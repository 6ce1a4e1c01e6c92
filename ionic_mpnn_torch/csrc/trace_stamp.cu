// Device phase stamps (ionic_mpnn_torch/utils/profiling.py): one thread
// writes (phase code, %globaltimer) into a fixed ring on the card at an
// index it advances itself, so a CUDA graph that captured the launch
// stamps on every replay with no host sync and no event readback.
//
// The kernel runs once the stream's earlier work has finished, so the
// difference of two stamps is the card's time for the work between them,
// on the GPU's own clock (nanoseconds). The ring keeps the newest
// entries: slot = index & mask, with the ring's length a power of two.
#include "common.cuh"

namespace ionic {

__global__ void trace_stamp_kernel(long long* __restrict__ ring,
                                   unsigned long long* __restrict__ next,
                                   unsigned long long mask, int code) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long i = atomicAdd(next, 1ull) & mask;
  ring[2 * i] = code;
  ring[2 * i + 1] = (long long)now;
}

}  // namespace ionic

IONIC_API int ionic_trace_stamp(long long* ring, unsigned long long* next, long long capacity,
                                int code, void* stream) {
  if (capacity <= 0 || (capacity & (capacity - 1))) return (int)cudaErrorInvalidValue;
  ionic::trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, next, (unsigned long long)(capacity - 1), code);
  return (int)cudaGetLastError();
}
