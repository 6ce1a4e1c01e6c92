// Sorted segment sum: out[n, :] = sum over e in [rowptr[n], rowptr[n+1]) of msg[e, :].
//
// Replaces the JAX package's Pallas kernel ops/pallas/segment_sum.py
// (sorted_segment_sum). There, node windows revisit (W, D) output blocks
// over 128-edge tiles and the scatter becomes one-hot MXU matmuls; here
// the sorted dst is read as CSR rows (rowptr from torch.searchsorted in the
// wrapper) and each destination node is one warp with lanes over D. Each
// lane walks the node's edge range with coalesced row loads and keeps its
// sum in an f32 register, so there are no atomics and the result does not
// depend on the run. Any D works (lanes loop over column chunks of 32).
//
// Bound: bytes. The edge rows are read once and the node rows written once
// (E*D*sizeof(T) + N*D*4 + (N+1)*4 bytes) against one add per element.
#include "common.cuh"

namespace ionic {

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ msg,
                                   const int* __restrict__ rowptr,
                                   float* __restrict__ out, int n_nodes, int dim) {
  const int lane = threadIdx.x & 31;
  const long node = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (node >= n_nodes) return;
  const int beg = rowptr[node];
  const int end = rowptr[node + 1];
  for (int c = lane; c < dim; c += 32) {
    float acc = 0.f;
#pragma unroll 4
    for (int e = beg; e < end; ++e) acc += load_f32(msg + (long)e * dim + c);
    out[node * dim + c] = acc;
  }
}

template <typename T>
int launch_segment_sum(const void* msg, const int* rowptr, float* out, int n_nodes,
                       int dim, cudaStream_t stream) {
  constexpr int kThreads = 256;
  if (n_nodes > 0) {
    const long blocks = ((long)n_nodes * 32 + kThreads - 1) / kThreads;
    segment_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(msg), rowptr, out, n_nodes, dim);
  }
  return (int)cudaGetLastError();
}

}  // namespace ionic

IONIC_API int ionic_segment_sum(const void* msg, int msg_dtype, const int* rowptr,
                                float* out, int n_nodes, int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim <= 0) return (int)cudaErrorInvalidValue;
  if (msg_dtype == ionic::kF32)
    return ionic::launch_segment_sum<float>(msg, rowptr, out, n_nodes, dim, s);
  if (msg_dtype == ionic::kBF16)
    return ionic::launch_segment_sum<__nv_bfloat16>(msg, rowptr, out, n_nodes, dim, s);
  return (int)cudaErrorInvalidValue;
}

IONIC_API const char* ionic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
