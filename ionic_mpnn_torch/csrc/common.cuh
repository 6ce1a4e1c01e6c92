// Shared helpers for the message-step kernels (plain C interface, bound
// with ctypes from ionic_mpnn_torch/ops/cuda/_lib.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define IONIC_API extern "C" __attribute__((visibility("default")))

namespace ionic {

constexpr unsigned kFullMask = 0xffffffffu;

// Element type codes shared with the Python wrappers.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) {
  return to_f32(p[0]);
}
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Blocks to launch for a grid-stride kernel: enough to fill every SM at
// the occupancy the kernel reaches, and no more than the work needs.
template <typename Kernel>
inline int resident_grid(Kernel kernel, int threads, size_t smem, long work_blocks) {
  int device = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  long cap = (long)sms * (per_sm > 0 ? per_sm : 1);
  long g = work_blocks < cap ? work_blocks : cap;
  return (int)(g > 0 ? g : 1);
}

}  // namespace ionic

IONIC_API const char* ionic_error_string(int code);
