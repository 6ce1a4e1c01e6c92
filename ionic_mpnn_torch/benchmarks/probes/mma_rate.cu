// Tensor-core rate of mma.sync on the card: each warp issues ITERS rounds of
// 8 independent mma.sync (TF32 m16n8k8, then bf16 m16n8k16) at 4, 8 and 16
// warps per SM, and the program prints TFLOP/s and the time per mma per SM
// sub-partition. It bounds what the fused kernels' products can reach.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate mma_rate.cu && ./mma_rate
#include <cstdio>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
constexpr int ITERS = 4096;
__global__ void tf32_rate(float* out) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b0 = threadIdx.x * 3, b1 = 7;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0; for (int c = 0; c < 8; ++c) s += acc[c][0] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void bf16_rate(float* out) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b0 = threadIdx.x * 3, b1 = 7;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0; for (int c = 0; c < 8; ++c) s += acc[c][0] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out; cudaMalloc(&out, 1 << 24);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  for (int warps : {4, 8, 16}) {
    for (int k = 0; k < 2; ++k) {
      auto run = [&](auto kern, const char* name, double flops_per) {
        kern<<<sms, warps * 32>>>(out); cudaDeviceSynchronize();
        cudaEventRecord(a); kern<<<sms, warps * 32>>>(out); cudaEventRecord(b); cudaEventSynchronize(b);
        float ms; cudaEventElapsedTime(&ms, a, b);
        double n = (double)sms * warps * ITERS * 8;
        printf("%s warps/SM=%d: %.3f ms, %.1f TFLOP/s, %.2f ns per mma per SM-subpartition\n", name, warps, ms,
               n * flops_per / ms / 1e9, ms * 1e6 / (n / (sms * 4)));
      };
      if (k == 0) run(tf32_rate, "tf32 m16n8k8 ", 2.0 * 16 * 8 * 8);
      else run(bf16_rate, "bf16 m16n8k16", 2.0 * 16 * 8 * 16);
    }
  }
  return 0;
}
