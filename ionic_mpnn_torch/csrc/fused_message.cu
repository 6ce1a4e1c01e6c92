// Fused bond-matrix message + destination aggregate, and the same with the
// GatedUpdate as an epilogue (one full message step per launch).
//
//   agg[n, i] = sum over e in row n with mask[e] of  sum_j K[j, bond[e]*D + i] * h[src[e], j]
//
// K is the lane-stacked (D, V*D) table, K[j, v*D + i] = M_v[i, j].
//
// Replaces two Pallas kernels of the JAX package:
//   ops/pallas/fused_message.py  fused_message_aggregate (kGru = false)
//   ops/pallas/fused_step.py     fused_mp_step           (kGru = true)
// The TPU kernels gather h[src] and scatter into dst as one-hot MXU matmuls
// over 128-node windows with a 3-window src halo and a static tile budget.
// None of that carries over. Here the sorted dst is read as CSR rows and each
// destination node is one warp; lane i owns output features i, i+32, ...
// (D = 32 or 64). K (and, for the step, the GRU weights) is staged once per
// block in shared memory and the blocks walk the nodes grid-stride, so the
// table is read from memory once per resident block rather than once per
// node. For each edge the warp loads h[src] as one coalesced row, broadcasts
// each h_j with __shfl_sync, and accumulates in f32 registers; lane reads of
// K[j, b*D + lane] are contiguous, so there are no bank conflicts. The degree
// is unbounded, |src - dst| is unbounded, and no edge is ever dropped. The
// (E, D) messages never reach memory, and in the step neither does agg.
//
// Bound: bytes for the message kernel (h rows gathered per edge, the edge
// arrays, out) against 2*E*D*D flops; the step adds 12*N*D*D flops of GRU
// matvecs with only N*D more bytes in, which puts it near the balance point
// of f32 CUDA-core work at D = 32. Neither uses tensor cores: per edge the
// work is a D x D matvec with a data-dependent matrix, too small to tile.
//
// Step epilogue (all f32, as fused_step.py:144-163), with W = [Wz | Wr | Wh]
// of shape (2D, 3D) whose rows [0, D) multiply h and rows [D, 2D) agg:
//   z|r = sigmoid(h Wzr[:D] + agg Wzr[D:] + b_zr)
//   c   = tanh((r*h) Wh[:D] + agg Wh[D:] + b_h)
//   h'  = LayerNorm_eps((1-z)*h + z*c) + h      (mean, then mean((x-mu)^2))
#include "common.cuh"

namespace ionic {

constexpr int kFusedThreads = 512;

inline size_t fused_smem_bytes(int dim, int n_types, bool gru) {
  size_t floats = (size_t)dim * n_types * dim;
  if (gru) floats += 6 * (size_t)dim * dim + 3 * dim + 2 * dim;
  return floats * sizeof(float);
}

template <typename T, int D, bool kGru>
__global__ void __launch_bounds__(kFusedThreads)
fused_message_kernel(const T* __restrict__ h, const float* __restrict__ table,
                     const int* __restrict__ bond, const int* __restrict__ src,
                     const uint8_t* __restrict__ mask, const int* __restrict__ rowptr,
                     const float* __restrict__ gru_w, const float* __restrict__ gru_b,
                     const float* __restrict__ ln, float ln_eps,
                     float* __restrict__ out, int n_nodes, int n_types) {
  constexpr int F = D / 32;  // features per lane
  extern __shared__ float smem[];
  const int VD = n_types * D;
  float* sK = smem;
  float* sW = sK + D * VD;   // (2D, 3D)
  float* sB = sW + 6 * D * D;  // (3D)
  float* sL = sB + 3 * D;      // (2, D): scale, bias
  for (int t = threadIdx.x; t < D * VD; t += blockDim.x) sK[t] = table[t];
  if (kGru) {
    for (int t = threadIdx.x; t < 6 * D * D; t += blockDim.x) sW[t] = gru_w[t];
    for (int t = threadIdx.x; t < 3 * D; t += blockDim.x) sB[t] = gru_b[t];
    for (int t = threadIdx.x; t < 2 * D; t += blockDim.x) sL[t] = ln[t];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (long node = (long)blockIdx.x * warps + (threadIdx.x >> 5); node < n_nodes;
       node += (long)gridDim.x * warps) {
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;

    const int beg = rowptr[node];
    const int end = rowptr[node + 1];
    for (int e0 = beg; e0 < end; e0 += 32) {
      // each lane fetches one edge's ids; the warp then walks them in order
      const int e = e0 + lane;
      int my_src = 0, my_bond = 0, my_mask = 0;
      if (e < end) {
        my_src = src[e];
        my_bond = bond[e];
        my_mask = mask[e];
      }
      const int cnt = min(32, end - e0);
      for (int t = 0; t < cnt; ++t) {
        if (!__shfl_sync(kFullMask, my_mask, t)) continue;  // warp-uniform
        const long s = __shfl_sync(kFullMask, my_src, t);
        const int b = __shfl_sync(kFullMask, my_bond, t);
        float hv[F];
#pragma unroll
        for (int f = 0; f < F; ++f) hv[f] = load_f32(h + s * D + f * 32 + lane);
        const float* kb = sK + b * D + lane;
#pragma unroll
        for (int g = 0; g < F; ++g) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float hj = __shfl_sync(kFullMask, hv[g], j);
            const float* krow = kb + (g * 32 + j) * VD;
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = fmaf(krow[f * 32], hj, acc[f]);
          }
        }
      }
    }

    float* o = out + node * D + lane;
    if (!kGru) {
#pragma unroll
      for (int f = 0; f < F; ++f) o[f * 32] = acc[f];
      continue;
    }

    // ---- GatedUpdate epilogue: h and agg of this node sit in the warp ----
    float hn[F], z[F], r[F], c[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      hn[f] = load_f32(h + node * D + f * 32 + lane);
      z[f] = r[f] = c[f] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < F; ++g) {
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int row = g * 32 + j;
        const float hj = __shfl_sync(kFullMask, hn[g], j);
        const float aj = __shfl_sync(kFullMask, acc[g], j);
        const float* wh = sW + row * 3 * D + lane;        // row multiplying h
        const float* wa = sW + (D + row) * 3 * D + lane;  // row multiplying agg
#pragma unroll
        for (int f = 0; f < F; ++f) {
          z[f] = fmaf(hj, wh[f * 32], fmaf(aj, wa[f * 32], z[f]));
          r[f] = fmaf(hj, wh[D + f * 32], fmaf(aj, wa[D + f * 32], r[f]));
          c[f] = fmaf(aj, wa[2 * D + f * 32], c[f]);
        }
      }
    }
    float rh[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int i = f * 32 + lane;
      z[f] = 1.f / (1.f + expf(-(z[f] + sB[i])));
      r[f] = 1.f / (1.f + expf(-(r[f] + sB[D + i])));
      rh[f] = r[f] * hn[f];
    }
#pragma unroll
    for (int g = 0; g < F; ++g) {
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int row = g * 32 + j;
        const float rj = __shfl_sync(kFullMask, rh[g], j);
        const float* wc = sW + row * 3 * D + 2 * D + lane;
#pragma unroll
        for (int f = 0; f < F; ++f) c[f] = fmaf(rj, wc[f * 32], c[f]);
      }
    }
    float nw[F];
    float part = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float cand = tanhf(c[f] + sB[2 * D + lane + f * 32]);
      nw[f] = (1.f - z[f]) * hn[f] + z[f] * cand;
      part += nw[f];
    }
    const float mean = warp_sum(part) / D;
    float sq = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float d = nw[f] - mean;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / D + ln_eps);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int i = f * 32 + lane;
      o[f * 32] = (nw[f] - mean) * inv * sL[i] + sL[D + i] + hn[f];
    }
  }
}

template <typename T, int D, bool kGru>
int run_fused(const void* h, const float* table, const int* bond, const int* src,
              const uint8_t* mask, const int* rowptr, const float* gru_w,
              const float* gru_b, const float* ln, float ln_eps, float* out,
              int n_nodes, int n_types, cudaStream_t stream) {
  auto kernel = fused_message_kernel<T, D, kGru>;
  const size_t smem = fused_smem_bytes(D, n_types, kGru);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes > 0) {
    const int warps = kFusedThreads / 32;
    const int grid = resident_grid(kernel, kFusedThreads, smem, (n_nodes + warps - 1) / warps);
    kernel<<<grid, kFusedThreads, smem, stream>>>(static_cast<const T*>(h), table, bond, src,
                                                  mask, rowptr, gru_w, gru_b, ln, ln_eps,
                                                  out, n_nodes, n_types);
  }
  return (int)cudaGetLastError();
}

template <bool kGru>
int dispatch_fused(const void* h, int h_dtype, const float* table, const int* bond,
                   const int* src, const uint8_t* mask, const int* rowptr,
                   const float* gru_w, const float* gru_b, const float* ln, float ln_eps,
                   float* out, int n_nodes, int dim, int n_types, cudaStream_t s) {
  if (n_types <= 0) return (int)cudaErrorInvalidValue;
#define IONIC_RUN(T, DIM) \
  run_fused<T, DIM, kGru>(h, table, bond, src, mask, rowptr, gru_w, gru_b, ln, ln_eps, out, n_nodes, n_types, s)
  if (h_dtype == kF32 && dim == 32) return IONIC_RUN(float, 32);
  if (h_dtype == kF32 && dim == 64) return IONIC_RUN(float, 64);
  if (h_dtype == kBF16 && dim == 32) return IONIC_RUN(__nv_bfloat16, 32);
  if (h_dtype == kBF16 && dim == 64) return IONIC_RUN(__nv_bfloat16, 64);
#undef IONIC_RUN
  return (int)cudaErrorInvalidValue;
}

}  // namespace ionic

// Dynamic shared memory one block may opt in to on the current device.
IONIC_API int ionic_max_dynamic_smem(void) {
  int device = 0, bytes = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

IONIC_API int ionic_fused_message(const void* h, int h_dtype, const float* table,
                                  const int* bond, const int* src, const uint8_t* mask,
                                  const int* rowptr, float* out, int n_nodes, int dim,
                                  int n_types, void* stream) {
  return ionic::dispatch_fused<false>(h, h_dtype, table, bond, src, mask, rowptr, nullptr,
                                      nullptr, nullptr, 0.f, out, n_nodes, dim, n_types,
                                      static_cast<cudaStream_t>(stream));
}

IONIC_API int ionic_fused_step(const void* h, int h_dtype, const float* table,
                               const int* bond, const int* src, const uint8_t* mask,
                               const int* rowptr, const float* gru_w, const float* gru_b,
                               const float* ln, float ln_eps, float* out, int n_nodes,
                               int dim, int n_types, void* stream) {
  return ionic::dispatch_fused<true>(h, h_dtype, table, bond, src, mask, rowptr, gru_w,
                                     gru_b, ln, ln_eps, out, n_nodes, dim, n_types,
                                     static_cast<cudaStream_t>(stream));
}
