// Fused bond-matrix message + destination aggregate, and the same with the
// GatedUpdate as an epilogue (one full message step per launch).
//
//   agg[n, i] = sum over e in row n with mask[e] of  sum_j K[j, bond[e]*D + i] * h[src[e], j]
//
// K is the lane-stacked (D, V*D) table, K[j, v*D + i] = M_v[i, j].
//
// Replaces the Pallas kernels of the JAX package:
//   ops/pallas/fused_message.py  fused_message_aggregate, and the dh of its
//                                _vjp_bwd (this kernel on (g, K^T))    kGru = false
//   ops/pallas/fused_step.py     fused_mp_step                         kGru = true
// The TPU kernels gather h[src] and scatter into dst as one-hot MXU matmuls
// over 128-node windows with a src halo and a static tile budget. None of
// that carries over: here the sorted dst is read as CSR rows, any in-degree
// and any |src - dst| are taken, and no edge is ever dropped.
//
// Bound. Bytes: h, the edge arrays, the table (and the GRU operands) read
// once, out written once. Flops: 2*E_real*D*D for the messages, plus
// 12*N*D*D for the step's gates. Both products run f32-accurate on the
// tensor cores as three TF32 passes, so the flop bound is over 495e12 / 3
// (H100 SXM dense TF32). At the bench's cation shape the message kernel is
// bound by bytes up to D = 64 and by flops at D = 128, the step by flops.
// What holds both back is latency: each edge's h row is a dependent
// gather, and a warp's tiles run in order.
//
// The widths: every D that is a multiple of 8 from 8 to 128, and up to 32
// bond types (the tile's type mask, and the 5 bits of a packed bond) at
// each. Two kernels share one design and its arithmetic:
// fused_message_tc_kernel, the D = 32 specialisation (the model's width:
// the table and the step's weights staged in shared memory), and
// fused_message_gen_kernel, every other width (column slices, operands read
// through L2). dispatch_fused chooses by D.
//
// Design (fused_message_tc_kernel first). The per-edge D x D matvec
// with a data-dependent matrix is rewritten with the identity of the JAX
// package's ops/message.py::message_pass_aggregate_typed,
//   agg[n] = sum_v M_v (sum over the edges of n with bond v of h[src]),
// so the matrix work becomes dense products on the tensor cores. A warp
// owns a tile of 16 consecutive destination nodes, whose edges are one CSR
// range; the tail tile is masked. Persistent blocks walk the tiles.
//  1. Bucket phase: the warp walks its edges in CSR order, 16 at a time, and
//     adds each real edge's h[src] row (lanes over D, f32) into the bucket
//     (dst - n0, bond) of Y[16, 4 slots x D] in shared memory. A bond type
//     takes a free slot when the tile first meets it; a tile that meets more
//     than 4 types (none at the bench shapes) runs the product on the full
//     slots and starts them over. So a warp's shared memory does not grow
//     with V, and more warps fit. Masked edges (pad edges carry the trained
//     bond 0) add nothing. One warp in CSR order and no atomics: the same
//     bits every run.
//  2. Product phase: agg_tile += Y_slot @ Kcat_v for each slot's type v,
//     Kcat[v*D + j, i] = K[j, v*D + i], on mma.sync with f32 accumulators,
//     f32-accurate, the operands split as the fragments load so the table
//     is stored once. The message kernel splits each operand exactly into
//     three bf16 parts and sums the six products of order <= 2^-16
//     (m16n8k16); the step uses 3xTF32 (m16n8k8, hi = rna(x), lo =
//     rna(x - hi), rounded as cvt.rna.tf32.f32 does but by integer ops),
//     which leaves 2^-22 in each operand. Both take three mma per 8 of depth.
//     The largest products and the small ones go to two short chains (at
//     most 8 depth steps each) added in f32, because the tensor cores
//     truncate what they sum. Only the types a tile holds cost work: a bench
//     cation tile holds ~1.5 of 7.
//  3. Step epilogue (kGru), the function of fused_step.py:138-163 in f32:
//     z|r = [h | agg] (16 x 2D) @ [Wz | Wr] and the candidate from
//     [r*h | agg] @ Wh on the same 3xTF32 mma, with the weights pre-split
//     into (hi, lo) pairs once per block, by the threads as they load them;
//     then sigmoid by the fast exponential and division (a few ulp; the
//     IEEE division spills through a call), tanhf, the LayerNorm (the mean,
//     then mean((x - mu)^2), eps ln_eps) with row sums over the 4 lanes of a
//     quad, and the residual. out is f32 whatever the dtype of h.
//  4. Copies, in a three-stage pipeline per warp: a tile's rowptr entries
//     one tile ahead, a chunk's edge arrays one chunk ahead, and its h[src]
//     rows one chunk ahead by 16-byte cp.async into two shared buffers, so
//     they are in flight while the current chunk is summed and, at a tile's
//     end, while its products run. The table, biases and LayerNorm are
//     staged once per block by TMA bulk copies on an mbarrier, the GRU
//     weights by 16-byte loads all in flight at once. (Plain loads, the
//     rows gathered into registers one chunk ahead, took 1.5x as long for
//     the message and 1.1x for the step on an H100.)
// Shared rows are padded (K: V*D + 4, W: 3D + 4 pairs, Y: 4D + 8 for the
// message and 4D + 4 for the step, X: 2D + 4) so that the fragment loads
// of the products and of the epilogue are free of bank conflicts. Tiles are
// dealt to the blocks first, so the SMs' loads differ by one tile at most.
//
// Any other width (fused_message_gen_kernel). At D = 128 the table alone is
// D * V*D * 4 = 458 KB at V = 7 and the step's weights 393 KB, more than a
// block's 227 KB of shared memory, so neither is staged: the products read
// their B fragments from global memory (__ldg; the table is at most 2 MB and
// stays in L2). A tile's columns are split over a team of ceil(D / 32)
// warps, each owning a slice of 32 output columns (the last one narrower):
//  - every warp of the team walks the tile's edges (the same chunks and the
//    same slot decisions) and gathers and sums only its slice of each
//    h[src] row into the team's shared buckets;
//  - a team barrier (bar.sync on the team's own id; __syncwarp for a team
//    of one) before the products, which read whole rows of the buckets,
//    and one after; each warp then zeroes its own columns;
//  - each warp multiplies into its slice of agg (n-tiles of 8 columns);
//    the message's bf16 depth is zero-padded to a multiple of 16 (the
//    buckets' pad columns stay 0 and the table's rows past D read as 0:
//    exact), the step's 3xTF32 takes D itself;
//  - the step writes its slices of X = [h | agg] over the buckets, and
//    every product and gate works on its slice: z and r (two slices of Wz
//    and Wr, D columns apart), r*h back into X, the candidate; the
//    LayerNorm's row sums add each warp's slice sum from shared memory, in
//    slice order, so it reads the true D and never the padded width.
// The arithmetic is the specialisation's step for step (the same splits,
// chains and epilogue), so the two agree to rounding at D = 32.
#include <climits>

#include "common.cuh"

namespace ionic {

// ------------------------------------------------------------ D = 32: tensor cores

constexpr int kTile = 16;     // destination nodes per warp tile (the mma M)
constexpr int kChunk = 16;    // edges per step of the bucket phase
constexpr int kTcDim = 32;    // the width the tensor-core kernel serves
constexpr int kSlots = 4;     // bond types a tile's buckets hold at once
// Warps per block: the step's epilogue needs more registers (65536 / 384 =
// 170 a thread) than the message (128 at 16 warps).
__host__ __device__ constexpr int max_warps(bool gru) { return gru ? 12 : 16; }
constexpr int kWsStride = 3 * kTcDim + 4;  // (hi, lo) row of the pre-split GRU weights, padded
constexpr int kBarBytes = 16;              // the mbarrier, at the start of shared memory

__host__ __device__ inline int tc_k_stride(int n_types) { return n_types * kTcDim + 4; }
// A row of Y's buckets, padded so that the product's fragment loads are
// free of bank conflicts: the message's bf16 split reads float2 pairs (a
// stride of 8 mod 32 floats), the step's 3xTF32 single floats (4 mod 32).
// The smaller pad also leaves room for a 12th step warp beside a 7-type table.
__host__ __device__ constexpr int y_stride(bool gru) { return kSlots * kTcDim + (gru ? 4 : 8); }
__host__ __device__ constexpr int y_bytes(bool gru) { return kTile * y_stride(gru) * 4; }
constexpr int kXStride = 2 * kTcDim + 4;  // a row of the epilogue's [h | agg], over Y

// Shared memory of one block: the mbarrier, the table, with kGru the GRU
// weights pre-split into TF32 (hi, lo) pairs and the biases, then per warp
// its Y tile of kSlots buckets per node and two row buffers.
inline size_t tc_fixed_bytes(int n_types, bool gru) {
  size_t bytes = kBarBytes + sizeof(float) * (size_t)kTcDim * tc_k_stride(n_types);
  if (gru) bytes += sizeof(uint2) * 2 * kTcDim * kWsStride + sizeof(float) * 5 * kTcDim;
  return bytes;
}

inline size_t tc_warp_bytes(size_t elem, bool gru) {
  return y_bytes(gru) + 2 * kChunk * kTcDim * elem;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TF32 rounding as cvt.rna.tf32.f32 does it (to nearest, ties away from
// zero) for finite x, in two integer operations: the cvt instruction is
// emulated by a longer sequence on this target.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint2 tf32_pair(float b) {
  uint2 r;
  split_tf32(b, r.x, r.y);
  return r;
}
__device__ __forceinline__ uint2 tf32_pair(uint2 b) { return b; }  // pre-split (hi, lo)

// acc[16 x 8*NT] += A[16 x 8*KT] @ B[8*KT x 8*NT], A f32 in shared memory
// with row stride lda, B in shared memory with row stride ldb, either f32
// (split as it loads) or pre-split (hi, lo) pairs, and A the same. Three TF32 passes: the
// hi*hi products and the two mixed ones (lo*hi, hi*lo) go to two zeroed
// chains over the KT k-steps, and acc += hh + mx in f32 at the end. Two
// chains per n-tile keep the tensor pipe busy, and short ones keep their
// sums exact enough: the tensor cores round what they accumulate towards
// zero, so one long chain on acc (a tile's types after one another) drifts.
// Fragments of mma.m16n8k8
// (PTX ISA), g = lane / 4, q = lane % 4: A a0 (g, q), a1 (g+8, q),
// a2 (g, q+4), a3 (g+8, q+4); B b0 (q, g), b1 (q+4, g); C c0 (g, 2q),
// c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1).
template <int KT, int NT, typename TA, typename TB>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[NT][4], const TA* A, int lda,
                                           const TB* B, int ldb, int lane) {
  const int g = lane >> 2, q = lane & 3;
  float hh[NT][4] = {}, mx[NT][4] = {};
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const TA* a = A + kk * 8 + q;
    const uint2 a0 = tf32_pair(a[g * lda]), a1 = tf32_pair(a[(g + 8) * lda]);
    const uint2 a2 = tf32_pair(a[g * lda + 4]), a3 = tf32_pair(a[(g + 8) * lda + 4]);
    const uint32_t ahi[4] = {a0.x, a1.x, a2.x, a3.x}, alo[4] = {a0.y, a1.y, a2.y, a3.y};
    const TB* b = B + (kk * 8 + q) * ldb + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b0 = tf32_pair(b[nt * 8]), b1 = tf32_pair(b[4 * ldb + nt * 8]);
      mma_tf32(mx[nt], alo, b0.x, b1.x);
      mma_tf32(mx[nt], ahi, b0.y, b1.y);
      mma_tf32(hh[nt], ahi, b0.x, b1.x);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += hh[nt][i] + mx[nt][i];
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) = x1 + x2 + x3 exactly, each part bf16 (8 significant bits,
// rounded to nearest), packed in pairs as the bf16 mma takes them: x in the
// low half.
__device__ __forceinline__ void split_bf16x3(float x, float y, uint32_t& p1, uint32_t& p2,
                                             uint32_t& p3) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(x, y);
  const float2 f1 = __bfloat1622float2(h1);
  const float rx = x - f1.x, ry = y - f1.y;
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(rx, ry);
  const float2 f2 = __bfloat1622float2(h2);
  p1 = bf16x2_bits(h1);
  p2 = bf16x2_bits(h2);
  p3 = bf16x2_bits(__floats2bfloat162_rn(rx - f2.x, ry - f2.y));
}

// acc[16 x 8*NT] += A[16 x 16*KT] @ B[16*KT x 8*NT], both f32 in shared
// memory (row strides lda, ldb), at f32 accuracy on the bf16 tensor cores:
// each operand splits exactly into three bf16 parts, and the six products
// x_i*y_j with i + j <= 4 are summed, the small ones first into one chain
// and x1*y1 into another, acc += hh + mx at the end. That is the mma count
// of 3xTF32 (m16n8k16 takes twice the depth at the same rate) with no
// rounding of the operands, where 3xTF32 leaves 2^-22 in each. Fragments of
// mma.m16n8k16 bf16 (PTX ISA), g = lane / 4, q = lane % 4: A a0 (g, 2q..2q+1),
// a1 (g+8, 2q..2q+1), a2 (g, 2q+8..2q+9), a3 (g+8, 2q+8..2q+9); B b0
// (2q..2q+1, g), b1 (2q+8..2q+9, g); C as m16n8k8.
template <int KT, int NT>
__device__ __forceinline__ void mma_bf16x3(float (&acc)[NT][4], const float* A, int lda,
                                           const float* B, int ldb, int lane) {
  const int g = lane >> 2, q = lane & 3;
  float hh[NT][4] = {}, mx[NT][4] = {};
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const float* a = A + kk * 16 + 2 * q;
    uint32_t a1[4], a2[4], a3[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(a + (i & 1) * 8 * lda + (i >> 1) * 8 +
                                                        g * lda);
      split_bf16x3(v.x, v.y, a1[i], a2[i], a3[i]);
    }
    const float* b = B + (kk * 16 + 2 * q) * ldb + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b1[2], b2[2], b3[2];
      split_bf16x3(b[nt * 8], b[ldb + nt * 8], b1[0], b2[0], b3[0]);
      split_bf16x3(b[8 * ldb + nt * 8], b[9 * ldb + nt * 8], b1[1], b2[1], b3[1]);
      mma_bf16(mx[nt], a3, b1);
      mma_bf16(mx[nt], a2, b2);
      mma_bf16(mx[nt], a1, b3);
      mma_bf16(mx[nt], a2, b1);
      mma_bf16(mx[nt], a1, b2);
      mma_bf16(hh[nt], a1, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += hh[nt][i] + mx[nt][i];
}

// ---- asynchronous copies (sm_90) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D TMA bulk copy global -> shared; bytes a multiple of 16, both ends 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- the bucket phase ----

// A tile's rowptr entries: lane r <= nrows holds rowptr[n0 + r], the others INT_MAX.
__device__ __forceinline__ int load_rowptr(const int* __restrict__ rowptr, int tile,
                                           int n_nodes, int lane) {
  const int n0 = tile * kTile;
  const int nrows = min(kTile, n_nodes - n0);
  return lane <= nrows ? rowptr[n0 + lane] : INT_MAX;
}

// Where the warp's edge loads stand: a tile, its edge range [e0, e_end) left
// to load, and its rowptr entries, by which an edge finds its row.
struct Cursor {
  int tile, e0, e_end;
  int rp;  // lane r: rowptr[n0 + r] (INT_MAX past the tile)
};

__device__ __forceinline__ void enter_tile(Cursor& at, int tile, int rowptr_entries,
                                           int n_nodes) {
  at.tile = tile;
  at.rp = rowptr_entries;
  const int nrows = min(kTile, n_nodes - tile * kTile);
  at.e0 = __shfl_sync(kFullMask, rowptr_entries, 0);
  at.e_end = __shfl_sync(kFullMask, rowptr_entries, nrows);
}

// A chunk's edge arrays as loaded, a step before they are used: lane t < CH
// holds edge e0 + t; m is 0 past the range.
struct RawEdges {
  int m = 0, b = 0, s = 0;
};

template <int CH>
__device__ __forceinline__ RawEdges load_edges(const int* __restrict__ src,
                                               const int* __restrict__ bond,
                                               const uint8_t* __restrict__ mask,
                                               const Cursor& at, int lane) {
  RawEdges r;
  const int e = at.e0 + lane;
  if (lane < CH && e < at.e_end) {
    r.m = mask[e];
    r.b = bond[e];
    r.s = src[e];
  }
  return r;
}

// Up to CH edges of a tile: lane t < CH holds edge e0 + t as
// packed = row << 5 | bond (row = dst - n0), or -1 when it is masked or past
// the tile's range, and its src.
struct Chunk {
  int packed = -1;
  int s = 0;
  uint32_t types = 0;  // bond types of its real edges, warp-uniform
  int tile = 0;
  bool last = true;    // the tile's last chunk
};

template <int CH>
__device__ __forceinline__ Chunk make_chunk(const RawEdges& r, const Cursor& at, int lane) {
  Chunk c;
  const int e = at.e0 + lane;
  int row = 0;  // the rows that start at or before e, after the first
#pragma unroll
  for (int k = 1; k < kTile; ++k) row += __shfl_sync(kFullMask, at.rp, k) <= e;
  if (r.m) {
    c.packed = (row << 5) | r.b;
    c.s = r.s;
  }
  c.types = __reduce_or_sync(kFullMask, c.packed >= 0 ? 1u << (c.packed & 31) : 0u);
  c.tile = at.tile;
  c.last = at.e0 + CH >= at.e_end;
  return c;
}

// The chunk's real h[src] rows into g (CH rows of D), 16 bytes a copy.
template <typename T, int CH>
__device__ __forceinline__ void gather_rows_async(T* g, const T* __restrict__ h,
                                                  const Chunk& c, int lane) {
  constexpr int kPieces = kTcDim * (int)sizeof(T) / 16;  // 16-byte pieces per row
#pragma unroll
  for (int i = 0; i < CH * kPieces / 32; ++i) {
    const int piece = lane + 32 * i, t = piece / kPieces, p = piece % kPieces;
    const int pk = __shfl_sync(kFullMask, c.packed, t);
    const int s = __shfl_sync(kFullMask, c.s, t);
    if (pk >= 0)
      cp_async16(reinterpret_cast<char*>(g + t * kTcDim) + p * 16,
                 reinterpret_cast<const char*>(h + (size_t)s * kTcDim) + p * 16);
  }
  cp_async_commit();
}

// The slots of a tile's buckets: slot k holds type (types >> 8k) & 255 for
// k < used; mask has those types' bits.
struct Slots {
  uint32_t types = 0, mask = 0;
  int used = 0;
};

// This pass's bucket of lane t's edge, row << 2 | slot, or -1 when its type
// has no slot (or it is not a real edge). Types of the chunk without a slot
// get free ones first, lowest type first.
__device__ __forceinline__ int take_slots(Slots& sl, uint32_t todo, const Chunk& c) {
  for (uint32_t fresh = todo & ~sl.mask; fresh && sl.used < kSlots; fresh &= fresh - 1) {
    const int v = __ffs(fresh) - 1;
    sl.types |= (uint32_t)v << (8 * sl.used++);
    sl.mask |= 1u << v;
  }
  if (c.packed < 0) return -1;
  const uint32_t b = c.packed & 31;
  if (!((sl.mask >> b) & 1u)) return -1;
  int slot = 0;
#pragma unroll
  for (int k = 1; k < kSlots; ++k) slot += ((sl.types >> (8 * k)) & 255u) == b && k < sl.used ? k : 0;
  return ((c.packed >> 5) << 2) | slot;
}

// Add the pass's edges into their buckets, in CSR order, from the gathered
// rows.
template <int CH, bool kGru, typename T>
__device__ __forceinline__ void add_rows(float* Y, const T* g, int bucket, int lane) {
#pragma unroll
  for (int t = 0; t < CH; ++t) {
    const int p = __shfl_sync(kFullMask, bucket, t);
    if (p >= 0)
      Y[(p >> 2) * y_stride(kGru) + (p & 3) * kTcDim + lane] += to_f32(g[t * kTcDim + lane]);
  }
}

// Zero the buckets of the slots in mask (bit k: slot k).
template <bool kGru>
__device__ __forceinline__ void zero_slots(float* Y, uint32_t slots, int lane) {
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (; slots; slots &= slots - 1) {
    float* yv = Y + (__ffs(slots) - 1) * kTcDim;
#pragma unroll
    for (int i = 0; i < kTile * kTcDim / 4 / 32; ++i) {
      const int idx = lane + 32 * i;
      reinterpret_cast<float4*>(yv + (idx >> 3) * y_stride(kGru))[idx & 7] = zero4;
    }
  }
}

// The warp's edges as one stream of chunks (an empty tile is one empty
// chunk), in three stages one step apart: a tile's rowptr entries, a
// chunk's edge arrays, its h[src] rows. Chunk k + 1's rows and chunk k + 2's
// edges are in flight while chunk k is summed and, at the end of a tile,
// while the tile's products run. gather(b, chunk) starts the copies of a
// chunk's rows into row buffer b (and commits them); visit(b, chunk) sums a
// chunk whose rows have landed. The warp's tiles are first, first + stride,
// ...
template <int CH, typename Gather, typename Visit>
__device__ __forceinline__ void walk_chunks(const int* __restrict__ rowptr,
                                            const int* __restrict__ src,
                                            const int* __restrict__ bond,
                                            const uint8_t* __restrict__ mask, int n_nodes,
                                            int first, int stride, int lane, Gather gather,
                                            Visit visit) {
  const int tiles = (n_nodes + kTile - 1) / kTile;
  if (first >= tiles) return;
  Cursor at;
  enter_tile(at, first, load_rowptr(rowptr, first, n_nodes, lane), n_nodes);
  int rp_next = first + stride < tiles ? load_rowptr(rowptr, first + stride, n_nodes, lane) : 0;
  RawEdges raw = load_edges<CH>(src, bond, mask, at, lane);
  bool more = true;  // the cursor is on a chunk
  // the loaded edges become a chunk whose rows are gathered; the cursor moves
  // on and loads the next chunk's edges
  auto advance = [&](int b) {
    const Chunk c = make_chunk<CH>(raw, at, lane);
    gather(b, c);
    if (c.last) {
      const int next = at.tile + stride;
      more = next < tiles;
      if (more) {
        enter_tile(at, next, rp_next, n_nodes);
        if (next + stride < tiles) rp_next = load_rowptr(rowptr, next + stride, n_nodes, lane);
      }
    } else {
      at.e0 += CH;
    }
    if (more) raw = load_edges<CH>(src, bond, mask, at, lane);
    return c;
  };
  int buf = 0;
  Chunk cur = advance(0);
  while (true) {
    const bool has_next = more;
    Chunk nxt;
    if (has_next) nxt = advance(buf ^ 1);
    else cp_async_commit();  // empty: wait_group 1 still means "the current chunk"
    cp_async_wait<1>();
    __syncwarp();
    visit(buf, cur);
    if (!has_next) break;
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
}

// The product phase: agg += each slot's buckets @ its type's block of the
// table; then the slots are zeroed and free. The message kernel's output is
// what the backward's sums over every node read (the remat and dh launches),
// so it takes the exact bf16 split; the step's agg reaches only its own
// output, and 3xTF32 there is faster (fewer registers beside the epilogue).
template <bool kGru>
__device__ __forceinline__ void flush_slots(float (&agg)[4][4], float* Y, Slots& sl,
                                            const float* sK, int ks, int lane) {
  __syncwarp();
  for (int k = 0; k < sl.used; ++k) {
    const int v = (sl.types >> (8 * k)) & 255u;
    if (kGru)
      mma_3xtf32<kTcDim / 8, 4>(agg, Y + k * kTcDim, y_stride(true), sK + v * kTcDim, ks, lane);
    else
      mma_bf16x3<kTcDim / 16, 4>(agg, Y + k * kTcDim, y_stride(false), sK + v * kTcDim, ks,
                                 lane);
  }
  __syncwarp();
  zero_slots<kGru>(Y, (1u << sl.used) - 1, lane);
  __syncwarp();
  sl = Slots();
}

// z and r through the fast exponential and division (a few ulp): the IEEE
// division reaches a slow path through a call, which spills the epilogue's
// registers. The candidate keeps tanhf: 1 - 2 / (e^2x + 1) cancels near 0,
// and that error, always of one sign, grows through 4 steps and the sum
// pooling to beyond the model's 1e-4.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// ---- the product phase, the epilogue, the store ----

template <typename T, bool kGru>
__device__ __forceinline__ void finish_tile(float (&agg)[4][4], float* Y, Slots& sl,
                                            const float* sK, int ks, const uint2* sW, int ws,
                                            const float* sB, const float* sL, float ln_eps,
                                            const T* __restrict__ h, float* __restrict__ out,
                                            int tile, int n_nodes, int lane) {
  constexpr int D = kTcDim;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = tile * kTile;
  const int nrows = min(kTile, n_nodes - n0);
  const bool ok0 = g < nrows, ok1 = g + 8 < nrows;  // the C rows g and g + 8
  float hv[4][4];  // the step's h, in the C layout; loaded ahead of the products
  if (kGru) {
    const T* h0 = h + (size_t)(n0 + g) * D + 2 * q;
    const T* h1 = h0 + 8 * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hv[j][0] = ok0 ? load_f32(h0 + 8 * j) : 0.f;
      hv[j][1] = ok0 ? load_f32(h0 + 8 * j + 1) : 0.f;
      hv[j][2] = ok1 ? load_f32(h1 + 8 * j) : 0.f;
      hv[j][3] = ok1 ? load_f32(h1 + 8 * j + 1) : 0.f;
    }
  }
  flush_slots<kGru>(agg, Y, sl, sK, ks, lane);
  float* o0 = out + (size_t)(n0 + g) * D + 2 * q;
  float* o1 = o0 + 8 * D;
  if (!kGru) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ok0) *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(agg[j][0], agg[j][1]);
      if (ok1) *reinterpret_cast<float2*>(o1 + 8 * j) = make_float2(agg[j][2], agg[j][3]);
    }
  } else {
    // X = [h | agg] (16 x 2D) over Y's columns [0, 2D), now free
    float* x0 = Y + g * kXStride + 2 * q;
    float* x1 = x0 + 8 * kXStride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0[8 * j] = hv[j][0];
      x0[8 * j + 1] = hv[j][1];
      x1[8 * j] = hv[j][2];
      x1[8 * j + 1] = hv[j][3];
      x0[D + 8 * j] = agg[j][0];
      x0[D + 8 * j + 1] = agg[j][1];
      x1[D + 8 * j] = agg[j][2];
      x1[D + 8 * j + 1] = agg[j][3];
    }
    __syncwarp();
    float zr[8][4] = {};
    mma_3xtf32<8, 8>(zr, Y, kXStride, sW, ws, lane);  // [h | agg] @ [Wz | Wr]
    __syncwarp();  // X is read: r*h replaces h in it
    float z[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = 8 * j + 2 * q + (k & 1);
        z[j][k] = sigmoid_fast(zr[j][k] + sB[col]);
        (k < 2 ? x0 : x1)[8 * j + (k & 1)] = sigmoid_fast(zr[4 + j][k] + sB[D + col]) * hv[j][k];
      }
    }
    __syncwarp();
    float cc[4][4] = {};
    mma_3xtf32<8, 4>(cc, Y, kXStride, sW + 2 * D, ws, lane);  // [r*h | agg] @ Wh
    float nw[4][4];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = 8 * j + 2 * q + (k & 1);
        const float cand = tanhf(cc[j][k] + sB[2 * D + col]);
        nw[j][k] = (1.f - z[j][k]) * hv[j][k] + z[j][k] * cand;
        if (k < 2) s0 += nw[j][k]; else s1 += nw[j][k];
      }
    }
    // a row's D values sit in the 4 lanes of a quad, 8 each
    s0 += __shfl_xor_sync(kFullMask, s0, 1);
    s0 += __shfl_xor_sync(kFullMask, s0, 2);
    s1 += __shfl_xor_sync(kFullMask, s1, 1);
    s1 += __shfl_xor_sync(kFullMask, s1, 2);
    const float mean0 = s0 / D, mean1 = s1 / D;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = nw[j][k] - (k < 2 ? mean0 : mean1);
        if (k < 2) v0 += d * d; else v1 += d * d;
      }
    }
    v0 += __shfl_xor_sync(kFullMask, v0, 1);
    v0 += __shfl_xor_sync(kFullMask, v0, 2);
    v1 += __shfl_xor_sync(kFullMask, v1, 1);
    v1 += __shfl_xor_sync(kFullMask, v1, 2);
    const float inv0 = rsqrtf(v0 / D + ln_eps), inv1 = rsqrtf(v1 / D + ln_eps);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = 8 * j + 2 * q + (k & 1);
        const float mean = k < 2 ? mean0 : mean1, inv = k < 2 ? inv0 : inv1;
        y[k] = (nw[j][k] - mean) * inv * sL[col] + sL[D + col] + hv[j][k];
      }
      if (ok0) *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(y[0], y[1]);
      if (ok1) *reinterpret_cast<float2*>(o1 + 8 * j) = make_float2(y[2], y[3]);
    }
  }
  if (kGru) {  // zero X: 16 rows of kXStride floats at the start of Y
    static_assert(kXStride <= y_stride(true) && kXStride % 4 == 0, "X lies in Y");
    __syncwarp();
    float4* y4 = reinterpret_cast<float4*>(Y);
    for (int i = lane; i < kTile * kXStride / 4; i += 32) y4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) agg[j][k] = 0.f;
}

template <typename T, bool kGru>
__global__ void __launch_bounds__(max_warps(kGru) * 32)
fused_message_tc_kernel(const T* __restrict__ h, const float* __restrict__ table,
                        const int* __restrict__ bond, const int* __restrict__ src,
                        const uint8_t* __restrict__ mask, const int* __restrict__ rowptr,
                        const float* __restrict__ gru_w, const float* __restrict__ gru_b,
                        const float* __restrict__ ln, float ln_eps, float* __restrict__ out,
                        int n_nodes, int n_types) {
  constexpr int D = kTcDim;
  constexpr int ws = kWsStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  const int VD = n_types * D;
  const int ks = tc_k_stride(n_types);
  constexpr int ys = y_stride(kGru);
  float* sK = reinterpret_cast<float*>(smem_raw + kBarBytes);  // (D, V*D), row ks
  uint2* sW = reinterpret_cast<uint2*>(sK + D * ks);           // (2D, 3D), row ws
  float* sB = reinterpret_cast<float*>(sW + 2 * D * ws);       // (3D)
  float* sL = sB + 3 * D;                                      // (2, D): scale, bias
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kGFloats = 2 * kChunk * D * (int)sizeof(T) / 4;
  float* Y = (kGru ? sL + 2 * D : reinterpret_cast<float*>(sW)) +
             warp * (y_bytes(kGru) / 4 + kGFloats);    // (16, kSlots*D), row ys
  T* G = reinterpret_cast<T*>(Y + y_bytes(kGru) / 4);  // two (kChunk, D) row buffers

  // ---- stage the table (and the GRU operands) once per block; zero Y ----
  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, D * VD * 4 + (kGru ? 5 * D * 4 : 0));
    for (int j = 0; j < D; ++j) bulk_copy(sK + j * ks, table + (size_t)j * VD, VD * 4, bar);
    if (kGru) {
      bulk_copy(sB, gru_b, 3 * D * 4, bar);
      bulk_copy(sL, ln, 2 * D * 4, bar);
    }
  }
  if (kGru) {  // 16-byte loads, up to 8 a thread in flight at once, split on the way
    constexpr int kW4 = 6 * D * D / 4;  // a row of 3D floats holds whole pieces
    const float4* w4 = reinterpret_cast<const float4*>(gru_w);
    for (int i0 = threadIdx.x; i0 < kW4; i0 += 8 * blockDim.x) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u * (int)blockDim.x < kW4) v[u] = w4[i0 + u * blockDim.x];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = 4 * (i0 + u * blockDim.x);
        if (t >= 6 * D * D) break;
        uint2* d = sW + (t / (3 * D)) * ws + t % (3 * D);
        d[0] = tf32_pair(v[u].x);
        d[1] = tf32_pair(v[u].y);
        d[2] = tf32_pair(v[u].z);
        d[3] = tf32_pair(v[u].w);
      }
    }
  }
  for (int t = lane; t < kTile * ys; t += 32) Y[t] = 0.f;
  mbar_wait(bar, 0);
  __syncthreads();

  // tiles are dealt to the blocks first: the SMs' tile counts differ by one
  // at most, and the last round of tiles spreads over every SM
  Slots sl;
  float agg[4][4] = {};
  walk_chunks<kChunk>(
      rowptr, src, bond, mask, n_nodes, warp * gridDim.x + blockIdx.x,
      gridDim.x * (blockDim.x >> 5), lane,
      [&](int b, const Chunk& c) { gather_rows_async<T, kChunk>(G + b * kChunk * D, h, c, lane); },
      [&](int b, const Chunk& cur) {
        // the chunk's types take free slots; a tile that meets more than
        // kSlots types runs the product on the full slots and starts them over
        for (uint32_t todo = cur.types;;) {
          const int bucket = take_slots(sl, todo, cur);
          add_rows<kChunk, kGru>(Y, G + b * kChunk * D, bucket, lane);
          todo &= ~sl.mask;
          if (!todo) break;
          flush_slots<kGru>(agg, Y, sl, sK, ks, lane);
        }
        __syncwarp();
        if (cur.last)
          finish_tile<T, kGru>(agg, Y, sl, sK, ks, sW, ws, sB, sL, ln_eps, h, out, cur.tile,
                               n_nodes, lane);
      });
}

template <typename T, bool kGru>
int launch_tc(const void* h, const float* table, const int* bond, const int* src,
              const uint8_t* mask, const int* rowptr, const float* gru_w,
              const float* gru_b, const float* ln, float ln_eps, float* out, int n_nodes,
              int n_types, size_t fixed, size_t per_warp, int warps, cudaStream_t stream) {
  auto kernel = fused_message_tc_kernel<T, kGru>;
  const size_t smem = fixed + warps * per_warp;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes > 0) {
    const long tiles = (n_nodes + kTile - 1) / kTile;
    const int grid = resident_grid(kernel, warps * 32, smem, (tiles + warps - 1) / warps);
    kernel<<<grid, warps * 32, smem, stream>>>(static_cast<const T*>(h), table, bond, src,
                                               mask, rowptr, gru_w, gru_b, ln, ln_eps, out,
                                               n_nodes, n_types);
  }
  return (int)cudaGetLastError();
}

// As many warps per block as shared memory holds, up to max_warps.
template <typename T, bool kGru>
int run_tc(const void* h, const float* table, const int* bond, const int* src,
           const uint8_t* mask, const int* rowptr, const float* gru_w, const float* gru_b,
           const float* ln, float ln_eps, float* out, int n_nodes, int n_types,
           cudaStream_t stream) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const size_t per_warp = tc_warp_bytes(sizeof(T), kGru);
  const size_t fixed = tc_fixed_bytes(n_types, kGru);
  if (fixed + per_warp > (size_t)optin) return (int)cudaErrorInvalidValue;
  const size_t fit = (optin - fixed) / per_warp;
  const int warps = (int)(fit < (size_t)max_warps(kGru) ? fit : max_warps(kGru));
  return launch_tc<T, kGru>(h, table, bond, src, mask, rowptr, gru_w, gru_b, ln, ln_eps, out,
                            n_nodes, n_types, fixed, per_warp, warps, stream);
}

// ------------------------------------------------------------ any D: column slices

constexpr int kSlice = 32;     // output columns a warp owns (the last slice may be narrower)
constexpr int kMaxDim = 128;   // the widest D the kernels take
constexpr int kMaxTypes = 32;  // the tile's type mask, and the 5 bits of a packed bond
constexpr int kChain = 8;      // depth steps per accumulation chain

// The warps that share a tile, one per slice of 32 output columns.
__host__ __device__ constexpr int team_warps(int dim) { return (dim + kSlice - 1) / kSlice; }
// The depth of a bucket's product: the message's bf16 mma takes 16 at a time
// (zero-padded past D), the step's TF32 mma 8, which every D is a multiple of.
__host__ __device__ constexpr int gen_depth(int dim, bool gru) {
  return gru ? dim : (dim + 15) / 16 * 16;
}
// Rows of the buckets, padded as the specialisation's: 8 mod 32 floats for
// the message's float2 fragment loads, 4 mod 32 for the step's single floats.
__host__ __device__ constexpr int gen_y_stride(int dim, bool gru) {
  return kSlots * gen_depth(dim, gru) + (gru ? 4 : 8);
}
// Shared memory of a team: its buckets (16 rows, the step's X over them)
// and, for the step, the LayerNorm's per-warp row sums (2 x warps x 16).
__host__ __device__ constexpr int gen_team_bytes(int dim, bool gru) {
  return 4 * (kTile * gen_y_stride(dim, gru) + (gru ? 2 * kTile * team_warps(dim) : 0));
}
// A warp's two row buffers of its slice, kSlice wide.
__host__ __device__ constexpr int gen_warp_bytes(int elem) { return 2 * kChunk * kSlice * elem; }

// What one warp of a team works on: the width, its slice [c0, c0 + cw) of
// the output columns (ntw n-tiles of 8), the buckets' depth and row stride,
// the table's row length V*D.
struct Slice {
  int D, DK, ys, VD, W, w, c0, cw, ntw;
};

// The team's barrier: bar.sync on the team's own id (0 is __syncthreads'),
// or the warp's for a team of one.
__device__ __forceinline__ void team_sync(const Slice& s, int team) {
  if (s.W == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(32 * s.W) : "memory");
}

// n-tile nt's first column, relative to B: NT = 8 takes two slices of 4
// n-tiles, `jump` columns apart (the step's z and r).
__device__ __forceinline__ int tile_col(int nt, int jump) { return (nt & 3) * 8 + (nt >> 2) * jump; }

// mma_3xtf32 with B in global memory (read through __ldg, split as it
// loads), a depth of kt steps of 8 (runtime), chains of at most kChain
// steps, and only the n-tiles nt with (nt & 3) < ntw.
template <int NT>
__device__ __forceinline__ void mma_3xtf32_gen(float (&acc)[NT][4], const float* A, int lda,
                                               const float* __restrict__ B, int ldb, int kt,
                                               int jump, int ntw, int lane) {
  const int g = lane >> 2, q = lane & 3;
  for (int k0 = 0; k0 < kt; k0 += kChain) {
    float hh[NT][4] = {}, mx[NT][4] = {};
    const int k1 = min(kt, k0 + kChain);
    for (int kk = k0; kk < k1; ++kk) {
      const float* a = A + kk * 8 + q;
      const uint2 a0 = tf32_pair(a[g * lda]), a1 = tf32_pair(a[(g + 8) * lda]);
      const uint2 a2 = tf32_pair(a[g * lda + 4]), a3 = tf32_pair(a[(g + 8) * lda + 4]);
      const uint32_t ahi[4] = {a0.x, a1.x, a2.x, a3.x}, alo[4] = {a0.y, a1.y, a2.y, a3.y};
      const float* b = B + (kk * 8 + q) * ldb + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if ((nt & 3) >= ntw) continue;
        const int col = tile_col(nt, jump);
        const uint2 b0 = tf32_pair(__ldg(b + col)), b1 = tf32_pair(__ldg(b + 4 * ldb + col));
        mma_tf32(mx[nt], alo, b0.x, b1.x);
        mma_tf32(mx[nt], ahi, b0.y, b1.y);
        mma_tf32(hh[nt], ahi, b0.x, b1.x);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += hh[nt][i] + mx[nt][i];
  }
}

// mma_bf16x3 with B in global memory, a depth of kt steps of 16 (runtime)
// of which the rows from k_valid on read as 0 (A's pad columns are 0: the
// padding is exact), chains of at most kChain steps, n-tiles nt < ntw.
template <int NT>
__device__ __forceinline__ void mma_bf16x3_gen(float (&acc)[NT][4], const float* A, int lda,
                                               const float* __restrict__ B, int ldb, int kt,
                                               int k_valid, int ntw, int lane) {
  const int g = lane >> 2, q = lane & 3;
  for (int k0 = 0; k0 < kt; k0 += kChain) {
    float hh[NT][4] = {}, mx[NT][4] = {};
    const int k1 = min(kt, k0 + kChain);
    for (int kk = k0; kk < k1; ++kk) {
      const float* a = A + kk * 16 + 2 * q;
      uint32_t a1[4], a2[4], a3[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(a + (i & 1) * 8 * lda + (i >> 1) * 8 +
                                                          g * lda);
        split_bf16x3(v.x, v.y, a1[i], a2[i], a3[i]);
      }
      // B rows r, r + 1, r + 8, r + 9; r is even and k_valid a multiple of
      // 8, so r + 1 is valid with r and r + 9 with r + 8
      const int r = kk * 16 + 2 * q;
      const bool lo_ok = r < k_valid, hi_ok = r + 8 < k_valid;
      const float* b = B + r * ldb + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= ntw) continue;
        const float* bn = b + nt * 8;
        uint32_t b1[2], b2[2], b3[2];
        split_bf16x3(lo_ok ? __ldg(bn) : 0.f, lo_ok ? __ldg(bn + ldb) : 0.f, b1[0], b2[0],
                     b3[0]);
        split_bf16x3(hi_ok ? __ldg(bn + 8 * ldb) : 0.f, hi_ok ? __ldg(bn + 9 * ldb) : 0.f,
                     b1[1], b2[1], b3[1]);
        mma_bf16(mx[nt], a3, b1);
        mma_bf16(mx[nt], a2, b2);
        mma_bf16(mx[nt], a1, b3);
        mma_bf16(mx[nt], a2, b1);
        mma_bf16(mx[nt], a1, b2);
        mma_bf16(hh[nt], a1, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += hh[nt][i] + mx[nt][i];
  }
}

// The chunk's real h[src] rows, this warp's slice of each, into g (CH rows
// of kSlice), 16 bytes a copy.
template <typename T, int CH>
__device__ __forceinline__ void gather_slice_async(T* g, const T* __restrict__ h, const Chunk& c,
                                                   const Slice& s, int lane) {
  constexpr int kMaxPieces = kSlice * (int)sizeof(T) / 16;  // 16-byte pieces of a full slice
  const int pieces = s.cw * (int)sizeof(T) / 16;
#pragma unroll
  for (int i = 0; i < CH * kMaxPieces / 32; ++i) {
    const int piece = lane + 32 * i, t = min(piece / pieces, CH - 1), p = piece - t * pieces;
    const int pk = __shfl_sync(kFullMask, c.packed, t);
    const int src = __shfl_sync(kFullMask, c.s, t);
    if (pk >= 0 && piece < CH * pieces)
      cp_async16(reinterpret_cast<char*>(g + t * kSlice) + p * 16,
                 reinterpret_cast<const char*>(h + (size_t)src * s.D + s.c0) + p * 16);
  }
  cp_async_commit();
}

// Add the pass's edges into the warp's columns of their buckets, in CSR
// order.
template <int CH, typename T>
__device__ __forceinline__ void add_slice(float* Y, const T* g, int bucket, const Slice& s,
                                          int lane) {
#pragma unroll
  for (int t = 0; t < CH; ++t) {
    const int p = __shfl_sync(kFullMask, bucket, t);
    if (p >= 0 && lane < s.cw)
      Y[(p >> 2) * s.ys + (p & 3) * s.DK + s.c0 + lane] += to_f32(g[t * kSlice + lane]);
  }
}

// Zero the warp's columns of the first `used` slots.
__device__ __forceinline__ void zero_slice(float* Y, int used, const Slice& s, int lane) {
  if (lane >= s.cw) return;
  for (int k = 0; k < used; ++k)
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) Y[r * s.ys + k * s.DK + s.c0 + lane] = 0.f;
}

// The product phase of a team: once every warp has summed its columns,
// agg (this warp's slice) += each slot's buckets @ its type's block of the
// table, then a barrier so that no bucket is reused while a warp reads it.
template <bool kGru>
__device__ __forceinline__ void products_gen(float (&agg)[4][4], const float* Y, const Slots& sl,
                                             const float* __restrict__ table, const Slice& s,
                                             int team, int lane) {
  team_sync(s, team);
  for (int k = 0; k < sl.used; ++k) {
    const int v = (sl.types >> (8 * k)) & 255u;
    const float* B = table + v * s.D + s.c0;
    if (kGru)
      mma_3xtf32_gen<4>(agg, Y + k * s.DK, s.ys, B, s.VD, s.D / 8, 0, s.ntw, lane);
    else
      mma_bf16x3_gen<4>(agg, Y + k * s.DK, s.ys, B, s.VD, s.DK / 16, s.D, s.ntw, lane);
  }
  team_sync(s, team);
}

// A finished tile: its last products, then the store (message) or the
// GatedUpdate on the team's slices (step); the buckets are zero after it.
template <typename T, bool kGru>
__device__ __forceinline__ void finish_gen(float (&agg)[4][4], float* Y, float* red, Slots& sl,
                                           const float* __restrict__ table,
                                           const float* __restrict__ gru_w,
                                           const float* __restrict__ gru_b,
                                           const float* __restrict__ ln, float ln_eps,
                                           const T* __restrict__ h, float* __restrict__ out,
                                           int tile, int n_nodes, const Slice& s, int team,
                                           int lane) {
  const int D = s.D;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = tile * kTile;
  const int nrows = min(kTile, n_nodes - n0);
  const bool ok0 = g < nrows, ok1 = g + 8 < nrows;  // the C rows g and g + 8
  float hv[4][4] = {};  // the step's h (this slice), in the C layout; loaded ahead of the products
  if (kGru) {
    const T* h0 = h + (size_t)(n0 + g) * D + s.c0 + 2 * q;
    const T* h1 = h0 + 8 * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= s.ntw) continue;
      hv[j][0] = ok0 ? load_f32(h0 + 8 * j) : 0.f;
      hv[j][1] = ok0 ? load_f32(h0 + 8 * j + 1) : 0.f;
      hv[j][2] = ok1 ? load_f32(h1 + 8 * j) : 0.f;
      hv[j][3] = ok1 ? load_f32(h1 + 8 * j + 1) : 0.f;
    }
  }
  products_gen<kGru>(agg, Y, sl, table, s, team, lane);
  float* o0 = out + (size_t)(n0 + g) * D + s.c0 + 2 * q;
  float* o1 = o0 + 8 * D;
  if (!kGru) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= s.ntw) continue;
      if (ok0) *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(agg[j][0], agg[j][1]);
      if (ok1) *reinterpret_cast<float2*>(o1 + 8 * j) = make_float2(agg[j][2], agg[j][3]);
    }
    zero_slice(Y, sl.used, s, lane);
  } else {
    // X = [h | agg] (16 x 2D, row xs) over the buckets, which every warp
    // has read: each warp writes its slices of h and agg
    const int xs = 2 * D + 4;
    float* x0 = Y + g * xs + s.c0 + 2 * q;
    float* x1 = x0 + 8 * xs;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= s.ntw) continue;
      x0[8 * j] = hv[j][0];
      x0[8 * j + 1] = hv[j][1];
      x1[8 * j] = hv[j][2];
      x1[8 * j + 1] = hv[j][3];
      x0[D + 8 * j] = agg[j][0];
      x0[D + 8 * j + 1] = agg[j][1];
      x1[D + 8 * j] = agg[j][2];
      x1[D + 8 * j + 1] = agg[j][3];
    }
    team_sync(s, team);
    float zr[8][4] = {};  // n-tiles 0-3: this slice of z, 4-7: of r
    mma_3xtf32_gen<8>(zr, Y, xs, gru_w + s.c0, 3 * D, 2 * D / 8, D, s.ntw, lane);
    team_sync(s, team);  // X is read: r*h replaces h in it
    float z[4][4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= s.ntw) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = s.c0 + 8 * j + 2 * q + (k & 1);
        z[j][k] = sigmoid_fast(zr[j][k] + __ldg(gru_b + col));
        (k < 2 ? x0 : x1)[8 * j + (k & 1)] =
            sigmoid_fast(zr[4 + j][k] + __ldg(gru_b + D + col)) * hv[j][k];
      }
    }
    team_sync(s, team);
    float cc[4][4] = {};
    mma_3xtf32_gen<4>(cc, Y, xs, gru_w + 2 * D + s.c0, 3 * D, 2 * D / 8, 0, s.ntw, lane);
    float nw[4][4] = {};
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= s.ntw) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = s.c0 + 8 * j + 2 * q + (k & 1);
        const float cand = tanhf(cc[j][k] + __ldg(gru_b + 2 * D + col));
        nw[j][k] = (1.f - z[j][k]) * hv[j][k] + z[j][k] * cand;
        if (k < 2) s0 += nw[j][k]; else s1 += nw[j][k];
      }
    }
    // a row's slice sits in the 4 lanes of a quad; the slices' sums meet in
    // red (slice w, row r at red[w * 16 + r]) and add in slice order
    s0 += __shfl_xor_sync(kFullMask, s0, 1);
    s0 += __shfl_xor_sync(kFullMask, s0, 2);
    s1 += __shfl_xor_sync(kFullMask, s1, 1);
    s1 += __shfl_xor_sync(kFullMask, s1, 2);
    if (q == 0) {
      red[s.w * kTile + g] = s0;
      red[s.w * kTile + g + 8] = s1;
    }
    team_sync(s, team);
    float t0 = 0.f, t1 = 0.f;
    for (int w = 0; w < s.W; ++w) {
      t0 += red[w * kTile + g];
      t1 += red[w * kTile + g + 8];
    }
    const float mean0 = t0 / D, mean1 = t1 / D;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= s.ntw) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = nw[j][k] - (k < 2 ? mean0 : mean1);
        if (k < 2) v0 += d * d; else v1 += d * d;
      }
    }
    v0 += __shfl_xor_sync(kFullMask, v0, 1);
    v0 += __shfl_xor_sync(kFullMask, v0, 2);
    v1 += __shfl_xor_sync(kFullMask, v1, 1);
    v1 += __shfl_xor_sync(kFullMask, v1, 2);
    float* sq = red + s.W * kTile;
    if (q == 0) {
      sq[s.w * kTile + g] = v0;
      sq[s.w * kTile + g + 8] = v1;
    }
    team_sync(s, team);
    t0 = t1 = 0.f;
    for (int w = 0; w < s.W; ++w) {
      t0 += sq[w * kTile + g];
      t1 += sq[w * kTile + g + 8];
    }
    const float inv0 = rsqrtf(t0 / D + ln_eps), inv1 = rsqrtf(t1 / D + ln_eps);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= s.ntw) continue;
      float y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = s.c0 + 8 * j + 2 * q + (k & 1);
        const float mean = k < 2 ? mean0 : mean1, inv = k < 2 ? inv0 : inv1;
        y[k] = (nw[j][k] - mean) * inv * __ldg(ln + col) + __ldg(ln + D + col) + hv[j][k];
      }
      if (ok0) *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(y[0], y[1]);
      if (ok1) *reinterpret_cast<float2*>(o1 + 8 * j) = make_float2(y[2], y[3]);
    }
    // every read of X and of the buckets is behind the syncs above: the
    // team zeroes its buckets (X and every slot), a share a warp, and waits
    // for that before the next tile's sums
    float4* y4 = reinterpret_cast<float4*>(Y);
    for (int i = s.w * 32 + lane; i < kTile * s.ys / 4; i += 32 * s.W)
      y4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    team_sync(s, team);
  }
  sl = Slots();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) agg[j][k] = 0.f;
}

// Any D (a multiple of 8, 8 to 128): a block holds `teams` teams of
// team_warps(D) warps; a team walks its tiles together, each warp on its
// slice of the columns. Shared memory: every team's buckets (and row sums),
// then every warp's two row buffers.
template <typename T, bool kGru>
__global__ void __launch_bounds__(max_warps(kGru) * 32)
fused_message_gen_kernel(const T* __restrict__ h, const float* __restrict__ table,
                         const int* __restrict__ bond, const int* __restrict__ src,
                         const uint8_t* __restrict__ mask, const int* __restrict__ rowptr,
                         const float* __restrict__ gru_w, const float* __restrict__ gru_b,
                         const float* __restrict__ ln, float ln_eps, float* __restrict__ out,
                         int n_nodes, int dim, int n_types) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Slice s;
  s.D = dim;
  s.DK = gen_depth(dim, kGru);
  s.ys = gen_y_stride(dim, kGru);
  s.VD = n_types * dim;
  s.W = team_warps(dim);
  s.w = warp % s.W;
  s.c0 = s.w * kSlice;
  s.cw = min(kSlice, dim - s.c0);
  s.ntw = s.cw / 8;
  const int team = warp / s.W, teams = (blockDim.x >> 5) / s.W;
  const int team_floats = gen_team_bytes(dim, kGru) / 4;
  float* Y = reinterpret_cast<float*>(smem_raw) + team * team_floats;  // (16, kSlots*DK), row ys
  float* red = Y + kTile * s.ys;  // the step's (2, W, 16) row sums
  T* G = reinterpret_cast<T*>(smem_raw + teams * gen_team_bytes(dim, kGru)) +
         warp * 2 * kChunk * kSlice;  // two (kChunk, kSlice) row buffers

  float4* all4 = reinterpret_cast<float4*>(smem_raw);
  for (int i = threadIdx.x; i < teams * team_floats / 4; i += blockDim.x)
    all4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // tiles are dealt to the blocks first, as in the specialisation; every
  // warp of a team takes the same tiles
  Slots sl;
  float agg[4][4] = {};
  walk_chunks<kChunk>(
      rowptr, src, bond, mask, n_nodes, team * gridDim.x + blockIdx.x, gridDim.x * teams, lane,
      [&](int b, const Chunk& c) {
        gather_slice_async<T, kChunk>(G + b * kChunk * kSlice, h, c, s, lane);
      },
      [&](int b, const Chunk& cur) {
        for (uint32_t todo = cur.types;;) {
          const int bucket = take_slots(sl, todo, cur);
          add_slice<kChunk>(Y, G + b * kChunk * kSlice, bucket, s, lane);
          todo &= ~sl.mask;
          if (!todo) break;
          products_gen<kGru>(agg, Y, sl, table, s, team, lane);
          zero_slice(Y, sl.used, s, lane);
          sl = Slots();
        }
        __syncwarp();
        if (cur.last)
          finish_gen<T, kGru>(agg, Y, red, sl, table, gru_w, gru_b, ln, ln_eps, h, out,
                              cur.tile, n_nodes, s, team, lane);
      });
}

// As many teams per block as shared memory holds, up to max_warps warps.
template <typename T, bool kGru>
int run_gen(const void* h, const float* table, const int* bond, const int* src,
            const uint8_t* mask, const int* rowptr, const float* gru_w, const float* gru_b,
            const float* ln, float ln_eps, float* out, int n_nodes, int dim, int n_types,
            cudaStream_t stream) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const int W = team_warps(dim);
  const size_t per_team = gen_team_bytes(dim, kGru) + W * gen_warp_bytes(sizeof(T));
  if (per_team > (size_t)optin) return (int)cudaErrorInvalidValue;
  const size_t fit = optin / per_team;
  const int teams = (int)(fit < (size_t)(max_warps(kGru) / W) ? fit : max_warps(kGru) / W);
  const size_t smem = teams * per_team;
  auto kernel = fused_message_gen_kernel<T, kGru>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes > 0) {
    const long tiles = (n_nodes + kTile - 1) / kTile;
    const int threads = teams * W * 32;
    const int grid = resident_grid(kernel, threads, smem, (tiles + teams - 1) / teams);
    kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(h), table, bond, src, mask,
                                            rowptr, gru_w, gru_b, ln, ln_eps, out, n_nodes,
                                            dim, n_types);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ dispatch

// The most bond types a width takes: 32 at every D that is a multiple of 8
// from 8 to 128, none at any other.
inline int max_types(int dim) {
  return dim >= 8 && dim <= kMaxDim && dim % 8 == 0 ? kMaxTypes : 0;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool kGru>
int dispatch_fused(const void* h, int h_dtype, const float* table, const int* bond,
                   const int* src, const uint8_t* mask, const int* rowptr,
                   const float* gru_w, const float* gru_b, const float* ln, float ln_eps,
                   float* out, int n_nodes, int dim, int n_types, cudaStream_t s) {
  if (n_types <= 0 || n_types > max_types(dim)) return (int)cudaErrorInvalidValue;
  if (!aligned16(h) || !aligned16(table) || !aligned16(out) ||
      (kGru && (!aligned16(gru_w) || !aligned16(gru_b) || !aligned16(ln))))
    return (int)cudaErrorMisalignedAddress;
#define IONIC_ARGS h, table, bond, src, mask, rowptr, gru_w, gru_b, ln, ln_eps, out, n_nodes
#ifndef IONIC_NO_D32_SPECIALISATION  // defined only to time the general kernel at D = 32
  if (dim == kTcDim) {
    if (h_dtype == kF32) return run_tc<float, kGru>(IONIC_ARGS, n_types, s);
    if (h_dtype == kBF16) return run_tc<__nv_bfloat16, kGru>(IONIC_ARGS, n_types, s);
    return (int)cudaErrorInvalidValue;
  }
#endif
  if (h_dtype == kF32) return run_gen<float, kGru>(IONIC_ARGS, dim, n_types, s);
  if (h_dtype == kBF16) return run_gen<__nv_bfloat16, kGru>(IONIC_ARGS, dim, n_types, s);
#undef IONIC_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace ionic

// The most bond types the fused kernels take at this width (0: not a width
// they take).
IONIC_API int ionic_fused_max_types(int dim) { return ionic::max_types(dim); }

// Dynamic shared memory one block may opt in to on the current device.
IONIC_API int ionic_max_dynamic_smem(void) {
  int device = 0, bytes = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// The least dynamic shared memory a launch at this width and type count
// needs (at D = 32: the staged operands and one warp's tile and row
// buffers; at any other D: one team's buckets and row buffers), or -1 for a
// shape the kernels do not take.
IONIC_API int ionic_fused_smem_bytes(int dim, int n_types, int gru) {
  if (n_types <= 0 || n_types > ionic::max_types(dim)) return -1;
  if (dim == ionic::kTcDim)
    return (int)(ionic::tc_fixed_bytes(n_types, gru != 0) +
                 ionic::tc_warp_bytes(sizeof(float), gru != 0));
  return ionic::gen_team_bytes(dim, gru != 0) +
         ionic::team_warps(dim) * ionic::gen_warp_bytes(sizeof(float));
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
