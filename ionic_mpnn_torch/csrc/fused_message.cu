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
// each. Three kernels share one design and its arithmetic:
// fused_message_tc_kernel, the D = 32 specialisation (the model's width:
// the table and the step's weights staged in shared memory); at every other
// width fused_message_gen_kernel (64-row blocks, operands split once per
// call by a prologue and staged by TMA) where its grid fills the card, and
// fused_message_team_kernel (warp teams on 32-column slices of a 16-row
// tile, operands read through L2) where it does not: a small graph, D < 64,
// and the message at D = 64. dispatch_fused chooses by D, the node count
// and kGru (use_blocks).
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
// block's 227 KB of shared memory, so neither is staged whole. Instead:
//  - a prologue (fused_message_split_kernel) splits every B operand once
//    per call into scratch the wrapper allocates: the table's type panels
//    into bf16 (hi, mid, lo) planes, the step's [Wz | Wr | Wh] into TF32
//    (hi, lo) planes, each k-slice laid out as it is staged (rows padded
//    for ldmatrix), so no split is left in a product's inner loop;
//  - a block owns 64 destination nodes (4 tiles of 16) and holds their
//    (node, bond type) buckets; each tile's edges are walked once, by one
//    warp, whole h[src] rows gathered by cp.async one chunk ahead;
//  - the k-slices of each type's panel, then of W, stream through a ring of
//    two or three stages in shared memory by TMA bulk copies on mbarriers,
//    the next landing while the current one is multiplied; each staged
//    slice serves every tile of the block that holds the type (the gates:
//    all 64 rows), where a 16-row tile reading B from L2 gets no reuse
//    beyond its rows;
//  - mma.sync fragments come from shared memory by ldmatrix; the message
//    and the step's aggregate take the exact bf16 split (six products), the
//    step's gates 3xTF32, chains of at most 8 depth steps as above;
//  - the step's epilogue runs on the 64 rows in shared memory: X = [h |
//    agg], z and r*h, the candidate and the new state, then the LayerNorm
//    per row over the true D (the mean, then mean((x - mu)^2)).
// The budget of a block's shared memory is worked out where the kernel
// begins, below.
#include <climits>

#include "common.cuh"
#include "fused_walk.cuh"

namespace ionic {

// ------------------------------------------------------------ D = 32: tensor cores

constexpr int kTcDim = 32;    // the width the tensor-core kernel serves
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

// ---- the bucket phase ----

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

// ------------------------------------------------------------ any D: 64-row blocks
//
// Budget of a block's shared memory (232,448 bytes on an H100), in three
// regions that live at once:
//  - a 256-byte header: the ring's mbarriers and the walkers' flags;
//  - the ring: gen_stages(D) stages (2 at D <= 64, 3 above) of max(a
//    message k-slice, a gate k-slice):
//      message k-slice: 3 bf16 planes x D rows x kKsPad = 240 D bytes
//                       (D = 64: 15,360; D = 128: 30,720);
//      gate k-slice:    2 TF32 planes x gate_cols rows x (gate_ks + 4) x 4
//                       (NT = 4: 32 x 68, 17,408; NT = 8: 128 x 20, 20,480);
//  - region A, the walk's buckets and row buffers, which the step's gates
//    take over once the last product has read the buckets:
//      buckets:     4 tiles x slots x 16 rows x (DK + 8) f32
//                   (D = 64: 18,432 a slot; D = 128: 34,816 a slot);
//      row buffers: 4 walkers x 2 x 16 rows x D x sizeof(h)
//                   (f32: D = 64 32,768, D = 128 65,536; bf16 half);
//      gates:       X = [h | agg] and ZR = [z | r*h], 2 x 64 x (2D + 4) f32
//                   (D = 64: 67,584; D = 128: 133,120).
// slots is the most (up to 4) with which the f32 step fits: at D <= 64 in
// two blocks an SM (115,712 bytes each), above in one. D = 64: 2 slots,
// 104,704 bytes; D = 128: 2 slots, 227,584 bytes (a third stage, where a
// third slot would not fit). A tile that meets more types than that
// flushes, as the specialisation does; at the bench's cation shape 99.4% of
// the tiles hold at most 2 types.

constexpr int kChain = 8;      // depth steps per accumulation chain
constexpr int kBlockTiles = 4;                   // tiles of 16 destination nodes a block owns
constexpr int kBlockRows = kBlockTiles * kTile;  // 64
constexpr int kGenWarps = 2 * kBlockTiles;       // a tile's two column halves, or 2 x 4 for the gates
constexpr int kMaxStages = 3;                    // the ring of staged k-slices, at most
constexpr int kKs = 32;                          // depth of a message k-slice (two bf16 k-steps)
constexpr int kKsPad = kKs + 8;  // bf16 a staged row: 80 bytes, so ldmatrix's 8 rows meet 8 bank groups
constexpr int kGenHeader = 256;
constexpr size_t kSmemOneBlock = 232448;  // H100: the most one block may take
constexpr size_t kSmemTwoBlocks = 115712;  // each of two blocks an SM (228 KB, 1 KB reserved each)

// n-tiles of 8 columns a warp holds of a product: a message half-row of
// D / 16, a gate group's quarter times 2 m-tiles
__host__ __device__ constexpr int gen_nt(int dim) { return dim <= 64 ? 4 : 8; }
// The ring's stages: 3 where one block fills an SM (D > 64), 2 where two do.
__host__ __device__ constexpr int gen_stages(int dim) { return gen_nt(dim) == 8 ? 3 : 2; }
// The message's depth: D zero-padded to whole k-slices.
__host__ __device__ constexpr int gen_depth(int dim) { return round_up(dim, kKs); }
// A bucket row, padded to 8 mod 32 floats: the A fragments' float2 loads are
// free of bank conflicts.
__host__ __device__ constexpr int gen_ys(int dim) { return gen_depth(dim) + 8; }
// A row of X and ZR (2D + 4 floats: 16 bytes mod 64, so ldmatrix's 8 rows
// meet 8 bank groups).
__host__ __device__ constexpr int gen_xs(int dim) { return 2 * dim + 4; }
// The gates: W's 3D columns in groups of gate_cols(nt), a warp a quarter of
// a group (gate_nt n-tiles) over 32 rows; k-slices of gate_ks(nt) (8 or 2
// TF32 k-steps). At D <= 64 a warp holds 1 n-tile, so that the gates'
// chains and sums fit two blocks an SM.
__host__ __device__ constexpr int gate_nt(int nt) { return nt == 8 ? 4 : 1; }
__host__ __device__ constexpr int gate_cols(int nt) { return 32 * gate_nt(nt); }
__host__ __device__ constexpr int gate_ks(int nt) { return nt == 4 ? 64 : 16; }
__host__ __device__ constexpr int gate_pad(int nt) { return gate_ks(nt) + 4; }
__host__ __device__ constexpr int k_stage_bytes(int dim) { return 3 * dim * kKsPad * 2; }
__host__ __device__ constexpr int w_stage_bytes(int nt) {
  return 2 * gate_cols(nt) * gate_pad(nt) * 4;
}
__host__ __device__ constexpr int gen_stage_bytes(int dim, bool gru) {
  return round_up(gru && w_stage_bytes(gen_nt(dim)) > k_stage_bytes(dim)
                      ? w_stage_bytes(gen_nt(dim)) : k_stage_bytes(dim), 128);
}
// [Wz | Wr] in groups, then Wh in groups: a group never spans the two.
__host__ __device__ constexpr int gate_groups_zr(int dim) {
  return (2 * dim + gate_cols(gen_nt(dim)) - 1) / gate_cols(gen_nt(dim));
}
__host__ __device__ constexpr int gate_groups(int dim) {
  return gate_groups_zr(dim) + (dim + gate_cols(gen_nt(dim)) - 1) / gate_cols(gen_nt(dim));
}
__host__ __device__ constexpr int gate_slices(int dim) {  // k-slices of a group
  return (2 * dim + gate_ks(gen_nt(dim)) - 1) / gate_ks(gen_nt(dim));
}

__host__ __device__ constexpr size_t gen_region_bytes(int dim, int slots, int elem, bool gru) {
  return (size_t)4 * kBlockTiles * slots * kTile * gen_ys(dim) +
                     (size_t)kBlockTiles * 2 * kChunk * dim * elem >
                 (gru ? (size_t)4 * 2 * kBlockRows * gen_xs(dim) : 0)
             ? (size_t)4 * kBlockTiles * slots * kTile * gen_ys(dim) +
                   (size_t)kBlockTiles * 2 * kChunk * dim * elem
             : (size_t)4 * 2 * kBlockRows * gen_xs(dim);
}
__host__ __device__ constexpr size_t gen_smem_bytes(int dim, int slots, int elem, bool gru) {
  return kGenHeader + (size_t)gen_stages(dim) * gen_stage_bytes(dim, gru) +
         gen_region_bytes(dim, slots, elem, gru);
}
// A width's bucket slots: the most, up to kSlots, with which the f32 step
// fits its blocks (two an SM at D <= 64, one above). The CPU mirror
// (tests/test_torch_tensorcore_math.py) takes the same count.
__host__ __device__ constexpr int gen_slots(int dim) {
  for (int s = kSlots; s > 1; --s)
    if (gen_smem_bytes(dim, s, 4, true) <= (gen_nt(dim) == 4 ? kSmemTwoBlocks : kSmemOneBlock))
      return s;
  return 1;
}
static_assert(gen_slots(64) == 2 && gen_smem_bytes(64, 2, 4, true) == 104704, "the budget");
static_assert(gen_slots(128) == 2 && gen_smem_bytes(128, 2, 4, true) == 227584, "the budget");

// The scratch the wrapper allocates: the table's type panels, 3 bf16 planes
// per k-slice (one TMA copy a stage), then, for the step, W's (hi, lo)
// planes per group and k-slice.
__host__ __device__ constexpr size_t k_scratch_bytes(int dim, int n_types) {
  return (size_t)n_types * (gen_depth(dim) / kKs) * k_stage_bytes(dim);
}
__host__ __device__ constexpr size_t w_scratch_offset(int dim, int n_types) {
  return (k_scratch_bytes(dim, n_types) + 127) / 128 * 128;
}
__host__ __device__ constexpr size_t scratch_bytes(int dim, int n_types, bool gru) {
  return w_scratch_offset(dim, n_types) +
         (gru ? (size_t)gate_groups(dim) * gate_slices(dim) * w_stage_bytes(gen_nt(dim)) : 0);
}

// Group gi of W's columns: [c0, c0 + width).
__host__ __device__ inline void gate_group(int dim, int gi, int& c0, int& width) {
  const int cols = gate_cols(gen_nt(dim)), zr = gate_groups_zr(dim);
  if (gi < zr) {
    c0 = gi * cols;
    width = min(cols, 2 * dim - c0);
  } else {
    c0 = 2 * dim + (gi - zr) * cols;
    width = min(cols, 3 * dim - c0);
  }
}

// ---- the prologue: every B operand split once per call ----

// The table's type panels as 3 bf16 planes [n][k] per k-slice of kKs, each
// entry K[k, v*D + n] split exactly as split_bf16x3 splits it (0 past D);
// with gru, [Wz | Wr | Wh] as TF32 (hi, lo) planes [n][k] per column group
// and k-slice (hi = rna(x), lo = rna(x - hi)). A thread takes 8 (a table
// piece) or 4 (W) consecutive k of one n and stores each plane's 16 bytes;
// n runs fastest across threads, so the reads coalesce. Row pads are left
// as they are: nothing reads them.
__global__ void __launch_bounds__(256)
fused_message_split_kernel(const float* __restrict__ table, const float* __restrict__ gru_w,
                           unsigned char* __restrict__ scratch, int dim, int n_types, int gru) {
  const long stride = (long)gridDim.x * blockDim.x;
  const long first = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nks = gen_depth(dim) / kKs, VD = n_types * dim;
  const long plane = (long)dim * kKsPad;
  const long k_items = (long)n_types * nks * (kKs / 8) * dim;
  __nv_bfloat16* kp = reinterpret_cast<__nv_bfloat16*>(scratch);
  for (long i = first; i < k_items; i += stride) {
    const int n = (int)(i % dim);
    long r = i / dim;
    const int c = (int)(r % (kKs / 8));
    r /= kKs / 8;
    const int s = (int)(r % nks), v = (int)(r / nks);
    uint32_t p[3][4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int k = s * kKs + c * 8 + e;  // k and k + 1: dim is a multiple of 8
      const float x0 = k < dim ? table[(long)k * VD + v * dim + n] : 0.f;
      const float x1 = k < dim ? table[(long)(k + 1) * VD + v * dim + n] : 0.f;
      split_bf16x3(x0, x1, p[0][e / 2], p[1][e / 2], p[2][e / 2]);
    }
    __nv_bfloat16* d = kp + (long)(v * nks + s) * 3 * plane + (long)n * kKsPad + c * 8;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      *reinterpret_cast<uint4*>(d + t * plane) = make_uint4(p[t][0], p[t][1], p[t][2], p[t][3]);
  }
  if (!gru) return;
  const int nt = gen_nt(dim), cols = gate_cols(nt), ks = gate_ks(nt), pad = gate_pad(nt);
  const int nkw = gate_slices(dim);
  const long wplane = (long)cols * pad;
  const long w_items = (long)gate_groups(dim) * nkw * (ks / 4) * cols;
  uint32_t* wp = reinterpret_cast<uint32_t*>(scratch + w_scratch_offset(dim, n_types));
  for (long i = first; i < w_items; i += stride) {
    const int n = (int)(i % cols);
    long r = i / cols;
    const int c = (int)(r % (ks / 4));
    r /= ks / 4;
    const int s = (int)(r % nkw), gi = (int)(r / nkw);
    int c0, width;
    gate_group(dim, gi, c0, width);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = s * ks + c * 4 + e;
      split_tf32(k < 2 * dim && n < width ? gru_w[(long)k * 3 * dim + c0 + n] : 0.f, hi[e],
                 lo[e]);
    }
    uint32_t* d = wp + (long)(gi * nkw + s) * 2 * wplane + (long)n * pad + c * 4;
    *reinterpret_cast<uint4*>(d) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(d + wplane) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// ---- the products: fragments from shared memory ----

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// acc += A[16 x kKs] @ B[kKs x 8 ntw] for the warp's n-tiles nt0 .. nt0 +
// ntw - 1. A: a tile's bucket of one type (f32, row stride ys), split into
// three bf16 parts as its fragments load (both k-steps' first, each feeding
// ntw n-tiles); B: a staged k-slice, three bf16 planes [n][kKsPad] (plane
// apart), whose fragments ldmatrix loads as they are: lanes 8m .. 8m + 7
// address the 8 rows of matrix m. The six products of mma_bf16x3, small ones
// into one chain and x1*y1 into another, both of the slice's two k-steps
// (a chain of 2), added into acc in f32: one n-tile's chains live at a
// time, so a warp's registers hold no more than its acc and the slice's A.
// hh, mx += A[16 x kKs] @ B[kKs x 8 ntw] for the warp's n-tiles nt0 .. nt0 +
// ntw - 1. A: a tile's bucket of one type (f32, row stride ys), split into
// three bf16 parts as its fragments load (each feeds ntw n-tiles); B: a
// staged k-slice, three bf16 planes [n][kKsPad] (plane apart), whose
// fragments ldmatrix loads as they are: lanes 8m .. 8m + 7 address the 8
// rows of matrix m. The six products of mma_bf16x3, small ones into mx; the
// n-tiles' chains are independent, and with kFull (ntw == NT, no guard
// between the n-tiles) the compiler interleaves them, so that the products
// of one chain do not wait on each other.
template <int NT, bool kFull>
__device__ __forceinline__ void message_slice(float (&hh)[NT][4], float (&mx)[NT][4],
                                              const float* A, int ys, const __nv_bfloat16* B,
                                              int plane, int nt0, int ntw, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kKs / 16; ++kk) {
    const float* a = A + kk * 16 + 2 * q + g * ys;
    uint32_t a1[4], a2[4], a3[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(a + (i & 1) * 8 * ys + (i >> 1) * 8);
      split_bf16x3(v.x, v.y, a1[i], a2[i], a3[i]);
    }
    // x4: planes 0 and 1 (lanes 16-31), k halves 0 and 1; x2: plane 2
    const __nv_bfloat16* b = B + (lane & 7) * kKsPad + kk * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (!kFull && j >= ntw) break;
      const __nv_bfloat16* bn = b + (nt0 + j) * 8 * kKsPad;
      uint32_t p12[4], p3[2];
      ldsm_x4(p12, bn + (lane >> 4) * plane);
      ldsm_x2(p3, bn + 2 * plane);
      const uint32_t b1[2] = {p12[0], p12[1]}, b2[2] = {p12[2], p12[3]};
      mma_bf16(mx[j], a3, b1);
      mma_bf16(mx[j], a2, b2);
      mma_bf16(mx[j], a1, p3);
      mma_bf16(mx[j], a2, b1);
      mma_bf16(mx[j], a1, b2);
      mma_bf16(hh[j], a1, b1);
    }
  }
}

// hh, mx += A[32 x KS] @ B[KS x 8 ntw] for a warp's 2 m-tiles and its
// n-tiles nt0 .. nt0 + ntw - 1 of a gate group, in 3xTF32 as mma_3xtf32.
// A: 32 rows of X (row stride xs) at columns k0 .., or, for the candidate,
// r*h from A_lo for the columns below k_split (both point at column 0 of
// their first row); ldmatrix loads the f32 fragments (a 32-bit word a lane)
// and each is split as it loads. B: a staged k-slice, (hi, lo) planes
// [n][KS + 4] (wplane apart). Depth steps at or past k_end are skipped; with
// kFull (ntw == gate_nt(NT)) no guard stands between the n-tiles.
template <int NT, bool kFull>
__device__ __forceinline__ void gate_slice(float (&hh)[2][gate_nt(NT)][4],
                                           float (&mx)[2][gate_nt(NT)][4],
                                           const float* A, const float* A_lo, int k_split, int xs,
                                           int k0, int k_end, const uint32_t* B, int wplane,
                                           int nt0, int ntw, int lane) {
  constexpr int KS = gate_ks(NT), PAD = gate_pad(NT);
  // matrix m of an x4: rows (m & 1) * 8 .., columns (m >> 1) * 4 .. of the
  // A fragment; planes (m >> 1), k halves (m & 1) of the B fragment
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 4;
  const uint32_t* b = B + (lane & 7) * PAD + ((lane >> 3) & 1) * 4 + (lane >> 4) * wplane;
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk) {
    const int k = k0 + kk * 8;
    if (k >= k_end) break;
    const float* src = (k < k_split ? A_lo : A) + k + a_col;
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t a[4];
      ldsm_x4(a, src + (16 * m + a_row) * xs);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ahi[m][i], alo[m][i]);
    }
#pragma unroll
    for (int j = 0; j < gate_nt(NT); ++j) {
      if (!kFull && j >= ntw) break;
      uint32_t bf[4];  // hi b0, hi b1, lo b0, lo b1
      ldsm_x4(bf, b + (nt0 + j) * 8 * PAD + kk * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_tf32(mx[m][j], alo[m], bf[0], bf[1]);
        mma_tf32(mx[m][j], ahi[m], bf[2], bf[3]);
        mma_tf32(hh[m][j], ahi[m], bf[0], bf[1]);
      }
    }
  }
}

// ---- the walk ----

__device__ __forceinline__ void add4(float* y, const float* g) {
  float4 a = *reinterpret_cast<float4*>(y);
  const float4 b = *reinterpret_cast<const float4*>(g);
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  *reinterpret_cast<float4*>(y) = a;
}

__device__ __forceinline__ void add4(float* y, const __nv_bfloat16* g) {
  const uint2 u = *reinterpret_cast<const uint2*>(g);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  float4 a = *reinterpret_cast<float4*>(y);
  a.x += lo.x;
  a.y += lo.y;
  a.z += hi.x;
  a.w += hi.y;
  *reinterpret_cast<float4*>(y) = a;
}

// Add the pass's edges into their buckets of the tile's slots (Yt: slot,
// row, ys), in CSR order, 4 columns a lane.
template <typename T>
__device__ __forceinline__ void add_chunk(float* Yt, const T* g, int bucket, int dim, int ys,
                                          int lane) {
  for (int t = 0; t < kChunk; ++t) {
    const int p = __shfl_sync(kFullMask, bucket, t);
    if (p < 0) continue;
    float* y = Yt + ((p & 3) * kTile + (p >> 2)) * ys;
    for (int c = 4 * lane; c < dim; c += 128) add4(y + c, g + t * dim + c);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// ---- the block ----

// The header: the ring's barriers and, per round (parity), what each walker
// publishes: its tile's slots, whether types of its chunk were left without
// one, whether chunks are left.
// The ring's producer (thread 0 alone): the stream it issues from, and how
// far. The stream: a round's k-slices (nks for each type of `types`, in
// type order), then, after the step's last round, W's slices.
struct Producer {
  uint32_t types;
  int start, klen, wlen, issued;
};

struct GenShared {
  uint64_t full[kMaxStages];
  Producer prod;
  uint32_t types[2][kBlockTiles], mask[2][kBlockTiles];
  int used[2][kBlockTiles], pend[2][kBlockTiles], alive[2][kBlockTiles];
};
static_assert(sizeof(GenShared) <= kGenHeader, "the header");

// The ring: `stages` stages of `stage` bytes; every thread counts the
// slices consumed. Thread 0 keeps `stages` copies in flight: it issues a
// slice once the barrier after the use of the slice `stages` before it has
// passed.
struct Ring {
  unsigned char* buf;
  uint64_t* full;
  int stage, stages, consumed;
};

// The scratch's offsets are worked out here, in thread 0 alone: no other
// thread holds them in registers.
template <int NT>
__device__ __forceinline__ void ring_top_up(const Ring& r, Producer& p,
                                            const unsigned char* scratch, int dim,
                                            int n_types) {
  const int nks = gen_depth(dim) / kKs, kbytes = k_stage_bytes(dim), wbytes = w_stage_bytes(NT);
  const unsigned char* kscr = scratch;
  const unsigned char* wscr = scratch + w_scratch_offset(dim, n_types);
  const int end = p.start + p.klen + p.wlen;
  while (p.issued < r.consumed + r.stages && p.issued < end) {
    const int j = p.issued - p.start;
    const unsigned char* from;
    int bytes;
    if (j < p.klen) {
      uint32_t m = p.types;
      for (int i = j / nks; i > 0; --i) m &= m - 1;
      from = kscr + (size_t)((__ffs(m) - 1) * nks + j % nks) * kbytes;
      bytes = kbytes;
    } else {
      from = wscr + (size_t)(j - p.klen) * wbytes;
      bytes = wbytes;
    }
    uint64_t* bar = r.full + p.issued % r.stages;
    mbar_expect_tx(bar, bytes);
    bulk_copy(r.buf + (p.issued % r.stages) * r.stage, from, bytes, bar);
    ++p.issued;
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Any D (a multiple of 8, 8 to 128): a block of 8 warps owns 64 consecutive
// destination nodes, 4 tiles of 16.
//  - Walk: warp t < 4 walks tile t's edges once, in chunks of 16 (edge
//    arrays one chunk ahead, whole h[src] rows by cp.async one chunk ahead)
//    and sums them into its buckets in CSR order. The walkers go in rounds
//    of a chunk each, between block barriers; a round in which a chunk met
//    more types than its tile's free slots runs the products on every
//    tile's slots (a flush), zeroes the buckets, and the walker goes on
//    with the chunk's other types.
//  - Products, once per round that flushes and once at the end: for each
//    type any tile holds, in type order, its panel streams through the
//    ring in k-slices, and each warp whose tile holds the type multiplies
//    the bucket by it (warp w: tile w & 3, column half w >> 2) into two
//    chains added into agg (registers) after the type's last slice.
//  - The message stores agg. The step writes X = [h | agg] over the walk's
//    region, then streams W through the same ring, group by group (warp w:
//    rows 32 (w & 1) .., a quarter w >> 1 of the group's columns): z and
//    r*h into ZR, then the candidate from [r*h | agg] and the new state
//    over z; then per row the LayerNorm and the residual (h from X).
// mma.sync (m16n8k16 bf16, m16n8k8 TF32) with B fragments by ldmatrix from
// the staged slices, not wgmma: a type's product runs only on the tiles that
// hold it (1.45 of a block's 4 at the cation shape, where the block holds
// 2.1 types; m64 would multiply every row), the exact bf16 split and the
// TF32 rounding of A take place in registers between the loads and the
// products, and the m16 fragments let a warp skip what it does not hold.
template <typename T, bool kGru, int NT>
__global__ void __launch_bounds__(kGenWarps * 32, NT == 4 ? 2 : 1)
fused_message_gen_kernel(const T* __restrict__ h, const unsigned char* __restrict__ scratch,
                         const int* __restrict__ bond, const int* __restrict__ src,
                         const uint8_t* __restrict__ mask, const int* __restrict__ rowptr,
                         const float* __restrict__ gru_b, const float* __restrict__ ln,
                         float ln_eps, float* __restrict__ out, int n_nodes, int dim,
                         int n_types, int slots) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  GenShared& sh = *reinterpret_cast<GenShared*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int ys = gen_ys(dim), nks = gen_depth(dim) / kKs;
  Ring ring;
  ring.buf = smem_raw + kGenHeader;
  ring.full = sh.full;
  ring.stage = gen_stage_bytes(dim, kGru);
  ring.stages = gen_stages(NT == 8 ? kMaxDim : 8);  // 3 or 2, a constant of the instantiation
  ring.consumed = 0;
  float* Y = reinterpret_cast<float*>(ring.buf + ring.stages * ring.stage);  // (tile, slot, 16, ys)
  const int tile_floats = slots * kTile * ys;
  T* G = reinterpret_cast<T*>(Y + kBlockTiles * tile_floats);  // a walker's two (kChunk, dim)
  const int row0 = blockIdx.x * kBlockRows;

  auto zero_buckets = [&]() {
    float4* y4 = reinterpret_cast<float4*>(Y);
    for (int i = tid; i < kBlockTiles * tile_floats / 4; i += blockDim.x)
      y4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  zero_buckets();
  if (tid == 0) {
    for (int i = 0; i < ring.stages; ++i) mbar_init(&sh.full[i], 1);
    sh.prod = Producer{0, 0, 0, 0, 0};
  }

  auto top_up = [&]() {
    if (tid == 0) ring_top_up<NT>(ring, sh.prod, scratch, dim, n_types);
  };
  auto next_slice = [&]() {
    mbar_wait(ring.full + ring.consumed % ring.stages, (ring.consumed / ring.stages) & 1);
    return ring.buf + (ring.consumed % ring.stages) * ring.stage;
  };
  auto release = [&]() {  // after a slice: the barrier, then the next copy
    __syncthreads();
    ++ring.consumed;
    top_up();
  };

  // ---- the message products of a round ----
  const int mt = warp & 3;
  const int ntt = dim / 8, half = (ntt + 1) / 2;
  const int mnt0 = (warp >> 2) * half, mntw = max(0, min(half, ntt - mnt0));
  float agg[NT][4] = {};
  auto products = [&](int par, bool last) {
    uint32_t U = 0;
#pragma unroll
    for (int t = 0; t < kBlockTiles; ++t) U |= sh.mask[par][t];
    if (tid == 0) {
      sh.prod.types = U;
      sh.prod.start = ring.consumed;
      sh.prod.klen = __popc(U) * nks;
      sh.prod.wlen = kGru && last ? gate_groups(dim) * gate_slices(dim) : 0;
    }
    top_up();
    const uint32_t mine = sh.types[par][mt];
    const int used = sh.used[par][mt];
    for (uint32_t m = U; m; m &= m - 1) {
      const uint32_t v = __ffs(m) - 1;
      int k = -1;
      for (int j = 0; j < used; ++j)
        if (((mine >> (8 * j)) & 255u) == v) k = j;
      float hh[NT][4] = {}, mx[NT][4] = {};
      const float* A = Y + (mt * slots + max(k, 0)) * kTile * ys;
      for (int s = 0; s < nks; ++s) {
        const __nv_bfloat16* B = reinterpret_cast<const __nv_bfloat16*>(next_slice());
        // the n-tiles interleave only where one block fills an SM (at two
        // an SM their fragments would not fit the registers), and not in a
        // flush, which keeps the walk's registers
        if (k >= 0 && NT == 8 && last && mntw == NT)
          message_slice<NT, true>(hh, mx, A + s * kKs, ys, B, dim * kKsPad, mnt0, NT, lane);
        else if (k >= 0)
          message_slice<NT, false>(hh, mx, A + s * kKs, ys, B, dim * kKsPad, mnt0, mntw, lane);
        release();
      }
      if (k >= 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) agg[j][i] += hh[j][i] + mx[j][i];
      }
    }
  };

  // ---- the walk ----
  const bool walker = warp < kBlockTiles;
  float* Yt = Y + warp * tile_floats;
  T* Gw = G + warp * 2 * kChunk * dim;
  Slots sl;
  Cursor at;
  RawEdges raw;
  Chunk cur, nxt;
  int buf = 0;
  bool has = false, pref = false;
  uint32_t todo = 0;
  if (walker) {
    const int tile = blockIdx.x * kBlockTiles + warp;
    if (tile * kTile < n_nodes) {
      enter_tile(at, tile, load_rowptr(rowptr, tile, n_nodes, lane), n_nodes);
      has = at.e0 < at.e_end;
      if (has) {
        raw = load_edges<kChunk>(src, bond, mask, at, lane);
        cur = make_chunk<kChunk>(raw, at, lane);
        gather_chunk<T>(Gw, h, cur, dim, lane);
        todo = cur.types;
        if (!cur.last) {
          at.e0 += kChunk;
          raw = load_edges<kChunk>(src, bond, mask, at, lane);
        }
      }
    }
  }
  __syncthreads();  // the buckets are zero and the barriers initialised
  for (int round = 0;; ++round) {
    const int par = round & 1;
    if (walker) {
      bool left = false;
      if (has) {
        if (!pref && !cur.last) {  // the next chunk's rows, and the edges after it
          nxt = make_chunk<kChunk>(raw, at, lane);
          gather_chunk<T>(Gw + (buf ^ 1) * kChunk * dim, h, nxt, dim, lane);
          if (!nxt.last) {
            at.e0 += kChunk;
            raw = load_edges<kChunk>(src, bond, mask, at, lane);
          }
          pref = true;
        }
        if (pref) cp_async_wait<1>();
        else cp_async_wait<0>();
        __syncwarp();
        const int bucket = take_slots_gen(sl, todo, cur, slots);
        add_chunk<T>(Yt, Gw + buf * kChunk * dim, bucket, dim, ys, lane);
        todo &= ~sl.mask;
        left = todo != 0;
        if (!left) {
          if (cur.last) {
            has = false;
          } else {
            cur = nxt;
            buf ^= 1;
            pref = false;
            todo = cur.types;
          }
        }
      }
      if (lane == 0) {
        sh.types[par][warp] = sl.types;
        sh.mask[par][warp] = sl.mask;
        sh.used[par][warp] = sl.used;
        sh.pend[par][warp] = left;
        sh.alive[par][warp] = has;
      }
    }
    __syncthreads();
    bool pend = false, alive = false;
#pragma unroll
    for (int t = 0; t < kBlockTiles; ++t) {
      pend |= sh.pend[par][t] != 0;
      alive |= sh.alive[par][t] != 0;
    }
    if (pend) {  // a flush: the products read the buckets (release's barrier), then free them
      products(par, false);
      zero_buckets();
      if (walker) sl = Slots();
      __syncthreads();
    } else if (!alive) {
      products(par, true);
      break;
    }
  }

  if (!kGru) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= mntw) break;
      const int col = (mnt0 + j) * 8 + 2 * q, r = row0 + mt * kTile + g;
      if (r < n_nodes)
        *reinterpret_cast<float2*>(out + (size_t)r * dim + col) = make_float2(agg[j][0], agg[j][1]);
      if (r + 8 < n_nodes)
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * dim + col) =
            make_float2(agg[j][2], agg[j][3]);
    }
    return;
  }

  // ---- the step's gates; the buckets are read (the last barrier) ----
  const int xs = gen_xs(dim);
  float* X = Y;                     // (64, xs): [h | agg]
  float* ZR = X + kBlockRows * xs;  // (64, xs): [z | r*h], then [new | r*h]
  {
    constexpr int kBatch = 4;  // loads in flight a thread
    const int quads = dim / 4, items = kBlockRows * quads;
    for (int i0 = tid; i0 < items; i0 += kBatch * kGenWarps * 32) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kGenWarps * 32, r = i / quads, c = (i - r * quads) * 4;
        v[u] = i < items && row0 + r < n_nodes ? load4(h + (size_t)(row0 + r) * dim + c)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kGenWarps * 32, r = i / quads, c = (i - r * quads) * 4;
        if (i < items) *reinterpret_cast<float4*>(X + r * xs + c) = v[u];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= mntw) break;
    float* x = X + (mt * kTile + g) * xs + dim + (mnt0 + j) * 8 + 2 * q;
    x[0] = agg[j][0];
    x[1] = agg[j][1];
    x[8 * xs] = agg[j][2];
    x[8 * xs + 1] = agg[j][3];
  }
  __syncthreads();
  const int mp = warp & 1, nq = warp >> 1;
  const int wplane = gate_cols(NT) * gate_pad(NT);
  const int nkw = gate_slices(dim), zr_groups = gate_groups_zr(dim);
  const float* Xw = X + 32 * mp * xs;
  const float* Rw = ZR + 32 * mp * xs + dim;  // r*h, at column D + k for k < D
  for (int gi = 0; gi < gate_groups(dim); ++gi) {
    int c0, width;
    gate_group(dim, gi, c0, width);
    const bool cand = gi >= zr_groups;
    if (gi == zr_groups) __syncthreads();  // z and r*h are in ZR
    constexpr int GN = gate_nt(NT);
    const int gnt0 = nq * GN, gntw = max(0, min(GN, width / 8 - gnt0));
    float acc[2][GN][4] = {}, hh[2][GN][4] = {}, mx[2][GN][4] = {};
    for (int s = 0; s < nkw; ++s) {
      const uint32_t* B = reinterpret_cast<const uint32_t*>(next_slice());
      if (gntw == GN)
        gate_slice<NT, true>(hh, mx, Xw, Rw, cand ? dim : 0, xs, s * gate_ks(NT), 2 * dim, B,
                             wplane, gnt0, GN, lane);
      else if (gntw > 0)
        gate_slice<NT, false>(hh, mx, Xw, Rw, cand ? dim : 0, xs, s * gate_ks(NT), 2 * dim, B,
                              wplane, gnt0, gntw, lane);
      if (((s + 1) * gate_ks(NT) / 8) % kChain == 0 || s == nkw - 1) {  // a chain ends
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < GN; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[m][j][i] += hh[m][j][i] + mx[m][j][i];
              hh[m][j][i] = mx[m][j][i] = 0.f;
            }
      }
      release();
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < GN; ++j) {
        if (j >= gntw) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 32 * mp + 16 * m + g + (i >> 1) * 8;
          const int col = c0 + (gnt0 + j) * 8 + 2 * q + (i & 1);
          const float a = acc[m][j][i] + __ldg(gru_b + col);
          if (!cand) {
            ZR[r * xs + col] = col < dim ? sigmoid_fast(a) : sigmoid_fast(a) * X[r * xs + col - dim];
          } else {
            const int c = col - 2 * dim;
            const float z = ZR[r * xs + c];
            ZR[r * xs + c] = (1.f - z) * X[r * xs + c] + z * tanhf(a);
          }
        }
      }
  }
  __syncthreads();
  // the LayerNorm over the true D (the mean, then mean((x - mu)^2)), the residual
  for (int r = warp; r < kBlockRows; r += kGenWarps) {
    const int n = row0 + r;
    if (n >= n_nodes) break;
    const float* x = ZR + r * xs;
    float s = 0.f;
    for (int c = lane; c < dim; c += 32) s += x[c];
    const float mean = warp_sum(s) / dim;
    float v = 0.f;
    for (int c = lane; c < dim; c += 32) {
      const float d = x[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / dim + ln_eps);
    for (int c = lane; c < dim; c += 32)
      out[(size_t)n * dim + c] =
          (x[c] - mean) * inv * __ldg(ln + c) + __ldg(ln + dim + c) + X[r * xs + c];
  }
}

// The prologue: every B operand of a launch at this width split into
// scratch, on a grid of at most 8 blocks an SM.
inline void launch_split(const float* table, const float* gru_w, unsigned char* scratch, int dim,
                         int n_types, bool gru, int sms, cudaStream_t stream) {
  const int nt = gen_nt(dim);
  const long items = (long)n_types * (gen_depth(dim) / kKs) * (kKs / 8) * dim +
                     (gru ? (long)gate_groups(dim) * gate_slices(dim) * (gate_ks(nt) / 4) *
                                gate_cols(nt)
                          : 0);
  const long blocks = (items + 255) / 256;
  fused_message_split_kernel<<<(int)(blocks < 8L * sms ? blocks : 8L * sms), 256, 0, stream>>>(
      table, gru_w, scratch, dim, n_types, gru);
}

// The prologue, then one block per 64 destination nodes.
template <typename T, bool kGru, int NT>
int run_gen(const void* h, const float* table, const int* bond, const int* src,
            const uint8_t* mask, const int* rowptr, const float* gru_w, const float* gru_b,
            const float* ln, float ln_eps, float* out, int n_nodes, int dim, int n_types,
            void* scratch, cudaStream_t stream) {
  int device = 0, optin = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int slots = gen_slots(dim);
  const size_t smem = gen_smem_bytes(dim, slots, sizeof(T), kGru);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  auto kernel = fused_message_gen_kernel<T, kGru, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes > 0) {
    auto* scr = static_cast<unsigned char*>(scratch);
    launch_split(table, gru_w, scr, dim, n_types, kGru, sms, stream);
    const long blocks = (n_nodes + kBlockRows - 1) / kBlockRows;
    kernel<<<(unsigned)blocks, kGenWarps * 32, smem, stream>>>(
        static_cast<const T*>(h), scr, bond, src, mask, rowptr, gru_b, ln, ln_eps, out, n_nodes,
        dim, n_types, slots);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ any D: warp teams
//
// The general kernel's other design (fused_message_team_kernel), for the
// launches the 64-row blocks serve badly: a grid of few blocks (a small
// graph) and the narrow widths, where a block's walk, not its products, sets
// its time and a team of ceil(D / 32) warps per 16-row tile keeps more tiles
// in flight. No prologue and no scratch: B is read through L2 and split as
// its fragments load. use_blocks, below, chooses between the two.

constexpr int kSlice = 32;     // output columns a warp owns (the last slice may be narrower)

// The warps that share a tile, one per slice of 32 output columns.
__host__ __device__ constexpr int team_warps(int dim) { return (dim + kSlice - 1) / kSlice; }
// The depth of a bucket's product: the message's bf16 mma takes 16 at a time
// (zero-padded past D), the step's TF32 mma 8, which every D is a multiple of.
__host__ __device__ constexpr int team_depth(int dim, bool gru) {
  return gru ? dim : (dim + 15) / 16 * 16;
}
// Rows of the buckets, padded as the specialisation's: 8 mod 32 floats for
// the message's float2 fragment loads, 4 mod 32 for the step's single floats.
__host__ __device__ constexpr int team_y_stride(int dim, bool gru) {
  return kSlots * team_depth(dim, gru) + (gru ? 4 : 8);
}
// Shared memory of a team: its buckets (16 rows, the step's X over them)
// and, for the step, the LayerNorm's per-warp row sums (2 x warps x 16).
__host__ __device__ constexpr int team_bytes(int dim, bool gru) {
  return 4 * (kTile * team_y_stride(dim, gru) + (gru ? 2 * kTile * team_warps(dim) : 0));
}
// A warp's two row buffers of its slice, kSlice wide.
__host__ __device__ constexpr int team_warp_bytes(int elem) { return 2 * kChunk * kSlice * elem; }

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
__device__ __forceinline__ void mma_3xtf32_team(float (&acc)[NT][4], const float* A, int lda,
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
__device__ __forceinline__ void mma_bf16x3_team(float (&acc)[NT][4], const float* A, int lda,
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
__device__ __forceinline__ void products_team(float (&agg)[4][4], const float* Y, const Slots& sl,
                                             const float* __restrict__ table, const Slice& s,
                                             int team, int lane) {
  team_sync(s, team);
  for (int k = 0; k < sl.used; ++k) {
    const int v = (sl.types >> (8 * k)) & 255u;
    const float* B = table + v * s.D + s.c0;
    if (kGru)
      mma_3xtf32_team<4>(agg, Y + k * s.DK, s.ys, B, s.VD, s.D / 8, 0, s.ntw, lane);
    else
      mma_bf16x3_team<4>(agg, Y + k * s.DK, s.ys, B, s.VD, s.DK / 16, s.D, s.ntw, lane);
  }
  team_sync(s, team);
}

// A finished tile: its last products, then the store (message) or the
// GatedUpdate on the team's slices (step); the buckets are zero after it.
template <typename T, bool kGru>
__device__ __forceinline__ void finish_team(float (&agg)[4][4], float* Y, float* red, Slots& sl,
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
  products_team<kGru>(agg, Y, sl, table, s, team, lane);
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
    mma_3xtf32_team<8>(zr, Y, xs, gru_w + s.c0, 3 * D, 2 * D / 8, D, s.ntw, lane);
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
    mma_3xtf32_team<4>(cc, Y, xs, gru_w + 2 * D + s.c0, 3 * D, 2 * D / 8, 0, s.ntw, lane);
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
fused_message_team_kernel(const T* __restrict__ h, const float* __restrict__ table,
                         const int* __restrict__ bond, const int* __restrict__ src,
                         const uint8_t* __restrict__ mask, const int* __restrict__ rowptr,
                         const float* __restrict__ gru_w, const float* __restrict__ gru_b,
                         const float* __restrict__ ln, float ln_eps, float* __restrict__ out,
                         int n_nodes, int dim, int n_types) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Slice s;
  s.D = dim;
  s.DK = team_depth(dim, kGru);
  s.ys = team_y_stride(dim, kGru);
  s.VD = n_types * dim;
  s.W = team_warps(dim);
  s.w = warp % s.W;
  s.c0 = s.w * kSlice;
  s.cw = min(kSlice, dim - s.c0);
  s.ntw = s.cw / 8;
  const int team = warp / s.W, teams = (blockDim.x >> 5) / s.W;
  const int team_floats = team_bytes(dim, kGru) / 4;
  float* Y = reinterpret_cast<float*>(smem_raw) + team * team_floats;  // (16, kSlots*DK), row ys
  float* red = Y + kTile * s.ys;  // the step's (2, W, 16) row sums
  T* G = reinterpret_cast<T*>(smem_raw + teams * team_bytes(dim, kGru)) +
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
          products_team<kGru>(agg, Y, sl, table, s, team, lane);
          zero_slice(Y, sl.used, s, lane);
          sl = Slots();
        }
        __syncwarp();
        if (cur.last)
          finish_team<T, kGru>(agg, Y, red, sl, table, gru_w, gru_b, ln, ln_eps, h, out,
                              cur.tile, n_nodes, s, team, lane);
      });
}

// As many teams per block as shared memory holds, up to max_warps warps.
template <typename T, bool kGru>
int run_team(const void* h, const float* table, const int* bond, const int* src,
            const uint8_t* mask, const int* rowptr, const float* gru_w, const float* gru_b,
            const float* ln, float ln_eps, float* out, int n_nodes, int dim, int n_types,
            cudaStream_t stream) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const int W = team_warps(dim);
  const size_t per_team = team_bytes(dim, kGru) + W * team_warp_bytes(sizeof(T));
  if (per_team > (size_t)optin) return (int)cudaErrorInvalidValue;
  const size_t fit = optin / per_team;
  const int teams = (int)(fit < (size_t)(max_warps(kGru) / W) ? fit : max_warps(kGru) / W);
  const size_t smem = teams * per_team;
  auto kernel = fused_message_team_kernel<T, kGru>;
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

// Whether a width runs the D = 32 specialisation (no scratch).
inline bool specialised(int dim) {
#ifndef IONIC_NO_D32_SPECIALISATION  // defined only to time the general kernel at D = 32
  return dim == kTcDim;
#else
  return false;
#endif
}

// Which general design a launch takes, where a probe or a check has not
// forced one (ionic_fused_force_design): 0 chooses, 1 the warp teams, 2 the
// 64-row blocks.
int g_forced_design = 0;

// Whether a launch at this width over n_nodes runs the 64-row blocks (the
// prologue, scratch) rather than the warp teams. Both designs timed on an
// H100 on the bench data's cation and anion graphs at batch 256 to 2048 and
// D = 8 to 128 (tools/width_probe.py designs; PERF.md §6):
//  - the blocks' time goes up in whole waves of the grid (two blocks an SM
//    at D <= 64, one above), and a tile that meets more types than its 2
//    slots (at 64 and 128) flushes the whole block: on every anion graph
//    (up to 1.2 waves) the blocks take 1.1-2.0x the teams' time;
//  - the step's staged W pays from 1.5 waves at D >= 64: 3-16% faster on
//    every cation graph from 466 blocks at 64 and 235 at 128;
//  - the message gains only at D > 64 from 2 waves (2-14% on 352 to 923
//    blocks); at D = 64 it ties at 3.5 waves and loses below, and at
//    D < 64 it loses everywhere (up to 2.6x at 8 and 16), as does the
//    step at 8 and 16; so both keep the teams there.
// What the rule misses (the blocks 5-21% faster where it takes the teams):
// the step on one wave of a cation graph (235 blocks at 48 and 64, 117 at
// 128), where the anion graphs of as many blocks lose (their tiles meet
// more types, which the host does not see), and the step at D = 48 on 466
// blocks (at 352, 692 and 923 the teams win or tie).
inline bool use_blocks(int dim, int n_nodes, bool gru) {
  if (specialised(dim) || n_nodes <= 0) return false;
  if (g_forced_design) return g_forced_design == 2;
  if (dim < 64 || (!gru && dim == 64)) return false;
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long blocks = (n_nodes + kBlockRows - 1) / kBlockRows;
  const long wave = (gen_nt(dim) == 4 ? 2 : 1) * (long)sms;  // __launch_bounds__' blocks an SM
  return gru ? 2 * blocks >= 3 * wave : blocks >= 2 * wave;
}

template <bool kGru>
int dispatch_fused(const void* h, int h_dtype, const float* table, const int* bond,
                   const int* src, const uint8_t* mask, const int* rowptr,
                   const float* gru_w, const float* gru_b, const float* ln, float ln_eps,
                   float* out, int n_nodes, int dim, int n_types, void* scratch,
                   cudaStream_t s) {
  if (n_types <= 0 || n_types > max_types(dim)) return (int)cudaErrorInvalidValue;
  if (!aligned16(h) || !aligned16(table) || !aligned16(out) ||
      (kGru && (!aligned16(gru_w) || !aligned16(gru_b) || !aligned16(ln))))
    return (int)cudaErrorMisalignedAddress;
#define IONIC_ARGS h, table, bond, src, mask, rowptr, gru_w, gru_b, ln, ln_eps, out, n_nodes
  if (specialised(dim)) {
    if (h_dtype == kF32) return run_tc<float, kGru>(IONIC_ARGS, n_types, s);
    if (h_dtype == kBF16) return run_tc<__nv_bfloat16, kGru>(IONIC_ARGS, n_types, s);
    return (int)cudaErrorInvalidValue;
  }
  if (!use_blocks(dim, n_nodes, kGru)) {
    if (h_dtype == kF32) return run_team<float, kGru>(IONIC_ARGS, dim, n_types, s);
    if (h_dtype == kBF16) return run_team<__nv_bfloat16, kGru>(IONIC_ARGS, dim, n_types, s);
    return (int)cudaErrorInvalidValue;
  }
  if (!scratch || !aligned16(scratch)) return (int)cudaErrorInvalidValue;
  const bool wide = gen_nt(dim) == 8;
  if (h_dtype == kF32)
    return wide ? run_gen<float, kGru, 8>(IONIC_ARGS, dim, n_types, scratch, s)
                : run_gen<float, kGru, 4>(IONIC_ARGS, dim, n_types, scratch, s);
  if (h_dtype == kBF16)
    return wide ? run_gen<__nv_bfloat16, kGru, 8>(IONIC_ARGS, dim, n_types, scratch, s)
                : run_gen<__nv_bfloat16, kGru, 4>(IONIC_ARGS, dim, n_types, scratch, s);
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
// over n_nodes needs on the current device (at D = 32: the staged operands
// and one warp's tile and row buffers; the 64-row blocks: a block with h in
// f32; the warp teams: one team's buckets and row buffers), or -1 for a
// shape the kernels do not take.
IONIC_API int ionic_fused_smem_bytes(int dim, int n_types, int gru, int n_nodes) {
  if (n_types <= 0 || n_types > ionic::max_types(dim)) return -1;
  if (ionic::specialised(dim))
    return (int)(ionic::tc_fixed_bytes(n_types, gru != 0) +
                 ionic::tc_warp_bytes(sizeof(float), gru != 0));
  if (ionic::use_blocks(dim, n_nodes, gru != 0))
    return (int)ionic::gen_smem_bytes(dim, ionic::gen_slots(dim), sizeof(float), gru != 0);
  return ionic::team_bytes(dim, gru != 0) +
         ionic::team_warps(dim) * ionic::team_warp_bytes(sizeof(float));
}

// Bytes of the scratch a launch over n_nodes on the current device splits
// its operands into: nonzero exactly where it runs the 64-row blocks, whose
// prologue (fused_message_split_kernel) it then launches first; -1 for a
// shape the kernels do not take. The wrapper allocates it.
IONIC_API int ionic_fused_scratch_bytes(int dim, int n_types, int gru, int n_nodes) {
  if (n_types <= 0 || n_types > ionic::max_types(dim)) return -1;
  if (!ionic::use_blocks(dim, n_nodes, gru != 0)) return 0;
  return (int)ionic::scratch_bytes(dim, n_types, gru != 0);
}

// The blocks' prologue alone, as a launch that runs them launches it first:
// the operands of a launch at this width split into scratch (of
// ionic_fused_scratch_bytes' size at a node count that takes the blocks).
// For the checks and timings of the prologue; the fused entry points launch
// it themselves.
IONIC_API int ionic_fused_split(const float* table, const float* gru_w, void* scratch, int dim,
                                int n_types, int gru, void* stream) {
  if (n_types <= 0 || n_types > ionic::max_types(dim) || dim == ionic::kTcDim)
    return (int)cudaErrorInvalidValue;
  if (!ionic::aligned16(table) || !ionic::aligned16(scratch) || (gru && !ionic::aligned16(gru_w)))
    return (int)cudaErrorMisalignedAddress;
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  ionic::launch_split(table, gru_w, static_cast<unsigned char*>(scratch), dim, n_types,
                      gru != 0, sms, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Force the general kernel's design (1 the warp teams, 2 the 64-row blocks)
// or, with 0, let use_blocks choose; returns the setting it replaces. For
// probes and checks that hold both designs at one shape.
IONIC_API int ionic_fused_force_design(int design) {
  const int before = ionic::g_forced_design;
  ionic::g_forced_design = design == 1 || design == 2 ? design : 0;
  return before;
}

IONIC_API int ionic_fused_message(const void* h, int h_dtype, const float* table,
                                  const int* bond, const int* src, const uint8_t* mask,
                                  const int* rowptr, float* out, int n_nodes, int dim,
                                  int n_types, void* scratch, void* stream) {
  return ionic::dispatch_fused<false>(h, h_dtype, table, bond, src, mask, rowptr, nullptr,
                                      nullptr, nullptr, 0.f, out, n_nodes, dim, n_types, scratch,
                                      static_cast<cudaStream_t>(stream));
}

IONIC_API int ionic_fused_step(const void* h, int h_dtype, const float* table,
                               const int* bond, const int* src, const uint8_t* mask,
                               const int* rowptr, const float* gru_w, const float* gru_b,
                               const float* ln, float ln_eps, float* out, int n_nodes,
                               int dim, int n_types, void* scratch, void* stream) {
  return ionic::dispatch_fused<true>(h, h_dtype, table, bond, src, mask, rowptr, gru_w,
                                     gru_b, ln, ln_eps, out, n_nodes, dim, n_types, scratch,
                                     static_cast<cudaStream_t>(stream));
}
