// The bucket walk and the split products shared by the fused message and
// step kernels (fused_message.cu) and the table gradient (table_grad.cu):
// a 16-node tile's CSR edges in chunks of 16 (rowptr, the edge arrays, the
// chunk's real h[src] rows gathered by cp.async), the slots of the (node,
// bond type) buckets that a chunk's types take, and the exact three-way
// bf16 split of an f32 operand with the bf16 mma that multiplies the parts.
#pragma once

#include <climits>

#include "common.cuh"

namespace ionic {

constexpr int kTile = 16;     // destination nodes per warp tile (the mma M)
constexpr int kChunk = 16;    // edges per step of the bucket phase
constexpr int kSlots = 4;     // bond types a tile's buckets hold at once
constexpr int kMaxDim = 128;   // the widest D the kernels take
constexpr int kMaxTypes = 32;  // the tile's type mask, and the 5 bits of a packed bond

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies (cp.async) ----

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

// The slots of a tile's buckets: slot k holds type (types >> 8k) & 255 for
// k < used; mask has those types' bits.
struct Slots {
  uint32_t types = 0, mask = 0;
  int used = 0;
};

// This pass's bucket of lane t's edge, row << 2 | slot, or -1 when its type
// has no slot (or it is not a real edge), with `slots` slots (1 to kSlots).
// Types of the chunk without a slot get free ones first, lowest type first.
__device__ __forceinline__ int take_slots_gen(Slots& sl, uint32_t todo, const Chunk& c,
                                              int slots) {
  for (uint32_t fresh = todo & ~sl.mask; fresh && sl.used < slots; fresh &= fresh - 1) {
    const int v = __ffs(fresh) - 1;
    sl.types |= (uint32_t)v << (8 * sl.used++);
    sl.mask |= 1u << v;
  }
  if (c.packed < 0) return -1;
  const uint32_t b = c.packed & 31;
  if (!((sl.mask >> b) & 1u)) return -1;
  int slot = 0;
#pragma unroll
  for (int k = 1; k < kSlots; ++k)
    slot += k < sl.used && ((sl.types >> (8 * k)) & 255u) == b ? k : 0;
  return ((c.packed >> 5) << 2) | slot;
}

// The chunk's real h[src] rows, columns [c0, c0 + width) of each, into g
// (kChunk rows of width), 16 bytes a copy: width * sizeof(T) and c0 *
// sizeof(T) are multiples of 16.
template <typename T>
__device__ __forceinline__ void gather_cols(T* g, const T* __restrict__ h, const Chunk& c,
                                            int dim, int c0, int width, int lane) {
  const int pieces = width * (int)sizeof(T) / 16, total = kChunk * pieces;
  for (int i0 = 0; i0 < total; i0 += 32) {  // a trip count the whole warp shares
    const int piece = i0 + lane, t = min(piece / pieces, kChunk - 1), p = piece - t * pieces;
    const int pk = __shfl_sync(kFullMask, c.packed, t);
    const int s = __shfl_sync(kFullMask, c.s, t);
    if (piece < total && pk >= 0)
      cp_async16(reinterpret_cast<char*>(g + t * width) + p * 16,
                 reinterpret_cast<const char*>(h + (size_t)s * dim + c0) + p * 16);
  }
  cp_async_commit();
}

// The chunk's real h[src] rows, whole, into g (kChunk rows of dim).
template <typename T>
__device__ __forceinline__ void gather_chunk(T* g, const T* __restrict__ h, const Chunk& c,
                                             int dim, int lane) {
  gather_cols(g, h, c, dim, 0, dim, lane);
}

// ---- host ----

// The most bond types a width takes: 32 at every D that is a multiple of 8
// from 8 to 128, none at any other.
inline int max_types(int dim) {
  return dim >= 8 && dim <= kMaxDim && dim % 8 == 0 ? kMaxTypes : 0;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace ionic
