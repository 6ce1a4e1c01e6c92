// The fused aggregate's table gradient, the dK of its backward:
//
//   dK[j, v*D + i] = sum over the edges e with bond v and mask of  g[dst_e, i] * h[src_e, j]
//
// an f32 (D, V*D) table, the lane-stacked layout of the forward's table.
//
// Replaces what the JAX package computes with XLA ops inside the custom VJP
// of its Pallas kernel (ops/pallas/fused_message.py, _vjp_bwd, lines
// 338-347: two gathers of E rows, a one-hot (E, V*D) operand and one
// (D, E) @ (E, V*D) product), which the port ran as the same PyTorch ops
// (fused_message_table_grad_plain).
//
// Design. The forward's typed buckets hold the key. With
//   Y[n, v, :] = sum over the real edges into node n with bond v of h[src]
// (what fused_message_tc_kernel sums before its product),
//   dK_v = sum over the 16-node tiles of  Y_v^T (D x 16) @ g_tile (16 x D),
// so each h[src] row is gathered once, each g row read once (dst is
// sorted: a tile's g rows are 16 consecutive rows), no (E, .) tensor is
// written, and the products are the forward's flops, dense, on the tensor
// cores.
//  - The walk is the forward's (fused_walk.cuh): a warp takes a tile's CSR
//    edges in chunks of 16, the chunk's h rows by cp.async one chunk ahead,
//    and adds each real edge's row into the bucket of its bond type among
//    its slots (take_slots_gen), in CSR order.
//  - The accumulator, the output's rows times V*D columns, is too large for
//    one block above D = 32 (458 KB at D = 128, V = 7), so the output is cut
//    into pieces: a slice of 32 rows of dK (16 at D <= 16), whose columns of
//    h a walker gathers, times a group of bond types, whose edges alone it
//    buckets (tg_plan: as many types a group as shared memory holds beside
//    the walkers). A block takes one piece and a contiguous range of tiles
//    (a node part); the pieces of a part are neighbours in the grid, so
//    they read its g rows and edge arrays while those are in L2.
//  - A block of 16 warps goes in rounds, with two bucket sets a walker. Its
//    walker warps (the first 8, or 4 where that means fewer walks of the
//    edge lists per walker: D = 128) each walk their tiles in turn, one
//    tile (or what is left of it) a round, into that round's set, a column
//    of the slice a lane; the next tile's edges load during a tile, and its
//    first rows are in flight across the round's barrier. A tile that meets
//    more types than its slots stops its round there and goes on in the
//    next, with fresh slots.
//  - The other warps, the consumers, meanwhile multiply the set filled the
//    round before, whose tiles' g rows they staged as it was filled. They
//    deal the round's fragment groups of the accumulator (a type, 16 rows
//    of the slice, 1 to 4 n-tiles of 8 columns) among themselves by the
//    types' holder counts, largest first, and add into each the products of
//    every walker's bucket of that type with that walker's g rows: mma.sync
//    m16n8k16, the depth of one tile, each operand split exactly into three
//    bf16 parts and the six products of order <= 2^-16 summed, as the
//    forward's message (the f32 bucket sums are taken without rounding,
//    where 3xTF32 would leave 2^-22 in each and take two k8 steps a tile).
//    Each tile's products start from zero in the tensor cores, x1*y1 in two
//    halves of 8, and add in f32 (tg_product says why) into 4 / NG chains
//    that take the walkers in turn; a round's chains add in order into the
//    f32 accumulator in shared memory. Then the consumers zero the set.
//  - The block writes its accumulator as its node part's partial (D, V*D)
//    table into scratch that the wrapper allocates; a second kernel sums
//    the parts in a fixed order (8 warps a column block, each over every
//    8th part, then the 8 in order). No float atomics: two launches give
//    the same bits.
//
// Bound on the H100: bytes at every width (g and h read once, the edge
// arrays, dK written: 16.6 MB at the bench's cation shape, D = 32) against
// the products' 2*P*D*D flops at the f32-accurate tensor-core rate, P the
// (node, type) buckets that hold a real edge (the buckets' E_real*D adds
// on the CUDA cores are a hundredth of that). What holds the
// kernel back is the walk's latency, as in the forward (rowptr, then the
// edges, then the gathered rows), and the instructions that the walkers and
// the consumers issue on one SM's four schedulers: the walkers go from tile
// to tile with those loads in flight, the products run beside the walk, and
// each consumer visits only the fragment groups dealt to it.
#include "common.cuh"
#include "fused_walk.cuh"

namespace ionic {

constexpr int kTgWarps = 16;  // warps of a block: the walkers, then the consumers
constexpr int kTgHeader = 512;  // the two sets' headers

// What the walkers publish of a bucket set: the tile each walker will fill
// it from (a round ahead, so that the consumers stage its g rows early), and
// once filled its slots and whether the walker has work left.
struct TgSet {
  int tile[kTgWarps];        // -1: none
  uint32_t types[kTgWarps];  // the walker's slots: type (types >> 8k) & 255 for k < used
  int used[kTgWarps];
  int more[kTgWarps];
};
struct TgShared {
  TgSet set[2];
};
static_assert(sizeof(TgShared) <= kTgHeader, "the header");

// How a launch cuts its work (tg_plan): walkers a block, bucket slots a
// tile, the rows of a j-slice and the slices, the types of a group and the
// groups, the n-tiles of a consumer's fragment group, and a block's dynamic
// shared memory.
struct TgPlan {
  int walkers, slots, js, slices, vg, groups, ng;
  size_t smem;
};

// A walker's shared memory: two bucket sets of `slots` buckets (16 rows of
// js + 4 floats: the A fragments' transposed loads are free of bank
// conflicts) and two row buffers of the slice (sized for f32); and, beside
// each walker, the g rows (D + 4 floats a row) of the tile the consumers
// multiply.
__host__ __device__ inline size_t tg_walker_bytes(int js, int slots) {
  return 4 * (2 * (size_t)slots * kTile * (js + 4) + 2 * kChunk * js);
}
__host__ __device__ inline size_t tg_g_rows_bytes(int dim) {
  return 4 * (size_t)kTile * (dim + 4);
}

// The pieces, walkers and slots of a width and type count within `budget`
// bytes of shared memory a block: for each of 8 and 4 walkers and 4, 3 and
// 2 slots, the most types a group; of those, the fewest walks of the edge
// lists per walker, then the most slots (8 walkers on a tie). The row
// buffers are sized for an f32 h, so the plan does not depend on h's type.
// `walkers` 8 or 4 takes only that count (a probe times both sides of the
// choice), 0 both. False where nothing fits.
inline bool tg_plan(int dim, int n_types, size_t budget, int walkers_only, TgPlan& best) {
  if (n_types <= 0 || n_types > max_types(dim)) return false;
  const int js = dim <= 16 ? 16 : 32;
  const int slices = (round_up(dim, 16) + js - 1) / js;
  const size_t per_type = (size_t)js * dim * 4;
  bool found = false;
  for (int walkers = 8; walkers >= 4; walkers -= 4) {
    if (walkers_only && walkers != walkers_only) continue;
    for (int slots = kSlots; slots >= 2; --slots) {
      const size_t fixed =
          kTgHeader + walkers * (tg_walker_bytes(js, slots) + tg_g_rows_bytes(dim));
      if (fixed + per_type > budget) continue;
      const size_t room = (budget - fixed) / per_type;
      int vg = room < (size_t)n_types ? (int)room : n_types;
      const int groups = (n_types + vg - 1) / vg;
      vg = (n_types + groups - 1) / groups;
      if (found) {
        const long mine = (long)slices * groups * best.walkers;
        const long theirs = (long)best.slices * best.groups * walkers;
        if (mine > theirs || (mine == theirs && slots <= best.slots)) continue;
      }
      // n-tiles a fragment group: a bucket's split serves NG n-tiles, and a
      // type has (rows / 16) * (n-tiles / NG) groups to deal among the
      // consumers; 4 / NG chains of the walkers
      const int ntd = dim / 8, ng = ntd >= 8 ? 4 : ntd >= 4 ? 2 : 1;
      best = TgPlan{walkers, slots, js, slices, vg, groups, ng, fixed + vg * per_type};
      found = true;
    }
  }
  return found;
}

inline size_t tg_budget() {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (size_t)optin;
}

// Node parts: about one resident block a piece on every SM (counted from
// shared memory alone, so that the scratch's size and the launch agree
// whatever h's type), and at least a tile a part.
inline int tg_parts(const TgPlan& p, int n_nodes) {
  const long tiles = ((long)n_nodes + kTile - 1) / kTile;
  if (tiles <= 0) return 0;
  int device = 0, sms = 1, per_sm = 0, reserved = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  long fit = (long)per_sm / (long)(p.smem + reserved);
  fit = fit < 1 ? 1 : fit > 4 ? 4 : fit;
  const long pieces = (long)p.slices * p.groups;
  long parts = (long)sms * fit / pieces;
  parts = parts < tiles ? parts : tiles;
  return (int)(parts < 1 ? 1 : parts);
}

// d += A (16 x 8) @ B (8 x 8) in bf16, f32 sums: m16n8k8, half of mma_bf16's depth.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// acc += Y^T (16 rows of dK x the tile's 16 nodes) @ G (16 nodes x 8 ng
// columns): one depth step of m16n8k16. Y: a bucket at its first row's
// column jm*16 (f32, row stride ys), read transposed (A[r][k] = Y[k][r]);
// G: the tile's g rows at column nt0*8 (row stride gs). Both split exactly
// into three bf16 parts as their fragments load; the six products of
// mma_bf16x3 (fused_message.cu): the small ones in a chain, and x1*y1 as two
// m16n8k8 halves of the depth, each from zero; then acc += (half + half) +
// small in f32. The tensor cores truncate what they add (toward zero, after
// aligning to the largest term), and an entry of dK adds about a thousand
// tiles at the bench's cation shape: so no sum runs on in them from tile to
// tile (carried, it read 6e-4 off on an entry of 0.73), and the largest
// products are summed 8 at a time, not 16 (on an H100 at the cation shape
// this keeps the kernel within 1e-4 + 1e-4 |dK| of an f64 evaluation at
// D = 32 to 128; the f32 plain version is 6e-4 to 1.5e-3 off it there).
// Fragments (PTX ISA, g = lane / 4, q = lane % 4): A a_i holds rows g + 8 (i
// & 1), columns 2q + 8 (i >> 1) and the next; B b0 rows 2q, 2q + 1 and b1
// rows 2q + 8, 2q + 9 of column g; C c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8,
// 2q), c3 (g + 8, 2q + 1).
template <int NG>
__device__ __forceinline__ void tg_product(float (&acc)[NG][4], const float* Y, int ys,
                                           const float* G, int gs, int ng, int lane) {
  const int g = lane >> 2, q = lane & 3;
  uint32_t a1[4], a2[4], a3[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* y = Y + (2 * q + (i >> 1) * 8) * ys + g + (i & 1) * 8;
    split_bf16x3(y[0], y[ys], a1[i], a2[i], a3[i]);
  }
  const float* b = G + 2 * q * gs + g;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    if (j >= ng) break;
    uint32_t b1[2], b2[2], b3[2];
    split_bf16x3(b[j * 8], b[gs + j * 8], b1[0], b2[0], b3[0]);
    split_bf16x3(b[8 * gs + j * 8], b[9 * gs + j * 8], b1[1], b2[1], b3[1]);
    float h0[4] = {}, h1[4] = {}, mx[4] = {};
    mma_bf16(mx, a3, b1);
    mma_bf16(mx, a2, b2);
    mma_bf16(mx, a1, b3);
    mma_bf16(mx, a2, b1);
    mma_bf16(mx, a1, b2);
    mma_bf16_k8(h0, a1[0], a1[1], b1[0]);  // depth 0-7
    mma_bf16_k8(h1, a1[2], a1[3], b1[1]);  // depth 8-15
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += (h0[i] + h1[i]) + mx[i];
  }
}

// gather_cols where a row's slice is a power of two of 16-byte pieces (a
// 32-column slice: 8 pieces f32, 4 bf16): shifts for gather_cols' division.
template <typename T>
__device__ __forceinline__ void gather_slice(T* g, const T* __restrict__ h, const Chunk& c,
                                             int dim, int c0, int cw, int lane) {
  const int pieces = cw * (int)sizeof(T) / 16;
  if (pieces & (pieces - 1)) {
    gather_cols<T>(g, h, c, dim, c0, cw, lane);
    return;
  }
  const int sh = __ffs(pieces) - 1, total = kChunk << sh;
  for (int i0 = 0; i0 < total; i0 += 32) {
    const int piece = i0 + lane, t = (piece >> sh) & (kChunk - 1), p = piece & (pieces - 1);
    const int pk = __shfl_sync(kFullMask, c.packed, t);
    const int s = __shfl_sync(kFullMask, c.s, t);
    if (piece < total && pk >= 0)
      cp_async16(reinterpret_cast<char*>(g + t * cw) + p * 16,
                 reinterpret_cast<const char*>(h + (size_t)s * dim + c0) + p * 16);
  }
  cp_async_commit();
}

// add_chunk for a slice of at most 32 columns: a column a lane, every lane
// busy (add_chunk's 4 columns a lane leave 24 idle on a 32-column slice).
template <typename T>
__device__ __forceinline__ void add_chunk_cols(float* Yt, const T* g, int bucket, int cw, int ys,
                                               int lane) {
  for (int t = 0; t < kChunk; ++t) {
    const int p = __shfl_sync(kFullMask, bucket, t);
    if (p >= 0 && lane < cw)
      Yt[((p & 3) * kTile + (p >> 2)) * ys + lane] += to_f32(g[t * cw + lane]);
  }
}

// The consumers' barrier: bar.sync 1 over their warps (0 is __syncthreads').
__device__ __forceinline__ void consumers_sync(int consumers) {
  asm volatile("bar.sync 1, %0;" ::"r"(32 * consumers) : "memory");
}

// One block: piece blockIdx.x % pieces (slice fastest, then the type
// group) of node part blockIdx.x / pieces. Shared memory: the two sets'
// headers, the accumulator (per type of the group, 16-row group of the
// slice and n-tile: a fragment, 4 floats a lane), each walker's two bucket
// sets and row buffers, then each walker's g rows.
template <typename T, int NG>
__global__ void __launch_bounds__(kTgWarps * 32, 1)
table_grad_bucket_kernel(const float* __restrict__ g, const T* __restrict__ h,
                         const int* __restrict__ bond, const int* __restrict__ src,
                         const uint8_t* __restrict__ mask, const int* __restrict__ rowptr,
                         float* __restrict__ partial, int n_nodes, int dim, int n_types,
                         int walkers, int slots, int js, int slices, int vg, int parts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TgShared& sh = *reinterpret_cast<TgShared*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pieces = slices * ((n_types + vg - 1) / vg);
  const int part = blockIdx.x / pieces, piece = blockIdx.x % pieces;
  const int j0 = (piece % slices) * js, cw = min(js, dim - j0);  // h's columns of the slice
  const int v0 = (piece / slices) * vg, vn = min(vg, n_types - v0);
  const int ys = js + 4, gs = dim + 4, ntd = dim / 8;
  const int jsm = (cw + 15) / 16, jsa = js / 16;  // 16-row groups used, allocated
  float* acc = reinterpret_cast<float*>(smem_raw + kTgHeader);
  const int acc_floats = vg * js * dim;
  const int set_floats = slots * kTile * ys;
  const size_t wbytes = tg_walker_bytes(js, slots);
  unsigned char* wbase = reinterpret_cast<unsigned char*>(acc + acc_floats);
  float* gbase = reinterpret_cast<float*>(wbase + walkers * wbytes);
  auto bucket_set = [&](int w, int s) {
    return reinterpret_cast<float*>(wbase + w * wbytes) + s * set_floats;
  };
  auto g_rows = [&](int w) { return gbase + w * kTile * gs; };

  const long tiles = ((long)n_nodes + kTile - 1) / kTile;
  const int tb = (int)(part * tiles / parts), te = (int)((part + 1) * tiles / parts);

  for (int i = tid; i < acc_floats / 4; i += blockDim.x)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w = 0; w < walkers; ++w)
    for (int i = tid; i < 2 * set_floats / 4; i += blockDim.x)
      reinterpret_cast<float4*>(bucket_set(w, 0))[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const bool walker = warp < walkers;
  const int consumers = kTgWarps - walkers, cwarp = warp - walkers;
  // the walker's edge filter: edges of the group's types only
  auto keep = [&](RawEdges r) {
    if ((unsigned)(r.b - v0) >= (unsigned)vn) r.m = 0;
    return r;
  };
  T* rows = reinterpret_cast<T*>(bucket_set(warp, 2));  // a walker's two (kChunk, cw) buffers
  Slots sl;
  Cursor at, nat;             // the tile being walked, the walker's next tile
  RawEdges raw, nraw0, nraw1;  // the chunk after the next; the next tile's first two chunks
  Chunk cur, nxt;
  int tile = tb + warp, rp_next = 0, buf = 0;
  uint32_t todo = 0;
  bool has_tile = walker && tile < te, in_tile = false, pref = false, ahead = false;
  // the first two chunks of a tile entered at `nat`: their edges loaded, their
  // rows now in flight, the edges after them loading
  auto begin = [&]() {
    at = nat;
    in_tile = at.e0 < at.e_end;
    pref = false;
    buf = 0;
    if (!in_tile) return;
    cur = make_chunk<kChunk>(nraw0, at, lane);
    gather_slice<T>(rows, h, cur, dim, j0, cw, lane);
    todo = cur.types;
    if (cur.last) return;
    at.e0 += kChunk;
    nxt = make_chunk<kChunk>(nraw1, at, lane);
    gather_slice<T>(rows + kChunk * cw, h, nxt, dim, j0, cw, lane);
    pref = true;
    if (!nxt.last) {
      at.e0 += kChunk;
      raw = keep(load_edges<kChunk>(src, bond, mask, at, lane));
    }
  };
  // enter tile t at `nat` (rowptr entries rp): its first two chunks' edges
  auto enter_next = [&](int t, int rp) {
    enter_tile(nat, t, rp, n_nodes);
    nraw0 = keep(load_edges<kChunk>(src, bond, mask, nat, lane));
    if (nat.e0 + kChunk < nat.e_end) {
      Cursor c1 = nat;
      c1.e0 += kChunk;
      nraw1 = keep(load_edges<kChunk>(src, bond, mask, c1, lane));
    }
  };
  if (has_tile) {
    enter_next(tile, load_rowptr(rowptr, tile, n_nodes, lane));
    if (tile + walkers < te) rp_next = load_rowptr(rowptr, tile + walkers, n_nodes, lane);
    begin();
  }
  if (walker && lane == 0) sh.set[0].tile[warp] = has_tile ? tile : -1;
  __syncthreads();

  const int ntg = (ntd + NG - 1) / NG, per_type = jsm * ntg;
  for (int r = 0;; ++r) {
    const int s = r & 1;
    if (walker) {
      // ---- the walk: the rest of the walker's tile into set s, until the
      // tile ends or a chunk meets more types than the free slots
      sl = Slots();
      float* Yt = bucket_set(warp, s);
      bool stopped = false;
      if (has_tile) {
        if (!ahead && tile + walkers < te) {  // the next tile's edges load during this one
          enter_next(tile + walkers, rp_next);
          rp_next = tile + 2 * walkers < te
                        ? load_rowptr(rowptr, tile + 2 * walkers, n_nodes, lane) : 0;
          ahead = true;
        }
        while (in_tile) {
          if (!pref && !cur.last) {  // the next chunk's rows, and the edges after it
            nxt = make_chunk<kChunk>(raw, at, lane);
            gather_slice<T>(rows + (buf ^ 1) * kChunk * cw, h, nxt, dim, j0, cw, lane);
            if (!nxt.last) {
              at.e0 += kChunk;
              raw = keep(load_edges<kChunk>(src, bond, mask, at, lane));
            }
            pref = true;
          }
          if (pref) cp_async_wait<1>();
          else cp_async_wait<0>();
          __syncwarp();
          const int bucket = take_slots_gen(sl, todo, cur, slots);
          add_chunk_cols<T>(Yt, rows + buf * kChunk * cw, bucket, cw, ys, lane);
          todo &= ~sl.mask;
          if (todo) {
            stopped = true;
            break;
          }
          if (cur.last) {
            in_tile = false;
          } else {
            cur = nxt;
            buf ^= 1;
            pref = false;
            todo = cur.types;
          }
        }
        if (!stopped) {  // on to the walker's next tile: its first rows load across the barrier
          tile += walkers;
          has_tile = tile < te;
          if (has_tile) {
            begin();
            ahead = false;
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        sh.set[s].types[warp] = sl.types;
        sh.set[s].used[warp] = sl.used;
        sh.set[s].more[warp] = has_tile;
        sh.set[s ^ 1].tile[warp] = has_tile ? tile : -1;  // next round's
      }
    } else {
      // ---- the products of the set the walkers filled last round, whose g
      // rows were issued then; then the g rows of the set they fill now
      const int c = s ^ 1, quads = dim / 4, ctid = tid - walkers * 32;
      if (r > 0) {
        const TgSet& st = sh.set[c];
        cp_async_wait<0>();
        consumers_sync(consumers);
        // the round's holders of each type (lane vl: type v0 + vl), then the
        // types ranked by holders, most first (ties: lower type first)
        const uint32_t my_types = lane < walkers ? st.types[lane] : 0u;
        const int my_used = lane < walkers ? st.used[lane] : 0;
        auto slot_of = [&](uint32_t v) {  // lane w: walker w's slot of type v, or -1
          int slot = -1;
          for (int k = 0; k < my_used; ++k)
            if (((my_types >> (8 * k)) & 255u) == v) slot = k;
          return slot;
        };
        uint32_t type_holders = 0;
        for (int vl = 0; vl < vn; ++vl) {
          const uint32_t m = __ballot_sync(kFullMask, slot_of(v0 + vl) >= 0);
          if (lane == vl) type_holders = m;
        }
        const int my_count = __popc(type_holders);
        int rank = 0;
        for (int u = 0; u < vn; ++u) {
          const int cu = __shfl_sync(kFullMask, my_count, u);
          rank += cu > my_count || (cu == my_count && u < lane);
        }
        int type_at = 0;  // lane r: the type of rank r
        for (int vl = 0; vl < vn; ++vl) {
          const int rr = __shfl_sync(kFullMask, rank, vl);
          if (lane == rr) type_at = vl;
        }
        // fragment group k = rank * per_type + it of the types with holders
        // goes to consumer snake(k): 0, 1, .., C - 1, C - 1, .., 0, 0, 1, ..
        const int items = __popc(__ballot_sync(kFullMask, lane < vn && my_count > 0)) * per_type;
        for (int k0 = 0; k0 < items; k0 += 2 * consumers) {
#pragma unroll
          for (int turn = 0; turn < 2; ++turn) {
            const int k = k0 + (turn ? 2 * consumers - 1 - cwarp : cwarp);
            if (k >= items) continue;
            const int r = k / per_type, it = k - r * per_type;
            const int vl = __shfl_sync(kFullMask, type_at, r);
            const uint32_t holders = __shfl_sync(kFullMask, type_holders, vl);
            const int my_slot = slot_of(v0 + vl);
            const int jm = it / ntg, nt0 = (it - jm * ntg) * NG, ng = min(NG, ntd - nt0);
            // the holders in walker order, dealt to kCh f32 chains in turn
            constexpr int kCh = 4 / NG;
            float sums[kCh][NG][4] = {};
            for (uint32_t m = holders; m;) {
#pragma unroll
              for (int ch = 0; ch < kCh; ++ch) {
                if (!m) break;
                const int w = __ffs(m) - 1;
                m &= m - 1;
                const int slot = __shfl_sync(kFullMask, my_slot, w);
                tg_product<NG>(sums[ch], bucket_set(w, c) + slot * kTile * ys + jm * 16, ys,
                               g_rows(w) + nt0 * 8, gs, ng, lane);
              }
            }
#pragma unroll
            for (int j = 0; j < NG; ++j) {
              if (j >= ng) break;
              float sum[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                sum[i] = sums[0][j][i];
#pragma unroll
                for (int ch = 1; ch < kCh; ++ch) sum[i] += sums[ch][j][i];
              }
              float4* a = reinterpret_cast<float4*>(
                  acc + (((size_t)vl * jsa + jm) * ntd + nt0 + j) * 128 + lane * 4);
              float4 x = *a;
              x.x += sum[0];
              x.y += sum[1];
              x.z += sum[2];
              x.w += sum[3];
              *a = x;
            }
          }
        }
        consumers_sync(consumers);  // the set and the g rows are read: the slots start over
        for (int w = 0; w < walkers; ++w) {
          float4* y4 = reinterpret_cast<float4*>(bucket_set(w, c));
          for (int i = ctid; i < st.used[w] * kTile * ys / 4; i += consumers * 32)
            y4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      const TgSet& nx = sh.set[s];
      for (int i = ctid; i < walkers * kTile * quads; i += consumers * 32) {
        const int w = i / (kTile * quads), row = (i / quads) % kTile, col = (i % quads) * 4;
        const int t = nx.tile[w];
        if (t < 0) continue;
        float* to = g_rows(w) + row * gs + col;
        if (t * kTile + row < n_nodes)
          cp_async16(to, g + (size_t)(t * kTile + row) * dim + col);
        else
          *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      cp_async_commit();
    }
    __syncthreads();
    bool more = false, pending = false;
    for (int w = 0; w < walkers; ++w) {
      more |= sh.set[s].more[w] != 0;
      pending |= sh.set[s].used[w] > 0;
    }
    if (!more && !pending) break;
  }

  // ---- the part's partial table: rows j0 .. of the slice, the group's types
  const int VD = n_types * dim;
  float* out = partial + (size_t)part * dim * VD;
  const int gq = lane >> 2, q = lane & 3;
  for (int f = warp; f < vn * jsa * ntd; f += kTgWarps) {
    const int vl = f / (jsa * ntd), jm = (f / ntd) % jsa, nt = f % ntd;
    if (jm >= jsm) continue;
    const float4 x = reinterpret_cast<const float4*>(acc + (size_t)f * 128)[lane];
    const int j = j0 + jm * 16 + gq, col = (v0 + vl) * dim + nt * 8 + 2 * q;
    if (j < dim) *reinterpret_cast<float2*>(out + (size_t)j * VD + col) = make_float2(x.x, x.y);
    if (j + 8 < dim)
      *reinterpret_cast<float2*>(out + (size_t)(j + 8) * VD + col) = make_float2(x.z, x.w);
  }
}

// out = the sum of the parts' partial tables, in a fixed order: a block of
// 8 warps takes 32 float4 of the table (a lane each); warp w adds the parts
// w, w + 8, ... in order, then warp 0 adds the 8 sums in warp order.
__global__ void __launch_bounds__(256)
table_grad_sum_kernel(const float4* __restrict__ partial, float4* __restrict__ out, long n4,
                      int parts) {
  __shared__ float4 red[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long x = (long)blockIdx.x * 32 + lane;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (x < n4) {
#pragma unroll 4
    for (int p = warp; p < parts; p += 8) {
      const float4 v = partial[(size_t)p * n4 + x];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && x < n4) {
    float4 t = red[0][lane];
    for (int w = 1; w < 8; ++w) {
      t.x += red[w][lane].x;
      t.y += red[w][lane].y;
      t.z += red[w][lane].z;
      t.w += red[w][lane].w;
    }
    out[x] = t;
  }
}

template <typename T, int NG>
int tg_run(const float* g, const void* h, const int* bond, const int* src, const uint8_t* mask,
           const int* rowptr, float* out, int n_nodes, int dim, int n_types, const TgPlan& p,
           float* scratch, cudaStream_t stream) {
  auto kernel = table_grad_bucket_kernel<T, NG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const int parts = tg_parts(p, n_nodes);
  if (parts > 0)
    kernel<<<parts * p.slices * p.groups, kTgWarps * 32, p.smem, stream>>>(
        g, static_cast<const T*>(h), bond, src, mask, rowptr, scratch, n_nodes, dim, n_types,
        p.walkers, p.slots, p.js, p.slices, p.vg, parts);
  const long n4 = (long)dim * n_types * dim / 4;
  table_grad_sum_kernel<<<(unsigned)((n4 + 31) / 32), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(scratch), reinterpret_cast<float4*>(out), n4, parts);
  return (int)cudaGetLastError();
}

template <typename T>
int tg_dispatch(const float* g, const void* h, const int* bond, const int* src,
                const uint8_t* mask, const int* rowptr, float* out, int n_nodes, int dim,
                int n_types, const TgPlan& p, float* scratch, cudaStream_t s) {
  if (p.ng == 4)
    return tg_run<T, 4>(g, h, bond, src, mask, rowptr, out, n_nodes, dim, n_types, p, scratch, s);
  if (p.ng == 2)
    return tg_run<T, 2>(g, h, bond, src, mask, rowptr, out, n_nodes, dim, n_types, p, scratch, s);
  return tg_run<T, 1>(g, h, bond, src, mask, rowptr, out, n_nodes, dim, n_types, p, scratch, s);
}

}  // namespace ionic

// The three entries below take `walkers`: 0 lets tg_plan choose, 8 or 4
// takes that count (a probe's; every wrapper passes 0).
//
// Bytes of the scratch a table-gradient launch over n_nodes takes on the
// current device (the node parts' partial tables), or -1 for a shape the
// kernel does not take. The wrapper allocates it.
IONIC_API long ionic_table_grad_scratch_bytes(int dim, int n_types, int n_nodes, int walkers) {
  ionic::TgPlan p;
  if (!ionic::tg_plan(dim, n_types, ionic::tg_budget(), walkers, p)) return -1;
  return (long)ionic::tg_parts(p, n_nodes) * dim * n_types * dim * 4;
}

// The plan of a launch, for logs and checks: walkers a block, slots a
// tile, rows of a j-slice, slices, types a group, groups, n-tiles a fragment
// group, shared memory bytes a block, node parts; returns 0, or -1 for a
// shape the kernel does not take.
IONIC_API int ionic_table_grad_plan(int dim, int n_types, int n_nodes, int walkers, int* out) {
  ionic::TgPlan p;
  if (!ionic::tg_plan(dim, n_types, ionic::tg_budget(), walkers, p)) return -1;
  const int v[9] = {p.walkers, p.slots, p.js, p.slices, p.vg, p.groups, p.ng, (int)p.smem,
                    ionic::tg_parts(p, n_nodes)};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// dK into out (D, V*D) f32: g (N, D) f32, h (N, D) f32 or bf16, the edges in
// CSR order of dst (rowptr), scratch of ionic_table_grad_scratch_bytes.
// Launches the bucket kernel and the sum of its parts; returns the launch
// error.
IONIC_API int ionic_table_grad(const float* g, const void* h, int h_dtype, const int* bond,
                               const int* src, const uint8_t* mask, const int* rowptr,
                               float* out, int n_nodes, int dim, int n_types, int walkers,
                               void* scratch, void* stream) {
  ionic::TgPlan p;
  if (!ionic::tg_plan(dim, n_types, ionic::tg_budget(), walkers, p))
    return (int)cudaErrorInvalidValue;
  if (!ionic::aligned16(g) || !ionic::aligned16(h) || !ionic::aligned16(out) ||
      !ionic::aligned16(scratch))
    return (int)cudaErrorMisalignedAddress;
  if (n_nodes > 0 && !scratch) return (int)cudaErrorInvalidValue;
  auto* scr = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (h_dtype == ionic::kF32)
    return ionic::tg_dispatch<float>(g, h, bond, src, mask, rowptr, out, n_nodes, dim, n_types,
                                     p, scr, s);
  if (h_dtype == ionic::kBF16)
    return ionic::tg_dispatch<__nv_bfloat16>(g, h, bond, src, mask, rowptr, out, n_nodes, dim,
                                             n_types, p, scr, s);
  return (int)cudaErrorInvalidValue;
}
