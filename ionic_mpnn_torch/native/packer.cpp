// Native batch packer: columnar molecule arrays -> packed COO graph batches.
//
// The port's own copy of the JAX package's C++ packer, built and loaded by
// ionic_mpnn_torch/native/__init__.py. It does what the Python packer
// (ionic_mpnn_torch/data/packing.py) does, at memcpy speed: +1 id offsets,
// per-graph node bookkeeping, optional fwd+rev edge duplication (reference
// parity mode), window-aligned and explicit (balanced) node placement, the
// uniform spread of pad edges, a stable sort-by-destination of the edge list
// (the CUDA kernels read dst as CSR rows), and the window tiling of the
// window layouts. At the reference batch size the per-epoch Python packing
// loop is what the host spends once a CUDA graph has taken the launches off
// it.
//
// Exposed as a plain C ABI for ctypes; all output buffers are caller-
// allocated numpy arrays (rows of the pinned group-staging buffers in fit()'s
// group mode). Returns 0 on success, negative error codes on capacity
// overflow (no silent truncation — reference contrast:
// train_viscosity.py:98-105 truncates silently).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

enum PackError {
  PACK_OK = 0,
  PACK_NODE_OVERFLOW = -1,
  PACK_EDGE_OVERFLOW = -2,
  PACK_BAD_ARGS = -3,
  PACK_TILE_OVERFLOW = -4,
  PACK_LOCALITY = -5,
};

// Forward declaration — pack_graphs delegates to the indexed variant
// with an identity selection (single implementation of the packing,
// alignment, pad-spread, and sort rules).
int pack_graphs_indexed(
    const int32_t* atoms_pool, const int64_t* a_off,
    const int32_t* bonds_pool, const int32_t* edges_pool,
    const int64_t* e_off,
    const int32_t* sel, int32_t n_sel,
    int32_t node_cap, int32_t edge_cap, int32_t duplicate_edges,
    int32_t sort_by_dst, int32_t node_align,
    int32_t* atom_ids_out, int32_t* bond_ids_out,
    int32_t* src_out, int32_t* dst_out,
    int32_t* node_graph_out, int32_t* node_local_out,
    uint8_t* node_mask_out, uint8_t* edge_mask_out);

int pack_graphs_indexed_at(
    const int32_t* atoms_pool, const int64_t* a_off,
    const int32_t* bonds_pool, const int32_t* edges_pool,
    const int64_t* e_off,
    const int32_t* sel, int32_t n_sel,
    const int32_t* node_offsets, int32_t use_offsets,
    int32_t node_cap, int32_t edge_cap, int32_t duplicate_edges,
    int32_t sort_by_dst, int32_t node_align,
    int32_t* atom_ids_out, int32_t* bond_ids_out,
    int32_t* src_out, int32_t* dst_out,
    int32_t* node_graph_out, int32_t* node_local_out,
    uint8_t* node_mask_out, uint8_t* edge_mask_out);

// Pack one batch of molecules given columnar inputs:
//   atom_ids_flat[atom_off[g] : atom_off[g+1]]  -- raw vocab ids, graph g
//   bond_ids_flat[edge_off[g] : edge_off[g+1]]  -- raw vocab ids
//   edges_flat[2*edge_off[g] : 2*edge_off[g+1]] -- (src, dst) local pairs
// Outputs are zero-filled to capacity by this function.
// node_align > 1 forbids molecules from straddling node_align-row window
// boundaries (offsets bump to the next boundary) — the
// edge_layout="window_aligned" contract (mirror of packing.py).
int pack_graphs(
    const int32_t* atom_ids_flat, const int64_t* atom_off,
    const int32_t* bond_ids_flat, const int32_t* edges_flat,
    const int64_t* edge_off, int32_t num_graphs,
    int32_t node_cap, int32_t edge_cap, int32_t duplicate_edges,
    int32_t sort_by_dst, int32_t node_align,
    int32_t* atom_ids_out, int32_t* bond_ids_out,
    int32_t* src_out, int32_t* dst_out,
    int32_t* node_graph_out, int32_t* node_local_out,
    uint8_t* node_mask_out, uint8_t* edge_mask_out) {
  if (num_graphs < 0) return PACK_BAD_ARGS;
  std::vector<int32_t> sel(num_graphs);
  std::iota(sel.begin(), sel.end(), 0);
  return pack_graphs_indexed(
      atom_ids_flat, atom_off, bond_ids_flat, edges_flat, edge_off,
      sel.data(), num_graphs, node_cap, edge_cap, duplicate_edges,
      sort_by_dst, node_align,
      atom_ids_out, bond_ids_out, src_out, dst_out,
      node_graph_out, node_local_out, node_mask_out, edge_mask_out);
}

// Greedy batch planning: given per-graph (node, edge) sizes and PER-SIDE
// capacities, compute batch boundaries (close a batch when the next graph
// would overflow any capacity). Writes batch start indices into starts_out
// (capacity num_graphs + 1); returns the number of batches, or a negative
// PackError if a single graph exceeds capacity.
int plan_batches2(
    const int32_t* n_nodes_a, const int32_t* n_edges_a,
    const int32_t* n_nodes_b, const int32_t* n_edges_b,
    int32_t num_graphs, int32_t batch_size,
    int32_t node_cap_a, int32_t edge_cap_a,
    int32_t node_cap_b, int32_t edge_cap_b,
    int32_t node_align, int32_t* starts_out) {
  int32_t n_batches = 0;
  int32_t count = 0;
  int64_t na = 0, nb = 0, ea = 0, eb = 0;
  // node rows used after placing an n-atom molecule (pack_graphs mirror)
  auto place = [node_align](int64_t used, int64_t n) -> int64_t {
    if (node_align > 1 && n > 0 && used % node_align + n > node_align) {
      used = (used / node_align + 1) * node_align;
    }
    return used + n;
  };
  starts_out[0] = 0;
  for (int32_t g = 0; g < num_graphs; ++g) {
    if (n_nodes_a[g] > node_cap_a || n_nodes_b[g] > node_cap_b)
      return PACK_NODE_OVERFLOW;
    if (node_align > 1 &&
        (n_nodes_a[g] > node_align || n_nodes_b[g] > node_align))
      return PACK_NODE_OVERFLOW;
    if (n_edges_a[g] > edge_cap_a || n_edges_b[g] > edge_cap_b)
      return PACK_EDGE_OVERFLOW;
    const bool overflow = count >= batch_size ||
                          place(na, n_nodes_a[g]) > node_cap_a ||
                          place(nb, n_nodes_b[g]) > node_cap_b ||
                          ea + n_edges_a[g] > edge_cap_a ||
                          eb + n_edges_b[g] > edge_cap_b;
    if (overflow && count > 0) {
      ++n_batches;
      starts_out[n_batches] = g;
      count = 0;
      na = nb = ea = eb = 0;
    }
    ++count;
    na = place(na, n_nodes_a[g]);
    nb = place(nb, n_nodes_b[g]);
    ea += n_edges_a[g];
    eb += n_edges_b[g];
  }
  if (count > 0) {
    ++n_batches;
    starts_out[n_batches] = num_graphs;
  }
  return n_batches;
}

// Back-compat shim: shared capacities for both sides.
int plan_batches(
    const int32_t* n_nodes_a, const int32_t* n_edges_a,
    const int32_t* n_nodes_b, const int32_t* n_edges_b,
    int32_t num_graphs, int32_t batch_size,
    int32_t node_cap, int32_t edge_cap, int32_t node_align,
    int32_t* starts_out) {
  return plan_batches2(n_nodes_a, n_edges_a, n_nodes_b, n_edges_b,
                       num_graphs, batch_size, node_cap, edge_cap,
                       node_cap, edge_cap, node_align, starts_out);
}

// Indexed packing: pack molecules sel[0..n_sel) gathered DIRECTLY from
// whole-dataset flat pools (atoms/bonds/edges + per-molecule offsets) —
// the per-epoch shuffle then permutes only the tiny size arrays instead
// of copying the dataset (measured: the permuted copy was 69% of host
// epoch time at 100k records). Same packed-batch semantics as
// pack_graphs on the selected molecule sequence.
int pack_graphs_indexed(
    const int32_t* atoms_pool, const int64_t* a_off,
    const int32_t* bonds_pool, const int32_t* edges_pool,
    const int64_t* e_off,
    const int32_t* sel, int32_t n_sel,
    int32_t node_cap, int32_t edge_cap, int32_t duplicate_edges,
    int32_t sort_by_dst, int32_t node_align,
    int32_t* atom_ids_out, int32_t* bond_ids_out,
    int32_t* src_out, int32_t* dst_out,
    int32_t* node_graph_out, int32_t* node_local_out,
    uint8_t* node_mask_out, uint8_t* edge_mask_out) {
  return pack_graphs_indexed_at(
      atoms_pool, a_off, bonds_pool, edges_pool, e_off, sel, n_sel,
      nullptr, 0, node_cap, edge_cap, duplicate_edges, sort_by_dst,
      node_align, atom_ids_out, bond_ids_out, src_out, dst_out,
      node_graph_out, node_local_out, node_mask_out, edge_mask_out);
}

// As pack_graphs_indexed, but with OPTIONAL explicit per-molecule node
// offsets (use_offsets != 0): the caller chose the placement (e.g. the
// LPT window balancing in data/packing.py::assign_windows_balanced) and
// this function just writes it. Offsets must be in-bounds and
// non-overlapping; bounds are checked, overlap is the caller's contract.
int pack_graphs_indexed_at(
    const int32_t* atoms_pool, const int64_t* a_off,
    const int32_t* bonds_pool, const int32_t* edges_pool,
    const int64_t* e_off,
    const int32_t* sel, int32_t n_sel,
    const int32_t* node_offsets, int32_t use_offsets,
    int32_t node_cap, int32_t edge_cap, int32_t duplicate_edges,
    int32_t sort_by_dst, int32_t node_align,
    int32_t* atom_ids_out, int32_t* bond_ids_out,
    int32_t* src_out, int32_t* dst_out,
    int32_t* node_graph_out, int32_t* node_local_out,
    uint8_t* node_mask_out, uint8_t* edge_mask_out) {
  if (!atoms_pool || !a_off || !bonds_pool || !edges_pool || !e_off ||
      (!sel && n_sel > 0) || n_sel < 0 || node_cap <= 0 || edge_cap <= 0 ||
      (use_offsets && !node_offsets && n_sel > 0)) {
    return PACK_BAD_ARGS;
  }
  std::memset(atom_ids_out, 0, sizeof(int32_t) * node_cap);
  std::memset(bond_ids_out, 0, sizeof(int32_t) * edge_cap);
  std::memset(src_out, 0, sizeof(int32_t) * edge_cap);
  std::memset(dst_out, 0, sizeof(int32_t) * edge_cap);
  std::memset(node_graph_out, 0, sizeof(int32_t) * node_cap);
  std::memset(node_local_out, 0, sizeof(int32_t) * node_cap);
  std::memset(node_mask_out, 0, node_cap);
  std::memset(edge_mask_out, 0, edge_cap);

  int64_t node_offset = 0;
  int64_t e_count = 0;
  const int dup = duplicate_edges ? 2 : 1;
  for (int32_t i = 0; i < n_sel; ++i) {
    const int32_t g = sel[i];
    const int64_t a0 = a_off[g], a1 = a_off[g + 1];
    const int64_t n = a1 - a0;
    if (use_offsets) {
      node_offset = node_offsets[i];
      if (node_offset < 0) return PACK_BAD_ARGS;
    } else if (node_align > 1 && n > 0) {
      if (n > node_align) return PACK_NODE_OVERFLOW;
      if (node_offset % node_align + n > node_align) {
        node_offset = (node_offset / node_align + 1) * node_align;
      }
    }
    if (node_offset + n > node_cap) return PACK_NODE_OVERFLOW;
    for (int64_t j = 0; j < n; ++j) {
      atom_ids_out[node_offset + j] = atoms_pool[a0 + j] + 1;
      node_graph_out[node_offset + j] = i;
      node_local_out[node_offset + j] = static_cast<int32_t>(j);
      node_mask_out[node_offset + j] = 1;
    }
    const int64_t e0 = e_off[g], e1 = e_off[g + 1];
    const int64_t ne = (e1 - e0) * dup;
    if (e_count + ne > edge_cap) return PACK_EDGE_OVERFLOW;
    for (int64_t e = e0; e < e1; ++e) {
      const int32_t s = edges_pool[2 * e] + static_cast<int32_t>(node_offset);
      const int32_t t = edges_pool[2 * e + 1] + static_cast<int32_t>(node_offset);
      const int32_t b = bonds_pool[e] + 1;
      src_out[e_count] = s;
      dst_out[e_count] = t;
      bond_ids_out[e_count] = b;
      edge_mask_out[e_count] = 1;
      ++e_count;
      if (dup == 2) {
        src_out[e_count] = t;
        dst_out[e_count] = s;
        bond_ids_out[e_count] = b;
        edge_mask_out[e_count] = 1;
        ++e_count;
      }
    }
    node_offset += n;
  }
  if (!use_offsets) {
    // forward-fill pad/gap rows so node_graph is non-decreasing (rows
    // are masked; sequential placement keeps real ids ascending) —
    // mirror of the Python packer's sorted-readout contract.
    int32_t running = 0;
    for (int64_t i = 0; i < node_cap; ++i) {
      if (node_graph_out[i] > running) running = node_graph_out[i];
      else node_graph_out[i] = running;
    }
  }
  const int64_t n_pad = edge_cap - e_count;
  for (int64_t k = 0; k < n_pad; ++k) {
    const int32_t spread = static_cast<int32_t>(k * node_cap / n_pad);
    src_out[e_count + k] = spread;
    dst_out[e_count + k] = spread;
  }
  if (sort_by_dst && edge_cap > 1) {
    // Stable COUNTING sort by dst (values < node_cap): O(E + N) vs the
    // previous std::stable_sort's O(E log E) — the sort was the dominant
    // per-batch cost at production edge counts. Stability (equal dst
    // keeps input order) matches the Python packer's stable argsort, so
    // outputs stay bit-identical.
    std::vector<int32_t> pos(node_cap + 1, 0);
    for (int64_t i = 0; i < edge_cap; ++i) ++pos[dst_out[i] + 1];
    for (int32_t v = 0; v < node_cap; ++v) pos[v + 1] += pos[v];
    std::vector<int32_t> order(edge_cap);
    for (int64_t i = 0; i < edge_cap; ++i) order[pos[dst_out[i]]++] = i;
    std::vector<int32_t> tmp(edge_cap);
    auto permute = [&](int32_t* arr) {
      for (int64_t i = 0; i < edge_cap; ++i) tmp[i] = arr[order[i]];
      std::memcpy(arr, tmp.data(), sizeof(int32_t) * edge_cap);
    };
    permute(src_out);
    permute(dst_out);
    permute(bond_ids_out);
    std::vector<uint8_t> tmpm(edge_cap);
    for (int64_t i = 0; i < edge_cap; ++i) tmpm[i] = edge_mask_out[order[i]];
    std::memcpy(edge_mask_out, tmpm.data(), edge_cap);
  }
  return PACK_OK;
}

// Re-lay a dst-sorted packed edge list into fixed per-window tiles
// (mirror of data/packing.py::window_tile_edges): window w (nodes
// [w*window, (w+1)*window)) owns output slots [w*tile, (w+1)*tile); its
// real edges fill the slot prefix in input order; remaining slots are
// masked self-loops on the window's last node. aligned=1 additionally
// requires src and dst to share a window (edge_layout="window_aligned");
// aligned=0 requires |src - dst| < window (the onehot halo contract).
// Output arrays have (node_cap / window) * tile slots.
int window_tile(
    const int32_t* src, const int32_t* dst, const int32_t* bond_ids,
    const uint8_t* edge_mask, int32_t edge_cap,
    int32_t node_cap, int32_t window, int32_t tile, int32_t aligned,
    int32_t* src_out, int32_t* dst_out, int32_t* bond_out,
    uint8_t* mask_out) {
  if (window <= 0 || tile <= 0 || node_cap % window != 0)
    return PACK_BAD_ARGS;
  const int32_t nw = node_cap / window;
  const int64_t e2 = static_cast<int64_t>(nw) * tile;
  for (int32_t w = 0; w < nw; ++w) {
    const int32_t pad_node = w * window + window - 1;
    for (int32_t t = 0; t < tile; ++t) {
      const int64_t s = static_cast<int64_t>(w) * tile + t;
      src_out[s] = pad_node;
      dst_out[s] = pad_node;
      bond_out[s] = 0;
      mask_out[s] = 0;
    }
  }
  (void)e2;
  std::vector<int32_t> count(nw, 0);
  for (int32_t e = 0; e < edge_cap; ++e) {
    if (!edge_mask[e]) continue;
    const int32_t d = dst[e], sfrom = src[e];
    const int32_t w = d / window;
    if (w < 0 || w >= nw) return PACK_BAD_ARGS;
    if (aligned) {
      if (sfrom / window != w) return PACK_LOCALITY;
    } else {
      const int64_t span = sfrom > d ? sfrom - d : d - sfrom;
      if (span >= window) return PACK_LOCALITY;
    }
    if (count[w] >= tile) return PACK_TILE_OVERFLOW;
    const int64_t s = static_cast<int64_t>(w) * tile + count[w]++;
    src_out[s] = sfrom;
    dst_out[s] = d;
    bond_out[s] = bond_ids[e];
    mask_out[s] = 1;
  }
  return PACK_OK;
}

}  // extern "C"
