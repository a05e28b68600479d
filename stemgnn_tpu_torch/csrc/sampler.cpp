// Native neighbor sampler: fanout-bounded incoming-neighbor sampling over a
// CSC adjacency, seeds-first node ordering.
//
// The port's copy of the JAX package's native sampler: the C++ sampling
// workers behind PyG's NeighborLoader (reference STEM-GNN/pretrain.py:151,
// utils/loader.py:10), exposed through a C ABI for ctypes.  The same source
// draws the same batches as the JAX package's library.
//
// Semantics match stemgnn_tpu_torch/data/sampler.py::sample_subgraph:
//   * per hop, every frontier node draws up to `fanout` in-edges without
//     replacement (all edges when degree <= fanout, or fanout < 0),
//   * nodes are numbered seeds-first, then in discovery order,
//   * emitted edges are (src_local, dst_local, original_edge_id).
//
// Built at first use by stemgnn_tpu_torch/data/native_sampler.py
// (g++ -O3 -march=native -std=c++17 -fPIC -shared).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// xoshiro256** — fast, seedable, reproducible across platforms.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    for (int i = 0; i < 4; i++) {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
    s[2] ^= t; s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform integer in [0, n)
  inline uint64_t bounded(uint64_t n) { return next() % n; }
};

}  // namespace

extern "C" {

// Returns 0 on success, -1 if output capacities were exceeded (caller should
// retry with larger buffers; partial results are clamped, not corrupted).
int stemgnn_sample_subgraph(
    const int64_t* indptr, const int32_t* src, const int64_t* edge_id,
    int64_t num_nodes,
    const int64_t* seeds, int64_t num_seeds,
    const int64_t* fanouts, int64_t num_hops,
    uint64_t rng_seed,
    int64_t* out_nodes, int64_t* out_num_nodes, int64_t node_cap,
    int32_t* out_esrc, int32_t* out_edst, int64_t* out_eid,
    int64_t* out_num_edges, int64_t edge_cap) {
  Rng rng(rng_seed);
  std::unordered_map<int64_t, int32_t> local;
  local.reserve(static_cast<size_t>(node_cap) * 2);
  std::vector<int64_t> nodes;
  nodes.reserve(node_cap);
  std::vector<int64_t> frontier, next_frontier;
  std::vector<int64_t> pick;  // edge offsets sampled for one node
  std::unordered_set<int64_t> picked;

  int overflow = 0;
  for (int64_t i = 0; i < num_seeds; i++) {
    int64_t v = seeds[i];
    // duplicate seeds keep their first local id (python parity) but still
    // occupy a node slot so out_nodes[:num_seeds] == seeds.  Only the FIRST
    // occurrence enters the frontier: expanding each occurrence would
    // re-sample the node's in-edges onto the same local row (duplicated
    // edges + inflated closures; NeighborLoader expands each unique node
    // once per batch, reference utils/loader.py:10-45).
    if (local.find(v) == local.end()) {
      local.emplace(v, static_cast<int32_t>(i));
      frontier.push_back(v);
    }
    if ((int64_t)nodes.size() < node_cap) nodes.push_back(v);
    else overflow = 1;
  }
  // discovered nodes are numbered after ALL seed slots (duplicates
  // included) so local ids always agree with positions in out_nodes
  int32_t next_local = static_cast<int32_t>(num_seeds);

  int64_t n_edges = 0;
  for (int64_t hop = 0; hop < num_hops && !frontier.empty(); hop++) {
    int64_t fanout = fanouts[hop];
    next_frontier.clear();
    for (int64_t v : frontier) {
      int64_t lo = indptr[v], hi = indptr[v + 1];
      int64_t deg = hi - lo;
      if (deg == 0) continue;
      pick.clear();
      if (fanout >= 0 && deg > fanout) {
        // Floyd's algorithm: `fanout` distinct offsets from [0, deg).
        // (t already picked -> pick j, which cannot have been picked yet.)
        picked.clear();
        for (int64_t j = deg - fanout; j < deg; j++) {
          int64_t t = static_cast<int64_t>(rng.bounded(j + 1));
          int64_t chosen = picked.insert(t).second ? t
                           : (picked.insert(j), j);
          pick.push_back(lo + chosen);
        }
      } else {
        for (int64_t j = lo; j < hi; j++) pick.push_back(j);
      }
      auto dst_it = local.find(v);
      int32_t dst_local = dst_it->second;
      for (int64_t off : pick) {
        int64_t u = src[off];
        auto it = local.find(u);
        int32_t u_local;
        if (it == local.end()) {
          u_local = next_local++;
          local.emplace(u, u_local);
          if ((int64_t)nodes.size() < node_cap) nodes.push_back(u);
          else overflow = 1;
          next_frontier.push_back(u);
        } else {
          u_local = it->second;
        }
        if (n_edges < edge_cap) {
          out_esrc[n_edges] = u_local;
          out_edst[n_edges] = dst_local;
          out_eid[n_edges] = edge_id[off];
          n_edges++;
        } else {
          overflow = 1;
        }
      }
    }
    frontier.swap(next_frontier);
  }

  *out_num_nodes = static_cast<int64_t>(nodes.size());
  std::memcpy(out_nodes, nodes.data(), nodes.size() * sizeof(int64_t));
  *out_num_edges = n_edges;
  return overflow ? -1 : 0;
}

// Batched variant: sample many seed batches in one call (amortizes the ctypes
// boundary; one rng stream per batch for reproducibility).
int stemgnn_sample_subgraph_batch(
    const int64_t* indptr, const int32_t* src, const int64_t* edge_id,
    int64_t num_nodes,
    const int64_t* seeds, int64_t batch_size, int64_t num_batches,
    const int64_t* fanouts, int64_t num_hops,
    uint64_t rng_seed,
    int64_t* out_nodes, int64_t* out_num_nodes, int64_t node_cap,
    int32_t* out_esrc, int32_t* out_edst, int64_t* out_eid,
    int64_t* out_num_edges, int64_t edge_cap) {
  int rc = 0;
  for (int64_t b = 0; b < num_batches; b++) {
    int r = stemgnn_sample_subgraph(
        indptr, src, edge_id, num_nodes,
        seeds + b * batch_size, batch_size, fanouts, num_hops,
        rng_seed + static_cast<uint64_t>(b) * 0x9E3779B97f4A7C15ULL,
        out_nodes + b * node_cap, out_num_nodes + b, node_cap,
        out_esrc + b * edge_cap, out_edst + b * edge_cap,
        out_eid + b * edge_cap, out_num_edges + b, edge_cap);
    if (r != 0) rc = r;
  }
  return rc;
}

}  // extern "C"
