// graphcore — host-side graph walks of redgnn_tpu_torch (single-threaded).
//
// The port's copy of the JAX package's redgnn_tpu/native/graphcore.cpp,
// with the same six C functions computing the same numbers: tight O(E)
// loops for the host-side work that runs between device steps —
//   * CSR construction (counting sort by head, stable in (head, time)),
//   * exact frontier walks used for capacity calibration and overflow
//     recalibration (full-row and time-windowed variants).
// The CSR builds and the per-query walks return 1 on a head outside
// [0, n_ent), 0 on success; the Python wrappers in
// redgnn_tpu_torch/native/__init__.py raise on any other code than 0,
// check every other input before the call, and have no fallback.
//
// Build (redgnn_tpu_torch/_build.py:build_host does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC graphcore.cpp -o libgraphcore.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Counting-sort CSR build: triples (n x 3) int64 -> rowptr/rel/tail int32.
// Returns 0 on success.
int build_csr(const int64_t* triples, int64_t n_edges, int64_t n_ent,
              int32_t* rowptr, int32_t* rel_out, int32_t* tail_out) {
  std::vector<int32_t> counts(n_ent + 1, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t h = triples[i * 3];
    if (h < 0 || h >= n_ent) return 1;
    counts[h + 1]++;
  }
  for (int64_t e = 0; e < n_ent; ++e) counts[e + 1] += counts[e];
  std::memcpy(rowptr, counts.data(), (n_ent + 1) * sizeof(int32_t));
  std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t h = triples[i * 3];
    int32_t slot = cursor[h]++;
    rel_out[slot] = static_cast<int32_t>(triples[i * 3 + 1]);
    tail_out[slot] = static_cast<int32_t>(triples[i * 3 + 2]);
  }
  return 0;
}

// Quadruple CSR sorted by (head, time): quads (n x 4) int64.
// perm_out[i] = CSR slot of original row i (for leave-one-out masks).
int build_csr_temporal(const int64_t* quads, int64_t n_edges, int64_t n_ent,
                       int32_t* rowptr, int32_t* rel_out, int32_t* tail_out,
                       int32_t* time_out, int32_t* perm_out) {
  std::vector<int64_t> order(n_edges);
  for (int64_t i = 0; i < n_edges; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [quads](int64_t a, int64_t b) {
                     int64_t ha = quads[a * 4], hb = quads[b * 4];
                     if (ha != hb) return ha < hb;
                     return quads[a * 4 + 3] < quads[b * 4 + 3];
                   });
  std::vector<int32_t> counts(n_ent + 1, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t h = quads[i * 4];
    if (h < 0 || h >= n_ent) return 1;
    counts[h + 1]++;
  }
  for (int64_t e = 0; e < n_ent; ++e) counts[e + 1] += counts[e];
  std::memcpy(rowptr, counts.data(), (n_ent + 1) * sizeof(int32_t));
  for (int64_t s = 0; s < n_edges; ++s) {
    int64_t src_row = order[s];
    rel_out[s] = static_cast<int32_t>(quads[src_row * 4 + 1]);
    tail_out[s] = static_cast<int32_t>(quads[src_row * 4 + 2]);
    time_out[s] = static_cast<int32_t>(quads[src_row * 4 + 3]);
    perm_out[src_row] = static_cast<int32_t>(s);
  }
  return 0;
}

// Exact frontier walk over full CSR rows. Frontier keys are
// batch * n_ent + entity. Writes per-hop node counts (n_layer+1) and
// edge counts (n_layer). Returns 0 on success.
int simulate_hops(const int32_t* rowptr, const int32_t* tail, int64_t n_ent,
                  const int64_t* heads, int64_t n_heads, int64_t n_layer,
                  int64_t* node_counts, int64_t* edge_counts) {
  std::vector<int64_t> keys(n_heads);
  for (int64_t i = 0; i < n_heads; ++i)
    keys[i] = i * n_ent + heads[i];
  node_counts[0] = n_heads;
  for (int64_t hop = 0; hop < n_layer; ++hop) {
    int64_t total = 0;
    for (int64_t k : keys) {
      int64_t e = k % n_ent;
      total += rowptr[e + 1] - rowptr[e];
    }
    edge_counts[hop] = total;
    std::vector<int64_t> next;
    next.reserve(total);
    for (int64_t k : keys) {
      int64_t e = k % n_ent;
      int64_t base = k - e;
      for (int32_t s = rowptr[e]; s < rowptr[e + 1]; ++s)
        next.push_back(base + tail[s]);
    }
    std::sort(next.begin(), next.end());
    next.erase(std::unique(next.begin(), next.end()), next.end());
    keys.swap(next);
    node_counts[hop + 1] = static_cast<int64_t>(keys.size());
  }
  return 0;
}

// Per-query exact frontier walk: node/edge counts per hop for EACH query
// independently. Composite batch keys (b * n_ent + ent) never collide
// across batch elements, so a batch's frontier counts are EXACTLY the sum
// of its queries' counts — the basis for the permutation-exact capacity
// calibration in graph/calibrate.py (no sampling, no replay).
// node_out: (n_heads, n_layer+1) row-major; edge_out: (n_heads, n_layer).
int per_query_hop_counts(const int32_t* rowptr, const int32_t* tail,
                         int64_t n_ent, const int64_t* heads,
                         int64_t n_heads, int64_t n_layer,
                         int64_t* node_out, int64_t* edge_out) {
  std::vector<int64_t> stamp(n_ent, -1);
  std::vector<int32_t> frontier, next;
  int64_t tick = 0;
  for (int64_t q = 0; q < n_heads; ++q) {
    int64_t h = heads[q];
    if (h < 0 || h >= n_ent) return 1;
    frontier.assign(1, static_cast<int32_t>(h));
    node_out[q * (n_layer + 1)] = 1;
    for (int64_t hop = 0; hop < n_layer; ++hop) {
      ++tick;
      int64_t ecnt = 0;
      next.clear();
      for (int32_t e : frontier) {
        ecnt += rowptr[e + 1] - rowptr[e];
        for (int32_t s = rowptr[e]; s < rowptr[e + 1]; ++s) {
          int32_t t = tail[s];
          if (stamp[t] != tick) {
            stamp[t] = tick;
            next.push_back(t);
          }
        }
      }
      edge_out[q * n_layer + hop] = ecnt;
      node_out[q * (n_layer + 1) + hop + 1] =
          static_cast<int64_t>(next.size());
      frontier.swap(next);
    }
  }
  return 0;
}

// Windowed variant (extrapolation): same contract; the +1 self-loop per
// frontier node and the node-keeping semantics mirror
// simulate_hops_windowed exactly.
int per_query_hop_counts_windowed(
    const int32_t* ekey, const int32_t* tail, int64_t n_edges,
    int64_t n_ent, int64_t key_base, const int64_t* heads,
    const int64_t* times, int64_t n_heads, int64_t window, int64_t n_layer,
    int64_t* node_out, int64_t* edge_out) {
  std::vector<int64_t> stamp(n_ent, -1);
  std::vector<int32_t> frontier, next;
  const int32_t* ekey_end = ekey + n_edges;
  int64_t tick = 0;
  for (int64_t q = 0; q < n_heads; ++q) {
    int64_t h = heads[q], tq = times[q];
    if (h < 0 || h >= n_ent) return 1;
    int64_t lo_t = std::max<int64_t>(tq - window, 0);
    frontier.assign(1, static_cast<int32_t>(h));
    node_out[q * (n_layer + 1)] = 1;
    for (int64_t hop = 0; hop < n_layer; ++hop) {
      ++tick;
      int64_t ecnt = 0;
      next.clear();
      for (int32_t e : frontier) {
        const int32_t* lo = std::lower_bound(
            ekey, ekey_end,
            static_cast<int32_t>(static_cast<int64_t>(e) * key_base + lo_t));
        const int32_t* hi = std::lower_bound(
            ekey, ekey_end,
            static_cast<int32_t>(static_cast<int64_t>(e) * key_base + tq));
        ecnt += (hi - lo) + 1;  // +1 self-loop
        if (stamp[e] != tick) {
          stamp[e] = tick;
          next.push_back(e);  // self-loop keeps the node
        }
        for (const int32_t* p = lo; p != hi; ++p) {
          int32_t t = tail[p - ekey];
          if (stamp[t] != tick) {
            stamp[t] = tick;
            next.push_back(t);
          }
        }
      }
      edge_out[q * n_layer + hop] = ecnt;
      node_out[q * (n_layer + 1) + hop + 1] =
          static_cast<int64_t>(next.size());
      frontier.swap(next);
    }
  }
  return 0;
}

// Time-windowed walk (extrapolation): per-node in-window edges found by
// binary search on the composite (head * key_base + time) sorted keys;
// +1 self-loop per node keeps it in the frontier.
int simulate_hops_windowed(const int32_t* ekey, const int32_t* tail,
                           int64_t n_edges, int64_t n_ent, int64_t key_base,
                           const int64_t* heads, const int64_t* times,
                           int64_t n_heads, int64_t window, int64_t n_layer,
                           int64_t* node_counts, int64_t* edge_counts) {
  std::vector<int64_t> keys(n_heads);
  for (int64_t i = 0; i < n_heads; ++i)
    keys[i] = i * n_ent + heads[i];
  node_counts[0] = n_heads;
  const int32_t* ekey_end = ekey + n_edges;
  for (int64_t hop = 0; hop < n_layer; ++hop) {
    int64_t total = 0;
    std::vector<int64_t> next;
    for (int64_t k : keys) {
      int64_t e = k % n_ent;
      int64_t b = k / n_ent;
      int64_t tq = times[b];
      int64_t lo_t = std::max<int64_t>(tq - window, 0);
      const int32_t* lo =
          std::lower_bound(ekey, ekey_end,
                           static_cast<int32_t>(e * key_base + lo_t));
      const int32_t* hi =
          std::lower_bound(ekey, ekey_end,
                           static_cast<int32_t>(e * key_base + tq));
      total += (hi - lo) + 1;  // +1 self-loop
      next.push_back(k);       // self-loop keeps the node
      int64_t base = k - e;
      for (const int32_t* p = lo; p != hi; ++p)
        next.push_back(base + tail[p - ekey]);
    }
    edge_counts[hop] = total;
    std::sort(next.begin(), next.end());
    next.erase(std::unique(next.begin(), next.end()), next.end());
    keys.swap(next);
    node_counts[hop + 1] = static_cast<int64_t>(keys.size());
  }
  return 0;
}

}  // extern "C"
