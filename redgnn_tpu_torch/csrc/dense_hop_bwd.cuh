// Backward walk of the temporal dense hop's kernel
// (dense_hop_temporal_bwd.cu), on Hopper (sm_90a). (The static kernel has a
// walk of its own, its products on the tensor cores:
// dense_hop_static_bwd.cuh.)
//
// Replaces: the gradient of TRedGNN._dense_hop
// (redgnn_tpu/models/temporal.py:461-572), which the JAX package takes by
// XLA autodiff of the composition: every (E, b, d) intermediate of the
// forward is kept, and the backward builds as many again. Here the
// forward's terms are recomputed per (edge, query) from the saved inputs
// and the cotangent row of the edge's tail; nothing per pair is kept
// between the passes.
//
// For a kept pair (edge e of tail v, query q), with G the tail's
// cotangent row (the cotangent of h through the visited mask, act' as a
// function of h alone, and the dropout mask):
//   msg = hs + hr + TT[t_e, q], out = msg W[dir] (or msg + B[dir]),
//   pre = hs A1s + RA[rel] + QA[q], alpha = sigmoid(relu(pre) . a2)
//   dlogit = (G . out) alpha (1 - alpha), 1 - alpha taken as
//   sigmoid(-logit) (no cancellation), dpre = dlogit a2 [pre > 0],
//   d_msg = alpha W[dir] G (or alpha G), d_hs = d_msg + A1s dpre;
//   with the linear transform G . out = msg . (W[dir] G), and W[k] G is
//   computed once an item for each direction k, so no step applies W.
// The sums, by the index that owns them:
//   * over an index the walk does not own, written once per pair and summed
//     by the existing kernels: d_hs (E, b, d) by source (list_sum over
//     tsrc_order), d_msg (E, b, d) by time id (list_sum over the time list);
//     the per-edge rows (groups, E, d + A), [sum_q d_msg | sum_q dpre], by
//     relation (take_rows_grad);
//   * over what the walk owns, on chip: each edge's sum over the warp's 32
//     queries; each query's sum of dpre (d QA); the contractions d A1s =
//     sum hs (x) dpre, d a2 = sum relu(pre) dlogit, and d W[k] = sum over
//     the pairs of direction k of msg (x) alpha G = sum over (tail, query)
//     of M_k (x) G with M_k = sum over the tail's kept edges of direction k
//     of alpha msg (the contraction taken once per item, not per edge; d
//     B[k] likewise with S_k = sum of alpha).
//
// Work: the forward's plan (dense_hop.cuh): a warp takes an item (a chunk
// of at most EDGE_CHUNK edges of one tail) for 32 queries, lane = query,
// query groups of 32 in grid y. Unlike the forward, the warp walks the
// chunk's edges together, one edge a step (lanes that do not keep it add
// zeros), so that each edge's sums over the queries are sums over the
// warp. A step stages each lane's hs, relu(pre), dlogit and d_msg in the
// warp's shared memory; then each lane owns columns (attention column a,
// hidden column j) and sums its columns over the 32 lanes in lane order
// (the d A1 contraction by hidden column where the attention is the
// narrower: umls's A = 5 kept 5 lanes busy and 27 idle).
// Every lane-owned sum and every lane's own running sum lives in the
// warp's own memory (no two lanes write one float): what a step stages
// for the other lanes and the sums updated every step by their owning
// lanes (d A1, d a2) in shared memory; M, W G, d W (per item) and d QA in
// a global scratch of the warp's own (L1-cached), which leaves more warps
// a multiprocessor. The warps' sums are added in warp order by their
// block, the blocks' in block order by a second kernel (sum_partials):
// no float atomics, the same bits on every run. The blocks are
// persistent (at most kBlocksX a query group, a constant, so the order of
// the sums is a function of the shapes);
// the warps a block (1 to 4) and whether the relation tables are staged
// are the choice that keeps the most warps on a multiprocessor in its
// shared memory, again a function of the shapes.
//
// What the card measured (PERF.md §6): a step of this walk at ICEWS14's
// width (d = 20, A = 30) takes ~30k warp cycles, of which the attention's
// forward (its RA row read from global memory inside the loop over a),
// d QA's read-modify-writes of the scratch and the item's end take two
// thirds. A walk that keeps no scratch inside the edge loop (W G in
// registers, M and d QA in shared memory, the relation rows spread by
// shuffles, 8 warps a multiprocessor) ran 14-22% faster there, but its
// three d x A products then took two thirds of its cycles, latency-bound
// at the 8 warps its registers and shared memory allow, and it was no
// faster at width 64; it was not kept.
//
// What bounds it: per kept pair the recomputed attention (d A FMAs), d_hs
// (d A) and the contraction d A1s (d A), with the message's few d; per
// item the three W G and M (x) G (3 d^2 each): ~2,000 FMAs a pair at
// ICEWS14 size (d = 20, A = 30), ~20 GFLOP at 7a's saturated hop, 0.3 ms
// at 67 TFLOP/s; the bytes are two (E, b, d) float32 writes (391 MB each
// at 7a), 0.23 ms. A first kernel: simple and right; the accumulators in
// shared memory leave a few warps a multiprocessor.

#pragma once

#include "dense_hop.cuh"

namespace dense_hop_bwd {

using namespace dense_hop;

// the model's switches: use_time, use_attention, direction_transform
// "linear" (else "bias")
constexpr int kLinear = 1, kAttn = 2, kTime = 4;
constexpr int kMaxWarps = 4;     // warps a block at most
constexpr int kBlocksX = 264;    // persistent blocks a query group at most
constexpr size_t kSmemPerSM = 233472;   // an H100 multiprocessor's
constexpr size_t kSmemPerBlock = 232448;

enum Act { kRelu = 0, kTanh, kSigmoid, kIdd, kSoftplus, kLeakyRelu };

// act'(y) from h = act(y) alone
__device__ __forceinline__ float act_grad(float h, int act) {
  switch (act) {
    case kRelu: return h > 0.f ? 1.f : 0.f;
    case kTanh: return 1.f - h * h;
    case kSigmoid: return h * (1.f - h);
    case kSoftplus: return -expm1f(-h);  // sigmoid(y) = 1 - e^-h
    case kLeakyRelu: return h > 0.f ? 1.f : 0.01f;
    default: return 1.f;
  }
}

struct Bwd {
  const float* hidden;       // (n_tail, b, d)
  const float* rela;         // (R, d)
  const int* trel;           // (E,)
  const int* ttime;          // (E,)
  const int* times;          // (b,)
  const unsigned char* excl;   // (E,) or null
  const unsigned char* ekeep;  // (E, b) or null
  const float* tt;           // (n_time, b, d) or null
  const float* ra;           // (R, A)
  const float* qa;           // (b, A)
  const float* a1;           // A1s (d, A)
  const float* a2;           // (A,)
  const float* wdir;         // (3, d, d) or null
  const float* bdir;         // (3, d) or null
  const float* g;            // (n_tail, b, d) the output's cotangent
  const float* h;            // (n_tail, b, d) the output
  const unsigned char* new_visited;  // (n_tail, b)
  const unsigned char* drop;         // (n_tail, b, d) or null
  float drop_div;
  int act, A, R, flags, n_edges;
  float* dhs;                // (E, b, d)
  float* dmsg;               // (E, b, d) or null (no time term)
  float* erow;               // (groups, E, d + A)
  float* partial;            // (groups, blocks_x, P) scratch
  float* out;                // (P - 32 A + b A,) the parameters' sums
  float* scratch;            // (groups, blocks_x, warps, glob_floats)
  bool vec_h, vec_t, vec_r, vec_g, vec_o, tables;
  int warps;                 // warps a block
  size_t warp_floats;        // shared floats a warp
  size_t glob_floats;        // global scratch floats a warp
};

__host__ __device__ inline int round4(long long n) {
  return (int)((n + 3) / 4 * 4);
}

// floats of the weights staged once a block: the transforms (linear:
// [3][DP^2 + 4], bias: [3][DP]), A1 [A][DP], QA [A][32], a2 [A]
__host__ __device__ inline int base_floats(int dp, int f, int A) {
  const int w = (f & kLinear) ? 3 * (dp * dp + 4) : 3 * dp;
  return round4(w + ((f & kAttn) ? A * (dp + 33) : 0));
}

// floats of a warp's accumulators: d A1 [d][A], d a2 [A], d W [3][d][d]
// (bias: d B [3][d]), d QA [A][32] (the part summed over every block is
// the first P - 32 A). d W or d B (a lane's own columns, updated once an
// item) and d QA (a lane's own column) sit in the warp's global scratch
// (at 7a it leaves more warps a multiprocessor); d A1 and d a2 (updated
// every step by their owning lanes) in its shared memory.
__host__ __device__ inline int acc_floats(int d, int f, int A) {
  return d * A + A + ((f & kLinear) ? 3 * d * d : 3 * d) + 32 * A;
}

__host__ __device__ inline int global_acc_floats(int d, int f) {
  return (f & kLinear) ? 3 * d * d : 3 * d;
}

// The staged hs rows' stride: float4-aligned rows (broadcast reads of a
// row) whose columns, read by the lanes at once, fall 4 banks apart.
constexpr int kHs = 36;

// Which lanes own the d A1 contraction's columns: the hidden ones where
// the attention has fewer (each lane then sums A dot products a step, not
// d, and up to d lanes work, not A).
__host__ __device__ inline bool lanes_own_hidden(int d, int A) {
  return A < d;
}

// floats of a warp's shared memory: staging hs [DP][36], relu(pre)
// [A][33], dlogit [32], d_msg [DP][33], the item's G [DP][33], dpre
// [A][32] (lanes owning hidden columns) and the shared accumulators
__host__ __device__ inline size_t warp_floats(int dp, int d, int f, int A) {
  return (size_t)kHs * dp + round4(33 * A) + 32 + 2 * round4(33 * dp) +
         (lanes_own_hidden(d, A) ? 32 * A : 0) +
         round4(acc_floats(d, f, A) - global_acc_floats(d, f) - 32 * A);
}

// floats of a warp's global scratch (L1-cached; what lanes keep per item,
// moved out of shared memory so that more warps fit a multiprocessor):
// M [3][DP][32] (bias: S [3][32]), W G [3][DP][32] (linear), d W or d B,
// d QA
__host__ __device__ inline size_t glob_floats(int dp, int d, int f, int A) {
  const bool linear = f & kLinear;
  return (size_t)(linear ? 96 * dp : 96) + (linear ? 96 * dp : 0) +
         round4(global_acc_floats(d, f) + 32 * A);
}

// Sum of s[4k .. 4k + 3] * y[4k .. 4k + 3] over k: a row of 32 staged
// floats (broadcast float4 reads) against a lane's 32 registers, four
// chains of eight in a fixed order.
__device__ __forceinline__ float dot32(const float* s, const float (&y)[32]) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(s + 4 * k);
    float& a = c[k & 3];
    a = fmaf(u.x, y[4 * k], a);
    a = fmaf(u.y, y[4 * k + 1], a);
    a = fmaf(u.z, y[4 * k + 2], a);
    a = fmaf(u.w, y[4 * k + 3], a);
  }
  return (c[0] + c[1]) + (c[2] + c[3]);
}

// row[0, d) = r[0, d) (16-byte stores where `vec`), or zeros
template <int DP>
__device__ __forceinline__ void store_row(float* row, int d, bool vec,
                                          const float (&r)[DP]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < DP / 4; ++k)
      if (4 * k < d)
        reinterpret_cast<float4*>(row)[k] =
            make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < DP; ++i)
      if (i < d) row[i] = r[i];
  }
}

template <int DP>
__device__ __forceinline__ void zero_row(float* row, int d, bool vec) {
  float z[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) z[i] = 0.f;
  store_row<DP>(row, d, vec, z);
}

// r[i] += row[i] for i < d, a float row of global memory (four at a time)
template <int DP>
__device__ __forceinline__ void add_row(const float* __restrict__ row, int d,
                                        bool vec, float (&r)[DP]) {
#pragma unroll
  for (int k = 0; k < DP / 4; ++k) {
    if (4 * k < d) {
      const float4 v = load4(row, k, d - 4 * k, vec);
      r[4 * k] += v.x;
      r[4 * k + 1] += v.y;
      r[4 * k + 2] += v.z;
      r[4 * k + 3] += v.w;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMaxWarps * 32)
hop_bwd(Walk p, Bwd t) {
  extern __shared__ __align__(16) float sm[];
  const int f = t.flags;
  const bool use_time = f & kTime, attn = f & kAttn, linear = f & kLinear;
  const int A = attn ? t.A : 0;
  const int d = p.d;
  const int g = blockIdx.y;
  constexpr int kMat = DP * DP + 4;  // one transform, padded
  // the weights, as the forward stages them
  float* s_w = sm;  // [3][kMat] or [3][DP]
  float* s_a1 = s_w + (linear ? 3 * kMat : 3 * DP);
  float* s_qa = s_a1 + A * DP;  // [A][32]
  float* s_a2 = s_qa + A * 32;  // [A]
  if (attn) {
    stage_proj(s_a1, t.a1, A, 1, DP, d, A);  // A1s (d, A)
    stage_query(s_qa, t.qa, p.b, A, g);
    stage_vec(s_a2, t.a2, A);
  }
  if (linear) {
    for (int k = threadIdx.x; k < 3 * kMat; k += blockDim.x) {
      const int m = k / kMat, r = k - m * kMat, i = r / DP, j = r - i * DP;
      s_w[k] = (i < d && j < d) ? t.wdir[((size_t)m * d + i) * d + j] : 0.f;
    }
  } else {
    for (int k = threadIdx.x; k < 3 * DP; k += blockDim.x) {
      const int m = k / DP, j = k - m * DP;
      s_w[k] = j < d ? t.bdir[m * d + j] : 0.f;
    }
  }
  const int base = base_floats(DP, f, A);
  const float* t_ra = t.ra;  // the relation tables: shared or global
  const float* t_rela = t.rela;
  float* s_next = sm + base;
  if (t.tables) {
    if (attn) {
      stage_table(s_next, t.ra, t.R * A);
      t_ra = s_next;
      s_next += round4((long long)t.R * A);
    }
    stage_table(s_next, t.rela, t.R * d);
    t_rela = s_next;
    s_next += round4((long long)t.R * d);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_warps = s_next;
  float* s_hs = s_warps + (size_t)warp * t.warp_floats;  // [DP][36]
  float* s_rp = s_hs + kHs * DP;                         // [A][33]
  float* s_dl = s_rp + round4(33 * A);                   // [32]
  float* s_dm = s_dl + 32;                               // [DP][33]
  float* s_g = s_dm + round4(33 * DP);                   // [DP][33]
  float* s_dp = s_g + round4(33 * DP);
  // the d A1 contraction: lanes own attention columns, or (fewer
  // attention columns than hidden ones) hidden columns, reading dpre
  // staged as [A][32]
  const bool own_i = lanes_own_hidden(d, A);
  float* acc = s_dp + (own_i ? 32 * A : 0);  // d A1, d a2
  // the warp's global scratch: M [3][DP][32] or S [3][32], W G
  // [3][DP][32], then d W or d B and d QA
  float* s_m = t.scratch +
               (((size_t)g * gridDim.x + blockIdx.x) * t.warps + warp) *
                   t.glob_floats;
  float* s_wg = s_m + (linear ? 96 * DP : 96);
  float* acc_w = s_wg + (linear ? 96 * DP : 0);  // d W or d B
  const int off_a2 = d * A, off_w = off_a2 + A;
  const int n_w = global_acc_floats(d, f);   // in global memory
  const int off_qa = off_w + n_w;
  const int n_acc = off_qa + 32 * A;
  // in global memory: d W or d B, then d QA
  const int n_g = n_w + 32 * A;
  float* acc_qa = acc_w + n_w;
  for (int k = lane; k < n_acc - n_g; k += 32) acc[k] = 0.f;
  for (int k = lane; k < n_g; k += 32) acc_w[k] = 0.f;
  __syncthreads();

  const int q = g * 32 + lane;
  const bool active = q < p.b;
  const int tq = active ? __ldg(t.times + q) : 0;
  const int we = d + A;  // width of a per-edge row
  const int n_items = __ldg(p.item_ptr + p.n_tail);
  const int stride = gridDim.x * t.warps;
  for (int w = blockIdx.x * t.warps + warp; w < n_items; w += stride) {
    Item it;
    item_of(p, w, it);
    // the tail's cotangent row for this lane's query
    const size_t vrow = (size_t)it.v * p.b + q;
    float G[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) G[i] = 0.f;
    if (active) {
      load_row<DP>(t.g + vrow * d, d, t.vec_g, G);
      float H[DP];
      load_row<DP>(t.h + vrow * d, d, t.vec_o, H);
      const bool nv = t.new_visited[vrow];
      const unsigned char* drop = t.drop ? t.drop + vrow * d : nullptr;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        float gi = nv ? G[i] * act_grad(H[i], t.act) : 0.f;
        if (drop && i < d) gi = drop[i] ? gi / t.drop_div : 0.f;
        G[i] = i < d ? gi : 0.f;
      }
    }
    // the lane's own column of G, and (linear) W[k] G for each direction
    // k: the transform's share of d_msg and of G . out, once an item
#pragma unroll
    for (int i = 0; i < DP; ++i) s_g[i * 33 + lane] = G[i];
    if (linear) {
      for (int k = 0; k < 3; ++k) {
        const float* W = s_w + k * kMat;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          float s = 0.f;
#pragma unroll
          for (int jc = 0; jc < DP; jc += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(W + i * DP + jc);
            s = fmaf(wv.x, G[jc], s);
            s = fmaf(wv.y, G[jc + 1], s);
            s = fmaf(wv.z, G[jc + 2], s);
            s = fmaf(wv.w, G[jc + 3], s);
          }
          s_wg[(k * DP + i) * 32 + lane] = s;
        }
      }
    }
    // the chunk: indices a lane, kept edges a lane, edges any lane keeps
    const int ne = it.e1 - it.e0;
    int rel_k = 0, te_k = 0;
    bool ok = lane < ne;
    if (ok) {
      rel_k = __ldg(t.trel + it.e0 + lane);
      te_k = __ldg(t.ttime + it.e0 + lane);
      if (t.excl) ok = t.excl[it.e0 + lane];
    }
    Chunk c = stage_chunk(p, it, q, active, __ballot_sync(kFull, ok),
                          t.ekeep);
    const unsigned any = __reduce_or_sync(kFull, c.mine);
    if (linear) {
#pragma unroll 4
      for (int k = 0; k < 3 * DP; ++k) s_m[k * 32 + lane] = 0.f;
    } else {
      for (int k = 0; k < 3; ++k) s_m[k * 32 + lane] = 0.f;
    }
    for (int j = 0; j < ne; ++j) {
      const size_t e = (size_t)it.e0 + j;
      const size_t prow = (e * p.b + q) * d;
      float* erow = t.erow + ((size_t)g * t.n_edges + e) * we;
      if (!((any >> j) & 1u)) {  // no lane keeps the edge: zeros
        if (active) {
          zero_row<DP>(t.dhs + prow, d, d % 4 == 0);
          if (t.dmsg) zero_row<DP>(t.dmsg + prow, d, d % 4 == 0);
        }
        for (int k = lane; k < we; k += 32) erow[k] = 0.f;
        continue;
      }
      const int src = __shfl_sync(kFull, c.src, j);
      const int rel = __shfl_sync(kFull, rel_k, j);
      const int te = __shfl_sync(kFull, te_k, j);
      const bool kept = (c.mine >> j) & 1u;
      float x[DP];  // hs, then the message, then d_msg and d_hs
#pragma unroll
      for (int i = 0; i < DP; ++i) x[i] = 0.f;
      // up to width 32 the relation and time-term rows are loaded with
      // hs, before the attention (wider: added where they are used)
      constexpr bool kEarly = DP <= 32;
      float hr[kEarly ? DP : 1], tr[kEarly ? DP : 1];
      if constexpr (kEarly) {
#pragma unroll
        for (int i = 0; i < DP; ++i) hr[i] = tr[i] = 0.f;
        if (kept) {
          add_table_row<DP>(t_rela + (size_t)rel * d, d, t.vec_r, hr);
          if (use_time)
            load_row<DP>(t.tt + ((size_t)te * p.b + q) * d, d, t.vec_t,
                         tr);
        }
      }
      if (kept)
        load_row<DP>(t.hidden + ((size_t)src * p.b + q) * d, d, t.vec_h, x);
      // the attention's forward: relu(pre) staged for the contractions
      // alpha and 1 - alpha = sigmoid(-logit), each to a few ulps (1.f -
      // alpha cancels where alpha nears 1)
      float alpha = 1.f, beta = 0.f;
      if (attn) {
        const float* r_row = t_ra + (size_t)rel * A;
        float logit = 0.f;
#pragma unroll 2
        for (int a = 0; a < A; ++a) {
          float pre = r_row[a] + s_qa[a * 32 + lane];
          const float* wa = s_a1 + a * DP;
#pragma unroll
          for (int i = 0; i < DP; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(wa + i);
            pre = fmaf(x[i], v.x, pre);
            pre = fmaf(x[i + 1], v.y, pre);
            pre = fmaf(x[i + 2], v.z, pre);
            pre = fmaf(x[i + 3], v.w, pre);
          }
          const float r = kept ? fmaxf(pre, 0.f) : 0.f;
          s_rp[a * 33 + lane] = r;
          logit = fmaf(r, s_a2[a], logit);
        }
        alpha = sigmoid(logit);
        beta = sigmoid(-logit);
      }
#pragma unroll
      for (int i = 0; i < DP; ++i) s_hs[i * kHs + lane] = x[i];
      // the message
      if constexpr (kEarly) {
#pragma unroll
        for (int i = 0; i < DP; ++i) x[i] += hr[i];
      } else {
        add_table_row<DP>(t_rela + (size_t)rel * d, d, t.vec_r, x);
      }
      if (use_time && kept) {
        if constexpr (kEarly) {
#pragma unroll
          for (int i = 0; i < DP; ++i) x[i] += tr[i];
        } else {
          add_row<DP>(t.tt + ((size_t)te * p.b + q) * d, d, t.vec_t, x);
        }
      }
      const int dir = te < tq ? 0 : (te == tq ? 1 : 2);
      // G . out, and d_msg into x: (linear) G . (msg W) = msg . (W G) and
      // d_msg = alpha W G, from this item's W G of the edge's direction
      float da = 0.f;
      if (linear) {
        if (kept) {
          float* m = s_m + (size_t)dir * DP * 32 + lane;
#pragma unroll
          for (int i = 0; i < DP; ++i) m[i * 32] += alpha * x[i];
        }
        const float* wg = s_wg + (size_t)dir * DP * 32 + lane;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          const float v = wg[i * 32];
          da = fmaf(x[i], v, da);
          x[i] = kept ? alpha * v : 0.f;
        }
      } else {
        const float* B = s_w + dir * DP;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          const float gi = s_g[i * 33 + lane];
          da = fmaf(gi, x[i] + B[i], da);
          x[i] = kept ? alpha * gi : 0.f;
        }
        if (kept) s_m[dir * 32 + lane] += alpha;
      }
      const float dl = (attn && kept) ? da * alpha * beta : 0.f;
      s_dl[lane] = dl;
#pragma unroll
      for (int i = 0; i < DP; ++i) s_dm[i * 33 + lane] = x[i];
      if (t.dmsg && active) store_row<DP>(t.dmsg + prow, d, d % 4 == 0, x);
      // d_hs = d_msg + A1 dpre; this query's sum of dpre
      for (int a = 0; a < A; ++a) {
        const float dp = s_rp[a * 33 + lane] > 0.f ? dl * s_a2[a] : 0.f;
        acc_qa[a * 32 + lane] += dp;
        if (own_i) s_dp[a * 32 + lane] = dp;
        const float* wa = s_a1 + a * DP;
#pragma unroll
        for (int i = 0; i < DP; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(wa + i);
          x[i] = fmaf(v.x, dp, x[i]);
          x[i + 1] = fmaf(v.y, dp, x[i + 1]);
          x[i + 2] = fmaf(v.z, dp, x[i + 2]);
          x[i + 3] = fmaf(v.w, dp, x[i + 3]);
        }
      }
      if (active) store_row<DP>(t.dhs + prow, d, d % 4 == 0, x);
      __syncwarp();
      // the lane-owned columns: attention column a (the edge's sum of
      // dpre, d a2, d A1 column a), hidden column j (the edge's sum of
      // d_msg)
      for (int a = lane; a < A; a += 32) {
        float yc[32];
        float es = 0.f, as = 0.f;
        const float a2a = s_a2[a];
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          const float r = s_rp[a * 33 + l], dll = s_dl[l];
          yc[l] = r > 0.f ? dll * a2a : 0.f;
          es += yc[l];
          as = fmaf(r, dll, as);
        }
        acc[off_a2 + a] += as;
        erow[d + a] = es;
        if (!own_i)
          for (int i = 0; i < d; ++i)
            acc[i * A + a] += dot32(s_hs + i * kHs, yc);
      }
      if (own_i) {
        for (int i = lane; i < d; i += 32) {
          float hc[32];
#pragma unroll
          for (int l = 0; l < 32; ++l) hc[l] = s_hs[i * kHs + l];
          for (int a = 0; a < A; ++a)
            acc[i * A + a] += dot32(s_dp + a * 32, hc);
        }
      }
      for (int jj = lane; jj < d; jj += 32) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int l = 0; l < 32; l += 2) {
          s0 += s_dm[jj * 33 + l];
          s1 += s_dm[jj * 33 + l + 1];
        }
        erow[jj] = s0 + s1;
      }
      __syncwarp();
    }
    // the item's end: d W[k] += M_k (x) G, d B[k] += S_k G (M and S in
    // global memory: the lanes' writes made visible to the warp first)
    __threadfence_block();
    __syncwarp();
    for (int jj = lane; jj < d; jj += 32) {
      float gc[32];
#pragma unroll
      for (int l = 0; l < 32; ++l) gc[l] = s_g[jj * 33 + l];
      if (linear) {
        for (int k = 0; k < 3; ++k)
          for (int i = 0; i < d; ++i)
            acc_w[(k * d + i) * d + jj] +=
                dot32(s_m + (size_t)(k * DP + i) * 32, gc);
      } else {
        for (int k = 0; k < 3; ++k)
          acc_w[k * d + jj] += dot32(s_m + k * 32, gc);
      }
    }
    __syncwarp();
  }
  __syncthreads();
  // the block's sums, its warps in order
  float* part = t.partial + ((size_t)g * gridDim.x + blockIdx.x) * n_acc;
  const size_t acc_at = acc - s_hs;  // the accumulators within a warp's floats
  const size_t w_at = acc_w - s_m;
  const float* block_scratch =
      t.scratch + ((size_t)g * gridDim.x + blockIdx.x) * t.warps *
                      t.glob_floats;
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
    // entry k of a warp's accumulators: d W or d B and d QA in global
    // memory, in order; the rest, in order, in shared memory
    const bool in_w = k >= off_w && k < off_w + n_w;
    const bool global = in_w || k >= off_qa;
    const size_t at = global ? w_at + (in_w ? k - off_w : n_w + k - off_qa)
                             : acc_at + (k < off_w ? k : k - n_w);
    float s = 0.f;
    for (int v = 0; v < t.warps; ++v)
      s += global ? block_scratch[v * t.glob_floats + at]
                  : s_warps[v * t.warp_floats + at];
    part[k] = s;
  }
}

// out[o] for o < pc: the sum over every block (query groups, then blocks,
// in order) of the blocks' sums; then (b, A): query q's sum of dpre over
// its group's blocks in order.
__global__ void sum_partials(const float* __restrict__ partial,
                             float* __restrict__ out, int groups,
                             int blocks_x, int n_acc, int pc, int A, int b) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= pc + b * A) return;
  float s = 0.f;
  if (o < pc) {
    for (int gg = 0; gg < groups; ++gg) {
      const float* p = partial + (size_t)gg * blocks_x * n_acc + o;
#pragma unroll 8
      for (int x = 0; x < blocks_x; ++x) s += __ldg(p + (size_t)x * n_acc);
    }
  } else {
    const int k = o - pc, q = k / A, a = k - q * A;
    const float* p = partial + (size_t)(q >> 5) * blocks_x * n_acc + pc +
                     a * 32 + (q & 31);
#pragma unroll 8
    for (int x = 0; x < blocks_x; ++x) s += __ldg(p + (size_t)x * n_acc);
  }
  out[o] = s;
}

// The template instance of a width: the registry's width 20 gets its own.
inline int instance_width(long long d) {
  const int dp = padded_width(d);
  return dp == 24 && d <= 20 ? 20 : dp;
}

// The launch's plan, a function of the shapes alone: the warps a block
// that keep the most warps a multiprocessor (ties: the larger block), the
// relation tables staged where they fit (kTableBytes) and leave room for
// those warps, the persistent blocks a query group; the floats of the
// buffers the walk writes (out: the parameters' sums; partial: the
// blocks'; scratch: the warps' global scratch); and `chain`, the most
// float32 additions a term of a parameter sum passes through in this
// order: within a step at most 32 (d a2's chain over the lanes; dot32's
// 10 after at most `chunk` of M's or S's running sum), a warp's running
// sum over its steps (at most `chunk` edges each of ceil(items /
// (blocks_x warps)) items), the block's warps, then sum_partials' blocks
// of every query group. warps == 0: no block fits.
struct Plan {
  int warps, blocks_x, groups, n_acc, pc;
  bool tables;
  size_t smem, warp_floats, glob_floats;
  long long out_floats, partial_floats, scratch_floats, chain;
};

inline Plan make_plan(int d, int f, int A, int R, int b, long long items,
                      int chunk) {
  Plan pl = {};
  const int dp = instance_width(d);
  if (!(f & kAttn)) A = 0;
  const size_t base = sizeof(float) * base_floats(dp, f, A);
  const size_t tab =
      sizeof(float) * (((f & kAttn) ? round4((long long)R * A) : 0) +
                       round4((long long)R * d));
  pl.warp_floats = warp_floats(dp, d, f, A);
  pl.glob_floats = glob_floats(dp, d, f, A);
  const size_t per_warp = sizeof(float) * pl.warp_floats;
  int best = 0;
  for (int staged = 1; staged >= 0; --staged) {
    if (staged && tab > kTableBytes) continue;
    for (int w = kMaxWarps; w >= 1; --w) {
      const size_t s = base + (staged ? tab : 0) + w * per_warp;
      if (s > kSmemPerBlock) continue;
      const int resident = (int)(kSmemPerSM / (s + 1024)) * w;
      if (resident > best) {
        best = resident;
        pl.warps = w;
        pl.smem = s;
        pl.tables = staged;
      }
    }
  }
  if (best == 0) return pl;
  const long long want = (items + pl.warps - 1) / pl.warps;
  pl.blocks_x = (int)(want < kBlocksX ? want : kBlocksX);
  pl.groups = (b + 31) / 32;
  pl.n_acc = acc_floats(d, f, A);
  pl.pc = pl.n_acc - 32 * A;
  pl.out_floats = pl.pc + (long long)b * A;
  const long long blocks = (long long)pl.groups * pl.blocks_x;
  pl.partial_floats = blocks * pl.n_acc;
  pl.scratch_floats = blocks * pl.warps * (long long)pl.glob_floats;
  const long long per_warp_items =
      (items + (long long)pl.blocks_x * pl.warps - 1) /
      ((long long)pl.blocks_x * pl.warps);
  pl.chain = 32 + chunk + chunk * per_warp_items + pl.warps + blocks;
  return pl;
}

// out[0..6) = the plan's out, partial and scratch floats, warps, blocks a
// query group and chain; an error where no block fits.
inline int write_plan(const Plan& pl, long long* out) {
  if (pl.warps == 0) return (int)cudaErrorInvalidValue;
  out[0] = pl.out_floats;
  out[1] = pl.partial_floats;
  out[2] = pl.scratch_floats;
  out[3] = pl.warps;
  out[4] = pl.blocks_x;
  out[5] = pl.chain;
  return 0;
}

// The walk and the sum of its blocks' partials, as `make_plan` plans them.
template <int DP>
int launch(const Walk& p, Bwd t, const Plan& pl, cudaStream_t stream) {
  t.warps = pl.warps;
  t.tables = pl.tables;
  t.warp_floats = pl.warp_floats;
  t.glob_floats = pl.glob_floats;
  const cudaError_t err = cudaFuncSetAttribute(
      hop_bwd<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  hop_bwd<DP>
      <<<dim3(pl.blocks_x, pl.groups), pl.warps * 32, pl.smem, stream>>>(p,
                                                                       t);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials<<<(int)((pl.out_floats + 255) / 256), 256, 0, stream>>>(
      t.partial, t.out, pl.groups, pl.blocks_x, pl.n_acc, pl.pc, t.A, p.b);
  return (int)cudaGetLastError();
}

inline int by_width(int d, const Walk& p, const Bwd& t, long long items,
                    cudaStream_t s) {
  const Plan pl = make_plan(d, t.flags, t.A, t.R, p.b, items, p.chunk);
  if (pl.warps == 0) return (int)cudaErrorInvalidValue;
  switch (instance_width(d)) {
    case 8: return launch<8>(p, t, pl, s);
    case 16: return launch<16>(p, t, pl, s);
    case 20: return launch<20>(p, t, pl, s);
    case 24: return launch<24>(p, t, pl, s);
    case 32: return launch<32>(p, t, pl, s);
    case 48: return launch<48>(p, t, pl, s);
    case 64: return launch<64>(p, t, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace dense_hop_bwd
