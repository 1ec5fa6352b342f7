// The static dense hop's backward walk (dense_hop_static_bwd.cu), on
// Hopper (sm_90a): its three products a step on the tensor cores.
//
// Replaces: the gradient of RelAttnLayer.dense
// (redgnn_tpu/models/layers.py:159-210), which the JAX package takes by
// XLA autodiff of the composition: every (E, b, d) intermediate of the
// forward is kept, and the backward builds as many again. Here the
// forward's terms are recomputed per (edge, query) from the saved inputs
// and the cotangent row of the edge's tail; nothing per pair is kept
// between the passes.
//
// For a kept pair (edge e of tail v, query q), with G the tail's
// cotangent row:
//   m = hs + hr (one bf16 round in bf16), pre = Ws hs + WR[rel] + WQ[q],
//   alpha = sigmoid(w_a . relu(pre) + b_a),
//   dlogit = (G . m) alpha (1 - alpha), 1 - alpha taken as
//   sigmoid(-logit) (no cancellation), dpre = dlogit w_a [pre > 0],
//   d_m = alpha G, d_hs = d_m + Ws^T dpre.
// The sums, by the index that owns them:
//   * over an index the walk does not own, written once per pair and summed
//     by the existing kernels: d_hs (E, b, d) by source (list_sum over
//     tsrc_order); the per-edge rows (groups, E, d + A), [sum_q d_m |
//     sum_q dpre], by relation (take_rows_grad);
//   * over what the walk owns, on chip: each edge's sum over the warp's 32
//     queries; each query's sum of dpre (d WQ); the contractions d Ws^T =
//     sum hs (x) dpre, d w_a = sum relu(pre) dlogit and d b_a = sum
//     dlogit.
//
// Work: a warp takes a unit (an item of the forward's plan, dense_hop.cuh:
// a chunk of at most EDGE_CHUNK edges of one tail, cut into kSplit units:
// none of the outputs sums over a tail's edges, so a hop of few items
// still fills the card) for 32 queries, and walks the unit's edges
// together, one edge a step (an edge no lane keeps costs a row of zeros).
// A step is three products on the tensor cores, each a warp-wide mma.sync
// m16n8k8 in TF32 with float32 accumulation, in the 3xTF32 split (x = big
// + small, big = tf32(x), small = tf32(x - big); big.big + big.small +
// small.big, each product's error ~2^-22 of |x||y|, float32's order; a
// bf16 state is exact in TF32, its small half 0): pre = hs Ws^T (the 32
// queries x d by d x A), d_hs = d_m + dpre Ws (32 x A by A x d), and
// d Ws^T += hs^T dpre (d x 32 by 32 x A, kept in registers across the
// warp's steps). The queries are the mma's rows: lane l holds queries
// l/4 + 8r (r < 4) and columns 8n + 2 (l % 4) + {0, 1} of every 8-wide
// tile, the accumulator's layout, which is also an A operand once the
// contraction index of a tile is read in the order 0, 2, 4, 6, 1, 3, 5, 7
// (the weights' B fragments are staged in that order, split, once a
// block; the 3xTF32 pieces and the layout's helpers: mma_tf32.cuh, shared
// with the temporal walk). Every per-query term (the logit, alpha, G . m, d_m) is computed
// in that layout, its sums over a query's columns finished by two
// shuffles within the lane's quad. The contraction over the queries needs
// them as its K index: hs and dpre are staged once a step in the warp's
// shared memory ([query][column], rows padded or swizzled so that both
// the staging stores and the fragment loads are conflict-free).
//
// Every sum over lanes is a fixed tree of shuffles; every lane-owned sum
// lives in registers or memory of the warp's own (no two lanes write one
// float); a warp writes its parameter sums once, in order, to its scratch,
// its block adds its warps in order, a second kernel (sum_partials) the
// blocks in order: no float atomics, the same bits on every run. The plan
// (make_plan) fills the card: the warps a block and whether the relation
// tables are staged are the choice that keeps the most warps on a
// multiprocessor (the occupancy calculator, registers and shared memory
// both), and the persistent blocks are as many as the card holds at once.
//
// What bounds it: per kept pair ~6 d A multiply-adds of the three
// products (on the tensor cores: 3 passes, padded to the tiles) and ~10 d
// + 10 A scalar operations; the bytes are the (E, b, d) float32 rows of
// d_hs. At umls's calls the walk is latency-bound (PERF.md): the loops
// over the attention tiles and query k-steps stay rolled (unrolled, a
// step's code outgrows the instruction cache), sm_90 has no instruction
// for cvt.rna.tf32 (tf32() below is two), and the rows are stored
// evict-first.

#pragma once

#include <mutex>
#include <vector>

#include "dense_hop.cuh"
#include "mma_tf32.cuh"

namespace static_bwd {

using namespace dense_hop;
using namespace tc;

constexpr int kMaxWarps = 4;  // warps a block at most
constexpr int kSplit = 8;     // units an item
constexpr size_t kSmemPerBlock = 232448;

struct Bwd {
  const void* hidden;        // (n_tail, b, d) float32 or bf16
  const void* rela;          // (R, d) in hidden's type
  bool bf16;                 // hidden and rela are bf16
  const int* trel;           // (E,)
  const float* ra;           // (R, A): WR
  const float* qa;           // (b, A): WQ
  const float* a1;           // (A, d): Ws
  const float* a2;           // (A,): w_alpha
  const float* balpha;       // (1,)
  const float* g;            // (n_tail, b, d) the output's cotangent
  int A, R, n_edges;
  float* dhs;                // (E, b, d)
  float* erow;               // (groups, E, d + A)
  float* partial;            // (groups, blocks_x, P) scratch
  float* out;                // (P - 32 A + b A,) the parameters' sums
  float* scratch;            // (groups, blocks_x, warps, glob) scratch
  // pairs of floats load as one where true: d (A) even and the table
  // aligned
  bool vec_h, vec_r, vec_g, vec_a;
  bool tables;               // the relation tables staged in shared memory
  int warps;                 // warps a block
  size_t glob;               // global scratch floats a warp
};

__host__ __device__ inline int round4(long long n) {
  return (int)((n + 3) / 4 * 4);
}

// floats of a warp's parameter sums: d Ws^T [d][A], d w_alpha [A], d
// b_alpha [1], d WQ [A][32] (the part summed over every block is the
// first P - 32 A)
__host__ __device__ inline int acc_floats(int d, int A) {
  return d * A + A + 1 + 32 * A;
}

// Where things live, in floats, for an instance's tiles (kd hidden and ka
// attention columns, multiples of 8). Shared memory: the block's weights
// (b1: pre's B fragments [d tiles][A tiles][lane][4], b2: d_hs's [A
// tiles][d tiles][lane][4], both big and small halves; WQ of the group's
// queries [32][ka] staged; w_alpha [ka]), then the relation tables where
// staged (WR [R][ka], the relation rows [R][d] in the tables' type), then
// each warp's two staging blocks, x [32][kd] (hs) and y [32][ka] (pre,
// then dpre), and its lanes' running sums of d WQ [4][ka] and d w_alpha
// [ka] (lane-private, [slot][lane]). A warp's global scratch: its
// parameter sums in order.
struct Offsets {
  int b1, b2, qa, a2, base;  // the block's weights
  int sy, dqa, da2, warp;    // a warp's: x at 0, y, d WQ, d w_alpha
  int glob;                  // a warp's global scratch
};

__host__ __device__ inline Offsets offsets(int kd, int ka, int n_acc) {
  Offsets o = {};
  const int ntd = kd / 8, nta = ka / 8;
  int at = 0;
  o.b1 = at;
  at += 128 * ntd * nta;
  o.b2 = at;
  at += 128 * ntd * nta;
  o.qa = at;
  at += 32 * stage_stride(ka);
  o.a2 = at;
  at += ka;
  o.base = round4(at);
  o.sy = 32 * stage_stride(kd);
  o.dqa = o.sy + 32 * stage_stride(ka);
  o.da2 = o.dqa + 256 * nta;
  o.warp = o.da2 + 64 * nta;
  o.glob = round4(n_acc);
  return o;
}

// The tail's cotangent rows for the lane's four queries, its columns (0
// from d on and for queries past b).
template <int CD>
__device__ __forceinline__ void load_g(const Bwd& t, int b, int d, int v,
                                       const int (&qr)[4],
                                       const bool (&act)[4], int tig,
                                       float (&G)[4][CD]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < CD / 2; ++n) {
      const float2 gv =
          act[r] ? ld2(t.g + ((size_t)v * b + qr[r]) * d, 8 * n + 2 * tig, d,
                       t.vec_g)
                 : make_float2(0.f, 0.f);
      G[r][2 * n] = gv.x;
      G[r][2 * n + 1] = gv.y;
    }
}

// up to width 32, at most 168 registers a thread: three blocks a
// multiprocessor
template <int KD, int KA>
__global__ void __launch_bounds__(kMaxWarps * 32, KD <= 32 ? 3 : 1)
hop_bwd(Walk p, Bwd t) {
  constexpr int NTD = KD / 8, NTA = KA / 8, MTD = (KD + 15) / 16;
  constexpr int CD = 2 * NTD, CA = 2 * NTA;
  // the last 16 hidden rows of d Ws^T half padding
  constexpr bool kHalf = KD % 16 == 8;
  extern __shared__ __align__(16) float sm[];
  const int A = t.A;
  const int d = p.d, b = p.b;
  const int g = blockIdx.y;
  const int n_acc = acc_floats(d, A);
  const Offsets o = offsets(KD, KA, n_acc);
  uint4* s_b1 = reinterpret_cast<uint4*>(sm + o.b1);
  uint4* s_b2 = reinterpret_cast<uint4*>(sm + o.b2);
  float* s_qa = sm + o.qa;
  float* s_a2 = sm + o.a2;
  // Ws^T (i, a) of the hidden row i and attention column a, 0 outside
  auto a1_at = [&](int i, int a) -> float {
    if (i >= d || a >= A) return 0.f;
    return t.a1[(size_t)a * d + i];
  };
  for (int k = threadIdx.x; k < NTD * NTA * 32; k += blockDim.x) {
    const int l = k & 31, tile = k >> 5, gl = l >> 2, tl = l & 3;
    uint4 v;
    // pre's B: contraction rows (hidden) 8 kt + 2 tl + {0, 1}, column
    // (attention) 8 n + gl
    const int kt = tile / NTA, n = tile - kt * NTA;
    split(a1_at(8 * kt + 2 * tl, 8 * n + gl), v.x, v.z);
    split(a1_at(8 * kt + 2 * tl + 1, 8 * n + gl), v.y, v.w);
    s_b1[k] = v;
    // d_hs's B: contraction rows (attention) 8 ka + 2 tl + {0, 1},
    // column (hidden) 8 nd + gl
    const int ka = tile / NTD, nd = tile - ka * NTD;
    split(a1_at(8 * nd + gl, 8 * ka + 2 * tl), v.x, v.z);
    split(a1_at(8 * nd + gl, 8 * ka + 2 * tl + 1), v.y, v.w);
    s_b2[k] = v;
  }
  for (int k = threadIdx.x; k < 32 * KA; k += blockDim.x) {
    const int q = k / KA, a = k - q * KA, qg = g * 32 + q;
    s_qa[sidx(q, a, KA)] = (qg < b && a < A) ? t.qa[(size_t)qg * A + a] : 0.f;
  }
  for (int a = threadIdx.x; a < KA; a += blockDim.x)
    s_a2[a] = a < A ? t.a2[a] : 0.f;
  // the relation tables: shared (WR rows padded to KA) or global
  const float* t_ra = t.ra;
  int ra_stride = A;
  bool vec_a = t.vec_a;
  const void* t_rela = t.rela;
  const int t_size = t.bf16 ? 2 : 4;
  float* s_next = sm + o.base;
  if (t.tables) {
    for (int k = threadIdx.x; k < t.R * KA; k += blockDim.x) {
      const int rr = k / KA, a = k - rr * KA;
      s_next[k] = a < A ? t.ra[(size_t)rr * A + a] : 0.f;
    }
    t_ra = s_next;
    ra_stride = KA;
    vec_a = true;
    s_next += round4((long long)t.R * KA);
    if (t.bf16)
      stage_table(reinterpret_cast<unsigned short*>(s_next),
                  reinterpret_cast<const unsigned short*>(t.rela), t.R * d);
    else
      stage_table(s_next, reinterpret_cast<const float*>(t.rela), t.R * d);
    t_rela = s_next;
    s_next += round4(((long long)t.R * d * t_size + 3) / 4);
  }
  const bool vec_r = t.tables ? d % 2 == 0 : t.vec_r;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float* s_x = s_next + (size_t)warp * o.warp;  // [32][KD]
  float* s_y = s_x + o.sy;                      // [32][KA]
  float* s_dqa = s_x + o.dqa;                   // [4][CA][32]
  float* s_da2 = s_x + o.da2;                   // [CA][32]
  // the warp's global scratch: its parameter sums
  float* wacc = t.scratch +
                (((size_t)g * gridDim.x + blockIdx.x) * t.warps + warp) * t.glob;
  for (int k = lane; k < 320 * NTA; k += 32) s_dqa[k] = 0.f;  // and s_da2
  __syncthreads();

  // the lane's queries gid + 8 r of the group
  int qr[4];
  bool act_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    qr[r] = g * 32 + gid + 8 * r;
    act_r[r] = qr[r] < b;
  }
  const size_t bd = (size_t)b * d;  // a row block of the group's queries
  int qo[4];                         // the lane's queries' row offsets
#pragma unroll
  for (int r = 0; r < 4; ++r) qo[r] = qr[r] * d;
  const int q_lane = g * 32 + lane;  // lane = query for the visited loads
  const bool act_lane = q_lane < b;
  const float ba = __ldg(t.balpha);
  const int we = d + A;  // width of a per-edge row
  // the warp's running sums: d Ws^T in mma fragments (hidden rows 16 mt +
  // gid (+8), attention columns 8 n + 2 tig + {0, 1}); the lane's sum over
  // its queries of d b_alpha; d w_alpha and d WQ in shared memory
  float acc1[MTD][NTA][4];
#pragma unroll
  for (int mt = 0; mt < MTD; ++mt)
#pragma unroll
    for (int n = 0; n < NTA; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc1[mt][n][i] = 0.f;
  float dba = 0.f;

  const int n_items = __ldg(p.item_ptr + p.n_tail);
  const long long n_units = (long long)n_items * kSplit;
  const int per = (p.chunk + kSplit - 1) / kSplit;
  const int stride = gridDim.x * t.warps;
  for (long long u = (long long)blockIdx.x * t.warps + warp; u < n_units;
       u += stride) {
    const int item = (int)(u / kSplit);
    const int part = (int)(u - (long long)item * kSplit);
    Item it;
    item_of(p, item, it);
    it.e0 = min(it.e0 + part * per, it.e1);
    it.e1 = min(it.e0 + per, it.e1);
    const int ne = it.e1 - it.e0;
    if (ne == 0) continue;  // warp-uniform
    // the unit: a relation index a lane
    const bool ok = lane < ne;
    const int rel_k = ok ? __ldg(t.trel + it.e0 + lane) : 0;
    float G[4][CD];  // the unit's cotangent rows
    load_g<CD>(t, b, d, it.v, qr, act_r, tig, G);
    // kept edges a lane (lane = query), edges any lane keeps, then each of
    // the lane's four queries' kept edges
    const Chunk ch = stage_chunk(p, it, q_lane, act_lane,
                                 __ballot_sync(kFull, ok), nullptr);
    const unsigned any = __reduce_or_sync(kFull, ch.mine);
    unsigned mine[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      mine[r] = __shfl_sync(kFull, ch.mine, gid + 8 * r);
    for (int j = 0; j < ne; ++j) {
      const size_t e = (size_t)it.e0 + j;
      float* erow = t.erow + ((size_t)g * t.n_edges + e) * we;
      if (!((any >> j) & 1u)) {  // no lane keeps the edge: zeros
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (!act_r[r]) continue;
          const size_t row = e * bd + qo[r];
#pragma unroll
          for (int n = 0; n < NTD; ++n)
            st2(t.dhs + row, 8 * n + 2 * tig, d, d % 2 == 0, 0.f, 0.f);
        }
        for (int k = lane; k < we; k += 32) erow[k] = 0.f;
        continue;
      }
      const int src = __shfl_sync(kFull, ch.src, j);
      const int rel = __shfl_sync(kFull, rel_k, j);
      bool kept[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) kept[r] = (mine[r] >> j) & 1u;
      // x: hs, then the message, then d_m, then d_hs
      const char* hs_rows = reinterpret_cast<const char*>(t.hidden) +
                            src * bd * t_size;
      float x[4][CD];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const char* hrow = hs_rows + (size_t)qo[r] * t_size;
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          float2 v = make_float2(0.f, 0.f);
          if (kept[r]) v = ld2t(hrow, 8 * n + 2 * tig, d, t.vec_h, t.bf16);
          x[r][2 * n] = v.x;
          x[r][2 * n + 1] = v.y;
        }
      }
      // pre = hs Ws^T + WR[rel] + WQ[q] an attention tile at a time
      // (queries 16 mt + gid (+8), attention columns 8 n + 2 tig + {0, 1})
      // from hs split once (hs itself waits in x's staging block): its
      // logit terms, then the tile parked in y where its dpre goes; then
      // alpha and 1 - alpha
      float alpha[4], beta[4];
      {
        // up to width 32 hs is split once a step; wider, once a tile (the
        // halves would take 4 KD registers)
        constexpr bool kPreSplit = KD <= 32;
        constexpr int CS = kPreSplit ? CD : 1;
        uint32_t xb[4][CS], xs[4][CS];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int n = 0; n < NTD; ++n)
            *reinterpret_cast<float2*>(
                s_x + sidx(gid + 8 * r, 8 * n + 2 * tig, KD)) =
                make_float2(x[r][2 * n], x[r][2 * n + 1]);
          if constexpr (kPreSplit) {
#pragma unroll
            for (int c = 0; c < CD; ++c) split(x[r][c], xb[r][c], xs[r][c]);
          }
        }
        const float* ra_row = t_ra + (size_t)rel * ra_stride;
        float lg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
        for (int n = 0; n < NTA; ++n) {
          float pre[2][4];
          const float2 rv = ld2(ra_row, 8 * n + 2 * tig, A, vec_a);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float2 q0 = *reinterpret_cast<const float2*>(
                s_qa + sidx(gid + 16 * mt, 8 * n + 2 * tig, KA));
            const float2 q1 = *reinterpret_cast<const float2*>(
                s_qa + sidx(gid + 16 * mt + 8, 8 * n + 2 * tig, KA));
            pre[mt][0] = rv.x + q0.x;
            pre[mt][1] = rv.y + q0.y;
            pre[mt][2] = rv.x + q1.x;
            pre[mt][3] = rv.y + q1.y;
          }
#pragma unroll
          for (int kt = 0; kt < NTD; ++kt) {
            const uint4 bw = s_b1[(kt * NTA + n) * 32 + lane];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              uint32_t ab[4], as[4];
              if constexpr (kPreSplit) {
                ab[0] = xb[2 * mt][2 * kt];
                ab[1] = xb[2 * mt + 1][2 * kt];
                ab[2] = xb[2 * mt][2 * kt + 1];
                ab[3] = xb[2 * mt + 1][2 * kt + 1];
                as[0] = xs[2 * mt][2 * kt];
                as[1] = xs[2 * mt + 1][2 * kt];
                as[2] = xs[2 * mt][2 * kt + 1];
                as[3] = xs[2 * mt + 1][2 * kt + 1];
              } else {
                a_frag(x, mt, kt, ab, as);
              }
              mma3f(pre[mt], ab, as, bw);
            }
          }
          const float2 a2n =
              *reinterpret_cast<const float2*>(s_a2 + 8 * n + 2 * tig);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = 2 * mt + (i >> 1);
              const float rv2 = kept[r] ? fmaxf(pre[mt][i], 0.f) : 0.f;
              lg[r] = fmaf(rv2, (i & 1) ? a2n.y : a2n.x, lg[r]);
            }
            *reinterpret_cast<float2*>(
                s_y + sidx(gid + 16 * mt, 8 * n + 2 * tig, KA)) =
                make_float2(pre[mt][0], pre[mt][1]);
            *reinterpret_cast<float2*>(
                s_y + sidx(gid + 16 * mt + 8, 8 * n + 2 * tig, KA)) =
                make_float2(pre[mt][2], pre[mt][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sigmoid_pair(sum_quad(lg[r]) + ba, alpha[r], beta[r]);
        // hs back from its staging block, for the message
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int n = 0; n < NTD; ++n) {
            const float2 v = *reinterpret_cast<const float2*>(
                s_x + sidx(gid + 8 * r, 8 * n + 2 * tig, KD));
            x[r][2 * n] = v.x;
            x[r][2 * n + 1] = v.y;
          }
      }
      // the message m = hs + hr, one bf16 round in bf16
      {
        const char* rrow =
            reinterpret_cast<const char*>(t_rela) + (size_t)rel * d * t_size;
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          const float2 hr = ld2t(rrow, 8 * n + 2 * tig, d, vec_r, t.bf16);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            x[r][2 * n] += hr.x;
            x[r][2 * n + 1] += hr.y;
          }
        }
      }
      if (t.bf16) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CD; ++c)
            x[r][c] = __bfloat162float(__float2bfloat16_rn(x[r][c]));
      }
      // G . m per query, d_m = alpha G into x
      float dl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          s = fmaf(G[r][c], x[r][c], s);
          x[r][c] = kept[r] ? alpha[r] * G[r][c] : 0.f;
        }
        const float dar = sum_quad(s);
        dl[r] = kept[r] ? dar * alpha[r] * beta[r] : 0.f;
      }
      // the edge's sum of d_m over the queries
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float s =
            sum_groups((x[0][c] + x[1][c]) + (x[2][c] + x[3][c]));
        const int col = 8 * (c >> 1) + 2 * tig + (c & 1);
        if (gid == 0 && col < d) erow[col] = s;
      }
      // an attention tile at a time: dpre from the parked pre (d w_alpha,
      // d WQ), staged in its place for the contraction; the edge's sum of
      // dpre over the queries; d_hs += dpre Ws (queries x 8 by 8 x d), on x
#pragma unroll 1
      for (int n = 0; n < NTA; ++n) {
        float dp[2][4];
        const float2 a2n =
            *reinterpret_cast<const float2*>(s_a2 + 8 * n + 2 * tig);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float2* y0 = reinterpret_cast<float2*>(
              s_y + sidx(gid + 16 * mt, 8 * n + 2 * tig, KA));
          float2* y1 = reinterpret_cast<float2*>(
              s_y + sidx(gid + 16 * mt + 8, 8 * n + 2 * tig, KA));
          const float2 p0 = *y0, p1 = *y1;
          dp[mt][0] = p0.x;
          dp[mt][1] = p0.y;
          dp[mt][2] = p1.x;
          dp[mt][3] = p1.y;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 2 * mt + (i >> 1), c = 2 * n + (i & 1);
            const float pv = dp[mt][i];
            const float rv = kept[r] ? fmaxf(pv, 0.f) : 0.f;
            s_da2[c * 32 + lane] = fmaf(rv, dl[r], s_da2[c * 32 + lane]);
            const float dpv =
                pv > 0.f ? dl[r] * ((i & 1) ? a2n.y : a2n.x) : 0.f;
            dp[mt][i] = dpv;
            s_dqa[(r * CA + c) * 32 + lane] += dpv;
          }
          *y0 = make_float2(dp[mt][0], dp[mt][1]);
          *y1 = make_float2(dp[mt][2], dp[mt][3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = sum_groups((dp[0][h] + dp[0][2 + h]) +
                                     (dp[1][h] + dp[1][2 + h]));
          const int a = 8 * n + 2 * tig + h;
          if (gid == 0 && a < A) erow[d + a] = s;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t ab[4], as[4];
          split(dp[mt][0], ab[0], as[0]);
          split(dp[mt][2], ab[1], as[1]);
          split(dp[mt][1], ab[2], as[2]);
          split(dp[mt][3], ab[3], as[3]);
#pragma unroll
          for (int nd = 0; nd < NTD; ++nd) {
            const uint4 bw = s_b2[(n * NTD + nd) * 32 + lane];
            float c[4] = {x[2 * mt][2 * nd], x[2 * mt][2 * nd + 1],
                          x[2 * mt + 1][2 * nd], x[2 * mt + 1][2 * nd + 1]};
            mma3(c, ab, as, bw);
            x[2 * mt][2 * nd] = c[0];
            x[2 * mt][2 * nd + 1] = c[1];
            x[2 * mt + 1][2 * nd] = c[2];
            x[2 * mt + 1][2 * nd + 1] = c[3];
          }
        }
      }
      dba += (dl[0] + dl[1]) + (dl[2] + dl[3]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (!act_r[r]) continue;
        float* row = t.dhs + e * bd + qo[r];
#pragma unroll
        for (int n = 0; n < NTD; ++n)
          st2(row, 8 * n + 2 * tig, d, d % 2 == 0, x[r][2 * n],
              x[r][2 * n + 1]);
      }
      // d Ws^T += hs^T dpre (d x 32 queries by 32 x A) from the staged
      // blocks: A fragment rows (hidden) 16 mt + gid (+8), contraction
      // (queries) 8 ks + tig (+4); B columns (attention) 8 n + gid
      __syncwarp();
#pragma unroll 1
      for (int ks = 0; ks < 4; ++ks) {
        const int q0 = 8 * ks + tig, q1 = q0 + 4;
        uint4 yb[NTA];
#pragma unroll
        for (int n = 0; n < NTA; ++n) {
          split(s_y[sidx(q0, 8 * n + gid, KA)], yb[n].x, yb[n].z);
          split(s_y[sidx(q1, 8 * n + gid, KA)], yb[n].y, yb[n].w);
        }
#pragma unroll
        for (int mt = 0; mt < MTD; ++mt) {
          const int i0 = 16 * mt + gid;
          const bool pad = kHalf && mt == MTD - 1;
          uint32_t ab[4], as[4];
          split(s_x[sidx(q0, i0, KD)], ab[0], as[0]);
          split(pad ? 0.f : s_x[sidx(q0, i0 + 8, KD)], ab[1], as[1]);
          split(s_x[sidx(q1, i0, KD)], ab[2], as[2]);
          split(pad ? 0.f : s_x[sidx(q1, i0 + 8, KD)], ab[3], as[3]);
#pragma unroll
          for (int n = 0; n < NTA; ++n) mma3(acc1[mt][n], ab, as, yb[n]);
        }
      }
      __syncwarp();
    }
  }
  // the warp's parameter sums, in order, to its scratch
  const int off_a2 = d * A, off_ba = off_a2 + A;
  const int off_qa = n_acc - 32 * A;
#pragma unroll
  for (int mt = 0; mt < MTD; ++mt)
#pragma unroll
    for (int n = 0; n < NTA; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * mt + gid + 8 * (i >> 1);
        const int col = 8 * n + 2 * tig + (i & 1);
        if (row < d && col < A) wacc[row * A + col] = acc1[mt][n][i];
      }
#pragma unroll
  for (int c = 0; c < CA; ++c) {
    const float s = sum_groups(s_da2[c * 32 + lane]);
    const int a = 8 * (c >> 1) + 2 * tig + (c & 1);
    if (gid == 0 && a < A) wacc[off_a2 + a] = s;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CA; ++c) {
      const int a = 8 * (c >> 1) + 2 * tig + (c & 1);
      if (a < A)
        wacc[off_qa + a * 32 + gid + 8 * r] = s_dqa[(r * CA + c) * 32 + lane];
    }
  {
    const float s = sum_groups(dba);  // every lane of a quad holds its sum
    if (lane == 0) wacc[off_ba] = s;
  }
  __syncthreads();
  // the block's sums, its warps in order
  float* part = t.partial + ((size_t)g * gridDim.x + blockIdx.x) * n_acc;
  const float* block_acc =
      t.scratch + ((size_t)g * gridDim.x + blockIdx.x) * t.warps * t.glob;
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < t.warps; ++v) s += block_acc[v * t.glob + k];
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

// The launch's plan, a function of the shapes and the compiled kernel on
// this card: the warps a block and whether the relation tables are staged
// are the choice that keeps the most warps on a multiprocessor (the
// occupancy calculator: registers and shared memory; ties: the tables
// staged, then the larger block), the persistent blocks a query group as
// many as the card then holds at once (at most one unit a warp); the
// floats of the buffers the walk writes (out: the parameters' sums;
// partial: the blocks'; scratch: the warps' global scratch); and `chain`,
// the most float32 additions a term of a parameter sum passes through in
// this order. An mma's k-step counts as k additions for each of its three
// products: d Ws^T takes 3 x 32 a step (the 32 queries), every later step
// of the warp adds as many to its running sum; d w_alpha, d b_alpha and
// d WQ at most 4 a step; then the tree over the lanes' column groups (3),
// the block's warps and sum_partials' blocks of every query group.
// warps == 0: no block fits.
struct Plan {
  int warps, blocks_x, groups, n_acc, pc, per_sm, split;
  bool tables;
  size_t smem, glob;
  long long out_floats, partial_floats, scratch_floats, chain;
};

// The runtime's answers a plan needs, asked once each and kept: the
// device's multiprocessors, and the instance's blocks a multiprocessor at
// (warps, shared bytes) on it (its shared memory limit raised first); 0
// where the runtime failed (not kept). A plan is then arithmetic.
template <int KD, int KA>
int blocks_per_sm(int dev, int w, size_t smem) {
  struct Entry {
    int dev, w;
    size_t smem;
    int nb;
  };
  static std::mutex mu;
  static std::vector<Entry> memo;
  const std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : memo)
    if (e.dev == dev && e.w == w && e.smem == smem) return e.nb;
  int nb = 0;
  if (cudaFuncSetAttribute(hop_bwd<KD, KA>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemPerBlock) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, hop_bwd<KD, KA>,
                                                    w * 32, smem) !=
          cudaSuccess)
    return 0;
  memo.push_back({dev, w, smem, nb});
  return nb;
}

template <int KD, int KA>
Plan make_plan(int d, int A, int R, int b, long long items, int chunk,
               int t_size) {
  Plan pl = {};
  pl.n_acc = acc_floats(d, A);
  const Offsets o = offsets(KD, KA, pl.n_acc);
  const size_t base = sizeof(float) * o.base;
  const size_t tab = sizeof(float) * (round4((long long)R * KA) +
                                      round4(((long long)R * d * t_size + 3) /
                                             4));
  const size_t per_warp = sizeof(float) * o.warp;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return pl;
  const int sms = sm_count(dev);
  if (sms == 0) return pl;
  int best = 0, blocks_sm = 0;
  for (int staged = 1; staged >= 0; --staged) {
    for (int w = kMaxWarps; w >= 1; --w) {
      const size_t s = base + (staged ? tab : 0) + w * per_warp;
      if (s > kSmemPerBlock) continue;
      const int nb = blocks_per_sm<KD, KA>(dev, w, s);
      if (nb * w > best) {
        best = nb * w;
        blocks_sm = nb;
        pl.warps = w;
        pl.smem = s;
        pl.tables = staged;
      }
    }
  }
  if (best == 0) return pl;
  pl.per_sm = best;
  pl.split = kSplit;
  pl.groups = (b + 31) / 32;
  const long long units = items * kSplit;
  const long long want = (units + pl.warps - 1) / pl.warps;
  long long fill = (long long)sms * blocks_sm / pl.groups;
  if (fill < 1) fill = 1;
  pl.blocks_x = (int)(want < fill ? want : fill);
  pl.pc = pl.n_acc - 32 * A;
  pl.out_floats = pl.pc + (long long)b * A;
  pl.glob = o.glob;
  const long long blocks = (long long)pl.groups * pl.blocks_x;
  pl.partial_floats = blocks * pl.n_acc;
  pl.scratch_floats = blocks * pl.warps * (long long)pl.glob;
  const long long warps = (long long)pl.blocks_x * pl.warps;
  const long long unit_steps = (chunk + kSplit - 1) / kSplit;
  const long long units_warp = (units + warps - 1) / warps;
  pl.chain = 96 * units_warp * unit_steps + 3 + pl.warps + blocks;
  return pl;
}

// out[0..9) = the plan's out, partial and scratch floats, warps a block,
// blocks a query group, chain, warps a multiprocessor, tables staged (1 or
// 0) and units an item; an error where no block fits.
inline int write_plan(const Plan& pl, long long* out) {
  if (pl.warps == 0) return (int)cudaErrorInvalidValue;
  out[0] = pl.out_floats;
  out[1] = pl.partial_floats;
  out[2] = pl.scratch_floats;
  out[3] = pl.warps;
  out[4] = pl.blocks_x;
  out[5] = pl.chain;
  out[6] = pl.per_sm;
  out[7] = pl.tables;
  out[8] = pl.split;
  return 0;
}

// The walk and the sum of its blocks' partials, as `make_plan` plans them.
template <int KD, int KA>
int launch(const Walk& p, Bwd t, const Plan& pl, cudaStream_t stream) {
  t.warps = pl.warps;
  t.tables = pl.tables;
  t.glob = pl.glob;
  hop_bwd<KD, KA>
      <<<dim3(pl.blocks_x, pl.groups), pl.warps * 32, pl.smem, stream>>>(p,
                                                                       t);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials<<<(int)((pl.out_floats + 255) / 256), 256, 0, stream>>>(
      t.partial, t.out, pl.groups, pl.blocks_x, pl.n_acc, pl.pc, t.A, p.b);
  return (int)cudaGetLastError();
}

// fn(Int<KD>, Int<KA>) for the instance of the hidden width d (8, 16, 24,
// 32, 48, 64) and the attention width A (8, 32, 64)
template <typename F>
int by_instance(int d, int A, F&& fn) {
  const int ka = A <= 8 ? 8 : A <= 32 ? 32 : 64;
#define STATIC_BWD_KD(KD)                                         \
  case KD:                                                        \
    return ka == 8    ? fn(Int<KD>{}, Int<8>{})                   \
           : ka == 32 ? fn(Int<KD>{}, Int<32>{})                  \
                      : fn(Int<KD>{}, Int<64>{});
  switch (padded_width(d)) {
    STATIC_BWD_KD(8)
    STATIC_BWD_KD(16)
    STATIC_BWD_KD(24)
    STATIC_BWD_KD(32)
    STATIC_BWD_KD(48)
    STATIC_BWD_KD(64)
  }
#undef STATIC_BWD_KD
  return (int)cudaErrorInvalidValue;
}

// The walk for these shapes: plan, then launch.
inline int run(const Walk& p, const Bwd& t, long long items, cudaStream_t s) {
  return by_instance(p.d, t.A, [&](auto kd, auto ka) {
    constexpr int KD = decltype(kd)::value, KA = decltype(ka)::value;
    const Plan pl = make_plan<KD, KA>(p.d, t.A, t.R, p.b, items, p.chunk,
                                      t.bf16 ? 2 : 4);
    if (pl.warps == 0) return (int)cudaErrorInvalidValue;
    return launch<KD, KA>(p, t, pl, s);
  });
}

// The plan for these shapes into out (write_plan); t_size: the tables'
// bytes an element.
inline int plan_of(int d, int A, int R, int b, long long items, int chunk,
                   int t_size, long long* out) {
  return by_instance(d, A, [&](auto kd, auto ka) {
    constexpr int KD = decltype(kd)::value, KA = decltype(ka)::value;
    return write_plan(make_plan<KD, KA>(d, A, R, b, items, chunk, t_size),
                      out);
  });
}

}  // namespace static_bwd
