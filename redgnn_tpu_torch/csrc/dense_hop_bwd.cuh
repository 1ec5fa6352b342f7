// Backward walk of the temporal dense hop's kernel
// (dense_hop_temporal_bwd.cu), on Hopper (sm_90a): one edge a step for a
// warp's 32 queries, the step's three products on the tensor cores.
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
// Which walk takes which width: hidden widths up to kTcMaxWidth (8, 16,
// 20, 24, 32: the tensor-core instances 8, 16, 24, 32) the tensor-core
// walk; 48 and 64 the scalar walk (hop_bwd, below), which the
// tensor-core walk did not beat there (its shared memory leaves 2-4 warps
// a multiprocessor at those widths; PERF.md §6).
//
// The tensor-core walk (tc_bwd). Work: the forward's plan (dense_hop.cuh):
// items are chunks of at most EDGE_CHUNK edges of one tail; a warp takes a
// contiguous range of them for 32 queries (query groups of 32 in grid y),
// so that the items of one tail follow each other and share the tail's G,
// W[k] G and M_k, and walks each item's edges that any of its queries
// keeps, one edge a step. A step is three products
// on the tensor cores (mma.sync m16n8k8, 3xTF32: mma_tf32.cuh, the static
// walk's layout): pre = hs A1s (the 32 queries x d by d x A, a fresh
// accumulator each k-step), d_hs = d_msg + dpre A1s^T (32 x A by A x d,
// dpre read from the accumulator's layout as the A operand, k in the order
// 0, 2, 4, 6, 1, 3, 5, 7) and d A1s += hs^T dpre (d x 32 by 32 x A); an
// tail adds two more for each direction k its kept pairs take: W[k] G (32
// x d by d x d, at its first item with such a pair) and d W[k] += M_k^T G
// (d x 32 by 32 x d, at its end). Every per-query term (the logit, alpha, G . out, d_msg) is
// computed in the accumulator's layout, its sums over a query's columns
// two shuffles within the lane's quad; each edge's sums over the queries a
// fixed tree of shuffles.
//
// Where each accumulator lives (inside the edge loop global memory sees
// the step's rows and, linear form, the lanes' own elements of M_k):
//   * registers, the lane's own elements in the accumulator's layout:
//     d A1s (across the warp's steps), d QA (its four queries) and the
//     tail's G and (bias form) S_k;
//   * the warp's shared memory ([query][column] blocks, mma_tf32.cuh's
//     stride and swizzle: both the lanes' pair stores and the fragment
//     loads conflict-free): a two-slot ring of each step's hs rows (the 32
//     queries') and relation rows (RA, the relation row), into which the
//     next edge's rows arrive by cp.async while this edge is worked on,
//     and one TT slot, into which the next edge's TT rows arrive once this
//     edge's d_msg rows have left it (16-byte copies where d % 4 == 0,
//     4-byte ones otherwise: no copy reads past the (queries, d) block);
//     the step's d_msg rows are staged in the TT slot once it is read, its
//     d_hs rows in its hs slot, and stored from there coalesced and
//     evict-first; pre, then dpre, staged for the d A1s product; the lanes'
//     shares of d a2 (lane-private; the share of a column group summed by
//     a tree at the end); the tail's W[k] G (linear);
//   * the warp's global scratch: M_k (linear; each lane adds to its own
//     elements, loaded together first; the tail's end reads them back for
//     the product), its parameter sums, d W[k] (or d B[k]) added once a
//     tail, the rest written once at the end. M_k in shared memory would
//     leave 5 warps a multiprocessor at ICEWS14's widths, not 8: the walk
//     is bound by its steps' latency, and its time falls with the warps.
// The warps' sums are added in warp order by their block, the blocks' in
// block order by a second kernel (sum_partials): no float atomics, the
// same bits on every run. The plan (tc_plan) fills the card: the warps
// a block (up to 8) keep the most warps on a multiprocessor (the
// occupancy calculator: registers and shared memory both), and the
// persistent blocks are as many as the card holds at once.
//
// What bounds it: per kept pair the recomputed attention, d_hs and the
// contraction d A1s (2 d A multiply-adds each), with the message's few d;
// per (tail, query, direction) W G and M (x) G (2 d^2 each); and the two
// (E, b, d) float32 rows it writes. The scalar walk (one query a
// lane, M, W G, d W and d QA in a global scratch of the warp's) ran ~30k
// warp cycles a step at ICEWS14's width, two thirds of them waiting on
// global memory inside the edge loop or in its dot products' chains
// (PERF.md §6). This walk takes its products to the tensor cores, the
// waits out of the loop but for M_k's, and keeps 8 warps a multiprocessor
// at ICEWS14's widths (255 registers, 24 KB of shared memory a warp): a
// step is latency-bound, so its time falls with the warps that hide it.

#pragma once

#include <mutex>
#include <vector>

#include "dense_hop.cuh"
#include "mma_tf32.cuh"

namespace dense_hop_bwd {

using namespace dense_hop;
using namespace tc;

// the model's switches: use_time, use_attention, direction_transform
// "linear" (else "bias")
constexpr int kLinear = 1, kAttn = 2, kTime = 4;
constexpr int kMaxWarps = 8;     // the tensor-core walk's warps a block
constexpr int kTcMaxWidth = 32;  // the widest hidden width it takes
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
  // 16-byte pieces of the state and time-term rows (d % 4 == 0, the table
  // aligned); the tensor-core walk: 16-byte row stores (d % 4 == 0,
  // aligned), g, h and W by pairs (d even, aligned); the scalar walk:
  // float4 rows of the other tables (d % 4 == 0, aligned), tables staged
  bool vec_h, vec_t, st16, vec_g, vec_w, vec_r, vec_g4, vec_o, tables;
  int warps;                 // warps a block
  size_t warp_floats;        // the scalar walk's shared floats a warp
  size_t glob_floats;        // global scratch floats a warp
};

__host__ __device__ inline int round4(long long n) {
  return (int)((n + 3) / 4 * 4);
}

// floats of a warp's parameter sums, in out's order: d A1 [d][A], d a2
// [A], d W [3][d][d] (bias: d B [3][d]), d QA [A][32] (the part summed
// over every block is the first P - 32 A)
__host__ __device__ inline int acc_floats(int d, int f, int A) {
  return d * A + A + ((f & kLinear) ? 3 * d * d : 3 * d) + 32 * A;
}

// ------------------------------------------------------ the tensor-core walk

// Asynchronous copies global -> shared (cp.async; L1 bypassed for the
// 16-byte form), a group of them committed, the lane's groups but the
// newest N waited for.
__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The lane's 16-byte pieces of a (nq, d) block of global memory (nq * d
// contiguous floats: the group's queries' rows of one index; d % 4 == 0):
// piece i is floats 4 (lane + 32 i) .. + 3, staged in shared memory at
// soff[i] of a (32, KD) block (sidx); n pieces in all. The same for every
// block of the walk, so computed once.
template <int KD>
struct Pieces {
  static constexpr int kMax = KD / 4;  // a lane's pieces at most
  int n;
  int soff[kMax];
};

template <int KD>
__device__ __forceinline__ Pieces<KD> pieces_of(int nq, int d) {
  Pieces<KD> pc;
  const int lane = threadIdx.x & 31, d4 = d >> 2;
  pc.n = nq * d4;
#pragma unroll
  for (int i = 0; i < Pieces<KD>::kMax; ++i) {
    const int k = lane + 32 * i, q = d4 ? k / d4 : 0;
    pc.soff[i] = sidx(q, 4 * (k - q * d4), KD);
  }
  return pc;
}

// A (nq, d) block of global memory into rows [0, nq), columns [0, d) of a
// (32, KD) block staged in shared memory (sidx), by the warp's lanes:
// 16-byte copies where `v16` (d % 4 == 0 and the block 16-byte aligned;
// the pieces `pc`), else 4-byte ones. The staged block's other rows and
// columns are not written; nothing past the block is read.
template <int KD>
__device__ __forceinline__ void copy_block(float* s, const float* g,
                                           const Pieces<KD>& pc, int nq,
                                           int d, bool v16) {
  const int lane = threadIdx.x & 31;
  if (v16) {
#pragma unroll
    for (int i = 0; i < Pieces<KD>::kMax; ++i) {
      const int k = lane + 32 * i;
      if (k < pc.n) cp_async16(s + pc.soff[i], g + 4 * k);
    }
  } else {
    const int n = nq * d;
    for (int k = lane; k < n; k += 32) {
      const int q = k / d;
      cp_async4(s + sidx(q, k - q * d, KD), g + k);
    }
  }
}

// The staged block's rows [0, nq), columns [0, d) into a contiguous (nq,
// d) block of global memory, evict-first (read back only by list_sum,
// after the walk): the lanes' 16-byte pieces where `v16`, else
// consecutive floats.
template <int KD>
__device__ __forceinline__ void store_block(float* g, const float* s,
                                            const Pieces<KD>& pc, int nq,
                                            int d, bool v16) {
  const int lane = threadIdx.x & 31;
  if (v16) {
#pragma unroll
    for (int i = 0; i < Pieces<KD>::kMax; ++i) {
      const int k = lane + 32 * i;
      if (k < pc.n)
        __stcs(reinterpret_cast<float4*>(g) + k,
               *reinterpret_cast<const float4*>(s + pc.soff[i]));
    }
  } else {
    const int n = nq * d;
    for (int k = lane; k < n; k += 32) {
      const int q = k / d;
      __stcs(g + k, s[sidx(q, k - q * d, KD)]);
    }
  }
}

// n zeros into global memory (16-byte stores where `v16`: n % 4 == 0 and
// g aligned)
__device__ __forceinline__ void zero_block(float* g, int n, bool v16) {
  const int lane = threadIdx.x & 31;
  if (v16) {
    for (int k = lane; k < n / 4; k += 32)
      __stcs(reinterpret_cast<float4*>(g) + k, make_float4(0.f, 0.f, 0.f,
                                                           0.f));
  } else {
    for (int k = lane; k < n; k += 32) __stcs(g + k, 0.f);
  }
}

// The lane's rows (queries gid + 8r) and column pairs of a staged block,
// the rows of queries not in `keep` as zeros.
template <int KD, int CD>
__device__ __forceinline__ void load_frag(const float* s, int gid, int tig,
                                          const bool (&keep)[4],
                                          float (&x)[4][CD]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < CD / 2; ++n) {
      const float2 v = *reinterpret_cast<const float2*>(
          s + sidx(gid + 8 * r, 8 * n + 2 * tig, KD));
      x[r][2 * n] = keep[r] ? v.x : 0.f;
      x[r][2 * n + 1] = keep[r] ? v.y : 0.f;
    }
}

// ... and back into a staged block
template <int KD, int CD>
__device__ __forceinline__ void stage_frag(float* s, int gid, int tig,
                                           const float (&x)[4][CD]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < CD / 2; ++n)
      *reinterpret_cast<float2*>(s + sidx(gid + 8 * r, 8 * n + 2 * tig, KD)) =
          make_float2(x[r][2 * n], x[r][2 * n + 1]);
}

// an edge's direction for a query: past, now or future
__device__ __forceinline__ int dir_of(int te, int tq) {
  return te < tq ? 0 : (te == tq ? 1 : 2);
}

// Where things live, in floats, for an instance's tiles (kd hidden and ka
// attention columns, multiples of 8) and the run's flags. The block's
// weights (with attention: b1, pre's B fragments [d tiles][A tiles][lane]
// [4] and b2, d_hs's [A tiles][d tiles][lane][4], both halves of the
// split; QA of the group's queries [32][ka] staged; a2 [ka]; bias form: B
// [3][kd]); then each warp's region: the ring's two hs slots [32][kd] at
// 0 (the slot of the step's edge, once read, stages its d_hs rows), the
// TT slot at tt (use_time: the step's TT rows, then its d_msg rows, then
// the next edge's TT rows), two edge-row slots at rows (RA [ka], then the
// relation row [kd]), y ([32][ka]: pre, then dpre), the lanes' shares of
// d a2 ([ka / 4][32], lane-private), and (linear) W[k] G at wg,
// [3][32][kd]. Blocks [32][w] take mma_tf32.cuh's stride(w); every offset
// is 16-byte aligned. (M_k lives in the warp's global scratch: in shared
// memory it would leave 5 warps a multiprocessor at ICEWS14's widths, not
// 8.)
struct Offsets {
  int b1, b2, qa, a2, bd, base;               // the block's
  int blk, tt, rows, rstride, y, da2, wg, warp;  // a warp's
};

__host__ __device__ inline Offsets offsets(int kd, int ka, int f) {
  Offsets o = {};
  const bool attn = f & kAttn, linear = f & kLinear;
  const int tiles = (kd / 8) * (ka / 8);
  int at = 0;
  o.b1 = at;
  at += attn ? 128 * tiles : 0;
  o.b2 = at;
  at += attn ? 128 * tiles : 0;
  o.qa = at;
  at += attn ? 32 * stage_stride(ka) : 0;
  o.a2 = at;
  at += attn ? ka : 0;
  o.bd = at;
  at += linear ? 0 : 3 * kd;
  o.base = round4(at);
  o.blk = 32 * stage_stride(kd);
  o.tt = 2 * o.blk;
  o.rows = o.tt + ((f & kTime) ? o.blk : 0);
  o.rstride = round4(ka + kd);
  o.y = o.rows + 2 * o.rstride;
  o.da2 = o.y + (attn ? 32 * stage_stride(ka) : 0);
  o.wg = o.da2 + (attn ? 8 * ka : 0);
  o.warp = o.wg + (linear ? 3 * o.blk : 0);
  return o;
}

// The tail's cotangent rows G for the lane's four queries, its column
// pairs: the cotangent of h through the visited mask, act' and the
// dropout mask (0 from d on and for queries past b).
template <int CD>
__device__ __forceinline__ void load_cotangent(const Bwd& t, int b, int d,
                                               int v, const int (&qr)[4],
                                               const bool (&act)[4], int tig,
                                               float (&G)[4][CD]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t row = (size_t)v * b + qr[r];
    const bool nv = act[r] && t.new_visited[row];
#pragma unroll
    for (int n = 0; n < CD / 2; ++n) {
      const int c = 8 * n + 2 * tig;
      float2 gv = make_float2(0.f, 0.f), hv = gv;
      if (nv) {
        gv = ld2(t.g + row * d, c, d, t.vec_g);
        hv = ld2(t.h + row * d, c, d, t.vec_g);
      }
      float g0 = gv.x * act_grad(hv.x, t.act);
      float g1 = gv.y * act_grad(hv.y, t.act);
      if (t.drop) {
        const unsigned char* keep = t.drop + row * d;
        g0 = (nv && c < d && keep[c]) ? g0 / t.drop_div : 0.f;
        g1 = (nv && c + 1 < d && keep[c + 1]) ? g1 / t.drop_div : 0.f;
      }
      G[r][2 * n] = g0;
      G[r][2 * n + 1] = g1;
    }
  }
}

template <int KD, int KA>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
tc_bwd(Walk p, Bwd t) {
  constexpr int NTD = KD / 8, NTA = KA / 8, MTD = (KD + 15) / 16;
  constexpr int CD = 2 * NTD, CA = 2 * NTA;
  // the last 16 hidden rows of d A1s and d W half padding
  constexpr bool kHalf = KD % 16 == 8;
  extern __shared__ __align__(16) float sm[];
  const int f = t.flags;
  const bool use_time = f & kTime, attn = f & kAttn, linear = f & kLinear;
  const int A = t.A;  // 0 without attention
  const int d = p.d, b = p.b;
  const int g = blockIdx.y;
  const Offsets o = offsets(KD, KA, f);
  uint4* s_b1 = reinterpret_cast<uint4*>(sm + o.b1);
  uint4* s_b2 = reinterpret_cast<uint4*>(sm + o.b2);
  float* s_qa = sm + o.qa;
  float* s_a2 = sm + o.a2;
  float* s_bd = sm + o.bd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float* s_w = sm + o.base + (size_t)warp * o.warp;  // the warp's region
  if (attn) {
    // A1s (i, a) of the hidden row i and attention column a, 0 outside
    auto a1_at = [&](int i, int a) -> float {
      if (i >= d || a >= A) return 0.f;
      return t.a1[(size_t)i * A + a];
    };
    for (int k = threadIdx.x; k < NTD * NTA * 32; k += blockDim.x) {
      const int l = k & 31, tile = k >> 5, gl = l >> 2, tl = l & 3;
      // pre's B: contraction rows (hidden) 8 kt + 2 tl + {0, 1}, column
      // (attention) 8 n + gl
      const int kt = tile / NTA, n = tile - kt * NTA;
      s_b1[k] = split2(a1_at(8 * kt + 2 * tl, 8 * n + gl),
                       a1_at(8 * kt + 2 * tl + 1, 8 * n + gl));
      // d_hs's B: contraction rows (attention) 8 ka + 2 tl + {0, 1},
      // column (hidden) 8 nd + gl
      const int ka = tile / NTD, nd = tile - ka * NTD;
      s_b2[k] = split2(a1_at(8 * nd + gl, 8 * ka + 2 * tl),
                       a1_at(8 * nd + gl, 8 * ka + 2 * tl + 1));
    }
    for (int k = threadIdx.x; k < 32 * KA; k += blockDim.x) {
      const int q = k / KA, a = k - q * KA, qg = g * 32 + q;
      s_qa[sidx(q, a, KA)] =
          (qg < b && a < A) ? t.qa[(size_t)qg * A + a] : 0.f;
    }
    for (int a = threadIdx.x; a < KA; a += blockDim.x)
      s_a2[a] = a < A ? t.a2[a] : 0.f;
  }
  if (!linear) {
    for (int k = threadIdx.x; k < 3 * KD; k += blockDim.x) {
      const int m = k / KD, j = k - m * KD;
      s_bd[k] = j < d ? t.bdir[m * d + j] : 0.f;
    }
  }
  // the warp's region zeroed: what the ring's copies leave unwritten (the
  // padding columns, the rows past b) stays 0
  for (int k = lane; k < o.warp; k += 32) s_w[k] = 0.f;
  // the warp's parameter sums in its global scratch (d W or d B running
  // there, item by item), then (linear) the item's M_k [3][32][KD]
  float* wacc = t.scratch +
                (((size_t)g * gridDim.x + blockIdx.x) * t.warps + warp) *
                    t.glob_floats;
  const int n_w = linear ? 3 * d * d : 3 * d;
  const int off_a2 = d * A, off_w = off_a2 + A, off_qa = off_w + n_w;
  float* __restrict__ m_g = wacc + round4(off_qa + 32 * A);
  for (int k = lane; k < n_w; k += 32) wacc[off_w + k] = 0.f;
  __syncthreads();

  // the lane's queries gid + 8 r of the group, and their times
  int qr[4], tq[4];
  bool act_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    qr[r] = g * 32 + gid + 8 * r;
    act_r[r] = qr[r] < b;
    tq[r] = act_r[r] ? __ldg(t.times + qr[r]) : 0;
  }
  const int q_lane = g * 32 + lane;  // lane = query for the chunk's masks
  const bool act_lane = q_lane < b;
  const int tq_lane = act_lane ? __ldg(t.times + q_lane) : 0;
  const int nq = min(32, b - g * 32);  // the group's queries
  const Pieces<KD> pc = pieces_of<KD>(nq, d);
  const int we = d + A;                // width of a per-edge row
  // the warp's running sums in registers: d A1s in mma fragments (hidden
  // rows 16 mt + gid (+8), attention columns 8 n + 2 tig + {0, 1}); d QA
  // of the lane's queries and columns; the lane's share of d a2
  float acc1[MTD][NTA][4], dqa[4][CA];
#pragma unroll
  for (int mt = 0; mt < MTD; ++mt)
#pragma unroll
    for (int n = 0; n < NTA; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc1[mt][n][i] = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CA; ++c) dqa[r][c] = 0.f;

  // the warp's items: a contiguous range of the plan's, so that the items
  // of one tail follow each other and share its G, W[k] G and M_k (one
  // item end a tail, not an item)
  const long long n_items = __ldg(p.item_ptr + p.n_tail);
  const long long warps_all = (long long)gridDim.x * t.warps;
  const long long gw = (long long)blockIdx.x * t.warps + warp;
  const int w_lo = (int)(gw * n_items / warps_all);
  const int w_hi = (int)((gw + 1) * n_items / warps_all);
  // the tail of the items walked: v, its first item and the next tail's,
  // its edges; `done` the directions whose W[k] G and M_k are live for it
  int v = -1, first = 0, next_first = 0, tail_e0 = 0, tail_e1 = 0;
  unsigned done = 0;
  float G[4][CD];
  float S[3][4];  // bias form: the sum of alpha by direction
  // the tail's end: d W[k] += M_k^T G (d x 32 queries by 32 x d: G staged
  // in hs slot 0, free until the next item's first copy; M_k's fragments
  // loaded from the warp's scratch), into the warp's running sums; bias:
  // d B[k] += sum over the queries of S_k G
  auto close_tail = [&]() {
    if (linear) {
      float* s_g = s_w;
      stage_frag<KD, CD>(s_g, gid, tig, G);
      __threadfence_block();  // the lanes' M rows seen by the warp
      __syncwarp();
#pragma unroll 1
      for (int k = 0; k < 3; ++k) {
        if (!((done >> k) & 1u)) continue;
        const float* m = m_g + k * 32 * KD;
        float* dw = wacc + off_w + (size_t)k * d * d;
#pragma unroll 1
        for (int mt = 0; mt < MTD; ++mt) {
          const int i0 = 16 * mt + gid;
          const bool pad = kHalf && mt == MTD - 1;
          float mf[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const int q0 = 8 * ks + tig, q1 = q0 + 4;
            mf[ks][0] = m[q0 * KD + i0];
            mf[ks][1] = pad ? 0.f : m[q0 * KD + i0 + 8];
            mf[ks][2] = m[q1 * KD + i0];
            mf[ks][3] = pad ? 0.f : m[q1 * KD + i0 + 8];
          }
          // the lane's elements of d W (rows 16 mt + gid (+8), columns 8 n
          // + 2 tig + {0, 1}), loaded while the product runs
          float c[NTD][4], old[NTD][4];
#pragma unroll
          for (int n = 0; n < NTD; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = i0 + 8 * (i >> 1);
              const int col = 8 * n + 2 * tig + (i & 1);
              c[n][i] = 0.f;
              old[n][i] = (row < d && col < d) ? dw[row * d + col] : 0.f;
            }
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const int q0 = 8 * ks + tig, q1 = q0 + 4;
            uint32_t ab[4], as[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split(mf[ks][i], ab[i], as[i]);
#pragma unroll
            for (int n = 0; n < NTD; ++n)
              mma3(c[n], ab, as,
                   split2(s_g[sidx(q0, 8 * n + gid, KD)],
                          s_g[sidx(q1, 8 * n + gid, KD)]));
          }
#pragma unroll
          for (int n = 0; n < NTD; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = i0 + 8 * (i >> 1);
              const int col = 8 * n + 2 * tig + (i & 1);
              if (row < d && col < d) dw[row * d + col] = old[n][i] + c[n][i];
            }
        }
      }
      __syncwarp();
    } else {
      for (int k = 0; k < 3; ++k) {
        if (!((done >> k) & 1u)) continue;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const float sv =
              sum_groups(fmaf(S[k][0], G[0][c], S[k][1] * G[1][c]) +
                         fmaf(S[k][2], G[2][c], S[k][3] * G[3][c]));
          const int col = 8 * (c >> 1) + 2 * tig + (c & 1);
          if (gid == 0 && col < d) wacc[off_w + k * d + col] += sv;
        }
      }
    }
  };
  for (int w = w_lo; w < w_hi; ++w) {
    if (v < 0 || w >= next_first) {
      // a new tail: the last one's end; its place, its cotangent rows G
      if (v >= 0) {
        close_tail();
        while (w >= next_first) next_first = __ldg(p.item_ptr + ++v + 1);
      } else {
        Item it0;
        item_of(p, w, it0);
        v = it0.v;
        next_first = __ldg(p.item_ptr + v + 1);
      }
      first = __ldg(p.item_ptr + v);
      tail_e0 = __ldg(p.tail_rowptr + v);
      tail_e1 = __ldg(p.tail_rowptr + v + 1);
      load_cotangent<CD>(t, b, d, v, qr, act_r, tig, G);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) S[k][r] = 0.f;
      done = 0;
    }
    Item it;
    it.v = v;
    it.e0 = tail_e0 + (w - first) * p.chunk;
    it.e1 = min(it.e0 + p.chunk, tail_e1);
    // the chunk: indices a lane, kept edges a lane (lane = query), edges
    // any lane keeps
    const int ne = it.e1 - it.e0;
    int rel_k = 0, te_k = 0;
    bool ok = lane < ne;
    if (ok) {
      rel_k = __ldg(t.trel + it.e0 + lane);
      te_k = __ldg(t.ttime + it.e0 + lane);
      if (t.excl) ok = t.excl[it.e0 + lane];
    }
    const Chunk ch = stage_chunk(p, it, q_lane, act_lane,
                                 __ballot_sync(kFull, ok), t.ekeep);
    const unsigned any = __reduce_or_sync(kFull, ch.mine);
    // the ring: edge jj's hs and relation rows into slot `slot`; its TT
    // rows into the TT slot
    auto fetch = [&](int jj, int slot) {
      const int src = __shfl_sync(kFull, ch.src, jj);
      const int rel = __shfl_sync(kFull, rel_k, jj);
      copy_block<KD>(s_w + slot * o.blk,
                     t.hidden + ((size_t)src * b + g * 32) * d, pc, nq, d,
                     t.vec_h);
      float* rr = s_w + o.rows + slot * o.rstride;
      for (int k = lane; k < A; k += 32)
        cp_async4(rr + k, t.ra + (size_t)rel * A + k);
      for (int k = lane; k < d; k += 32)
        cp_async4(rr + KA + k, t.rela + (size_t)rel * d + k);
    };
    auto fetch_tt = [&](int jj) {
      const int te = __shfl_sync(kFull, te_k, jj);
      copy_block<KD>(s_w + o.tt, t.tt + ((size_t)te * b + g * 32) * d, pc,
                     nq, d, t.vec_t);
    };
    unsigned todo = any;
    int j = todo ? __ffs(todo) - 1 : -1;
    if (j >= 0) {
      fetch(j, 0);
      if (use_time) fetch_tt(j);
    }
    cp_commit();
    // while the first edge's rows arrive: the rows of the edges no lane
    // keeps (zeros), the directions the kept pairs take, W[k] G of those
    // new to the tail
    for (int z = 0; z < ne; ++z) {
      if ((any >> z) & 1u) continue;
      const size_t e = (size_t)it.e0 + z;
      const size_t row0 = (e * b + g * 32) * d;
      zero_block(t.dhs + row0, nq * d, t.st16);
      if (use_time) zero_block(t.dmsg + row0, nq * d, t.st16);
      float* er = t.erow + ((size_t)g * t.n_edges + e) * we;
      for (int k = lane; k < we; k += 32) er[k] = 0.f;
    }
    unsigned dirs = 0, mine[4];
    for (int z = 0; z < ne; ++z) {
      const int te = __shfl_sync(kFull, te_k, z);
      if ((ch.mine >> z) & 1u) dirs |= 1u << dir_of(te, tq_lane);
    }
    dirs = __reduce_or_sync(kFull, dirs);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      mine[r] = __shfl_sync(kFull, ch.mine, gid + 8 * r);
    const unsigned fresh = dirs & ~done;
    done |= dirs;
    if (linear) {
      // W[k] G (queries x d by d x d: B[j][i] = W[k][i][j]) for each
      // direction the kept pairs take first in this tail, into wg; M_k
      // zeroed
#pragma unroll 1
      for (int k = 0; k < 3; ++k) {
        if (!((fresh >> k) & 1u)) continue;
        const float* W = t.wdir + (size_t)k * d * d;
        float c[2][NTD][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < NTD; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) c[mt][n][i] = 0.f;
#pragma unroll
        for (int kt = 0; kt < NTD; ++kt) {
          uint4 wb[NTD];
#pragma unroll
          for (int n = 0; n < NTD; ++n) {
            const int i = 8 * n + gid;
            const float2 wv =
                i < d ? ld2(W + (size_t)i * d, 8 * kt + 2 * tig, d, t.vec_w)
                      : make_float2(0.f, 0.f);
            wb[n] = split2(wv.x, wv.y);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t ab[4], as[4];
            a_frag(G, mt, kt, ab, as);
#pragma unroll
            for (int n = 0; n < NTD; ++n) mma3(c[mt][n], ab, as, wb[n]);
          }
        }
        float* wg = s_w + o.wg + k * o.blk;
        float* m = m_g + k * 32 * KD;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < NTD; ++n) {
            const int q0 = 16 * mt + gid, col = 8 * n + 2 * tig;
            *reinterpret_cast<float2*>(wg + sidx(q0, col, KD)) =
                make_float2(c[mt][n][0], c[mt][n][1]);
            *reinterpret_cast<float2*>(wg + sidx(q0 + 8, col, KD)) =
                make_float2(c[mt][n][2], c[mt][n][3]);
            *reinterpret_cast<float2*>(m + q0 * KD + col) =
                make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(m + (q0 + 8) * KD + col) =
                make_float2(0.f, 0.f);
          }
      }
    }
    // the walk of the item's kept edges, the next one's rows in flight
    int s = 0;
    while (j >= 0) {
      todo &= todo - 1;
      const int jn = todo ? __ffs(todo) - 1 : -1;
      if (jn >= 0) fetch(jn, s ^ 1);
      cp_commit();
      cp_wait<1>();
      __syncwarp();
      const size_t e = (size_t)it.e0 + j;
      const int te = __shfl_sync(kFull, te_k, j);
      float* hsb = s_w + s * o.blk;
      float* ttb = s_w + o.tt;
      const float* rr = s_w + o.rows + s * o.rstride;
      float* s_y = s_w + o.y;
      float* erow = t.erow + ((size_t)g * t.n_edges + e) * we;
      const size_t row0 = (e * b + g * 32) * d;
      bool kept[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) kept[r] = (mine[r] >> j) & 1u;
      // x: hs, then the message, then d_msg, then d_hs
      float x[4][CD];
      load_frag<KD, CD>(hsb, gid, tig, kept, x);
      // pre = hs A1s + RA[rel] + QA[q] an attention tile at a time
      // (queries 16 mt + gid (+8), attention columns 8 n + 2 tig + {0,
      // 1}): its logit terms, then the tile parked in y where its dpre
      // goes; then alpha and 1 - alpha
      float alpha[4] = {1.f, 1.f, 1.f, 1.f}, beta[4] = {0.f, 0.f, 0.f, 0.f};
      if (attn) {
        // hs split once a step, its registers free again after pre
        uint32_t xb[4][CD], xs[4][CD];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CD; ++c) split(x[r][c], xb[r][c], xs[r][c]);
        float lg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
        for (int n = 0; n < NTA; ++n) {
          float pre[2][4];
          const float2 rv =
              *reinterpret_cast<const float2*>(rr + 8 * n + 2 * tig);
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
              const uint32_t ab[4] = {xb[2 * mt][2 * kt],
                                      xb[2 * mt + 1][2 * kt],
                                      xb[2 * mt][2 * kt + 1],
                                      xb[2 * mt + 1][2 * kt + 1]};
              const uint32_t as[4] = {xs[2 * mt][2 * kt],
                                      xs[2 * mt + 1][2 * kt],
                                      xs[2 * mt][2 * kt + 1],
                                      xs[2 * mt + 1][2 * kt + 1]};
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
          sigmoid_pair(sum_quad(lg[r]), alpha[r], beta[r]);
        // hs back from its slot, for the message
        load_frag<KD, CD>(hsb, gid, tig, kept, x);
      }
      // the message msg = hs + hr + TT[t_e, q]
#pragma unroll
      for (int n = 0; n < NTD; ++n) {
        const float2 hr =
            *reinterpret_cast<const float2*>(rr + KA + 8 * n + 2 * tig);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          x[r][2 * n] += hr.x;
          x[r][2 * n + 1] += hr.y;
        }
      }
      if (use_time) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int n = 0; n < NTD; ++n) {
            const float2 tv = *reinterpret_cast<const float2*>(
                ttb + sidx(gid + 8 * r, 8 * n + 2 * tig, KD));
            x[r][2 * n] += tv.x;
            x[r][2 * n + 1] += tv.y;
          }
      }
      // G . out per query and d_msg into x: (linear) G . (msg W) = msg .
      // (W G), d_msg = alpha W G, from the item's W G of the pair's
      // direction, M of that direction += alpha msg (its rows loaded
      // first, all at once); (bias) G . (msg + B), d_msg = alpha G, S +=
      // alpha
      float dl[4];
      if (linear) {
        float2 mv[4][NTD];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* m =
              m_g + (dir_of(te, tq[r]) * 32 + gid + 8 * r) * KD + 2 * tig;
#pragma unroll
          for (int n = 0; n < NTD; ++n)
            mv[r][n] = kept[r] ? *reinterpret_cast<const float2*>(m + 8 * n)
                               : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int dir = dir_of(te, tq[r]);
          const int q = gid + 8 * r;
          const float* wg = s_w + o.wg + dir * o.blk;
          float* m = m_g + (dir * 32 + q) * KD + 2 * tig;
          float sg = 0.f;
#pragma unroll
          for (int n = 0; n < NTD; ++n) {
            const float2 wv = *reinterpret_cast<const float2*>(
                wg + sidx(q, 8 * n + 2 * tig, KD));
            sg = fmaf(x[r][2 * n], wv.x, sg);
            sg = fmaf(x[r][2 * n + 1], wv.y, sg);
            if (kept[r])
              *reinterpret_cast<float2*>(m + 8 * n) =
                  make_float2(fmaf(alpha[r], x[r][2 * n], mv[r][n].x),
                              fmaf(alpha[r], x[r][2 * n + 1], mv[r][n].y));
            x[r][2 * n] = kept[r] ? alpha[r] * wv.x : 0.f;
            x[r][2 * n + 1] = kept[r] ? alpha[r] * wv.y : 0.f;
          }
          const float da = sum_quad(sg);
          dl[r] = (attn && kept[r]) ? da * alpha[r] * beta[r] : 0.f;
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int dir = dir_of(te, tq[r]);
          const float* B = s_bd + dir * KD;
          float sg = 0.f;
#pragma unroll
          for (int n = 0; n < NTD; ++n) {
            const float2 bv =
                *reinterpret_cast<const float2*>(B + 8 * n + 2 * tig);
            sg = fmaf(G[r][2 * n], x[r][2 * n] + bv.x, sg);
            sg = fmaf(G[r][2 * n + 1], x[r][2 * n + 1] + bv.y, sg);
            x[r][2 * n] = kept[r] ? alpha[r] * G[r][2 * n] : 0.f;
            x[r][2 * n + 1] = kept[r] ? alpha[r] * G[r][2 * n + 1] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < 3; ++k)
            S[k][r] += (kept[r] && dir == k) ? alpha[r] : 0.f;
          const float da = sum_quad(sg);
          dl[r] = (attn && kept[r]) ? da * alpha[r] * beta[r] : 0.f;
        }
      }
      // the edge's sum of d_msg over the queries
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float sum =
            sum_groups((x[0][c] + x[1][c]) + (x[2][c] + x[3][c]));
        const int col = 8 * (c >> 1) + 2 * tig + (c & 1);
        if (gid == 0 && col < d) erow[col] = sum;
      }
      // d_msg's rows, staged in the TT slot (each lane over the elements
      // it read above) and stored; then the next edge's TT rows into it
      if (use_time) {
        stage_frag<KD, CD>(ttb, gid, tig, x);
        __syncwarp();
        store_block<KD>(t.dmsg + row0, ttb, pc, nq, d, t.st16);
        __syncwarp();
        if (jn >= 0) fetch_tt(jn);
      }
      cp_commit();
      // an attention tile at a time: dpre from the parked pre (d a2, d
      // QA), staged in its place for the contraction; the edge's sum of
      // dpre over the queries; d_hs += dpre A1s^T (queries x 8 by 8 x d),
      // on x
      if (attn) {
        float* s_da2 = s_w + o.da2;
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
              dp[mt][i] =
                  pv > 0.f ? dl[r] * ((i & 1) ? a2n.y : a2n.x) : 0.f;
            }
            *y0 = make_float2(dp[mt][0], dp[mt][1]);
            *y1 = make_float2(dp[mt][2], dp[mt][3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float sum = sum_groups((dp[0][h] + dp[0][2 + h]) +
                                         (dp[1][h] + dp[1][2 + h]));
            const int a = 8 * n + 2 * tig + h;
            if (gid == 0 && a < A) erow[d + a] = sum;
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // dpre as the A operand: k read 0, 2, 4, 6, 1, 3, 5, 7
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
        // d QA += dpre of the lane's queries and columns, from y
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int n = 0; n < NTA; ++n) {
            const float2 v = *reinterpret_cast<const float2*>(
                s_y + sidx(gid + 8 * r, 8 * n + 2 * tig, KA));
            dqa[r][2 * n] += v.x;
            dqa[r][2 * n + 1] += v.y;
          }
        // d A1s += hs^T dpre (d x 32 queries by 32 x A) from the staged
        // blocks: A fragment rows (hidden) 16 mt + gid (+8), contraction
        // (queries) 8 ks + tig (+4); B columns (attention) 8 n + gid
#pragma unroll 1
        for (int ks = 0; ks < 4; ++ks) {
          const int q0 = 8 * ks + tig, q1 = q0 + 4;
          uint4 yb[NTA];
#pragma unroll
          for (int n = 0; n < NTA; ++n)
            yb[n] = split2(s_y[sidx(q0, 8 * n + gid, KA)],
                           s_y[sidx(q1, 8 * n + gid, KA)]);
#pragma unroll
          for (int mt = 0; mt < MTD; ++mt) {
            const int i0 = 16 * mt + gid;
            const bool pad = kHalf && mt == MTD - 1;
            uint32_t ab[4], as[4];
            split(hsb[sidx(q0, i0, KD)], ab[0], as[0]);
            split(pad ? 0.f : hsb[sidx(q0, i0 + 8, KD)], ab[1], as[1]);
            split(hsb[sidx(q1, i0, KD)], ab[2], as[2]);
            split(pad ? 0.f : hsb[sidx(q1, i0 + 8, KD)], ab[3], as[3]);
#pragma unroll
            for (int n = 0; n < NTA; ++n) mma3(acc1[mt][n], ab, as, yb[n]);
          }
        }
        __syncwarp();
      }
      // d_hs's rows, staged in the step's hs slot (read) and stored
      stage_frag<KD, CD>(hsb, gid, tig, x);
      __syncwarp();
      store_block<KD>(t.dhs + row0, hsb, pc, nq, d, t.st16);
      __syncwarp();
      s ^= 1;
      j = jn;
    }
  }
  if (v >= 0) close_tail();
  // the warp's other parameter sums, in order, to its scratch
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
  if (attn) {  // (the lanes' shares of d a2 exist with attention only)
#pragma unroll
    for (int c = 0; c < CA; ++c) {
      const float sum = sum_groups(s_w[o.da2 + c * 32 + lane]);
      const int a = 8 * (c >> 1) + 2 * tig + (c & 1);
      if (gid == 0 && a < A) wacc[off_a2 + a] = sum;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CA; ++c) {
      const int a = 8 * (c >> 1) + 2 * tig + (c & 1);
      if (a < A) wacc[off_qa + a * 32 + gid + 8 * r] = dqa[r][c];
    }
  __syncthreads();
  // the block's sums, its warps in order
  const int n_acc = off_qa + 32 * A;
  float* part = t.partial + ((size_t)g * gridDim.x + blockIdx.x) * n_acc;
  const float* block_acc =
      t.scratch +
      ((size_t)g * gridDim.x + blockIdx.x) * t.warps * t.glob_floats;
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
    float sum = 0.f;
    for (int v = 0; v < t.warps; ++v) sum += block_acc[v * t.glob_floats + k];
    part[k] = sum;
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

// ------------------------------------------------------------ the scalar walk

// The scalar walk, for the widths above kTcMaxWidth (48 and 64): a warp
// takes an item for 32
// queries, lane = query, and walks the chunk's edges together, one edge a
// step (lanes that do not keep it add zeros), so that each edge's sums
// over the queries are sums over the warp. A step stages each lane's hs,
// relu(pre), dlogit and d_msg in the warp's shared memory; then each lane
// owns columns (attention column a, hidden column j) and sums its columns
// over the 32 lanes in lane order. M, W G, d W (per item) and d QA sit in
// a global scratch of the warp's own (L1-cached); d A1 and d a2 in its
// shared memory. Up to kScalarWarps warps a block, at most kScalarBlocks
// persistent blocks a query group, the relation tables staged where they
// fit: the choice that keeps the most warps a multiprocessor in its shared
// memory, a function of the shapes.
constexpr int kScalarWarps = 4;
constexpr int kScalarBlocks = 264;

// floats of the weights staged once a block: the transforms (linear:
// [3][DP^2 + 4], bias: [3][DP]), A1 [A][DP], QA [A][32], a2 [A]
__host__ __device__ inline int base_floats(int dp, int f, int A) {
  const int w = (f & kLinear) ? 3 * (dp * dp + 4) : 3 * dp;
  return round4(w + ((f & kAttn) ? A * (dp + 33) : 0));
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
__global__ void __launch_bounds__(kScalarWarps * 32)
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
      load_row<DP>(t.g + vrow * d, d, t.vec_g4, G);
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
// ------------------------------------------------------------------ plans

// A launch's plan, a function of the shapes and (the tensor-core walk)
// the compiled kernel on this card: the warps a block, its shared bytes,
// the persistent blocks a query group, the warps a multiprocessor the
// plan counts on, whether the relation tables are staged (the scalar
// walk) and the units an item is cut into (1); the floats of the buffers
// the walk writes (out: the parameters' sums; partial: the blocks';
// scratch: the warps' global scratch); and `chain`, the most float32
// additions a term of a parameter sum passes through in the walk's order.
// warps == 0: no block fits.
struct Plan {
  int warps, blocks_x, groups, n_acc, pc, per_sm, split;
  bool tables;
  size_t smem, warp_floats, glob_floats;
  long long out_floats, partial_floats, scratch_floats, chain;
};


// The scalar walk's plan, a function of the shapes alone (its chain:
// within a step at most 32 (d a2's chain over the lanes; dot32's 10 after
// at most `chunk` of M's or S's running sum), a warp's running sum over
// its steps, the block's warps, then sum_partials' blocks).
inline Plan scalar_plan(int d, int f, int A, int R, int b, long long items,
                        int chunk) {
  Plan pl = {};
  const int dp = padded_width(d);
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
    for (int w = kScalarWarps; w >= 1; --w) {
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
  pl.per_sm = best;
  pl.split = 1;
  const long long want = (items + pl.warps - 1) / pl.warps;
  pl.blocks_x = (int)(want < kScalarBlocks ? want : kScalarBlocks);
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

template <int DP>
int scalar_launch(const Walk& p, Bwd t, const Plan& pl, cudaStream_t stream) {
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

// An instance's blocks a multiprocessor at (threads, shared bytes) on
// device dev (its shared memory limit raised first), asked of the
// occupancy calculator once and kept, keyed by the kernel's address (a
// memo of a function-local static is one object a process, even across
// two libraries built from one header); 0 where the runtime failed (not
// kept).
inline int blocks_per_sm(const void* fn, int dev, int threads, size_t smem) {
  struct Entry {
    const void* fn;
    int dev, threads;
    size_t smem;
    int nb;
  };
  static std::mutex mu;
  static std::vector<Entry> memo;
  const std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : memo)
    if (e.fn == fn && e.dev == dev && e.threads == threads && e.smem == smem)
      return e.nb;
  int nb = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemPerBlock) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fn, threads, smem) !=
          cudaSuccess)
    return 0;
  memo.push_back({fn, dev, threads, smem, nb});
  return nb;
}

// The tensor-core walk's plan: the warps a block (up to kMaxWarps) that
// keep the most warps on a multiprocessor (ties: the larger block), the
// blocks a query group as many as the card then holds at once. Its chain:
// d A1s takes 3 x 32 additions a step (an mma's k-step counts as k
// additions for each of its three products; the 32 queries), every later
// step of the warp's (at most `chunk` of each of its items) adds as many;
// d W[k] takes M_k's running sum (at most the edges of the warp's items of
// one tail), the tail's product (3 x 32) and the warp's running sum over
// its tails; d a2, d QA and d B fewer; then the tree over the lanes'
// column groups (3), the block's warps and sum_partials' blocks of every
// query group.
template <int KD, int KA>
Plan tc_plan(int d, int f, int A, int b, long long items, int chunk) {
  Plan pl = {};
  pl.n_acc = acc_floats(d, f, A);
  const Offsets o = offsets(KD, KA, f);
  const size_t base = sizeof(float) * o.base;
  const size_t per_warp = sizeof(float) * o.warp;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return pl;
  const int sms = sm_count(dev);
  if (sms == 0) return pl;
  const void* fn = reinterpret_cast<const void*>(tc_bwd<KD, KA>);
  int best = 0, blocks_sm = 0;
  for (int w = kMaxWarps; w >= 1; --w) {
    const size_t s = base + w * per_warp;
    if (s > kSmemPerBlock) continue;
    const int nb = blocks_per_sm(fn, dev, w * 32, s);
    if (nb * w > best) {
      best = nb * w;
      blocks_sm = nb;
      pl.warps = w;
      pl.smem = s;
    }
  }
  if (best == 0) return pl;
  pl.per_sm = best;
  pl.split = 1;
  pl.groups = (b + 31) / 32;
  const long long want = (items + pl.warps - 1) / pl.warps;
  long long fill = (long long)sms * blocks_sm / pl.groups;
  if (fill < 1) fill = 1;
  pl.blocks_x = (int)(want < fill ? want : fill);
  pl.pc = pl.n_acc - 32 * A;
  pl.out_floats = pl.pc + (long long)b * A;
  pl.glob_floats = round4(pl.n_acc) + ((f & kLinear) ? 3 * 32 * KD : 0);
  const long long blocks = (long long)pl.groups * pl.blocks_x;
  pl.partial_floats = blocks * pl.n_acc;
  pl.scratch_floats = blocks * pl.warps * (long long)pl.glob_floats;
  const long long warps = (long long)pl.blocks_x * pl.warps;
  const long long items_warp = (items + warps - 1) / warps;
  const long long a1 = (f & kAttn) ? 96 * items_warp * chunk : 0;
  const long long w = items_warp * chunk + 96 + items_warp;
  pl.chain = (a1 > w ? a1 : w) + 3 + pl.warps + blocks;
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

// The walk and the sum of its blocks' partials, as the plan says.
template <int KD, int KA>
int tc_launch(const Walk& p, Bwd t, const Plan& pl, cudaStream_t stream) {
  t.warps = pl.warps;
  t.glob_floats = pl.glob_floats;
  const cudaError_t err = cudaFuncSetAttribute(
      tc_bwd<KD, KA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  tc_bwd<KD, KA>
      <<<dim3(pl.blocks_x, pl.groups), pl.warps * 32, pl.smem, stream>>>(p,
                                                                       t);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials<<<(int)((pl.out_floats + 255) / 256), 256, 0, stream>>>(
      t.partial, t.out, pl.groups, pl.blocks_x, pl.n_acc, pl.pc, t.A, p.b);
  return (int)cudaGetLastError();
}

// fn(Int<KD>, Int<KA>) for the tensor-core instance of the hidden width d
// (8, 16, 24, 32, 48, 64) and the attention width A (0 and up to 8: 8; up
// to 32; up to 64)
template <typename F>
int by_instance(int d, int A, F&& fn) {
  const int ka = A <= 8 ? 8 : A <= 32 ? 32 : 64;
#define TEMPORAL_BWD_KD(KD)                                       \
  case KD:                                                        \
    return ka == 8    ? fn(Int<KD>{}, Int<8>{})                   \
           : ka == 32 ? fn(Int<KD>{}, Int<32>{})                  \
                      : fn(Int<KD>{}, Int<64>{});
  switch (padded_width(d)) {
    TEMPORAL_BWD_KD(8)
    TEMPORAL_BWD_KD(16)
    TEMPORAL_BWD_KD(24)
    TEMPORAL_BWD_KD(32)
    TEMPORAL_BWD_KD(48)
    TEMPORAL_BWD_KD(64)
  }
#undef TEMPORAL_BWD_KD
  return (int)cudaErrorInvalidValue;
}

// The walk for these shapes (the tensor-core walk up to kTcMaxWidth, the
// scalar walk above it): plan, then launch.
inline int run(const Walk& p, const Bwd& t, long long items, cudaStream_t s) {
  return by_instance(p.d, t.A, [&](auto kd, auto ka) {
    constexpr int KD = decltype(kd)::value, KA = decltype(ka)::value;
    if constexpr (KD <= kTcMaxWidth) {
      const Plan pl = tc_plan<KD, KA>(p.d, t.flags, t.A, p.b, items, p.chunk);
      if (pl.warps == 0) return (int)cudaErrorInvalidValue;
      return tc_launch<KD, KA>(p, t, pl, s);
    } else {
      const Plan pl = scalar_plan(p.d, t.flags, t.A, t.R, p.b, items, p.chunk);
      if (pl.warps == 0) return (int)cudaErrorInvalidValue;
      return scalar_launch<KD>(p, t, pl, s);
    }
  });
}

// The plan for these shapes into out (write_plan).
inline int plan_of(int d, int f, int A, int R, int b, long long items,
                   int chunk, long long* out) {
  return by_instance(d, A, [&](auto kd, auto ka) {
    constexpr int KD = decltype(kd)::value, KA = decltype(ka)::value;
    if constexpr (KD <= kTcMaxWidth)
      return write_plan(tc_plan<KD, KA>(d, f, A, b, items, chunk), out);
    else
      return write_plan(scalar_plan(d, f, A, R, b, items, chunk), out);
  });
}

}  // namespace dense_hop_bwd
