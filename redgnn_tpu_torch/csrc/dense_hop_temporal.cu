// The temporal dense hop's forward, one kernel, on Hopper (sm_90a).
//
// Replaces: TRedGNN._dense_hop of redgnn_tpu/models/temporal.py:461-572, an
// XLA composition and not a Pallas kernel. In the port's eager route each
// (E, b, d) intermediate (gathered state, message, three direction
// transforms, attention, masked message) is a tensor in device memory
// (391 MB apiece at ICEWS14 size); here none is. For each tail v and query
// q (the walk: dense_hop.cuh) it computes
//     msg     = hs + hr + TT[t_e, q]                       (TIME)
//     out     = msg @ W[dir]   (LINEAR)  or  msg + B[dir]
//     alpha   = sigmoid(relu(hs A1_s + RA[rel] + QA[q]) . a2)   (ATTN)
//     agg     = sum over kept edges e of tail v of out * alpha
//     h[v, q] = act(dropout(agg)) where any edge is kept, else 0
// with hs = hidden[tsrc[e], q], hr = rela[trel[e]], dir past / now /
// future by the sign of ttime[e] - times[q], and an edge kept where
// visited[tsrc[e], q] and the optional (E,) leave-one-out keep and (E, b)
// edge-dropout keep masks say so. The terms that depend on fewer operands
// than (edge, query) come from the wrapper (ops/dense_hop.py:
// temporal_terms): RA = rela A1_r per relation, QA = h_qr A1_q per query,
// and TT, the time term per (time id, query): relu([cos z ‖ sin z] W_t +
// t_b) at z = 2π f (t − t_q) through the trig factoring, or the absolute
// table's row. That moves the (E, b) x 2K x d product of the time
// embedding (65% of the hop's arithmetic at ICEWS14 size) to n_time x b
// rows. TIME, ATTN and LINEAR are the model's ablation switches
// (use_time, use_attention, direction_transform): compile-time flags at
// widths up to 32, run-time ones above (`kRuntime`).
//
// What bounds it: at ICEWS14 size (E = 152,780, N = 7,128, b = 32, d = 20,
// A = 30) the work left per kept (edge, query) is d * A + d * d + A FMAs
// (~1,030): ~10 GFLOP at a saturated hop, 0.15 ms at the card's
// 67 TFLOP/s fp32 peak; the bytes it must move (state, indices, result)
// are ~40 MB, 12 µs. A lane's step reads its FMAs' weights as broadcast
// float4s of shared memory, one per 4 FMAs (250 a step at d = 20), and
// the warps' steps are long chains of dependent FMAs: at ICEWS14's three
// served dense calls (25%, 84% and 100% of the pairs kept) the kernel
// reaches 7.4%, 20.4% and 24.8% of that per-pair fp32 bound (5.0%, 13.4%
// and 16.2% of the bound that counts the transform once per tail, query
// and direction), held by those loads and chains, not by bytes
// (chip_smoke.py phase 7i, H100 80GB HBM3 at 700 W).
//
// Design (PR 14): the walk of dense_hop.cuh (the chunk's indices, time
// ids and masks loaded before any row; each lane walks its own kept
// edges, so a sparse hop costs its kept pairs and not every edge some
// lane keeps), chunks of 16 edges (shorter hub chains than 32), 4 warps
// a block; RA and the relation table staged in shared
// memory; a step's state and time-term rows loaded together before the
// attention. A1_s sits in shared memory column by column ([A][d]: A
// columns), the three d x d transforms (each padded by 4 floats, so
// lanes of different directions read other banks) and a2 beside it, QA
// lane-major. A lane keeps hs, the time term, the message and the sum in
// registers, the width padded to 8, 16, 20, 24, 32, 48 or 64 (the
// transform is taken four output columns at a time, so no third DP-wide
// array is live).
//
// The transform stays per (edge, query). Summing each direction's
// messages first and transforming the three sums once a tail is the same
// function (the transform is linear and precedes the sum), but its
// float32 rounding is not that of the float64 check the kernel is held
// to: the check's sum|x| term counts the per-edge transformed terms, and
// a transform's cancellation is covered only where the plain version
// rounds it as the kernel does. Measured (PR 14, NVIDIA H100 80GB HBM3,
// tests/test_torch_cuda.py): with the direction sums, 7 of 18 temporal
// cases ended up to 4.7e-7 past that bound.

#include "dense_hop.cuh"

namespace {

using namespace dense_hop;

enum Act { kRelu = 0, kTanh, kSigmoid, kIdd, kSoftplus, kLeakyRelu };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu: return fmaxf(x, 0.f);
    case kTanh: return tanhf(x);
    case kSigmoid: return sigmoid(x);
    case kSoftplus: return x > 20.f ? x : log1pf(expf(x));
    case kLeakyRelu: return x > 0.f ? x : x * 0.01f;
    default: return x;
  }
}

struct Temporal {
  const float* hidden;          // (n_tail, b, d)
  const float* rela;            // (R, d)
  const int* trel;              // (E,)
  const int* ttime;             // (E,)
  const int* times;             // (b,)
  const unsigned char* excl;    // (E,) or null
  const unsigned char* ekeep;   // (E, b) or null
  const float* tt;              // (n_time, b, d) or null
  const float* ra;              // (R, A)
  const float* qa;              // (b, A)
  const float* a1s;             // (d, A)
  const float* a2;              // (A,)
  const float* wdir;            // (3, d, d) past, now, future, or null
  const float* bdir;            // (3, d) or null
  const unsigned char* drop;    // (n_tail, b, d) or null
  float drop_div;               // 1 - dropout rate
  float* out;                   // (n_tail, b, d)
  unsigned char* new_visited;   // (n_tail, b)
  int act, A, R;
  int flags;                    // kTime | kAttn | kLinear
  bool vec_h, vec_t, vec_r;
  bool tables;                  // RA and rela staged in shared memory
};

// The ablation switches: use_time, use_attention, direction_transform
// "linear". A kernel instance takes them as the compile-time FLAGS, or
// (kRuntime: the widths above 32, where one instance of each width keeps
// nvcc's time down) reads them from Temporal::flags, warp-uniform
// branches.
constexpr int kLinear = 1, kAttn = 2, kTime = 4, kRuntime = -1;

// The block's shared memory: the transforms (or biases), A1_s [A][DP], QA
// [A][32] and a2 [A], rounded up to a float4; then, where they fit, RA
// [R][A] (with attention) and the relation rows [R][d].
__host__ __device__ inline size_t weight_floats(int dp, bool linear,
                                                bool attn, int A) {
  return ((linear ? 3 * (dp * dp + 4) : 3 * dp) +
          (attn ? (size_t)A * (dp + 33) : 0) + 3) / 4 * 4;
}

__host__ __device__ inline size_t table_floats(int R, int A, int d,
                                               bool attn) {
  return (attn ? ((size_t)R * A + 3) / 4 * 4 : 0) + (size_t)R * d;
}

// No cap below 255 registers a thread: a spill costs more than the warps
// a cap would add (128 registers spilled at d = 24 and 32).
template <int DP, int FLAGS>
__global__ void __launch_bounds__(kThreads)
temporal_hop(Walk p, Temporal t) {
  extern __shared__ __align__(16) float sm[];
  constexpr int kMat = DP * DP + 4;  // one transform, padded
  const int f = FLAGS == kRuntime ? t.flags : FLAGS;
  const bool use_time = f & kTime, attn = f & kAttn, linear = f & kLinear;
  const int A = t.A;
  float* s_w = sm;                                   // [3][kMat] or [3][DP]
  float* s_a1 = s_w + (linear ? 3 * kMat : 3 * DP);  // [A][DP]
  float* s_qa = s_a1 + A * DP;                       // [A][32]
  float* s_a2 = s_qa + A * 32;                       // [A]
  const int g = blockIdx.y;
  if (attn) {
    stage_proj(s_a1, t.a1s, A, 1, DP, p.d, A);
    stage_query(s_qa, t.qa, p.b, A, g);
    stage_vec(s_a2, t.a2, A);
  }
  if (linear) {
#pragma unroll 4
    for (int k = threadIdx.x; k < 3 * kMat; k += blockDim.x) {
      const int m = k / kMat, r = k - m * kMat, i = r / DP, j = r - i * DP;
      s_w[k] = (i < p.d && j < p.d)
                   ? t.wdir[((size_t)m * p.d + i) * p.d + j] : 0.f;
    }
  } else {
    for (int k = threadIdx.x; k < 3 * DP; k += blockDim.x) {
      const int m = k / DP, j = k - m * DP;
      s_w[k] = j < p.d ? t.bdir[m * p.d + j] : 0.f;
    }
  }
  const float* t_ra = t.ra;  // the relation tables: shared or global
  const float* t_rela = t.rela;
  if (t.tables) {
    float* s_tab = sm + weight_floats(DP, linear, attn, A);
    if (attn) {
      stage_table(s_tab, t.ra, t.R * A);
      t_ra = s_tab;
      s_tab += ((size_t)t.R * A + 3) / 4 * 4;
    }
    stage_table(s_tab, t.rela, t.R * p.d);
    t_rela = s_tab;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int q = g * 32 + lane;
  const bool active = q < p.b;
  const int tq = active ? __ldg(t.times + q) : 0;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  Item it;
  if (!item_of(p, w, it)) return;
  // lane k: edge e0 + k's relation and time id, and whether the
  // leave-one-out mask keeps it
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
  int kept = __popc(c.mine);
  const int steps = __reduce_max_sync(kFull, kept);
  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int j = next_edge(c.mine);
    const int src = __shfl_sync(kFull, c.src, j & 31);
    const int rel = __shfl_sync(kFull, rel_k, j & 31);
    const int te = __shfl_sync(kFull, te_k, j & 31);
    if (j < 0) continue;
    // both rows' loads at once, before the attention
    float x[DP], tr[DP];  // hs, then the message; the time term
    load_row<DP>(t.hidden + ((size_t)src * p.b + q) * p.d, p.d, t.vec_h,
                 x);
    if (use_time)
      load_row<DP>(t.tt + ((size_t)te * p.b + q) * p.d, p.d, t.vec_t, tr);
    float alpha = 1.f;
    if (attn)
      alpha = sigmoid(attn_logit<DP>(x, s_a1, t_ra + (size_t)rel * A, s_qa,
                                     s_a2, A, lane, 0.f));
    add_table_row<DP>(t_rela + (size_t)rel * p.d, p.d, t.vec_r, x);
    if (use_time) {
#pragma unroll
      for (int i = 0; i < DP; ++i) x[i] += tr[i];
    }
    const int dir = te < tq ? 0 : (te == tq ? 1 : 2);
    if (linear) {
      // y[j] = sum_i x[i] W[dir][i][j] in order of i, four columns at a
      // time, scaled and added to the sum
      const float* W = s_w + dir * kMat;
#pragma unroll
      for (int jc = 0; jc < DP; jc += 4) {
        float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          const float4 wv =
              *reinterpret_cast<const float4*>(W + i * DP + jc);
          y0 = fmaf(x[i], wv.x, y0);
          y1 = fmaf(x[i], wv.y, y1);
          y2 = fmaf(x[i], wv.z, y2);
          y3 = fmaf(x[i], wv.w, y3);
        }
        acc[jc] += attn ? y0 * alpha : y0;
        acc[jc + 1] += attn ? y1 * alpha : y1;
        acc[jc + 2] += attn ? y2 * alpha : y2;
        acc[jc + 3] += attn ? y3 * alpha : y3;
      }
    } else {
#pragma unroll
      for (int jc = 0; jc < DP; ++jc) {
        const float y = x[jc] + s_w[dir * DP + jc];
        acc[jc] += attn ? y * alpha : y;
      }
    }
  }
  if (!close_item<DP>(p, it, w, q, active, acc, kept) || !active) return;
  const size_t row = (size_t)it.v * p.b + q;
  float* out = t.out + row * p.d;
  const unsigned char* drop = t.drop ? t.drop + row * p.d : nullptr;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    if (i < p.d) {
      float v = acc[i];
      if (drop) v = drop[i] ? v / t.drop_div : 0.f;
      out[i] = kept > 0 ? activate(v, t.act) : 0.f;
    }
  }
  t.new_visited[row] = kept > 0;
}

template <int DP, int FLAGS>
int launch(const Walk& p, Temporal t, long long items, cudaStream_t stream) {
  const int f = FLAGS == kRuntime ? t.flags : FLAGS;
  const size_t base =
      sizeof(float) * weight_floats(DP, f & kLinear, f & kAttn, t.A);
  const size_t tab = sizeof(float) * table_floats(t.R, t.A, p.d, f & kAttn);
  t.tables = tab <= kTableBytes;
  const size_t smem = base + (t.tables ? tab : 0);
  if (smem > 48 * 1024) {  // the tables; the widest transforms (74 KB)
    const cudaError_t err = cudaFuncSetAttribute(
        temporal_hop<DP, FLAGS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((items + kWarps - 1) / kWarps),
                  (unsigned)((p.b + 31) / 32));
  temporal_hop<DP, FLAGS><<<grid, kThreads, smem, stream>>>(p, t);
  return (int)cudaGetLastError();
}

template <int DP>
int by_flags(const Walk& p, const Temporal& t, long long items,
             cudaStream_t s) {
  switch (t.flags) {
    case 0: return launch<DP, 0>(p, t, items, s);
    case 1: return launch<DP, 1>(p, t, items, s);
    case 2: return launch<DP, 2>(p, t, items, s);
    case 3: return launch<DP, 3>(p, t, items, s);
    case 4: return launch<DP, 4>(p, t, items, s);
    case 5: return launch<DP, 5>(p, t, items, s);
    case 6: return launch<DP, 6>(p, t, items, s);
    default: return launch<DP, 7>(p, t, items, s);
  }
}

}  // namespace

// hidden (n_tail, b, d) float32; visited (n_tail, b) bool; rela (R, d);
// tsrc, trel, ttime (E,) int32; tail_rowptr, item_ptr (n_tail + 1,) int32;
// times (b,) int32; excl (E,) and ekeep (E, b) bool or null; tt (n_time, b,
// d) (null without use_time); ra (R, A), qa (b, A), a1s (d, A), a2 (A,)
// (read only with use_attn); wdir (3, d, d) with linear, else bdir (3, d),
// past / now / future; drop (n_tail, b, d) bool or null, drop_div the
// kept scale's divisor; act 0-5 (relu, tanh, sigmoid, idd, softplus,
// leakyrelu). Writes out (n_tail, b, d) float32 and new_visited (n_tail,
// b) bool; partial, partial_kept and arrive_counts as dense_hop_static's;
// n_rel is R. d <= 64. Returns a cudaError_t.
extern "C" int dense_hop_temporal(
    const void* hidden, const void* visited, const void* rela,
    const void* tsrc, const void* trel, const void* ttime,
    const void* tail_rowptr, const void* item_ptr, const void* times,
    const void* excl, const void* ekeep, const void* tt, const void* ra,
    const void* qa, const void* a1s, const void* a2, const void* wdir,
    const void* bdir, const void* drop, float drop_div, int act, void* out,
    void* new_visited, void* partial, void* partial_kept, void* arrive_counts,
    long long n_tail, long long b, long long d, long long a, long long chunk,
    long long items, long long n_rel, int use_time, int use_attn, int linear,
    void* stream) {
  const int dp = dense_hop::padded_width(d);
  if (n_tail <= 0 || b <= 0 || d <= 0 || dp == 0 || a < 0 ||
      n_rel <= 0 || n_rel > 0x7fffffffLL / 64 ||
      a > 64 || (use_attn && a == 0) || chunk <= 0 ||
      chunk > dense_hop::kMaxChunk || items < n_tail ||
      items > 0x7fffffffLL || (b + 31) / 32 > 65535 ||
      n_tail * b > 0x7fffffffLL || act < 0 || act > 5 ||
      (use_time && !tt) || (linear ? !wdir : !bdir)) {
    return (int)cudaErrorInvalidValue;
  }
  dense_hop::Walk p;
  p.tsrc = (const int*)tsrc;
  p.tail_rowptr = (const int*)tail_rowptr;
  p.item_ptr = (const int*)item_ptr;
  p.visited = (const unsigned char*)visited;
  p.partial = (float*)partial;
  p.partial_kept = (int*)partial_kept;
  p.counts = (int*)arrive_counts;
  p.arrive = (int*)arrive_counts + 2;
  p.n_tail = (int)n_tail;
  p.b = (int)b;
  p.d = (int)d;
  p.chunk = (int)chunk;
  Temporal t;
  t.hidden = (const float*)hidden;
  t.rela = (const float*)rela;
  t.trel = (const int*)trel;
  t.ttime = (const int*)ttime;
  t.times = (const int*)times;
  t.excl = (const unsigned char*)excl;
  t.ekeep = (const unsigned char*)ekeep;
  t.tt = (const float*)tt;
  t.ra = (const float*)ra;
  t.qa = (const float*)qa;
  t.a1s = (const float*)a1s;
  t.a2 = (const float*)a2;
  t.wdir = (const float*)wdir;
  t.bdir = (const float*)bdir;
  t.drop = (const unsigned char*)drop;
  t.drop_div = drop_div;
  t.out = (float*)out;
  t.new_visited = (unsigned char*)new_visited;
  t.act = act;
  t.A = (int)a;
  t.R = (int)n_rel;
  t.vec_h = d % 4 == 0 && (uintptr_t)hidden % 16 == 0;
  t.vec_t = d % 4 == 0 && (uintptr_t)tt % 16 == 0;
  t.vec_r = d % 4 == 0 && (uintptr_t)rela % 16 == 0;
  t.flags = (use_time ? kTime : 0) | (use_attn ? kAttn : 0) |
            (linear ? kLinear : 0);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dp) {
    case 8: return by_flags<8>(p, t, items, s);
    case 16: return by_flags<16>(p, t, items, s);
    case 24:  // the registry's width 20 gets its own instances
      return d <= 20 ? by_flags<20>(p, t, items, s)
                     : by_flags<24>(p, t, items, s);
    case 32: return by_flags<32>(p, t, items, s);
    case 48: return launch<48, kRuntime>(p, t, items, s);
    default: return launch<64, kRuntime>(p, t, items, s);
  }
}
