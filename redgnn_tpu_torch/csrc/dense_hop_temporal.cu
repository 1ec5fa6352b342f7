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
// A = 30) the work left per (edge, query) is d * A + d * d + A FMAs
// (~1,030): 10 GFLOP a hop, 0.15 ms at the card's 67 TFLOP/s fp32 peak;
// the bytes it must move (state, indices, result) are ~39 MB, 12 µs. So
// fp32 FMA throughput bounds it: the design keeps every operand of an FMA
// in a register or a broadcast shared-memory float4.
//
// Design: lane = query; the edge's indices, its relation row and its RA
// row are the same for the warp (broadcast loads); A1_s [d][A], the three
// d x d transforms (each padded by 4 floats, so lanes of different
// directions read other banks) and a2 sit in shared memory, QA lane-major.
// A lane reads its own hs and TT rows (16-byte loads where d % 4 == 0)
// and keeps them, the message and the sum in registers, the width padded
// to 8, 16, 20, 24, 32, 48 or 64 (the transform is taken four output
// columns at a time, so no third DP-wide array is live). Edges whose
// source no lane has visited are skipped as a warp.

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
  int act, A, Ap;
  int flags;                    // kTime | kAttn | kLinear
  bool vec_h, vec_t;
};

// The ablation switches: use_time, use_attention, direction_transform
// "linear". A kernel instance takes them as the compile-time FLAGS, or
// (kRuntime: the widths above 32, where one instance of each width keeps
// nvcc's time down) reads them from Temporal::flags, warp-uniform
// branches.
constexpr int kLinear = 1, kAttn = 2, kTime = 4, kRuntime = -1;

template <int DP, int FLAGS>
__global__ void __launch_bounds__(kThreads)
temporal_hop(Walk p, Temporal t) {
  extern __shared__ __align__(16) float sm[];
  constexpr int kMat = DP * DP + 4;  // one transform, padded
  const int f = FLAGS == kRuntime ? t.flags : FLAGS;
  const bool use_time = f & kTime, attn = f & kAttn, linear = f & kLinear;
  const int Ap = t.Ap;
  float* s_a1 = sm;                  // [DP][Ap]
  float* s_qa = s_a1 + DP * Ap;      // [Ap][32]
  float* s_a2 = s_qa + Ap * 32;      // [Ap]
  float* s_w = s_a2 + Ap;            // [3][kMat] or [3][DP]
  const int g = blockIdx.y;
  if (attn) {
    stage_proj(s_a1, t.a1s, t.A, 1, DP, p.d, t.A, Ap);
    stage_query(s_qa, t.qa, p.b, t.A, Ap, g);
    stage_vec(s_a2, t.a2, t.A, Ap);
  }
  if (linear) {
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
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  Item it;
  if (!item_of(p, w, it)) return;
  const int q = g * 32 + lane;
  const bool active = q < p.b;
  const int tq = active ? __ldg(t.times + q) : 0;
  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = 0.f;
  int kept = 0;
  for (int e = it.e0; e < it.e1; ++e) {
    const int src = __ldg(p.tsrc + e);
    bool keep = active && p.visited[(size_t)src * p.b + q];
    if (t.excl) keep = keep && t.excl[e];
    if (t.ekeep) keep = keep && t.ekeep[(size_t)e * p.b + q];
    if (!__any_sync(kFull, keep)) continue;
    if (!keep) continue;
    float x[DP];  // hs, then the message
    load_row<DP>(t.hidden + ((size_t)src * p.b + q) * p.d, p.d, t.vec_h, x);
    const int rel = __ldg(t.trel + e);
    const int te = __ldg(t.ttime + e);
    float alpha = 1.f;
    if (attn)
      alpha = sigmoid(attn_logit<DP>(x, s_a1, t.ra + (size_t)rel * t.A, s_qa,
                                     s_a2, t.A, Ap, lane, 0.f));
    const float* hr = t.rela + (size_t)rel * p.d;
#pragma unroll
    for (int i = 0; i < DP; ++i)
      if (i < p.d) x[i] += __ldg(hr + i);
    if (use_time)
      add_row<DP>(t.tt + ((size_t)te * p.b + q) * p.d, p.d, t.vec_t, x);
    const int dir = te < tq ? 0 : (te == tq ? 1 : 2);
    if (linear) {
      // y[j] = sum_i x[i] W[i][j] in order of i, four columns at a time
      const float* W = s_w + dir * kMat;
#pragma unroll
      for (int j = 0; j < DP; j += 4) {
        float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          const float4 wv = *reinterpret_cast<const float4*>(W + i * DP + j);
          y0 = fmaf(x[i], wv.x, y0);
          y1 = fmaf(x[i], wv.y, y1);
          y2 = fmaf(x[i], wv.z, y2);
          y3 = fmaf(x[i], wv.w, y3);
        }
        acc[j] += attn ? y0 * alpha : y0;
        acc[j + 1] += attn ? y1 * alpha : y1;
        acc[j + 2] += attn ? y2 * alpha : y2;
        acc[j + 3] += attn ? y3 * alpha : y3;
      }
    } else {
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        const float y = x[j] + s_w[dir * DP + j];
        acc[j] += attn ? y * alpha : y;
      }
    }
    ++kept;
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
int launch(const Walk& p, const Temporal& t, long long items,
           cudaStream_t stream) {
  const bool linear = (FLAGS == kRuntime ? t.flags : FLAGS) & kLinear;
  const size_t mats = linear ? 3 * (DP * DP + 4) : 3 * DP;
  const size_t smem =
      sizeof(float) * ((size_t)DP * t.Ap + t.Ap * 32 + t.Ap + mats);
  const dim3 grid((unsigned)((items + kWarps - 1) / kWarps),
                  (unsigned)((p.b + 31) / 32));
  if (smem > 48 * 1024) {  // the widest transforms (74 KB at d = 64, A = 64)
    const cudaError_t err = cudaFuncSetAttribute(
        temporal_hop<DP, FLAGS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
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
// b) bool; partial, partial_kept and arrive_counts as dense_hop_static's.
// d <= 64. Returns a cudaError_t.
extern "C" int dense_hop_temporal(
    const void* hidden, const void* visited, const void* rela,
    const void* tsrc, const void* trel, const void* ttime,
    const void* tail_rowptr, const void* item_ptr, const void* times,
    const void* excl, const void* ekeep, const void* tt, const void* ra,
    const void* qa, const void* a1s, const void* a2, const void* wdir,
    const void* bdir, const void* drop, float drop_div, int act, void* out,
    void* new_visited, void* partial, void* partial_kept, void* arrive_counts,
    long long n_tail, long long b, long long d, long long a, long long chunk,
    long long items, int use_time, int use_attn, int linear, void* stream) {
  const int dp = dense_hop::padded_width(d);
  if (n_tail <= 0 || b <= 0 || d <= 0 || dp == 0 || a < 0 ||
      a > 64 || (use_attn && a == 0) || chunk <= 0 || items < n_tail ||
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
  t.Ap = use_attn ? ((int)a + 7) / 8 * 8 : 0;
  t.vec_h = d % 4 == 0 && (uintptr_t)hidden % 16 == 0;
  t.vec_t = d % 4 == 0 && (uintptr_t)tt % 16 == 0;
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
