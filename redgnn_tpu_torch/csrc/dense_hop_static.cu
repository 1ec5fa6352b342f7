// The static dense hop's forward, one kernel, on Hopper (sm_90a).
//
// Replaces: RelAttnLayer.dense of redgnn_tpu/models/layers.py:159-210, an
// XLA composition and not a Pallas kernel (gather of the packed state,
// attention, message, segment sums by tail). In the port's eager route
// every (E, b, d) intermediate of that composition is a tensor in device
// memory; here none is. For each tail v and query q (the walk:
// dense_hop.cuh) it computes
//     agg[v, q]   = sum over kept edges e of tail v of
//                   (hs + hr) * sigmoid(w_a . relu(Ws hs + WR[rel] + WQ[q]) + b_a)
//     new_vis[v, q] = any edge kept,  counts[0] = edges kept
// with hs = hidden[tsrc[e], q], hr = rela[trel[e]], an edge kept where
// visited[tsrc[e], q]. WR = Wr rela (per relation) and WQ = Wqr h_qr + b_qr
// (per query) are the terms that depend on fewer operands than (edge,
// query): the wrapper computes them once (ops/dense_hop.py:static_terms).
// In bf16 (T = __nv_bfloat16) hidden and rela are bf16 tables: the rows
// are promoted to float32 for the projections and hs + hr is rounded to
// bf16 once, as the port's bf16 route does. act(W_h agg) stays outside.
//
// What bounds it: at the umls entry (N = 135, b = 50, d = 48, A = 5,
// E ~ 10.6k) the hop moves ~2.7 MB and does ~0.34 GFLOP: a few µs of
// either. What is left is latency: a step of a lane (one kept edge) is a
// load of its state row, ~d * A dependent FMAs in A chains, a sigmoid and
// 2d FMAs, and a warp's steps follow one another; so the time goes as the
// steps of the busiest warps over the warps in flight.
//
// Design (PR 14): the walk of dense_hop.cuh, chunks of 16 edges (at umls
// ~1,440 warps for its two query groups, against ~930 of 32 edges
// before), 4 warps a block; the chunk's indices and visited bytes loaded
// before any row; each lane walks only its own kept edges; WR and the
// relation table staged in shared memory. Ws sits in shared memory column
// by column ([A][d]: one broadcast float4 per 4 FMAs, A columns, not A
// rounded up to 8), WQ lane-major; each lane reads its own hs row
// (16-byte loads where d % 4 == 0) and keeps hs and the sum in registers
// (width padded to 8, 16, 24, 32, 48 or 64); the relation row is added in
// place, four values at a time.

#include "dense_hop.cuh"

namespace {

using namespace dense_hop;

// The block's shared memory: Ws [A][DP], WQ [A][32], w_alpha [A], then,
// where they fit, WR [R][A] and the relation rows [R][d] (in T).
__host__ __device__ inline size_t weight_floats(int A, int dp) {
  return ((size_t)A * (dp + 33) + 3) / 4 * 4;
}

template <typename T>
__host__ __device__ inline size_t table_bytes(int R, int A, int d) {
  return ((size_t)R * A + 3) / 4 * 16 + (size_t)R * d * sizeof(T);
}

// No cap below 255 registers a thread: at 128 (8-warp blocks, 16 warps a
// multiprocessor) d = 48 spilled and ran slower.
template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
static_hop(Walk p, const T* __restrict__ hidden, const T* __restrict__ rela,
           const int* __restrict__ trel, const float* __restrict__ wr,
           const float* __restrict__ wq, const float* __restrict__ ws,
           const float* __restrict__ w_alpha, const float* __restrict__ b_alpha,
           float* __restrict__ agg, unsigned char* __restrict__ new_visited,
           int A, int R, bool vec_h, bool vec_r, bool tables) {
  extern __shared__ __align__(16) float sm[];
  float* s_ws = sm;               // [A][DP]
  float* s_wq = s_ws + A * DP;    // [A][32]
  float* s_wa = s_wq + A * 32;    // [A]
  const int g = blockIdx.y;
  stage_proj(s_ws, ws, 1, p.d, DP, p.d, A);  // Linear weight (A, d)
  stage_query(s_wq, wq, p.b, A, g);
  stage_vec(s_wa, w_alpha, A);
  const float* t_wr = wr;  // the relation tables: shared or global
  const T* t_rela = rela;
  if (tables) {
    float* s_wr = sm + weight_floats(A, DP);
    T* s_rela = reinterpret_cast<T*>(s_wr + ((size_t)R * A + 3) / 4 * 4);
    stage_table(s_wr, wr, R * A);
    stage_table(s_rela, rela, R * p.d);
    t_wr = s_wr;
    t_rela = s_rela;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int q = g * 32 + lane;
  const bool active = q < p.b;
  const float ba = __ldg(b_alpha);
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  Item it;
  if (!item_of(p, w, it)) return;
  const int rel_k = lane < it.e1 - it.e0 ? __ldg(trel + it.e0 + lane) : 0;
  Chunk c = stage_chunk(p, it, q, active, kFull, nullptr);
  int kept = __popc(c.mine);
  const int steps = __reduce_max_sync(kFull, kept);
  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int j = next_edge(c.mine);
    const int src = __shfl_sync(kFull, c.src, j & 31);
    const int rel = __shfl_sync(kFull, rel_k, j & 31);
    if (j < 0) continue;
    float hs[DP];
    load_row<DP>(hidden + ((size_t)src * p.b + q) * p.d, p.d, vec_h, hs);
    const float alpha = sigmoid(attn_logit<DP>(
        hs, s_ws, t_wr + (size_t)rel * A, s_wq, s_wa, A, lane, ba));
    add_table_row<DP>(t_rela + (size_t)rel * p.d, p.d, vec_r, hs);
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      if (i < p.d) {
        float m = hs[i];  // hs + hr
        if (sizeof(T) == 2) m = __bfloat162float(__float2bfloat16_rn(m));
        acc[i] += m * alpha;
      }
    }
  }
  if (!close_item<DP>(p, it, w, q, active, acc, kept) || !active) return;
  float* out = agg + ((size_t)it.v * p.b + q) * p.d;
#pragma unroll
  for (int i = 0; i < DP; ++i)
    if (i < p.d) out[i] = acc[i];
  new_visited[(size_t)it.v * p.b + q] = kept > 0;
}

template <int DP, typename T>
int launch(const Walk& p, const void* hidden, const void* rela,
           const void* trel, const void* wr, const void* wq, const void* ws,
           const void* w_alpha, const void* b_alpha, void* agg,
           void* new_visited, int A, int R, long long items,
           cudaStream_t stream) {
  const size_t base = sizeof(float) * weight_floats(A, DP);
  const size_t tab = table_bytes<T>(R, A, p.d);
  const bool tables = tab <= kTableBytes;
  const size_t smem = base + (tables ? tab : 0);
  const size_t align = sizeof(T) == 4 ? 16 : 8;
  const bool vec_h = p.d % 4 == 0 && (uintptr_t)hidden % align == 0;
  // relation rows: 16-byte loads of a float table (global or staged)
  const bool vec_r = p.d % 4 == 0 && (uintptr_t)rela % 16 == 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        static_hop<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((items + kWarps - 1) / kWarps),
                  (unsigned)((p.b + 31) / 32));
  static_hop<DP, T><<<grid, kThreads, smem, stream>>>(
      p, (const T*)hidden, (const T*)rela, (const int*)trel,
      (const float*)wr, (const float*)wq, (const float*)ws,
      (const float*)w_alpha, (const float*)b_alpha, (float*)agg,
      (unsigned char*)new_visited, A, R, vec_h, vec_r, tables);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dp, const Walk& p, const void* hidden, const void* rela,
             const void* trel, const void* wr, const void* wq, const void* ws,
             const void* w_alpha, const void* b_alpha, void* agg,
             void* new_visited, int A, int R, long long items,
             cudaStream_t s) {
#define DENSE_HOP_CASE(W)                                                    \
  case W:                                                                    \
    return launch<W, T>(p, hidden, rela, trel, wr, wq, ws, w_alpha, b_alpha, \
                        agg, new_visited, A, R, items, s);
  switch (dp) {
    DENSE_HOP_CASE(8)
    DENSE_HOP_CASE(16)
    DENSE_HOP_CASE(24)
    DENSE_HOP_CASE(32)
    DENSE_HOP_CASE(48)
    DENSE_HOP_CASE(64)
  }
#undef DENSE_HOP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// hidden (n_tail, b, d) and rela (R, d): float32 (bf16 == 0) or bfloat16
// (bf16 == 1); visited (n_tail, b) bool; tsrc, trel (E,) int32; tail_rowptr,
// item_ptr (n_tail + 1,) int32; wr (R, A), wq (b, A), ws (A, d), w_alpha
// (A,), b_alpha (1,) float32. Writes agg (n_tail, b, d) float32 and
// new_visited (n_tail, b) bool; partial (items, b, d) float32 and
// partial_kept (items, b) int32 are scratch; arrive_counts (2 + n_tail *
// ceil(b / 32),) int32, zeroed, starts with [edges kept, (v, q) flagged]
// and holds the split tails' arrival counters. `items` bounds
// item_ptr[n_tail]; n_rel is R. Returns a cudaError_t.
extern "C" int dense_hop_static(
    const void* hidden, int bf16, const void* visited, const void* rela,
    const void* tsrc, const void* trel, const void* tail_rowptr,
    const void* item_ptr, const void* wr, const void* wq, const void* ws,
    const void* w_alpha, const void* b_alpha, void* agg, void* new_visited,
    void* partial, void* partial_kept, void* arrive_counts, long long n_tail,
    long long b, long long d, long long a, long long chunk, long long items,
    long long n_rel, void* stream) {
  const int dp = dense_hop::padded_width(d);
  if (n_tail <= 0 || b <= 0 || d <= 0 || dp == 0 || a <= 0 || a > 64 ||
      chunk <= 0 || chunk > dense_hop::kMaxChunk || items < n_tail ||
      (b + 31) / 32 > 65535 || n_rel <= 0 || n_rel > 0x7fffffffLL / 64 ||
      items > 0x7fffffffLL || n_tail * b > 0x7fffffffLL) {
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return dispatch<__nv_bfloat16>(dp, p, hidden, rela, trel, wr, wq, ws,
                                   w_alpha, b_alpha, agg, new_visited, (int)a,
                                   (int)n_rel, items, s);
  }
  return dispatch<float>(dp, p, hidden, rela, trel, wr, wq, ws, w_alpha,
                         b_alpha, agg, new_visited, (int)a, (int)n_rel, items,
                         s);
}
