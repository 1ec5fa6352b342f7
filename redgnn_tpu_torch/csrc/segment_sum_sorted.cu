// Sorted-segment sum on Hopper (sm_90a), v3.
//
// Replaces: redgnn_tpu/ops/segment_pallas.py:segment_sum_pallas (the
// Pallas TPU kernel at segment_pallas.py:145). It computes
//     out[s, :] = sum of data[e, :] over edges e with seg[e] == s,
// for ascending int32 seg, 0 <= s < n_seg; ids outside [0, n_seg) are
// dropped and empty segments are 0. With a per-block `limit` (the kmax
// contract of segment_sum_pallas_checked), segments of node block
// j = s / block_nodes only take edges at positions < limit[j]. Sums are
// fp32, without float atomics, in a fixed order: the same bits run to run.
//
// What bounds it: bytes. Each edge row is read once and each output row
// written once, E*D*4 + E*4 + N*D*4 bytes, against E*D fp32 adds; at
// 3.35 TB/s and 67 TFLOP/s the adds are ~2 orders of magnitude below the
// memory time. At the serving path's sizes (E <= 170k, D = 48) the whole
// launch is a few microseconds, so latency chains count as much as bytes.
//
// Design (v2 gave each segment to one warp: lane 0 ran two dependent
// binary searches per segment, a hub segment was walked by one warp four
// rows at a time, and rows were read with 4-byte loads):
//  * A block owns kSegs = 16 consecutive segments [s0, s1). Two warps
//    find the block's edge range [lower_bound(s0), lower_bound(s1)) at
//    once, each with a 32-way search (32 probes per step, one ballot):
//    ~4 dependent loads at E = 170k instead of 2 x 18. The segment starts
//    inside the range come from one coalesced adjacent-compare pass over
//    the ids into shared memory. One launch per call, no offsets kernel.
//  * Work is split by edges, not segments. Each worker (a group of G
//    lanes) takes an equal contiguous share of the block's edges and sums
//    runs of equal id in edge order. A segment that lies wholly inside a
//    share is written by its worker; a worker's at most two boundary
//    partials (the run that started before its share, the run that goes on
//    past it) go to shared memory and are added in worker order by one
//    worker after a barrier. A hub of hundreds of edges is spread over the
//    block's workers; no segment crosses blocks, so a single huge segment
//    stays correct, only unbalanced.
//  * 16-byte loads: when D % 4 == 0 and `data` is 16-byte aligned (the
//    wrapper decides, `vec`), a lane loads float4. A worker is G lanes x 3
//    float4 (G = 4 for D <= 48, so a warp has 8 rows in flight; G = 8 past
//    that), and each lane keeps kRowsAhead rows of loads ahead of the adds.
//    Other D, or a misaligned pointer, take the same kernel with 4-byte
//    loads (G = 16). Wider rows take several passes over the columns.
//  * Deterministic: every sum is taken in one fixed order (edge order in a
//    share, then shares in order), so two calls give the same bits.
//  * 64 registers, no spills: four blocks of 256 threads (50% occupancy)
//    per SM. kSegs, kWarps and kRowsAhead were chosen from card timings
//    of builds with other values (time_kernel_variants.py).
//
// Left for later: at the serving hops the time is the launch and a chain
// of dependent loads per block (search, id pass, rows), not bytes; fusing
// the alpha*(hs+hr) message into the reduction (the E x D message then
// never goes through device memory); staging rows with TMA 1-D bulk
// copies (not timed); the backward (dout[seg], masked).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSegs = 16;  // segments a block owns
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsAhead = 2;  // rows a lane loads ahead of its adds
// Blocks per SM that __launch_bounds__ asks for: half the SM's 2048
// threads, so 64 registers a thread.
constexpr int kMinBlocks = 2048 / 2 / kThreads;

__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void add_to(float& a, const float& b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// First position in seg[0, n) whose id is >= key, by the whole warp: each
// step splits the range into 32 pieces and a ballot over their last ids
// picks the piece that holds the answer.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ seg,
                                                int n, int key, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const long long q = (long long)lo + (long long)(lane + 1) * step - 1;
    const bool less = q < hi && __ldg(seg + q) < key;
    const int c = __popc(__ballot_sync(0xffffffffu, less));
    const long long top = (long long)lo + (long long)(c + 1) * step - 1;
    lo += c * step;
    hi = top < hi ? (int)top : hi;
  }
  return lo;
}

// V: float4 (vector path) or float; G lanes per worker, C loads per lane
// and row: one pass covers G * C * width columns.
template <typename V, int G, int C, bool kLimit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_sum_sorted_kernel(const float* __restrict__ data,
                          const int* __restrict__ seg,
                          const long long* __restrict__ limit,
                          float* __restrict__ out, int n_edges, int dim,
                          int n_seg, int block_nodes) {
  constexpr int kWidth = sizeof(V) / sizeof(float);
  constexpr int kWorkers = kThreads / G;
  constexpr int kPass = G * C * kWidth;
  __shared__ int start[kSegs + 1];
  __shared__ V part[2][kWorkers][G * C];
  __shared__ int range[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int s0 = blockIdx.x * kSegs;
  const int s1 = s0 + min(kSegs, n_seg - s0);  // no int overflow
  const int ns = s1 - s0;

  if (tid < 64) {  // warp 0 finds the first edge, warp 1 the end
    const int e = warp_lower_bound(seg, n_edges, tid < 32 ? s0 : s1, lane);
    if (lane == 0) range[tid >> 5] = e;
  }
  __syncthreads();
  const int e_lo = range[0], e_hi = range[1];
  // start[j]: first position with id >= s0 + j (a virtual edge of id s1
  // sits at e_hi), so segment j holds [start[j], start[j + 1]).
  for (int e = e_lo + tid; e <= e_hi; e += kThreads) {
    const int id = e < e_hi ? __ldg(seg + e) : s1;
    const int prev = e > e_lo ? __ldg(seg + e - 1) : s0 - 1;
    for (int t = prev + 1; t <= id; ++t) start[t - s0] = e;
  }
  __syncthreads();

  // Segment j's edges that count: [start[j], live_end(j)).
  auto live_end = [&](int j) {
    int hi = start[j + 1];
    if (kLimit) {
      const long long lim = limit[(s0 + j) / block_nodes];
      if (lim < hi) hi = (int)(lim > 0 ? lim : 0);
    }
    return hi;
  };

  const int w = tid / G;   // this lane's worker
  const int gl = tid % G;  // its lane within the worker
  const int len = e_hi - e_lo;
  const int chunk = (len + kWorkers - 1) / kWorkers;
  const int a = min(e_lo + w * chunk, e_hi);  // the worker's share [a, b)
  const int b = min(a + chunk, e_hi);

  for (int c0 = 0; c0 < dim; c0 += kPass) {
    bool on[C];
#pragma unroll
    for (int c = 0; c < C; ++c) on[c] = c0 + (gl + G * c) * kWidth < dim;
    auto store_row = [&](int j, const V* acc) {
      V* row = reinterpret_cast<V*>(out + (long long)(s0 + j) * dim + c0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (on[c]) row[gl + G * c] = acc[c];
      }
    };

    if (a < b) {
      // the segment that holds position a: the last j with start[j] <= a
      int j = 0, top = ns - 1;
      while (j < top) {
        const int mid = (j + top + 1) >> 1;
        if (start[mid] <= a) {
          j = mid;
        } else {
          top = mid - 1;
        }
      }
      int end_j = start[j + 1];
      int live_j = live_end(j);
      V acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) set_zero(acc[c]);
      bool any = false;
      // Flush segment j's run: the whole segment inside [a, b) goes to
      // `out`; a run that began before a to slot 0; one that goes past b
      // to slot 1.
      auto flush = [&]() {
        const int lo = start[j];
        if (lo >= a && live_j <= b) {
          store_row(j, acc);
        } else {
          V* p = part[lo < a ? 0 : 1][w];
#pragma unroll
          for (int c = 0; c < C; ++c) p[gl + G * c] = acc[c];
        }
      };

      for (int e = a; e < b; e += kRowsAhead) {
        V v[kRowsAhead][C];
#pragma unroll
        for (int r = 0; r < kRowsAhead; ++r) {
          const V* row = reinterpret_cast<const V*>(
              data + (long long)(e + r) * dim + c0);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (e + r < b && on[c]) {
              v[r][c] = __ldg(row + gl + G * c);
            } else {
              set_zero(v[r][c]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsAhead; ++r) {
          const int er = e + r;
          if (er < b) {
            while (er >= end_j) {  // next segment (skips empty ones)
              if (any) flush();
              ++j;
              end_j = start[j + 1];
              live_j = live_end(j);
#pragma unroll
              for (int c = 0; c < C; ++c) set_zero(acc[c]);
              any = false;
            }
            if (!kLimit || er < live_j) {
#pragma unroll
              for (int c = 0; c < C; ++c) add_to(acc[c], v[r][c]);
              any = true;
            }
          }
        }
      }
      if (any) flush();
    }
    __syncthreads();

    // Empty segments get 0; a segment that crosses shares is its first
    // worker's slot 1 plus the slot 0 of every later worker it reaches,
    // added in worker order.
    for (int j = w; j < ns; j += kWorkers) {
      const int lo = start[j], hi = live_end(j);
      V acc[C];
      if (lo >= hi) {
#pragma unroll
        for (int c = 0; c < C; ++c) set_zero(acc[c]);
      } else {
        const int ka = (lo - e_lo) / chunk, kb = (hi - 1 - e_lo) / chunk;
        if (ka == kb) continue;  // written by its worker
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = part[1][ka][gl + G * c];
        for (int k = ka + 1; k <= kb; ++k) {
#pragma unroll
          for (int c = 0; c < C; ++c) add_to(acc[c], part[0][k][gl + G * c]);
        }
      }
      store_row(j, acc);
    }
    __syncthreads();  // the next pass reuses `part`
  }
}

template <typename V, int G, int C>
void launch(unsigned grid, cudaStream_t stream, const float* data,
            const int* seg, const long long* limit, float* out, int n_edges,
            int dim, int n_seg, int block_nodes) {
  if (limit != nullptr) {
    segment_sum_sorted_kernel<V, G, C, true><<<grid, kThreads, 0, stream>>>(
        data, seg, limit, out, n_edges, dim, n_seg, block_nodes);
  } else {
    segment_sum_sorted_kernel<V, G, C, false><<<grid, kThreads, 0, stream>>>(
        data, seg, limit, out, n_edges, dim, n_seg, block_nodes);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers;
// `limit` may be null (no kmax). `vec` asks for float4 loads (needs
// D % 4 == 0 and a 16-byte aligned `data`), as the wrapper's launch plan
// (ops/segment_sorted.py:_launch_plan) chooses; the grid is one block per
// kSegs segments. Launches on `stream` and returns cudaGetLastError() of
// the launch (0 = cudaSuccess), or cudaErrorInvalidValue for arguments it
// refuses: more than INT_MAX - kThreads edges (positions are int, and the
// strides need kThreads of headroom), a limit without block_nodes, or
// `vec` on rows it cannot load as float4.
extern "C" int segment_sum_sorted_f32(const void* data, const void* seg,
                                      const void* limit, void* out,
                                      long long n_edges, int dim, int n_seg,
                                      int block_nodes, int vec,
                                      void* stream) {
  if (n_seg <= 0 || dim <= 0) return 0;
  if (n_edges < 0 || n_edges > INT_MAX - kThreads ||
      (limit != nullptr && block_nodes <= 0) ||
      (vec && (dim % 4 != 0 || (uintptr_t)data % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((n_seg + kSegs - 1) / kSegs);
  const auto s = (cudaStream_t)stream;
  const auto* d = (const float*)data;
  const auto* ids = (const int*)seg;
  const auto* lim = (const long long*)limit;
  auto* o = (float*)out;
  const int e = (int)n_edges;
  if (!vec) {
    launch<float, 16, 3>(grid, s, d, ids, lim, o, e, dim, n_seg, block_nodes);
  } else if (dim <= 48) {
    launch<float4, 4, 3>(grid, s, d, ids, lim, o, e, dim, n_seg, block_nodes);
  } else {
    launch<float4, 8, 3>(grid, s, d, ids, lim, o, e, dim, n_seg, block_nodes);
  }
  return (int)cudaGetLastError();
}
