// Sorted-segment sum on Hopper (sm_90a).
//
// Replaces: redgnn_tpu/ops/segment_pallas.py:segment_sum_pallas (the
// Pallas TPU kernel at segment_pallas.py:145). It computes
//     out[s, :] = sum of data[e, :] over edges e with seg[e] == s,
// for ascending seg, 0 <= s < n_seg; ids outside [0, n_seg) are dropped.
// With a per-block `limit` (the kmax contract of
// segment_sum_pallas_checked), segments of node block j = s / block_nodes
// only take edges at positions < limit[j].
//
// What bounds it: bytes. Each edge row is read once and each output row
// written once, E*D*4 + E*4 + N*D*4 bytes, against E*D fp32 adds; at
// 3.35 TB/s and 67 TFLOP/s the adds are ~2 orders of magnitude below the
// memory time.
//
// Design. The TPU kernel needs its one-hot matmul and sequential grid
// carry only because scatter is slow there. Here the ids are sorted, so
// each output row's edges form one contiguous range, found by two binary
// searches. One warp owns one segment: lane 0 finds [lo, hi), the lanes
// stride over the D columns (neighbouring lanes on neighbouring
// addresses, so each edge row is one coalesced read) and sum the rows of
// the range in edge order, in fp32. Each output row is written once, by
// its warp, with no atomics, so results are the same run to run; empty
// segments get 0. A lane keeps up to four column sums, so a row of D <= 128
// is read in one pass; four rows are loaded ahead of the adds to keep
// loads in flight without changing the order of the sum. Callers map
// padding edges to an out-of-range id (models/layers.py), so no warp
// walks them.
//
// Left for later: balancing hub segments across warps, 16-byte vector
// loads, and fusing the alpha*(hs+hr) message into the reduction so that
// the E x D message never goes through device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kCols = 4;  // columns per lane per pass: 128 per warp
constexpr int kRows = 4;  // edge rows loaded ahead of the adds

__device__ __forceinline__ long long lower_bound(const int* __restrict__ seg,
                                                 long long n, int key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(seg + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_sorted_kernel(const float* __restrict__ data,
                          const int* __restrict__ seg,
                          const long long* __restrict__ limit,
                          float* __restrict__ out, long long n_edges,
                          int dim, int n_seg, int block_nodes) {
  const int lane = threadIdx.x & 31;
  const long long s =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= n_seg) return;  // uniform across the warp

  long long lo = 0, hi = 0;
  if (lane == 0) {
    lo = lower_bound(seg, n_edges, (int)s);
    hi = lower_bound(seg, n_edges, (int)s + 1);
    if (limit != nullptr) {
      const long long lim = limit[s / block_nodes];
      hi = hi < lim ? hi : lim;
      lo = lo < hi ? lo : hi;
    }
  }
  lo = __shfl_sync(0xffffffffu, lo, 0);
  hi = __shfl_sync(0xffffffffu, hi, 0);

  // Each lane sums up to kCols columns (lane, lane+32, ...) in one pass
  // over the range, so D = 48 reads every edge row once.
  float* __restrict__ orow = out + s * dim;
  for (int c0 = 0; c0 < dim; c0 += 32 * kCols) {
    int col[kCols];
    bool on[kCols];
    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      col[j] = c0 + lane + 32 * j;
      on[j] = col[j] < dim;
      acc[j] = 0.f;
    }
    const float* row = data + lo * dim;
    long long e = lo;
    for (; e + kRows <= hi; e += kRows, row += kRows * (long long)dim) {
      float v[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          v[r][j] = on[j] ? __ldg(row + r * (long long)dim + col[j]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] += v[r][j];
      }
    }
    for (; e < hi; ++e, row += dim) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (on[j]) acc[j] += __ldg(row + col[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (on[j]) orow[col[j]] = acc[j];
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers;
// `limit` may be null (no kmax). Launches on `stream` and returns
// cudaGetLastError() of the launch (0 = cudaSuccess).
extern "C" int segment_sum_sorted_f32(const void* data, const void* seg,
                                      const void* limit, void* out,
                                      long long n_edges, int dim, int n_seg,
                                      int block_nodes, void* stream) {
  if (n_seg <= 0 || dim <= 0) return 0;
  const unsigned grid = (unsigned)((n_seg + kWarpsPerBlock - 1) /
                                   kWarpsPerBlock);
  segment_sum_sorted_kernel<<<grid, kWarpsPerBlock * 32, 0,
                              (cudaStream_t)stream>>>(
      (const float*)data, (const int*)seg, (const long long*)limit,
      (float*)out, n_edges, dim, n_seg, block_nodes);
  return (int)cudaGetLastError();
}
