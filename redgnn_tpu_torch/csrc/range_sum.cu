// Exact range sum on Hopper (sm_90a): the backward of gather_rows_packed.
//
// Replaces: the custom VJP `_gp_bwd` of redgnn_tpu/ops/gather.py
// (gather_rows_packed, `:174-183`), a jax.custom_vjp and not a Pallas
// kernel. It computes, for every row v of a table of P rows,
//     out[v, :] = sum of g[e, :] over e in [start[v], start[v] + count[v])
//                 intersected with [0, E),
// so a row with count <= 0 is 0, a range cut by E is a partial sum and a
// row with start >= E is 0 (`_gp_bwd`'s clipping). Ranges need not be
// ascending or disjoint. The JAX package and the port's CPU path take the
// difference of a float32 prefix sum of g, which cancels large partial sums
// (noise of O(E u sum|g|)); this kernel adds each range's own rows and
// nothing else. Sums are fp32, without float atomics, in one fixed order
// that depends on the inputs and the wrapper's plan (a function of shapes)
// alone: the same bits run to run and card to card.
//
// What bounds it: bytes. Each slot of a range is read once and each output
// row written once, T*D*4 + P*D*4 (+ P*16 for start and count) bytes for T
// slots in ranges, against T*D fp32 adds; at 3.35 TB/s and 67 TFLOP/s the
// adds are two orders of magnitude below the memory time.
//
// Design: the ranges' slots, clipped, are laid end to end in a virtual list
// (row v at off[v], the exclusive scan of the clipped lengths), and
// share_sum.cuh sums the list in equal shares:
//  1. tile_kernel: block x sums the clipped lengths of rows
//     [x kScanRows, (x + 1) kScanRows).
//  2. offsets_kernel: block x adds the sums of the tiles before it (and of
//     all: T, the list's length, hence the share), scans its rows' lengths
//     and writes off[v] (and off[P] = T) and the clipped start lo[v], and
//     for each warp's part of the list that begins in its rows, first_row
//     (a binary search over the tile's starts in shared memory, one thread
//     a part). The output is zeroed first (a memset on the stream): no
//     share holds an empty row.
//  3. share_kernel: share_sum::sum_share over the list. A warp reads the
//     row of its first position (first_row); a round's rows come from one
//     load of the 32 row starts after it and a ballot a position, which
//     also give each row's bounds. A share is a fixed number of positions
//     (the wrapper's plan, from E alone), so a range of 3,210 slots, or a
//     10^5-slot hub, is spread over blocks and warps, and the grid has
//     ceil(E / S) blocks whatever the rows. Where the ranges are laid end
//     to end (the frontier's: start is the exclusive cumsum of the
//     degrees), a round's slots run on and it is one contiguous span of g,
//     copied in 16-byte pieces; D = 30 no longer takes 4-byte loads. The
//     choice is made per round on the device and changes no sum: only how
//     the rows reach shared memory.
//  4. share_sum::fixup_kernel adds the block partials of rows that cross
//     shares, in block order.
// A list longer than the grid's shares of S (overlapping ranges whose
// slots add up past E) takes the smallest multiple of S that fits the grid
// (share_sum::effective_share); then the order depends on T as well.

#include "share_sum.cuh"

namespace {

using share_sum::kFull;
using share_sum::kThreads;
using share_sum::kWarps;

constexpr int kScanRows = 512;  // rows a block of the scan passes takes
constexpr int kPerThread = kScanRows / kThreads;

// The clipped range [lo, lo + length) of row (st, c) in [0, n_slots).
__device__ __forceinline__ long long clip(long long st, long long c,
                                          long long n_slots, long long* lo) {
  const long long s = st < 0 ? 0 : (st > n_slots ? n_slots : st);
  long long hi = c > 0 ? st + c : st;
  hi = hi > n_slots ? n_slots : hi;
  *lo = s;
  return hi > s ? hi - s : 0;
}

// Sum of the block's values, in thread 0.
__device__ __forceinline__ long long block_sum(long long v) {
  __shared__ long long wsum[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  if (lane == 0) wsum[w] = v;
  __syncthreads();
  long long t = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += wsum[k];
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
tile_kernel(const long long* __restrict__ start,
            const long long* __restrict__ count, long long* __restrict__ tsum,
            long long n_slots, int n_rows) {
  const long long v0 = (long long)blockIdx.x * kScanRows;
  long long s = 0, lo;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long v = v0 + j * kThreads + threadIdx.x;
    if (v < n_rows) s += clip(start[v], count[v], n_slots, &lo);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) tsum[blockIdx.x] = s;
}

// Block x: off[v], lo[v] of its rows; first_row of each warp's part of the
// list that begins in its rows.
__global__ void __launch_bounds__(kThreads)
offsets_kernel(const long long* __restrict__ start,
               const long long* __restrict__ count,
               const long long* __restrict__ tsum, long long* __restrict__ off,
               long long* __restrict__ lo_out, int* __restrict__ first_row,
               long long n_slots, int n_rows, long long share,
               long long n_blocks) {
  __shared__ long long offs[kScanRows + 1];  // the tile's row starts
  __shared__ long long wsum[kWarps];
  __shared__ long long before, total;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long v0 = (long long)blockIdx.x * kScanRows;
  const int nr = (int)(n_rows - v0 < kScanRows ? n_rows - v0 : kScanRows);
  // this thread's rows v0 + k kThreads + tid, all loaded up front
  long long len[kPerThread], lo[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long v = v0 + k * kThreads + tid;
    len[k] = v < n_rows ? clip(start[v], count[v], n_slots, &lo[k]) : 0;
  }
  if (w == 0) {  // the tiles before this one, and all of them
    long long s = 0, t = 0;
    for (int k = lane; k < (int)gridDim.x; k += 32) {
      const long long x = tsum[k];
      t += x;
      if (k < (int)blockIdx.x) s += x;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s += __shfl_down_sync(kFull, s, d);
      t += __shfl_down_sync(kFull, t, d);
    }
    if (lane == 0) {
      before = s;
      total = t;
    }
  }
  __syncthreads();
  long long base = before;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long v = v0 + k * kThreads + tid;
    long long incl = len[k];  // the block's scan of this pass's rows
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) wsum[w] = incl;
    __syncthreads();
    long long at = base + incl - len[k], pass = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      if (j < w) at += wsum[j];
      pass += wsum[j];
    }
    __syncthreads();  // wsum is written again by the next pass
    base += pass;
    offs[k * kThreads + tid] = at;
    if (v < n_rows) {
      off[v] = at;
      lo_out[v] = lo[k];
      if (v == n_rows - 1) off[n_rows] = at + len[k];
    }
  }
  if (tid == 0) offs[kScanRows] = base;
  __syncthreads();
  // the warps' parts of the list that begin in this tile's positions: the
  // last row of the tile whose start is at or before the part's first
  // position holds it (a binary search over the tile's starts)
  const long long sub =
      share_sum::effective_share(total, share * kWarps, n_blocks) / kWarps;
  for (long long q = (offs[0] + sub - 1) / sub + tid; q * sub < base;
       q += kThreads) {
    const long long p = q * sub;
    int lo_i = 0, hi_i = nr - 1;  // the last i with offs[i] <= p
    while (lo_i < hi_i) {
      const int mid = (lo_i + hi_i + 1) >> 1;
      if (offs[mid] <= p) {
        lo_i = mid;
      } else {
        hi_i = mid - 1;
      }
    }
    first_row[q] = (int)(v0 + lo_i);
  }
}

template <int C, int WB>
__global__ void __launch_bounds__(kThreads, 4)
share_kernel(const float* __restrict__ g, const long long* __restrict__ off,
             const long long* __restrict__ lo,
             const int* __restrict__ first_row, float* __restrict__ out,
             float* __restrict__ bpart, int* __restrict__ tails, int n_rows,
             int dim, int tile, long long share, long long n_blocks) {
  constexpr int B = share_sum::batch_rows(C);
  constexpr int K = share_sum::lane_positions(C);
  extern __shared__ __align__(16) float stage[];
  const long long blk = blockIdx.x;
  const int c0 = blockIdx.y * tile;
  const int tw = min(tile, dim - c0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0 && blockIdx.y == 0) tails[blk] = -1;
  const long long total = off[n_rows];
  const int row_a = first_row[blk * kWarps + w];
  const long long S =
      share_sum::effective_share(total, share * kWarps, n_blocks);
  const long long s0 = blk * S;
  if (s0 >= total) return;
  const long long s1 = s0 + S < total ? s0 + S : total;
  const long long sub = S / kWarps;
  const long long a = s0 + w * sub < s1 ? s0 + w * sub : s1;
  const long long b = a + sub < s1 ? a + sub : s1;
  // vb: the row of the next position to locate; base: off[vb]; next_end:
  // off[r + 1] of the last position located
  long long vb = 0, base = 0, next_end = 0;
  if (a < b) {
    vb = row_a;
    base = off[vb];
  }
  const long long base_a = base;  // off of the row of position a
  // Lane l's positions t = t0 + l + 32 j: their row is vb plus the number
  // of row starts in (vb, t]. Lane i loads off[wb + 1 + i] (a window of 32
  // row starts) and a ballot a position counts those at or below it; a
  // window that ends before a position moves on by 32 rows. The row's
  // bounds off[r], off[r + 1] come from the window too.
  auto locate = [&](long long t0, int nb, long long (&slot)[K],
                    int (&row)[K]) {
    long long r[K], first[K], next[K];
    bool done[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      r[j] = vb;
      first[j] = base;
      next[j] = 0;
      done[j] = lane + 32 * j >= nb;
    }
    long long w_off = base;  // off[wb]
    for (long long wb = vb;; wb += 32) {
      const long long jj = wb + 1 + lane;
      const long long oj = jj <= n_rows ? off[jj] : LLONG_MAX;
      int cnt[K];
#pragma unroll
      for (int j = 0; j < K; ++j) cnt[j] = 0;
#pragma unroll
      for (int i = 0; i < B; ++i) {
        const unsigned m = __ballot_sync(kFull, oj <= t0 + i);
        if ((i & 31) == lane) cnt[i >> 5] = __popc(m);
      }
      bool all = true;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = cnt[j];
        const long long nx = __shfl_sync(kFull, oj, c < 32 ? c : 31);
        const long long fs = __shfl_sync(kFull, oj, c > 0 ? c - 1 : 0);
        if (!done[j]) {
          r[j] = wb + c;
          first[j] = c > 0 ? fs : w_off;
          next[j] = nx;
          done[j] = c < 32;
        }
        all = all && done[j];
      }
      if (__all_sync(kFull, all)) break;
      w_off = __shfl_sync(kFull, oj, 31);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = lane + 32 * j;
      row[j] = (int)r[j];
      slot[j] = p < nb ? lo[r[j]] + (t0 + p - first[j]) : 0;
    }
    const int jl = (nb - 1) >> 5, ll = (nb - 1) & 31;
    vb = __shfl_sync(kFull, share_sum::pick(r, jl), ll);
    base = __shfl_sync(kFull, share_sum::pick(first, jl), ll);
    next_end = __shfl_sync(kFull, share_sum::pick(next, jl), ll);
  };
  auto began_before = [&](int) { return base_a < a; };
  auto goes_past = [&](int) { return next_end > b; };
  share_sum::sum_share<C, WB>(g, out, bpart, tails, a, b, dim, c0, tw, blk,
                              stage, locate, began_before, goes_past);
}

template <int C, int WB>
int launch_share(dim3 grid, cudaStream_t s, const float* g,
                 const long long* off, const long long* lo,
                 const int* first_row, float* out, float* bpart, int* tails,
                 int n_rows, int dim, int tile, long long share,
                 long long n_blocks) {
  static bool raised[64] = {};
  auto* kernel = share_kernel<C, WB>;
  const int err = share_sum::allow_smem(
      kernel, share_sum::share_smem_bytes(C, 32 * C), raised);
  if (err != 0) return err;
  const int smem = share_sum::share_smem_bytes(C, tile);
  kernel<<<grid, kThreads, smem, s>>>(g, off, lo, first_row, out, bpart,
                                      tails, n_rows, dim, tile, share,
                                      n_blocks);
  return (int)cudaGetLastError();
}

template <int C>
int launch_width(int wb, dim3 grid, cudaStream_t s, const float* g,
                 const long long* off, const long long* lo,
                 const int* first_row, float* out, float* bpart, int* tails,
                 int n_rows, int dim, int tile, long long share,
                 long long n_blocks) {
  if (wb == 16) {
    return launch_share<C, 16>(grid, s, g, off, lo, first_row, out, bpart,
                               tails, n_rows, dim, tile, share, n_blocks);
  }
  if (wb == 8) {
    return launch_share<C, 8>(grid, s, g, off, lo, first_row, out, bpart,
                              tails, n_rows, dim, tile, share, n_blocks);
  }
  return launch_share<C, 4>(grid, s, g, off, lo, first_row, out, bpart,
                            tails, n_rows, dim, tile, share, n_blocks);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// g (n_slots, dim) float32, start and count (n_rows,) int64, out
// (n_rows, dim) float32. Scratch, as the wrapper's plan
// (ops/gather.py:_range_plan) sizes it: tsum (ceil(n_rows / 512),), off
// (n_rows + 1,) and lo (n_rows,) int64; tails (n_blocks,) and first_row
// (8 n_blocks,) int32; bpart
// (n_blocks, 2, dim) float32, with n_blocks = ceil(n_slots / (8 * sub)).
// `tile` is the columns a block of the share pass sums (at most 128), `sub`
// the list positions a warp sums, `wb` the bytes of a row-by-row copy
// piece (16, 8 or 4: g's alignment and dim allow it). Zeroes out, then
// launches the four passes on `stream` and returns cudaGetLastError() (0 =
// cudaSuccess), or cudaErrorInvalidValue for arguments it refuses:
// negative sizes, a tile past 128 columns, a `sub` that is not a positive
// multiple of 32, or a `wb` that g and dim do not allow.
extern "C" int range_sum_f32(const void* g, const void* start,
                             const void* count, void* out, void* tsum,
                             void* off, void* lo, void* tails,
                             void* first_row, void* bpart, long long n_slots,
                             int dim, int n_rows, int tile, int sub, int wb,
                             void* stream) {
  if (n_rows <= 0 || dim <= 0) return 0;
  const int kw = wb / 4;
  if (n_slots < 0 || tile <= 0 || tile > share_sum::kMaxCols || sub <= 0 ||
      sub % 32 != 0 || (wb != 4 && wb != 8 && wb != 16) || dim % kw != 0 ||
      tile % kw != 0 || (uintptr_t)g % wb != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = (cudaStream_t)stream;
  auto* o = (float*)out;
  if (n_slots == 0) {
    cudaMemsetAsync(out, 0, (size_t)n_rows * dim * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  const auto* st = (const long long*)start;
  const auto* ct = (const long long*)count;
  auto* ts = (long long*)tsum;
  auto* of = (long long*)off;
  auto* l = (long long*)lo;
  auto* tl = (int*)tails;
  const long long S = (long long)sub * kWarps;
  const long long n_blocks = (n_slots + S - 1) / S;
  auto* fr = (int*)first_row;
  const unsigned tiles = (unsigned)((n_rows + kScanRows - 1) / kScanRows);
  // no share holds an empty row: its output stays 0
  cudaMemsetAsync(out, 0, (size_t)n_rows * dim * sizeof(float), s);
  tile_kernel<<<tiles, kThreads, 0, s>>>(st, ct, ts, n_slots, n_rows);
  offsets_kernel<<<tiles, kThreads, 0, s>>>(st, ct, ts, of, l, fr, n_slots,
                                            n_rows, sub, n_blocks);
  if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  const dim3 grid((unsigned)n_blocks, (unsigned)((dim + tile - 1) / tile));
  const auto* x = (const float*)g;
  auto* bp = (float*)bpart;
  int err;
  switch ((tile + 31) / 32) {
    case 1:
      err = launch_width<1>(wb, grid, s, x, of, l, fr, o, bp, tl, n_rows,
                            dim, tile, sub, n_blocks);
      break;
    case 2:
      err = launch_width<2>(wb, grid, s, x, of, l, fr, o, bp, tl, n_rows,
                            dim, tile, sub, n_blocks);
      break;
    case 3:
      err = launch_width<3>(wb, grid, s, x, of, l, fr, o, bp, tl, n_rows,
                            dim, tile, sub, n_blocks);
      break;
    default:
      err = launch_width<4>(wb, grid, s, x, of, l, fr, o, bp, tl, n_rows,
                            dim, tile, sub, n_blocks);
  }
  if (err != 0) return err;
  share_sum::fixup_kernel<long long><<<(unsigned)n_blocks, kThreads, 0, s>>>(
      of, bp, tl, o, n_rows, S, n_blocks, dim);
  return (int)cudaGetLastError();
}
