// Listed-row sum on Hopper (sm_90a): the backward of the dense hop's
// packed-row gather.
//
// Replaces: the backward of `packed[tsrc]` in redgnn_tpu/models/layers.py
// (`RelAttnLayer.dense`, `:176`) and redgnn_tpu/models/temporal.py
// (`TRedGNN._dense_hop`, `:484`), a plain gather that XLA differentiates
// into a scatter-add, and not a Pallas kernel. It computes, for a list of
// positions laid out in rows (row v holds positions [off[v], off[v + 1]))
// and a permutation `order` that names each position's slot of g,
//     out[v, :] = sum of g[order[t], :] over t in [off[v], off[v + 1]),
// so a row with no positions is 0. The dense hop's list is the stable
// order of the tail-sorted table's sources (graph/kg.py:build_src_order)
// and its rows are the CSR's own `rowptr`: the edges of source v, in edge
// order. Sums are fp32, without float atomics, in one fixed order that
// depends on the inputs and the wrapper's plan (a function of shapes)
// alone: the same bits run to run and card to card.
//
// What bounds it: bytes. Each listed slot's row is read once and each
// output row written once, T*W*4 + N*W*4 (+ T*4 + N*4 for order and off)
// bytes for T positions of W floats into N rows, against T*W fp32 adds:
// the adds are two orders of magnitude below the memory time.
//
// Design: share_sum.cuh's slot-balanced pass, the list given.
//  * The output is zeroed first (a memset on the stream): no share holds
//    an empty row. No scan pass: `off` is the list's row starts.
//  * share_kernel: share_sum::sum_share over the list. Each warp finds the
//    row of its sub-share's first position by one 32-ary search in off
//    (lanes probe 32 points, a ballot counts those at or below it), then
//    walks from there: a round's rows come from one load of the 32 row
//    starts after the current row and a ballot a position, as in
//    range_sum.cu, and its slots from order. A source's edges lie
//    scattered over the tail-sorted table, so slots rarely run on and a
//    round copies row by row, in 16-byte pieces where W and g's alignment
//    allow (W = 672 and 980 on the dense hops do). A 10^3-edge hub is
//    spread over its shares' warps and blocks like any other row.
//  * Wide rows take the grid's second dimension in column tiles of up to
//    kMaxCols (128) columns: 6 tiles at W = 672, 8 at W = 980, the last
//    partial.
//  * share_sum::fixup_kernel adds the block partials of rows that cross
//    shares, in block order.

#include "share_sum.cuh"

namespace {

using share_sum::kFull;
using share_sum::kThreads;
using share_sum::kWarps;

// The last v in [0, n_rows) with off[v] <= a (off[0] = 0 <= a < off[n_rows]):
// the row that holds position a. Called by a whole warp; every lane gets it.
__device__ __forceinline__ long long row_of(const int* __restrict__ off,
                                            int n_rows, long long a) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n_rows - 1;  // off[lo] <= a; the row is at or below hi
  while (lo < hi) {
    const long long step = (hi - lo + 32) / 32;
    const long long v = lo + (long long)lane * step;
    const bool le = v <= hi && off[v] <= a;
    const int c = __popc(__ballot_sync(kFull, le));  // lane 0 probes lo
    lo += (long long)(c - 1) * step;
    hi = lo + step - 1 < hi ? lo + step - 1 : hi;
  }
  return lo;
}

template <int C, int WB>
__global__ void __launch_bounds__(kThreads, 4)
share_kernel(const float* __restrict__ g, const int* __restrict__ order,
             const int* __restrict__ off, float* __restrict__ out,
             float* __restrict__ bpart, int* __restrict__ tails, int n_rows,
             int dim, int tile, long long sub) {
  constexpr int B = share_sum::batch_rows(C);
  constexpr int K = share_sum::lane_positions(C);
  extern __shared__ __align__(16) float stage[];
  const long long S = sub * kWarps;
  const long long blk = blockIdx.x;
  const int c0 = blockIdx.y * tile;
  const int tw = min(tile, dim - c0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0 && blockIdx.y == 0) tails[blk] = -1;
  const long long total = off[n_rows];
  const long long s0 = blk * S;
  if (s0 >= total) return;
  const long long s1 = s0 + S < total ? s0 + S : total;
  const long long a = s0 + w * sub < s1 ? s0 + w * sub : s1;
  const long long b = a + sub < s1 ? a + sub : s1;
  // vb: the row of the next position to locate; base: off[vb]; next_end:
  // off[r + 1] of the last position located
  long long vb = 0, base = 0, next_end = 0;
  if (a < b) {
    vb = row_of(off, n_rows, a);
    base = off[vb];
  }
  const long long base_a = base;  // off of the row of position a
  // Lane l's positions t = t0 + l + 32 j: their row is vb plus the number
  // of row starts in (vb, t]. Lane i loads off[wb + 1 + i] (a window of 32
  // row starts) and a ballot a position counts those at or below it; a
  // window that ends before a position moves on by 32 rows.
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
    // the slots first: their loads do not wait on the rows
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = lane + 32 * j;
      slot[j] = p < nb ? (long long)order[t0 + p] : 0;
    }
    long long w_off = base;  // off[wb]
    for (long long wb = vb;; wb += 32) {
      const long long jj = wb + 1 + lane;
      const long long oj = jj <= n_rows ? (long long)off[jj] : LLONG_MAX;
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
    for (int j = 0; j < K; ++j) row[j] = (int)r[j];
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
int launch_share(dim3 grid, cudaStream_t s, const float* g, const int* order,
                 const int* off, float* out, float* bpart, int* tails,
                 int n_rows, int dim, int tile, long long sub) {
  static bool raised[64] = {};
  auto* kernel = share_kernel<C, WB>;
  const int err = share_sum::allow_smem(
      kernel, share_sum::share_smem_bytes(C, 32 * C), raised);
  if (err != 0) return err;
  const int smem = share_sum::share_smem_bytes(C, tile);
  kernel<<<grid, kThreads, smem, s>>>(g, order, off, out, bpart, tails,
                                      n_rows, dim, tile, sub);
  return (int)cudaGetLastError();
}

template <int C>
int launch_width(int wb, dim3 grid, cudaStream_t s, const float* g,
                 const int* order, const int* off, float* out, float* bpart,
                 int* tails, int n_rows, int dim, int tile, long long sub) {
  if (wb == 16) {
    return launch_share<C, 16>(grid, s, g, order, off, out, bpart, tails,
                               n_rows, dim, tile, sub);
  }
  if (wb == 8) {
    return launch_share<C, 8>(grid, s, g, order, off, out, bpart, tails,
                              n_rows, dim, tile, sub);
  }
  return launch_share<C, 4>(grid, s, g, order, off, out, bpart, tails,
                            n_rows, dim, tile, sub);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// g (n_slots, dim) float32; order (n_slots,) int32, each position's slot
// of g; off (n_rows + 1,) int32, the rows' first positions, with off[0] =
// 0 and off[n_rows] <= n_slots; out (n_rows, dim) float32. Scratch, as the
// wrapper's plan (ops/gather.py:_list_plan) sizes it: tails (n_blocks,)
// int32 and bpart (n_blocks, 2, dim) float32, with n_blocks =
// ceil(n_slots / (8 * sub)). `tile` is the columns a block of the share
// pass sums (at most 128), `sub` the list positions a warp sums, `wb` the
// bytes of a row-by-row copy piece (16, 8 or 4: g's alignment and dim
// allow it). Zeroes out, then launches the two passes on `stream` and
// returns cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue
// for arguments it refuses: negative sizes, 2^31 slots or more, a tile
// past 128 columns, a `sub` that is not a positive multiple of 32, or a
// `wb` that g and dim do not allow.
extern "C" int list_sum_f32(const void* g, const void* order, const void* off,
                            void* out, void* tails, void* bpart,
                            long long n_slots, int dim, int n_rows, int tile,
                            int sub, int wb, void* stream) {
  if (n_rows <= 0 || dim <= 0) return 0;
  const int kw = wb / 4;
  if (n_slots < 0 || n_slots > INT_MAX || tile <= 0 ||
      tile > share_sum::kMaxCols || sub <= 0 || sub % 32 != 0 ||
      (wb != 4 && wb != 8 && wb != 16) || dim % kw != 0 || tile % kw != 0 ||
      (uintptr_t)g % wb != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = (cudaStream_t)stream;
  // no share holds an empty row: its output stays 0
  cudaMemsetAsync(out, 0, (size_t)n_rows * dim * sizeof(float), s);
  if (n_slots == 0) return (int)cudaGetLastError();
  const long long S = (long long)sub * kWarps;
  const long long n_blocks = (n_slots + S - 1) / S;
  const dim3 grid((unsigned)n_blocks, (unsigned)((dim + tile - 1) / tile));
  const auto* x = (const float*)g;
  const auto* od = (const int*)order;
  const auto* of = (const int*)off;
  auto* o = (float*)out;
  auto* bp = (float*)bpart;
  auto* tl = (int*)tails;
  int err;
  switch ((tile + 31) / 32) {
    case 1:
      err = launch_width<1>(wb, grid, s, x, od, of, o, bp, tl, n_rows, dim,
                            tile, sub);
      break;
    case 2:
      err = launch_width<2>(wb, grid, s, x, od, of, o, bp, tl, n_rows, dim,
                            tile, sub);
      break;
    case 3:
      err = launch_width<3>(wb, grid, s, x, od, of, o, bp, tl, n_rows, dim,
                            tile, sub);
      break;
    default:
      err = launch_width<4>(wb, grid, s, x, od, of, o, bp, tl, n_rows, dim,
                            tile, sub);
  }
  if (err != 0) return err;
  share_sum::fixup_kernel<int><<<(unsigned)n_blocks, kThreads, 0, s>>>(
      of, bp, tl, o, n_rows, S, n_blocks, dim);
  return (int)cudaGetLastError();
}
