// Deterministic scatter-add on Hopper (sm_90a): the backward of take_rows
// above the one-hot budget.
//
// Replaces: the over-budget branch of take_rows' custom VJP `_bwd` in
// redgnn_tpu/ops/gather.py (`:41-55`, `jax.ops.segment_sum`), a
// jax.custom_vjp and not a Pallas kernel. It computes
//     out[r, :] = sum of g[e, :] over e with idx[e] == r,
// for a flat, unsorted idx over a table of R rows and D columns; ids
// outside [0, R) are dropped. Sums are fp32, without float atomics, in one
// fixed order that depends on the inputs and the wrapper's plan (a function
// of shapes) alone: the same bits run to run and card to card.
//
// What bounds it: bytes. The bound counts g and the ids read once and the
// table written once, E*D*4 + E*id_bytes + R*D*4. This design moves g once,
// the ids twice, the sorted list (8 bytes a slot) once each way, and small
// count tables: E*(4D + 2 id_bytes + 16) + R*D*4 bytes, 1.2x the bound at
// D = 30 with int64 ids.
//
// Design: a stable counting sort of the slots by id, then the slot-balanced
// sum of share_sum.cuh over the sorted list.
//  1. count_kernel: block x counts the ids of chunk x (kChunk consecutive
//     slots, 16 a lane, all loaded before the first is used) per row in
//     shared memory (integer atomics: a count is the same in any order)
//     and writes column x of the (R, chunks) count table.
//  2. scan_kernel: one warp a row scans its counts over the chunks in place
//     (exclusive) and writes the row's total; an empty row's output is
//     zeroed here.
//  3. place_kernel: block x scans the R totals (each row's first place in
//     the sorted list; block 0 writes them, `rowstart`), adds its chunk's
//     prefix, and gives each of its warps the place of its first id of
//     each row (the warps' counts, added in warp order). Each warp then
//     walks its ids (held in registers since the counts) in slot order:
//     __match_any_sync finds the lanes with its id, the rank among them is
//     the popcount of the lower ones, and sorted[place + rank] = (slot,
//     row). Chunks, warps, steps and lanes are taken in slot order, so the
//     list is exactly the stable sort (torch.sort(idx, stable=True)) of
//     the valid ids; no atomic decides a place.
//  4. share_kernel: share_sum::sum_share over the list: each block an
//     equal, fixed-size share of the sorted slots, so a row
//     that holds most ids (one relation held 38-70% of a training hop's
//     ids on the forecasting model; a sorted batch table puts its ids in a
//     few long runs) is spread over many blocks and warps. Rows of g come
//     through the list (16-byte pieces where the slots run on: sorted ids).
//  5. share_sum::fixup_kernel adds the block partials of rows that cross
//     shares, in block order.
// The table is never held in shared memory, so its size bounds only the
// count tables: R <= kMaxRows (8 warps' counts of R rows, 128 KB, in
// place_kernel's shared memory).

#include "share_sum.cuh"

namespace {

using share_sum::kFull;
using share_sum::kThreads;
using share_sum::kWarps;

constexpr int kMaxRows = 4096;
constexpr int kChunk = 4096;                  // ids a block of the sort passes
constexpr int kIdsPerLane = kChunk / kThreads;  // 16: loaded up front

template <typename I>
__device__ __forceinline__ int row_of(const I* __restrict__ idx, long long e,
                                      long long n, int rows) {
  const I id = e < n ? idx[e] : (I)-1;
  return id >= 0 && id < (I)rows ? (int)id : -1;
}

// The rows of this warp's ids in the chunk, slot order: lane l, step k
// holds slot e0 + w * 512 + 32 k + l (all loads issued before any use).
template <typename I>
__device__ __forceinline__ void load_rows(const I* __restrict__ idx,
                                          long long e0, long long n, int rows,
                                          int (&key)[kIdsPerLane]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long base = e0 + (long long)w * 32 * kIdsPerLane + lane;
#pragma unroll
  for (int k = 0; k < kIdsPerLane; ++k) {
    key[k] = row_of(idx, base + 32 * k, n, rows);
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
count_kernel(const I* __restrict__ idx, int* __restrict__ counts, long long n,
             int rows, int n_chunks) {
  extern __shared__ int hist[];  // rows
  const int tid = threadIdx.x;
  int key[kIdsPerLane];
  load_rows(idx, (long long)blockIdx.x * kChunk, n, rows, key);
  for (int r = tid; r < rows; r += kThreads) hist[r] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kIdsPerLane; ++k) {
    if (key[k] >= 0) atomicAdd(&hist[key[k]], 1);
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) {
    counts[(long long)r * n_chunks + blockIdx.x] = hist[r];
  }
}

// One warp a row: exclusive scan of its counts over the chunks, in place
// (lane l a contiguous piece); its total; an empty row's output zeroed.
__global__ void __launch_bounds__(kThreads)
scan_kernel(int* __restrict__ counts, int* __restrict__ totals,
            float* __restrict__ out, int rows, int n_chunks, int dim) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  int* c = counts + (long long)row * n_chunks;
  const int per = (n_chunks + 31) / 32;
  const int k0 = min(lane * per, n_chunks), k1 = min(k0 + per, n_chunks);
  int sum = 0;
  for (int k = k0; k < k1; ++k) sum += c[k];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int run = incl - sum;
  for (int k = k0; k < k1; ++k) {
    const int v = c[k];
    c[k] = run;
    run += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  if (lane == 0) totals[row] = total;
  if (total == 0) {
    for (int col = lane; col < dim; col += 32) {
      out[(long long)row * dim + col] = 0.f;
    }
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
place_kernel(const I* __restrict__ idx, const int* __restrict__ counts,
             const int* __restrict__ totals, int* __restrict__ rowstart,
             int2* __restrict__ sorted, long long n, int rows, int n_chunks) {
  extern __shared__ int smem[];
  int* hist = smem;                   // kWarps x rows: a warp's next place
  int* start = smem + kWarps * rows;  // rows + 1: rowstart
  __shared__ int wsum[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long e0 = (long long)blockIdx.x * kChunk;
  int key[kIdsPerLane];
  load_rows(idx, e0, n, rows, key);
  for (int i = tid; i < kWarps * rows; i += kThreads) hist[i] = 0;

  // rowstart: exclusive scan of the totals, each thread a run of `per`
  const int per = (rows + kThreads - 1) / kThreads;
  const int i0 = min(tid * per, rows), i1 = min(i0 + per, rows);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += totals[i];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  int before = 0;
  for (int k = 0; k < w; ++k) before += wsum[k];
  int run = before + incl - sum;
  for (int i = i0; i < i1; ++i) {
    start[i] = run;
    run += totals[i];
  }
  if (tid == kThreads - 1) start[rows] = before + incl;

  // each warp's counts of its 512 ids
  int* mine = hist + w * rows;
#pragma unroll
  for (int k = 0; k < kIdsPerLane; ++k) {
    if (key[k] >= 0) atomicAdd(&mine[key[k]], 1);
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int r = tid; r <= rows; r += kThreads) rowstart[r] = start[r];
  }
  // a warp's first place for row r: rowstart + the chunk's prefix + the
  // earlier warps' counts
  for (int r = tid; r < rows; r += kThreads) {
    int b = start[r] + counts[(long long)r * n_chunks + blockIdx.x];
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int t = hist[k * rows + r];
      hist[k * rows + r] = b;
      b += t;
    }
  }
  __syncthreads();
  const long long base = e0 + (long long)w * 32 * kIdsPerLane + lane;
#pragma unroll
  for (int k = 0; k < kIdsPerLane; ++k) {
    const unsigned peers = __match_any_sync(kFull, key[k]);
    if (key[k] >= 0) {
      const int place = mine[key[k]] + __popc(peers & ((1u << lane) - 1u));
      sorted[place] = make_int2((int)(base + 32 * k), key[k]);
    }
    __syncwarp();
    if (key[k] >= 0 && lane == __ffs(peers) - 1) {
      mine[key[k]] += __popc(peers);
    }
    __syncwarp();
  }
}

template <int C, int WB>
__global__ void __launch_bounds__(kThreads, 4)
share_kernel(const float* __restrict__ g, const int2* __restrict__ sorted,
             const int* __restrict__ rowstart, float* __restrict__ out,
             float* __restrict__ bpart, int* __restrict__ tails, int rows,
             int dim, int tile, long long sub) {
  constexpr int K = share_sum::lane_positions(C);
  extern __shared__ __align__(16) float stage[];
  const long long S = sub * kWarps;
  const long long blk = blockIdx.x;
  const int c0 = blockIdx.y * tile;
  const int tw = min(tile, dim - c0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0 && blockIdx.y == 0) tails[blk] = -1;
  const long long total = rowstart[rows];
  const long long s0 = blk * S;
  if (s0 >= total) return;
  const long long s1 = s0 + S < total ? s0 + S : total;
  const long long a = s0 + w * sub < s1 ? s0 + w * sub : s1;
  const long long b = a + sub < s1 ? a + sub : s1;
  // the rows next to the warp's part of the sorted list
  const int prev_row = a > 0 && a < b ? sorted[a - 1].y : -1;
  const int next_row = b < total && a < b ? sorted[b].y : -1;
  auto locate = [&](long long t0, int nb, long long (&slot)[K],
                    int (&row)[K]) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = lane + 32 * j;
      const int2 v = p < nb ? sorted[t0 + p] : make_int2(0, -1);
      slot[j] = v.x;
      row[j] = v.y;
    }
  };
  auto began_before = [&](int r) { return r == prev_row; };
  auto goes_past = [&](int r) { return r == next_row; };
  share_sum::sum_share<C, WB>(g, out, bpart, tails, a, b, dim, c0, tw, blk,
                              stage, locate, began_before, goes_past);
}

template <int C, int WB>
int launch_share(dim3 grid, cudaStream_t s, const float* g, const int2* sorted,
                 const int* rowstart, float* out, float* bpart, int* tails,
                 int rows, int dim, int tile, long long sub) {
  static bool raised[64] = {};
  auto* kernel = share_kernel<C, WB>;
  const int err = share_sum::allow_smem(
      kernel, share_sum::share_smem_bytes(C, 32 * C), raised);
  if (err != 0) return err;
  const int smem = share_sum::share_smem_bytes(C, tile);
  kernel<<<grid, kThreads, smem, s>>>(g, sorted, rowstart, out, bpart, tails,
                                      rows, dim, tile, sub);
  return (int)cudaGetLastError();
}

template <int C>
int launch_width(int wb, dim3 grid, cudaStream_t s, const float* g,
                 const int2* sorted, const int* rowstart, float* out,
                 float* bpart, int* tails, int rows, int dim, int tile,
                 long long sub) {
  if (wb == 16) {
    return launch_share<C, 16>(grid, s, g, sorted, rowstart, out, bpart,
                               tails, rows, dim, tile, sub);
  }
  if (wb == 8) {
    return launch_share<C, 8>(grid, s, g, sorted, rowstart, out, bpart,
                              tails, rows, dim, tile, sub);
  }
  return launch_share<C, 4>(grid, s, g, sorted, rowstart, out, bpart, tails,
                            rows, dim, tile, sub);
}

// place_kernel's dynamic shared memory at `rows` table rows
constexpr int place_smem(int rows) {
  return (kWarps * rows + rows + 1) * (int)sizeof(int);
}

template <typename I>
int sort_ids(cudaStream_t s, const I* idx, int* counts, int* totals,
             int* rowstart, int2* sorted, float* out, long long n, int rows,
             int dim, int n_chunks) {
  count_kernel<I><<<n_chunks, kThreads, rows * (int)sizeof(int), s>>>(
      idx, counts, n, rows, n_chunks);
  scan_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      counts, totals, out, rows, n_chunks, dim);
  if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  static bool raised[64] = {};
  auto* place = place_kernel<I>;
  const int err = share_sum::allow_smem(place, place_smem(kMaxRows), raised);
  if (err != 0) return err;
  place<<<n_chunks, kThreads, place_smem(rows), s>>>(
      idx, counts, totals, rowstart, sorted, n, rows, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// g (n, dim) float32; idx (n,) int32 (idx64 = 0) or int64 (idx64 = 1);
// out (rows, dim) float32. Scratch, as the wrapper's plan
// (ops/gather.py:_scatter_plan) sizes it: sorted (n,) int2, counts
// (rows, n_chunks) int32, totals (rows,) and rowstart (rows + 1,) int32,
// tails (n_blocks,) int32 and bpart (n_blocks, 2, dim) float32, with
// n_chunks = ceil(n / chunk) and n_blocks = ceil(n / (8 * sub)). `tile` is
// the columns a block of the share pass sums (at most 128), `chunk` the
// ids a block of the sort passes reads (kChunk), `sub` the sorted slots a
// warp sums,
// `wb` the bytes of a row-by-row copy piece (16, 8 or 4: g's alignment
// and dim allow it). Launches the five passes on `stream` and returns
// cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue for
// arguments it refuses: more than kMaxRows rows, more than INT_MAX ids, a
// tile past 128 columns, a chunk other than kChunk, a `sub` that is not a
// positive multiple of 32, or a `wb` that g and dim do not allow.
extern "C" int take_rows_grad_f32(const void* g, const void* idx, int idx64,
                                  void* sorted, void* counts, void* totals,
                                  void* rowstart, void* tails, void* bpart,
                                  void* out, long long n, int rows, int dim,
                                  int tile, int chunk, int sub, int wb,
                                  void* stream) {
  if (rows <= 0 || dim <= 0) return 0;
  const int kw = wb / 4;
  if (n < 0 || n > INT_MAX || rows > kMaxRows || tile <= 0 ||
      tile > share_sum::kMaxCols || chunk != kChunk ||
      sub <= 0 || sub % 32 != 0 || (wb != 4 && wb != 8 && wb != 16) ||
      dim % kw != 0 || tile % kw != 0 || (uintptr_t)g % wb != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = (cudaStream_t)stream;
  auto* o = (float*)out;
  if (n == 0) {
    cudaMemsetAsync(out, 0, (size_t)rows * dim * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  const int n_chunks = (int)((n + chunk - 1) / chunk);
  auto* srt = (int2*)sorted;
  auto* cnt = (int*)counts;
  auto* tot = (int*)totals;
  auto* rs = (int*)rowstart;
  int err = idx64 ? sort_ids(s, (const long long*)idx, cnt, tot, rs, srt, o,
                             n, rows, dim, n_chunks)
                  : sort_ids(s, (const int*)idx, cnt, tot, rs, srt, o, n,
                             rows, dim, n_chunks);
  if (err != 0) return err;
  const long long S = (long long)sub * kWarps;
  const long long n_blocks = (n + S - 1) / S;
  const dim3 grid((unsigned)n_blocks, (unsigned)((dim + tile - 1) / tile));
  const auto* x = (const float*)g;
  auto* bp = (float*)bpart;
  auto* tl = (int*)tails;
  switch ((tile + 31) / 32) {
    case 1:
      err = launch_width<1>(wb, grid, s, x, srt, rs, o, bp, tl, rows, dim,
                            tile, sub);
      break;
    case 2:
      err = launch_width<2>(wb, grid, s, x, srt, rs, o, bp, tl, rows, dim,
                            tile, sub);
      break;
    case 3:
      err = launch_width<3>(wb, grid, s, x, srt, rs, o, bp, tl, rows, dim,
                            tile, sub);
      break;
    default:
      err = launch_width<4>(wb, grid, s, x, srt, rs, o, bp, tl, rows, dim,
                            tile, sub);
  }
  if (err != 0) return err;
  share_sum::fixup_kernel<int><<<(unsigned)n_blocks, kThreads, 0, s>>>(
      rs, bp, tl, o, rows, S, n_blocks, dim);
  return (int)cudaGetLastError();
}
