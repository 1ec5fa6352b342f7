// Deterministic small-table scatter-add on Hopper (sm_90a): the backward of
// take_rows above the one-hot budget.
//
// Replaces: the over-budget branch of take_rows' custom VJP `_bwd` in
// redgnn_tpu/ops/gather.py (`:41-55`, `jax.ops.segment_sum`), a
// jax.custom_vjp and not a Pallas kernel. It computes
//     out[r, :] = sum of g[e, :] over e with idx[e] == r,
// for a flat, unsorted idx over a table of R rows and D columns; ids
// outside [0, R) are dropped. Sums are fp32, without float atomics, in one
// fixed order that depends on no property of the card (the chunk size is
// a function of R alone): the same bits run to run and card to card.
//
// What bounds it: bytes. Each slot's row of g and its id are read once,
// each block's partial table written once and read back once, and the
// output written once: E*D*4 + E*id_bytes + chunks*R*D*8 + R*D*4 bytes.
//
// Design (ROADMAP queue 2, item 2):
//  * Pass 1: block x owns the contiguous chunk of ids
//    [x * chunk, (x + 1) * chunk) and builds a partial R x tile table in
//    shared memory (462 x 30 fp32 is 55 KB). Warp w of W owns the table
//    rows r with r % W == w and lane l the columns l, l + 32, ... of the
//    tile, so every (r, d) cell is updated by one thread only, in slot
//    order. Each warp reads kStep ids at a time (coalesced), queues its
//    own in slot order in shared memory (a ballot and a popcount), then
//    loads their rows 16 / C at a time (C columns a lane) ahead of the
//    adds. A run of equal ids is added in registers and goes to shared
//    memory once.
//  * Tables too wide for shared memory tile their columns over the
//    grid's second dimension (the wrapper picks the tile).
//  * Pass 2: each (r, d) cell adds the chunks' partial tables in a fixed
//    order (eight contiguous groups of chunks, each in chunk order, then
//    the groups in order).
//  * W = 8 warps a block, 4 for tables under 128 rows: those are the
//    batch tables, whose ids come sorted, so one warp of a block is busy
//    and smaller blocks put more busy warps on each SM. W changes no sum's
//    order.
//  * The chunk is the power of two at or above 2 R, within [1024, 65536]
//    (the wrapper's plan): a small chunk gives many blocks, and with them
//    many warps on a hot row (the relation tables' ids are skewed: one
//    relation held 23% of a hop's ids on the forecasting model), at the
//    price of partial tables as large as g at R = 462. chip_smoke.py
//    (phase 7g) times the other rules, 16 R to R, at the forecasting
//    model's last training hop.
//
// Left for later: a row that holds most ids (the sorted batch table) is
// summed by one warp of each block; splitting a hot row over the block's
// warps (then a fixed-order add) would put eight times the loads in flight.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // the second pass's warps; the first pass's W
constexpr int kThreads = kWarps * 32;
constexpr int kSmallTable = 128;  // fewer rows: W = 4 warps a block
constexpr int kStep = 256;  // ids a warp reads per step: 8 per lane
constexpr int kMaxCols = 128;  // columns a tile may have: 4 per lane
// Bytes the partial table may take in shared memory (the card's 227 KB
// block maximum, less the queue and headroom).
constexpr int kMaxTableBytes = 200 * 1024;

// W: warps a block; C: columns a lane owns in the tile (tile <= 32 C); B:
// rows a warp loads ahead of its adds; I: the id type (int or long long).
template <int W, int C, int B, typename I>
__global__ void __launch_bounds__(W * 32)
scatter_partial_kernel(const float* __restrict__ g, const I* __restrict__ idx,
                       float* __restrict__ part, long long n, int rows,
                       int dim, int tile, int chunk) {
  extern __shared__ float table[];  // rows x tw
  // the warp's queue of ids for this step: slot offset << 16 | row
  __shared__ unsigned queue[W][kStep];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.y * tile;  // the tile's first column
  const int tw = min(tile, dim - c0);
  for (int i = tid; i < rows * tw; i += W * 32) table[i] = 0.f;
  __syncthreads();

  const long long e0 = (long long)blockIdx.x * chunk;
  const long long e1 = min(e0 + chunk, n);
  bool on[C];
#pragma unroll
  for (int c = 0; c < C; ++c) on[c] = lane + 32 * c < tw;
  int cur = -1;  // the row whose run `acc` holds
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (long long base = e0; base < e1; base += kStep) {
    int n_q = 0;
#pragma unroll
    for (int k = 0; k < kStep / 32; ++k) {
      const long long e = base + 32 * k + lane;
      const I id = e < e1 ? idx[e] : (I)-1;
      const bool mine = id >= 0 && id < (I)rows && (int)id % W == warp;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) {
        const int at = n_q + __popc(m & ((1u << lane) - 1u));
        queue[warp][at] = ((unsigned)(32 * k + lane) << 16) | (unsigned)id;
      }
      n_q += __popc(m);
    }
    __syncwarp();
    for (int q = 0; q < n_q; q += B) {
      int rid[B];
      float v[B][C];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        rid[b] = -1;
        if (q + b < n_q) {
          const unsigned word = queue[warp][q + b];
          rid[b] = (int)(word & 0xffffu);
          const float* row = g + (base + (word >> 16)) * dim + c0;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            v[b][c] = on[c] ? __ldg(row + lane + 32 * c) : 0.f;
          }
        }
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (rid[b] >= 0) {
          if (rid[b] != cur) {  // the run ends: back to shared memory
            if (cur >= 0) {
#pragma unroll
              for (int c = 0; c < C; ++c) {
                if (on[c]) table[cur * tw + lane + 32 * c] = acc[c];
              }
            }
            cur = rid[b];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              acc[c] = on[c] ? table[cur * tw + lane + 32 * c] : 0.f;
            }
          }
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += v[b][c];
        }
      }
    }
    __syncwarp();  // the next step rewrites the queue
  }
  if (cur >= 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (on[c]) table[cur * tw + lane + 32 * c] = acc[c];
    }
  }
  __syncthreads();
  float* dst = part + (long long)blockIdx.x * rows * dim + c0;
  for (int i = tid; i < rows * tw; i += W * 32) {
    const int r = i / tw, col = i - r * tw;
    dst[(long long)r * dim + col] = table[i];
  }
}

// out[i] = the chunks' partial tables added in a fixed order: a block
// takes 32 consecutive cells (one a lane), warp w adds the chunks of its
// contiguous share in chunk order, and the warps' sums are added in warp
// order. The order depends on the chunk count alone.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int n_chunks, long long cells) {
  constexpr int kAhead = 16;  // loads a lane keeps in flight
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * 32 + lane;
  const int per = (n_chunks + kWarps - 1) / kWarps;
  const int k1 = min((warp + 1) * per, n_chunks);
  float s = 0.f;
  if (i < cells) {
    int k = warp * per;
    for (; k + kAhead <= k1; k += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) v[u] = part[(k + u) * cells + i];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) s += v[u];
    }
    for (; k < k1; ++k) s += part[k * cells + i];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < cells) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += red[w][lane];
    out[i] = t;
  }
}

template <int W, int C, typename I>
int launch(dim3 grid, cudaStream_t stream, const float* g, const I* idx,
           float* part, long long n, int rows, int dim, int tile,
           int chunk) {
  constexpr int B = 16 / C;
  auto* kernel = scatter_partial_kernel<W, C, B, I>;
  const int smem = rows * (tile < dim ? tile : dim) * (int)sizeof(float);
  // raised once per instantiation and device (not a stream operation, so
  // a CUDA graph's capture never meets it after a first eager call)
  static bool raised[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (smem > 48 * 1024 && (device >= 64 || !raised[device])) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxTableBytes);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) raised[device] = true;
  }
  kernel<<<grid, W * 32, smem, stream>>>(g, idx, part, n, rows, dim, tile,
                                         chunk);
  return (int)cudaGetLastError();
}

template <int W, typename I>
int launch_cols(dim3 grid, cudaStream_t stream, const float* g, const I* idx,
                float* part, long long n, int rows, int dim, int tile,
                int chunk) {
  switch (((tile < dim ? tile : dim) + 31) / 32) {
    case 1:
      return launch<W, 1, I>(grid, stream, g, idx, part, n, rows, dim, tile,
                             chunk);
    case 2:
      return launch<W, 2, I>(grid, stream, g, idx, part, n, rows, dim, tile,
                             chunk);
    case 3:
      return launch<W, 3, I>(grid, stream, g, idx, part, n, rows, dim, tile,
                             chunk);
    default:
      return launch<W, 4, I>(grid, stream, g, idx, part, n, rows, dim, tile,
                             chunk);
  }
}

template <typename I>
int launch_ids(dim3 grid, cudaStream_t stream, const float* g, const I* idx,
               float* part, long long n, int rows, int dim, int tile,
               int chunk) {
  if (rows < kSmallTable) {
    return launch_cols<4, I>(grid, stream, g, idx, part, n, rows, dim, tile,
                             chunk);
  }
  return launch_cols<8, I>(grid, stream, g, idx, part, n, rows, dim, tile,
                           chunk);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// g (n, dim) float32; idx (n,) int32 (idx64 = 0) or int64 (idx64 = 1);
// part (ceil(n / chunk), rows, dim) float32 scratch; out (rows, dim)
// float32. `tile` (columns per block, at most 128) and `chunk` (ids per
// block) are the wrapper's plan (ops/gather.py:_scatter_plan). Launches
// both passes on `stream` and returns cudaGetLastError() (0 =
// cudaSuccess), or cudaErrorInvalidValue for arguments it refuses: a
// table of more than 65,535 rows (the queue packs a row in 16 bits), a
// tile whose rows x tile table passes kMaxTableBytes, a chunk that is not
// a positive multiple of kStep, or more than INT_MAX chunks.
extern "C" int take_rows_grad_f32(const void* g, const void* idx, int idx64,
                                  void* part, void* out, long long n,
                                  int rows, int dim, int tile, int chunk,
                                  void* stream) {
  if (rows <= 0 || dim <= 0) return 0;
  const int tw = tile < dim ? tile : dim;
  if (n < 0 || rows > 0xffff || tile <= 0 || tile > kMaxCols ||
      (long long)rows * tw * 4 > kMaxTableBytes || chunk <= 0 ||
      chunk % kStep != 0 || (n + chunk - 1) / chunk > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = (cudaStream_t)stream;
  const long long cells = (long long)rows * dim;
  if (n == 0) {
    cudaMemsetAsync(out, 0, cells * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  const int n_chunks = (int)((n + chunk - 1) / chunk);
  const dim3 grid((unsigned)n_chunks, (unsigned)((dim + tile - 1) / tile));
  const auto* x = (const float*)g;
  auto* p = (float*)part;
  const int err =
      idx64 ? launch_ids(grid, s, x, (const long long*)idx, p, n, rows, dim,
                         tile, chunk)
            : launch_ids(grid, s, x, (const int*)idx, p, n, rows, dim, tile,
                         chunk);
  if (err != 0) return err;
  sum_partials_kernel<<<(unsigned)((cells + 31) / 32), kThreads, 0, s>>>(
      p, (float*)out, n_chunks, cells);
  return (int)cudaGetLastError();
}
