// Exact range sum on Hopper (sm_90a): the backward of gather_rows_packed.
//
// Replaces: the custom VJP `_gp_bwd` of redgnn_tpu/ops/gather.py
// (gather_rows_packed, `:174-183`), a jax.custom_vjp and not a Pallas
// kernel. It computes, for every row v of a table of P rows,
//     out[v, :] = sum of g[e, :] over e in [start[v], start[v] + count[v])
//                 intersected with [0, E),
// so a row with count <= 0 is 0, a range cut by E is a partial sum and a
// row with start >= E is 0 (`_gp_bwd`'s clipping). The JAX package and the
// port's CPU path take the difference of a float32 prefix sum of g, which
// cancels large partial sums (noise of O(E u sum|g|)); this kernel adds each
// range's own rows and nothing else. Sums are fp32, without float atomics,
// in one fixed order that depends on no property of the card: the same
// bits run to run and card to card.
//
// What bounds it: bytes. Each slot's row of g is read once and each output
// row written once, E*D*4 + P*D*4 (+ P*16 for start and count) bytes,
// against E*D fp32 adds; at 3.35 TB/s and 67 TFLOP/s the adds are two
// orders of magnitude below the memory time.
//
// Design (from the sorted-segment kernel, segment_sum_sorted.cu, without
// its searches: the ranges are given, so no id pass is needed):
//  * A block owns kRows = 32 consecutive rows. One warp reads their start
//    and count, clips each range to [0, E) and scans the lengths: row j's
//    slots are laid end to end at off[j] in a virtual list of the block's
//    slots. Ranges need not be ascending or disjoint for this (the
//    frontier's are both).
//  * Work is split by slots, not rows: each worker (G lanes) takes an
//    equal contiguous share of the block's virtual list and sums runs in
//    order, A rows of loads ahead of its adds. A row wholly inside
//    a share is written by its worker; a worker's at most two boundary
//    partials go to shared memory and are added in worker order after a
//    barrier. A hub range of 10^5 slots is spread over the block's 16 to 64
//    workers, not walked by one warp; it still stays in one block (left
//    for later: spreading it over blocks with a fix-up pass).
//  * 16-byte loads when D % 4 == 0 and g is 16-byte aligned (the wrapper
//    decides, `vec`): G = 4 lanes x 3 float4 for D <= 48, G = 8 past that.
//    Other D (D = 30 on the forecasting model) take 4-byte loads: for
//    D <= 32 a worker is G = 8 lanes x 4 floats with 8 rows ahead (32
//    workers a block; a block that owns a range of thousands of slots is
//    bound by its workers' chains of dependent loads, so more workers with
//    more loads in flight pay: timed on the H100 against 16 lanes x 2
//    floats with 4 rows ahead, it was faster at every hop of the
//    forecasting model), past that G = 16 lanes x 4 floats. Wider rows
//    take several column passes, spread over the grid's second dimension
//    as in the segment kernel.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;  // rows a block owns: one warp scans them
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Blocks a launch may spread its column passes over (4 per SM on 132 SMs).
constexpr int kColBlocks = 528;

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

// V: float4 (vector path) or float; G lanes per worker, C loads per lane
// and row: one pass covers G * C * width columns; A rows a lane loads
// ahead of its adds.
template <typename V, int G, int C, int A>
__global__ void __launch_bounds__(kThreads, 2)
range_sum_kernel(const float* __restrict__ g,
                 const long long* __restrict__ start,
                 const long long* __restrict__ count,
                 float* __restrict__ out, long long n_slots, int dim,
                 int n_rows) {
  static_assert(kRows == 32, "one warp scans the block's rows");
  constexpr int kWidth = sizeof(V) / sizeof(float);
  constexpr int kWorkers = kThreads / G;
  constexpr int kPass = G * C * kWidth;
  __shared__ long long lo[kRows];       // row j's first slot
  __shared__ long long off[kRows + 1];  // row j's place in the block's list
  __shared__ V part[2][kWorkers][G * C];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int v0 = blockIdx.x * kRows;
  const int nr = min(kRows, n_rows - v0);

  if (tid < 32) {
    long long s = 0, len = 0;
    if (lane < nr) {
      const long long st = start[v0 + lane], c = count[v0 + lane];
      s = st < 0 ? 0 : (st > n_slots ? n_slots : st);
      long long hi = c > 0 ? st + c : st;
      hi = hi > n_slots ? n_slots : hi;
      len = hi > s ? hi - s : 0;
    }
    long long incl = len;  // inclusive scan of the clipped lengths
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, incl, k);
      if (lane >= k) incl += y;
    }
    lo[lane] = s;
    off[lane + 1] = incl;
    if (lane == 0) off[0] = 0;
  }
  __syncthreads();

  const long long total = off[nr];
  const int w = tid / G;   // this lane's worker
  const int gl = tid % G;  // its lane within the worker
  const long long chunk = (total + kWorkers - 1) / kWorkers;
  const long long a = min((long long)w * chunk, total);  // share [a, b)
  const long long b = min(a + chunk, total);

  for (int c0 = blockIdx.y * kPass; c0 < dim; c0 += gridDim.y * kPass) {
    bool on[C];
#pragma unroll
    for (int c = 0; c < C; ++c) on[c] = c0 + (gl + G * c) * kWidth < dim;
    auto store_row = [&](int j, const V* acc) {
      V* row = reinterpret_cast<V*>(out + (long long)(v0 + j) * dim + c0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (on[c]) row[gl + G * c] = acc[c];
      }
    };

    if (a < b) {
      // the row that holds position a: the last j with off[j] <= a
      int j = 0, top = nr - 1;
      while (j < top) {
        const int mid = (j + top + 1) >> 1;
        if (off[mid] <= a) {
          j = mid;
        } else {
          top = mid - 1;
        }
      }
      long long end_j = off[j + 1];
      V acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) set_zero(acc[c]);
      bool any = false;
      // Flush row j's run: the whole row inside [a, b) goes to `out`; a
      // run that began before a to slot 0; one that goes past b to slot 1.
      auto flush = [&]() {
        const long long first = off[j];
        if (first >= a && end_j <= b) {
          store_row(j, acc);
        } else {
          V* p = part[first < a ? 0 : 1][w];
#pragma unroll
          for (int c = 0; c < C; ++c) p[gl + G * c] = acc[c];
        }
      };

      for (long long t = a; t < b; t += A) {
        V v[A][C];
        int jj = j;
#pragma unroll
        for (int r = 0; r < A; ++r) {
          const long long tt = t + r;
          if (tt < b) {
            while (tt >= off[jj + 1]) ++jj;
            const V* row = reinterpret_cast<const V*>(
                g + (lo[jj] + (tt - off[jj])) * dim + c0);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (on[c]) {
                v[r][c] = __ldg(row + gl + G * c);
              } else {
                set_zero(v[r][c]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < A; ++r) {
          const long long tt = t + r;
          if (tt < b) {
            while (tt >= end_j) {  // next row (skips empty ones)
              if (any) flush();
              ++j;
              end_j = off[j + 1];
#pragma unroll
              for (int c = 0; c < C; ++c) set_zero(acc[c]);
              any = false;
            }
#pragma unroll
            for (int c = 0; c < C; ++c) add_to(acc[c], v[r][c]);
            any = true;
          }
        }
      }
      if (any) flush();
    }
    __syncthreads();

    // Empty rows get 0; a row that crosses shares is its first worker's
    // slot 1 plus the slot 0 of every later worker it reaches, added in
    // worker order.
    for (int j = w; j < nr; j += kWorkers) {
      const long long first = off[j], last = off[j + 1];
      V acc[C];
      if (first >= last) {
#pragma unroll
        for (int c = 0; c < C; ++c) set_zero(acc[c]);
      } else {
        const long long ka = first / chunk, kb = (last - 1) / chunk;
        if (ka == kb) continue;  // written by its worker
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = part[1][ka][gl + G * c];
        for (long long k = ka + 1; k <= kb; ++k) {
#pragma unroll
          for (int c = 0; c < C; ++c) add_to(acc[c], part[0][k][gl + G * c]);
        }
      }
      store_row(j, acc);
    }
    __syncthreads();  // the next pass reuses `part`
  }
}

template <typename V, int G, int C, int A>
void launch(unsigned grid_x, cudaStream_t stream, const float* g,
            const long long* start, const long long* count, float* out,
            long long n_slots, int dim, int n_rows) {
  constexpr int kPass = G * C * (int)(sizeof(V) / sizeof(float));
  const int passes = (dim + kPass - 1) / kPass;
  const int room = kColBlocks / (int)grid_x;
  const dim3 grid(grid_x, (unsigned)(passes < room ? passes
                                                   : (room > 1 ? room : 1)));
  range_sum_kernel<V, G, C, A><<<grid, kThreads, 0, stream>>>(
      g, start, count, out, n_slots, dim, n_rows);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// g (n_slots, dim) float32, start and count (n_rows,) int64, out
// (n_rows, dim) float32. `vec` asks for float4 loads (needs dim % 4 == 0
// and a 16-byte aligned g), as the wrapper (ops/gather.py:range_sum)
// chooses. Launches on `stream` and returns cudaGetLastError() of the
// launch (0 = cudaSuccess), or cudaErrorInvalidValue for arguments it
// refuses: negative sizes, or `vec` on rows it cannot load as float4.
extern "C" int range_sum_f32(const void* g, const void* start,
                             const void* count, void* out, long long n_slots,
                             int dim, int n_rows, int vec, void* stream) {
  if (n_rows <= 0 || dim <= 0) return 0;
  if (n_slots < 0 || (vec && (dim % 4 != 0 || (uintptr_t)g % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((n_rows + kRows - 1) / kRows);
  const auto s = (cudaStream_t)stream;
  const auto* x = (const float*)g;
  const auto* st = (const long long*)start;
  const auto* ct = (const long long*)count;
  auto* o = (float*)out;
  if (!vec) {
    if (dim <= 32) {
      launch<float, 8, 4, 8>(grid, s, x, st, ct, o, n_slots, dim, n_rows);
    } else {
      launch<float, 16, 4, 4>(grid, s, x, st, ct, o, n_slots, dim, n_rows);
    }
  } else if (dim <= 48) {
    launch<float4, 4, 3, 4>(grid, s, x, st, ct, o, n_slots, dim, n_rows);
  } else {
    launch<float4, 8, 3, 4>(grid, s, x, st, ct, o, n_slots, dim, n_rows);
  }
  return (int)cudaGetLastError();
}
