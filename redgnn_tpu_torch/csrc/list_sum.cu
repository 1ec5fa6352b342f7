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
// Design: one launch, whole rows, a ring of copies in flight a warp.
//  * Shares of the list, as in share_sum.cuh: block x takes the share
//    [x S, (x + 1) S) of S = kWarps * sub positions and warp w the
//    sub-share of `sub` (at most 64) positions at w * sub. The wrapper's
//    plan (ops/gather.py:_list_plan) picks sub by the list's length so
//    that the blocks make whole waves of three a multiprocessor (7a:
//    390 blocks of 49 positions a warp): the card's 132 multiprocessors
//    get equal bytes, and none waits on another's last block.
//  * A block sums whole rows, up to kMaxTile (1,024) columns: 672 and 980
//    floats on the dense hops. So a position is located once, not once
//    a column tile; wider rows take tiles of 1,024 in the grid's second
//    dimension. Lane l owns columns l, l + 32, ... of the tile and keeps
//    their sums in registers.
//  * A warp reads its positions' slots from `order` and, while they
//    arrive, finds its rows (one 128-ary search in off, then windows of
//    32 row starts); then it puts the first `stages` stages of rows in
//    flight.
//    The ring: `stages` stages of `stage_rows` rows each (2 x 1 row at
//    W = 672 and 980, up to 32 rows of a narrow tile), one mbarrier a
//    stage. A 16-byte aligned g with W a multiple of 4 copies each row
//    with one bulk copy (cp.async.bulk, completing on the stage's
//    mbarrier); else the warp copies it in 8- or 4-byte cp.async pieces
//    and each lane's arrive on the mbarrier follows its pieces. A stage
//    is refilled as soon as it is summed, so the next rows are in flight
//    while the current ones are added.
//  * Runs of equal row are summed in position order. A run inside the
//    sub-share goes to out; the sub-share's first run, if its row began
//    before it, goes to the warp's head row in shared memory, and its
//    last run, if its row goes on past it, to the drained ring (tail).
//    After one barrier each chain of warp partials is added in warp
//    order (to out, or to the block's partial slot 0 / 1 in bpart).
//  * No second pass: the warp that writes a block partial of a row
//    crossing blocks adds one to the row's counter (counts[first block of
//    the row], an integer atomic). The last of the row's blocks to
//    arrive adds the row's block partials, in groups of kFixGroup blocks
//    in block order, writes the row and sets the counter back to 0, so
//    the counters are 0 between launches.
//  * No memset: every row is written once. A row with positions by the
//    warp, block or last block that ends it; a row without by the warp
//    whose positions lie around its start (between two positions' rows,
//    before the row of its first position, or, for the warp holding the
//    list's end, after the last row).
//  * Deterministic: the order is the share pass's (runs in position
//    order, then warps, then groups of kFixGroup blocks, then groups);
//    ops/gather.py:list_sum_model repeats it in plain PyTorch and the card
//    tests hold the kernel to it bit for bit.

#include "share_sum.cuh"  // the share pass's constants, allow_smem

namespace {

using share_sum::kFixGroup;
using share_sum::kFull;
using share_sum::kThreads;
using share_sum::kWarps;
using share_sum::smem_addr;

constexpr int kMaxSub = 64;        // list positions a warp sums
constexpr int kMaxTile = 1024;     // columns a block sums: 32 a lane
constexpr int kRingFloats = 2048;  // a warp's ring and head row, 8 KB
constexpr int kMaxStages = 8;
constexpr int kMaxStageRows = 32;

__device__ __forceinline__ void bar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect_tx(unsigned long long* bar,
                                              unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// the arrive of this thread's earlier cp.async pieces, once they land
__device__ __forceinline__ void bar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one row of g into shared memory by the bulk-copy engine
__device__ __forceinline__ void bulk_row(float* dst, const float* src,
                                         unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_piece(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

// The number of i in [0, n) with a[i] < x (a non-decreasing), or with
// a[i] <= x when `le`: the first i past them. Called by a whole warp;
// every lane gets it. 128-ary: each lane probes 4 points a step (two steps
// for 16,384 rows).
__device__ __forceinline__ long long warp_count(const int* __restrict__ a,
                                                long long n, long long x,
                                                bool le) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // counted below lo, not at hi and on
  while (lo < hi) {
    const long long step = (hi - lo + 127) / 128;
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long v = lo + (4 * lane + k + 1) * step - 1;
      const bool in = v < hi && (le ? a[v] <= x : a[v] < x);
      c += __popc(__ballot_sync(kFull, in));
    }
    const long long cut = lo + (long long)(c + 1) * step - 1;
    lo += (long long)c * step;
    hi = cut < hi ? cut : hi;
  }
  return lo;
}

// Rows [v0, v1) of the tile are 0 (rows with no positions). Whole warp.
__device__ __forceinline__ void zero_rows(float* __restrict__ out, long long v0,
                                          long long v1, int dim, int c0,
                                          int tw) {
  const int lane = threadIdx.x & 31;
  for (long long v = v0; v < v1; ++v) {
    for (int c = lane; c < tw; c += 32) out[v * dim + c0 + c] = 0.f;
  }
}

// Row r crosses blocks ka..kb: the sum of its block partials (slot 1 of
// ka, slot 0 of the others), in groups of kFixGroup blocks in block order,
// to out. Called by the whole block of the last of those blocks to arrive.
__device__ __forceinline__ void fix_row(const float* __restrict__ bpart,
                                        float* __restrict__ out, long long r,
                                        long long ka, long long kb, int dim,
                                        int c0, int tw) {
  for (int col = threadIdx.x; col < tw; col += kThreads) {
    const float* src = bpart + c0 + col;
    float sum = 0.f;
    for (long long g0 = ka / kFixGroup; g0 <= kb / kFixGroup; ++g0) {
      const long long k_lo = g0 * kFixGroup > ka ? g0 * kFixGroup : ka;
      const long long k_end = g0 * kFixGroup + kFixGroup - 1;
      const long long k_hi = k_end < kb ? k_end : kb;
      float v[kFixGroup];
#pragma unroll
      for (int u = 0; u < kFixGroup; ++u) {
        const long long k = k_lo + u;
        v[u] = k <= k_hi ? __ldcg(src + (k * 2 + (k == ka ? 1 : 0)) * dim)
                         : 0.f;
      }
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < kFixGroup; ++u) {
        if (k_lo + u <= k_hi) s += v[u];
      }
      sum += s;
    }
    out[r * dim + c0 + col] = sum;
  }
}

// This warp wrote the block partial of row r (slot 1 if r began in this
// block, else slot 0): one more of the row's blocks is in. Returns, to
// every lane, whether this block is the last (it then sets the counter
// back to 0 and adds the row: fix_row). The add is acq_rel at GPU scope:
// it releases the warp's partial (ordered before it by the warp barrier)
// and, for the last, acquires the others' (the block barrier passes that
// on to the threads that read them).
__device__ __forceinline__ bool arrive(const int* __restrict__ off,
                                       int* __restrict__ counts, long long r,
                                       long long S) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    const long long ka = (long long)off[r] / S;
    const long long kb = ((long long)off[r + 1] - 1) / S;
    int* cnt = counts + ka * gridDim.y + blockIdx.y;
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(cnt)
                 : "memory");
    last = old == (int)(kb - ka);
    if (last) *cnt = 0;  // every block of the row is in: back to 0
  }
  return __shfl_sync(kFull, last, 0) != 0;
}

template <int C>
__global__ void __launch_bounds__(kThreads, C <= 24 ? 3 : 2)
list_kernel(const float* __restrict__ g, const int* __restrict__ order,
            const int* __restrict__ off, float* __restrict__ out,
            float* __restrict__ bpart, int* __restrict__ counts, int n_rows,
            int dim, int tile, int sub, int stage_rows, int stages,
            int piece) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long bars[kWarps][kMaxStages];
  __shared__ int head_row[kWarps], tail_row[kWarps];

  __shared__ int fixes[2];  // rows this block adds up (fix_row), or -1
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long blk = blockIdx.x;
  const int c0 = blockIdx.y * tile;
  const int tw = min(tile, dim - c0);
  const int wp = (tile + 3) & ~3;  // floats a staged row takes
  const int ring = stages * stage_rows * wp;
  const int span = ring + wp;  // a warp's ring, then its head partial
  const long long S = (long long)sub * kWarps;
  const long long total = off[n_rows];
  const long long s0 = blk * S;
  float* my_ring = smem + (long long)w * span;
  float* my_head = my_ring + ring;
  if (lane == 0) {
    head_row[w] = -1;
    tail_row[w] = -1;
  }
  if (threadIdx.x < 2) fixes[threadIdx.x] = -1;
  if (total == 0 && blk == 0 && w == 0) zero_rows(out, 0, n_rows, dim, c0, tw);

  // This warp's sub-share [a, b) of the list.
  const long long s1 = s0 + S < total ? s0 + S : total;
  const long long a = s0 + w * sub < s1 ? s0 + w * sub : s1;
  const long long b = a + sub < s1 ? a + sub : s1;
  const int n = a < b ? (int)(b - a) : 0;
  if (n > 0) {
    // slots first: the copies wait on nothing else
    const int slot0 = lane < n ? order[a + lane] : 0;
    const int slot1 = lane + 32 < n ? order[a + 32 + lane] : 0;
    unsigned long long* bar = bars[w];
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) bar_init(&bar[s], piece == 16 ? 1 : 32);
      bar_init_fence();
    }
    __syncwarp();
    const int n_st = (n + stage_rows - 1) / stage_rows;
    // stage k: positions [k stage_rows, ...) into ring stage k % stages
    auto issue = [&](int k) {
      const int p0 = k * stage_rows;
      const int nr = min(stage_rows, n - p0);
      float* dst = my_ring + (k % stages) * stage_rows * wp;
      unsigned long long* sb = &bar[k % stages];
      if (piece == 16) {
        const int p = p0 + (lane < nr ? lane : 0);
        const int v0 = __shfl_sync(kFull, slot0, p & 31);
        const int v1 = __shfl_sync(kFull, slot1, p & 31);
        if (lane == 0) bar_expect_tx(sb, (unsigned)(nr * tw * 4));
        __syncwarp();
        if (lane < nr) {
          const long long s = p < 32 ? v0 : v1;
          bulk_row(dst + lane * wp, g + s * dim + c0, (unsigned)(tw * 4), sb);
        }
      } else {
        const int kw = piece / 4;
        const int per = (tw + kw - 1) / kw;
        const int pieces = nr * per;
        for (int q0 = 0; q0 < pieces; q0 += 32) {
          const int q = q0 + lane;
          const int i = min(q / per, nr - 1);
          const int p = p0 + i;
          const int v0 = __shfl_sync(kFull, slot0, p & 31);
          const int v1 = __shfl_sync(kFull, slot1, p & 31);
          if (q < pieces) {
            const long long s = p < 32 ? v0 : v1;
            const int c = (q - i * per) * kw;
            if (piece == 8) {
              cp_piece<8>(dst + i * wp + c, g + s * dim + c0 + c);
            } else {
              cp_piece<4>(dst + i * wp + c, g + s * dim + c0 + c);
            }
          }
        }
        bar_arrive_copies(sb);
      }
    };

    // The rows of the n positions, while the slots arrive (and before any
    // row is in flight: behind the copies, these dependent loads would
    // wait their turn): lane l holds those of a + l (row0) and a + 32 + l
    // (row1). One 128-ary search finds the row of a; then lane i loads
    // off[wb + 1 + i] (a window of 32 row starts) and a ballot a position
    // counts those at or below it; a window that ends before a position
    // moves on by 32 rows.
    const long long ra = warp_count(off, n_rows, a, true) - 1;
    const long long base_a = off[ra];  // the start of the row of a
    int row0 = (int)ra, row1 = (int)ra;
    long long next_end;  // off[r + 1] of the last position's row r
    {
      bool done0 = lane >= n, done1 = lane + 32 >= n;
      long long wb = ra, oj;
      for (;; wb += 32) {
        const long long jj = wb + 1 + lane;
        oj = jj <= n_rows ? (long long)off[jj] : LLONG_MAX;
        int cnt0 = 0, cnt1 = 0;
        for (int i = 0; i < n; ++i) {
          const unsigned m = __ballot_sync(kFull, oj <= a + i);
          if ((i & 31) == lane) {
            if (i < 32) {
              cnt0 = __popc(m);
            } else {
              cnt1 = __popc(m);
            }
          }
        }
        if (!done0) {
          row0 = (int)(wb + cnt0);
          done0 = cnt0 < 32;
        }
        if (!done1) {
          row1 = (int)(wb + cnt1);
          done1 = cnt1 < 32;
        }
        if (__all_sync(kFull, done0 && done1)) break;
      }
      // the last position's row was found in this window: its end is there
      const int ll = (n - 1) & 31;
      const int last_row = __shfl_sync(kFull, n > 32 ? row1 : row0, ll);
      next_end = __shfl_sync(kFull, oj, (int)(last_row - wb));
      if (b == total) zero_rows(out, last_row + 1, n_rows, dim, c0, tw);
    }
    for (int k = 0; k < n_st && k < stages; ++k) issue(k);
    const bool before = base_a < a;  // the first run began before a
    const bool past = next_end > b;  // the last run goes on past b
    if (!before) {
      // rows before ra that start at a too have no positions: this warp
      // writes them (a window of 32 row starts at a time, backwards)
      for (long long v1 = ra;;) {
        const long long v = v1 - 1 - lane;
        const bool at_a = v >= 0 && off[v] == a;
        const int k = __popc(__ballot_sync(kFull, at_a));
        zero_rows(out, v1 - k, v1, dim, c0, tw);
        if (k < 32) break;
        v1 -= 32;
      }
    }

    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    int cur = -1;
    bool first_run = true;
    // the run of row `cur` is done and is not the sub-share's last: to
    // out, or (the sub-share's first run, begun before a) to the head
    auto flush = [&]() {
      float* o = first_run && before ? my_head + lane
                                     : out + (long long)cur * dim + c0 + lane;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (lane + 32 * c < tw) o[32 * c] = acc[c];
      }
      if (first_run && before && lane == 0) head_row[w] = cur;
      first_run = false;
    };
    for (int k = 0; k < n_st; ++k) {
      const int s = k % stages;
      bar_wait(&bar[s], (unsigned)((k / stages) & 1));
      const float* st = my_ring + s * stage_rows * wp + lane;
      const int p0 = k * stage_rows;
      const int nr = min(stage_rows, n - p0);
      for (int i = 0; i < nr; ++i) {
        const int p = p0 + i;
        const int r0 = __shfl_sync(kFull, row0, p & 31);
        const int r1 = __shfl_sync(kFull, row1, p & 31);
        const int r = p < 32 ? r0 : r1;
        if (r != cur) {
          if (cur >= 0) {
            flush();
            // the rows between two positions' rows have no positions
            zero_rows(out, cur + 1, r, dim, c0, tw);
          }
          cur = r;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (lane + 32 * c < tw) acc[c] += st[i * wp + 32 * c];
        }
      }
      __syncwarp();  // every lane has read the stage before it is refilled
      if (k + stages < n_st) issue(k + stages);
    }
    // The last run: out, the head (the sub-share's first run, begun
    // before a) or the tail (going on past b), in the drained ring.
    float* o = first_run && before ? my_head + lane
               : past              ? my_ring + lane
                                   : out + (long long)cur * dim + c0 + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (lane + 32 * c < tw) o[32 * c] = acc[c];
    }
    if (lane == 0) {
      if (first_run && before) head_row[w] = cur;
      if (past) tail_row[w] = cur;
    }
  }
  __syncthreads();

  // Chains of warp partials, added in warp order (as share_sum.cuh): a
  // row that began in warp w and goes on is warp w's chain, adding the
  // head of each next warp it reaches; it goes to out if it ends in the
  // block, else to the block's slot 1. The block's first row, if it began
  // before the block, is warp 0's: the block's slot 0. A warp that writes
  // a block partial arrives on the row's counter; the block then adds up
  // the rows it was the last to reach.
  const int row = tail_row[w];
  if (row >= 0 && head_row[w] != row) {
    int k_end = w + 1;
    while (k_end < kWarps && tail_row[k_end] == row) ++k_end;
    const bool ends = k_end < kWarps;  // in warp k_end
    for (int col = lane; col < tw; col += 32) {
      float v = 0.f + my_ring[col];
      for (int k = w + 1; k <= k_end && k < kWarps; ++k) {
        v += smem[k * span + ring + col];
      }
      if (ends) {
        out[(long long)row * dim + c0 + col] = v;
      } else {
        bpart[(blk * 2 + 1) * dim + c0 + col] = v;
      }
    }
    if (!ends && arrive(off, counts, row, S) && lane == 0) fixes[1] = row;
  }
  const int r_head = head_row[0];
  if (w == 0 && r_head >= 0) {
    for (int col = lane; col < tw; col += 32) {
      float v = 0.f + my_head[col];
      for (int k = 1; k < kWarps && tail_row[k - 1] == r_head; ++k) {
        v += smem[k * span + ring + col];
      }
      bpart[(blk * 2) * dim + c0 + col] = v;
    }
    if (arrive(off, counts, r_head, S) && lane == 0) fixes[0] = r_head;
  }
  __syncthreads();
  for (int j = 0; j < 2; ++j) {
    const long long r = fixes[j];
    if (r < 0) continue;
    fix_row(bpart, out, r, (long long)off[r] / S, ((long long)off[r + 1] - 1) / S,
            dim, c0, tw);
  }
}

template <int C>
int launch(dim3 grid, int smem, cudaStream_t s, const float* g,
           const int* order, const int* off, float* out, float* bpart,
           int* counts, int n_rows, int dim, int tile, int sub,
           int stage_rows, int stages, int piece) {
  static bool raised[64] = {};
  auto* kernel = list_kernel<C>;
  const int err = share_sum::allow_smem(
      kernel, kWarps * 3 * kMaxTile * (int)sizeof(float), raised);
  if (err != 0) return err;
  kernel<<<grid, kThreads, smem, s>>>(g, order, off, out, bpart, counts,
                                      n_rows, dim, tile, sub, stage_rows,
                                      stages, piece);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// g (n_slots, dim) float32; order (n_slots,) int32, each position's slot
// of g; off (n_rows + 1,) int32, the rows' first positions, with off[0] =
// 0 and off[n_rows] <= n_slots; out (n_rows, dim) float32. Scratch, as the
// wrapper's plan (ops/gather.py:_list_plan) sizes it: bpart (n_blocks, 2,
// dim) float32, and counts (n_blocks * n_tiles,) int32, all 0 (the kernel
// leaves them 0), with n_blocks = ceil(n_slots / (8 * sub)) and n_tiles =
// ceil(dim / tile). `tile` is the columns a block sums (at most 1,024; a
// multiple of 4 below dim), `sub` the list positions a warp sums (1 to
// 64); each warp's ring holds `stages` (1 to 8) stages of `stage_rows`
// (1 to 32) rows of the tile, and with its head row at most 2,048 floats
// (three rows of a wider tile). Launches one kernel on `stream` and
// returns cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue
// for arguments it refuses.
extern "C" int list_sum_f32(const void* g, const void* order, const void* off,
                            void* out, void* bpart, void* counts,
                            long long n_slots, int dim, int n_rows, int tile,
                            int sub, int stage_rows, int stages, void* stream) {
  if (n_rows <= 0 || dim <= 0) return 0;
  const int wp = (tile + 3) & ~3;
  // a warp's ring and head partial
  const long long span = (long long)stages * stage_rows * wp + wp;
  if (n_slots <= 0 || n_slots > INT_MAX || tile <= 0 || tile > kMaxTile ||
      (tile < dim && tile % 4 != 0) || sub <= 0 || sub > kMaxSub ||
      stage_rows <= 0 || stage_rows > kMaxStageRows || stages <= 0 ||
      stages > kMaxStages || (span > kRingFloats && span > 3 * wp)) {
    return (int)cudaErrorInvalidValue;
  }
  // bulk copies want 16-byte aligned rows; else 8- or 4-byte pieces
  const uintptr_t addr = (uintptr_t)g;
  const int piece = addr % 16 == 0 && dim % 4 == 0   ? 16
                    : addr % 8 == 0 && dim % 2 == 0  ? 8
                                                     : 4;
  const long long S = (long long)sub * kWarps;
  const long long n_blocks = (n_slots + S - 1) / S;
  const int n_tiles = (dim + tile - 1) / tile;
  if (n_blocks > INT_MAX || n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_blocks, (unsigned)n_tiles);
  const int smem = kWarps * (int)span * (int)sizeof(float);
  const auto s = (cudaStream_t)stream;
  const auto* x = (const float*)g;
  const auto* od = (const int*)order;
  const auto* of = (const int*)off;
  auto* o = (float*)out;
  auto* bp = (float*)bpart;
  auto* ct = (int*)counts;
  const int C = (tile + 31) / 32;
  if (C <= 1) {
    return launch<1>(grid, smem, s, x, od, of, o, bp, ct, n_rows, dim, tile,
                     sub, stage_rows, stages, piece);
  }
  if (C <= 2) {
    return launch<2>(grid, smem, s, x, od, of, o, bp, ct, n_rows, dim, tile,
                     sub, stage_rows, stages, piece);
  }
  if (C <= 4) {
    return launch<4>(grid, smem, s, x, od, of, o, bp, ct, n_rows, dim, tile,
                     sub, stage_rows, stages, piece);
  }
  if (C <= 8) {
    return launch<8>(grid, smem, s, x, od, of, o, bp, ct, n_rows, dim, tile,
                     sub, stage_rows, stages, piece);
  }
  if (C <= 16) {
    return launch<16>(grid, smem, s, x, od, of, o, bp, ct, n_rows, dim, tile,
                      sub, stage_rows, stages, piece);
  }
  if (C <= 24) {
    return launch<24>(grid, smem, s, x, od, of, o, bp, ct, n_rows, dim, tile,
                      sub, stage_rows, stages, piece);
  }
  return launch<32>(grid, smem, s, x, od, of, o, bp, ct, n_rows, dim, tile,
                    sub, stage_rows, stages, piece);
}
