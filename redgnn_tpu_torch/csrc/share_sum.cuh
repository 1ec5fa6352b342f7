// Slot-balanced sums over a list of slots laid out in runs of equal row, on
// Hopper (sm_90a): the pass that range_sum.cu and take_rows_grad.cu share.
//
// Both kernels reduce to the same problem. A list of T positions is laid
// end to end in rows: row v holds positions [off[v], off[v + 1]), and
// position t names one slot of g (a row of D floats). Row v of the result is
// the float32 sum of its positions' slots. The range sum's list is its
// ranges' slots (off: the scan of the clipped lengths); the scatter-add's is
// its ids' slots after a stable counting sort by id (off: the rows' first
// places in the sorted list).
//
// What bounds it: bytes. Each listed slot's row is read once and each output
// row written once.
//
// Design:
//  * Shares of the list, not rows. Block x takes the share [x S, (x + 1) S)
//    of S = kWarps * sub positions, and warp w the sub-share of `sub`
//    positions at w * sub. A row that holds 10^5 positions is spread over
//    its shares' warps and blocks; a share's cost does not depend on how its
//    positions fall into rows.
//  * A warp walks its sub-share in rounds of B positions (B rows of a tile
//    of up to 32 C columns: B * 32 C <= 2048 floats, 8 KB; B = 32 at
//    D <= 64, two rounds of the plans' sub = 64). A round asks the caller's
//    `locate` for the slot and row of each position (lane l: positions
//    t0 + l + 32 j), then copies the round's rows into shared memory with
//    cp.async and waits once: every row of the round is in flight at once,
//    and the warp's latency chain is a few dependent loads a round, not
//    one a row. A round whose slots run on (ranges laid end to end, sorted
//    ids) is one contiguous span of g when the tile spans the row: it is
//    copied in 16-byte pieces, its ends rounded out to 16 bytes. Other
//    rounds copy row by row, 16, 8 or 4 bytes a piece as D and the
//    alignment of g allow. Every lane is busy either way (D = 20 or 30 no
//    longer leaves lanes idle or takes 4-byte loads).
//  * The sum reads shared memory: lane l owns columns l, l + 32, ... of the
//    tile and adds the round's rows in position order. Where the row
//    changes, the finished run goes out: to `out` if its row lies inside
//    the sub-share, else to the warp's partial slot 0 (the sub-share's
//    first run, whose row began before it) or 1 (its last run, whose row
//    goes on past it). Whether either holds is asked of the caller once a
//    sub-share (`began_before`, `goes_past`), never per run.
//  * After a barrier, each chain of warp partials is added in warp order; a
//    row that lies inside the block goes to `out`, one that crosses the
//    block's bounds leaves a block partial (slot 0: it began before the
//    block; slot 1: it began in the block and goes on, its row in
//    tails[block]).
//  * The fix-up pass (fixup_kernel): block x adds the partials of the row
//    that tails[x] names, blocks x .. y in order: warps add groups of
//    kFixGroup consecutive block partials (group = block / kFixGroup), and
//    the groups' sums are added in group order.
//  * Deterministic: every sum is taken in one order fixed by the list, S
//    and kFixGroup (run order in a sub-share, then warps, then groups of
//    blocks, then groups), with no float atomics. The wrappers' plans pick
//    S from shapes alone; ops/gather.py models the order in plain PyTorch
//    (`_share_order_sum`), and the card tests hold the kernels to the model
//    bit for bit.
//  * Wide rows take column tiles of at most kMaxCols columns over the
//    grid's second dimension; a tile's sums are independent of the others.

#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace share_sum {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFixGroup = 16;  // block partials a fix-up warp adds in turn
constexpr int kMaxCols = 128;  // columns a tile may have: 4 a lane
constexpr int kSlack = 8;      // floats a stage keeps for 16-byte rounding
constexpr unsigned kFull = 0xffffffffu;

// rows a round of a warp holds at C columns a lane: B * 32 C <= 2048
// floats (timed on the H100 against 64 rows at C = 1: smaller stages let
// four blocks share an SM)
__host__ __device__ constexpr int batch_rows(int C) {
  return C <= 2 ? 32 : 16;
}

// list positions a lane locates in a round
__host__ __device__ constexpr int lane_positions(int C) {
  return batch_rows(C) >= 32 ? batch_rows(C) / 32 : 1;
}

// floats the stage of one warp holds at a tile of `tile` columns
__host__ __device__ inline int stage_floats(int C, int tile) {
  return (batch_rows(C) * tile + kSlack + 3) & ~3;
}

// dynamic shared memory of a share-pass block: one stage a warp
__host__ __device__ inline int share_smem_bytes(int C, int tile) {
  return kWarps * stage_floats(C, tile) * (int)sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// v[j] of the lane-uniform j: a select, so that v stays in registers
template <int K, typename T>
__device__ __forceinline__ T pick(const T (&v)[K], int j) {
  T x = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (k == j) x = v[k];
  }
  return x;
}

// Raise a kernel's dynamic shared memory limit to `most`, the most any of
// its launches asks for, once per device (not a stream operation, so a
// CUDA graph's capture never meets it after a first eager call).
template <typename Kern>
int allow_smem(Kern* kernel, int most, bool* raised) {
  if (most <= 48 * 1024) return 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device < 64 && raised[device]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return (int)err;
  if (device < 64) raised[device] = true;
  return 0;
}

// Copy rows [first, first + nb) of g (dim floats each) into `st` with
// 16-byte cp.async pieces, the span rounded out to 16 bytes (a 16-byte
// piece never leaves the allocation that holds a byte of it); returns where
// row `first` begins in `st` (floats). Called by the whole warp.
__device__ __forceinline__ int issue_span(const float* __restrict__ g,
                                          long long first, int nb, int dim,
                                          float* st, int lane) {
  const uintptr_t beg = (uintptr_t)(g + first * dim);
  const uintptr_t end = (uintptr_t)(g + (first + nb) * dim);
  const uintptr_t base = beg & ~(uintptr_t)15;
  const int n16 = (int)((end - base + 15) >> 4);
  for (int q = lane; q < n16; q += 32) {
    cp_async<16>(st + 4 * q, (const void*)(base + 16 * (uintptr_t)q));
  }
  return (int)((beg - base) >> 2);
}

// The share [s0, s1) of the list, summed by one block (see the header);
// [a, b) is this warp's part of it. c0 / tw: the tile's first column and
// width; stage: this block's dynamic shared memory. Called by the whole
// block. The caller's functors, called by the whole warp:
//  * locate(t0, nb, slot, row): lane l's positions t0 + l + 32 j (j < K,
//    those below t0 + nb) get their slot of g and their row;
//  * began_before(r): whether row r, the row of position a, holds
//    position a - 1 too;
//  * goes_past(r): whether row r, the row of position b - 1, holds
//    position b too.
template <int C, int WB, typename Locate, typename Before, typename Past>
__device__ __forceinline__ void sum_share(
    const float* __restrict__ g, float* __restrict__ out,
    float* __restrict__ bpart, int* __restrict__ tails, long long a,
    long long b, int dim, int c0, int tw, long long blk, float* stage,
    Locate& locate, Before& began_before, Past& goes_past) {
  constexpr int B = batch_rows(C);
  constexpr int K = lane_positions(C);
  constexpr int kW = WB / 4;  // floats a piece of a row-by-row copy
  __shared__ float part[2][kWarps][32 * C];
  __shared__ int head_row[kWarps], tail_row[kWarps];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* st = stage + (long long)w * stage_floats(C, tw);
  bool on[C];
#pragma unroll
  for (int c = 0; c < C; ++c) on[c] = lane + 32 * c < tw;
  if (lane == 0) {
    head_row[w] = -1;
    tail_row[w] = -1;
  }
  __syncwarp();

  float acc[C];
  int cur = -1;
  bool first_run = true, before = false;
  // The run of row `cur` is done: to out, or to the warp's partials (slot
  // 0: the sub-share's first run, begun before a; slot 1: its last run,
  // going on past b).
  auto flush = [&](bool past) {
    const bool head = first_run && before;
    float* dst = nullptr;
    if (head) {
      dst = part[0][w];
      if (lane == 0) {
        head_row[w] = cur;
        if (past) tail_row[w] = cur;
      }
    } else if (past) {
      dst = part[1][w];
      if (lane == 0) tail_row[w] = cur;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (on[c]) {
        if (dst != nullptr) {
          dst[lane + 32 * c] = acc[c];
        } else {
          out[(long long)cur * dim + c0 + lane + 32 * c] = acc[c];
        }
      }
    }
    first_run = false;
  };

  for (long long t0 = a; t0 < b; t0 += B) {
    const int nb = (int)(b - t0 < B ? b - t0 : B);
    long long slot[K];
    int row[K];
    locate(t0, nb, slot, row);
    if (t0 == a) before = began_before(__shfl_sync(kFull, row[0], 0));
    // the copies: one span of g when the slots run on and the tile spans
    // the row (rounded out to 16 bytes), else row by row
    const long long s_first = __shfl_sync(kFull, slot[0], 0);
    bool run = true;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = lane + 32 * j;
      run = run && (p >= nb || slot[j] == s_first + p);
    }
    int sh = 0;
    if (__all_sync(kFull, run) && tw == dim) {
      sh = issue_span(g, s_first, nb, dim, st, lane);
    } else {
      const int per = tw / kW;
      const int n = nb * per;
      for (int k0 = 0; k0 < n; k0 += 32) {
        const int q = k0 + lane;
        const int i = min(q / per, nb - 1);
        long long s = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const long long sj = __shfl_sync(kFull, slot[j], i & 31);
          if ((i >> 5) == j) s = sj;
        }
        if (q < n) {
          const int c = (q - i * per) * kW;
          cp_async<WB>(st + i * tw + c, g + s * dim + c0 + c);
        }
      }
    }
    // the round's runs of equal row: bit l of starts[j] marks position
    // 32 j + l as the first of a run (the round's first position opens
    // one unless it goes on with the row of the previous round)
    unsigned starts[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = lane + 32 * j;
      int up = __shfl_up_sync(kFull, row[j], 1);
      const int last =
          j == 0 ? cur : __shfl_sync(kFull, row[j > 0 ? j - 1 : 0], 31);
      if (lane == 0) up = last;
      starts[j] = __ballot_sync(kFull, p < nb && row[j] != up);
    }
    cp_async_wait_all();
    __syncwarp();
    for (int i = 0; i < nb;) {
      int e = nb;  // the next run's first position
#pragma unroll
      for (int j = K - 1; j >= 0; --j) {
        const int from = i + 1 - 32 * j;
        const unsigned m = from <= 0    ? starts[j]
                           : from >= 32 ? 0u
                                        : starts[j] >> from << from;
        if (m != 0) e = 32 * j + __ffs(m) - 1;
      }
      const int r = __shfl_sync(kFull, pick(row, i >> 5), i & 31);
      if (r != cur) {
        if (cur >= 0) flush(false);
        cur = r;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = 0.f;
      }
      const float* src = st + sh + i * tw + lane;
#pragma unroll 4
      for (int q = 0; q < e - i; ++q) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (on[c]) acc[c] += src[q * tw + 32 * c];
        }
      }
      i = e;
    }
    __syncwarp();  // the next round refills the stage
  }
  if (cur >= 0) flush(goes_past(cur));
  __syncthreads();

  // Chains of warp partials, added in warp order. A row that began in
  // warp w and goes on (its slot 1) is warp w's chain: slot 0 of each next
  // warp it reaches; it goes to out if it ends in the block, else to the
  // block's slot 1 (and tails[blk]). The block's first row, if it began
  // before the block, is warp 0's too: the block's slot 0.
  auto store = [&](float* dst, const float* v) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (on[c]) dst[lane + 32 * c] = v[c];
    }
  };
  float v[C];
  const int row = tail_row[w];
  if (row >= 0 && head_row[w] != row) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.f + part[1][w][lane + 32 * c];
    for (int k = w + 1;; ++k) {
      if (k == kWarps) {
        store(bpart + (blk * 2 + 1) * dim + c0, v);
        if (lane == 0 && blockIdx.y == 0) tails[blk] = row;
        break;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] += part[0][k][lane + 32 * c];
      if (tail_row[k] != row) {
        store(out + (long long)row * dim + c0, v);
        break;
      }
    }
  }
  if (w == 0 && head_row[0] >= 0) {
    const int r0 = head_row[0];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.f + part[0][0][lane + 32 * c];
    for (int k = 1; k < kWarps && tail_row[k - 1] == r0; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] += part[0][k][lane + 32 * c];
    }
    store(bpart + (blk * 2) * dim + c0, v);
  }
}

// The effective share of the list: S positions a block, unless the list is
// longer than `n_blocks` shares of S (ranges that overlap); then the
// smallest multiple of S that fits it into n_blocks shares.
__device__ __forceinline__ long long effective_share(long long total,
                                                     long long S,
                                                     long long n_blocks) {
  const long long shares = (total + S - 1) / S;
  const long long m = shares > n_blocks ? (shares + n_blocks - 1) / n_blocks
                                        : 1;
  return S * m;
}

// Block x adds the block partials of the row in tails[x] (a row that began
// in share x and goes on past it): share x's slot 1, then slot 0 of every
// later share the row reaches. Warps take groups of kFixGroup consecutive
// shares (group = share / kFixGroup) and add each in share order; the
// groups' sums are added in group order. `total` is off[rows] and
// `share` / `n_blocks` those of the share pass.
template <typename Off>
__global__ void __launch_bounds__(kThreads)
fixup_kernel(const Off* __restrict__ off, const float* __restrict__ bpart,
             const int* __restrict__ tails, float* __restrict__ out, int rows,
             long long share, long long n_blocks, int dim) {
  __shared__ float gsum[kWarps][32];
  const long long ka = blockIdx.x;
  const int row = tails[ka];
  if (row < 0) return;
  const long long S = effective_share((long long)off[rows], share, n_blocks);
  const long long kb = ((long long)off[row + 1] - 1) / S;
  const long long g_lo = ka / kFixGroup, g_hi = kb / kFixGroup;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int col = c0 + lane;
    const bool on = col < dim;
    float total = 0.f;
    for (long long g0 = g_lo; g0 <= g_hi; g0 += kWarps) {
      const long long gg = g0 + w;
      float s = 0.f;
      if (gg <= g_hi && on) {
        const long long k_lo = gg * kFixGroup > ka ? gg * kFixGroup : ka;
        const long long k_end = gg * kFixGroup + kFixGroup - 1;
        const long long k_hi = k_end < kb ? k_end : kb;
        float v[kFixGroup];
#pragma unroll
        for (int u = 0; u < kFixGroup; ++u) {
          const long long k = k_lo + u;
          v[u] = k <= k_hi ? bpart[(k * 2 + (k == ka ? 1 : 0)) * dim + col]
                           : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kFixGroup; ++u) {
          if (k_lo + u <= k_hi) s += v[u];
        }
      }
      gsum[w][lane] = s;
      __syncthreads();
      if (w == 0) {
#pragma unroll
        for (int j = 0; j < kWarps; ++j) {
          if (g0 + j <= g_hi) total += gsum[j][lane];
        }
      }
      __syncthreads();
    }
    if (w == 0 && on) out[(long long)row * dim + col] = total;
  }
}

}  // namespace share_sum
