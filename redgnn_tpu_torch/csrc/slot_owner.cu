// Owner of each output edge slot of a frontier expansion, on Hopper
// (sm_90a).
//
// Replaces: the owner fill of redgnn_tpu/ops/frontier.py:
// expand_frontier_ranges (`:179-184`), an XLA composition and not a Pallas
// kernel: a scatter of each node's index at its first slot, then
// jax.lax.cummax. The port's plain path did the same (a scatter, then
// torch.cummax: PyTorch's 1-D scan with indices). The comment there says a
// binary search "lowers ~10x slower ... on TPU"; on this card it is the
// cheaper route. It computes, for cum the inclusive cumsum of P
// nonnegative degrees and total = cum[P - 1],
//     out[e] = the first i with cum[i] > min(e, total - 1),   e < edge_cap,
// and 0 for every slot when total is 0. That is the scatter-and-cummax
// result bit for bit: the nodes with edges have strictly increasing starts
// cum[i] - deg[i], so the owner of a slot below total is the node whose
// range holds it, and every slot at or past total (where total <=
// edge_cap) belongs to the last node with edges. Integers only: no float
// touches a slot number (edge_cap may pass 2^24).
//
// What bounds it: bytes. The bound counts cum read once and out written
// once, P*8 + edge_cap*8 bytes; the searches' reads of cum come from L2
// or L1.
//
// Design: search once a run, then walk, and store wide.
//  * Block x takes kSlots (1,024) consecutive slots, thread t the run of
//    kRun (4) consecutive slots at t * kRun: a thread's walk is serial,
//    and a small hop's time is one block's latency, so short runs beat
//    runs of 8 or 16 there, and cost little at the widest hops. Owners
//    do not decrease over slots, so the block's owners lie between those
//    of its first and last slots, found by one warp each (a 32-ary search
//    over cum: 32 lanes probe 32 points and a ballot counts those at or
//    below the target).
//  * Where the two are one node (a hub whose range covers the block, or
//    the slots past total) every slot is that node: no search at all.
//  * Else the block copies cum between the two owners into shared memory
//    when it fits (kStage entries; else the threads read cum itself), as
//    32-bit offsets from the block's first slot: the slots' offsets lie
//    in [0, kSlots), so 32-bit compares decide. A thread finds its run's
//    first owner by a binary search there, then walks forward: the next
//    slot's owner is the same node while cum[i] is past the slot, else a
//    later one. Zero-degree nodes (equal cum) are stepped over; after
//    kWalk steps the walk searches again from where it stands, so a long
//    run of them (the frontier's SENTINEL pads, sparse owners) does not
//    serialise a thread.
//  * Stores: a thread writes its owners to shared memory (one padded row a
//    thread: no bank conflicts), then each warp writes its 128 slots as
//    16-byte pairs of int64, lane by lane on consecutive addresses; an odd
//    or ragged tail is masked (an 8-byte store for a last lone slot).
//  * total is read on the device: the launch needs no host
//    synchronisation.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;                  // consecutive slots a thread
constexpr int kSlots = kRun * kThreads;  // slots a block
constexpr int kRow = kRun + 1;           // int64 a thread's staged row
constexpr int kWalk = 8;                 // steps a walk takes, then a search
constexpr int kStage = 1536;             // cum entries a block may stage
constexpr unsigned kFull = 0xffffffffu;

// The number of i in [0, n) with a[i] <= x (a non-decreasing): the first
// i with a[i] > x, or n. Called by a whole warp; every lane gets it.
__device__ __forceinline__ long long warp_rank(const long long* __restrict__ a,
                                               long long n, long long x) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // a[i] <= x below lo, a[i] > x at hi and on
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long v = lo + (lane + 1) * step - 1;
    const bool le = v < hi && a[v] <= x;
    const int c = __popc(__ballot_sync(kFull, le));
    const long long cut = lo + (long long)(c + 1) * step - 1;
    lo += (long long)c * step;
    hi = cut < hi ? cut : hi;
  }
  return lo;
}

// The first i in [lo, hi] with a[i] > x, given a[hi] > x.
template <typename T, typename I>
__device__ __forceinline__ I first_above(const T* a, I lo, I hi, T x) {
  while (lo < hi) {
    const I mid = lo + ((hi - lo) >> 1);
    if (a[mid] > x) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// A thread's run of kRun slots: slot j's value x0 + j (at most xl) and
// its owner i, a[i] > x, into row[j] as base + i: the first by a search
// in [lo, hi], the others by the walk (a[hi] > xl).
template <typename T, typename I>
__device__ __forceinline__ void fill_run(const T* a, I lo, I hi, T x0, T xl,
                                         long long base, long long* row) {
  T x = x0 < xl ? x0 : xl;
  I i = first_above<T, I>(a, lo, hi, x);
  T ci = a[i];
  row[0] = base + i;
#pragma unroll
  for (int j = 1; j < kRun; ++j) {
    x = x0 + j < xl ? x0 + j : xl;
    for (int step = 0; ci <= x; ++step) {
      if (step == kWalk) {
        i = first_above<T, I>(a, i, hi, x);
        ci = a[i];
        break;
      }
      ci = a[++i];
    }
    row[j] = base + i;
  }
}

__global__ void __launch_bounds__(kThreads)
owner_kernel(const long long* __restrict__ cum, long long* __restrict__ out,
             long long n_nodes, long long edge_cap) {
  __shared__ long long stage[kThreads * kRow];
  __shared__ int cum_st[kStage];
  __shared__ long long bounds[2];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long e0 = (long long)blockIdx.x * kSlots;
  const long long e_end = e0 + kSlots < edge_cap ? e0 + kSlots : edge_cap;
  // this warp's slots [we, we_end), as 16-byte pairs
  const long long we = e0 + (long long)w * 32 * kRun;
  const long long we_end = we + 32 * kRun < e_end ? we + 32 * kRun : e_end;
  const long long total = cum[n_nodes - 1];
  if (total <= 0) {
    const longlong2 zero = make_longlong2(0, 0);
    for (long long e = we + 2 * lane; e < we_end; e += 64) {
      if (e + 1 < we_end) {
        *reinterpret_cast<longlong2*>(out + e) = zero;
      } else {
        out[e] = 0;
      }
    }
    return;
  }
  const long long last = total - 1;
  if (w < 2) {
    const long long e = w == 0 ? e0 : e_end - 1;
    const long long r = warp_rank(cum, n_nodes, e < last ? e : last);
    if (lane == 0) bounds[w] = r;
  }
  __syncthreads();
  const long long lo = bounds[0], hi = bounds[1];
  if (lo == hi) {  // one owner for the block's slots
    const longlong2 pair = make_longlong2(lo, lo);
    for (long long e = we + 2 * lane; e < we_end; e += 64) {
      if (e + 1 < we_end) {
        *reinterpret_cast<longlong2*>(out + e) = pair;
      } else {
        out[e] = lo;
      }
    }
    return;
  }
  // two owners or more: the block's slots are below last, x in [e0,
  // e_end), and cum[lo, hi) in (e0, e_end); cum[hi] may lie far past
  const bool staged = hi - lo < kStage;
  if (staged) {
    for (long long i = tid; i <= hi - lo; i += kThreads) {
      const long long d = cum[lo + i] - e0;
      cum_st[i] = (int)(d < kSlots ? d : kSlots);
    }
    __syncthreads();
  }
  long long* row = stage + tid * kRow;
  const long long r0 = e0 + (long long)tid * kRun;
  if (r0 < e_end) {
    if (staged) {
      fill_run<int, int>(cum_st, 0, (int)(hi - lo), (int)(r0 - e0),
                         (int)(last < e_end ? last - e0 : kSlots), lo, row);
    } else {
      fill_run<long long, long long>(cum, lo, hi, r0, last, 0, row);
    }
  }
  __syncwarp();
  // the warp's 128 slots, pair q (slots 2q, 2q + 1) from lane q % 32: a
  // thread's row holds its kRun slots as kRun / 2 pairs
  long long* base = stage + (long long)(w * 32) * kRow;
  for (int q = lane; 2 * q < 32 * kRun; q += 32) {
    const long long e = we + 2 * q;
    if (e >= we_end) break;
    const long long* src = base + (q / (kRun / 2)) * kRow + 2 * (q % (kRun / 2));
    if (e + 1 < we_end) {
      *reinterpret_cast<longlong2*>(out + e) = make_longlong2(src[0], src[1]);
    } else {
      out[e] = src[0];
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// cum (n_nodes,) int64, the inclusive cumsum of nonnegative degrees; out
// (edge_cap,) int64, 16-byte aligned. `blocks` is the wrapper's plan
// (ops/frontier.py:_owner_blocks): ceil(edge_cap / 1024). Launches one
// kernel on `stream` and returns cudaGetLastError() (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments it refuses: no nodes, a negative
// edge_cap, a misaligned out, or another block count.
extern "C" int slot_owner_i64(const void* cum, void* out, long long n_nodes,
                              long long edge_cap, long long blocks,
                              void* stream) {
  if (n_nodes <= 0 || edge_cap < 0 || (uintptr_t)out % 16 != 0 ||
      blocks != (edge_cap + kSlots - 1) / kSlots || blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (edge_cap == 0) return 0;
  owner_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)cum, (long long*)out, n_nodes, edge_cap);
  return (int)cudaGetLastError();
}
