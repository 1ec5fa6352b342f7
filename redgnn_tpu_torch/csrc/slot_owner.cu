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
// or shared memory.
//
// Design: block x takes kSlots consecutive slots. Its first and last
// slots' owners are found by one warp each, a 32-ary search over cum (each
// step, 32 lanes probe 32 points and a ballot counts those at or below the
// target: 4 dependent loads for 10^6 nodes). Every owner in the block lies
// between the two, so the block copies cum over that range into shared
// memory when it fits (kStage entries) and each thread finds its slots'
// owners by a binary search there (else in cum itself). Slots go to
// threads in strides of the block size, so the writes are coalesced.
// total is read on the device: the launch needs no host synchronisation.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4 * kThreads;  // slots a block
constexpr int kStage = 2048;          // cum entries a block may stage
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

// The first i in [lo, hi] with a[i - base] > x, given a[hi - base] > x.
__device__ __forceinline__ long long first_above(const long long* a,
                                                 long long base, long long lo,
                                                 long long hi, long long x) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (a[mid - base] > x) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
owner_kernel(const long long* __restrict__ cum, long long* __restrict__ out,
             long long n_nodes, long long edge_cap) {
  __shared__ long long stage[kStage];
  __shared__ long long bounds[2];
  const int tid = threadIdx.x, w = tid >> 5;
  const long long e0 = (long long)blockIdx.x * kSlots;
  const long long e_end = e0 + kSlots < edge_cap ? e0 + kSlots : edge_cap;
  const long long total = cum[n_nodes - 1];
  if (total <= 0) {
    for (long long e = e0 + tid; e < e_end; e += kThreads) out[e] = 0;
    return;
  }
  const long long last = total - 1;
  if (w < 2) {
    const long long e = w == 0 ? e0 : e_end - 1;
    const long long r = warp_rank(cum, n_nodes, e < last ? e : last);
    if ((tid & 31) == 0) bounds[w] = r;
  }
  __syncthreads();
  const long long lo = bounds[0], hi = bounds[1];
  const long long span = hi - lo + 1;
  const bool staged = span <= kStage;
  if (staged) {
    for (long long i = tid; i < span; i += kThreads) stage[i] = cum[lo + i];
    __syncthreads();
  }
  for (long long e = e0 + tid; e < e_end; e += kThreads) {
    const long long x = e < last ? e : last;
    out[e] = staged ? first_above(stage, lo, lo, hi, x)
                    : first_above(cum, 0, lo, hi, x);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// cum (n_nodes,) int64, the inclusive cumsum of nonnegative degrees; out
// (edge_cap,) int64. Launches one kernel on `stream` and returns
// cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue for
// arguments it refuses: no nodes, or a negative edge_cap.
extern "C" int slot_owner_i64(const void* cum, void* out, long long n_nodes,
                              long long edge_cap, void* stream) {
  if (n_nodes <= 0 || edge_cap < 0) return (int)cudaErrorInvalidValue;
  if (edge_cap == 0) return 0;
  const long long blocks = (edge_cap + kSlots - 1) / kSlots;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  owner_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)cum, (long long*)out, n_nodes, edge_cap);
  return (int)cudaGetLastError();
}
