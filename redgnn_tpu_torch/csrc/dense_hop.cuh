// Shared walk of the dense hop's two kernels (dense_hop_static.cu,
// dense_hop_temporal.cu), on Hopper (sm_90a).
//
// A dense hop runs over the whole tail-sorted edge table (edges of tail v
// at [tail_rowptr[v], tail_rowptr[v + 1])), shared by a batch of b
// queries. For each (tail v, query q) it sums, over the tail's edges e
// whose source src is visited for q, a message of (hidden[src, q],
// edge e, query q), and flags v as visited for q when any edge is kept.
//
// Work: a warp takes one work item for 32 queries, lane = query. An item
// is a chunk of at most `chunk` consecutive edges of one tail; every tail
// has at least one item (an empty tail writes zeros), item_ptr[v] is the
// first item of tail v (item_ptr[n_tail] items in all, strictly
// increasing: `ops/dense_hop.py:tail_items`). Grid y is the query group
// (32 queries each), grid x the items, kWarps a block. A tail of one item
// sums its edges in table order and writes its result. A tail of several
// items: each writes its partial sums to `partial` (row = item), then
// counts itself in arrive[group, v] (an integer atomic); the item that
// arrives last adds the partials in item order and writes the result. So every
// (v, q) is the same sum in the same order on every run, whichever item
// arrives last: no float atomics.
//
// counts[0] += edges kept, counts[1] += (v, q) flagged: integer atomics,
// exact. The wrapper zeroes counts and arrive (one buffer, counts first)
// before the launch.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dense_hop {

constexpr int kWarps = 4;  // warps (items) a block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

struct Walk {
  const int* tsrc;              // (E,) source of each tail-sorted edge
  const int* tail_rowptr;       // (n_tail + 1,)
  const int* item_ptr;          // (n_tail + 1,)
  const unsigned char* visited; // (n_tail, b) bool
  float* partial;               // (items, b, d) partial sums of split tails
  int* partial_kept;            // (items, b)
  int* counts;                  // (2,) zeroed: edges kept, (v, q) flagged
  int* arrive;                  // (groups, n_tail) zeroed
  int n_tail, b, d, chunk;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// row[0, d) as float into r[0, DP), zeros past d. `vec`: d % 4 == 0 and
// the table 16-byte (float) or 8-byte (bf16) aligned, so each group of 4
// is one load.
template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int d,
                                         bool vec, float (&r)[DP]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < DP / 4; ++k) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * k < d) v = __ldg(reinterpret_cast<const float4*>(row) + k);
      r[4 * k] = v.x;
      r[4 * k + 1] = v.y;
      r[4 * k + 2] = v.z;
      r[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DP; ++i) r[i] = i < d ? __ldg(row + i) : 0.f;
  }
}

// r[i] += row[i] for i < d (float32 row, as `load_row`'s), one group of
// 4 at a time: no second DP-wide array is held.
template <int DP>
__device__ __forceinline__ void add_row(const float* __restrict__ row, int d,
                                        bool vec, float (&r)[DP]) {
#pragma unroll
  for (int k = 0; k < DP / 4; ++k) {
    if (4 * k >= d) break;
    if (vec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row) + k);
      r[4 * k] += v.x;
      r[4 * k + 1] += v.y;
      r[4 * k + 2] += v.z;
      r[4 * k + 3] += v.w;
    } else {
#pragma unroll
      for (int i = 4 * k; i < 4 * k + 4; ++i)
        if (i < d) r[i] += __ldg(row + i);
    }
  }
}

template <int DP>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ row,
                                         int d, bool vec, float (&r)[DP]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < DP / 4; ++k) {
      uint2 u = make_uint2(0u, 0u);
      if (4 * k < d) u = __ldg(reinterpret_cast<const uint2*>(row) + k);
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      r[4 * k] = lo.x;
      r[4 * k + 1] = lo.y;
      r[4 * k + 2] = hi.x;
      r[4 * k + 3] = hi.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DP; ++i) r[i] = i < d ? __bfloat162float(row[i]) : 0.f;
  }
}

// Stage a (d, A) projection (element [i][a] at w[i * si + a * sa]) into
// shared memory as [DP][Ap], zeros past d and A; a per-query (b, A) term's
// rows of this block's query group as [Ap][32] (lane-major: conflict-free
// reads); a vector (A,) as [Ap].
__device__ __forceinline__ void stage_proj(float* s, const float* __restrict__ w,
                                           int si, int sa, int dp, int d,
                                           int A, int Ap) {
  for (int k = threadIdx.x; k < dp * Ap; k += blockDim.x) {
    const int i = k / Ap, a = k - (k / Ap) * Ap;
    s[k] = (i < d && a < A) ? w[(size_t)i * si + (size_t)a * sa] : 0.f;
  }
}

__device__ __forceinline__ void stage_query(float* s, const float* __restrict__ wq,
                                            int b, int A, int Ap, int g) {
  for (int k = threadIdx.x; k < Ap * 32; k += blockDim.x) {
    const int a = k >> 5, q = g * 32 + (k & 31);
    s[k] = (a < A && q < b) ? wq[(size_t)q * A + a] : 0.f;
  }
}

__device__ __forceinline__ void stage_vec(float* s, const float* __restrict__ v,
                                          int A, int Ap) {
  for (int a = threadIdx.x; a < Ap; a += blockDim.x) s[a] = a < A ? v[a] : 0.f;
}

// init + sum_a relu(hs . s_w[:, a] + r_row[a] + s_q[a][lane]) * s_out[a]:
// the attention logit. s_w is [DP][Ap], r_row a global (A,) row (the
// edge's relation term), s_q [Ap][32], s_out [Ap]; Ap is a multiple of 8.
template <int DP>
__device__ __forceinline__ float attn_logit(const float (&hs)[DP],
                                            const float* s_w,
                                            const float* __restrict__ r_row,
                                            const float* s_q,
                                            const float* s_out, int A, int Ap,
                                            int lane, float init) {
  float logit = init;
  for (int a0 = 0; a0 < Ap; a0 += 8) {
    float pre[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      pre[k] = (a0 + k < A ? __ldg(r_row + a0 + k) : 0.f) +
               s_q[(a0 + k) * 32 + lane];
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      const float4 w0 = *reinterpret_cast<const float4*>(s_w + i * Ap + a0);
      const float4 w1 =
          *reinterpret_cast<const float4*>(s_w + i * Ap + a0 + 4);
      pre[0] = fmaf(hs[i], w0.x, pre[0]);
      pre[1] = fmaf(hs[i], w0.y, pre[1]);
      pre[2] = fmaf(hs[i], w0.z, pre[2]);
      pre[3] = fmaf(hs[i], w0.w, pre[3]);
      pre[4] = fmaf(hs[i], w1.x, pre[4]);
      pre[5] = fmaf(hs[i], w1.y, pre[5]);
      pre[6] = fmaf(hs[i], w1.z, pre[6]);
      pre[7] = fmaf(hs[i], w1.w, pre[7]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      logit = fmaf(fmaxf(pre[k], 0.f), s_out[a0 + k], logit);
  }
  return logit;
}

// 1 / (1 + e^-x), with the accurate expf (no fast-math intrinsics)
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The item of this warp: tail v, its first item, its item count and the
// edge range [e0, e1). False when the warp has no item.
struct Item {
  int v, first, n, e0, e1;
};

__device__ __forceinline__ bool item_of(const Walk& p, int w, Item& it) {
  if (w >= __ldg(p.item_ptr + p.n_tail)) return false;
  int lo = 0, hi = p.n_tail - 1;  // last v with item_ptr[v] <= w
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(p.item_ptr + mid) <= w) lo = mid;
    else hi = mid - 1;
  }
  it.v = lo;
  it.first = __ldg(p.item_ptr + lo);
  it.n = __ldg(p.item_ptr + lo + 1) - it.first;
  const int end = __ldg(p.tail_rowptr + lo + 1);
  it.e0 = __ldg(p.tail_rowptr + lo) + (w - it.first) * p.chunk;
  it.e1 = min(it.e0 + p.chunk, end);
  return true;
}

// Close the item: a split tail's item stores its partials and the last
// to arrive sums them in item order. Returns false for the items that
// leave the result to another; the one that writes it has (acc, kept) of
// the whole tail and has added its counts.
template <int DP>
__device__ __forceinline__ bool close_item(const Walk& p, const Item& it,
                                           int w, int q, bool active,
                                           float (&acc)[DP], int& kept) {
  const int lane = threadIdx.x & 31;
  if (it.n > 1) {
    if (active) {
      float* dst = p.partial + ((size_t)w * p.b + q) * p.d;
#pragma unroll
      for (int i = 0; i < DP; ++i)
        if (i < p.d) dst[i] = acc[i];
      p.partial_kept[(size_t)w * p.b + q] = kept;
    }
    __threadfence();
    __syncwarp();
    int last = 0;
    int* arrive = p.arrive + (size_t)blockIdx.y * p.n_tail + it.v;
    if (lane == 0) last = atomicAdd(arrive, 1) == it.n - 1;
    if (!__shfl_sync(kFull, last, 0)) return false;
    __threadfence();
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] = 0.f;
    kept = 0;
    if (active) {
      // unrolled: four partials' loads in flight (a hub tail has hundreds)
#pragma unroll 4
      for (int j = 0; j < it.n; ++j) {
        const size_t r = (size_t)(it.first + j) * p.b + q;
        const float* src = p.partial + r * p.d;
#pragma unroll
        for (int i = 0; i < DP; ++i)
          if (i < p.d) acc[i] += __ldcg(src + i);
        kept += __ldcg(p.partial_kept + r);
      }
    }
  }
  const int n_kept = __reduce_add_sync(kFull, active ? kept : 0);
  const int n_new = __reduce_add_sync(kFull, (active && kept > 0) ? 1 : 0);
  if (lane == 0) {
    if (n_kept) atomicAdd(p.counts, n_kept);
    if (n_new) atomicAdd(p.counts + 1, n_new);
  }
  return true;
}

// The smallest of 8, 16, 24, 32, 48, 64 that holds d (0 past 64).
inline int padded_width(long long d) {
  if (d <= 8) return 8;
  if (d <= 16) return 16;
  if (d <= 24) return 24;
  if (d <= 32) return 32;
  if (d <= 48) return 48;
  if (d <= 64) return 64;
  return 0;
}

}  // namespace dense_hop
