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
// is a chunk of at most `chunk` (<= 32) consecutive edges of one tail;
// every tail has at least one item (an empty tail writes zeros),
// item_ptr[v] is the first item of tail v (item_ptr[n_tail] items in all,
// strictly increasing: `ops/dense_hop.py:tail_items`, chunks of
// EDGE_CHUNK = 16 edges, the wrapper's one constant, so a graph sums in
// one order on every card). Grid y is the query group (32 queries each),
// grid x the items, kWarps a block. A tail of one item sums its edges in table
// order and writes its result. A tail of several items: each writes its
// partial sums to `partial` (row = item), then counts itself in
// arrive[group, v] (an integer atomic); the item that arrives last adds
// the partials in item order, a few rows' loads in flight at a time, and
// writes the result. So every (v, q) is the same sum in the same order on
// every run, whichever item arrives last: no float atomics.
//
// The walk of an item: the warp finds its tail with a 32-ary search of
// item_ptr (a few rounds of one load a lane, not a chain of log2 N
// loads), lane k loads edge e0 + k's indices (one coalesced load each),
// then every lane loads the visited bytes of all the chunk's sources for
// its query at once (independent loads, all in flight) and keeps a bit
// mask of the edges it keeps. Each lane then walks its own kept edges in
// table order, the edge's indices taken from their lane by a shuffle: the
// warp runs as many steps as its busiest lane keeps edges, so an edge no
// lane keeps costs nothing, and on a sparse hop a lane is not held on
// edges only other lanes keep. A step's only global loads are the lane's
// state row (and time-term row), issued together: the per-relation terms
// and relation rows are staged in shared memory once a block where they
// fit (kTableBytes), so no step waits on a chain of loads.
//
// What the card measured (PR 14, tests and chip_smoke.py phase 7i on an
// H100): what cut a step's time was taking the relation rows out of
// global memory, and chunks of 16 cut the busiest warps (8 was slower
// at every served call, 32 at all but ICEWS14's sparsest); blocks of 8
// warps were 4-10% slower and blocks that loop over items no faster, so
// neither is kept. A per-warp ring of state rows filled by cp.async was
// not timed and is not kept.
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
constexpr int kMaxChunk = 32;  // a chunk's edges: one a lane
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

// Four values of a row at element 4k as float: one 16-byte (float) or
// 8-byte (bf16) load where `vec`, else four loads of the first `n` (the
// rest 0).
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int k,
                                        int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row) + k);
  const float* r = row + 4 * k;
  return make_float4(n > 0 ? __ldg(r) : 0.f, n > 1 ? __ldg(r + 1) : 0.f,
                     n > 2 ? __ldg(r + 2) : 0.f, n > 3 ? __ldg(r + 3) : 0.f);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* __restrict__ row,
                                        int k, int n, bool vec) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + k);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  const __nv_bfloat16* r = row + 4 * k;
  return make_float4(n > 0 ? to_f32(r[0]) : 0.f, n > 1 ? to_f32(r[1]) : 0.f,
                     n > 2 ? to_f32(r[2]) : 0.f, n > 3 ? to_f32(r[3]) : 0.f);
}

// row[0, d) as float into r[0, DP), zeros past d. `vec`: d % 4 == 0 and
// the table 16-byte (float) or 8-byte (bf16) aligned.
template <int DP, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int d,
                                         bool vec, float (&r)[DP]) {
#pragma unroll
  for (int k = 0; k < DP / 4; ++k) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * k < d) v = load4(row, k, d - 4 * k, vec);
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
}

// r[i] += row[i] for i < d, row a table row in shared or global memory
// (plain loads: 16-byte ones where `vec`), four values at a time.
template <int DP, typename T>
__device__ __forceinline__ void add_table_row(const T* row, int d, bool vec,
                                              float (&r)[DP]) {
#pragma unroll
  for (int k = 0; k < DP / 4; ++k) {
    if (4 * k >= d) break;
    float4 v;
    if (sizeof(T) == 4 && vec) {
      v = reinterpret_cast<const float4*>(row)[k];
    } else {
      const int n = d - 4 * k;
      const T* e = row + 4 * k;
      v = make_float4(to_f32(e[0]), n > 1 ? to_f32(e[1]) : 0.f,
                      n > 2 ? to_f32(e[2]) : 0.f, n > 3 ? to_f32(e[3]) : 0.f);
    }
    r[4 * k] += v.x;
    r[4 * k + 1] += v.y;
    r[4 * k + 2] += v.z;
    r[4 * k + 3] += v.w;
  }
}

// Copy n elements of a global table into shared memory, eight loads in
// flight a thread before their stores.
template <typename T>
__device__ __forceinline__ void stage_table(T* s, const T* __restrict__ g,
                                            int n) {
  for (int k0 = threadIdx.x; k0 < n; k0 += 8 * blockDim.x) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < n) v[u] = g[k];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < n) s[k] = v[u];
    }
  }
}

// Shared memory a block may give the relation tables (the per-relation
// attention term and the relation rows): where they fit they are staged
// once a block, else each lane reads its edge's rows from global memory.
constexpr int kTableBytes = 64 * 1024;

// Stage a (d, A) projection (element [i][a] at w[i * si + a * sa]) into
// shared memory column-major, [A][DP] (zeros past d), so a column is DP
// contiguous floats that the warp reads as broadcast float4s; a per-query
// (b, A) term's rows of this block's query group as [A][32] (lane-major:
// conflict-free reads); a vector (A,) as [A].
__device__ __forceinline__ void stage_proj(float* s, const float* __restrict__ w,
                                           int si, int sa, int dp, int d,
                                           int A) {
#pragma unroll 4
  for (int k = threadIdx.x; k < A * dp; k += blockDim.x) {
    const int a = k / dp, i = k - (k / dp) * dp;
    s[k] = i < d ? w[(size_t)i * si + (size_t)a * sa] : 0.f;
  }
}

__device__ __forceinline__ void stage_query(float* s, const float* __restrict__ wq,
                                            int b, int A, int g) {
#pragma unroll 4
  for (int k = threadIdx.x; k < A * 32; k += blockDim.x) {
    const int a = k >> 5, q = g * 32 + (k & 31);
    s[k] = q < b ? wq[(size_t)q * A + a] : 0.f;
  }
}

__device__ __forceinline__ void stage_vec(float* s, const float* __restrict__ v,
                                          int A) {
  for (int a = threadIdx.x; a < A; a += blockDim.x) s[a] = v[a];
}

// init + sum_a relu(r_row[a] + s_q[a][lane] + hs . s_w[a]) * s_out[a]:
// the attention logit. s_w is [A][DP] (column a's DP weights contiguous),
// r_row the edge's (A,) relation term (shared or global memory), s_q
// [A][32], s_out [A]. Each column's pre-activation is summed in order of
// i, then the columns in order of a. Two columns at a time: two
// independent chains.
template <int DP>
__device__ __forceinline__ float attn_logit(const float (&hs)[DP],
                                            const float* s_w,
                                            const float* r_row,
                                            const float* s_q,
                                            const float* s_out, int A,
                                            int lane, float init) {
  float logit = init;
#pragma unroll 2
  for (int a = 0; a < A; ++a) {
    float pre = r_row[a] + s_q[a * 32 + lane];
    const float* w = s_w + a * DP;
#pragma unroll
    for (int i = 0; i < DP; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + i);
      pre = fmaf(hs[i], v.x, pre);
      pre = fmaf(hs[i + 1], v.y, pre);
      pre = fmaf(hs[i + 2], v.z, pre);
      pre = fmaf(hs[i + 3], v.w, pre);
    }
    logit = fmaf(fmaxf(pre, 0.f), s_out[a], logit);
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
  // the last v with item_ptr[v] <= w: item_ptr[lo] <= w holds throughout
  // (item_ptr[0] = 0) and v lies in [lo, lo + len); a round cuts the range
  // into 32 steps, lane k tests the start of step k, and item_ptr rises
  // strictly, so the lanes that pass are a prefix
  const int lane = threadIdx.x & 31;
  int lo = 0, len = p.n_tail;
  while (len > 1) {
    const int step = (len + 31) >> 5;
    const int at = lo + lane * step;
    const bool le = at < lo + len && __ldg(p.item_ptr + at) <= w;
    const int k = __popc(__ballot_sync(kFull, le)) - 1;
    lo += k * step;
    len = min(step, len - k * step);
  }
  it.v = lo;
  it.first = __ldg(p.item_ptr + lo);
  it.n = __ldg(p.item_ptr + lo + 1) - it.first;
  const int end = __ldg(p.tail_rowptr + lo + 1);
  it.e0 = __ldg(p.tail_rowptr + lo) + (w - it.first) * p.chunk;
  it.e1 = min(it.e0 + p.chunk, end);
  return true;
}

// The chunk of an item, staged: lane k holds edge e0 + k's source (and
// the kernel's other per-edge indices, loaded beside it); `mine` has bit
// j set where this lane keeps edge e0 + j.
struct Chunk {
  int src;       // tsrc[e0 + lane] (0 past the chunk)
  unsigned mine;  // the lane's kept edges of the chunk
};

// Stage the sources and the visited bits: all the chunk's visited loads
// of a lane are independent and in flight together. `edge_ok` (bit j:
// edge e0 + j may be kept at all) and, where `ekeep` is given, its (E, b)
// byte per (edge, query) narrow the mask.
__device__ __forceinline__ Chunk stage_chunk(const Walk& p, const Item& it,
                                             int q, bool active,
                                             unsigned edge_ok,
                                             const unsigned char* ekeep) {
  const int lane = threadIdx.x & 31;
  const int ne = it.e1 - it.e0;
  Chunk c;
  c.src = lane < ne ? __ldg(p.tsrc + it.e0 + lane) : 0;
  c.mine = 0;
#pragma unroll
  for (int j = 0; j < kMaxChunk; ++j) {
    if (j >= ne) break;
    const int src = __shfl_sync(kFull, c.src, j);
    bool keep = active && ((edge_ok >> j) & 1u) &&
                p.visited[(size_t)src * p.b + q];
    if (ekeep) keep = keep && ekeep[(size_t)(it.e0 + j) * p.b + q];
    c.mine |= (unsigned)keep << j;
  }
  return c;
}

// The next kept edge of the lane (its offset j in the chunk, or -1), taken
// off its mask.
__device__ __forceinline__ int next_edge(unsigned& mine) {
  const int j = __ffs(mine) - 1;
  mine &= mine - 1;
  return j;
}

// Close the item: a split tail's item stores its partials and the last
// to arrive sums them in item order, kRows items' rows in flight at a
// time. Returns false for the items that leave the result to another; the
// one that writes it has (acc, kept) of the whole tail and has added its
// counts.
template <int DP>
__device__ __forceinline__ bool close_item(const Walk& p, const Item& it,
                                           int w, int q, bool active,
                                           float (&acc)[DP], int& kept) {
  constexpr int kRows = DP <= 16 ? 8 : DP <= 24 ? 4 : DP <= 32 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const bool vec = p.d % 4 == 0;  // partial rows are 16-byte aligned then
  if (it.n > 1) {
    if (active) {
      float* dst = p.partial + ((size_t)w * p.b + q) * p.d;
      if (vec) {
#pragma unroll
        for (int k = 0; k < DP / 4; ++k)
          if (4 * k < p.d)
            reinterpret_cast<float4*>(dst)[k] = make_float4(
                acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < DP; ++i)
          if (i < p.d) dst[i] = acc[i];
      }
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
      for (int j0 = 0; j0 < it.n; j0 += kRows) {
        float rows[kRows][DP];
        int k_rows[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const bool in = j0 + r < it.n;
          const size_t row = (size_t)(it.first + j0 + r) * p.b + q;
          const float* src = p.partial + row * p.d;
#pragma unroll
          for (int k = 0; k < DP / 4; ++k) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (in && 4 * k < p.d) {
              if (vec) {
                v = __ldcg(reinterpret_cast<const float4*>(src) + k);
              } else {
                const int n = p.d - 4 * k;
                v.x = __ldcg(src + 4 * k);
                if (n > 1) v.y = __ldcg(src + 4 * k + 1);
                if (n > 2) v.z = __ldcg(src + 4 * k + 2);
                if (n > 3) v.w = __ldcg(src + 4 * k + 3);
              }
            }
            rows[r][4 * k] = v.x;
            rows[r][4 * k + 1] = v.y;
            rows[r][4 * k + 2] = v.z;
            rows[r][4 * k + 3] = v.w;
          }
          k_rows[r] = in ? __ldcg(p.partial_kept + row) : 0;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (j0 + r >= it.n) break;
#pragma unroll
          for (int i = 0; i < DP; ++i) acc[i] += rows[r][i];
          kept += k_rows[r];
        }
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
