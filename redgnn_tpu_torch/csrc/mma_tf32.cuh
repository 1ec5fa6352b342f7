// Warp-level pieces of the dense hop's two backward walks
// (dense_hop_static_bwd.cuh, dense_hop_bwd.cuh), on Hopper (sm_90a): float32
// products on the tensor cores in the 3xTF32 split (mma.sync m16n8k8), the
// mma's fragment layout, blocks staged in a warp's shared memory in that
// layout, rows loaded and stored by pairs, and the fixed trees of shuffles
// over a fragment's lanes.
//
// The layout: a warp's 32 queries are the mma's rows. Lane l holds queries
// l/4 + 8r (r < 4) and columns 8n + 2 (l % 4) + {0, 1} of every 8-wide
// tile, the accumulator's layout, which is also an A operand once the
// contraction index of a tile is read in the order 0, 2, 4, 6, 1, 3, 5, 7
// (a B operand staged for it holds contraction rows 8k + 2 (l % 4) + {0,
// 1} at its two k slots).

#pragma once

#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>

#include "dense_hop.cuh"

namespace tc {

using dense_hop::kFull;
using dense_hop::to_f32;

template <int V>
struct Int {
  static constexpr int value = V;
};

// ---------------------------------------------------- 3xTF32 on mma.sync

// x rounded to TF32 (10 stored bits), to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x; sm_90 has no instruction for that
// conversion (it takes ~10), this is two. The tensor cores read a TF32
// operand's top 19 bits.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to ~2^-22 of |x|, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a b: one m16n8k8 tile, TF32 in, float32 accumulation
__device__ __forceinline__ void mma8(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b: one m16n8k8 tile into a fresh accumulator (a zero C operand)
__device__ __forceinline__ void mma8z(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c += a b in 3xTF32 (b = (big0, big1, small0, small1)): the small
// products, then big.big, in c itself. The tensor cores truncate their
// sums: a running accumulator carries each k-step's truncation, ~2^-23 of
// its value a step; the parameters' sums and d_hs take it (their checks:
// the chain of additions and their scale, and sum|x| of a pair's terms).
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint4 b) {
  mma8(c, as, b.x, b.y);
  mma8(c, ab, b.z, b.w);
  mma8(c, ab, b.x, b.y);
}

// The same through a fresh accumulator that a float32 add (rounded to
// nearest) takes into c: the truncation stays within the k-step's 8
// products. The attention's pre-activation takes it (alpha's relative
// error reaches every gradient of the pair).
__device__ __forceinline__ void mma3f(float (&c)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], uint4 b) {
  float t[4];
  mma8z(t, as, b.x, b.y);
  mma8(t, ab, b.z, b.w);
  mma8(t, ab, b.x, b.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// a B fragment's pair (b0, b1) split: (big0, big1, small0, small1)
__device__ __forceinline__ uint4 split2(float b0, float b1) {
  uint4 v;
  split(b0, v.x, v.z);
  split(b1, v.y, v.w);
  return v;
}

// alpha = sigmoid(x) and beta = sigmoid(-x) = 1 - alpha, each to a few ulps
// (no cancellation): one exp and one division
__device__ __forceinline__ void sigmoid_pair(float x, float& alpha,
                                             float& beta) {
  const float z = expf(-fabsf(x));  // (0, 1]
  const float s = 1.f / (1.f + z);  // sigmoid(|x|)
  const float o = z * s;            // sigmoid(-|x|)
  alpha = x >= 0.f ? s : o;
  beta = x >= 0.f ? o : s;
}

// The A fragment of rows (queries) 16 mt + l/4 (+8) and contraction
// columns 8 k + 2 (l%4) + {0, 1} from a lane's [query r][column pair]
// registers, split.
template <int C>
__device__ __forceinline__ void a_frag(const float (&x)[4][C], int mt, int k,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split(x[2 * mt][2 * k], ab[0], as[0]);
  split(x[2 * mt + 1][2 * k], ab[1], as[1]);
  split(x[2 * mt][2 * k + 1], ab[2], as[2]);
  split(x[2 * mt + 1][2 * k + 1], ab[3], as[3]);
}

// ------------------------------------------------- blocks in shared memory

// The stride of a (32, w) block staged in shared memory, w a multiple of
// 8: w itself where w % 32 is 8 or 24 (rows fall 8 banks apart), w + 8
// where it is 16; a multiple of 32 stays and its columns are swizzled
// (column c of row q at c ^ 8 (q % 4)). Either way the warp's stores of
// (row l/4 + 8r, columns 8n + 2(l%4) + {0,1}) and its fragment loads
// (rows 8k + l%4 (+4), column 8n + l/4) hit 32 different banks; four
// columns 4k .. 4k + 3 of a row stay contiguous and 16-byte aligned.
__host__ __device__ __forceinline__ int stage_stride(int w) {
  return w % 32 == 16 ? w + 8 : w;
}

__host__ __device__ __forceinline__ int sidx(int q, int c, int w) {
  return q * stage_stride(w) + (w % 32 == 0 ? (c ^ ((q & 3) << 3)) : c);
}

// ------------------------------------------------------- rows by pairs

// row[c], row[c + 1] as float (0 from n on); vec: n even and the row's
// pairs aligned (8 bytes float, 4 bytes bf16). Shared or global memory.
template <typename T>
__device__ __forceinline__ float2 ld2(const T* row, int c, int n, bool vec) {
  float2 v = make_float2(0.f, 0.f);
  if (c < n) {
    if (vec) {
      if constexpr (sizeof(T) == 4) {
        v = *reinterpret_cast<const float2*>(row + c);
      } else {
        v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + c));
      }
    } else {
      v.x = to_f32(row[c]);
      if (c + 1 < n) v.y = to_f32(row[c + 1]);
    }
  }
  return v;
}

// the same from a float or bf16 table (bf16 at run time)
__device__ __forceinline__ float2 ld2t(const void* row, int c, int n,
                                       bool vec, bool bf16) {
  return bf16 ? ld2(reinterpret_cast<const __nv_bfloat16*>(row), c, n, vec)
              : ld2(reinterpret_cast<const float*>(row), c, n, vec);
}

// row[c], row[c + 1] = x, y (up to n), evict-first (the rows are read
// back only by list_sum, after the walk)
__device__ __forceinline__ void st2(float* row, int c, int n, bool vec,
                                    float x, float y) {
  if (c < n) {
    if (vec) {
      __stcs(reinterpret_cast<float2*>(row + c), make_float2(x, y));
    } else {
      row[c] = x;
      if (c + 1 < n) row[c + 1] = y;
    }
  }
}

// ------------------------------------------------------ sums over lanes

// v summed over the eight lanes of the lane's column group (l % 4), a
// fixed tree
__device__ __forceinline__ float sum_groups(float v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 16);
  return v;
}

// v summed over the lane's quad (its query's four column lanes)
__device__ __forceinline__ float sum_quad(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

// ------------------------------------------------------------- the card

// The device's multiprocessors, asked once a device and kept (0 where the
// runtime failed: not kept).
inline int sm_count(int dev) {
  static std::mutex mu;
  static std::vector<std::pair<int, int>> memo;
  const std::lock_guard<std::mutex> lock(mu);
  for (const auto& e : memo)
    if (e.first == dev) return e.second;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  memo.emplace_back(dev, sms);
  return sms;
}

}  // namespace tc
