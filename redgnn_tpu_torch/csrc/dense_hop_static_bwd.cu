// The static dense hop's backward, on Hopper (sm_90a).
//
// Replaces: the gradient of RelAttnLayer.dense
// (redgnn_tpu/models/layers.py:159-210), which the JAX package takes by
// XLA autodiff; an XLA composition and not a Pallas kernel. The walk, the
// sums and what bounds them: dense_hop_static_bwd.cuh (its products on
// the tensor cores; the epilogue act(W_h agg) stays outside the hop). In
// bf16 the state and relation tables are bf16, as in the forward (hs + hr
// rounded to bf16 once); every gradient is float32 and no bf16 round
// enters it, so the state's gradient is the float32 sum of the pairs'
// float32 terms (a bf16 state is exact in TF32: its small half is 0); the
// tables' type is a run-time switch, not an instance.

#include "dense_hop_static_bwd.cuh"

// g (n_tail, b, d) float32: the cotangent of agg; then the forward's
// inputs (dense_hop_static.cu), hidden and rela float32 (bf16 == 0) or
// bfloat16 (bf16 == 1). Writes dhs (E, b, d) float32, erow (ceil(b / 32),
// E, d + A) and out (d A + A + 1 + b A,): d Ws transposed (d, A), d w_alpha
// (A,), d b_alpha (1,), d WQ (b, A); partial and scratch are scratch. The
// floats of out, partial and scratch are dense_hop_static_bwd_plan's.
// d <= 64, 0 < A <= 64. Returns a cudaError_t.
extern "C" int dense_hop_static_bwd(
    const void* g, const void* hidden, int bf16, const void* visited,
    const void* rela, const void* tsrc, const void* trel,
    const void* tail_rowptr, const void* item_ptr, const void* wr,
    const void* wq, const void* ws, const void* w_alpha, const void* b_alpha,
    void* dhs, void* erow, void* partial, void* out, void* scratch,
    long long n_tail,
    long long b, long long d, long long a, long long chunk, long long items,
    long long n_rel, long long n_edges, void* stream) {
  using namespace static_bwd;
  const int dp = dense_hop::padded_width(d);
  if (n_tail <= 0 || b <= 0 || d <= 0 || dp == 0 || a <= 0 || a > 64 ||
      n_rel <= 0 || n_rel > 0x7fffffffLL / 64 || chunk <= 0 ||
      chunk > dense_hop::kMaxChunk || items < n_tail ||
      items > 0x7fffffffLL || (b + 31) / 32 > 65535 ||
      n_tail * b > 0x7fffffffLL || n_edges <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  dense_hop::Walk p = {};
  p.tsrc = (const int*)tsrc;
  p.tail_rowptr = (const int*)tail_rowptr;
  p.item_ptr = (const int*)item_ptr;
  p.visited = (const unsigned char*)visited;
  p.n_tail = (int)n_tail;
  p.b = (int)b;
  p.d = (int)d;
  p.chunk = (int)chunk;
  Bwd t = {};
  t.hidden = hidden;
  t.rela = rela;
  t.bf16 = bf16 != 0;
  t.trel = (const int*)trel;
  t.ra = (const float*)wr;
  t.qa = (const float*)wq;
  t.a1 = (const float*)ws;
  t.a2 = (const float*)w_alpha;
  t.balpha = (const float*)b_alpha;
  t.g = (const float*)g;
  t.A = (int)a;
  t.R = (int)n_rel;
  t.n_edges = (int)n_edges;
  t.dhs = (float*)dhs;
  t.erow = (float*)erow;
  t.partial = (float*)partial;
  t.out = (float*)out;
  t.scratch = (float*)scratch;
  const size_t align = bf16 ? 4 : 8;
  t.vec_h = d % 2 == 0 && (uintptr_t)hidden % align == 0;
  t.vec_r = d % 2 == 0 && (uintptr_t)rela % align == 0;
  t.vec_g = d % 2 == 0 && (uintptr_t)g % 8 == 0;
  t.vec_a = a % 2 == 0 && (uintptr_t)wr % 8 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return run(p, t, items, s);
}

// The launch's plan for these shapes (dense_hop_static_bwd.cuh:make_plan):
// out[0..9) = the floats of out, partial and scratch, the warps a block,
// the blocks a query group, the most additions a term of a parameter sum
// passes through, the warps a multiprocessor, whether the relation tables
// are staged and the units an item. Returns a cudaError_t.
extern "C" int dense_hop_static_bwd_plan(long long b, long long d,
                                         long long a, long long chunk,
                                         long long items, long long n_rel,
                                         int bf16, long long* out) {
  using namespace static_bwd;
  if (b <= 0 || d <= 0 || dense_hop::padded_width(d) == 0 || a <= 0 ||
      a > 64 || n_rel <= 0 || n_rel > 0x7fffffffLL / 64 || chunk <= 0 ||
      chunk > dense_hop::kMaxChunk || items <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  return plan_of((int)d, (int)a, (int)n_rel, (int)b, items, (int)chunk,
                 bf16 ? 2 : 4, out);
}
