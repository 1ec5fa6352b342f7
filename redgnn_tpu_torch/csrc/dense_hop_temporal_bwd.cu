// The temporal dense hop's backward, on Hopper (sm_90a).
//
// Replaces: the gradient of TRedGNN._dense_hop
// (redgnn_tpu/models/temporal.py:461-572), which the JAX package takes by
// XLA autodiff; an XLA composition and not a Pallas kernel. The walk, the
// sums and what bounds them: dense_hop_bwd.cuh. This file is its entry
// point for the temporal model: the cotangent of h is taken back through
// the visited mask, the activation (its derivative from h alone) and the
// dropout mask once per (tail, query) where a warp's walk reaches the
// tail; the ablation switches (use_time, use_attention, the linear or bias
// direction transform) are run-time flags, which keeps nvcc's time down:
// one tensor-core instance a (hidden, attention) width pair (hidden 8, 16,
// 24, 32 by attention 8, 32, 64), one scalar instance at hidden 48 and 64.
// The direction transform stays per (edge, query), as in the forward.

#include "dense_hop_bwd.cuh"

// g, h (n_tail, b, d) float32: the cotangent of the hop's output h and h
// itself; new_visited (n_tail, b) bool; drop (n_tail, b, d) bool or null,
// drop_div the kept scale's divisor; act 0-5; then the forward's inputs
// (dense_hop_temporal.cu). Writes dhs (E, b, d), dmsg (E, b, d) (with
// use_time, else null), erow (ceil(b / 32), E, d + A) and out (d A + A +
// 3 d^2 (linear; bias: 3 d) + b A,): d A1s (d, A), d a2 (A,), d W (3, d,
// d) or d B (3, d), d QA (b, A); partial and scratch are scratch. The
// floats of out, partial and scratch are dense_hop_temporal_bwd_plan's.
// d <= 64, A <= 64. Returns a cudaError_t.
extern "C" int dense_hop_temporal_bwd(
    const void* g, const void* h, const void* new_visited, const void* drop,
    const void* hidden, const void* visited, const void* rela,
    const void* tsrc, const void* trel, const void* ttime,
    const void* tail_rowptr, const void* item_ptr, const void* times,
    const void* excl, const void* ekeep, const void* tt, const void* ra,
    const void* qa, const void* a1s, const void* a2, const void* wdir,
    const void* bdir, void* dhs, void* dmsg, void* erow, void* partial,
    void* out, void* scratch, float drop_div, int act, long long n_tail,
    long long b,
    long long d, long long a, long long chunk, long long items,
    long long n_rel, long long n_edges, int use_time, int use_attn,
    int linear, void* stream) {
  using namespace dense_hop_bwd;
  const int dp = dense_hop::padded_width(d);
  if (n_tail <= 0 || b <= 0 || d <= 0 || dp == 0 || a < 0 || a > 64 ||
      (use_attn && a == 0) || n_rel <= 0 || n_rel > 0x7fffffffLL / 64 ||
      chunk <= 0 || chunk > dense_hop::kMaxChunk || items < n_tail ||
      items > 0x7fffffffLL || (b + 31) / 32 > 65535 ||
      n_tail * b > 0x7fffffffLL || n_edges <= 0 ||
      n_edges * b * d > 0x7fffffffffffLL || act < 0 || act > 5 ||
      (use_time && (!tt || !dmsg)) || (linear ? !wdir : !bdir) ||
      (use_attn && (!ra || !qa || !a1s || !a2))) {
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
  t.hidden = (const float*)hidden;
  t.rela = (const float*)rela;
  t.trel = (const int*)trel;
  t.ttime = (const int*)ttime;
  t.times = (const int*)times;
  t.excl = (const unsigned char*)excl;
  t.ekeep = (const unsigned char*)ekeep;
  t.tt = use_time ? (const float*)tt : nullptr;
  t.ra = (const float*)ra;
  t.qa = (const float*)qa;
  t.a1 = (const float*)a1s;
  t.a2 = (const float*)a2;
  t.wdir = (const float*)wdir;
  t.bdir = (const float*)bdir;
  t.g = (const float*)g;
  t.h = (const float*)h;
  t.new_visited = (const unsigned char*)new_visited;
  t.drop = (const unsigned char*)drop;
  t.drop_div = drop_div;
  t.act = act;
  t.A = use_attn ? (int)a : 0;
  t.R = (int)n_rel;
  t.flags = (use_time ? kTime : 0) | (use_attn ? kAttn : 0) |
            (linear ? kLinear : 0);
  t.n_edges = (int)n_edges;
  t.dhs = (float*)dhs;
  t.dmsg = use_time ? (float*)dmsg : nullptr;
  t.erow = (float*)erow;
  t.partial = (float*)partial;
  t.out = (float*)out;
  t.scratch = (float*)scratch;
  t.vec_h = d % 4 == 0 && (uintptr_t)hidden % 16 == 0;
  t.vec_t = d % 4 == 0 && (uintptr_t)tt % 16 == 0;
  t.st16 = d % 4 == 0 && (uintptr_t)dhs % 16 == 0 &&
           (uintptr_t)dmsg % 16 == 0;
  t.vec_g = d % 2 == 0 && (uintptr_t)g % 8 == 0 && (uintptr_t)h % 8 == 0;
  t.vec_w = d % 2 == 0 && (uintptr_t)wdir % 8 == 0;
  t.vec_r = d % 4 == 0 && (uintptr_t)rela % 16 == 0;
  t.vec_g4 = d % 4 == 0 && (uintptr_t)g % 16 == 0;
  t.vec_o = d % 4 == 0 && (uintptr_t)h % 16 == 0;
  return run(p, t, items, (cudaStream_t)stream);
}

// The launch's plan for these shapes (dense_hop_bwd.cuh:plan_of): out[0..9)
// = the floats of out, partial and scratch, the warps a block, the blocks a
// query group, the most additions a term of a parameter sum passes
// through, the warps a multiprocessor, the relation tables staged (1 or 0)
// and the units an item. Returns a cudaError_t.
extern "C" int dense_hop_temporal_bwd_plan(long long b, long long d,
                                           long long a, long long chunk,
                                           long long items, long long n_rel,
                                           int use_time, int use_attn,
                                           int linear, long long* out) {
  using namespace dense_hop_bwd;
  if (b <= 0 || d <= 0 || dense_hop::padded_width(d) == 0 || a < 0 ||
      a > 64 || (use_attn && a == 0) || n_rel <= 0 ||
      n_rel > 0x7fffffffLL / 64 || chunk <= 0 ||
      chunk > dense_hop::kMaxChunk || items <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int f = (use_time ? kTime : 0) | (use_attn ? kAttn : 0) |
                (linear ? kLinear : 0);
  return plan_of((int)d, f, use_attn ? (int)a : 0, (int)n_rel, (int)b, items,
                 (int)chunk, out);
}
