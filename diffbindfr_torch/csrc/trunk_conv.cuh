// Shared device code of the trunk-conv kernels: the arguments of one conv
// (ConvArgs), its geometry (pair_geo), its mask decisions (dense_valid) and
// the compaction of a block's valid candidates into a list (compact_pairs),
// which the forward wide tiles (conv_fwd_wide.cuh: B1, B7 and B11-cross in
// cross_conv.cu; B2, B8 and B11-pair in pair_conv.cu; B3, B9 and B11-knn in
// knn_conv.cu; B10 in layer_conv.cu), the backward pass (conv_bwd_wide.cuh:
// B4, B5, B6) and the backward pair lists (dense_pairs.cuh) all take; the
// finalize's shared-memory view (Regions, conv_fin.cuh) and the l <= 2
// spherical-harmonic constants.
//
// Per pair, the chain every kernel computes: distance -> mask -> 32-bin
// Gaussian (+ bond features) -> edge MLP -> [attr | tgt scalars | src
// scalars] -> TP-weight MLP -> l<=2 spherical harmonics -> cb = sh @ ck ->
// depthwise tensor product -> sum. Geometry, masks and every sum are exact
// fp32 (no TF32, no fast math), rounded step by step as the plain versions
// (nn/trunk_convs.py) round them, so that mask decisions agree.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x2.cuh"

namespace dbfr {

constexpr int kThreads = 256;  // 8 warps per block

// kDense: candidates = (owned node, every node of the other side);
// kKnn: the owned targets' neighbour-list slots.
enum Mode { kDense = 0, kKnn = 1 };

struct ConvArgs {
  const float* tgt_pos;    // [B, nt, 3]
  const float* src_pos;    // [B, nsrc, 3]
  const float* tgt_x;      // [B, nt, din] component-major
  const float* src_x;      // [B, nsrc, din] component-major
  const float* tgt_mask;   // [B, nt]
  const float* src_mask;   // [B, nsrc]
  const float* cab;        // [B, nt] or [B, nsrc] (cab_on_tgt), or null
  const float* bond_feat;  // [B, nt, nsrc, nb] or null
  const float* bond_mask;  // [B, nt, nsrc] or null
  const int* knn_idx;      // [B, nt, k] (knn mode)
  const float* knn_valid;  // [B, nt, k] (knn mode)
  const float* cutoff;     // [B]
  const float* w1;         // [gs_n + nb, he]: Gaussian rows, then bond rows
  const float* b1;         // [B, he]: b1 + temb @ W1_temb, folded per sample
  const float* w2;         // [he, ns]
  const float* b2;         // [ns]
  const float* wf1;        // [3 ns, hf]
  const float* bf1;        // [hf]
  const float* wf2;        // [hf, nw]
  const float* bf2;        // [nw]
  const float* ck;         // [9, kdim]: sh -> Cb contraction, alpha folded in
  const float* gs_off;     // [gs_n]
  const int* out_meta;     // [dout, 8]: a_base, mul, d1, w_idx, cb_base, d3, 0, 0
  float* out;              // [B, nt, dout] component-major message sums
  int nt, nsrc, din, dout, nb, k, ns, he, hf, nw, kdim, gs_n;
  float gs_coeff;
  int flip, cab_on_tgt, exclude_self;
  int g;  // owned nodes per block, set by the launcher
  // ---- B11 only: the bf16 chain, and which scalar rows of the TP-weight
  // MLP input are rounded to bf16 (target, source)
  int bf16_chain, bf_tgt_sc, bf_src_sc;
  // ---- finalize epilogue only (conv_fin.cuh)
  const float* cnt;      // [B, nt] message counts (clamped to >= 1 there)
  const float* mix_w;    // [mix_numel] irreps-Linear weight vector
  const float* ln_w;     // LayerNorm weight, one per output slot channel
  const float* ln_ms;    // LayerNorm mean shift, one per output slot channel
  const float* ln_b;     // LayerNorm bias, one per 0e channel
  const int* mix_meta;   // [out_dim, 16] (trunk_convs.FinConsts.tables)
  const int* ln_slots;   // [n_slots, 8]
  int out_dim, n_slots, mix_numel;  // out_dim = 0: no finalize
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// candidates per owned target
__host__ __device__ inline int per_owned(const ConvArgs& a, int mode) {
  return mode == kDense ? a.nsrc : a.k;
}

// per (owned row, output slot) LayerNorm statistics of the finalize: the
// means of up to kMaxComp components, then 1 / sqrt(norm + eps)
constexpr int kMaxComp = 5;
constexpr int kStat = 8;

struct PairGeo {
  float vx, vy, vz, d;
};

// vec = src - tgt (negated with flip), d = sqrt(|vec|^2 + 1e-12), rounded
// step by step exactly as the plain version so that mask decisions agree.
__device__ __forceinline__ PairGeo pair_geo(const float* tp, const float* sp, int flip) {
  float vx = __fsub_rn(sp[0], tp[0]);
  float vy = __fsub_rn(sp[1], tp[1]);
  float vz = __fsub_rn(sp[2], tp[2]);
  if (flip) {
    vx = -vx;
    vy = -vy;
    vz = -vz;
  }
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)), __fmul_rn(vz, vz));
  PairGeo g;
  g.vx = vx;
  g.vy = vy;
  g.vz = vz;
  g.d = __fsqrt_rn(__fadd_rn(d2, 1e-12f));
  return g;
}

__device__ __forceinline__ bool dense_valid(const ConvArgs& a, int b, int t, int s, float cut) {
  if (!(a.src_mask[(size_t)b * a.nsrc + s] > 0.f)) return false;
  const PairGeo g = pair_geo(a.tgt_pos + ((size_t)b * a.nt + t) * 3,
                             a.src_pos + ((size_t)b * a.nsrc + s) * 3, a.flip);
  float cab = 0.f;
  if (a.cab != nullptr)
    cab = a.cab_on_tgt ? a.cab[(size_t)b * a.nt + t] : a.cab[(size_t)b * a.nsrc + s];
  bool base = (cab > 0.f) || (g.d <= cut);
  if (a.exclude_self) base = base && (t != s);
  if (a.bond_mask != nullptr)
    base = base || (a.bond_mask[((size_t)b * a.nt + t) * a.nsrc + s] > 0.f);
  return base;
}

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt15 = 3.872983346207417f;
constexpr float kSqrt5Half = 1.118033988749895f;

// Compact the valid candidates of owned nodes own0 .. own0 + g - 1 into
// `list`, in candidate order (deterministic); entry = (owned << 16) | other.
// A masked target receives no message, so it yields no pair.
template <int MODE>
__device__ __forceinline__ int compact_pairs(const ConvArgs& a, int b, int own0, int* list,
                                             int* wcnt) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = per_owned(a, MODE);
  const int ncand = a.g * per;
  const float cut = MODE == kDense ? a.cutoff[b] : 0.f;
  int total = 0;
  for (int c0 = 0; c0 < ncand; c0 += kThreads) {
    const int c = c0 + tid;
    bool ok = false;
    int entry = 0;
    const int gl = c / per;
    const int own = own0 + gl;
    if (c < ncand && own < a.nt) {
      int other = c % per;
      if (MODE == kKnn) {
        const size_t e = ((size_t)b * a.nt + own) * a.k + other;
        other = a.knn_idx[e];
        ok = a.knn_valid[e] > 0.f && other >= 0 && other < a.nsrc;
      } else {
        ok = a.tgt_mask[(size_t)b * a.nt + own] > 0.f && dense_valid(a, b, own, other, cut);
      }
      entry = (gl << 16) | (ok ? other : 0);
    }
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = total;
    int all = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int cnt = wcnt[w];
      if (w < warp) off += cnt;
      all += cnt;
    }
    if (ok) list[off + __popc(bal & ((1u << lane) - 1u))] = entry;
    total += all;
    __syncthreads();
  }
  return total;
}

// The finalize's view of a block's shared memory (conv_fin.cuh; carved by
// conv_fwd_wide.cuh carve_fwd): r1 the mix weights, r2 the mixed rows, the
// sums acc [g][dout], the output rows oacc and the LayerNorm statistics.
struct Regions {
  float *r1, *r2, *acc, *oacc, *stats;
};

}  // namespace dbfr
