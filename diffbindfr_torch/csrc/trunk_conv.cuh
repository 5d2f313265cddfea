// Shared device code of the trunk-conv kernels (forward B1 cross, B2 pair,
// B3 knn; the backward kernels B5-B6 build on it in trunk_conv_bwd.cuh, B4
// takes its geometry and mask decisions in conv_bwd_wide.cuh / cross_bwd.cu):
// one block gathers the valid (target, source) pairs of its g owned nodes,
// then runs the whole per-pair chain on chunks of 32 pairs in shared memory
// and sums per owned node. A chunk is latency-bound (weight tiles stream
// through shared memory between barriers), so blocks in flight matter as
// much as full chunks: dense blocks take several owned nodes only when the
// owned side is long and the other side short (the la pass: 1024 atoms x
// 128 ligand rows); see launch().
//
// Per pair: distance -> mask -> 32-bin Gaussian (+ bond features) -> edge
// MLP -> [attr | tgt scalars | src scalars] -> TP-weight MLP -> l<=2
// spherical harmonics -> cb = sh @ ck -> depthwise tensor product -> sum.
//
// Activations live in shared memory as [feature][pair] tiles with a padded
// pair stride of 36 floats: a lane reads four pairs of one feature as one
// float4 (broadcast), and float4 stores of a warp hit 32 distinct banks.
// The MLPs are fp32 FMA register-tiled products (4 pairs x up to 10 columns
// per thread) with weights streamed through shared memory 8 rows at a time.
// Geometry, masks and every sum are exact fp32 (no TF32, no fast math).
// conv_sums() is the pair loop alone, so that the finalize kernels
// (conv_fin.cuh: B7-B9 with fin, B10) run it and then their epilogue on the
// block's complete sums.
//
// B11, the bf16 chain (conv_sums<MODE, true>; the JAX kernels with
// dw_dtype='bfloat16', diffbindfr_tpu/nn/pallas_conv_t.py:200-250): the MLPs
// stay fp32, but the TP weights w and the cb rows leave their products as
// bf16 tiles, the source rows are staged as bf16 beside them (half the
// footprint of fp32 tiles: they fit the fp32 plan's regions), the target
// and/or source scalars enter the TP-weight MLP rounded to bf16 where the
// reference moves them at one bf16 pass (ConvArgs::bf_tgt_sc, bf_src_sc),
// and the chain runs two pairs per packed bf16x2 register in the
// reference's order: bs = x_i * w, t = bs * cb_i, z = z + t over i, each
// product and sum rounded once (bf16x2.cuh; an fma would round once fewer).
// Every sum over pairs stays fp32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x2.cuh"

namespace dbfr {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kPairs = 32;     // pairs per chunk: one per lane of warp 0
constexpr int kStride = 36;    // padded pair stride of the activation tiles
constexpr int kKTile = 8;      // weight rows staged per step
constexpr int kMaxJ = 10;      // output columns per lane: every N <= 320
constexpr int kKnnGroup = 4;   // knn owned nodes per block (4 x 16 = 64 pairs)
constexpr int kDenseCands = 1024;  // dense mode: at most 1024 candidates per block
constexpr int kMaxGroup = 8;       // and at most 8 owned nodes, one per 128
constexpr int kMaxInPaths = 8;     // backward: TP paths reading one input column
constexpr int kHStride = 36;       // B11: bf16 tiles, pair stride in bf16 elements
constexpr int kHWords = kHStride / 2;  // and in 32-bit words (two pairs per word)

// kDense: candidates = (owned node, every node of the other side);
// kKnn: the owned targets' neighbour-list slots; kKnnRev (backward only):
// the owned sources' entries of the reverse neighbour list.
enum Mode { kDense = 0, kKnn = 1, kKnnRev = 2 };

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
  // ---- backward only (trunk_conv_bwd.cuh)
  const float* gout;     // [B, nt, dout] cotangent of out
  const float* wf2t;     // [nw, hf] = wf2^T
  const float* wf1t;     // [hf, 3 ns] = wf1^T
  const float* w2t;      // [ns, he] = w2^T
  const int* w_meta;     // [nw, 8]: a_base, mul, d1, o_base, cb_off, d3, 0, 0
  const int* in_meta;    // [din, kMaxInPaths, 8]: o_base, mul, w_idx, cb_base, d3, 0, 0, 0
  const int* rev_off;    // [B, nsrc + 1] offsets into rev_tgt / rev_src (kKnnRev)
  const int* rev_tgt;    // reverse neighbour list: target of each entry
  const int* rev_src;    // and its source
  float* d_own;          // [B, n_own, din] feature gradient of the owned side
  float* part;           // [blocks, part_stride] per-block parameter-gradient sums
  int part_stride, o_win, o_beff, o_w2, o_b2, o_wf1, o_bf1, o_wf2, o_bf2;
  int own_src, accumulate, batch;
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

// owned side: the targets (forward, and the backward's target pass) or the
// sources (the backward's source pass, own_src)
__host__ __device__ inline int n_owned(const ConvArgs& a) { return a.own_src ? a.nsrc : a.nt; }

// candidates per owned node
__host__ __device__ inline int per_owned(const ConvArgs& a, int mode) {
  return mode == kDense ? (a.own_src ? a.nt : a.nsrc) : a.k;
}

// owned nodes per block: knn blocks take 4 (64 list slots); dense blocks
// group only when the owned side is long and the other side short
__host__ __device__ inline int group_size(const ConvArgs& a, int mode) {
  if (mode != kDense) return kKnnGroup;
  return imax(1, imin(imin(kMaxGroup, kDenseCands / imax(per_owned(a, mode), 1)), n_owned(a) / 128));
}

// per (owned row, output slot) LayerNorm statistics of the finalize: the
// means of up to kMaxComp components, then 1 / sqrt(norm + eps)
constexpr int kMaxComp = 5;
constexpr int kStat = 8;

// Shared-memory plan, in 4-byte words; every region starts 16-byte aligned.
// With a finalize (out_dim > 0) the epilogue stages the mix weights in r1
// and the mixed rows in r2 (both free after the pair loop), and adds the
// output accumulator `oacc` and the LayerNorm statistics `stats`.
struct Plan {
  int r1, r2, ws, sh, acc, list, oacc, stats, misc, words;
};

__host__ __device__ inline Plan make_plan(const ConvArgs& a, int mode) {
  Plan p;
  const int ke = a.gs_n + a.nb;
  const int maxn = imax(imax(imax(a.he, a.ns), imax(a.hf, a.nw)), a.kdim);
  p.r1 = imax(3 * a.ns, a.nw) * kStride;
  p.r2 = imax(imax(a.hf, a.kdim), ke + a.he) * kStride;
  p.ws = round4(kKTile * maxn);
  p.sh = 9 * kStride;
  p.acc = round4(a.g * a.dout);
  p.list = round4(a.g * per_owned(a, mode));
  if (a.bf16_chain) {  // bf16 tiles: w in r1; cb, then the source rows, in r2
    p.r1 = imax(p.r1, round4(a.nw * kHWords));
    p.r2 = imax(p.r2, round4((a.kdim + a.din) * kHWords));
  }
  p.oacc = 0;
  p.stats = 0;
  if (a.out_dim > 0) {
    p.r1 = imax(p.r1, round4(a.mix_numel));
    p.r2 = imax(p.r2, round4(a.g * a.out_dim));
    p.oacc = round4(a.g * a.out_dim);
    p.stats = round4(a.g * a.n_slots * kStat);
  }
  p.misc = 4 * kPairs + 8;
  p.words = p.r1 + p.r2 + p.ws + p.sh + p.acc + p.list + p.oacc + p.stats + p.misc;
  return p;
}

// the larger of two plans, region by region (B10: one layout for the four
// convs of a layer)
__host__ __device__ inline Plan max_plan(const Plan& x, const Plan& y) {
  Plan p;
  p.r1 = imax(x.r1, y.r1);
  p.r2 = imax(x.r2, y.r2);
  p.ws = imax(x.ws, y.ws);
  p.sh = imax(x.sh, y.sh);
  p.acc = imax(x.acc, y.acc);
  p.list = imax(x.list, y.list);
  p.oacc = imax(x.oacc, y.oacc);
  p.stats = imax(x.stats, y.stats);
  p.misc = imax(x.misc, y.misc);
  p.words = p.r1 + p.r2 + p.ws + p.sh + p.acc + p.list + p.oacc + p.stats + p.misc;
  return p;
}

// out[n][p] = act(sum_k in[k][p] * W[k][n] + bias[n]) for the 32 pairs of a
// chunk; in/out are [rows][kStride] tiles (never the same rows), W is
// row-major [K][N] in global memory. Thread (warp w, lane l) owns pairs
// 4w..4w+3 and columns l + 32 j. BF_OUT: out is a bf16 [rows][kHStride]
// tile of the results rounded to nearest even (no activation).
template <bool BF_OUT = false>
__device__ __forceinline__ void gemm(const float* in, int K,
                                     const float* __restrict__ W,
                                     const float* __restrict__ bias, int N,
                                     float* out, bool relu, float* ws) {
  const int lane = threadIdx.x & 31;
  const int p0 = (threadIdx.x >> 5) * 4;
  float acc[4][kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int n = lane + 32 * j;
    const float bv = (bias != nullptr && n < N) ? __ldg(bias + n) : 0.f;
    acc[0][j] = bv;
    acc[1][j] = bv;
    acc[2][j] = bv;
    acc[3][j] = bv;
  }
  for (int k0 = 0; k0 < K; k0 += kKTile) {
    const int kt = min(kKTile, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kt * N; i += kThreads)
      ws[i] = __ldg(W + (size_t)k0 * N + i);
    __syncthreads();
    for (int kk = 0; kk < kt; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(in + (k0 + kk) * kStride + p0);
      const float* wr = ws + kk * N;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        if (32 * j < N) {
          const int n = lane + 32 * j;
          const float w = n < N ? wr[n] : 0.f;
          acc[0][j] = fmaf(av.x, w, acc[0][j]);
          acc[1][j] = fmaf(av.y, w, acc[1][j]);
          acc[2][j] = fmaf(av.z, w, acc[2][j]);
          acc[3][j] = fmaf(av.w, w, acc[3][j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int n = lane + 32 * j;
    if (BF_OUT && 32 * j < N && n < N) {
      const uint2 v = make_uint2(
          (uint32_t)to_bf16_bits(acc[0][j]) | ((uint32_t)to_bf16_bits(acc[1][j]) << 16),
          (uint32_t)to_bf16_bits(acc[2][j]) | ((uint32_t)to_bf16_bits(acc[3][j]) << 16));
      *reinterpret_cast<uint2*>(reinterpret_cast<uint16_t*>(out) + n * kHStride + p0) = v;
    } else if (32 * j < N && n < N) {
      float4 v = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      if (relu) {
        v.x = fmaxf(v.x, 0.f);
        v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f);
        v.w = fmaxf(v.w, 0.f);
      }
      *reinterpret_cast<float4*>(out + n * kStride + p0) = v;
    }
  }
  __syncthreads();
}

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

// Per-pair slots of the current chunk (shared memory).
struct Slots {
  int* t;      // target node
  int* s;      // source node
  int* own;    // owned node, relative to the block's first
  float* d;    // distance
  int* wcnt;   // per-warp counts of the compaction
};

// 1. Compact the valid candidates of owned nodes own0 .. own0 + g - 1 into
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
  const int n_own = n_owned(a);
  const float cut = MODE == kDense ? a.cutoff[b] : 0.f;
  int total = 0;
  for (int c0 = 0; c0 < ncand; c0 += kThreads) {
    const int c = c0 + tid;
    bool ok = false;
    int entry = 0;
    const int gl = c / per;
    const int own = own0 + gl;
    if (c < ncand && own < n_own) {
      int other = c % per;
      if (MODE == kKnn) {
        const size_t e = ((size_t)b * a.nt + own) * a.k + other;
        other = a.knn_idx[e];
        ok = a.knn_valid[e] > 0.f && other >= 0 && other < a.nsrc;
      } else {
        const int t = a.own_src ? other : own;
        const int s = a.own_src ? own : other;
        ok = a.tgt_mask[(size_t)b * a.nt + t] > 0.f && dense_valid(a, b, t, s, cut);
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

// 2. Pairs c0 .. c0 + n - 1 of the block's list (kKnnRev: of the reverse
// list, read from global memory): nodes, distance and spherical harmonics,
// one pair per lane of warp 0. The caller synchronises.
template <int MODE>
__device__ __forceinline__ void load_chunk(const ConvArgs& a, int b, int own0, const int* list,
                                           int c0, int n, Slots sl, float* shs) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int t = 0, s = 0, gl = 0;
  float vx = 0.f, vy = 0.f, vz = 0.f, d = 0.f;
  if (lane < n) {
    if (MODE == kKnnRev) {
      t = a.rev_tgt[c0 + lane];
      s = a.rev_src[c0 + lane];
      gl = s - own0;
    } else {
      const int e = list[c0 + lane];
      gl = e >> 16;
      const int other = e & 0xffff;
      t = a.own_src ? other : own0 + gl;
      s = a.own_src ? own0 + gl : other;
    }
    const PairGeo pg = pair_geo(a.tgt_pos + ((size_t)b * a.nt + t) * 3,
                                a.src_pos + ((size_t)b * a.nsrc + s) * 3, a.flip);
    vx = pg.vx;
    vy = pg.vy;
    vz = pg.vz;
    d = pg.d;
  }
  sl.t[lane] = t;
  sl.s[lane] = s;
  sl.own[lane] = gl;
  sl.d[lane] = d;
  const float nrm = sqrtf(vx * vx + vy * vy + vz * vz);
  const float den = fmaxf(nrm, 1e-9f);
  const float x = vx / den, y = vy / den, z = vz / den;
  shs[0 * kStride + lane] = 1.f;
  shs[1 * kStride + lane] = x * kSqrt3;
  shs[2 * kStride + lane] = y * kSqrt3;
  shs[3 * kStride + lane] = z * kSqrt3;
  shs[4 * kStride + lane] = kSqrt15 * x * y;
  shs[5 * kStride + lane] = kSqrt15 * y * z;
  shs[6 * kStride + lane] = kSqrt5Half * (3.f * z * z - 1.f);
  shs[7 * kStride + lane] = kSqrt15 * x * z;
  shs[8 * kStride + lane] = 0.5f * kSqrt15 * (x * x - y * y);
}

// 3. Edge-MLP input rows [Gaussian (gs_n) | bond features (nb)] -> in_rows,
// and 4. the scalar rows [tgt (ns) | src (ns)] of the TP-weight MLP input ->
// sc_rows (BF: rounded to bf16 where a.bf_tgt_sc / a.bf_src_sc say). Lanes
// beyond the chunk's n pairs are zero.
template <bool BF = false>
__device__ __forceinline__ void input_rows(const ConvArgs& a, int b, int n, Slots sl,
                                           float* in_rows, float* sc_rows) {
  const int ke = a.gs_n + a.nb;
  for (int i = threadIdx.x; i < ke * kPairs; i += kThreads) {
    const int r = i / kPairs, p = i % kPairs;
    float v = 0.f;
    if (p < n) {
      if (r < a.gs_n) {
        const float diff = sl.d[p] - a.gs_off[r];
        v = expf(a.gs_coeff * (diff * diff));
      } else {
        const size_t e = ((size_t)b * a.nt + sl.t[p]) * a.nsrc + sl.s[p];
        v = a.bond_feat[e * a.nb + (r - a.gs_n)];
      }
    }
    in_rows[r * kStride + p] = v;
  }
  for (int i = threadIdx.x; i < 2 * a.ns * kPairs; i += kThreads) {
    const int p = i / (2 * a.ns), r = i % (2 * a.ns);
    float v = 0.f;
    if (p < n) {
      v = r < a.ns ? a.tgt_x[((size_t)b * a.nt + sl.t[p]) * a.din + r]
                   : a.src_x[((size_t)b * a.nsrc + sl.s[p]) * a.din + (r - a.ns)];
      if (BF && (r < a.ns ? a.bf_tgt_sc : a.bf_src_sc)) v = __bfloat162float(__float2bfloat16_rn(v));
    }
    sc_rows[r * kStride + p] = v;
  }
}

// 5.-7. Edge MLP (h1 = relu(W1^T in + b1_eff), attr -> e[0:ns]), TP-weight
// MLP (h = relu(Wf1^T e + bf1), w = Wf2^T h + bf2) and cb = ck^T sh. The
// forward lets later tiles reuse the rows of earlier ones.
__device__ __forceinline__ void mlp_forward(const ConvArgs& a, int b, float* in_rows, float* h1,
                                            float* e, float* h, float* w, float* cb,
                                            const float* shs, float* ws) {
  const int ke = a.gs_n + a.nb;
  gemm(in_rows, ke, a.w1, a.b1 + (size_t)b * a.he, a.he, h1, true, ws);
  gemm(h1, a.he, a.w2, a.b2, a.ns, e, false, ws);
  gemm(e, 3 * a.ns, a.wf1, a.bf1, a.hf, h, true, ws);
  gemm(h, a.hf, a.wf2, a.bf2, a.nw, w, false, ws);
  gemm(shs, 9, a.ck, nullptr, a.kdim, cb, false, ws);
}

// B11: the same MLPs, with w and cb written as bf16 tiles
__device__ __forceinline__ void mlp_forward_bf16(const ConvArgs& a, int b, float* in_rows,
                                                 float* h1, float* e, float* h, float* w,
                                                 float* cb, const float* shs, float* ws) {
  const int ke = a.gs_n + a.nb;
  gemm(in_rows, ke, a.w1, a.b1 + (size_t)b * a.he, a.he, h1, true, ws);
  gemm(h1, a.he, a.w2, a.b2, a.ns, e, false, ws);
  gemm(e, 3 * a.ns, a.wf1, a.bf1, a.hf, h, true, ws);
  gemm<true>(h, a.hf, a.wf2, a.bf2, a.nw, w, false, ws);
  gemm<true>(shs, 9, a.ck, nullptr, a.kdim, cb, false, ws);
}

// B11: the chunk's source rows as a bf16 tile [din][kHStride] (lanes beyond
// n are zero); the caller synchronises
__device__ __forceinline__ void stage_src_bf16(const ConvArgs& a, int b, int n, Slots sl,
                                               uint16_t* xb) {
  for (int i = threadIdx.x; i < a.din * kPairs; i += kThreads) {
    const int p = i / a.din, c = i % a.din;
    const float v = p < n ? a.src_x[((size_t)b * a.nsrc + sl.s[p]) * a.din + c] : 0.f;
    xb[c * kHStride + p] = to_bf16_bits(v);
  }
}

// B11: thread o owns output column o: per pair of pairs, the path's chain
// z = sum_i (x_i * w) * cb_i in bf16x2, then both halves into the owners'
// fp32 sums
__device__ __forceinline__ void chain_bf16(const ConvArgs& a, int n, Slots sl, const float* r1,
                                           const float* r2, float* acc) {
  const uint32_t* wb = reinterpret_cast<const uint32_t*>(r1);
  const uint32_t* cbb = reinterpret_cast<const uint32_t*>(r2);
  const uint32_t* xb = cbb + a.kdim * kHWords;
  const int4* meta = reinterpret_cast<const int4*>(a.out_meta);
  for (int o = threadIdx.x; o < a.dout; o += kThreads) {
    const int4 m0 = meta[2 * o];      // a_base, mul, d1, w_idx
    const int4 m1 = meta[2 * o + 1];  // cb_base, d3
    const uint32_t* wr = wb + m0.w * kHWords;
    for (int pp = 0; 2 * pp < n; ++pp) {
      const uint32_t w2 = wr[pp];
      uint32_t z = 0u;
      for (int i = 0; i < m0.z; ++i) {
        const uint32_t bs = mul_bf16x2(xb[(m0.x + i * m0.y) * kHWords + pp], w2);
        const uint32_t t = mul_bf16x2(bs, cbb[(m1.x + i * m1.y) * kHWords + pp]);
        z = i == 0 ? t : add_bf16x2(z, t);
      }
      acc[sl.own[2 * pp] * a.dout + o] += lo_f32(z);
      if (2 * pp + 1 < n) acc[sl.own[2 * pp + 1] * a.dout + o] += hi_f32(z);
    }
  }
}

// The block's shared-memory regions, carved from the dynamic allocation.
struct Regions {
  float *r1, *r2, *ws, *shs, *acc, *oacc, *stats;
  int* list;
  Slots sl;
};

__device__ __forceinline__ Regions carve(const Plan& pl) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  Regions R;
  R.r1 = smem;
  R.r2 = R.r1 + pl.r1;
  R.ws = R.r2 + pl.r2;
  R.shs = R.ws + pl.ws;
  R.acc = R.shs + pl.sh;
  R.oacc = R.acc + pl.acc;
  R.stats = R.oacc + pl.oacc;
  R.list = reinterpret_cast<int*>(R.stats + pl.stats);
  R.sl.t = R.list + pl.list;
  R.sl.s = R.sl.t + kPairs;
  R.sl.own = R.sl.s + kPairs;
  R.sl.d = reinterpret_cast<float*>(R.sl.own + kPairs);
  R.sl.wcnt = reinterpret_cast<int*>(R.sl.d + kPairs);
  return R;
}

// The masked message sums of targets t0 .. t0 + g - 1 of sample b into
// R.acc [g][dout] (zeroed here). Ends after a barrier when there was a
// chunk; callers synchronise before reading acc from other threads. BF: the
// B11 chain.
template <int MODE, bool BF = false>
__device__ __forceinline__ void conv_sums(const ConvArgs& a, int b, int t0, const Regions& R) {
  const int tid = threadIdx.x;
  const Slots sl = R.sl;
  float* r1 = R.r1;
  float* r2 = R.r2;
  float* acc = R.acc;
  for (int i = tid; i < a.g * a.dout; i += kThreads) acc[i] = 0.f;

  const int total = compact_pairs<MODE>(a, b, t0, R.list, sl.wcnt);
  const int ke = a.gs_n + a.nb;
  for (int c0 = 0; c0 < total; c0 += kPairs) {
    const int n = min(kPairs, total - c0);
    load_chunk<MODE>(a, b, t0, R.list, c0, n, sl, R.shs);
    __syncthreads();
    input_rows<BF>(a, b, n, sl, r2, r1 + a.ns * kStride);
    if constexpr (BF) {
      // bf16 tiles: weights -> r1, cb -> r2, then the source rows after cb
      mlp_forward_bf16(a, b, r2, r2 + ke * kStride, r1, r2, r1, r2, R.shs, R.ws);
      stage_src_bf16(a, b, n, sl, reinterpret_cast<uint16_t*>(r2) + a.kdim * kHStride);
      __syncthreads();
      chain_bf16(a, n, sl, r1, r2, acc);
      __syncthreads();
      continue;
    }
    // edge MLP -> r2[ke:], attr -> r1[0:ns]; hidden -> r2, weights -> r1; cb -> r2
    mlp_forward(a, b, r2, r2 + ke * kStride, r1, r2, r1, r2, R.shs, R.ws);
    // 8. depthwise TP, summed per target: thread o owns output column o
    const int4* meta = reinterpret_cast<const int4*>(a.out_meta);
    for (int o = tid; o < a.dout; o += kThreads) {
      const int4 m0 = meta[2 * o];      // a_base, mul, d1, w_idx
      const int4 m1 = meta[2 * o + 1];  // cb_base, d3
      for (int p = 0; p < n; ++p) {
        const float* xs = a.src_x + ((size_t)b * a.nsrc + sl.s[p]) * a.din + m0.x;
        float zv = 0.f;
        for (int i = 0; i < m0.z; ++i)
          zv = fmaf(__ldg(xs + i * m0.y), r2[(m1.x + i * m1.y) * kStride + p], zv);
        acc[sl.own[p] * a.dout + o] += zv * r1[m0.w * kStride + p];
      }
    }
    __syncthreads();
  }
}

// Body of every forward trunk-conv kernel: block = targets t0 .. t0 + g - 1.
template <int MODE, bool BF = false>
__device__ __forceinline__ void conv_block(const ConvArgs& a) {
  const Regions R = carve(make_plan(a, MODE));
  const int b = blockIdx.y;
  const int g = a.g;
  const int t0 = blockIdx.x * g;
  conv_sums<MODE, BF>(a, b, t0, R);

  // 9. per-target sums -> out
  for (int i = threadIdx.x; i < g * a.dout; i += kThreads) {
    const int t = t0 + i / a.dout;
    if (t < a.nt) a.out[((size_t)b * a.nt + t) * a.dout + (i % a.dout)] = R.acc[i];
  }
}

template <int MODE>
inline int launch(void (*kernel)(ConvArgs), ConvArgs a, int batch, cudaStream_t st) {
  // measured on the H100 (PERF.md): grouping the la pass's 1024 atom
  // targets took B1 from 8.46 to 7.25 ms, grouping the 128 ligand rows of
  // B2 slowed it from 0.57 to 0.85 ms (fewer blocks in flight)
  a.g = group_size(a, MODE);
  const Plan pl = make_plan(a, MODE);
  const int bytes = pl.words * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.nt + a.g - 1) / a.g;
  if (tiles > 0 && batch > 0) {
    kernel<<<dim3(tiles, batch), kThreads, bytes, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace dbfr
