// The forward chain of a trunk conv over 64-pair wide tiles, for blocks
// that own their targets (B10, layer_conv.cu; B1 and B7, cross_conv.cu;
// B3 and B9, knn_conv.cu; B2 and B8, pair_conv.cu). Replaces the per-pair
// chain of the Pallas whole-layer kernel (diffbindfr_tpu/nn/pallas_layer.py:
// make_layer_conv, the pallas_call at :552), of the cross conv kernels
// (nn/pallas_conv_t.py:make_cross_conv_t, :693; nn/pallas_conv.py:
// make_cross_conv, :1008), of the knn conv kernels (nn/pallas_conv_t.py:
// make_knn_conv_t, :935; nn/pallas_conv.py:make_knn_conv, :1225) and of the
// pair conv kernels (nn/pallas_conv_t.py:make_pair_conv_t, :433; nn/
// pallas_conv.py:make_pair_conv, :653): a
// block compacts the valid candidates of its g owned targets into a list in
// candidate order (trunk_conv.cuh compact_pairs: target-major, then source
// index or neighbour slot), walks the list in tiles of 64 pairs, and per
// tile computes
//   pair_geo (exact fp32) -> sh, Gaussian rows [| bond features]
//   -> edge MLP h1 = relu(W1^T in + b1[sample]), attr = W2^T h1 + b2
//   -> [attr | tgt scalars | src scalars] -> h = relu(Wf1^T e + bf1)
//   -> w = Wf2^T h + bf2, cb = ck^T sh -> the depthwise TP message,
// and adds each pair's message to its target's sum in list order (thread o
// owns output column o, so every sum has one fixed order): the block ends
// with the complete sums of its targets in shared memory, for the
// finalize epilogue (conv_fin.cuh). Activations are feature-major tiles
// [rows][kWideS]; the MLPs are conv_bwd_wide.cuh's register-tiled products
// (warp w: pairs 8w .. 8w + 7, lane l: columns l + 32 j), so a staged
// weight element feeds 64 pairs, with the weights streamed in 16-row
// cp.async stages, two deep.
// Bound on the H100: fp32 FMA in the MLPs (operations); the TP is ~2% of
// them, its source rows staged in shared memory 32 pairs at a time.
//
// BF (B11-cross, cross_conv.cu; B11-pair, pair_conv.cu; B11-knn,
// knn_conv.cu): the bf16 depthwise chain of the JAX kernels with
// dw_dtype='bfloat16' (diffbindfr_tpu/nn/pallas_conv_t.py:222-250,
// _dw_paths_t), rounded where the JAX kernels round: the target and/or
// source scalars enter the TP-weight MLP rounded to bf16 where the
// reference moves them at one bf16 pass (ConvArgs::bf_tgt_sc, bf_src_sc:
// B11-pair the target's, B11-knn both, B11-cross per direction); the MLPs
// stay fp32; w = Wf2^T h + bf2 and cb = ck^T sh leave their products
// rounded to bf16, as packed tiles [rows][kWideSW words] (a masked pair
// never reaches the list, so w * mask is w); the tile's source rows are
// staged as bf16 in the same layout, all 64 pairs at once; and thread o
// runs output column o's chain two pairs per bf16x2 register in the
// reference's order, bs = x_i * w, t = bs * cb_i, z = z + t over i
// ascending, each product and sum rounded once (bf16x2.cuh: mul.rn and
// add.rn, never an fma), then adds each half to its target's fp32 running
// sum in list order. Half-size w and cb tiles leave p2 the size of e, so a
// block holds more rows of sums (fwd_plan).
#pragma once

#include "conv_bwd_wide.cuh"
#include "conv_fin.cuh"

namespace dbfr {

constexpr int kSmemWords = 232448 / 4;  // the H100's shared memory per block
constexpr int kTpPairs = 32;  // source rows staged per step of the TP

// Shared-memory plan of a forward wide block, in 4-byte words. p1: h1, h,
// then cb (and the finalize's output rows); p2: the edge input, e, then w
// (and the finalize's mix weights); ws: the weight stages, then the TP's
// staged source rows. With a.bf16_chain (BF) w, cb and the source rows are
// bf16 tiles of kWideSW words per row.
struct FwdPlan {
  int p1, p2, sh, ws, ck, acc, oacc, stats, list, misc, words;
};

__host__ __device__ inline FwdPlan fwd_plan(const ConvArgs& a, int mode) {
  FwdPlan p;
  const int ke = a.gs_n + a.nb;
  const int ws = round4(2 * kWideKT * 32 * ((imax(imax(a.he, a.ns), imax(a.hf, a.nw)) + 31) / 32));
  if (a.bf16_chain) {
    p.p1 = imax(imax(imax(a.he, a.hf) * kWideS, round4(a.kdim * kWideSW)), round4(a.g * a.out_dim));
    p.p2 = imax(imax(imax(ke, 3 * a.ns) * kWideS, round4(a.nw * kWideSW)), round4(a.mix_numel));
    p.ws = imax(ws, round4(a.din * kWideSW));
  } else {
    p.p1 = imax(imax(imax(a.he, a.hf), a.kdim) * kWideS, round4(a.g * a.out_dim));
    p.p2 = imax(imax(imax(ke, 3 * a.ns), a.nw) * kWideS, round4(a.mix_numel));
    p.ws = imax(ws, kTpPairs * round4(a.din));
  }
  p.sh = 9 * kWideS;
  p.ck = round4(9 * a.kdim);
  p.acc = round4(a.g * a.dout);
  p.oacc = round4(a.g * a.out_dim);
  p.stats = round4(a.g * a.n_slots * kStat);
  p.list = round4(a.g * per_owned(a, mode));
  p.misc = 4 * kWideTile + 8;
  p.words = p.p1 + p.p2 + p.sh + p.ws + p.ck + p.acc + p.oacc + p.stats + p.list + p.misc;
  return p;
}

// the larger of two plans, region by region (B10, B1 and B7: one layout for
// the convs or directions of one grid)
__host__ __device__ inline FwdPlan max_fwd_plan(const FwdPlan& x, const FwdPlan& y) {
  FwdPlan p;
  p.p1 = imax(x.p1, y.p1);
  p.p2 = imax(x.p2, y.p2);
  p.sh = imax(x.sh, y.sh);
  p.ws = imax(x.ws, y.ws);
  p.ck = imax(x.ck, y.ck);
  p.acc = imax(x.acc, y.acc);
  p.oacc = imax(x.oacc, y.oacc);
  p.stats = imax(x.stats, y.stats);
  p.list = imax(x.list, y.list);
  p.misc = imax(x.misc, y.misc);
  p.words = p.p1 + p.p2 + p.sh + p.ws + p.ck + p.acc + p.oacc + p.stats + p.list + p.misc;
  return p;
}

// A plan whose finalize (a.out_dim > 0) runs once, after the sums (B7, B8,
// B9): its output rows and LayerNorm statistics take the weight-stage
// region, free by then, so they cost no rows of sums.
__host__ __device__ inline FwdPlan fin_after_sums(FwdPlan p, const ConvArgs& a) {
  if (a.out_dim > 0) {
    p.ws = imax(p.ws, p.oacc + p.stats);
    p.oacc = p.stats = 0;
    p.words = p.p1 + p.p2 + p.sh + p.ws + p.ck + p.acc + p.list + p.misc;
  }
  return p;
}

// The regions of a forward wide block; R holds the finalize's view of them
// (conv_fin.cuh: r1 the mix weights, r2 the mixed rows, acc, oacc, stats).
struct FwdRegions {
  float *p1, *p2, *shs, *ws, *ck;
  int* list;
  int *sl_t, *sl_s, *sl_own, *wcnt;
  float* sl_d;
  Regions R;
};

__device__ __forceinline__ FwdRegions carve_fwd(const FwdPlan& pl) {
  extern __shared__ float4 smem_f4[];
  FwdRegions F;
  F.p1 = reinterpret_cast<float*>(smem_f4);
  F.p2 = F.p1 + pl.p1;
  F.shs = F.p2 + pl.p2;
  F.ws = F.shs + pl.sh;
  F.ck = F.ws + pl.ws;
  F.R = {};
  F.R.r1 = F.p2;
  F.R.r2 = F.p1;
  F.R.acc = F.ck + pl.ck;
  F.R.oacc = F.R.acc + pl.acc;
  F.R.stats = F.R.oacc + pl.oacc;
  F.list = reinterpret_cast<int*>(F.R.stats + pl.stats);
  F.sl_t = F.list + pl.list;
  F.sl_s = F.sl_t + kWideTile;
  F.sl_own = F.sl_s + kWideTile;
  F.sl_d = reinterpret_cast<float*>(F.sl_own + kWideTile);
  F.wcnt = reinterpret_cast<int*>(F.sl_d + kWideTile);
  return F;
}

// The messages of the tile's pairs 0 .. nvalid - 1, added in order to
// their targets' sums. The source rows of kTpPairs pairs at a time are
// staged in the weight-stage region (coalesced, free here: L1 cannot hold
// the tile's rows beside the shared memory); then thread o owns output
// column o, keeps a running sum while consecutive pairs share a target, and
// adds it to acc[target][o] when the target changes or the step ends.
__device__ __forceinline__ void tile_messages(const ConvArgs& a, int b, int nvalid,
                                              const FwdRegions& F) {
  const float* cb = F.p1;
  const float* w = F.p2;
  float* xs = F.ws;
  const int ldx = round4(a.din);
  const int4* meta = reinterpret_cast<const int4*>(a.out_meta);
  const float* xb = a.src_x + (size_t)b * a.nsrc * a.din;
  const bool vec = a.din % 4 == 0 && ((uintptr_t)a.src_x & 15) == 0;
  for (int c0 = 0; c0 < nvalid; c0 += kTpPairs) {
    const int n = imin(kTpPairs, nvalid - c0);
    if (vec) {
      const int q4 = a.din / 4;
      for (int i = threadIdx.x; i < n * q4; i += kThreads) {
        const int p = i / q4, q = i % q4;
        reinterpret_cast<float4*>(xs + p * ldx)[q] =
            __ldg(reinterpret_cast<const float4*>(xb + (size_t)F.sl_s[c0 + p] * a.din) + q);
      }
    } else {
      for (int i = threadIdx.x; i < n * a.din; i += kThreads) {
        const int p = i / a.din, q = i % a.din;
        xs[p * ldx + q] = __ldg(xb + (size_t)F.sl_s[c0 + p] * a.din + q);
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < a.dout; o += kThreads) {
      const int4 m0 = meta[2 * o];      // a_base, mul, d1, w_idx
      const int4 m1 = meta[2 * o + 1];  // cb_base, d3
      int cur = F.sl_own[c0];
      float run = 0.f;
      for (int j0 = 0; j0 < n; j0 += 4) {
        // four pairs: w and cb as float4 along the pair axis (a quarter-warp's
        // rows then fill the 32 banks once), x clamped into the staged rows
        const int p0 = c0 + j0;
        const float4 wv = *reinterpret_cast<const float4*>(w + m0.w * kWideS + p0);
        float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kTpD; ++i) {
          if (i >= m0.z) break;
          const float4 c = *reinterpret_cast<const float4*>(cb + (m1.x + i * m1.y) * kWideS + p0);
          const float* x = xs + m0.x + i * m0.y;
          z[0] = fmaf(x[j0 * ldx], c.x, z[0]);
          z[1] = fmaf(x[imin(j0 + 1, n - 1) * ldx], c.y, z[1]);
          z[2] = fmaf(x[imin(j0 + 2, n - 1) * ldx], c.z, z[2]);
          z[3] = fmaf(x[imin(j0 + 3, n - 1) * ldx], c.w, z[3]);
        }
        const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j0 + u >= n) break;
          const int own = F.sl_own[p0 + u];
          if (own != cur) {
            F.R.acc[cur * a.dout + o] += run;
            run = 0.f;
            cur = own;
          }
          run = fmaf(z[u], wq[u], run);
        }
      }
      F.R.acc[cur * a.dout + o] += run;
    }
    __syncthreads();
  }
}

// BF: the messages of the tile's pairs 0 .. nvalid - 1 through the bf16
// chain, added in order to their targets' sums. w (p2) and cb (p1) are bf16
// tiles; the source rows are staged here as one more, [din][kWideSW words]
// in the weight-stage region (pairs beyond nvalid zero). Thread o owns
// output column o and reads four pairs of a row as one uint2 (a half-warp's
// consecutive rows, kWideSW = 34 words apart, then fill the 32 banks once):
// two bf16x2 chains, then each half into the running sum of its target,
// which is added to acc[target][o] when the target changes, as
// tile_messages does. Starts after, and ends with, a barrier.
__device__ __forceinline__ void tile_messages_bf16(const ConvArgs& a, int b, int nvalid,
                                                   const FwdRegions& F) {
  const uint32_t* cb = reinterpret_cast<const uint32_t*>(F.p1);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(F.p2);
  uint32_t* xs = reinterpret_cast<uint32_t*>(F.ws);
  const int4* meta = reinterpret_cast<const int4*>(a.out_meta);
  const float* xb = a.src_x + (size_t)b * a.nsrc * a.din;
  const int nw4 = (nvalid + 3) / 4 * 2;  // words of the pairs the chain reads
  for (int i = threadIdx.x; i < nw4 * a.din; i += kThreads) {
    const int q = i / a.din, c = i % a.din;  // consecutive threads: one pair's row
    const int p = 2 * q;
    const float v0 = p < nvalid ? __ldg(xb + (size_t)F.sl_s[p] * a.din + c) : 0.f;
    const float v1 = p + 1 < nvalid ? __ldg(xb + (size_t)F.sl_s[p + 1] * a.din + c) : 0.f;
    xs[c * kWideSW + q] = (uint32_t)to_bf16_bits(v0) | ((uint32_t)to_bf16_bits(v1) << 16);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < a.dout; o += kThreads) {
    const int4 m0 = meta[2 * o];      // a_base, mul, d1, w_idx
    const int4 m1 = meta[2 * o + 1];  // cb_base, d3
    const uint32_t* wr = w + m0.w * kWideSW;
    int cur = F.sl_own[0];
    float run = 0.f;
    for (int j0 = 0; j0 < nvalid; j0 += 4) {
      const int q = j0 / 2;
      const uint2 wv = *reinterpret_cast<const uint2*>(wr + q);
      uint32_t z0 = 0u, z1 = 0u;
#pragma unroll
      for (int i = 0; i < kTpD; ++i) {
        if (i >= m0.z) break;
        const uint2 x = *reinterpret_cast<const uint2*>(xs + (m0.x + i * m0.y) * kWideSW + q);
        const uint2 c = *reinterpret_cast<const uint2*>(cb + (m1.x + i * m1.y) * kWideSW + q);
        const uint32_t t0 = mul_bf16x2(mul_bf16x2(x.x, wv.x), c.x);
        const uint32_t t1 = mul_bf16x2(mul_bf16x2(x.y, wv.y), c.y);
        z0 = i == 0 ? t0 : add_bf16x2(z0, t0);
        z1 = i == 0 ? t1 : add_bf16x2(z1, t1);
      }
      const float zf[4] = {lo_f32(z0), hi_f32(z0), lo_f32(z1), hi_f32(z1)};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u >= nvalid) break;
        const int own = F.sl_own[j0 + u];
        if (own != cur) {
          F.R.acc[cur * a.dout + o] += run;
          run = 0.f;
          cur = own;
        }
        run += zf[u];
      }
    }
    F.R.acc[cur * a.dout + o] += run;
  }
  __syncthreads();
}

// The masked message sums of targets t0 .. t0 + g - 1 of sample b into
// F.R.acc [g][dout] (zeroed here). MODE: kDense (every source of the other
// side, the ConvArgs' mask rules) or kKnn (the neighbour slots); BF: the
// bf16 chain (a.bf16_chain set, the plan fwd_plan gives it). Ends after a
// barrier. Inlined into its kernel, so that the block's pointers and
// sizes stay in registers: through a call they live in local memory and are
// reloaded after every store to shared memory.
template <int MODE, bool BF = false>
__device__ __forceinline__ void wide_conv_sums(const ConvArgs& a, int b, int t0,
                                               const FwdRegions& F) {
  const int tid = threadIdx.x;
  const int ns = a.ns, he = a.he, ke = a.gs_n + a.nb;
  float* acc = F.R.acc;
  for (int i = tid; i < a.g * a.dout; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < 9 * a.kdim; i += kThreads) F.ck[i] = __ldg(a.ck + i);
  const int total = compact_pairs<MODE>(a, b, t0, F.list, F.wcnt);
  __syncthreads();
  for (int c0 = 0; c0 < total; c0 += kWideTile) {
    const int nvalid = imin(kWideTile, total - c0);
    // 1. the tile's pairs: nodes, distance, spherical harmonics (0 beyond nvalid)
    if (tid < kWideTile) {
      const int p = tid;
      int t = 0, s = 0, gl = 0;
      float x = 0.f, y = 0.f, z = 0.f, d = 0.f, on = 0.f;
      if (p < nvalid) {
        const int e = F.list[c0 + p];
        gl = e >> 16;
        t = t0 + gl;
        s = e & 0xffff;
        const PairGeo g = pair_geo(a.tgt_pos + ((size_t)b * a.nt + t) * 3,
                                   a.src_pos + ((size_t)b * a.nsrc + s) * 3, a.flip);
        const float nrm = sqrtf(g.vx * g.vx + g.vy * g.vy + g.vz * g.vz);
        const float den = fmaxf(nrm, 1e-9f);
        x = g.vx / den;
        y = g.vy / den;
        z = g.vz / den;
        d = g.d;
        on = 1.f;
      }
      F.sl_t[p] = t;
      F.sl_s[p] = s;
      F.sl_own[p] = gl;
      F.sl_d[p] = d;
      float* sh = F.shs;
      sh[0 * kWideS + p] = on;
      sh[1 * kWideS + p] = x * kSqrt3;
      sh[2 * kWideS + p] = y * kSqrt3;
      sh[3 * kWideS + p] = z * kSqrt3;
      sh[4 * kWideS + p] = kSqrt15 * x * y;
      sh[5 * kWideS + p] = kSqrt15 * y * z;
      sh[6 * kWideS + p] = on * kSqrt5Half * (3.f * z * z - 1.f);
      sh[7 * kWideS + p] = kSqrt15 * x * z;
      sh[8 * kWideS + p] = 0.5f * kSqrt15 * (x * x - y * y);
    }
    __syncthreads();
    // 2. edge input rows [Gaussian | bond features] -> p2
    for (int i = tid; i < ke * kWideTile; i += kThreads) {
      const int r = i / kWideTile, p = i % kWideTile;
      float v = 0.f;
      if (p < nvalid) {
        if (r < a.gs_n) {
          const float diff = F.sl_d[p] - a.gs_off[r];
          v = expf(a.gs_coeff * (diff * diff));
        } else {
          const size_t e = ((size_t)b * a.nt + F.sl_t[p]) * a.nsrc + F.sl_s[p];
          v = a.bond_feat[e * a.nb + (r - a.gs_n)];
        }
      }
      F.p2[r * kWideS + p] = v;
    }
    // 3. edge MLP: h1 -> p1[0:he], attr -> p2[0:ns]
    wide_gemm(F.p2, ke, a.w1, he, a.b1 + (size_t)b * he, nullptr, 1, nullptr, F.p1, nvalid,
              F.ws);
    wide_gemm(F.p1, he, a.w2, ns, a.b2, nullptr, 0, nullptr, F.p2, nvalid, F.ws);
    // 4. the target and source scalar rows -> p2[ns:3ns]
    for (int i0 = 0; i0 < 2 * ns * kWideTile; i0 += kWideU * kThreads) {
      float v[kWideU];  // unconditional loads (pair clamped), all in flight together
#pragma unroll
      for (int u = 0; u < kWideU; ++u) {
        const int i = imin(i0 + u * kThreads + tid, 2 * ns * kWideTile - 1);
        const int p = imin(i / (2 * ns), nvalid - 1), r = i % (2 * ns);
        v[u] = r < ns ? a.tgt_x[((size_t)b * a.nt + F.sl_t[p]) * a.din + r]
                      : a.src_x[((size_t)b * a.nsrc + F.sl_s[p]) * a.din + (r - ns)];
        if (BF && (r < ns ? a.bf_tgt_sc : a.bf_src_sc))
          v[u] = __bfloat162float(__float2bfloat16_rn(v[u]));
      }
#pragma unroll
      for (int u = 0; u < kWideU; ++u) {
        const int i = i0 + u * kThreads + tid;
        const int p = i / (2 * ns), r = i % (2 * ns);
        if (i < 2 * ns * kWideTile) F.p2[(ns + r) * kWideS + p] = p < nvalid ? v[u] : 0.f;
      }
    }
    // 5. TP-weight MLP: h -> p1, w -> p2 (BF: a bf16 tile)
    wide_gemm(F.p2, 3 * ns, a.wf1, a.hf, a.bf1, nullptr, 1, nullptr, F.p1, nvalid, F.ws);
    wide_gemm<BF>(F.p1, a.hf, a.wf2, a.nw, a.bf2, nullptr, 0, nullptr, F.p2, nvalid, F.ws);
    // 6. cb = ck^T sh -> p1 (h is used up); BF: a bf16 tile, two pairs per word
    if constexpr (BF) {
      uint32_t* cbw = reinterpret_cast<uint32_t*>(F.p1);
      for (int i = tid; i < a.kdim * (kWideTile / 2); i += kThreads) {
        const int r = i / (kWideTile / 2), q = i % (kWideTile / 2);
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int m = 0; m < 9; ++m) {
          const float ck = F.ck[m * a.kdim + r];
          v0 = fmaf(F.shs[m * kWideS + 2 * q], ck, v0);
          v1 = fmaf(F.shs[m * kWideS + 2 * q + 1], ck, v1);
        }
        cbw[r * kWideSW + q] = (uint32_t)to_bf16_bits(v0) | ((uint32_t)to_bf16_bits(v1) << 16);
      }
    } else {
      for (int i = tid; i < a.kdim * kWideTile; i += kThreads) {
        const int r = i / kWideTile, p = i % kWideTile;
        float v = 0.f;
#pragma unroll
        for (int m = 0; m < 9; ++m) v = fmaf(F.shs[m * kWideS + p], F.ck[m * a.kdim + r], v);
        F.p1[r * kWideS + p] = v;
      }
    }
    __syncthreads();
    // 7. the messages, summed per target in list order
    if constexpr (BF)
      tile_messages_bf16(a, b, nvalid, F);
    else
      tile_messages(a, b, nvalid, F);
  }
}

// The sums of targets t0 .. t0 + g - 1 of sample b (BF: the bf16 chain),
// then (FIN) their finalize in the weight-stage region (the plan of
// fin_after_sums), written to a.out: the rows of one block of B1, B7 and
// B11-cross (cross_conv.cu), of B3, B9 and B11-knn (knn_conv.cu) and of
// B2, B8 and B11-pair (pair_conv.cu).
// Inlined per call, so that the kernel parameters stay where the compiler
// can address them statically.
template <int MODE, bool FIN, bool BF = false>
__device__ __forceinline__ void wide_rows(const ConvArgs& a, int b, int t0, FwdRegions F) {
  wide_conv_sums<MODE, BF>(a, b, t0, F);  // ends after a barrier: acc complete, ws free
  if constexpr (FIN) {
    F.R.oacc = F.ws;
    F.R.stats = F.ws + round4(a.g * a.out_dim);
    init_oacc(a, b, t0, nullptr, F.R);
    fin_epilogue(a, b, t0, F.R);
    store_oacc(a, b, t0, a.out, F.R);
  } else {
    for (int i = threadIdx.x; i < a.g * a.dout; i += kThreads) {
      const int t = t0 + i / a.dout;
      if (t < a.nt) a.out[((size_t)b * a.nt + t) * a.dout + (i % a.dout)] = F.R.acc[i];
    }
  }
}

}  // namespace dbfr
