// The wide-tile pair pass of a trunk conv's backward (B4, cross_bwd.cu, for
// each direction of the cross conv; B5, pair_bwd.cu, for the pair conv; B6,
// knn_bwd.cu, for the knn conv). It replaces the Pallas backward kernels'
// per-pair chain (diffbindfr_tpu/nn/pallas_conv_t.py, make_cross_bwd_t,
// make_pair_bwd_t, make_knn_bwd_t) for one direction of a conv, given a list
// of the valid pairs (target, source, sample) built by the caller. The pair
// count is a host integer (B4 and B5, which read it) or a device word (B6,
// whose list and grid are sized by every neighbour slot): tiles at and
// beyond a device count write zero columns, so that the contractions over
// the whole scratch see zeros there. The edge MLP's input rows are the
// Gaussian rows of the pair's distance, then (B5) its nb bond features.
//
// A block takes 64 consecutive pairs of the list and, per pair, recomputes
// the forward chain (geometry, Gaussian rows, edge MLP, TP-weight MLP, sh,
// cb) and runs its backward, with g = d loss / d out of the pair's target:
//   dw_j = sum_k g[o_k] sum_i x_src[a_i] cb[i, k]      (TP weights)
//   dx_src = w_j sum_k g[o_k] cb[i, k]                 (TP input)
//   dh = relu'(h) (Wf2 dw), de = Wf1 dh, dh1 = relu'(h1) (W2 de[0:ns])
// It writes, feature-major ([features][pairs], the pairs along the
// contiguous axis, the TPU kernels' cmT orientation), every row that a
// parameter gradient contracts: the edge-MLP input, h1, dh1, de[0:ns], e,
// dh, h and dw (WideRows); and, pair-major, each pair's contribution to its
// target's scalars (de[ns:2ns]) and to its source's features (the TP-input
// gradient plus de[2ns:3ns]), each at the row the caller maps the pair to
// (tgt_at / src_at: node-major order). The caller contracts the rows over all
// pairs into the parameter gradients (abt_gemm.cuh) and sums the pair rows
// per node in a fixed order: no scratch row per block, no atomics.
//
// Bound on the H100: fp32 FMA in the MLP products (operations: ~2.6e5 per
// pair and direction at ns = 48). The products are register-tiled over the
// 64-pair tile: warp w owns pairs 8w .. 8w + 7, lane l output columns
// l + 32 j, so one staged weight element feeds 64 pairs; the weights stream
// through shared memory in slices of 16 rows by cp.async, two stages. The
// tensor-product part (~4% of the operations) runs two pairs per warp at a
// time, with each pair's cotangent row, source feature row and cb row
// staged once into shared memory. Masks were decided when the
// list was built; geometry rounds exactly as the forward's (pair_geo).
#pragma once

#include "abt_gemm.cuh"
#include "trunk_conv.cuh"

namespace dbfr {

constexpr int kWideTile = 64;              // pairs per block
constexpr int kWideS = kWideTile + 4;      // pair stride of the feature-major tiles
constexpr int kWideSW = kWideS / 2;  // and of a bf16 tile, in 32-bit words (two pairs each)
constexpr int kWideKT = 16;                // weight rows per cp.async stage
constexpr int kTpD = 5;  // largest component count of a TP path (l <= 2)
constexpr int kWideU = 8;  // global loads per thread issued together before use
constexpr int kWideWarps = kThreads / 32;  // 8 warps x 8 pairs

// Rows of one direction's feature-major scratch [total][ld]
struct WideRows {
  int in, h1, dh1, dea, e, dh, h, dw, total;
};

__host__ __device__ inline WideRows wide_rows(int ke, int he, int ns, int hf, int nw) {
  WideRows r;
  int o = 0;
  r.in = o;
  o += ke;
  r.h1 = o;
  o += he;
  r.dh1 = o;
  o += he;
  r.dea = o;
  o += ns;
  r.e = o;
  o += 3 * ns;
  r.dh = o;
  o += hf;
  r.h = o;
  o += hf;
  r.dw = o;
  o += nw;
  r.total = o;
  return r;
}

struct WideArgs {
  const int* pair_t;  // [P] target node, source node and sample of each pair
  const int* pair_s;
  const int* pair_b;
  int P, ld;  // pairs; row stride of the scratch (a multiple of kWideTile)
  const int* P_dev;  // the pair count on the device, read in place of P (null: P)
  const float* tgt_pos;  // [B, nt, 3]
  const float* src_pos;  // [B, nsrc, 3]
  int flip;              // vec = src - tgt, negated with flip
  const float* tgt_x;    // [B, nt, din] component-major
  const float* src_x;    // [B, nsrc, din]
  const float* gout;     // [B, nt, dout] cotangent of the target's message sum
  int nt, nsrc, din, dout, ns, he, hf, nw, kdim, gs_n;
  float gs_coeff;
  const float* bond_feat;  // [B, nt, nsrc, nb] the edge MLP's extra input rows (nb = 0: none)
  int nb;
  const float* w1;    // [gs_n + nb, he] the edge MLP's Gaussian rows, then its bond rows
  const float* beff;  // [B, he] its bias with the time embedding folded in
  const float* w2;    // [he, ns]
  const float* b2;    // [ns]
  const float* w2t;   // [ns, he]
  const float* wf1;   // [3 ns, hf]
  const float* bf1;   // [hf]
  const float* wf2;   // [hf, nw]
  const float* bf2;   // [nw]
  const float* wf1t;  // [hf, 3 ns]
  const float* wf2t;  // [nw, hf]
  const float* ck;    // [9, kdim]
  const float* gs_off;  // [gs_n]
  const int4* w_meta;   // [nw]: a_base, mul, o_base, cb_off | d1 << 16 | d3 << 24
  const int* in_off;    // [din + 1]: the entries of in_ent per input column
  const int4* in_ent;   // [n_in]: o_base, mul, w_idx, cb_base | d3 << 16
  int n_in;
  float* rows;      // [WideRows.total, ld]
  float* tgt_rows;  // [ld, ns] d / d target scalars, per pair
  float* src_rows;  // [ld, din] d / d source features, per pair
  const int* tgt_at;  // the row of pair p in tgt_rows (null: row p)
  const int* src_at;  // and in src_rows
};

// Shared-memory plan, in 4-byte words (every region a multiple of 4)
struct WidePlan {
  int a, b, sh, ws, ck, wm, io, ie, slots, words;
};

__host__ __device__ inline WidePlan wide_plan(const WideArgs& a) {
  WidePlan p;
  const int maxn = 32 * ((imax(imax(imax(a.he, a.ns), imax(a.hf, a.nw)), 3 * a.ns) + 31) / 32);
  p.a = (a.he + imax(3 * a.ns, a.nw)) * kWideS;  // h1 | e, then w / dw, then de
  p.b = imax(imax(a.gs_n + a.nb, a.hf), a.he) * kWideS;  // in, then h / dh, then dh1
  p.sh = 9 * kWideS;
  // weight slices, two stages; in the TP phase two staging rows per warp
  p.ws = round4(imax(2 * kWideKT * maxn, 2 * kWideWarps * round4(a.dout + a.din + a.kdim)));
  p.ck = round4(9 * a.kdim);
  p.wm = 4 * a.nw;
  p.io = round4(a.din + 1);
  p.ie = 4 * a.n_in;
  p.slots = 4 * kWideTile;
  p.words = p.a + p.b + p.sh + p.ws + p.ck + p.wm + p.io + p.ie + p.slots;
  return p;
}

// One slice of W (rows k0 .. k0 + kt - 1, N columns) into a shared-memory
// stage whose rows are Np = 32 J floats apart, columns N .. Np - 1 zero, by
// cp.async (16-byte copies where N is a multiple of 4).
__device__ __forceinline__ void stage_weights(float* dst, const float* __restrict__ W, int k0,
                                              int kt, int N, int Np) {
  if (N % 4 == 0) {
    const int q = Np / 4;
    for (int c = threadIdx.x; c < kt * q; c += kThreads) {
      const int r = c / q, c4 = 4 * (c % q);
      const bool in = c4 < N;
      cp_async16(dst + r * Np + c4, in ? W + (size_t)(k0 + r) * N + c4 : W, in ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < kt * Np; c += kThreads) {
      const int r = c / Np, col = c % Np;
      const bool in = col < N;
      cp_async4(dst + c, in ? W + (size_t)(k0 + r) * N + col : W, in ? 4 : 0);
    }
  }
  cp_async_commit();
}

// out[n][p] = act(sum_k in[k][p] W[k][n] + bias) for the tile's pairs, J =
// ceil(N / 32) column groups: in and out are [rows][kWideS] tiles, W
// row-major [K][N] in global memory. Each k step loads the warp's 8 input
// values (two broadcast float4) and the lane's J weights before its 8 J
// FMAs, so the loads of the next steps overlap them. bias: null, per column
// (bias[n]), or, with bias_b, per pair's sample (bias[bias_b[p] * N + n]).
// act: 0 none, 1 ReLU, 2 keep where mask[n][p] > 0 (mask may be out: each
// element is read by the thread that writes it). Pairs at and beyond
// nvalid get 0. BF_OUT: out is a bf16 tile [rows][kWideSW words] (two pairs
// per word, the first in the low half) of the results rounded to nearest
// even. Starts and ends with a barrier.
template <int J, bool BF_OUT = false>
__device__ __noinline__ void wide_gemm_j(const float* in, int K, const float* __restrict__ W,
                                         int N, const float* __restrict__ bias,
                                         const int* bias_b, int act, const float* mask,
                                         float* out, int nvalid, float* ws) {
  constexpr int Np = 32 * J;
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = (tid >> 5) * 8;
  float acc[8][J];
  if (bias == nullptr) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = 0.f;
  } else {  // unconditional loads (column clamped), all in flight together
    int row[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) row[i] = bias_b ? bias_b[p0 + i] * N : 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int n = imin(lane + 32 * j, N - 1);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = __ldg(bias + row[i] + n);
    }
  }
  const int steps = (K + kWideKT - 1) / kWideKT;
  __syncthreads();  // `in` complete, ws free
  for (int s = 0; s <= steps; ++s) {
    if (s < steps)  // stage slice s while slice s - 1 is used
      stage_weights(ws + (s & 1) * kWideKT * Np, W, s * kWideKT, imin(kWideKT, K - s * kWideKT),
                    N, Np);
    if (s == 0) continue;
    if (s < steps)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int k0 = (s - 1) * kWideKT;
    const int kt = imin(kWideKT, K - k0);
    const float* wsb = ws + ((s - 1) & 1) * kWideKT * Np + lane;
    const float* ib = in + k0 * kWideS + p0;
    auto step = [&](int kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(ib + kk * kWideS);
      const float4 x1 = *reinterpret_cast<const float4*>(ib + kk * kWideS + 4);
      float w[J];
#pragma unroll
      for (int j = 0; j < J; ++j) w[j] = wsb[kk * Np + 32 * j];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        acc[0][j] = fmaf(x0.x, w[j], acc[0][j]);
        acc[1][j] = fmaf(x0.y, w[j], acc[1][j]);
        acc[2][j] = fmaf(x0.z, w[j], acc[2][j]);
        acc[3][j] = fmaf(x0.w, w[j], acc[3][j]);
        acc[4][j] = fmaf(x1.x, w[j], acc[4][j]);
        acc[5][j] = fmaf(x1.y, w[j], acc[5][j]);
        acc[6][j] = fmaf(x1.z, w[j], acc[6][j]);
        acc[7][j] = fmaf(x1.w, w[j], acc[7][j]);
      }
    };
    if (kt == kWideKT) {
#pragma unroll 4
      for (int kk = 0; kk < kWideKT; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < kt; ++kk) step(kk);
    }
    __syncthreads();  // slice s - 1 used up: the next stage may overwrite it
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int n = lane + 32 * j;
    if (n >= N) continue;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x = acc[i][j];
      if (act == 1) x = fmaxf(x, 0.f);
      if (act == 2 && !(mask[n * kWideS + p0 + i] > 0.f)) x = 0.f;
      v[i] = p0 + i < nvalid ? x : 0.f;
    }
    if constexpr (BF_OUT) {
      uint32_t q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (uint32_t)to_bf16_bits(v[2 * i]) | ((uint32_t)to_bf16_bits(v[2 * i + 1]) << 16);
      uint2* o = reinterpret_cast<uint2*>(reinterpret_cast<uint32_t*>(out) + n * kWideSW + p0 / 2);
      o[0] = make_uint2(q[0], q[1]);
      o[1] = make_uint2(q[2], q[3]);
    } else {
      float* o = out + n * kWideS + p0;
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  __syncthreads();
}

template <bool BF_OUT = false>
__device__ __forceinline__ void wide_gemm(const float* in, int K, const float* __restrict__ W,
                                          int N, const float* __restrict__ bias,
                                          const int* bias_b, int act, const float* mask,
                                          float* out, int nvalid, float* ws) {
#define DBFR_WIDE_J(j) \
  case j:              \
    wide_gemm_j<j, BF_OUT>(in, K, W, N, bias, bias_b, act, mask, out, nvalid, ws); \
    break;
  switch ((N + 31) / 32) {
    DBFR_WIDE_J(1)
    DBFR_WIDE_J(2)
    DBFR_WIDE_J(3)
    DBFR_WIDE_J(4)
    DBFR_WIDE_J(5)
    DBFR_WIDE_J(6)
    DBFR_WIDE_J(7)
    DBFR_WIDE_J(8)
    DBFR_WIDE_J(9)
    DBFR_WIDE_J(10)
  }
#undef DBFR_WIDE_J
}

// dst[0 .. n4) <- src[0 .. n4) by one warp, kWideU float4 loads per lane in
// flight together (indices clamped, so every load is unconditional)
__device__ __forceinline__ void stage_row4(const float4* __restrict__ src, int n4, float4* dst,
                                           int lane) {
  for (int i0 = 0; i0 < n4; i0 += 32 * kWideU) {
    float4 t[kWideU];
#pragma unroll
    for (int u = 0; u < kWideU; ++u) t[u] = __ldg(src + imin(i0 + 32 * u + lane, n4 - 1));
#pragma unroll
    for (int u = 0; u < kWideU; ++u)
      if (i0 + 32 * u + lane < n4) dst[i0 + 32 * u + lane] = t[u];
  }
}

// rows r0 .. r0 + n - 1 of the scratch, columns tile0 .. tile0 + 63 <- tile
__device__ __forceinline__ void store_rows(const float* tile, int n, float* __restrict__ rows,
                                           int r0, int ld, int tile0) {
  for (int i = threadIdx.x; i < n * (kWideTile / 4); i += kThreads) {
    const int r = i / (kWideTile / 4), q = (i % (kWideTile / 4)) * 4;
    *reinterpret_cast<float4*>(rows + (size_t)(r0 + r) * ld + tile0 + q) =
        *reinterpret_cast<const float4*>(tile + r * kWideS + q);
  }
}

// The pass over pairs 64 b .. 64 b + 63 (b = blockIdx.x) of one direction.
__device__ __forceinline__ void wide_pass(const WideArgs& a) {
  const int tile0 = blockIdx.x * kWideTile;
  const int nvalid = imin(kWideTile, (a.P_dev ? *a.P_dev : a.P) - tile0);
  if (nvalid <= 0) {
    if (a.P_dev && tile0 < a.ld) {  // beyond a device count: zero columns of every row
      const int rows = wide_rows(a.gs_n + a.nb, a.he, a.ns, a.hf, a.nw).total;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = threadIdx.x; i < rows * (kWideTile / 4); i += kThreads)
        *reinterpret_cast<float4*>(a.rows + (size_t)(i / (kWideTile / 4)) * a.ld + tile0 +
                                   4 * (i % (kWideTile / 4))) = z;
    }
    return;
  }
  const WidePlan pl = wide_plan(a);
  extern __shared__ float4 smem_f4[];
  float* A = reinterpret_cast<float*>(smem_f4);
  float* B = A + pl.a;
  float* shs = B + pl.b;
  float* ws = shs + pl.sh;
  float* ck = ws + pl.ws;
  int4* wm = reinterpret_cast<int4*>(ck + pl.ck);
  int* io = reinterpret_cast<int*>(wm) + pl.wm;
  int4* ie = reinterpret_cast<int4*>(io + pl.io);
  int* sl_t = reinterpret_cast<int*>(ie) + pl.ie;
  int* sl_s = sl_t + kWideTile;
  int* sl_b = sl_s + kWideTile;
  float* sl_d = reinterpret_cast<float*>(sl_b + kWideTile);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ns = a.ns, he = a.he, ke = a.gs_n + a.nb;
  const WideRows R = wide_rows(ke, he, ns, a.hf, a.nw);
  for (int i = tid; i < 9 * a.kdim; i += kThreads) ck[i] = __ldg(a.ck + i);
  for (int i = tid; i < a.nw; i += kThreads) wm[i] = a.w_meta[i];
  for (int i = tid; i <= a.din; i += kThreads) io[i] = __ldg(a.in_off + i);
  for (int i = tid; i < a.n_in; i += kThreads) ie[i] = a.in_ent[i];

  // 1. the tile's pairs: nodes, distance, spherical harmonics (0 beyond nvalid)
  if (tid < kWideTile) {
    const int p = tid;
    int t = 0, s = 0, b = 0;
    float x = 0.f, y = 0.f, z = 0.f, d = 0.f, on = 0.f;
    if (p < nvalid) {
      t = a.pair_t[tile0 + p];
      s = a.pair_s[tile0 + p];
      b = a.pair_b[tile0 + p];
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
    sl_t[p] = t;
    sl_s[p] = s;
    sl_b[p] = b;
    sl_d[p] = d;
    shs[0 * kWideS + p] = on;
    shs[1 * kWideS + p] = x * kSqrt3;
    shs[2 * kWideS + p] = y * kSqrt3;
    shs[3 * kWideS + p] = z * kSqrt3;
    shs[4 * kWideS + p] = kSqrt15 * x * y;
    shs[5 * kWideS + p] = kSqrt15 * y * z;
    shs[6 * kWideS + p] = on * kSqrt5Half * (3.f * z * z - 1.f);
    shs[7 * kWideS + p] = kSqrt15 * x * z;
    shs[8 * kWideS + p] = 0.5f * kSqrt15 * (x * x - y * y);
  }
  __syncthreads();
  // 2. edge input rows [Gaussian | bond features] -> B
  for (int i = tid; i < ke * kWideTile; i += kThreads) {
    const int r = i / kWideTile, p = i % kWideTile;
    float v = 0.f;
    if (p < nvalid) {
      if (r < a.gs_n) {
        const float diff = sl_d[p] - a.gs_off[r];
        v = expf(a.gs_coeff * (diff * diff));
      } else {
        const size_t e = ((size_t)sl_b[p] * a.nt + sl_t[p]) * a.nsrc + sl_s[p];
        v = a.bond_feat[e * a.nb + (r - a.gs_n)];
      }
    }
    B[r * kWideS + p] = v;
  }
  __syncthreads();
  store_rows(B, ke, a.rows, R.in, a.ld, tile0);
  // 3. edge MLP: h1 = relu(W1^T in + beff[sample]) -> A[0:he], attr -> A[he:he+ns]
  wide_gemm(B, ke, a.w1, he, a.beff, sl_b, 1, nullptr, A, nvalid, ws);
  store_rows(A, he, a.rows, R.h1, a.ld, tile0);
  float* E = A + he * kWideS;
  wide_gemm(A, he, a.w2, ns, a.b2, nullptr, 0, nullptr, E, nvalid, ws);
  // 4. the target and source scalar rows of the TP-weight MLP input
  for (int i0 = 0; i0 < 2 * ns * kWideTile; i0 += kWideU * kThreads) {
    float v[kWideU];  // unconditional loads (pair clamped), all in flight together
#pragma unroll
    for (int u = 0; u < kWideU; ++u) {
      const int i = imin(i0 + u * kThreads + tid, 2 * ns * kWideTile - 1);
      const int p = imin(i / (2 * ns), nvalid - 1), r = i % (2 * ns);
      v[u] = r < ns ? a.tgt_x[((size_t)sl_b[p] * a.nt + sl_t[p]) * a.din + r]
                    : a.src_x[((size_t)sl_b[p] * a.nsrc + sl_s[p]) * a.din + (r - ns)];
    }
#pragma unroll
    for (int u = 0; u < kWideU; ++u) {
      const int i = i0 + u * kThreads + tid;
      const int p = i / (2 * ns), r = i % (2 * ns);
      if (i < 2 * ns * kWideTile) E[(ns + r) * kWideS + p] = p < nvalid ? v[u] : 0.f;
    }
  }
  __syncthreads();
  store_rows(E, 3 * ns, a.rows, R.e, a.ld, tile0);
  // 5. TP-weight MLP: h = relu(Wf1^T e + bf1) -> B, w = Wf2^T h + bf2 -> E
  wide_gemm(E, 3 * ns, a.wf1, a.hf, a.bf1, nullptr, 1, nullptr, B, nvalid, ws);
  store_rows(B, a.hf, a.rows, R.h, a.ld, tile0);
  wide_gemm(B, a.hf, a.wf2, a.nw, a.bf2, nullptr, 0, nullptr, E, nvalid, ws);

  // 6. tensor product, two pairs per warp at a time (two independent chains
  // per lane, one walk of the path tables): the TP-input gradient ->
  // src_rows, then dw in place of the pairs' w columns. Each pair's
  // cotangent row, source row and cb row are staged in shared memory first.
  {
    const int stg = round4(a.dout + a.din + a.kdim);
    const bool vec = a.dout % 4 == 0 && a.din % 4 == 0 && ((uintptr_t)a.gout & 15) == 0 &&
                     ((uintptr_t)a.src_x & 15) == 0;
    const int per_warp = kWideTile / kWideWarps;
    for (int pi = 0; pi < per_warp; pi += 2) {
      const int p0 = warp * per_warp + pi;
      float* gs[2];
      float* xs[2];
      float* cbs[2];
      float* wcol[2];
      float* sr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        gs[h] = ws + (2 * warp + h) * stg;
        xs[h] = gs[h] + a.dout;
        cbs[h] = xs[h] + a.din;
        wcol[h] = E + p0 + h;
        sr[h] = nullptr;
        const int p = p0 + h;
        if (p >= nvalid) continue;
        const int b = sl_b[p];
        const float* gr = a.gout + ((size_t)b * a.nt + sl_t[p]) * a.dout;
        const float* xr = a.src_x + ((size_t)b * a.nsrc + sl_s[p]) * a.din;
        if (vec) {
          stage_row4(reinterpret_cast<const float4*>(gr), a.dout / 4,
                     reinterpret_cast<float4*>(gs[h]), lane);
          stage_row4(reinterpret_cast<const float4*>(xr), a.din / 4,
                     reinterpret_cast<float4*>(xs[h]), lane);
        } else {
          for (int i = lane; i < a.dout; i += 32) gs[h][i] = __ldg(gr + i);
          for (int i = lane; i < a.din; i += 32) xs[h][i] = __ldg(xr + i);
        }
        for (int r = lane; r < a.kdim; r += 32) {  // cb = ck^T sh
          float v = 0.f;
#pragma unroll
          for (int m = 0; m < 9; ++m) v = fmaf(shs[m * kWideS + p], ck[m * a.kdim + r], v);
          cbs[h][r] = v;
        }
        sr[h] = a.src_rows + (size_t)(a.src_at ? a.src_at[tile0 + p] : tile0 + p) * a.din;
      }
      const bool two = p0 + 1 < nvalid;
      if (p0 >= nvalid) {  // both pairs padding: dw = 0
        for (int j = lane; j < a.nw; j += 32) wcol[0][j * kWideS] = wcol[1][j * kWideS] = 0.f;
        continue;
      }
      __syncwarp();
      for (int c = lane; c < a.din; c += 32) {
        float v0 = 0.f, v1 = 0.f;
        for (int q = io[c]; q < io[c + 1]; ++q) {
          const int4 e = ie[q];  // o_base, mul, w_idx, cb_base | d3 << 16
          const int d3 = e.w >> 16, cb0 = e.w & 0xffff;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int k = 0; k < kTpD; ++k)
            if (k < d3) {
              s0 = fmaf(gs[0][e.x + k * e.y], cbs[0][cb0 + k], s0);
              s1 = fmaf(gs[1][e.x + k * e.y], cbs[1][cb0 + k], s1);
            }
          v0 = fmaf(wcol[0][e.z * kWideS], s0, v0);
          v1 = fmaf(wcol[1][e.z * kWideS], s1, v1);
        }
        sr[0][c] = v0;
        if (two) sr[1][c] = v1;
      }
      __syncwarp();
      for (int j = lane; j < a.nw; j += 32) {
        const int4 m = wm[j];  // a_base, mul, o_base, cb_off | d1 << 16 | d3 << 24
        const int cb0 = m.w & 0xffff, d1 = (m.w >> 16) & 0xff, d3 = m.w >> 24;
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int k = 0; k < kTpD; ++k) {
          if (k >= d3) break;
          float z0 = 0.f, z1 = 0.f;
#pragma unroll
          for (int i = 0; i < kTpD; ++i)
            if (i < d1) {
              const int xi = m.x + i * m.y, ci = cb0 + i * d3 + k;
              z0 = fmaf(xs[0][xi], cbs[0][ci], z0);
              z1 = fmaf(xs[1][xi], cbs[1][ci], z1);
            }
          v0 = fmaf(gs[0][m.z + k * m.y], z0, v0);
          v1 = fmaf(gs[1][m.z + k * m.y], z1, v1);
        }
        wcol[0][j * kWideS] = v0;
        wcol[1][j * kWideS] = two ? v1 : 0.f;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  store_rows(E, a.nw, a.rows, R.dw, a.ld, tile0);
  // 7. dh = relu'(h) (Wf2 dw) -> B (over h), de = Wf1 dh -> E
  wide_gemm(E, a.nw, a.wf2t, a.hf, nullptr, nullptr, 2, B, B, nvalid, ws);
  store_rows(B, a.hf, a.rows, R.dh, a.ld, tile0);
  wide_gemm(B, a.hf, a.wf1t, 3 * ns, nullptr, nullptr, 0, nullptr, E, nvalid, ws);
  store_rows(E, ns, a.rows, R.dea, a.ld, tile0);
  // 8. the scalar rows of de to the nodes' pair rows: target (written),
  // source (added to the TP-input gradient of step 6)
  for (int i = tid; i < ns * nvalid; i += kThreads) {
    const int p = i / ns, c = i % ns;
    const int gp = tile0 + p;
    a.tgt_rows[(size_t)(a.tgt_at ? a.tgt_at[gp] : gp) * ns + c] = E[(ns + c) * kWideS + p];
    a.src_rows[(size_t)(a.src_at ? a.src_at[gp] : gp) * a.din + c] += E[(2 * ns + c) * kWideS + p];
  }
  // 9. dh1 = relu'(h1) (W2 de[0:ns]) -> B
  wide_gemm(E, ns, a.w2t, he, nullptr, nullptr, 2, A, B, nvalid, ws);
  store_rows(B, he, a.rows, R.dh1, a.ld, tile0);
}

inline int wide_smem_bytes(const WideArgs& a) { return wide_plan(a).words * 4; }

// The parameter gradients of one pass: a . b^T over the ld pair columns of
// its rows (zero beyond the pairs), in one grouped launch of the split-K
// contraction (abt_gemm.cuh): dW1 + db1_eff (indicator rows per sample
// segment of the list, sample_off [batch + 1]), dW2 + db2, dWf1 + dbf1,
// dWf2 + dbf2, written at offs (o_win, o_w2, o_wf1, o_wf2) of a row of
// `stride` floats; part [max_splits, stride]. Returns a cudaError_t.
inline int wide_contract(const float* rows, int ld, int ke, int he, int ns, int hf, int nw,
                         int batch, const int* sample_off, const int offs[4], int stride,
                         float* part, int max_splits, float* grads, cudaStream_t st) {
  const WideRows R = wide_rows(ke, he, ns, hf, nw);
  AbtGroup g = {};
  g.n = 4;
  g.K = ld;
  g.stride = stride;
  g.part = part;
  const int ab[4][2] = {{R.in, R.dh1}, {R.h1, R.dea}, {R.e, R.dh}, {R.h, R.dw}};
  const int mn[4][2] = {{ke, he}, {he, ns}, {3 * ns, hf}, {hf, nw}};
  for (int i = 0; i < 4; ++i) {
    g.p[i].a = rows + (size_t)ab[i][0] * ld;
    g.p[i].b = rows + (size_t)ab[i][1] * ld;
    g.p[i].M = mn[i][0];
    g.p[i].N = mn[i][1];
    g.p[i].lda = ld;
    g.p[i].ldb = ld;
    g.p[i].n_seg = i == 0 ? batch : 1;
    g.p[i].seg = i == 0 ? sample_off : nullptr;
    g.p[i].out_off = offs[i];
  }
  return abt_launch(g, max_splits, grads, st);
}

}  // namespace dbfr
