// Shared device code of the three trunk-conv kernels (B1 cross, B2 pair,
// B3 knn): one block gathers the valid (target, source) pairs of its g
// targets, then runs the whole per-pair chain on chunks of 32 pairs in
// shared memory and sums the messages per target. A chunk is latency-bound
// (weight tiles stream through shared memory between barriers), so blocks
// in flight matter as much as full chunks: dense blocks take several
// targets only when the target side is long and the source side short
// (the la pass: 1024 atoms x 128 ligand rows); see launch().
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
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dbfr {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kPairs = 32;     // pairs per chunk: one per lane of warp 0
constexpr int kStride = 36;    // padded pair stride of the activation tiles
constexpr int kKTile = 8;      // weight rows staged per step
constexpr int kMaxJ = 10;      // output columns per lane: every N <= 320
constexpr int kKnnGroup = 4;   // knn targets per block (4 x 16 = 64 pairs)
constexpr int kDenseCands = 1024;  // dense mode: at most 1024 candidates per block
constexpr int kMaxGroup = 8;       // and at most 8 targets, one per 128 targets

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
  int g;  // targets per block, set by launch()
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory plan, in 4-byte words; every region starts 16-byte aligned.
struct Plan {
  int r1, r2, ws, sh, acc, list, misc, words;
};

__host__ __device__ inline Plan make_plan(const ConvArgs& a, int mode) {
  Plan p;
  const int ke = a.gs_n + a.nb;
  const int ncand = a.g * (mode == kKnn ? a.k : a.nsrc);
  const int maxn = imax(imax(imax(a.he, a.ns), imax(a.hf, a.nw)), a.kdim);
  p.r1 = imax(3 * a.ns, a.nw) * kStride;
  p.r2 = imax(imax(a.hf, a.kdim), ke + a.he) * kStride;
  p.ws = round4(kKTile * maxn);
  p.sh = 9 * kStride;
  p.acc = round4(a.g * a.dout);
  p.list = round4(ncand);
  p.misc = 3 * kPairs + 8;
  p.words = p.r1 + p.r2 + p.ws + p.sh + p.acc + p.list + p.misc;
  return p;
}

// out[n][p] = act(sum_k in[k][p] * W[k][n] + bias[n]) for the 32 pairs of a
// chunk; in/out are [rows][kStride] tiles, W is row-major [K][N] in global
// memory. Thread (warp w, lane l) owns pairs 4w..4w+3 and columns l + 32 j.
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
    if (32 * j < N && n < N) {
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

// Body of every trunk-conv kernel: block = targets t0 .. t0 + g - 1.
// Dense mode: candidates = (target, every source). Knn mode: candidates =
// the targets' neighbour-list slots.
template <int MODE>
__device__ __forceinline__ void conv_block(const ConvArgs& a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const Plan pl = make_plan(a, MODE);
  float* r1 = smem;
  float* r2 = r1 + pl.r1;
  float* ws = r2 + pl.r2;
  float* shs = ws + pl.ws;
  float* acc = shs + pl.sh;
  int* list = reinterpret_cast<int*>(acc + pl.acc);
  int* pair_tl = list + pl.list;
  int* pair_s = pair_tl + kPairs;
  float* pair_d = reinterpret_cast<float*>(pair_s + kPairs);
  int* wcnt = reinterpret_cast<int*>(pair_d + kPairs);

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = a.g;
  const int t0 = blockIdx.x * g;
  const float cut = MODE == kDense ? a.cutoff[b] : 0.f;
  const int per_target = MODE == kKnn ? a.k : a.nsrc;
  const int ncand = g * per_target;
  for (int i = tid; i < g * a.dout; i += kThreads) acc[i] = 0.f;

  // 1. compact this block's valid pairs, in candidate order (deterministic)
  int total = 0;
  for (int c0 = 0; c0 < ncand; c0 += kThreads) {
    const int c = c0 + tid;
    bool ok = false;
    int entry = 0;
    const int gl = c / per_target;
    const int t = t0 + gl;
    if (c < ncand && t < a.nt) {
      int s = c % per_target;
      if (MODE == kKnn) {
        const size_t e = ((size_t)b * a.nt + t) * a.k + s;
        s = a.knn_idx[e];
        ok = a.knn_valid[e] > 0.f && s >= 0 && s < a.nsrc;
      } else {
        // a masked target row receives no message: its output stays zero
        ok = a.tgt_mask[(size_t)b * a.nt + t] > 0.f && dense_valid(a, b, t, s, cut);
      }
      entry = (gl << 16) | (ok ? s : 0);
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

  const int ke = a.gs_n + a.nb;
  for (int c0 = 0; c0 < total; c0 += kPairs) {
    const int n = min(kPairs, total - c0);
    // 2. geometry and spherical harmonics, one pair per lane of warp 0
    if (warp == 0) {
      int tl = 0, s = 0;
      float vx = 0.f, vy = 0.f, vz = 0.f, d = 0.f;
      if (lane < n) {
        const int e = list[c0 + lane];
        tl = e >> 16;
        s = e & 0xffff;
        const PairGeo pg = pair_geo(a.tgt_pos + ((size_t)b * a.nt + t0 + tl) * 3,
                                    a.src_pos + ((size_t)b * a.nsrc + s) * 3, a.flip);
        vx = pg.vx;
        vy = pg.vy;
        vz = pg.vz;
        d = pg.d;
      }
      pair_tl[lane] = tl;
      pair_s[lane] = s;
      pair_d[lane] = d;
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
    __syncthreads();
    // 3. edge-MLP input rows [Gaussian (gs_n) | bond features (nb)] -> r2
    for (int i = tid; i < ke * kPairs; i += kThreads) {
      const int r = i / kPairs, p = i % kPairs;
      float v = 0.f;
      if (p < n) {
        if (r < a.gs_n) {
          const float diff = pair_d[p] - a.gs_off[r];
          v = expf(a.gs_coeff * (diff * diff));
        } else {
          const size_t e = ((size_t)b * a.nt + t0 + pair_tl[p]) * a.nsrc + pair_s[p];
          v = a.bond_feat[e * a.nb + (r - a.gs_n)];
        }
      }
      r2[r * kStride + p] = v;
    }
    // 4. scalar rows of the TP-weight MLP input [attr | tgt | src] -> r1
    for (int i = tid; i < 2 * a.ns * kPairs; i += kThreads) {
      const int p = i / (2 * a.ns), r = i % (2 * a.ns);
      float v = 0.f;
      if (p < n) {
        v = r < a.ns
                ? a.tgt_x[((size_t)b * a.nt + t0 + pair_tl[p]) * a.din + r]
                : a.src_x[((size_t)b * a.nsrc + pair_s[p]) * a.din + (r - a.ns)];
      }
      r1[(a.ns + r) * kStride + p] = v;
    }
    // 5. edge MLP: relu(W1^T [gs | bond] + b1_eff) -> r2[ke:], then attr -> r1[0:ns]
    gemm(r2, ke, a.w1, a.b1 + (size_t)b * a.he, a.he, r2 + ke * kStride, true, ws);
    gemm(r2 + ke * kStride, a.he, a.w2, a.b2, a.ns, r1, false, ws);
    // 6. TP-weight MLP: hidden -> r2, weights -> r1
    gemm(r1, 3 * a.ns, a.wf1, a.bf1, a.hf, r2, true, ws);
    gemm(r2, a.hf, a.wf2, a.bf2, a.nw, r1, false, ws);
    // 7. cb = ck^T sh -> r2[0:kdim]
    gemm(shs, 9, a.ck, nullptr, a.kdim, r2, false, ws);
    // 8. depthwise TP, summed per target: thread o owns output column o
    const int4* meta = reinterpret_cast<const int4*>(a.out_meta);
    for (int o = tid; o < a.dout; o += kThreads) {
      const int4 m0 = meta[2 * o];      // a_base, mul, d1, w_idx
      const int4 m1 = meta[2 * o + 1];  // cb_base, d3
      for (int p = 0; p < n; ++p) {
        const float* xs = a.src_x + ((size_t)b * a.nsrc + pair_s[p]) * a.din + m0.x;
        float zv = 0.f;
        for (int i = 0; i < m0.z; ++i)
          zv = fmaf(__ldg(xs + i * m0.y), r2[(m1.x + i * m1.y) * kStride + p], zv);
        acc[pair_tl[p] * a.dout + o] += zv * r1[m0.w * kStride + p];
      }
    }
    __syncthreads();
  }

  // 9. per-target sums -> out
  for (int i = tid; i < g * a.dout; i += kThreads) {
    const int t = t0 + i / a.dout;
    if (t < a.nt) a.out[((size_t)b * a.nt + t) * a.dout + (i % a.dout)] = acc[i];
  }
}

template <int MODE>
inline int launch(void (*kernel)(ConvArgs), ConvArgs a, int batch, cudaStream_t st) {
  // measured on the H100 (PERF.md): grouping the la pass's 1024 atom
  // targets took B1 from 8.46 to 7.25 ms, grouping the 128 ligand rows of
  // B2 slowed it from 0.57 to 0.85 ms (fewer blocks in flight)
  a.g = MODE == kKnn ? kKnnGroup
                     : imax(1, imin(imin(kMaxGroup, kDenseCands / imax(a.nsrc, 1)), a.nt / 128));
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
