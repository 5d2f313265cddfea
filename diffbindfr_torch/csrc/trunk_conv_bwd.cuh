// Device code of the pair conv's backward kernel (B5, pair_bwd.cu; B4 and
// B6, the cross and knn convs' backward, run the wide-tile pass of
// conv_bwd_wide.cuh). Replaces the hand-written Pallas backward kernel of
// diffbindfr_tpu/nn/pallas_conv_t.py (make_pair_bwd_t): like it, a kernel
// recomputes each pair's forward chain
// (geometry, mask, edge MLP, TP-weight MLP, spherical harmonics) from the
// node features and returns only feature and parameter gradients;
// positions, time embedding, masks and bond features get none (pure data
// in training). Per valid pair, with g = d loss / d out of its target:
//   dw_j    = sum_k g[o_k] sum_i x_src[a_i] cb[i, k]      (TP weights)
//   dx_src += w_j sum_k g[o_k] cb[i, k]                   (TP input)
//   dh = relu'(h) (Wf2 dw), de = Wf1 dh, dh1 = relu'(h1) (W2 de[0:ns])
//   dWf2 += h dw^T, dWf1 += e dh^T, dW2 += h1 de[0:ns]^T, dW1 += in dh1^T
// and de's target / source scalar rows flow to those nodes' features.
//
// On the TPU the sequential grid carried the source-side gradient and every
// parameter gradient in VMEM from one grid step to the next; blocks of the
// H100 run in no order, so:
//  * the target pass (own_src = 0) keeps the blocks' targets as in the
//    forward; a fixed grid of kBwdBlocks persistent blocks walks the target
//    tiles in a fixed order, and block i adds its parameter-gradient sums to
//    its own row i of a scratch array; reduce_rows then sums the rows in
//    order (deterministic, no atomics);
//  * the source pass (own_src = 1) owns the sources and recomputes the chain
//    for their pairs (roles swapped, as B1's forward does for la), adding
//    the TP-input and source-scalar gradients per owned source.
// Bound on the H100: fp32 FMA in the per-pair MLPs (operations), about
// three times the forward's MLP work per pair plus the source pass's
// recompute; masked pairs are skipped.
#pragma once

#include "trunk_conv.cuh"

namespace dbfr {

constexpr int kBwdBlocks = 264;  // persistent blocks of a target pass: 2 per SM of an H100

// Shared-memory plan of a backward block, in 4-byte words.
struct BwdPlan {
  int in, h1, e, h, w, cb, sh, dh, ws, acc, list, misc, words;
};

__host__ __device__ inline BwdPlan make_bwd_plan(const ConvArgs& a, int mode) {
  BwdPlan p;
  const int ke = a.gs_n + a.nb;
  const int maxn = imax(imax(imax(a.he, a.ns), imax(a.hf, a.nw)), imax(a.kdim, 3 * a.ns));
  p.in = ke * kStride;                        // [gs | bond] edge-MLP input
  p.h1 = a.he * kStride;                      // edge-MLP hidden
  p.e = 3 * a.ns * kStride;                   // [attr | tgt | src] TP-weight MLP input
  p.h = imax(a.hf, 3 * a.ns) * kStride;       // TP-weight hidden, then de
  p.w = imax(a.nw, a.he) * kStride;           // TP weights, then dw, then dh1
  p.cb = a.kdim * kStride;
  p.sh = 9 * kStride;
  p.dh = a.hf * kStride;
  p.ws = round4(kKTile * maxn);
  p.acc = round4(a.g * a.din);
  p.list = round4(a.g * per_owned(a, mode));
  p.misc = 4 * kPairs + 8;
  p.words = p.in + p.h1 + p.e + p.h + p.w + p.cb + p.sh + p.dh + p.ws + p.acc + p.list + p.misc;
  return p;
}

// Row layout of the parameter-gradient scratch and of the reduced result:
// dW1 [ke, he] | db1_eff [batch, he] | dW2 [he, ns] | db2 | dWf1 [3 ns, hf] |
// dbf1 | dWf2 [hf, nw] | dbf2 (diffbindfr_torch/nn/trunk_convs.py mirrors it).
inline void set_grad_layout(ConvArgs& a) {
  int o = 0;
  a.o_win = o;
  o += (a.gs_n + a.nb) * a.he;
  a.o_beff = o;
  o += a.batch * a.he;
  a.o_w2 = o;
  o += a.he * a.ns;
  a.o_b2 = o;
  o += a.ns;
  a.o_wf1 = o;
  o += 3 * a.ns * a.hf;
  a.o_bf1 = o;
  o += a.hf;
  a.o_wf2 = o;
  o += a.hf * a.nw;
  a.o_bf2 = o;
  o += a.nw;
  a.part_stride = round4(o);
}

// part[k * N + n] += sum_p A[k][p] D[n][p] over the 32 pairs of a chunk
// (D is zero beyond the chunk's pairs). Warp w takes rows 4w.. of A, lane l
// columns l + 32 j: A reads are broadcasts, D reads conflict-free float4s.
// Entry (k, n) always belongs to the same thread, so the read-modify-write
// of the block's own scratch row needs no atomics.
__device__ __forceinline__ void wgrad(const float* A, int K, const float* D, int N,
                                      float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 4 * warp; k0 < K; k0 += 4 * (kThreads / 32)) {
    float acc[4][kMaxJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) acc[i][j] = 0.f;
    for (int p = 0; p < kPairs; p += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = k0 + i < K ? *reinterpret_cast<const float4*>(A + (k0 + i) * kStride + p) : zero4;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        if (32 * j < N) {
          const int n = lane + 32 * j;
          const float4 dv = n < N ? *reinterpret_cast<const float4*>(D + n * kStride + p) : zero4;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float v = acc[i][j];
            v = fmaf(av[i].x, dv.x, v);
            v = fmaf(av[i].y, dv.y, v);
            v = fmaf(av[i].z, dv.z, v);
            acc[i][j] = fmaf(av[i].w, dv.w, v);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int n = lane + 32 * j;
      if (32 * j < N && n < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + i < K) part[(size_t)(k0 + i) * N + n] += acc[i][j];
      }
    }
  }
}

// part[n] += sum_p D[n][p] (bias gradients)
__device__ __forceinline__ void bias_grad(const float* D, int N, float* __restrict__ part) {
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float s = 0.f;
    for (int p = 0; p < kPairs; p += 4) {
      const float4 v = *reinterpret_cast<const float4*>(D + n * kStride + p);
      s += (v.x + v.y) + (v.z + v.w);
    }
    part[n] += s;
  }
}

// D *= relu'(pre-activation), read from the activation H = relu(pre)
__device__ __forceinline__ void relu_mask(float* D, const float* H, int N) {
  for (int i = threadIdx.x; i < N * kPairs; i += kThreads) {
    const int r = i / kPairs, p = i % kPairs;
    if (!(H[r * kStride + p] > 0.f)) D[r * kStride + p] = 0.f;
  }
  __syncthreads();
}

// dw[j][p] = sum_k g[t_p, o_base + k mul] z_k, z_k = sum_i x_s[a_base + i mul] cb[cb_off + i d3 + k]
__device__ __forceinline__ void tp_dw(const ConvArgs& a, int b, int n, Slots sl, const float* cb,
                                      float* dw) {
  const int4* wm = reinterpret_cast<const int4*>(a.w_meta);
  for (int j = threadIdx.x; j < a.nw; j += kThreads) {
    const int4 m0 = wm[2 * j];      // a_base, mul, d1, o_base
    const int4 m1 = wm[2 * j + 1];  // cb_off, d3
    for (int p = 0; p < kPairs; ++p) {
      float v = 0.f;
      if (p < n) {
        const float* xs = a.src_x + ((size_t)b * a.nsrc + sl.s[p]) * a.din + m0.x;
        const float* gr = a.gout + ((size_t)b * a.nt + sl.t[p]) * a.dout + m0.w;
        for (int k = 0; k < m1.y; ++k) {
          float z = 0.f;
          for (int i = 0; i < m0.z; ++i)
            z = fmaf(__ldg(xs + i * m0.y), cb[(m1.x + i * m1.y + k) * kStride + p], z);
          v = fmaf(__ldg(gr + k * m0.y), z, v);
        }
      }
      dw[j * kStride + p] = v;
    }
  }
}

// acc[own_p][c] += sum over the paths reading input column c of
// w_j sum_k g[t_p, o_base + k mul] cb[cb_base + k]; thread c owns column c
__device__ __forceinline__ void tp_dsrc(const ConvArgs& a, int b, int n, Slots sl,
                                        const float* w, const float* cb, float* acc) {
  const int4* im = reinterpret_cast<const int4*>(a.in_meta);
  for (int c = threadIdx.x; c < a.din; c += kThreads) {
    for (int p = 0; p < n; ++p) {
      const float* gr = a.gout + ((size_t)b * a.nt + sl.t[p]) * a.dout;
      float v = 0.f;
      for (int q = 0; q < kMaxInPaths; ++q) {
        const int4 m0 = im[(c * kMaxInPaths + q) * 2];      // o_base, mul, w_idx, cb_base
        const int d3 = im[(c * kMaxInPaths + q) * 2 + 1].x;
        if (d3 == 0) break;
        float s = 0.f;
        for (int k = 0; k < d3; ++k)
          s = fmaf(__ldg(gr + m0.x + k * m0.y), cb[(m0.w + k) * kStride + p], s);
        v = fmaf(w[m0.z * kStride + p], s, v);
      }
      acc[sl.own[p] * a.din + c] += v;
    }
  }
}

// acc[own_p][c] += rows[c][p] for the ns scalar columns
__device__ __forceinline__ void scalar_grad(const ConvArgs& a, int n, Slots sl, const float* rows,
                                            float* acc) {
  for (int c = threadIdx.x; c < a.ns; c += kThreads)
    for (int p = 0; p < n; ++p) acc[sl.own[p] * a.din + c] += rows[c * kStride + p];
}

// One tile: owned nodes own0 .. own0 + g - 1 of sample b.
template <int MODE>
__device__ __forceinline__ void bwd_tile(const ConvArgs& a, const BwdPlan& pl, float* smem, int b,
                                         int own0) {
  float* in_rows = smem;
  float* h1 = in_rows + pl.in;
  float* e = h1 + pl.h1;
  float* h = e + pl.e;  // then de
  float* w = h + pl.h;  // then dw, then dh1
  float* cb = w + pl.w;
  float* shs = cb + pl.cb;
  float* dh = shs + pl.sh;
  float* ws = dh + pl.dh;
  float* acc = ws + pl.ws;
  int* list = reinterpret_cast<int*>(acc + pl.acc);
  Slots sl;
  sl.t = list + pl.list;
  sl.s = sl.t + kPairs;
  sl.own = sl.s + kPairs;
  sl.d = reinterpret_cast<float*>(sl.own + kPairs);
  sl.wcnt = reinterpret_cast<int*>(sl.d + kPairs);

  const int tid = threadIdx.x;
  const int ns = a.ns;
  const int ke = a.gs_n + a.nb;
  const int n_own = n_owned(a);
  float* part = a.own_src ? nullptr : a.part + (size_t)blockIdx.x * a.part_stride;
  for (int i = tid; i < a.g * a.din; i += kThreads) acc[i] = 0.f;

  const int total = compact_pairs<MODE>(a, b, own0, list, sl.wcnt);
  for (int c0 = 0; c0 < total; c0 += kPairs) {
    const int n = imin(kPairs, total - c0);
    load_chunk(a, b, own0, list, c0, n, sl, shs);
    __syncthreads();
    input_rows(a, b, n, sl, in_rows, e + ns * kStride);
    mlp_forward(a, b, in_rows, h1, e, h, w, cb, shs, ws);
    if (a.own_src) {
      tp_dsrc(a, b, n, sl, w, cb, acc);
      __syncthreads();
    }
    tp_dw(a, b, n, sl, cb, w);                              // dw over w
    gemm(w, a.nw, a.wf2t, nullptr, a.hf, dh, false, ws);    // dh = Wf2 dw
    relu_mask(dh, h, a.hf);
    if (!a.own_src) {
      wgrad(h, a.hf, w, a.nw, part + a.o_wf2);
      bias_grad(w, a.nw, part + a.o_bf2);
      wgrad(e, 3 * ns, dh, a.hf, part + a.o_wf1);
      bias_grad(dh, a.hf, part + a.o_bf1);
    }
    gemm(dh, a.hf, a.wf1t, nullptr, 3 * ns, h, false, ws);  // de = Wf1 dh over h
    if (a.own_src) {
      scalar_grad(a, n, sl, h + 2 * ns * kStride, acc);
    } else {
      scalar_grad(a, n, sl, h + ns * kStride, acc);
      gemm(h, ns, a.w2t, nullptr, a.he, w, false, ws);      // dh1 = W2 de[0:ns] over w
      relu_mask(w, h1, a.he);
      wgrad(h1, a.he, h, ns, part + a.o_w2);
      bias_grad(h, ns, part + a.o_b2);
      wgrad(in_rows, ke, w, a.he, part + a.o_win);
      bias_grad(w, a.he, part + a.o_beff + b * a.he);
    }
    __syncthreads();
  }

  for (int i = tid; i < a.g * a.din; i += kThreads) {
    const int own = own0 + i / a.din;
    if (own < n_own) {
      float* dst = a.d_own + ((size_t)b * n_own + own) * a.din + (i % a.din);
      *dst = a.accumulate ? *dst + acc[i] : acc[i];
    }
  }
  __syncthreads();
}

// Persistent blocks: block i takes tiles i, i + gridDim.x, ... of all samples.
template <int MODE>
__device__ __forceinline__ void conv_bwd(const ConvArgs& a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const BwdPlan pl = make_bwd_plan(a, MODE);
  const int tiles = (n_owned(a) + a.g - 1) / a.g;
  for (int tile = blockIdx.x; tile < a.batch * tiles; tile += gridDim.x)
    bwd_tile<MODE>(a, pl, smem, tile / tiles, (tile % tiles) * a.g);
}

template <int MODE>
inline int launch_bwd(void (*kernel)(ConvArgs), ConvArgs a, cudaStream_t st) {
  a.g = group_size(a, MODE);
  const int bytes = make_bwd_plan(a, MODE).words * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n_owned(a) + a.g - 1) / a.g;
  const int blocks = imin(kBwdBlocks, tiles * a.batch);
  if (blocks > 0) kernel<<<blocks, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

namespace {
// out[i] = sum_r part[r * stride + i], rows in order
__global__ void reduce_rows_kernel(const float* __restrict__ part, int rows, int stride,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= stride) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * stride + i];
  out[i] = s;
}
}  // namespace

inline int reduce_rows(const float* part, int stride, float* out, cudaStream_t st) {
  reduce_rows_kernel<<<(stride + 255) / 256, 256, 0, st>>>(part, kBwdBlocks, stride, out);
  return (int)cudaGetLastError();
}

}  // namespace dbfr
