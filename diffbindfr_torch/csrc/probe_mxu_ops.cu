// P2: the depthwise chain on CUDA cores against tensor cores. Replaces
// tools/probe_mxu_ops.py: legality (the pallas_call at :80), run_vpu (:194)
// and run_mxu (:207), which decided on the TPU whether the cmT kernels'
// depthwise chain should move from the vector unit to the matrix unit.
//
// legality: a [128, 8] -> [128, 16]: columns 0-8 the unnormalised l <= 2
// monomials 1, x, y, z, xy, yz, zz, xz, xx - yy of columns 0-2, column 9 the
// row's sum of squares, columns 10-15 zero. One thread per row; a launch is
// latency. Every product and sum is rounded on its own (no fma contraction),
// as the reference rounds them.
//
// chain_vpu: per grid step i (input block i % nblk: src [din_p, 128],
// w [wn_p, 128], cb [kdim, 128], f32) and per path of the cmT row plan:
// bs = bf16(src) * bf16(w), t = bs * bf16(cb), z_k = t_0 + t_1 + ... (i2
// ascending), every product and sum rounded to bf16; then the f32 sum of z
// over each 32-lane group into output column lane / 32 (of 8; columns 4-7
// zero). Output [reps, dout_p, 8]. One block per grid step, 128 threads, one
// thread per lane, so each warp is exactly one 32-lane group and the group
// sum is a butterfly of warp shuffles in f32. Two rows of a path travel in
// one bf16x2 register (mul.rn / add.rn, bf16x2.cuh: never fused into an fma).
//
// chain_mxu: the same chain as one bf16 contraction per path:
// lhs [mp, d1 * 128] = bf16(src * w), rhs [d1 * 128, d3 * 8] with
// rhs[i2 * 128 + l, k * 8 + j] = bf16(cbT[l, cb_off + i2 * d3 + k]) if
// j == l / 32 else 0, mk = lhs @ rhs with an f32 sum, written to rows
// w_row .. w_row + mp (not out_row) of an [reps, wn_p, ncols] output; for a
// path with d3 < d3max the TPU kernel rounds mk to bf16 before its one-hot
// pad product, so those values are bf16-rounded; columns past d3 * 8 are
// zero. The port's first tensor-core code: mma.sync m16n8k16 bf16 with f32
// accumulation; the shapes fit it exactly (mp in {16, 48}, K = d1 * 128,
// N = d3 * 8). Per path and i2 the block builds the lhs and rhs tiles in
// shared memory; each warp owns some of the (mp / 16) x d3 output tiles and
// keeps their sums in registers over i2.
//
// Bound on the H100 at the TPU probe's shapes (4096 steps, 64 input blocks):
// chain_vpu 3.0e9 rounded bf16 operations take 45 us at 6.7e13/s, but its
// 159 MB of output take 48 us at 3.35 TB/s (54 us with the 22 MB of inputs);
// chain_mxu 2.1e10 tensor-core operations take 21 us at 989 TFLOP/s and its
// 252 MB of output 75 us. Both are bound by their output writes; each block
// writes its output rows once, from shared memory (vpu) or from the
// accumulators (mxu).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x2.cuh"
#include "probe_path.cuh"

namespace {

using dbfr::load_path;
using dbfr::Path;
using dbfr::warp_sum;

constexpr int kLanes = 128;
constexpr int kMaxPaths = 64;

__global__ void legality_kernel(const float* __restrict__ a, float* __restrict__ out) {
  const int r = threadIdx.x;
  const float* x = a + r * 8;
  float* o = out + r * 16;
  const float X = x[0], Y = x[1], Z = x[2];
  o[0] = 1.f;
  o[1] = X;
  o[2] = Y;
  o[3] = Z;
  o[4] = __fmul_rn(X, Y);
  o[5] = __fmul_rn(Y, Z);
  o[6] = __fmul_rn(Z, Z);
  o[7] = __fmul_rn(X, Z);
  o[8] = __fsub_rn(__fmul_rn(X, X), __fmul_rn(Y, Y));
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s = __fadd_rn(s, __fmul_rn(x[k], x[k]));
  o[9] = s;
#pragma unroll
  for (int k = 10; k < 16; ++k) o[k] = 0.f;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)dbfr::to_bf16_bits(lo) | ((uint32_t)dbfr::to_bf16_bits(hi) << 16);
}

// one path's chain for this lane, two rows (u, u + 1) per bf16x2 register;
// the group sums go to acc[(out_row + k * mp + u) * 8 + warp]
template <int D1, int D3>
__device__ void vpu_path(const Path& q, const float* __restrict__ S, const float* __restrict__ W,
                         const float* __restrict__ C, float* acc, int lane, int warp) {
  uint32_t c[D1 * D3];
#pragma unroll
  for (int i = 0; i < D1 * D3; ++i) {
    const float v = C[(q.cb_off + i) * kLanes + lane];
    c[i] = bf16_pair(v, v);
  }
  for (int u = 0; u < q.mp; u += 2) {
    const uint32_t wp = bf16_pair(W[(q.w_row + u) * kLanes + lane],
                                  W[(q.w_row + u + 1) * kLanes + lane]);
    uint32_t bs[D1];
#pragma unroll
    for (int i = 0; i < D1; ++i)
      bs[i] = dbfr::mul_bf16x2(bf16_pair(S[(q.src[i] + u) * kLanes + lane],
                                         S[(q.src[i] + u + 1) * kLanes + lane]),
                               wp);
#pragma unroll
    for (int k = 0; k < D3; ++k) {
      uint32_t z = dbfr::mul_bf16x2(bs[0], c[k]);
#pragma unroll
      for (int i = 1; i < D1; ++i) z = dbfr::add_bf16x2(z, dbfr::mul_bf16x2(bs[i], c[i * D3 + k]));
      const float lo = warp_sum(dbfr::lo_f32(z)), hi = warp_sum(dbfr::hi_f32(z));
      if ((lane & 31) == 0) {
        const int row = q.out_row + k * q.mp + u;
        acc[row * 8 + warp] += lo;
        acc[(row + 1) * 8 + warp] += hi;
      }
    }
  }
}

template <int D1>
__device__ void vpu_path_d3(const Path& q, const float* S, const float* W, const float* C,
                            float* acc, int lane, int warp) {
  if (q.d3 == 1) vpu_path<D1, 1>(q, S, W, C, acc, lane, warp);
  else if (q.d3 == 3) vpu_path<D1, 3>(q, S, W, C, acc, lane, warp);
  else vpu_path<D1, 5>(q, S, W, C, acc, lane, warp);
}

__global__ void __launch_bounds__(kLanes) chain_vpu_kernel(
    const float* __restrict__ src, const float* __restrict__ w, const float* __restrict__ cb,
    const int* __restrict__ paths, float* __restrict__ out, int n_paths, int nblk, int din_p,
    int wn_p, int kdim, int dout_p) {
  extern __shared__ float acc[];  // [dout_p, 8]
  const int lane = threadIdx.x, warp = lane >> 5;
  for (int i = lane; i < dout_p * 8; i += kLanes) acc[i] = 0.f;
  __syncthreads();
  const int blk = blockIdx.x % nblk;
  const float* S = src + (size_t)blk * din_p * kLanes;
  const float* W = w + (size_t)blk * wn_p * kLanes;
  const float* C = cb + (size_t)blk * kdim * kLanes;
  for (int p = 0; p < n_paths; ++p) {
    const Path q = load_path(paths, p);
    if (q.d1 == 1) vpu_path_d3<1>(q, S, W, C, acc, lane, warp);
    else if (q.d1 == 3) vpu_path_d3<3>(q, S, W, C, acc, lane, warp);
    else vpu_path_d3<5>(q, S, W, C, acc, lane, warp);
  }
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * dout_p * 8);
  const float4* a4 = reinterpret_cast<const float4*>(acc);
  for (int i = lane; i < dout_p * 2; i += kLanes) o[i] = a4[i];
}

constexpr int kMaxMp = 48;
constexpr int kMaxN = 40;          // d3max * 8
constexpr int kStride = kLanes + 8;  // bf16 row stride of the tiles (bank spread)
constexpr int kMaxTilesPerWarp = 4;  // (48 / 16) * 5 tiles over 4 warps

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kLanes) chain_mxu_kernel(
    const float* __restrict__ src, const float* __restrict__ w, const float* __restrict__ cbT,
    const int* __restrict__ paths, float* __restrict__ out, int n_paths, int nblk, int din_p,
    int wn_p, int kdim, int d3max) {
  __shared__ __align__(16) __nv_bfloat16 lhs[kMaxMp * kStride];
  __shared__ __align__(16) __nv_bfloat16 rhs[kMaxN * kStride];  // [n][k]: B column-major
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
  const int blk = blockIdx.x % nblk;
  const int ncols = d3max * 8;
  const float* S = src + (size_t)blk * din_p * kLanes;
  const float* W = w + (size_t)blk * wn_p * kLanes;
  const float* CT = cbT + (size_t)blk * kLanes * kdim;
  float* O = out + (size_t)blockIdx.x * wn_p * ncols;
  for (int p = 0; p < n_paths; ++p) {
    const Path q = load_path(paths, p);
    const int n_mt = q.mp / 16, n_tiles = n_mt * q.d3;
    float d[kMaxTilesPerWarp][4];
#pragma unroll
    for (int j = 0; j < kMaxTilesPerWarp; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) d[j][v] = 0.f;
    for (int i2 = 0; i2 < q.d1; ++i2) {
      // thread tid builds column tid of lhs and of rhs
      // the product of two bf16 values is exact in f32: one rounding, as bf16 * bf16
      const int r0 = q.src[i2];
      for (int u = 0; u < q.mp; ++u) {
        const float s = __bfloat162float(__float2bfloat16_rn(S[(r0 + u) * kLanes + tid]));
        const float wv = __bfloat162float(__float2bfloat16_rn(W[(q.w_row + u) * kLanes + tid]));
        lhs[u * kStride + tid] = __float2bfloat16_rn(__fmul_rn(s, wv));
      }
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int k = 0; k < q.d3; ++k) {
        const __nv_bfloat16 cv = __float2bfloat16_rn(CT[tid * kdim + q.cb_off + i2 * q.d3 + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) rhs[(k * 8 + j) * kStride + tid] = j == (tid >> 5) ? cv : zero;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxTilesPerWarp; ++j) {
        const int tile = warp + 4 * j;
        if (tile < n_tiles) {
          const int m0 = (tile % n_mt) * 16, n0 = (tile / n_mt) * 8;
#pragma unroll
          for (int k0 = 0; k0 < kLanes; k0 += 16) {
            uint32_t a[4], b[2];
            const __nv_bfloat16* A = lhs + (m0 + g) * kStride + k0 + 2 * t4;
            a[0] = *reinterpret_cast<const uint32_t*>(A);
            a[1] = *reinterpret_cast<const uint32_t*>(A + 8 * kStride);
            a[2] = *reinterpret_cast<const uint32_t*>(A + 8);
            a[3] = *reinterpret_cast<const uint32_t*>(A + 8 * kStride + 8);
            const __nv_bfloat16* B = rhs + (n0 + g) * kStride + k0 + 2 * t4;
            b[0] = *reinterpret_cast<const uint32_t*>(B);
            b[1] = *reinterpret_cast<const uint32_t*>(B + 8);
            mma_bf16(d[j], a, b);
          }
        }
      }
      __syncthreads();
    }
    const bool rnd = q.d3 < d3max;
#pragma unroll
    for (int j = 0; j < kMaxTilesPerWarp; ++j) {
      const int tile = warp + 4 * j;
      if (tile < n_tiles) {
        const int m0 = (tile % n_mt) * 16, n0 = (tile / n_mt) * 8;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int row = q.w_row + m0 + g + (v >> 1) * 8, col = n0 + 2 * t4 + (v & 1);
          const float x = rnd ? __bfloat162float(__float2bfloat16_rn(d[j][v])) : d[j][v];
          O[row * ncols + col] = x;
        }
      }
    }
    const int zc = ncols - q.d3 * 8;
    for (int i = tid; i < q.mp * zc; i += kLanes)
      O[(q.w_row + i / zc) * ncols + q.d3 * 8 + i % zc] = 0.f;
  }
}

}  // namespace

// a [128, 8] f32 -> out [128, 16]
extern "C" int dbfr_probe_legality(const float* a, float* out, void* stream) {
  legality_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}

// src [nblk, din_p, 128], w [nblk, wn_p, 128], cb [nblk, kdim, 128] f32; paths
// int32 [n_paths, 16]; out [reps, dout_p, 8] f32
extern "C" int dbfr_probe_chain_vpu(const float* src, const float* w, const float* cb,
                                    const int* paths, float* out, int n_paths, int reps,
                                    int nblk, int din_p, int wn_p, int kdim, int dout_p,
                                    void* stream) {
  if (n_paths > kMaxPaths || reps <= 0 || nblk <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)dout_p * 8 * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  chain_vpu_kernel<<<reps, kLanes, smem, (cudaStream_t)stream>>>(src, w, cb, paths, out, n_paths,
                                                                 nblk, din_p, wn_p, kdim, dout_p);
  return (int)cudaGetLastError();
}

// cbT [nblk, 128, kdim]; out [reps, wn_p, d3max * 8] f32
extern "C" int dbfr_probe_chain_mxu(const float* src, const float* w, const float* cbT,
                                    const int* paths, float* out, int n_paths, int reps,
                                    int nblk, int din_p, int wn_p, int kdim, int d3max,
                                    void* stream) {
  if (n_paths > kMaxPaths || reps <= 0 || nblk <= 0 || d3max * 8 > kMaxN)
    return (int)cudaErrorInvalidValue;
  chain_mxu_kernel<<<reps, kLanes, 0, (cudaStream_t)stream>>>(src, w, cbT, paths, out, n_paths,
                                                              nblk, din_p, wn_p, kdim, d3max);
  return (int)cudaGetLastError();
}
