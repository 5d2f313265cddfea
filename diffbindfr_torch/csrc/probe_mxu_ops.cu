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
// thread per lane, so each warp is exactly one 32-lane group. Two rows of a
// path travel in one bf16x2 register (mul.rn / add.rn, bf16x2.cuh: never
// fused into an fma). The group sums of the 1216 rows of a step are most of
// its work: a butterfly per row would take 5 shuffles and 5 adds in every
// lane, against ~2.3k bf16x2 instructions per lane for the whole chain. So
// a warp sums 8 or 16 rows at once by reduce-scatter (group_sums: bf16
// halves two to a shuffle at partner 16, f32 after), under one shuffle per
// row, bit-equal to the butterfly; each row's sum is staged once in shared
// memory and the step's output leaves in coalesced 16-byte streaming
// stores. A path group's source rows (shared by up to six paths) and each
// path's w rows are rounded to bf16 once per step; 8 blocks of 4 warps fit
// an SM. The inputs come from L2 (64 blocks, 22 MB), so the kernel waits on
// load and shuffle latency more than on its instructions: a path's output components
// are unrolled, so that their cb loads and their shuffle chains overlap,
// and each path's w rows load while the path before it computes.
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
// accumulators (mxu). chain_vpu runs ~7k instructions per thread and step
// (chain, conversions, group sums) and ~2k memory and shuffle operations:
// at the card's instruction rates that alone is about twice its bytes' time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x2.cuh"
#include "probe_path.cuh"

namespace {

using dbfr::load_path;
using dbfr::Path;

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

constexpr unsigned kFull = 0xffffffffu;

// two f32 values as one bf16x2 register (lo in the low half): one
// cvt.rn.bf16x2.f32
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one path of the table in shared memory (int4 [n_paths * 4]: the 16
// columns of probe_path.cuh's row)
struct VpuPath {
  int mp, d1, d3, w_row, out_row, cb_off, src[dbfr::kMaxD1];
};

__device__ __forceinline__ VpuPath vpu_path(const int4* __restrict__ tab, int p) {
  const int4 a = tab[4 * p], b = tab[4 * p + 1], c = tab[4 * p + 2];
  return {a.x, a.y, a.z, a.w, b.x, b.y, {b.z, b.w, c.x, c.y, c.z}};
}

// (unused source rows are -1 in the table; every index is static, so the
// paths stay in registers)
__device__ __forceinline__ bool same_sources(const VpuPath& a, const VpuPath& b) {
  bool same = a.mp == b.mp && a.d1 == b.d1;
#pragma unroll
  for (int i = 0; i < dbfr::kMaxD1; ++i) same = same && a.src[i] == b.src[i];
  return same;
}

// The 32-lane group sums of 2 * NP rows, z[q] holding this lane's rows 2q
// (low half) and 2q + 1, by reduce-scatter over the warp: at each xor
// partner 16, 8, 4, ... a lane sends the half of its rows that it gives
// away and adds the partner's values of the half it keeps. Partner 16
// exchanges bf16 halves, two to a shuffle, and the sums are f32 from there;
// once a lane holds one row, the remaining partners exchange it whole.
// Every sum pairs the lanes of probes/_cuda.py's `butterfly_sum` (f32
// addition commutes), so each row's sum is bit-equal to it. 2 * NP rows
// take NP / 2 + NP / 2 + NP / 4 + ... shuffles instead of 10 per row pair.
// Returns the sum of row `group_row<NP>(gl)`.
template <int NP>
__device__ __forceinline__ float group_sums(const uint32_t (&z)[NP], int gl) {
  static_assert(NP >= 2 && NP <= 16 && (NP & (NP - 1)) == 0, "NP: 2, 4, 8 or 16");
  const bool b4 = gl & 16;
  // the halves given away, two registers to a word; the kept half as f32
  const uint32_t give = b4 ? 0x5410u : 0x7632u, keep = b4 ? 0x3244u : 0x1044u;
  float f[NP];
#pragma unroll
  for (int q = 0; q < NP; q += 2) {
    const uint32_t r = __shfl_xor_sync(kFull, __byte_perm(z[q], z[q + 1], give), 16);
    f[q] = __uint_as_float(__byte_perm(z[q], 0u, keep)) + __uint_as_float(r << 16);
    f[q + 1] = __uint_as_float(__byte_perm(z[q + 1], 0u, keep)) +
               __uint_as_float(r & 0xffff0000u);
  }
  int n = NP;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    if (n > 1) {
      const int h = n / 2;
      const bool b = gl & o;
#pragma unroll
      for (int t = 0; t < h; ++t) {
        const float give_v = b ? f[t] : f[t + h], keep_v = b ? f[t + h] : f[t];
        f[t] = keep_v + __shfl_xor_sync(kFull, give_v, o);
      }
      n = h;
    } else {
      f[0] += __shfl_xor_sync(kFull, f[0], o);
    }
  }
  return f[0];
}

// the row (of the 2 * NP) whose sum group_sums leaves in lane gl
template <int NP>
__device__ __forceinline__ int group_row(int gl) {
  int q = 0, n = NP;
#pragma unroll
  for (int o = 8; o > 0 && n > 1; o >>= 1) {
    n /= 2;
    if (gl & o) q += n;
  }
  return 2 * q + ((gl >> 4) & 1);
}

// the lanes that write a row's sum: one of the lanes that hold it
template <int NP>
__device__ __forceinline__ bool group_writer(int gl) {
  int halvings = 0;
  for (int n = NP; n > 1; n /= 2) ++halvings;
  return (gl & ((16 >> halvings) - 1)) == 0;
}

// One path's rows at one block of rows u: per output component k, z =
// sum_i bs_i * cb_(i, k) (bf16x2, two rows to a register), and the group
// sums of the block's rows to the block's staging rows in shared memory
// (column = the warp's group). The components are unrolled, so that their
// cb loads and their group sums' shuffle chains overlap.
template <int D1, int NP, int D3>
__device__ __forceinline__ void vpu_components(const uint32_t (&bs)[D1][NP], const VpuPath& q,
                                               int u0, const float* __restrict__ C,
                                               float* __restrict__ stage, int gl, int warp,
                                               int row, bool writer) {
#pragma unroll
  for (int k = 0; k < D3; ++k) {
    uint32_t c[D1];
#pragma unroll
    for (int i = 0; i < D1; ++i) {
      const float v = C[(size_t)(q.cb_off + i * D3 + k) * kLanes];
      c[i] = bf16_pair(v, v);
    }
    uint32_t z[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      z[j] = dbfr::mul_bf16x2(bs[0][j], c[0]);
#pragma unroll
      for (int i = 1; i < D1; ++i) z[j] = dbfr::add_bf16x2(z[j], dbfr::mul_bf16x2(bs[i][j], c[i]));
    }
    const float sum = group_sums<NP>(z, gl);
    if (writer) stage[(q.out_row + k * q.mp + u0 + row) * 4 + warp] = sum;
  }
}

// The paths p0 .. p1 - 1 share their source rows (and mul_p, d1). Per block
// of UB rows u, the sources are rounded to bf16 once and kept in registers
// over the paths; each path rounds its w rows once (loaded while the path
// before it computes) and forms bs = src * w for vpu_components.
template <int D1, int UB>
__device__ void vpu_paths(const int4* __restrict__ tab, int p0, int p1,
                          const float* __restrict__ S, const float* __restrict__ W,
                          const float* __restrict__ C, float* __restrict__ stage, int gl,
                          int warp) {
  constexpr int NP = UB / 2;
  const VpuPath g = vpu_path(tab, p0);
  const int row = group_row<NP>(gl);
  const bool writer = group_writer<NP>(gl);
  for (int u0 = 0; u0 < g.mp; u0 += UB) {
    uint32_t s[D1][NP];
#pragma unroll
    for (int i = 0; i < D1; ++i) {
      const float* r = S + (size_t)(g.src[i] + u0) * kLanes;
#pragma unroll
      for (int q = 0; q < NP; ++q) s[i][q] = bf16_pair(r[2 * q * kLanes], r[(2 * q + 1) * kLanes]);
    }
    float wf[UB];
    const float* wr = W + (size_t)(g.w_row + u0) * kLanes;
#pragma unroll
    for (int j = 0; j < UB; ++j) wf[j] = wr[j * kLanes];
    for (int p = p0; p < p1; ++p) {
      const VpuPath q = vpu_path(tab, p);
      uint32_t bs[D1][NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const uint32_t wp = bf16_pair(wf[2 * j], wf[2 * j + 1]);
#pragma unroll
        for (int i = 0; i < D1; ++i) bs[i][j] = dbfr::mul_bf16x2(s[i][j], wp);
      }
      if (p + 1 < p1) {
        wr = W + (size_t)(vpu_path(tab, p + 1).w_row + u0) * kLanes;
#pragma unroll
        for (int j = 0; j < UB; ++j) wf[j] = wr[j * kLanes];
      }
      if (q.d3 == 1) vpu_components<D1, NP, 1>(bs, q, u0, C, stage, gl, warp, row, writer);
      else if (q.d3 == 3) vpu_components<D1, NP, 3>(bs, q, u0, C, stage, gl, warp, row, writer);
      else vpu_components<D1, NP, 5>(bs, q, u0, C, stage, gl, warp, row, writer);
    }
  }
}

// one grid step per block: 128 threads, thread = lane, warp = 32-lane group
constexpr int kVpuMinBlocks = 8;  // 8 blocks of 4 warps: 8 warps per scheduler

__global__ void __launch_bounds__(kLanes, kVpuMinBlocks) chain_vpu_kernel(
    const float* __restrict__ src, const float* __restrict__ w, const float* __restrict__ cb,
    const int* __restrict__ paths, float* __restrict__ out, int n_paths, int nblk, int din_p,
    int wn_p, int kdim, int dout_p) {
  extern __shared__ int4 smem[];
  int4* tab = smem;                                           // [n_paths * 4]
  float* stage = reinterpret_cast<float*>(smem + 4 * n_paths);  // [dout_p, 4]
  const int tid = threadIdx.x, gl = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 4 * n_paths; i += kLanes) tab[i] = reinterpret_cast<const int4*>(paths)[i];
  float4* stage4 = reinterpret_cast<float4*>(stage);
  for (int i = tid; i < dout_p; i += kLanes) stage4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int blk = blockIdx.x % nblk;
  const float* S = src + (size_t)blk * din_p * kLanes + tid;
  const float* W = w + (size_t)blk * wn_p * kLanes + tid;
  const float* C = cb + (size_t)blk * kdim * kLanes + tid;
  for (int p0 = 0; p0 < n_paths;) {
    const VpuPath g = vpu_path(tab, p0);
    int p1 = p0 + 1;
    while (p1 < n_paths && same_sources(vpu_path(tab, p1), g)) ++p1;
    if (g.d1 == 1) vpu_paths<1, 16>(tab, p0, p1, S, W, C, stage, gl, warp);
    else if (g.d1 == 3) vpu_paths<3, 8>(tab, p0, p1, S, W, C, stage, gl, warp);
    else vpu_paths<5, 8>(tab, p0, p1, S, W, C, stage, gl, warp);
    p0 = p1;
  }
  __syncthreads();
  // row r of the step's output: its 4 group sums, then 4 zero columns
  float4* o = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * dout_p * 8);
  for (int i = tid; i < dout_p * 2; i += kLanes)
    __stcs(o + i, (i & 1) ? make_float4(0.f, 0.f, 0.f, 0.f) : stage4[i >> 1]);
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
// int32 [n_paths, 16] (mul_p a multiple of 16, d1 in 1, 3, 5, the paths'
// output rows disjoint and covering dout_p); out [reps, dout_p, 8] f32
extern "C" int dbfr_probe_chain_vpu(const float* src, const float* w, const float* cb,
                                    const int* paths, float* out, int n_paths, int reps,
                                    int nblk, int din_p, int wn_p, int kdim, int dout_p,
                                    void* stream) {
  if (n_paths <= 0 || n_paths > kMaxPaths || reps <= 0 || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_paths * 4 * sizeof(int4) + (size_t)dout_p * 4 * sizeof(float);
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
