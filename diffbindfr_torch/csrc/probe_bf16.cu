// P1: the madd-chain throughput probe. Replaces tools/probe_bf16.py:
// make_probe (the pallas_call at :48), which decided on the TPU whether the
// cmT kernels' depthwise chain should run in packed bf16. Each element runs
// the chain acc = acc * w + x + pert for `reps` steps (pert = bf16 or f32 of
// step * 1e-6, so that no step can be folded into another), from acc = 0,
// in one of three arithmetics:
//   0  f32:          acc = fmaf(acc, w, x) + pert        (FFMA + FADD)
//   1  bf16x2 mul/add: acc = ((acc * w) + x) + pert, every product and sum
//                    rounded to bf16 (mul.rn / add.rn.bf16x2: the rounding
//                    of the B11 chain, conv_fwd_wide.cuh)
//   2  bf16x2 fma:   acc = fma(acc, w, x) + pert, one rounding for the fma
//
// Bound on the H100: the instruction rate of the CUDA cores. An SM starts one
// FP32 or one bf16x2 instruction per lane and clock, so a step costs 2, 1.5
// or 1 instructions per element (f32, bf16x2 mul/add, bf16x2 fma) and
// 8192 x 1024 elements x 2000 steps take at least 1.003 / 0.752 / 0.502 ms
// at 132 SMs x 128 lanes x 1.98 GHz. Everything else a step runs is
// overhead against that floor: the step's pert (a multiply, and for bf16 a
// rounding and pack), the step counter, the loop. The design spreads it:
// - a thread runs kVecs = 4 vectors of 16 bytes (16 f32 or 32 bf16
//   chains), so the per-step scalar work is shared by 4x the chains, and
//   the independent chains hide each step's dependent latency;
// - the step number comes from a float counter (rf += 1, exact below
//   2^24), so no int-to-float conversion runs; pert is formed and
//   packed once per thread and step;
// - x and w are read with 4-byte loads: a 16-byte load lands in an aligned
//   quad of registers, which puts an element's w and x (and, as ptxas then
//   allocates, its acc) in the same register banks, and the three-operand
//   FFMA / HFMA2 then waits on bank conflicts; with 4-byte loads ptxas
//   places the operands apart;
// - the step loop is unrolled 8x.
// Every element-step is still computed: nothing is hoisted or folded
// across steps. A block is one warp, so that the blocks spread evenly over
// the SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x2.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kVecs = 4;
constexpr int kBlockVecs = kThreads * kVecs;
// 32 one-warp blocks per SM (its most): 8 warps per scheduler, <= 64 registers
constexpr int kMinBlocks = 32;

// the thread's first vector, and how many of its kVecs vectors (j-th at
// v0 + j * kThreads) lie below n
__device__ __forceinline__ int thread_vecs(int n, int* v0) {
  *v0 = blockIdx.x * kBlockVecs + threadIdx.x;
  const int left = n - *v0;
  return left <= 0 ? 0 : min(kVecs, (left + kThreads - 1) / kThreads);
}

// the four 32-bit words of vector v (zeros where it lies past the array),
// each by its own load
template <class V, class T>
__device__ __forceinline__ void load_words(const V* __restrict__ p, int v, bool in, T* dst) {
  const T* q = reinterpret_cast<const T*>(p + (in ? v : 0));
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[k] = in ? __ldg(q + k) : T(0);
}

// A thread's vectors past the array run on zeros and are not stored, so
// that every thread runs the one compiled step loop.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    probe_f32_kernel(const float4* __restrict__ x, const float4* __restrict__ w,
                     float4* __restrict__ out, int n, int reps) {
  int v0;
  const int nv = thread_vecs(n, &v0);
  if (nv == 0) return;
  float xs[kVecs * 4], ws[kVecs * 4], acc[kVecs * 4];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    load_words(x, v0 + j * kThreads, j < nv, xs + 4 * j);
    load_words(w, v0 + j * kThreads, j < nv, ws + 4 * j);
  }
#pragma unroll
  for (int e = 0; e < kVecs * 4; ++e) acc[e] = 0.f;
  float rf = 0.f;
#pragma unroll 8
  for (int r = 0; r < reps; ++r) {
    const float pert = __fmul_rn(rf, 1e-6f);
#pragma unroll
    for (int e = 0; e < kVecs * 4; ++e) acc[e] = __fadd_rn(fmaf(acc[e], ws[e], xs[e]), pert);
    rf = __fadd_rn(rf, 1.f);
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
    if (j < nv)
      out[v0 + j * kThreads] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                                           acc[4 * j + 3]);
}

template <bool FMA>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    probe_bf16_kernel(const uint4* __restrict__ x, const uint4* __restrict__ w,
                      uint4* __restrict__ out, int n, int reps) {
  int v0;
  const int nv = thread_vecs(n, &v0);
  if (nv == 0) return;
  uint32_t xs[kVecs * 4], ws[kVecs * 4], acc[kVecs * 4];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    load_words(x, v0 + j * kThreads, j < nv, xs + 4 * j);
    load_words(w, v0 + j * kThreads, j < nv, ws + 4 * j);
  }
#pragma unroll
  for (int e = 0; e < kVecs * 4; ++e) acc[e] = 0u;
  float rf = 0.f;
#pragma unroll 8
  for (int r = 0; r < reps; ++r) {
    // one cvt.rn.bf16x2.f32: both halves the bf16 of step * 1e-6
    const float pf = __fmul_rn(rf, 1e-6f);
    const __nv_bfloat162 p2 = __floats2bfloat162_rn(pf, pf);
    const uint32_t pert = *reinterpret_cast<const uint32_t*>(&p2);
#pragma unroll
    for (int e = 0; e < kVecs * 4; ++e) {
      const uint32_t t = FMA ? dbfr::fma_bf16x2(acc[e], ws[e], xs[e])
                             : dbfr::add_bf16x2(dbfr::mul_bf16x2(acc[e], ws[e]), xs[e]);
      acc[e] = dbfr::add_bf16x2(t, pert);
    }
    rf = __fadd_rn(rf, 1.f);
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
    if (j < nv)
      out[v0 + j * kThreads] = make_uint4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                                          acc[4 * j + 3]);
}

}  // namespace

// variant 0: x, w, out are float [n * 4]; variants 1, 2: bf16 [n * 8]
extern "C" int dbfr_probe_bf16(const void* x, const void* w, void* out, int n_vec, int reps,
                               int variant, void* stream) {
  if (n_vec <= 0) return 0;
  const int blocks = (n_vec + kBlockVecs - 1) / kBlockVecs;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    probe_f32_kernel<<<blocks, kThreads, 0, st>>>((const float4*)x, (const float4*)w,
                                                  (float4*)out, n_vec, reps);
  } else if (variant == 1) {
    probe_bf16_kernel<false><<<blocks, kThreads, 0, st>>>((const uint4*)x, (const uint4*)w,
                                                          (uint4*)out, n_vec, reps);
  } else if (variant == 2) {
    probe_bf16_kernel<true><<<blocks, kThreads, 0, st>>>((const uint4*)x, (const uint4*)w,
                                                         (uint4*)out, n_vec, reps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
