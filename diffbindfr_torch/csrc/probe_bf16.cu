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
// A thread runs one 16-byte vector of elements (4 f32 or 8 bf16 chains):
// independent chains hide the latency of each dependent step. Bound on the
// H100: arithmetic on the CUDA cores (67 TFLOP/s f32; bf16x2 packs two
// elements per instruction); probes/bf16_chain.py times R and
// 2R steps and takes the per-step time from the difference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x2.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) probe_f32_kernel(const float4* __restrict__ x,
                                                             const float4* __restrict__ w,
                                                             float4* __restrict__ out, int n,
                                                             int reps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float4 xv = x[i], wv = w[i];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < reps; ++r) {
    const float pert = __fmul_rn((float)r, 1e-6f);
    acc.x = __fadd_rn(fmaf(acc.x, wv.x, xv.x), pert);
    acc.y = __fadd_rn(fmaf(acc.y, wv.y, xv.y), pert);
    acc.z = __fadd_rn(fmaf(acc.z, wv.z, xv.z), pert);
    acc.w = __fadd_rn(fmaf(acc.w, wv.w, xv.w), pert);
  }
  out[i] = acc;
}

template <bool FMA>
__global__ void __launch_bounds__(kThreads) probe_bf16_kernel(const uint4* __restrict__ x,
                                                              const uint4* __restrict__ w,
                                                              uint4* __restrict__ out, int n,
                                                              int reps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 xv = x[i], wv = w[i];
  const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  for (int r = 0; r < reps; ++r) {
    const __nv_bfloat16 p = __float2bfloat16_rn(__fmul_rn((float)r, 1e-6f));
    const uint32_t pert = dbfr::pack_bf16x2(p, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t t = FMA ? dbfr::fma_bf16x2(acc[j], ws[j], xs[j])
                             : dbfr::add_bf16x2(dbfr::mul_bf16x2(acc[j], ws[j]), xs[j]);
      acc[j] = dbfr::add_bf16x2(t, pert);
    }
  }
  out[i] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
}

}  // namespace

// variant 0: x, w, out are float [n * 4]; variants 1, 2: bf16 [n * 8]
extern "C" int dbfr_probe_bf16(const void* x, const void* w, void* out, int n_vec, int reps,
                               int variant, void* stream) {
  if (n_vec <= 0) return 0;
  const int blocks = (n_vec + kThreads - 1) / kThreads;
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
