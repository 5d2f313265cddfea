// The finalize epilogue of the row-major kernels (B7-B9 with fin, B10):
// each owned row's message sums, divided by max(count, 1), mixed by the
// irreps Linear and LayerNorm-ed per slot, component-major, written once.
// Counterpart of the in-kernel finalize of diffbindfr_tpu/nn/pallas_conv.py
// (dense_mix_cm, make_ln_cm; kernel at :436-441) and of pallas_layer.py.
//
// A block owns its target rows and the pair loop (conv_fwd_wide.cuh's
// wide_conv_sums for B7, B8, B9 and B10) leaves each row's complete sums in
// shared memory, so the finalize is a per-block epilogue: no second pass,
// no grid-wide reduction, no atomics, and the result is the same from run
// to run. The TPU kernels expanded the Linear into a dense [dout, out_dim]
// matrix for the MXU (419 KB at layers 3-5, more than an SM's shared
// memory); here the block-sparse weight vector itself (at most 7,776 floats
// at flagship width) is staged in shared memory and each output column sums
// over the input rows of its irrep type only (FinConsts.tables: at most
// kMixSegs input slots per output slot).
// Bound on the H100: a few thousand fp32 operations per row, against the
// pair loop's ~10^5 per row: the epilogue is not what bounds these kernels.
// Exact fp32 throughout: IEEE division and square root, no fast math.
#pragma once

#include "trunk_conv.cuh"

namespace dbfr {

constexpr int kMixSegs = 4;  // mix_meta: input slots per output slot
constexpr int kMetaW = 16;   // ints per mix_meta row
constexpr int kSlotW = 8;    // ints per ln_slots row

// Finalize targets t0 .. t0 + g - 1 of sample b from their sums in R.acc
// and ADD the result to R.oacc [g][out_dim]. Starts and ends with a barrier.
__device__ __forceinline__ void fin_epilogue(const ConvArgs& a, int b, int t0, const Regions& R) {
  const int tid = threadIdx.x;
  const int g = a.g, dout = a.dout, od = a.out_dim;
  float* wmix = R.r1;  // free after the pair loop
  float* y = R.r2;
  __syncthreads();
  // 1. divide by the clamped count; stage the mix weights
  for (int i = tid; i < g * dout; i += kThreads) {
    const int t = t0 + i / dout;
    const float c = t < a.nt ? fmaxf(a.cnt[(size_t)b * a.nt + t], 1.f) : 1.f;
    R.acc[i] = R.acc[i] / c;
  }
  for (int i = tid; i < a.mix_numel; i += kThreads) wmix[i] = __ldg(a.mix_w + i);
  __syncthreads();
  // 2. block-sparse irreps Linear: y[row][j] = sum over j's input segments
  for (int i = tid; i < g * od; i += kThreads) {
    const int gl = i / od, j = i % od;
    const int* m = a.mix_meta + j * kMetaW;
    const float* x = R.acc + gl * dout;
    const int mul3 = m[1];
    float v = 0.f;
    for (int sg = 0; sg < m[0]; ++sg) {
      const int base = m[2 + 3 * sg], len = m[3 + 3 * sg], wb = m[4 + 3 * sg];
      for (int u = 0; u < len; ++u) v = fmaf(x[base + u], wmix[wb + u * mul3], v);
    }
    y[i] = v;
  }
  __syncthreads();
  // 3. LayerNorm statistics, one thread per (row, slot): the component
  // means over the slot's channels, then 1 / sqrt(mean of the shifted squares
  // over channels and components + eps)
  for (int i = tid; i < g * a.n_slots; i += kThreads) {
    const int gl = i / a.n_slots, sl = i % a.n_slots;
    const int* s = a.ln_slots + sl * kSlotW;
    const int off = s[0], mul = s[1], d = s[2], iw = s[3];
    const float* yr = y + gl * od + off;
    float* st = R.stats + i * kStat;
    float norm = 0.f;
    for (int k = 0; k < d; ++k) {
      float sum = 0.f;
      for (int u = 0; u < mul; ++u) sum += yr[k * mul + u];
      const float mean = sum / (float)mul;
      st[k] = mean;
      float sq = 0.f;
      for (int u = 0; u < mul; ++u) {
        const float f = yr[k * mul + u] - mean * __ldg(a.ln_ms + iw + u);
        sq = fmaf(f, f, sq);
      }
      norm += sq / (float)mul;
    }
    st[kMaxComp] = 1.f / sqrtf(norm / (float)d + 1e-5f);
  }
  __syncthreads();
  // 4. normalise, scale, add the 0e bias; accumulate into oacc
  for (int i = tid; i < g * od; i += kThreads) {
    const int gl = i / od, j = i % od;
    const int* m = a.mix_meta + j * kMetaW;
    const int sl = m[14], k = m[15];
    const int* s = a.ln_slots + sl * kSlotW;
    const int u = j - s[0] - k * s[1];
    const float* st = R.stats + (gl * a.n_slots + sl) * kStat;
    const float f = y[i] - st[k] * __ldg(a.ln_ms + s[3] + u);
    float v = f * (st[kMaxComp] * __ldg(a.ln_w + s[3] + u));
    if (s[4] >= 0) v += __ldg(a.ln_b + s[4] + u);
    R.oacc[i] += v;
  }
  __syncthreads();
}

// oacc [g][out_dim] <- the residual: the rows' input features, zero-padded
// to out_dim (component-major: the irreps ladder only appends slots), or 0.
__device__ __forceinline__ void init_oacc(const ConvArgs& a, int b, int t0, const float* x,
                                          const Regions& R) {
  const int od = a.out_dim;
  for (int i = threadIdx.x; i < a.g * od; i += kThreads) {
    const int t = t0 + i / od, j = i % od;
    R.oacc[i] = (x != nullptr && t < a.nt && j < a.din) ? x[((size_t)b * a.nt + t) * a.din + j]
                                                         : 0.f;
  }
}

// oacc -> out [B, nt, out_dim]
__device__ __forceinline__ void store_oacc(const ConvArgs& a, int b, int t0, float* out,
                                           const Regions& R) {
  const int od = a.out_dim;
  for (int i = threadIdx.x; i < a.g * od; i += kThreads) {
    const int t = t0 + i / od;
    if (t < a.nt) out[((size_t)b * a.nt + t) * od + (i % od)] = R.oacc[i];
  }
}

// Host side: the finalize fields of one conv's arguments.
inline void set_fin(ConvArgs& a, const void* cnt, const void* mix_w, const void* ln_w,
                    const void* ln_ms, const void* ln_b, const void* mix_meta,
                    const void* ln_slots, int out_dim, int n_slots, int mix_numel) {
  a.cnt = (const float*)cnt;
  a.mix_w = (const float*)mix_w;
  a.ln_w = (const float*)ln_w;
  a.ln_ms = (const float*)ln_ms;
  a.ln_b = (const float*)ln_b;
  a.mix_meta = (const int*)mix_meta;
  a.ln_slots = (const int*)ln_slots;
  a.out_dim = out_dim;
  a.n_slots = n_slots;
  a.mix_numel = mix_numel;
}

}  // namespace dbfr
