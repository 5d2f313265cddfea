// P4: the fused two-layer MLP of one cmT block. Replaces tools/probe_timing.py:
// fn (the pallas_call at :22), which timed on the TPU the TP-weight MLP of the
// cmT kernels on one 1024-pair block; tools/probe_mosaic.py: probe_mlps (the
// call at :291) has the same body and shapes and is served by this kernel too.
//
//   out[480, R] = w2[480, 144] @ relu(w1[144, 144] @ e[144, R] + b1[144])
//
// b2 is an input of the TPU kernel and never added there; it is not read here.
// The TPU grid of 8 repeats one block, so the output is one [480, R] block.
//
// Bound on the H100: at R = 1024 the 1.84e8 fp32 operations take 2.75 us at
// 67 TFLOP/s and the 2.9 MB of inputs and output 0.87 us at 3.35 TB/s, so
// operations bound it. Design: one block per 64-column tile of R and 96-row
// slice of the output (80 blocks at R = 1024, 5 at R = 32: the card is far
// from full, as with B1's 32-pair chunks); each block computes the hidden
// tile hh [144, 64] (ReLU fused), which stays in shared memory (36 KB) for
// the second product; each thread keeps a register tile of the product and
// reads its operands from shared-memory tiles staged 8 columns of K at a time.
#include <cuda_runtime.h>

namespace {

constexpr int kH = 144;     // hidden width (rows of w1, columns of w2)
constexpr int kOut = 480;   // rows of w2
constexpr int kTile = 64;   // columns of R per block
constexpr int kK = 8;       // K columns staged per step
constexpr int kThreads = 256;
constexpr int kRowBlock = 96;  // output rows per block (blockIdx.y)

__global__ void __launch_bounds__(kThreads) probe_mlp_kernel(const float* __restrict__ e,
                                                             const float* __restrict__ w1,
                                                             const float* __restrict__ b1,
                                                             const float* __restrict__ w2,
                                                             float* __restrict__ out, int R) {
  __shared__ float hh[kH][kTile];
  __shared__ float ws[kH][kK];
  __shared__ float es[kK][kTile];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c0 = blockIdx.x * kTile;

  // hh = relu(w1 @ e[:, c0:c0+64] + b1): rows ty + 16 i, columns tx + 16 j
  float acc[9][4];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kH; k0 += kK) {
    for (int i = tid; i < kH * kK; i += kThreads)
      ws[i / kK][i % kK] = w1[(i / kK) * kH + k0 + i % kK];
    for (int i = tid; i < kK * kTile; i += kThreads) {
      const int kk = i / kTile, c = i % kTile;
      es[kk][c] = c0 + c < R ? e[(size_t)(k0 + kk) * R + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      float ev[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ev[j] = es[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const float wv = ws[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv, ev[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float b = b1[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) hh[ty + 16 * i][tx + 16 * j] = fmaxf(acc[i][j] + b, 0.f);
  }
  __syncthreads();

  // out[r0:r0+96, c0:c0+64] = w2[r0:r0+96] @ hh: rows r0 + ty + 16 i
  {
    const int r0 = blockIdx.y * kRowBlock;
    float o[6][4];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
    for (int k0 = 0; k0 < kH; k0 += kK) {
      for (int i = tid; i < kRowBlock * kK; i += kThreads)
        ws[i / kK][i % kK] = w2[(size_t)(r0 + i / kK) * kH + k0 + i % kK];
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        float hv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hh[k0 + kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float wv = ws[ty + 16 * i][kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(wv, hv[j], o[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < R) out[(size_t)(r0 + ty + 16 * i) * R + c] = o[i][j];
      }
  }
}

}  // namespace

// e [144, R], w1 [144, 144], b1 [144], w2 [480, 144] f32, row-major; out [480, R]
extern "C" int dbfr_probe_mlp(const float* e, const float* w1, const float* b1, const float* w2,
                              float* out, int R, void* stream) {
  if (R <= 0) return 0;
  const dim3 blocks((R + kTile - 1) / kTile, kOut / kRowBlock);
  probe_mlp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(e, w1, b1, w2, out, R);
  return (int)cudaGetLastError();
}
