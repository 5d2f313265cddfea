// The fp32 contraction out[M, N] = a[M, K] . b[N, K]^T with both operands
// contiguous along K, shared by P3-abt (probe_mosaic.cu; the TPU tool's
// model of the backward kernels' weight-gradient contraction,
// tools/probe_mosaic.py:343) and B4 (cross_bwd.cu), whose parameter
// gradients are such contractions over the pairs of a batch.
//
// Bound on the H100: fp32 FMA on the CUDA cores (no tensor cores, no TF32:
// the gates hold it to fp32 sums). Design:
//  * 64 x 64 block tiles, 256 threads each holding a 4 x 4 register tile
//    (rows ty + 16 i, columns tx + 16 j: the float4 reads of a warp hit
//    distinct bank groups);
//  * A and B staged through shared memory in K slices of 32 by cp.async,
//    two stages, so the next slice loads while the current one is used;
//    16-byte copies where rows and K are multiples of 4 floats, else 4-byte;
//  * split-K: when the M x N tiles alone would leave SMs idle, the K axis
//    is cut into `splits` chunks; each (tile, chunk) block writes its own
//    slab of partial sums and abt_reduce_kernel adds the slabs in order
//    (deterministic, no atomics);
//  * rows M .. M + n_seg - 1 of A are generated, not read: row M + r is 1
//    on k in [seg[r], seg[r + 1]) (seg null: one row of ones), so a bias
//    gradient (a sum over K, per segment) comes out as extra output rows;
//  * several problems with the same K run in one launch (a group): each
//    writes its [M + n_seg, N] result at out_off of one partial row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dbfr {

constexpr int kAbtTile = 64;      // block tile, rows and columns
constexpr int kAbtBK = 32;        // K slice per stage
constexpr int kAbtThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kAbtMaxProblems = 4;

struct AbtProblem {
  const float* a;  // [M, K], rows lda apart
  const float* b;  // [N, K], rows ldb apart
  const int* seg;  // [n_seg + 1] offsets of the generated rows of A, or null
  int M, N, lda, ldb, n_seg;
  int out_off;     // where out[M + n_seg, N] starts in a partial row
  int tiles_n, tiles, block0;  // set by abt_launch
};

struct AbtGroup {
  AbtProblem p[kAbtMaxProblems];
  float* part;   // [splits, stride] partial sums
  int n, K, stride;
  int kchunk, splits, vec;  // set by abt_launch
};

// 16- and 4-byte asynchronous copies global -> shared; src_bytes = 0 fills
// the destination with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Launch the group's contraction over at most `max_splits` K chunks into
// g.part, then the in-order sum of the chunks into out[0 .. g.stride).
// Returns a cudaError_t.
int abt_launch(AbtGroup g, int max_splits, float* out, cudaStream_t st);

}  // namespace dbfr
