// The cmT path table of the probes' depthwise chains (P2 chain_vpu /
// chain_mxu, probe_mxu_ops.cu; P3 dwloop, probe_mosaic.cu), and the warp's
// f32 butterfly sum of P3 dwloop. The table is built by
// diffbindfr_torch/probes/cm_layout.py (`path_table`): int32 [n_paths,
// kPathCols], one row per path, its columns in the order of `Path` below
// (unused source rows -1); chain_vpu reads a row as four int4.
#pragma once

namespace dbfr {

constexpr int kMaxD1 = 5;
constexpr int kPathCols = 16;  // path table row: mul_p, d1, d3, w_row, out_row, cb_off, src[5]

struct Path {
  int mp, d1, d3, w_row, out_row, cb_off, src[kMaxD1];
};

__device__ __forceinline__ Path load_path(const int* __restrict__ t, int p) {
  const int* r = t + p * kPathCols;
  Path q;
  q.mp = r[0];
  q.d1 = r[1];
  q.d3 = r[2];
  q.w_row = r[3];
  q.out_row = r[4];
  q.cb_off = r[5];
#pragma unroll
  for (int i = 0; i < kMaxD1; ++i) q.src[i] = r[6 + i];
  return q;
}

// the sum of v over the warp, in every lane: xor-shuffle butterfly, halves
// 16, 8, 4, 2, 1 (probes/_cuda.py `butterfly_sum` is its order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace dbfr
