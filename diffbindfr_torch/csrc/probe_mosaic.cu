// P3: the Mosaic construct probes of the cmT kernels, as Hopper kernels.
// Replaces the ten pallas_calls of tools/probe_mosaic.py (probe_3d_accum :40,
// probe_onehot_matmul :68, probe_tile_lanes :91, probe_bcast2d :109,
// probe_4d_block :129, probe_msel :154, probe_precision :199, probe_dwloop
// :243, probe_mlps :291, probe_abt :343), which checked on the TPU that each
// construct lowers and how fast it runs. Each computes a plain function; here
// it gets the plainest kernel for that function (probe_mlps is the P4 kernel,
// csrc/probe_mlp.cu, and probe_precision the gather below):
//
//   accum3d   x [16, 256] -> out [2, 64, 8]; rows 8-23 of each block are
//             (0 + x[:, 0:8] * 1) + x[:, 128:136] * 2, the two grid steps'
//             accumulation into row slices; other rows 0
//   gather    a [m, n] -> out [m, 8 * 128 * ...]: out[:, p] = a[:, p / 128],
//             the one-hot movement matmul (onehot_matmul, precision) as a
//             gather: bit-exact by construction, no dot at all
//   tile      a [m, 128] -> out [m, 128 * reps], lanes tiled
//   bcast2d   d [1, n], offs [c, 1] -> exp(-0.5 * (d - offs)^2) [c, n], expf
//   block4d   b [2, 2, m, n] -> 2 * b[1, 1] (the last grid step wins)
//   msel      z [rows, 1024] -> the sums of each 128-lane group, [rows, 8]
//   dwloop    the f32 depthwise chain of the trunk's sep spec over R pairs
//             with a pair mask, in the order of _dw_paths_t (w masked per
//             path first, bs = src * w, z = sum_i bs_i * cb, i ascending,
//             every product and sum rounded on its own), then the sum of z
//             over each 128-lane group; 8 identical blocks [8, dout_p, R/128]
//   abt       a [M, K], b [N, K] -> a @ b^T [M, N], fp32 on the CUDA cores
//
// Bounds on the H100: the layout probes move a few hundred KB: a launch is
// latency (a few us) against a bound under 0.2 us, and their design is one
// thread per output element, neighbouring threads on neighbouring addresses.
// msel and dwloop are small reductions (bytes); abt's 1.42e8 fp32 operations
// take 2.1 us at 67 TFLOP/s against 0.85 us for its 2.8 MB, so operations
// bind it. abt runs the split-K contraction of abt_gemm.cuh, the one B4's
// parameter gradients run: its 8 x 3 output tiles of 64 x 64 alone would
// leave most SMs idle, so K = 1024 is cut into chunks summed in order.
#include <cuda_runtime.h>

#include "abt_gemm.cuh"
#include "probe_path.cuh"

namespace {

using dbfr::load_path;
using dbfr::Path;
using dbfr::warp_sum;

constexpr int kThreads = 256;

__global__ void accum3d_kernel(const float* __restrict__ x, float* __restrict__ out) {
  // out [2, 64, 8], x [16, 256]
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * 64 * 8) return;
  const int r = (i / 8) % 64, c = i % 8;
  float v = 0.f;
  if (r >= 8 && r < 24) {
    v = __fadd_rn(0.f, __fmul_rn(x[(r - 8) * 256 + c], 1.f));
    v = __fadd_rn(v, __fmul_rn(x[(r - 8) * 256 + 128 + c], 2.f));
  }
  out[i] = v;
}

__global__ void gather_kernel(const float* __restrict__ a, float* __restrict__ out, int m, int n,
                              int width, int group) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m * width) return;
  const int r = i / width, p = i % width;
  out[i] = a[r * n + p / group];
}

__global__ void tile_kernel(const float* __restrict__ a, float* __restrict__ out, int m, int n,
                            int reps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m * n * reps) return;
  const int r = i / (n * reps), p = i % (n * reps);
  out[i] = a[r * n + p % n];
}

__global__ void bcast2d_kernel(const float* __restrict__ d, const float* __restrict__ offs,
                               float* __restrict__ out, int c, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= c * n) return;
  const float t = __fsub_rn(d[i % n], offs[i / n]);
  out[i] = expf(__fmul_rn(-0.5f, __fmul_rn(t, t)));
}

__global__ void block4d_kernel(const float* __restrict__ b, float* __restrict__ out, int mn) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= mn) return;
  out[i] = __fmul_rn(b[3 * mn + i], 2.f);  // b[1, 1] of [2, 2, m, n]
}

// one block per row of 1024 lanes, 256 threads: thread t holds lanes 4t..4t+3,
// so warp w covers the 128-lane group w
__global__ void __launch_bounds__(kThreads) msel_kernel(const float* __restrict__ z,
                                                         float* __restrict__ out) {
  const float4 v = reinterpret_cast<const float4*>(z + (size_t)blockIdx.x * 1024)[threadIdx.x];
  const float s = warp_sum(__fadd_rn(__fadd_rn(__fadd_rn(v.x, v.y), v.z), v.w));
  if ((threadIdx.x & 31) == 0) out[blockIdx.x * 8 + (threadIdx.x >> 5)] = s;
}

constexpr int kLanes = 128;
constexpr int kMaxDout = 1024;

// one path's f32 chain for pair `col`; each warp's sums go to part[row * 4 + warp]
template <int D1, int D3>
__device__ void dw_path(const Path& q, const float* __restrict__ src, const float* __restrict__ w,
                        const float* __restrict__ cb, float mask, int R, int col, float* part,
                        int lane, int warp) {
  float c[D1 * D3];
#pragma unroll
  for (int i = 0; i < D1 * D3; ++i) c[i] = cb[(size_t)(q.cb_off + i) * R + col];
  for (int u = 0; u < q.mp; ++u) {
    const float wp = __fmul_rn(w[(size_t)(q.w_row + u) * R + col], mask);
    float bs[D1];
#pragma unroll
    for (int i = 0; i < D1; ++i) bs[i] = __fmul_rn(src[(size_t)(q.src[i] + u) * R + col], wp);
#pragma unroll
    for (int k = 0; k < D3; ++k) {
      float z = __fmul_rn(bs[0], c[k]);
#pragma unroll
      for (int i = 1; i < D1; ++i) z = __fadd_rn(z, __fmul_rn(bs[i], c[i * D3 + k]));
      z = warp_sum(z);
      if (lane == 0) part[(q.out_row + k * q.mp + u) * 4 + warp] += z;
    }
  }
}

template <int D1>
__device__ void dw_path_d3(const Path& q, const float* src, const float* w, const float* cb,
                           float mask, int R, int col, float* part, int lane, int warp) {
  if (q.d3 == 1) dw_path<D1, 1>(q, src, w, cb, mask, R, col, part, lane, warp);
  else if (q.d3 == 3) dw_path<D1, 3>(q, src, w, cb, mask, R, col, part, lane, warp);
  else dw_path<D1, 5>(q, src, w, cb, mask, R, col, part, lane, warp);
}

// grid (reps, R / 128), 128 threads: block (rep, g) sums the pairs of group g
__global__ void __launch_bounds__(kLanes) dwloop_kernel(
    const float* __restrict__ src, const float* __restrict__ w, const float* __restrict__ cb,
    const float* __restrict__ mask, const int* __restrict__ paths, float* __restrict__ out,
    int n_paths, int R, int dout_p) {
  __shared__ float part[kMaxDout * 4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = blockIdx.y;
  const int col = g * kLanes + tid;
  for (int i = tid; i < dout_p * 4; i += kLanes) part[i] = 0.f;
  __syncthreads();
  const float m = mask[col];
  for (int p = 0; p < n_paths; ++p) {
    const Path q = load_path(paths, p);
    if (q.d1 == 1) dw_path_d3<1>(q, src, w, cb, m, R, col, part, lane, warp);
    else if (q.d1 == 3) dw_path_d3<3>(q, src, w, cb, m, R, col, part, lane, warp);
    else dw_path_d3<5>(q, src, w, cb, m, R, col, part, lane, warp);
  }
  __syncthreads();
  const int groups = gridDim.y;
  float* o = out + (size_t)blockIdx.x * dout_p * groups;
  for (int r = tid; r < dout_p; r += kLanes) {
    const float* s = part + r * 4;
    o[r * groups + g] = __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
  }
}

inline int blocks(long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int dbfr_probe_accum3d(const float* x, float* out, void* stream) {
  accum3d_kernel<<<blocks(2 * 64 * 8), kThreads, 0, (cudaStream_t)stream>>>(x, out);
  return (int)cudaGetLastError();
}

// a [m, n] -> out [m, width], out[r, p] = a[r, p / group]
extern "C" int dbfr_probe_gather(const float* a, float* out, int m, int n, int width, int group,
                                 void* stream) {
  gather_kernel<<<blocks((long)m * width), kThreads, 0, (cudaStream_t)stream>>>(a, out, m, n,
                                                                               width, group);
  return (int)cudaGetLastError();
}

extern "C" int dbfr_probe_tile(const float* a, float* out, int m, int n, int reps, void* stream) {
  tile_kernel<<<blocks((long)m * n * reps), kThreads, 0, (cudaStream_t)stream>>>(a, out, m, n,
                                                                                reps);
  return (int)cudaGetLastError();
}

extern "C" int dbfr_probe_bcast2d(const float* d, const float* offs, float* out, int c, int n,
                                  void* stream) {
  bcast2d_kernel<<<blocks((long)c * n), kThreads, 0, (cudaStream_t)stream>>>(d, offs, out, c, n);
  return (int)cudaGetLastError();
}

// b [2, 2, m, n] -> out [m, n]; mn = m * n
extern "C" int dbfr_probe_block4d(const float* b, float* out, int mn, void* stream) {
  block4d_kernel<<<blocks(mn), kThreads, 0, (cudaStream_t)stream>>>(b, out, mn);
  return (int)cudaGetLastError();
}

// z [rows, 1024] -> out [rows, 8]
extern "C" int dbfr_probe_msel(const float* z, float* out, int rows, void* stream) {
  if (rows <= 0) return 0;
  msel_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(z, out);
  return (int)cudaGetLastError();
}

// src [din_p, R], w [wn_p, R], cb [kdim, R], mask [R] f32; paths int32
// [n_paths, 16]; out [reps, dout_p, R / 128]
extern "C" int dbfr_probe_dwloop(const float* src, const float* w, const float* cb,
                                 const float* mask, const int* paths, float* out, int n_paths,
                                 int reps, int R, int dout_p, void* stream) {
  if (R % kLanes || dout_p > kMaxDout || reps <= 0) return (int)cudaErrorInvalidValue;
  dwloop_kernel<<<dim3(reps, R / kLanes), kLanes, 0, (cudaStream_t)stream>>>(
      src, w, cb, mask, paths, out, n_paths, R, dout_p);
  return (int)cudaGetLastError();
}

// a [M, K], b [N, K] -> out [M, N] = a @ b^T, through at most `splits` K
// chunks whose partial sums go to part [splits, M * N]
extern "C" int dbfr_probe_abt(const float* a, const float* b, float* part, float* out, int M,
                              int N, int K, int splits, void* stream) {
  dbfr::AbtGroup g = {};
  g.n = 1;
  g.K = K;
  g.stride = M * N;
  g.part = part;
  g.p[0].a = a;
  g.p[0].b = b;
  g.p[0].M = M;
  g.p[0].N = N;
  g.p[0].lda = K;
  g.p[0].ldb = K;
  return dbfr::abt_launch(g, splits, out, (cudaStream_t)stream);
}
