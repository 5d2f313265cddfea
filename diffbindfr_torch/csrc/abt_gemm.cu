// The split-K fp32 contraction of abt_gemm.cuh (design and bound there):
// abt_kernel computes one (problem, 64 x 64 tile, K chunk) per block into
// its slab of partial sums, abt_reduce_kernel adds the slabs in order.
#include "abt_gemm.cuh"

namespace {

using dbfr::kAbtBK;
using dbfr::kAbtThreads;
using dbfr::kAbtTile;

constexpr int kPad = kAbtBK + 4;  // shared row stride: float4 reads of a warp in distinct banks

// Stage rows r0 .. r0 + 63 of an operand, K columns k0 .. k0 + 31 (zero at
// and beyond k_end), into T. Rows at and beyond `rows` are generated: rows
// rows .. rows + n_seg - 1 are indicator rows (gen), the rest zero.
template <bool VEC>
__device__ __forceinline__ void stage(float (*T)[kPad], const float* __restrict__ x, int ld,
                                      int rows, int r0, int k0, int k_end, int n_seg,
                                      const int* __restrict__ seg, int K) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int r = 0; r < kAbtTile * kAbtBK / 4 / kAbtThreads; ++r) {
      const int c = tid + r * kAbtThreads;
      const int row = c >> 3, kq = (c & 7) * 4;
      const int gr = r0 + row, k = k0 + kq;
      if (gr < rows) {
        const bool in = k < k_end;  // k_end is a multiple of 4 here
        dbfr::cp_async16(&T[row][kq], in ? x + (size_t)gr * ld + k : x, in ? 16 : 0);
      } else {
        float v[4];
        const int s = gr - rows;
        const int lo = s < n_seg ? (seg ? seg[s] : 0) : 0;
        const int hi = s < n_seg ? (seg ? seg[s + 1] : K) : 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = (k + e < k_end && k + e >= lo && k + e < hi) ? 1.f : 0.f;
        *reinterpret_cast<float4*>(&T[row][kq]) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kAbtTile * kAbtBK / kAbtThreads; ++r) {
      const int c = tid + r * kAbtThreads;
      const int row = c >> 5, kk = c & 31;
      const int gr = r0 + row, k = k0 + kk;
      if (gr < rows) {
        const bool in = k < k_end;
        dbfr::cp_async4(&T[row][kk], in ? x + (size_t)gr * ld + k : x, in ? 4 : 0);
      } else {
        const int s = gr - rows;
        const int lo = s < n_seg ? (seg ? seg[s] : 0) : 0;
        const int hi = s < n_seg ? (seg ? seg[s + 1] : K) : 0;
        T[row][kk] = (k < k_end && k >= lo && k < hi) ? 1.f : 0.f;
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kAbtThreads, 2) abt_kernel(dbfr::AbtGroup g) {
  __shared__ __align__(16) float As[2][kAbtTile][kPad];
  __shared__ __align__(16) float Bs[2][kAbtTile][kPad];
  // the problem of this block: the last whose first block is <= blockIdx.x
  const int bid = blockIdx.x;
  int pi = 0;
#pragma unroll
  for (int j = 1; j < dbfr::kAbtMaxProblems; ++j)
    if (j < g.n && bid >= g.p[j].block0) pi = j;
  dbfr::AbtProblem q = g.p[0];
#pragma unroll
  for (int j = 1; j < dbfr::kAbtMaxProblems; ++j)
    if (pi == j) q = g.p[j];
  const int local = bid - q.block0;
  const int split = local / q.tiles, tile = local % q.tiles;
  const int m0 = (tile / q.tiles_n) * kAbtTile, n0 = (tile % q.tiles_n) * kAbtTile;
  const int k_beg = split * g.kchunk;
  const int k_end = min(g.K, k_beg + g.kchunk);
  const int nk = k_end > k_beg ? (k_end - k_beg + kAbtBK - 1) / kAbtBK : 0;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (nk > 0) {
    stage<VEC>(As[0], q.a, q.lda, q.M, m0, k_beg, k_end, q.n_seg, q.seg, g.K);
    stage<VEC>(Bs[0], q.b, q.ldb, q.N, n0, k_beg, k_end, 0, nullptr, g.K);
    dbfr::cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    if (s + 1 < nk) {
      const int k0 = k_beg + (s + 1) * kAbtBK;
      stage<VEC>(As[(s + 1) & 1], q.a, q.lda, q.M, m0, k0, k_end, q.n_seg, q.seg, g.K);
      stage<VEC>(Bs[(s + 1) & 1], q.b, q.ldb, q.N, n0, k0, k_end, 0, nullptr, g.K);
      dbfr::cp_async_commit();
      dbfr::cp_async_wait<1>();
    } else {
      dbfr::cp_async_wait<0>();
    }
    __syncthreads();
    const float(*A)[kPad] = As[s & 1];
    const float(*B)[kPad] = Bs[s & 1];
#pragma unroll
    for (int kk = 0; kk < kAbtBK; kk += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(&A[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(&B[tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = acc[i][j];
          v = fmaf(av[i].x, bv[j].x, v);
          v = fmaf(av[i].y, bv[j].y, v);
          v = fmaf(av[i].z, bv[j].z, v);
          acc[i][j] = fmaf(av[i].w, bv[j].w, v);
        }
    }
    __syncthreads();
  }

  const int rows = q.M + q.n_seg;
  float* dst = g.part + (size_t)split * g.stride + q.out_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < q.N) dst[(size_t)r * q.N + c] = acc[i][j];
    }
  }
}

constexpr int kReduceU = 4;  // slabs whose loads are in flight together

// out[i] = sum over s = 0 .. splits - 1 of part[s][i], in order
__global__ void abt_reduce_kernel(const float* __restrict__ part, int splits, int stride, int n,
                                  float* __restrict__ out, int vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    if (4 * i >= n) return;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < splits; r0 += kReduceU) {
      float4 v[kReduceU];
#pragma unroll
      for (int u = 0; u < kReduceU; ++u)
        v[u] = r0 + u < splits
                   ? *reinterpret_cast<const float4*>(part + (size_t)(r0 + u) * stride + 4 * i)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kReduceU; ++u) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
    }
    *reinterpret_cast<float4*>(out + 4 * i) = s;
  } else {
    if (i >= n) return;
    float s = 0.f;
    for (int r = 0; r < splits; ++r) s += part[(size_t)r * stride + i];
    out[i] = s;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

namespace dbfr {

int abt_launch(AbtGroup g, int max_splits, float* out, cudaStream_t st) {
  if (g.n < 1 || g.n > kAbtMaxProblems || max_splits < 1 || g.K < 0 || g.stride < 0)
    return (int)cudaErrorInvalidValue;
  // K chunks of whole slices; no chunk is empty unless K is 0
  const int S = max(1, min(max_splits, (g.K + kAbtBK - 1) / kAbtBK));
  g.kchunk = max(kAbtBK, ((g.K + S - 1) / S + kAbtBK - 1) / kAbtBK * kAbtBK);
  g.splits = max(1, (g.K + g.kchunk - 1) / g.kchunk);
  bool vec = g.K % 4 == 0;
  int blocks = 0;
  for (int i = 0; i < g.n; ++i) {
    AbtProblem& p = g.p[i];
    if (p.M < 0 || p.N < 0 || p.n_seg < 0 || p.out_off < 0 ||
        p.out_off + (p.M + p.n_seg) * p.N > g.stride)
      return (int)cudaErrorInvalidValue;
    p.tiles_n = (p.N + kAbtTile - 1) / kAbtTile;
    p.tiles = p.tiles_n * ((p.M + p.n_seg + kAbtTile - 1) / kAbtTile);
    p.block0 = blocks;
    blocks += p.tiles * g.splits;
    vec = vec && p.lda % 4 == 0 && p.ldb % 4 == 0 && aligned16(p.a) && aligned16(p.b);
  }
  g.vec = vec;
  if (blocks > 0) {
    if (vec)
      abt_kernel<true><<<blocks, kAbtThreads, 0, st>>>(g);
    else
      abt_kernel<false><<<blocks, kAbtThreads, 0, st>>>(g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int rvec = g.stride % 4 == 0 && aligned16(g.part) && aligned16(out);
  const int items = rvec ? g.stride / 4 : g.stride;
  if (items > 0)
    abt_reduce_kernel<<<(items + 255) / 256, 256, 0, st>>>(g.part, g.splits, g.stride, g.stride,
                                                           out, rvec);
  return (int)cudaGetLastError();
}

}  // namespace dbfr
