// The valid pairs of a dense trunk conv as one list, and the per-node sums
// over it: the first and last steps of the backward kernels that walk the
// list in wide tiles (B4, cross_bwd.cu: the cross conv's (ligand, atom)
// pairs; B5, pair_bwd.cu: the pair conv's (ligand, ligand) pairs).
//  1. dense_pairs_count: per target row, the rank of each valid source
//     among the row's valid sources (the forward's mask decision,
//     dense_valid, in source order) and the row's count; per source, its
//     count; exclusive prefix sums of both (one block each, in order: no
//     atomics). The caller reads the total P to the host and sizes its
//     scratch by it;
//  2. dense_pairs_fill: the list in target-major order (b, target, source
//     ascending), per-sample offsets, and each pair's place in source-major
//     order (a counting sort, target order kept within a source);
//  3. segment_sum_kernel: per node, the rows of its segment of the list (or
//     of its source-major permutation), added in list order.
// Every sum runs in a fixed order: two calls give the same bits.
#pragma once

#include "trunk_conv.cuh"

namespace dbfr {
namespace {

// target row (blockIdx.x, sample blockIdx.y): pid[b][t][s] = rank of source
// s among the row's valid sources, or -1; cnt[b][t] = their number
__global__ void __launch_bounds__(kThreads) pairs_count_kernel(ConvArgs a, int* pid, int* cnt) {
  __shared__ int wcnt[kThreads / 32];
  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* row = pid + ((size_t)b * a.nt + t) * a.nsrc;
  const bool tgt_ok = a.tgt_mask[(size_t)b * a.nt + t] > 0.f;
  const float cut = a.cutoff[b];
  int total = 0;
  for (int c0 = 0; c0 < a.nsrc; c0 += kThreads) {
    const int s = c0 + tid;
    const bool ok = s < a.nsrc && tgt_ok && dense_valid(a, b, t, s, cut);
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = total, all = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) off += wcnt[w];
      all += wcnt[w];
    }
    if (s < a.nsrc) row[s] = ok ? off + __popc(bal & ((1u << lane) - 1u)) : -1;
    total += all;
    __syncthreads();
  }
  if (tid == 0) cnt[(size_t)b * a.nt + t] = total;
}

// cnt[b][s] = valid pairs of source s of sample b
__global__ void src_count_kernel(const int* __restrict__ pid, int batch, int nt, int nsrc,
                                 int* __restrict__ cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * nsrc) return;
  const int b = i / nsrc, s = i % nsrc;
  int c = 0;
  for (int t = 0; t < nt; ++t) c += pid[((size_t)b * nt + t) * nsrc + s] >= 0;
  cnt[i] = c;
}

// out[0 .. n] = exclusive prefix sums of in[0 .. n - 1] (out[n] = total); one block
__global__ void __launch_bounds__(1024) exclusive_scan_kernel(const int* __restrict__ in, int n,
                                                              int* __restrict__ out) {
  __shared__ int wsum[32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += 1024) {
    const int v = base + tid < n ? in[base + tid] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = wsum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      wsum[lane] = s;
    }
    __syncthreads();
    if (base + tid < n) out[base + tid] = carry + (warp ? wsum[warp - 1] : 0) + x - v;
    __syncthreads();
    if (tid == 0) carry += wsum[31];
    __syncthreads();
  }
  if (tid == 0) out[n] = carry;
}

// the pair list: pair g = tgt_off[b][t] + pid[b][t][s] holds (t, s, b); its
// place in source-major order, at_src[g] = src_off[b][s] + j for the j-th
// pair of source s in list order (a counting sort); sample_off[b] = the
// first pair of sample b (sample_off[B] = P)
__global__ void pairs_fill_kernel(const int* __restrict__ pid, const int* __restrict__ tgt_off,
                                  const int* __restrict__ src_off, int batch, int nt, int nsrc,
                                  int* __restrict__ pair_t, int* __restrict__ pair_s,
                                  int* __restrict__ pair_b, int* __restrict__ at_src,
                                  int* __restrict__ sample_off) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * nsrc) return;
  const int b = i / nsrc, s = i % nsrc;
  if (s == 0) sample_off[b] = tgt_off[(size_t)b * nt];
  if (i == 0) sample_off[batch] = tgt_off[(size_t)batch * nt];
  int j = src_off[i];
  for (int t = 0; t < nt; ++t) {
    const int r = pid[((size_t)b * nt + t) * nsrc + s];
    if (r < 0) continue;
    const int g = tgt_off[(size_t)b * nt + t] + r;
    pair_t[g] = t;
    pair_s[g] = s;
    pair_b[g] = b;
    at_src[g] = j++;
  }
}

// out[node][c] = sum over the node's rows q = off[node] .. off[node + 1] - 1
// (in order) of src_rows[q][c] + (c < ns ? tgt_rows[q][c] : 0), a null
// src_rows or tgt_rows adding nothing. W warps per node (W divides 8): warp
// w sums rows off[node] + w, + w + W, ... with each lane holding its
// columns c = lane + 32 i and the loads of kSegU rows in flight together;
// then the W partial sums are added in warp order. Fixed order:
// deterministic.
constexpr int kSegC = 10;  // columns per lane: din <= 320
constexpr int kSegU = 4;   // rows per step whose loads are in flight together
template <int W>
__global__ void __launch_bounds__(256) segment_sum_kernel(
    const int* __restrict__ off, const float* __restrict__ src_rows,
    const float* __restrict__ tgt_rows, int nodes, int din, int ns, float* __restrict__ out) {
  __shared__ float part[8][32 * kSegC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int node = blockIdx.x * (8 / W) + warp / W, w = warp % W;
  float acc[kSegC];
#pragma unroll
  for (int i = 0; i < kSegC; ++i) acc[i] = 0.f;
  if (node < nodes) {
    const int q1 = off[node + 1];
    for (int q = off[node] + w; q < q1; q += kSegU * W) {
      float v[kSegU][kSegC];
      // every load unconditional (indices clamped into the node's rows), so
      // that all of them issue before the first is used; masked after
#pragma unroll
      for (int u = 0; u < kSegU; ++u) {
        const int r = q + u * W;
        const size_t rc = (size_t)min(r, q1 - 1);
#pragma unroll
        for (int i = 0; i < kSegC; ++i) {
          const int c = lane + 32 * i;
          const float x = src_rows ? src_rows[rc * din + min(c, din - 1)] : 0.f;
          const float t = tgt_rows ? tgt_rows[rc * ns + min(c, ns - 1)] : 0.f;
          v[u][i] = r < q1 && c < din ? x + (c < ns ? t : 0.f) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSegU; ++u)
#pragma unroll
        for (int i = 0; i < kSegC; ++i) acc[i] += v[u][i];
    }
  }
  if (W > 1) {
#pragma unroll
    for (int i = 0; i < kSegC; ++i) part[warp][lane + 32 * i] = acc[i];
    __syncthreads();
    if (w != 0) return;
#pragma unroll
    for (int i = 0; i < kSegC; ++i)
      for (int v = 1; v < W; ++v) acc[i] += part[warp + v][lane + 32 * i];
  }
  if (node >= nodes) return;
#pragma unroll
  for (int i = 0; i < kSegC; ++i) {
    const int c = lane + 32 * i;
    if (c < din) out[(size_t)node * din + c] = acc[i];
  }
}

inline int grid(long n, int per) { return (int)((n + per - 1) / per); }

// Step 1 for the conv `a` (its targets, sources, masks, cutoff, cab, bond
// mask and exclude_self; batch samples): pid [B, nt, nsrc], cnt_t [B nt],
// tgt_off [B nt + 1], cnt_s [B nsrc], src_off [B nsrc + 1]. Returns a
// cudaError_t.
inline int dense_pairs_count(const ConvArgs& a, int batch, int* pid, int* cnt_t, int* tgt_off,
                             int* cnt_s, int* src_off, cudaStream_t st) {
  if (batch <= 0 || a.nt <= 0 || a.nsrc <= 0) return (int)cudaErrorInvalidValue;
  pairs_count_kernel<<<dim3(a.nt, batch), kThreads, 0, st>>>(a, pid, cnt_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exclusive_scan_kernel<<<1, 1024, 0, st>>>(cnt_t, batch * a.nt, tgt_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  src_count_kernel<<<grid((long)batch * a.nsrc, 256), 256, 0, st>>>(pid, batch, a.nt, a.nsrc,
                                                                     cnt_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exclusive_scan_kernel<<<1, 1024, 0, st>>>(cnt_s, batch * a.nsrc, src_off);
  return (int)cudaGetLastError();
}

// Step 2: the list (pair_t, pair_s, pair_b, at_src) and sample_off [B + 1]
// from step 1's pid and offsets. Returns a cudaError_t.
inline int dense_pairs_fill(const int* pid, const int* tgt_off, const int* src_off, int batch,
                            int nt, int nsrc, int* pair_t, int* pair_s, int* pair_b, int* at_src,
                            int* sample_off, cudaStream_t st) {
  pairs_fill_kernel<<<grid((long)batch * nsrc, 256), 256, 0, st>>>(
      pid, tgt_off, src_off, batch, nt, nsrc, pair_t, pair_s, pair_b, at_src, sample_off);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dbfr
