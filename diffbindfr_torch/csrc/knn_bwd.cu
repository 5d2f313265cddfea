// B6: backward of the pocket-atom knn conv (B3, knn_conv.cu).
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_knn_bwd_t (the
// pallas_call at :1884, factory :1704). Given the cotangent g [B, n, dout]
// of the conv's message sums it returns d_x [B, n, din] and the gradients
// of the edge MLP (w_in, b1_eff per sample, w2, b2) and of the TP-weight MLP
// (wf1, bf1, wf2, bf2), in the layout of trunk_convs._grad_layout.
//
// The design is B4's (cross_bwd.cu) for one direction:
//  1. the list of the valid neighbour slots (valid > 0, 0 <= idx < n) in
//     (sample, target, slot) order, so each target's pairs are one segment:
//     knn_count_kernel counts each target row's pairs, knn_scan_kernel
//     takes their exclusive prefix sums (one block, in order);
//     knn_rev_kernel (one block per sample) fills the list and gives each
//     pair its place in source-major order, (target, slot) order kept within
//     a source: per-warp counts per source, their prefix sums over the warps
//     and over the sources, then each warp walks its targets in order
//     (ranks among equal sources within a step by __match_any_sync);
//  2. one wide-tile pass over the list (conv_bwd_wide.cuh wide_pass: knn
//     geometry, flip 0, Gaussian edge rows only), writing the feature-major
//     rows that the parameter gradients contract, each pair's target-scalar
//     row (de[ns:2ns]) in list order and its source row (the TP-input
//     gradient plus de[2ns:3ns]) at its source-major place;
//  3. one grouped launch of the split-K contraction (abt_gemm.cuh): dW1 +
//     db1_eff (indicator rows per sample segment), dW2 + db2, dWf1 + dbf1,
//     dWf2 + dbf2;
//  4. the node sums, one warp per atom: its target segment in list order,
//     then its source segment in source-major order.
// No host read: the list, the scratch and the pass's grid are sized by the
// B n k neighbour slots, which the host knows; the pass reads the pair
// count from the device, and its tiles beyond the count write zero columns,
// so the contractions run over every slot (at the 3dbs bucket 42% of the
// slots are empty: their columns add work, not value) and a CUDA graph can
// capture a call. Every sum runs in a fixed order (integer atomics count,
// never place): two calls give the same bits.
// Bound on the H100: fp32 FMA in the TP-weight MLP (operations: the
// recompute and both products of every MLP's backward, ~3x the forward's).
// The pass register-tiles the MLPs over 64-pair tiles with 16-row cp.async
// weight stages (conv_bwd_wide.cuh); the contractions add ~25% of its
// operations at large tile reuse.
#include "conv_bwd_wide.cuh"

namespace {

using dbfr::kThreads;

constexpr int kRevThreads = 1024;
constexpr int kRevWarps = kRevThreads / 32;
constexpr int kRevWords = 32768;  // per-warp source counters in shared memory: 128 KB

__device__ __forceinline__ bool slot_ok(const int* __restrict__ idx,
                                        const float* __restrict__ valid, size_t e, int n) {
  const int s = idx[e];
  return valid[e] > 0.f && s >= 0 && s < n;
}

// cnt[r] = valid slots of target row r = b n + t
__global__ void knn_count_kernel(const int* __restrict__ idx, const float* __restrict__ valid,
                                 int rows, int n, int k, int* __restrict__ cnt) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  int c = 0;
  for (int j = 0; j < k; ++j) c += slot_ok(idx, valid, (size_t)r * k + j, n);
  cnt[r] = c;
}

// Block-wide exclusive prefix sum of v over the threads of the block, in
// thread order; `total` receives the sum. Every thread calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum, int& total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    wsum[lane] = s;
  }
  __syncthreads();
  const int out = (warp ? wsum[warp - 1] : 0) + x - v;
  total = wsum[31];
  __syncthreads();
  return out;
}

// out[0 .. m] = exclusive prefix sums of in[0 .. m - 1] (out[m] = total); one block
__global__ void __launch_bounds__(kRevThreads) knn_scan_kernel(const int* __restrict__ in, int m,
                                                               int* __restrict__ out) {
  __shared__ int wsum[32];
  int carry = 0;
  for (int base = 0; base < m; base += kRevThreads) {
    const int i = base + threadIdx.x;
    int total;
    const int e = block_exclusive_scan(i < m ? in[i] : 0, wsum, total);
    if (i < m) out[i] = carry + e;
    carry += total;
  }
  if (threadIdx.x == 0) out[m] = carry;
}

// Sample b = blockIdx.x: the list and the source-major places of its pairs
// (see the file's note). tgt_off [B n + 1] from knn_scan_kernel; out:
// src_off [B n + 1] (the first source-major place of each source),
// sample_off [B + 1], pair_t / pair_s / pair_b / at_src per pair. Warp w
// (w < warps: warps x n counters fit the shared memory) owns targets
// [w per, (w + 1) per).
__global__ void __launch_bounds__(kRevThreads) knn_rev_kernel(
    const int* __restrict__ idx, const float* __restrict__ valid, const int* __restrict__ tgt_off,
    int batch, int n, int k, int warps, int* __restrict__ src_off, int* __restrict__ sample_off,
    int* __restrict__ pair_t, int* __restrict__ pair_s, int* __restrict__ pair_b,
    int* __restrict__ at_src) {
  extern __shared__ int cw[];  // [warps][n]: counts, then cursors, per warp and source
  __shared__ int wsum[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < warps * n; i += kRevThreads) cw[i] = 0;
  __syncthreads();
  const int per = (n + warps - 1) / warps;
  const int t0 = warp * per, t1 = warp < warps ? min(n, t0 + per) : t0;
  const size_t row0 = (size_t)b * n;
  // 1. each warp's pairs per source (integer counts: any order gives the same)
  for (int t = t0; t < t1; ++t)
    for (int j = lane; j < k; j += 32) {
      const size_t e = (row0 + t) * k + j;
      if (slot_ok(idx, valid, e, n)) atomicAdd(&cw[warp * n + idx[e]], 1);
    }
  __syncthreads();
  // 2. per source: the warps' exclusive prefix over the warps (their start
  // within the source's segment), and the segments' starts in source order
  int carry = tgt_off[row0];  // the sample's pairs start at the same place in both orders
  for (int s0 = 0; s0 < n; s0 += kRevThreads) {
    const int s = s0 + tid;
    int tot = 0;
    if (s < n)
      for (int w = 0; w < warps; ++w) {
        const int c = cw[w * n + s];
        cw[w * n + s] = tot;
        tot += c;
      }
    int total;
    const int e = block_exclusive_scan(tot, wsum, total);
    if (s < n) src_off[row0 + s] = carry + e;
    carry += total;
  }
  if (tid == 0) {
    sample_off[b] = tgt_off[row0];
    if (b == batch - 1) sample_off[batch] = src_off[(size_t)batch * n] = tgt_off[(size_t)batch * n];
  }
  __syncthreads();  // src_off of this sample is complete
  // 3. the list: the warp's targets in order, each target's slots in order;
  // a pair's source-major place = its source's start + the warp's start
  // there + the pairs of that source the warp placed before it
  const unsigned lower = (1u << lane) - 1u;
  for (int t = t0; t < t1; ++t) {
    int g = tgt_off[row0 + t];
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      const size_t e = (row0 + t) * k + j;
      const bool ok = j < k && slot_ok(idx, valid, e, n);
      const int s = ok ? idx[e] : -1 - lane;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      const unsigned peers = __match_any_sync(0xffffffffu, s);
      int place = 0;
      if (ok) place = src_off[row0 + s] + cw[warp * n + s] + __popc(peers & lower);
      __syncwarp();
      if (ok && (peers >> lane) == 1u) cw[warp * n + s] += __popc(peers);  // its group's last lane
      __syncwarp();
      if (ok) {
        const int q = g + __popc(bal & lower);
        pair_t[q] = t;
        pair_s[q] = s;
        pair_b[q] = b;
        at_src[q] = place;
      }
      g += __popc(bal);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) knn_wide_kernel(dbfr::WideArgs a) {
  dbfr::wide_pass(a);
}

// out[node][c] = sum over the node's target rows q in [tgt_off[node],
// tgt_off[node + 1]) of tgt_rows[q][c] (c < ns), then over its source rows
// q in [src_off[node], src_off[node + 1]) of src_rows[q][c], each in order.
// One warp per node, lane l holding columns l + 32 i, the loads of kSegU
// rows in flight together (indices clamped: every load unconditional).
constexpr int kSegC = 10;  // columns per lane: din <= 320
constexpr int kSegU = 4;

__device__ __forceinline__ void add_rows(const float* __restrict__ rows, int width, int q0, int q1,
                                         int lane, float* acc) {
  for (int q = q0; q < q1; q += kSegU) {
    float v[kSegU][kSegC];
#pragma unroll
    for (int u = 0; u < kSegU; ++u) {
      const float* r = rows + (size_t)min(q + u, q1 - 1) * width;
#pragma unroll
      for (int i = 0; i < kSegC; ++i) {
        const int c = lane + 32 * i;
        const float x = r[min(c, width - 1)];
        v[u][i] = q + u < q1 && c < width ? x : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kSegU; ++u)
#pragma unroll
      for (int i = 0; i < kSegC; ++i) acc[i] += v[u][i];
  }
}

__global__ void __launch_bounds__(256) knn_node_sum_kernel(
    const int* __restrict__ tgt_off, const int* __restrict__ src_off,
    const float* __restrict__ tgt_rows, const float* __restrict__ src_rows, int nodes, int din,
    int ns, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (node >= nodes) return;
  float acc[kSegC];
#pragma unroll
  for (int i = 0; i < kSegC; ++i) acc[i] = 0.f;
  add_rows(tgt_rows, ns, tgt_off[node], tgt_off[node + 1], lane, acc);
  add_rows(src_rows, din, src_off[node], src_off[node + 1], lane, acc);
#pragma unroll
  for (int i = 0; i < kSegC; ++i) {
    const int c = lane + 32 * i;
    if (c < din) out[(size_t)node * din + c] = acc[i];
  }
}

inline int grid(long n, int per) { return (int)((n + per - 1) / per); }

}  // namespace

// ld = B n k rounded up to kWideTile: the pass's grid and the scratch rows'
// stride; grads in the layout of trunk_convs._grad_layout (offsets o_win,
// o_w2, o_wf1, o_wf2, row length stride); part [max_splits, stride].
extern "C" int dbfr_knn_bwd(
    const void* pos, const void* x, const void* idx, const void* valid, const void* w_in,
    const void* beff, const void* w2, const void* b2, const void* w2t, const void* wf1,
    const void* bf1, const void* wf2, const void* bf2, const void* wf1t, const void* wf2t,
    const void* ck, const void* gs_off, const void* w_meta, const void* in_off,
    const void* in_ent, const void* gout, void* cnt_t, void* tgt_off, void* src_off,
    void* sample_off, void* pair_t, void* pair_s, void* pair_b, void* at_src, void* rows,
    void* tgt_rows, void* src_rows, void* part, void* grads, void* d_x, int batch, int n, int k,
    int din, int dout, int ns, int he, int hf, int nw, int kdim, int gs_n, int n_in, int ld,
    int o_win, int o_w2, int o_wf1, int o_wf2, int stride, int max_splits, float gs_coeff,
    void* stream) {
  const long slots = (long)batch * n * k;
  if (batch <= 0 || n <= 0 || k < 0 || ld < slots || ld % dbfr::kWideTile || din > 32 * kSegC ||
      n > kRevWords)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nodes = batch * n;
  // 1. the pair list
  knn_count_kernel<<<grid(nodes, 256), 256, 0, st>>>((const int*)idx, (const float*)valid, nodes,
                                                      n, k, (int*)cnt_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_scan_kernel<<<1, kRevThreads, 0, st>>>((const int*)cnt_t, nodes, (int*)tgt_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = dbfr::imin(kRevWarps, kRevWords / n);
  const int rev_bytes = warps * n * 4;
  err = cudaFuncSetAttribute(knn_rev_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rev_bytes);
  if (err != cudaSuccess) return (int)err;
  knn_rev_kernel<<<batch, kRevThreads, rev_bytes, st>>>(
      (const int*)idx, (const float*)valid, (const int*)tgt_off, batch, n, k, warps,
      (int*)src_off, (int*)sample_off, (int*)pair_t, (int*)pair_s, (int*)pair_b, (int*)at_src);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2. the pair pass: the list's pairs, their count read on the device
  dbfr::WideArgs a = {};
  a.pair_t = (const int*)pair_t;
  a.pair_s = (const int*)pair_s;
  a.pair_b = (const int*)pair_b;
  a.P = 0;
  a.P_dev = (const int*)tgt_off + nodes;
  a.ld = ld;
  a.tgt_pos = a.src_pos = (const float*)pos;
  a.tgt_x = a.src_x = (const float*)x;
  a.gout = (const float*)gout;
  a.nt = a.nsrc = n;
  a.din = din;
  a.dout = dout;
  a.ns = ns;
  a.he = he;
  a.hf = hf;
  a.nw = nw;
  a.kdim = kdim;
  a.gs_n = gs_n;
  a.gs_coeff = gs_coeff;
  a.w1 = (const float*)w_in;
  a.beff = (const float*)beff;
  a.w2 = (const float*)w2;
  a.b2 = (const float*)b2;
  a.w2t = (const float*)w2t;
  a.wf1 = (const float*)wf1;
  a.bf1 = (const float*)bf1;
  a.wf2 = (const float*)wf2;
  a.bf2 = (const float*)bf2;
  a.wf1t = (const float*)wf1t;
  a.wf2t = (const float*)wf2t;
  a.ck = (const float*)ck;
  a.gs_off = (const float*)gs_off;
  a.w_meta = (const int4*)w_meta;
  a.in_off = (const int*)in_off;
  a.in_ent = (const int4*)in_ent;
  a.n_in = n_in;
  a.rows = (float*)rows;
  a.tgt_rows = (float*)tgt_rows;  // in list order
  a.src_rows = (float*)src_rows;
  a.src_at = (const int*)at_src;  // at the pair's source-major place
  const int bytes = dbfr::wide_smem_bytes(a);
  err = cudaFuncSetAttribute(knn_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  knn_wide_kernel<<<dbfr::imax(1, ld / dbfr::kWideTile), kThreads, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 3. the parameter gradients over the ld slot columns (zero at and
  // beyond the pair count)
  const int offs[4] = {o_win, o_w2, o_wf1, o_wf2};
  const int rc = dbfr::wide_contract((const float*)rows, ld, gs_n, he, ns, hf, nw, batch,
                                     (const int*)sample_off, offs, stride, (float*)part,
                                     max_splits, (float*)grads, st);
  if (rc != 0) return rc;

  // 4. the node sums
  knn_node_sum_kernel<<<grid(nodes, 8), 256, 0, st>>>(
      (const int*)tgt_off, (const int*)src_off, (const float*)tgt_rows, (const float*)src_rows,
      nodes, din, ns, (float*)d_x);
  return (int)cudaGetLastError();
}
