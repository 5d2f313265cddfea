// B4: backward of the dual ligand<->pocket cross conv (B1, cross_conv.cu).
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_cross_bwd_t (the
// pallas_call at :1600, factory :1368). Given the cotangents of both
// outputs (g_al [B, nl, dout], g_la [B, na, dout]) it returns d_lig, d_atm
// and, per direction, the gradients of the edge MLP (each direction's own
// share: the wrapper adds the two) and of that direction's TP-weight MLP.
//
// The valid (ligand, atom) pairs are the same in both directions, so one
// list serves both:
//  1. dbfr_cross_pairs: per ligand row, the rank of each valid atom among
//     the row's valid atoms (the forward's mask decision, dense_valid, in
//     candidate order) and the row's count; per atom, its count; exclusive
//     prefix sums of both (one block each, in order: no atomics). The
//     wrapper reads the total P (the one host read of a call) and sizes the
//     scratch;
//  2. dbfr_cross_bwd: the list in ligand-major order (al's target order),
//     with per-sample offsets and each pair's place in atom-major order (a
//     counting sort, ligand order kept within an atom); then per direction the
//     wide-tile pair pass (conv_bwd_wide.cuh) and one grouped launch of the
//     split-K contraction (abt_gemm.cuh) that turns its feature-major rows
//     into dW1 + db1_eff [B rows, per-sample segments of the list], dW2 +
//     db2, dWf1 + dbf1 and dWf2 + dbf2, written in _grad_layout order. The
//     passes write each pair's atom-side rows at its atom-major place, so
//     last the per-node sums run over contiguous segments for both sides,
//     each in list order.
// Every sum runs in a fixed order: two calls give the same bits.
// Bound: fp32 FMA in the TP-weight MLPs (operations), as before; the
// contractions add ~25% of the pass's operations at large tile reuse.
#include "conv_bwd_wide.cuh"

namespace {

using dbfr::kThreads;

// ligand row (blockIdx.x, sample blockIdx.y): pid[b][l][a] = rank of atom a
// among the row's valid atoms, or -1; cnt[b][l] = their number
__global__ void __launch_bounds__(kThreads) cross_pairs_count_kernel(dbfr::ConvArgs al, int* pid,
                                                                     int* cnt) {
  __shared__ int wcnt[kThreads / 32];
  const int l = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* row = pid + ((size_t)b * al.nt + l) * al.nsrc;
  const bool lig_ok = al.tgt_mask[(size_t)b * al.nt + l] > 0.f;
  const float cut = al.cutoff[b];
  int total = 0;
  for (int c0 = 0; c0 < al.nsrc; c0 += kThreads) {
    const int s = c0 + tid;
    const bool ok = s < al.nsrc && lig_ok && dbfr::dense_valid(al, b, l, s, cut);
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = total, all = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) off += wcnt[w];
      all += wcnt[w];
    }
    if (s < al.nsrc) row[s] = ok ? off + __popc(bal & ((1u << lane) - 1u)) : -1;
    total += all;
    __syncthreads();
  }
  if (tid == 0) cnt[(size_t)b * al.nt + l] = total;
}

// cnt[b][a] = valid pairs of atom a of sample b
__global__ void cross_atom_count_kernel(const int* __restrict__ pid, int batch, int nl, int na,
                                        int* __restrict__ cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * na) return;
  const int b = i / na, a = i % na;
  int c = 0;
  for (int l = 0; l < nl; ++l) c += pid[((size_t)b * nl + l) * na + a] >= 0;
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

// the pair list: pair g = lig_off[b][l] + pid[b][l][a] holds (l, a, b); its
// place in atom-major order, at_atom[g] = atm_off[b][a] + j for the j-th
// pair of atom a in list order (a counting sort); sample_off[b] = the first
// pair of sample b (sample_off[B] = P)
__global__ void cross_pairs_fill_kernel(const int* __restrict__ pid, const int* __restrict__ lig_off,
                                        const int* __restrict__ atm_off, int batch, int nl, int na,
                                        int* __restrict__ pair_l, int* __restrict__ pair_a,
                                        int* __restrict__ pair_b, int* __restrict__ at_atom,
                                        int* __restrict__ sample_off) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * na) return;
  const int b = i / na, a = i % na;
  if (a == 0) sample_off[b] = lig_off[(size_t)b * nl];
  if (i == 0) sample_off[batch] = lig_off[(size_t)batch * nl];
  int j = atm_off[i];
  for (int l = 0; l < nl; ++l) {
    const int r = pid[((size_t)b * nl + l) * na + a];
    if (r < 0) continue;
    const int g = lig_off[(size_t)b * nl + l] + r;
    pair_l[g] = l;
    pair_a[g] = a;
    pair_b[g] = b;
    at_atom[g] = j++;
  }
}

__global__ void __launch_bounds__(kThreads, 1) cross_wide_kernel(dbfr::WideArgs a) {
  dbfr::wide_pass(a);
}

// out[node][c] = sum over the node's rows q = off[node] .. off[node + 1] - 1
// (in order) of src_rows[q][c] + (c < ns ? tgt_rows[q][c] : 0). W warps per
// node (W divides 8): warp w sums rows off[node] + w, + w + W, ... with each
// lane holding its columns c = lane + 32 i and the loads of kSegU rows in
// flight together; then the W partial sums are added in warp order. Fixed
// order: deterministic.
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
        const float* sr = src_rows + (size_t)min(r, q1 - 1) * din;
        const float* tr = tgt_rows + (size_t)min(r, q1 - 1) * ns;
#pragma unroll
        for (int i = 0; i < kSegC; ++i) {
          const int c = lane + 32 * i;
          const float x = sr[min(c, din - 1)], t = tr[min(c, ns - 1)];
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

}  // namespace

// Step 1: ranks and counts of the valid pairs, their prefix sums
extern "C" int dbfr_cross_pairs(const void* lig_pos, const void* atm_pos, const void* lig_mask,
                                const void* atm_mask, const void* cabflag, const void* cutoff,
                                void* pid, void* cnt_l, void* lig_off, void* cnt_a, void* atm_off,
                                int batch, int nl, int na, void* stream) {
  if (batch <= 0 || nl <= 0 || na <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // al: ligand rows are the targets, atoms the sources (vec = atom - ligand);
  // the la direction's mask decisions are the same (flip negates vec exactly)
  dbfr::ConvArgs al = {};
  al.tgt_pos = (const float*)lig_pos;
  al.src_pos = (const float*)atm_pos;
  al.tgt_mask = (const float*)lig_mask;
  al.src_mask = (const float*)atm_mask;
  al.cab = (const float*)cabflag;
  al.cutoff = (const float*)cutoff;
  al.nt = nl;
  al.nsrc = na;
  cross_pairs_count_kernel<<<dim3(nl, batch), kThreads, 0, st>>>(al, (int*)pid, (int*)cnt_l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exclusive_scan_kernel<<<1, 1024, 0, st>>>((const int*)cnt_l, batch * nl, (int*)lig_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cross_atom_count_kernel<<<grid((long)batch * na, 256), 256, 0, st>>>((const int*)pid, batch, nl,
                                                                       na, (int*)cnt_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exclusive_scan_kernel<<<1, 1024, 0, st>>>((const int*)cnt_a, batch * na, (int*)atm_off);
  return (int)cudaGetLastError();
}

// Steps 2-3. P pairs, scratch rows ld = P rounded up to kWideTile apart;
// grads_al / grads_la in the layout of trunk_convs._grad_layout (offsets
// o_win, o_w2, o_wf1, o_wf2, row length stride); part [max_splits, stride].
extern "C" int dbfr_cross_bwd(
    const void* lig_pos, const void* atm_pos, const void* lig_x, const void* atm_x,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* w2t,
    const void* al_w1, const void* al_b1, const void* al_w2, const void* al_b2,
    const void* al_w1t, const void* al_w2t, const void* la_w1, const void* la_b1,
    const void* la_w2, const void* la_b2, const void* la_w1t, const void* la_w2t,
    const void* ck, const void* gs_off, const void* w_meta, const void* in_off,
    const void* in_ent, const void* g_al, const void* g_la, const void* pid,
    const void* lig_off, const void* atm_off, void* pair_l, void* pair_a, void* pair_b,
    void* at_atom, void* sample_off, void* rows, void* al_tgt, void* al_src, void* la_tgt,
    void* la_src, void* part, void* grads_al, void* grads_la, void* d_lig, void* d_atm,
    int batch, int nl, int na, int din, int dout, int ns, int he, int hf, int nw, int kdim,
    int gs_n, int n_in, int P, int ld, int o_win, int o_w2, int o_wf1, int o_wf2, int stride,
    int max_splits, float gs_coeff, void* stream) {
  if (batch <= 0 || P < 0 || ld < P || ld % dbfr::kWideTile) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nodes_a = batch * na;
  cross_pairs_fill_kernel<<<grid(nodes_a, 256), 256, 0, st>>>(
      (const int*)pid, (const int*)lig_off, (const int*)atm_off, batch, nl, na, (int*)pair_l,
      (int*)pair_a, (int*)pair_b, (int*)at_atom, (int*)sample_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dbfr::WideArgs a = {};
  a.pair_b = (const int*)pair_b;
  a.P = P;
  a.ld = ld;
  a.din = din;
  a.dout = dout;
  a.ns = ns;
  a.he = he;
  a.hf = hf;
  a.nw = nw;
  a.kdim = kdim;
  a.gs_n = gs_n;
  a.gs_coeff = gs_coeff;
  a.w1 = (const float*)w1;
  a.beff = (const float*)b1;
  a.w2 = (const float*)w2;
  a.b2 = (const float*)b2;
  a.w2t = (const float*)w2t;
  a.ck = (const float*)ck;
  a.gs_off = (const float*)gs_off;
  a.w_meta = (const int4*)w_meta;
  a.in_off = (const int*)in_off;
  a.in_ent = (const int4*)in_ent;
  a.n_in = n_in;
  a.rows = (float*)rows;

  // al: ligand rows are the targets, atoms the sources
  dbfr::WideArgs al = a;
  al.pair_t = (const int*)pair_l;
  al.pair_s = (const int*)pair_a;
  al.tgt_pos = (const float*)lig_pos;
  al.src_pos = (const float*)atm_pos;
  al.tgt_x = (const float*)lig_x;
  al.src_x = (const float*)atm_x;
  al.nt = nl;
  al.nsrc = na;
  al.gout = (const float*)g_al;
  al.wf1 = (const float*)al_w1;
  al.bf1 = (const float*)al_b1;
  al.wf2 = (const float*)al_w2;
  al.bf2 = (const float*)al_b2;
  al.wf1t = (const float*)al_w1t;
  al.wf2t = (const float*)al_w2t;
  al.tgt_rows = (float*)al_tgt;
  al.src_rows = (float*)al_src;
  al.src_at = (const int*)at_atom;  // atom-side rows in atom-major order
  // la: atoms are the targets, ligand rows the sources; flip keeps
  // vec = atom - ligand, so distances and sh match the al pass
  dbfr::WideArgs la = al;
  la.pair_t = (const int*)pair_a;
  la.pair_s = (const int*)pair_l;
  la.tgt_pos = (const float*)atm_pos;
  la.src_pos = (const float*)lig_pos;
  la.flip = 1;
  la.tgt_x = (const float*)atm_x;
  la.src_x = (const float*)lig_x;
  la.nt = na;
  la.nsrc = nl;
  la.gout = (const float*)g_la;
  la.wf1 = (const float*)la_w1;
  la.bf1 = (const float*)la_b1;
  la.wf2 = (const float*)la_w2;
  la.bf2 = (const float*)la_b2;
  la.wf1t = (const float*)la_w1t;
  la.wf2t = (const float*)la_w2t;
  la.tgt_rows = (float*)la_tgt;
  la.src_rows = (float*)la_src;
  la.src_at = nullptr;
  la.tgt_at = (const int*)at_atom;

  const int bytes = dbfr::wide_smem_bytes(a);
  err = cudaFuncSetAttribute(cross_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dbfr::WideRows R = dbfr::wide_rows(gs_n, he, ns, hf, nw);
  float* rw = (float*)rows;
  const dbfr::WideArgs* dirs[2] = {&al, &la};
  float* grads[2] = {(float*)grads_al, (float*)grads_la};
  for (int d = 0; d < 2; ++d) {
    // the pair pass (one block when there is no pair: it returns at once)
    cross_wide_kernel<<<dbfr::imax(1, ld / dbfr::kWideTile), kThreads, bytes, st>>>(*dirs[d]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // the parameter gradients: a . b^T over the ld pair columns (zero
    // beyond P), bias rows generated (db1_eff per sample segment)
    dbfr::AbtGroup g = {};
    g.n = 4;
    g.K = ld;
    g.stride = stride;
    g.part = (float*)part;
    const int ab[4][2] = {{R.in, R.dh1}, {R.h1, R.dea}, {R.e, R.dh}, {R.h, R.dw}};
    const int mn[4][2] = {{gs_n, he}, {he, ns}, {3 * ns, hf}, {hf, nw}};
    const int offs[4] = {o_win, o_w2, o_wf1, o_wf2};
    for (int i = 0; i < 4; ++i) {
      g.p[i].a = rw + (size_t)ab[i][0] * ld;
      g.p[i].b = rw + (size_t)ab[i][1] * ld;
      g.p[i].M = mn[i][0];
      g.p[i].N = mn[i][1];
      g.p[i].lda = ld;
      g.p[i].ldb = ld;
      g.p[i].n_seg = i == 0 ? batch : 1;
      g.p[i].seg = i == 0 ? (const int*)sample_off : nullptr;
      g.p[i].out_off = offs[i];
    }
    const int rc = dbfr::abt_launch(g, max_splits, grads[d], st);
    if (rc != 0) return rc;
  }
  // the per-node sums: d_lig = al's target rows + la's source rows over the
  // ligand rows' segments of the list; d_atm = al's source rows + la's target
  // rows, which the passes wrote in atom-major order, over the atoms' segments
  if (din > 32 * kSegC) return (int)cudaErrorInvalidValue;
  const int nodes_l = batch * nl;
  segment_sum_kernel<8><<<nodes_l, 256, 0, st>>>((const int*)lig_off, (const float*)la_src,
                                                 (const float*)al_tgt, nodes_l, din, ns,
                                                 (float*)d_lig);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_sum_kernel<2><<<grid(nodes_a, 4), 256, 0, st>>>((const int*)atm_off, (const float*)al_src,
                                                          (const float*)la_tgt, nodes_a, din, ns,
                                                          (float*)d_atm);
  return (int)cudaGetLastError();
}
