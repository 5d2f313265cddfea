// B5: backward of the ligand-ligand pair conv (B2, pair_conv.cu).
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_pair_bwd_t (the
// pallas_call at :1258, factory :1035). Given the cotangent g [B, nt, dout]
// of the conv's message sums it returns d_tgt (the target scalars' gradient
// through the TP-weight MLP input: the first ns columns of [B, nt, din]),
// d_src (the sources' TP input and scalars, [B, nsrc, din]) and the
// gradients of the edge MLP (W1 rows [Gaussian | bond], the per-sample
// folded bias, W2, b2) and of the TP-weight MLP (Wf1, bf1, Wf2, bf2), in
// the layout of trunk_convs._grad_layout.
//
// The design is B4's (cross_bwd.cu) for one direction, with the bond rows:
//  1. dbfr_pair_pairs (started by the autograd forward): the counts and
//     prefix sums of the valid (target, source) pairs, the forward's mask
//     decision (dense_pairs.cuh: cutoff or cab, self pairs excluded, or
//     bonded; both nodes valid). The wrapper reads the total P to the host
//     and sizes the scratch by it (not by the nt x nsrc slots: at the 3dbs
//     bucket, B = 4, 1,832 pairs against 65,536 slots);
//  2. dbfr_pair_bwd: the list in target-major order with each pair's place
//     in source-major order (dense_pairs_fill); one wide-tile pass over it
//     (conv_bwd_wide.cuh wide_pass, flip 0, the edge input [Gaussian |
//     bond features]) writing the feature-major rows that the parameter
//     gradients contract, each pair's target-scalar row (de[ns:2ns]) in
//     list order and its source row (the TP-input gradient plus
//     de[2ns:3ns]) at its source-major place; one grouped launch of the
//     split-K contraction (abt_gemm.cuh): dW1 + db1_eff (indicator rows per
//     sample segment), dW2 + db2, dWf1 + dbf1, dWf2 + dbf2; then the node
//     sums (segment_sum_kernel): d_tgt over the targets' segments of the
//     list, d_src over the sources' segments of the source-major order,
//     each in list order.
// Every sum runs in a fixed order, no atomics: two calls give the same bits.
// Bound on the H100: fp32 FMA in the TP-weight MLP (operations: the
// recompute and both products of every MLP's backward, ~3x the forward's).
// At the 3dbs bucket the list is short (~460 pairs a sample: 29 tiles at B
// = 4, 115 at B = 16), so the pass fills under one wave of the card's SMs
// and takes about one tile's latency; the list, the contraction and the
// node sums add their own launches' latencies.
#include "conv_bwd_wide.cuh"
#include "dense_pairs.cuh"

namespace {

__global__ void __launch_bounds__(dbfr::kThreads, 1) pair_wide_kernel(dbfr::WideArgs a) {
  dbfr::wide_pass(a);
}

}  // namespace

// Step 1: ranks and counts of the valid pairs, their prefix sums. cab is on
// the source side; self pairs are excluded; bond_mask [B, nt, nsrc].
extern "C" int dbfr_pair_pairs(const void* tgt_pos, const void* src_pos, const void* tgt_mask,
                               const void* src_mask, const void* cab, const void* cutoff,
                               const void* bond_mask, void* pid, void* cnt_t, void* tgt_off,
                               void* cnt_s, void* src_off, int batch, int nt, int nsrc,
                               void* stream) {
  dbfr::ConvArgs a = {};
  a.tgt_pos = (const float*)tgt_pos;
  a.src_pos = (const float*)src_pos;
  a.tgt_mask = (const float*)tgt_mask;
  a.src_mask = (const float*)src_mask;
  a.cab = (const float*)cab;
  a.cutoff = (const float*)cutoff;
  a.bond_mask = (const float*)bond_mask;
  a.exclude_self = 1;
  a.nt = nt;
  a.nsrc = nsrc;
  return dbfr::dense_pairs_count(a, batch, (int*)pid, (int*)cnt_t, (int*)tgt_off, (int*)cnt_s,
                                 (int*)src_off, (cudaStream_t)stream);
}

// Step 2. P pairs, scratch rows ld = P rounded up to kWideTile apart; grads
// in the layout of trunk_convs._grad_layout (offsets o_win, o_w2, o_wf1,
// o_wf2, row length stride); part [max_splits, stride].
extern "C" int dbfr_pair_bwd(
    const void* tgt_pos, const void* src_pos, const void* tgt_x, const void* src_x,
    const void* bond_feat, const void* w_in, const void* beff, const void* w2, const void* b2,
    const void* w2t, const void* wf1, const void* bf1, const void* wf2, const void* bf2,
    const void* wf1t, const void* wf2t, const void* ck, const void* gs_off, const void* w_meta,
    const void* in_off, const void* in_ent, const void* gout, const void* pid,
    const void* tgt_off, const void* src_off, void* pair_t, void* pair_s, void* pair_b,
    void* at_src, void* sample_off, void* rows, void* tgt_rows, void* src_rows, void* part,
    void* grads, void* d_tgt, void* d_src, int batch, int nt, int nsrc, int din, int dout,
    int nb, int ns, int he, int hf, int nw, int kdim, int gs_n, int n_in, int P, int ld,
    int o_win, int o_w2, int o_wf1, int o_wf2, int stride, int max_splits, float gs_coeff,
    void* stream) {
  if (batch <= 0 || P < 0 || ld < P || ld % dbfr::kWideTile || din > 32 * dbfr::kSegC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = dbfr::dense_pairs_fill((const int*)pid, (const int*)tgt_off, (const int*)src_off, batch,
                                  nt, nsrc, (int*)pair_t, (int*)pair_s, (int*)pair_b,
                                  (int*)at_src, (int*)sample_off, st);
  if (rc != 0) return rc;

  // the pair pass: targets and sources in list order, the edge input
  // [Gaussian | bond features]
  dbfr::WideArgs a = {};
  a.pair_t = (const int*)pair_t;
  a.pair_s = (const int*)pair_s;
  a.pair_b = (const int*)pair_b;
  a.P = P;
  a.ld = ld;
  a.tgt_pos = (const float*)tgt_pos;
  a.src_pos = (const float*)src_pos;
  a.tgt_x = (const float*)tgt_x;
  a.src_x = (const float*)src_x;
  a.gout = (const float*)gout;
  a.nt = nt;
  a.nsrc = nsrc;
  a.din = din;
  a.dout = dout;
  a.ns = ns;
  a.he = he;
  a.hf = hf;
  a.nw = nw;
  a.kdim = kdim;
  a.gs_n = gs_n;
  a.gs_coeff = gs_coeff;
  a.bond_feat = (const float*)bond_feat;
  a.nb = nb;
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
  cudaError_t err =
      cudaFuncSetAttribute(pair_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (ld > 0) {
    pair_wide_kernel<<<ld / dbfr::kWideTile, dbfr::kThreads, bytes, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // the parameter gradients over the ld pair columns (zero beyond P)
  const int offs[4] = {o_win, o_w2, o_wf1, o_wf2};
  rc = dbfr::wide_contract((const float*)rows, ld, gs_n + nb, he, ns, hf, nw, batch,
                           (const int*)sample_off, offs, stride, (float*)part, max_splits,
                           (float*)grads, st);
  if (rc != 0) return rc;

  // the node sums: d_tgt over the targets' segments of the list (the scalar
  // rows, zero beyond ns), d_src over the sources' segments of the
  // source-major order in which the pass wrote their rows
  const int nodes_t = batch * nt, nodes_s = batch * nsrc;
  dbfr::segment_sum_kernel<2><<<dbfr::grid(nodes_t, 4), 256, 0, st>>>(
      (const int*)tgt_off, nullptr, (const float*)tgt_rows, nodes_t, din, ns, (float*)d_tgt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dbfr::segment_sum_kernel<2><<<dbfr::grid(nodes_s, 4), 256, 0, st>>>(
      (const int*)src_off, (const float*)src_rows, nullptr, nodes_s, din, ns, (float*)d_src);
  return (int)cudaGetLastError();
}
