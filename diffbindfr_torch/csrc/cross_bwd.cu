// B4: backward of the dual ligand<->pocket cross conv (B1, cross_conv.cu).
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_cross_bwd_t (the
// pallas_call at :1600, factory :1368). Given the cotangents of both
// outputs (g_al [B, nl, dout], g_la [B, na, dout]) it returns d_lig, d_atm
// and, per direction, the gradients of the edge MLP (each direction's own
// share: the wrapper adds the two) and of that direction's TP-weight MLP.
//
// The valid (ligand, atom) pairs are the same in both directions, so one
// list serves both:
//  1. dbfr_cross_pairs: the counts and prefix sums of the valid pairs
//     (dense_pairs.cuh dense_pairs_count, al's targets: the ligand rows).
//     The wrapper reads the total P (the one host read of a call) and sizes
//     the scratch;
//  2. dbfr_cross_bwd: the list in ligand-major order (al's target order),
//     with per-sample offsets and each pair's place in atom-major order
//     (dense_pairs_fill: a counting sort, ligand order kept within an atom);
//     then per direction the wide-tile pair pass (conv_bwd_wide.cuh) and
//     one grouped launch of the split-K contraction (abt_gemm.cuh) that
//     turns its feature-major rows into dW1 + db1_eff [B rows, per-sample
//     segments of the list], dW2 + db2, dWf1 + dbf1 and dWf2 + dbf2,
//     written in _grad_layout order. The passes write each pair's atom-side
//     rows at its atom-major place, so last the per-node sums
//     (dense_pairs.cuh segment_sum_kernel) run over contiguous segments for
//     both sides, each in list order.
// Every sum runs in a fixed order: two calls give the same bits.
// Bound: fp32 FMA in the TP-weight MLPs (operations), as before; the
// contractions add ~25% of the pass's operations at large tile reuse.
#include "conv_bwd_wide.cuh"
#include "dense_pairs.cuh"

namespace {

using dbfr::kThreads;

__global__ void __launch_bounds__(kThreads, 1) cross_wide_kernel(dbfr::WideArgs a) {
  dbfr::wide_pass(a);
}

}  // namespace

// Step 1: ranks and counts of the valid pairs, their prefix sums
extern "C" int dbfr_cross_pairs(const void* lig_pos, const void* atm_pos, const void* lig_mask,
                                const void* atm_mask, const void* cabflag, const void* cutoff,
                                void* pid, void* cnt_l, void* lig_off, void* cnt_a, void* atm_off,
                                int batch, int nl, int na, void* stream) {
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
  return dbfr::dense_pairs_count(al, batch, (int*)pid, (int*)cnt_l, (int*)lig_off, (int*)cnt_a,
                                 (int*)atm_off, (cudaStream_t)stream);
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
  int rc = dbfr::dense_pairs_fill((const int*)pid, (const int*)lig_off, (const int*)atm_off, batch,
                                  nl, na, (int*)pair_l, (int*)pair_a, (int*)pair_b,
                                  (int*)at_atom, (int*)sample_off, st);
  if (rc != 0) return rc;

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
  cudaError_t err =
      cudaFuncSetAttribute(cross_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int offs[4] = {o_win, o_w2, o_wf1, o_wf2};
  const dbfr::WideArgs* dirs[2] = {&al, &la};
  float* grads[2] = {(float*)grads_al, (float*)grads_la};
  for (int d = 0; d < 2; ++d) {
    // the pair pass (one block when there is no pair: it returns at once)
    cross_wide_kernel<<<dbfr::imax(1, ld / dbfr::kWideTile), kThreads, bytes, st>>>(*dirs[d]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // the parameter gradients
    rc = dbfr::wide_contract((const float*)rows, ld, gs_n, he, ns, hf, nw, batch,
                             (const int*)sample_off, offs, stride, (float*)part, max_splits,
                             grads[d], st);
    if (rc != 0) return rc;
  }
  // the per-node sums: d_lig = al's target rows + la's source rows over the
  // ligand rows' segments of the list; d_atm = al's source rows + la's target
  // rows, which the passes wrote in atom-major order, over the atoms' segments
  if (din > 32 * dbfr::kSegC) return (int)cudaErrorInvalidValue;
  const int nodes_l = batch * nl;
  dbfr::segment_sum_kernel<8><<<nodes_l, 256, 0, st>>>((const int*)lig_off, (const float*)la_src,
                                                       (const float*)al_tgt, nodes_l, din, ns,
                                                       (float*)d_lig);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dbfr::segment_sum_kernel<2><<<dbfr::grid(nodes_a, 4), 256, 0, st>>>(
      (const int*)atm_off, (const float*)al_src, (const float*)la_tgt, nodes_a, din, ns,
      (float*)d_atm);
  return (int)cudaGetLastError();
}
