// B4: backward of the dual ligand<->pocket cross conv (B1, cross_conv.cu).
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_cross_bwd_t (the
// pallas_call at :1600, factory :1368). Given the cotangents of both
// outputs (g_al [B, nl, dout], g_la [B, na, dout]) it returns d_lig,
// d_atm and, per direction, the gradients of the edge MLP (shared by al and
// la: the wrapper adds the two) and of that direction's TP-weight MLP.
// Four passes, each a trunk_conv_bwd.cuh pass over the same masked pairs:
//   al targets (ligand rows) -> ligand scalars + al parameters
//   la sources (ligand rows) -> ligand TP input + scalars (added)
//   la targets (atoms)       -> atom scalars + la parameters
//   al sources (atoms)       -> atom TP input + scalars (added)
// Passes on one stream run in order, so the added outputs are
// deterministic. Bound: fp32 FMA in the TP-weight MLPs (operations).
#include "trunk_conv_bwd.cuh"

namespace {
__global__ void __launch_bounds__(dbfr::kThreads, 1) cross_bwd_kernel(dbfr::ConvArgs a) {
  dbfr::conv_bwd<dbfr::kDense>(a);
}
}  // namespace

extern "C" int dbfr_cross_bwd(
    const void* lig_pos, const void* atm_pos, const void* lig_x, const void* atm_x,
    const void* lig_mask, const void* atm_mask, const void* cabflag,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w2t, const void* al_w1, const void* al_b1,
    const void* al_w2, const void* al_b2, const void* al_w1t, const void* al_w2t,
    const void* la_w1, const void* la_b1, const void* la_w2, const void* la_b2,
    const void* la_w1t, const void* la_w2t, const void* ck, const void* gs_off,
    const void* w_meta, const void* in_meta, const void* g_al, const void* g_la,
    void* d_lig, void* d_atm, void* part_al, void* part_la, void* grads_al,
    void* grads_la, int batch, int nl, int na, int din, int dout, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, void* stream) {
  dbfr::ConvArgs a = {};
  a.cab = (const float*)cabflag;
  a.cutoff = (const float*)cutoff;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.b2 = (const float*)b2;
  a.w2t = (const float*)w2t;
  a.ck = (const float*)ck;
  a.gs_off = (const float*)gs_off;
  a.w_meta = (const int*)w_meta;
  a.in_meta = (const int*)in_meta;
  a.din = din;
  a.dout = dout;
  a.ns = ns;
  a.he = he;
  a.hf = hf;
  a.nw = nw;
  a.kdim = kdim;
  a.gs_n = gs_n;
  a.gs_coeff = gs_coeff;
  a.batch = batch;
  dbfr::set_grad_layout(a);
  cudaStream_t st = (cudaStream_t)stream;

  // al: ligand rows are the targets, atoms the sources (vec = atom - ligand)
  dbfr::ConvArgs al = a;
  al.tgt_pos = (const float*)lig_pos;
  al.src_pos = (const float*)atm_pos;
  al.tgt_x = (const float*)lig_x;
  al.src_x = (const float*)atm_x;
  al.tgt_mask = (const float*)lig_mask;
  al.src_mask = (const float*)atm_mask;
  al.nt = nl;
  al.nsrc = na;
  al.wf1 = (const float*)al_w1;
  al.bf1 = (const float*)al_b1;
  al.wf2 = (const float*)al_w2;
  al.bf2 = (const float*)al_b2;
  al.wf1t = (const float*)al_w1t;
  al.wf2t = (const float*)al_w2t;
  al.gout = (const float*)g_al;
  al.part = (float*)part_al;

  // la: atoms are the targets, ligand rows the sources; flip keeps
  // vec = atom - ligand, so distances, masks and sh match the al pass
  dbfr::ConvArgs la = a;
  la.tgt_pos = (const float*)atm_pos;
  la.src_pos = (const float*)lig_pos;
  la.tgt_x = (const float*)atm_x;
  la.src_x = (const float*)lig_x;
  la.tgt_mask = (const float*)atm_mask;
  la.src_mask = (const float*)lig_mask;
  la.nt = na;
  la.nsrc = nl;
  la.cab_on_tgt = 1;
  la.flip = 1;
  la.wf1 = (const float*)la_w1;
  la.bf1 = (const float*)la_b1;
  la.wf2 = (const float*)la_w2;
  la.bf2 = (const float*)la_b2;
  la.wf1t = (const float*)la_w1t;
  la.wf2t = (const float*)la_w2t;
  la.gout = (const float*)g_la;
  la.part = (float*)part_la;

  const dbfr::ConvArgs passes[4] = {al, la, la, al};
  float* outs[4] = {(float*)d_lig, (float*)d_lig, (float*)d_atm, (float*)d_atm};
  for (int i = 0; i < 4; ++i) {
    dbfr::ConvArgs p = passes[i];
    p.own_src = i % 2;
    p.accumulate = i % 2;
    p.d_own = outs[i];
    const int rc = dbfr::launch_bwd<dbfr::kDense>(cross_bwd_kernel, p, st);
    if (rc != 0) return rc;
  }
  const int rc = dbfr::reduce_rows((const float*)part_al, a.part_stride, (float*)grads_al, st);
  if (rc != 0) return rc;
  return dbfr::reduce_rows((const float*)part_la, a.part_stride, (float*)grads_la, st);
}
