// B5: backward of the ligand-ligand pair conv (B2, pair_conv.cu).
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_pair_bwd_t (the
// pallas_call at :1258, factory :1035). Returns d_tgt (the target scalars'
// gradient through the TP-weight MLP input: the first ns columns), d_src
// (TP input and source scalars) and, reduced over the blocks, the gradients
// of the edge MLP (W1 rows [Gaussian | bond], the per-sample folded bias),
// of W2/b2 and of the TP-weight MLP. Design, bound and determinism:
// trunk_conv_bwd.cuh.
#include "trunk_conv_bwd.cuh"

namespace {
__global__ void __launch_bounds__(dbfr::kThreads, 1) pair_bwd_kernel(dbfr::ConvArgs a) {
  dbfr::conv_bwd<dbfr::kDense>(a);
}
}  // namespace

extern "C" int dbfr_pair_bwd(
    const void* tgt_pos, const void* src_pos, const void* tgt_x, const void* src_x,
    const void* tgt_mask, const void* src_mask, const void* cab, int cab_on_tgt,
    const void* cutoff, const void* bond_feat, const void* bond_mask,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wf1, const void* bf1, const void* wf2, const void* bf2,
    const void* w2t, const void* wf1t, const void* wf2t,
    const void* ck, const void* gs_off, const void* w_meta, const void* in_meta,
    const void* gout, void* d_tgt, void* d_src, void* part, void* grads,
    int batch, int nt, int nsrc, int din, int dout, int nb, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, int flip,
    int exclude_self, void* stream) {
  dbfr::ConvArgs a = {};
  a.tgt_pos = (const float*)tgt_pos;
  a.src_pos = (const float*)src_pos;
  a.tgt_x = (const float*)tgt_x;
  a.src_x = (const float*)src_x;
  a.tgt_mask = (const float*)tgt_mask;
  a.src_mask = (const float*)src_mask;
  a.cab = (const float*)cab;
  a.bond_feat = (const float*)bond_feat;
  a.bond_mask = (const float*)bond_mask;
  a.cutoff = (const float*)cutoff;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.b2 = (const float*)b2;
  a.wf1 = (const float*)wf1;
  a.bf1 = (const float*)bf1;
  a.wf2 = (const float*)wf2;
  a.bf2 = (const float*)bf2;
  a.w2t = (const float*)w2t;
  a.wf1t = (const float*)wf1t;
  a.wf2t = (const float*)wf2t;
  a.ck = (const float*)ck;
  a.gs_off = (const float*)gs_off;
  a.w_meta = (const int*)w_meta;
  a.in_meta = (const int*)in_meta;
  a.gout = (const float*)gout;
  a.part = (float*)part;
  a.nt = nt;
  a.nsrc = nsrc;
  a.din = din;
  a.dout = dout;
  a.nb = nb;
  a.ns = ns;
  a.he = he;
  a.hf = hf;
  a.nw = nw;
  a.kdim = kdim;
  a.gs_n = gs_n;
  a.gs_coeff = gs_coeff;
  a.flip = flip;
  a.cab_on_tgt = cab_on_tgt;
  a.exclude_self = exclude_self;
  a.batch = batch;
  dbfr::set_grad_layout(a);
  cudaStream_t st = (cudaStream_t)stream;

  // target pass: target scalars and every parameter gradient
  dbfr::ConvArgs t = a;
  t.d_own = (float*)d_tgt;
  int rc = dbfr::launch_bwd<dbfr::kDense>(pair_bwd_kernel, t, st);
  if (rc != 0) return rc;
  // source pass: the sources' features
  dbfr::ConvArgs s = a;
  s.own_src = 1;
  s.d_own = (float*)d_src;
  rc = dbfr::launch_bwd<dbfr::kDense>(pair_bwd_kernel, s, st);
  if (rc != 0) return rc;
  return dbfr::reduce_rows((const float*)part, a.part_stride, (float*)grads, st);
}
