// B6: backward of the pocket-atom knn conv (B3, knn_conv.cu).
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_knn_bwd_t (the
// pallas_call at :1884, factory :1704). The target pass walks each atom's
// neighbour list as the forward does (target scalars, every parameter
// gradient); the gradient that flows back through the neighbour gather into
// the source features comes from a source pass over the reverse neighbour
// list (rev_off / rev_tgt / rev_src, built by the wrapper with a stable
// sort, so the order of the sums is fixed). Design and bound:
// trunk_conv_bwd.cuh.
#include "trunk_conv_bwd.cuh"

namespace {
__global__ void __launch_bounds__(dbfr::kThreads, 1) knn_bwd_kernel(dbfr::ConvArgs a) {
  dbfr::conv_bwd<dbfr::kKnn>(a);
}
__global__ void __launch_bounds__(dbfr::kThreads, 1) knn_bwd_rev_kernel(dbfr::ConvArgs a) {
  dbfr::conv_bwd<dbfr::kKnnRev>(a);
}
}  // namespace

extern "C" int dbfr_knn_bwd(
    const void* pos, const void* x, const void* idx, const void* valid,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* w2t, const void* wf1, const void* bf1, const void* wf2,
    const void* bf2, const void* wf1t, const void* wf2t, const void* ck,
    const void* gs_off, const void* w_meta, const void* in_meta,
    const void* rev_off, const void* rev_tgt, const void* rev_src,
    const void* gout, void* d_x, void* part, void* grads, int batch, int n,
    int k, int din, int dout, int ns, int he, int hf, int nw, int kdim,
    int gs_n, float gs_coeff, void* stream) {
  dbfr::ConvArgs a = {};
  a.tgt_pos = (const float*)pos;
  a.src_pos = (const float*)pos;
  a.tgt_x = (const float*)x;
  a.src_x = (const float*)x;
  a.knn_idx = (const int*)idx;
  a.knn_valid = (const float*)valid;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
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
  a.w_meta = (const int*)w_meta;
  a.in_meta = (const int*)in_meta;
  a.rev_off = (const int*)rev_off;
  a.rev_tgt = (const int*)rev_tgt;
  a.rev_src = (const int*)rev_src;
  a.gout = (const float*)gout;
  a.d_own = (float*)d_x;
  a.part = (float*)part;
  a.nt = n;
  a.nsrc = n;
  a.din = din;
  a.dout = dout;
  a.k = k;
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

  int rc = dbfr::launch_bwd<dbfr::kKnn>(knn_bwd_kernel, a, st);
  if (rc != 0) return rc;
  dbfr::ConvArgs s = a;
  s.own_src = 1;
  s.accumulate = 1;
  rc = dbfr::launch_bwd<dbfr::kKnnRev>(knn_bwd_rev_kernel, s, st);
  if (rc != 0) return rc;
  return dbfr::reduce_rows((const float*)part, a.part_stride, (float*)grads, st);
}
