// B2: ligand-ligand pair conv over the dense [nl, nl] block.
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_pair_conv_t (the
// pallas_call at :433); contract of the XLA twin make_pair_twin
// (nn/pallas_conv.py:227-292): component-major f32 features in, masked
// message SUM out, batch axis B in place of the vmap.
// Mask: (d <= cutoff and not self) or bonded, and both nodes valid.
// Bound on the H100: fp32 FMA in the per-pair MLPs (operations); the design
// skips masked pairs entirely and keeps every per-pair tensor on chip.
#include "trunk_conv.cuh"

namespace {
__global__ void __launch_bounds__(dbfr::kThreads, 2) pair_conv_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kDense>(a);
}
}  // namespace

extern "C" int dbfr_pair_conv(
    const void* tgt_pos, const void* src_pos, const void* tgt_x, const void* src_x,
    const void* tgt_mask, const void* src_mask, const void* cab, int cab_on_tgt,
    const void* cutoff, const void* bond_feat, const void* bond_mask,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wf1, const void* bf1, const void* wf2, const void* bf2,
    const void* ck, const void* gs_off, const void* out_meta, void* out,
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
  a.ck = (const float*)ck;
  a.gs_off = (const float*)gs_off;
  a.out_meta = (const int*)out_meta;
  a.out = (float*)out;
  a.nt = nt;
  a.nsrc = nsrc;
  a.din = din;
  a.dout = dout;
  a.nb = nb;
  a.k = 0;
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
  return dbfr::launch<dbfr::kDense>(pair_conv_kernel, a, batch, (cudaStream_t)stream);
}
