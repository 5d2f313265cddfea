// B2: ligand-ligand pair conv over the dense [nl, nl] block.
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_pair_conv_t (the
// pallas_call at :433); contract of the XLA twin make_pair_twin
// (nn/pallas_conv.py:227-292): component-major f32 features in, masked
// message SUM out, batch axis B in place of the vmap.
// Mask: (d <= cutoff and not self) or bonded, and both nodes valid.
// Bound on the H100: fp32 FMA in the per-pair MLPs (operations); the design
// skips masked pairs entirely and keeps every per-pair tensor on chip.
//
// B8: dbfr_pair_conv_fin is the same conv with the finalize of
// diffbindfr_tpu/nn/pallas_conv.py:make_pair_conv(fin=) (the pallas_call at
// :653): sums / max(cnt, 1) -> irreps Linear -> LayerNorm, as a per-block
// epilogue of the same block loop (conv_fin.cuh); out is [B, nt, out_dim].
//
// B11-pair: dbfr_pair_conv_bf16 is B2 with the bf16 depthwise chain of
// make_pair_conv_t(dw_dtype='bfloat16') (trunk_conv.cuh conv_sums<., true>):
// the target scalars enter the TP-weight MLP rounded to bf16
// (pallas_conv_t.py:328), the source scalars exact (:332).
#include "conv_fin.cuh"

namespace {
__global__ void __launch_bounds__(dbfr::kThreads, 2) pair_conv_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kDense>(a);
}

__global__ void __launch_bounds__(dbfr::kThreads, 2) pair_conv_fin_kernel(dbfr::ConvArgs a) {
  dbfr::conv_fin_block<dbfr::kDense>(a);
}

__global__ void __launch_bounds__(dbfr::kThreads, 2) pair_conv_bf16_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kDense, true>(a);
}

dbfr::ConvArgs pair_args(
    const void* tgt_pos, const void* src_pos, const void* tgt_x, const void* src_x,
    const void* tgt_mask, const void* src_mask, const void* cab, int cab_on_tgt,
    const void* cutoff, const void* bond_feat, const void* bond_mask,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wf1, const void* bf1, const void* wf2, const void* bf2,
    const void* ck, const void* gs_off, const void* out_meta, void* out,
    int nt, int nsrc, int din, int dout, int nb, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, int flip, int exclude_self) {
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
  return a;
}
}  // namespace

extern "C" int dbfr_pair_conv_fin(
    const void* tgt_pos, const void* src_pos, const void* tgt_x, const void* src_x,
    const void* tgt_mask, const void* src_mask, const void* cab, int cab_on_tgt,
    const void* cutoff, const void* bond_feat, const void* bond_mask,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wf1, const void* bf1, const void* wf2, const void* bf2,
    const void* ck, const void* gs_off, const void* out_meta, void* out,
    int batch, int nt, int nsrc, int din, int dout, int nb, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, int flip,
    int exclude_self, const void* cnt, const void* mix_w, const void* ln_w,
    const void* ln_ms, const void* ln_b, const void* mix_meta, const void* ln_slots,
    int out_dim, int n_slots, int mix_numel, void* stream) {
  dbfr::ConvArgs a = pair_args(tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab,
                               cab_on_tgt, cutoff, bond_feat, bond_mask, w1, b1, w2, b2, wf1,
                               bf1, wf2, bf2, ck, gs_off, out_meta, out, nt, nsrc, din, dout,
                               nb, ns, he, hf, nw, kdim, gs_n, gs_coeff, flip, exclude_self);
  dbfr::set_fin(a, cnt, mix_w, ln_w, ln_ms, ln_b, mix_meta, ln_slots, out_dim, n_slots,
                mix_numel);
  return out_dim > 0
             ? dbfr::launch<dbfr::kDense>(pair_conv_fin_kernel, a, batch, (cudaStream_t)stream)
             : dbfr::launch<dbfr::kDense>(pair_conv_kernel, a, batch, (cudaStream_t)stream);
}

// B2: the sums alone (no finalize)
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
  return dbfr_pair_conv_fin(tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab, cab_on_tgt,
                            cutoff, bond_feat, bond_mask, w1, b1, w2, b2, wf1, bf1, wf2, bf2,
                            ck, gs_off, out_meta, out, batch, nt, nsrc, din, dout, nb, ns, he,
                            hf, nw, kdim, gs_n, gs_coeff, flip, exclude_self, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, stream);
}

// B11-pair: the sums with the bf16 chain (the arguments of dbfr_pair_conv)
extern "C" int dbfr_pair_conv_bf16(
    const void* tgt_pos, const void* src_pos, const void* tgt_x, const void* src_x,
    const void* tgt_mask, const void* src_mask, const void* cab, int cab_on_tgt,
    const void* cutoff, const void* bond_feat, const void* bond_mask,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wf1, const void* bf1, const void* wf2, const void* bf2,
    const void* ck, const void* gs_off, const void* out_meta, void* out,
    int batch, int nt, int nsrc, int din, int dout, int nb, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, int flip,
    int exclude_self, void* stream) {
  dbfr::ConvArgs a = pair_args(tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab,
                               cab_on_tgt, cutoff, bond_feat, bond_mask, w1, b1, w2, b2, wf1,
                               bf1, wf2, bf2, ck, gs_off, out_meta, out, nt, nsrc, din, dout,
                               nb, ns, he, hf, nw, kdim, gs_n, gs_coeff, flip, exclude_self);
  a.bf16_chain = 1;
  a.bf_tgt_sc = 1;
  return dbfr::launch<dbfr::kDense>(pair_conv_bf16_kernel, a, batch, (cudaStream_t)stream);
}
