// B1: dual ligand<->pocket cross conv over the dense [nl, na] block.
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_cross_conv_t (the
// pallas_call at :693); contract of the XLA twin make_cross_twin
// (nn/pallas_conv.py:295-356). Mask: CA/CB atom or d <= 0.2 sigma_tr + 5,
// and both nodes valid. Outputs the masked message sums `al` [B, nl, dout]
// (atoms -> ligand rows, fc_al) and `la` [B, na, dout] (ligand -> atom
// columns, fc_la; same edge features and spherical harmonics).
// Blocks run in no order, so `la` gets its own launch with the atoms as
// targets, which recomputes the shared edge MLP (about 6% of the pair work)
// instead of reducing partial sums across blocks or using atomics: both
// outputs are deterministic.
// Bound on the H100: fp32 FMA in the two TP-weight MLPs (operations);
// masked pairs are skipped, so the work follows the cutoff, not nl x na.
//
// B7: dbfr_cross_conv_fin is the same conv with the finalize of
// diffbindfr_tpu/nn/pallas_conv.py:make_cross_conv(fin=) (the pallas_call at
// :1008) on both outputs: al / max(cnt_al, 1) and la / max(cnt_la, 1), each
// through its own irreps Linear and LayerNorm, as a per-block epilogue of
// each pass (conv_fin.cuh); the TPU kernel finalized the atom side on its
// last grid step, here the la pass's blocks own their atoms.
//
// B11-cross: dbfr_cross_conv_bf16 is B1 with the bf16 depthwise chain of
// make_cross_conv_t(dw_dtype='bfloat16') (trunk_conv.cuh conv_sums<., true>)
// in both passes: the ligand rows move rounded to bf16
// (pallas_conv_t.py:584-585), so their scalars enter both TP-weight MLPs
// rounded (the al pass's targets, the la pass's sources), the atom rows
// exact (:590-593); the la sums stay fp32 (:640-649).
#include "conv_fin.cuh"

namespace {
__global__ void __launch_bounds__(dbfr::kThreads, 2) cross_conv_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kDense>(a);
}

__global__ void __launch_bounds__(dbfr::kThreads, 2) cross_conv_fin_kernel(dbfr::ConvArgs a) {
  dbfr::conv_fin_block<dbfr::kDense>(a);
}

__global__ void __launch_bounds__(dbfr::kThreads, 2) cross_conv_bf16_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kDense, true>(a);
}

int launch_pass(const dbfr::ConvArgs& a, int batch, cudaStream_t st) {
  if (a.bf16_chain) return dbfr::launch<dbfr::kDense>(cross_conv_bf16_kernel, a, batch, st);
  return a.out_dim > 0 ? dbfr::launch<dbfr::kDense>(cross_conv_fin_kernel, a, batch, st)
                       : dbfr::launch<dbfr::kDense>(cross_conv_kernel, a, batch, st);
}

// the al pass (ligand rows are the targets, atoms the sources) and the la
// pass (atoms are the targets, ligand rows the sources), without finalize
void cross_passes(
    const void* lig_pos, const void* atm_pos, const void* lig_x, const void* atm_x,
    const void* lig_mask, const void* atm_mask, const void* cabflag,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* al_w1, const void* al_b1, const void* al_w2,
    const void* al_b2, const void* la_w1, const void* la_b1, const void* la_w2,
    const void* la_b2, const void* ck, const void* gs_off, const void* out_meta,
    void* out_al, void* out_la, int nl, int na, int din, int dout,
    int ns, int he, int hf, int nw, int kdim, int gs_n, float gs_coeff,
    dbfr::ConvArgs* al_out, dbfr::ConvArgs* la_out) {
  dbfr::ConvArgs a = {};
  a.cab = (const float*)cabflag;
  a.cutoff = (const float*)cutoff;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.b2 = (const float*)b2;
  a.ck = (const float*)ck;
  a.gs_off = (const float*)gs_off;
  a.out_meta = (const int*)out_meta;
  a.din = din;
  a.dout = dout;
  a.nb = 0;
  a.k = 0;
  a.ns = ns;
  a.he = he;
  a.hf = hf;
  a.nw = nw;
  a.kdim = kdim;
  a.gs_n = gs_n;
  a.gs_coeff = gs_coeff;
  a.exclude_self = 0;

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
  al.cab_on_tgt = 0;
  al.flip = 0;
  al.wf1 = (const float*)al_w1;
  al.bf1 = (const float*)al_b1;
  al.wf2 = (const float*)al_w2;
  al.bf2 = (const float*)al_b2;
  al.out = (float*)out_al;
  *al_out = al;

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
  la.out = (float*)out_la;
  *la_out = la;
}
}  // namespace

extern "C" int dbfr_cross_conv_fin(
    const void* lig_pos, const void* atm_pos, const void* lig_x, const void* atm_x,
    const void* lig_mask, const void* atm_mask, const void* cabflag,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* al_w1, const void* al_b1, const void* al_w2,
    const void* al_b2, const void* la_w1, const void* la_b1, const void* la_w2,
    const void* la_b2, const void* ck, const void* gs_off, const void* out_meta,
    void* out_al, void* out_la, int batch, int nl, int na, int din, int dout,
    int ns, int he, int hf, int nw, int kdim, int gs_n, float gs_coeff,
    const void* al_cnt, const void* al_mix, const void* al_ln_w, const void* al_ln_ms,
    const void* al_ln_b, const void* la_cnt, const void* la_mix, const void* la_ln_w,
    const void* la_ln_ms, const void* la_ln_b, const void* mix_meta, const void* ln_slots,
    int out_dim, int n_slots, int mix_numel, void* stream) {
  dbfr::ConvArgs al, la;
  cross_passes(lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cabflag, cutoff, w1, b1, w2,
               b2, al_w1, al_b1, al_w2, al_b2, la_w1, la_b1, la_w2, la_b2, ck, gs_off, out_meta,
               out_al, out_la, nl, na, din, dout, ns, he, hf, nw, kdim, gs_n, gs_coeff, &al, &la);
  cudaStream_t st = (cudaStream_t)stream;
  dbfr::set_fin(al, al_cnt, al_mix, al_ln_w, al_ln_ms, al_ln_b, mix_meta, ln_slots, out_dim,
                n_slots, mix_numel);
  int rc = launch_pass(al, batch, st);
  if (rc != 0) return rc;
  dbfr::set_fin(la, la_cnt, la_mix, la_ln_w, la_ln_ms, la_ln_b, mix_meta, ln_slots, out_dim,
                n_slots, mix_numel);
  return launch_pass(la, batch, st);
}

// B1: the sums alone (no finalize)
extern "C" int dbfr_cross_conv(
    const void* lig_pos, const void* atm_pos, const void* lig_x, const void* atm_x,
    const void* lig_mask, const void* atm_mask, const void* cabflag,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* al_w1, const void* al_b1, const void* al_w2,
    const void* al_b2, const void* la_w1, const void* la_b1, const void* la_w2,
    const void* la_b2, const void* ck, const void* gs_off, const void* out_meta,
    void* out_al, void* out_la, int batch, int nl, int na, int din, int dout,
    int ns, int he, int hf, int nw, int kdim, int gs_n, float gs_coeff,
    void* stream) {
  return dbfr_cross_conv_fin(lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cabflag, cutoff,
                             w1, b1, w2, b2, al_w1, al_b1, al_w2, al_b2, la_w1, la_b1, la_w2,
                             la_b2, ck, gs_off, out_meta, out_al, out_la, batch, nl, na, din,
                             dout, ns, he, hf, nw, kdim, gs_n, gs_coeff, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, 0, 0, 0, stream);
}

// B11-cross: both passes with the bf16 chain (the arguments of dbfr_cross_conv)
extern "C" int dbfr_cross_conv_bf16(
    const void* lig_pos, const void* atm_pos, const void* lig_x, const void* atm_x,
    const void* lig_mask, const void* atm_mask, const void* cabflag,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* al_w1, const void* al_b1, const void* al_w2,
    const void* al_b2, const void* la_w1, const void* la_b1, const void* la_w2,
    const void* la_b2, const void* ck, const void* gs_off, const void* out_meta,
    void* out_al, void* out_la, int batch, int nl, int na, int din, int dout,
    int ns, int he, int hf, int nw, int kdim, int gs_n, float gs_coeff,
    void* stream) {
  dbfr::ConvArgs al, la;
  cross_passes(lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cabflag, cutoff, w1, b1, w2,
               b2, al_w1, al_b1, al_w2, al_b2, la_w1, la_b1, la_w2, la_b2, ck, gs_off, out_meta,
               out_al, out_la, nl, na, din, dout, ns, he, hf, nw, kdim, gs_n, gs_coeff, &al, &la);
  cudaStream_t st = (cudaStream_t)stream;
  al.bf16_chain = la.bf16_chain = 1;
  al.bf_tgt_sc = 1;  // the ligand rows: targets of al, sources of la
  la.bf_src_sc = 1;
  int rc = launch_pass(al, batch, st);
  if (rc != 0) return rc;
  return launch_pass(la, batch, st);
}
