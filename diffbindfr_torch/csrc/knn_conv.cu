// B3: pocket-atom conv over the fixed neighbour list idx/valid [na, k]
// (knn_edges, 4 A). Replaces diffbindfr_tpu/nn/pallas_conv_t.py:
// make_knn_conv_t (the pallas_call at :935); contract of the XLA twin
// make_knn_twin (nn/pallas_conv.py:359-405): the sum runs over the valid
// neighbours. A block takes 4 targets (64 list slots), so a chunk of 32
// pairs is full even though each target has at most k = 16 neighbours.
// Bound on the H100: fp32 FMA in the TP-weight MLP (operations).
//
// B9: dbfr_knn_conv_fin is the same conv with the finalize of
// diffbindfr_tpu/nn/pallas_conv.py:make_knn_conv(fin=) (the pallas_call at
// :1225): sums / max(sum of valid, 1) -> irreps Linear -> LayerNorm, as a
// per-block epilogue (conv_fin.cuh); `cnt` is the valid count per target.
//
// B11-knn: dbfr_knn_conv_bf16 is B3 with the bf16 depthwise chain of
// make_knn_conv_t(dw_dtype='bfloat16') (trunk_conv.cuh conv_sums<., true>):
// the gathered neighbour rows and the target scalars move rounded to bf16
// (pallas_conv_t.py:842, :848), so both scalar halves of the TP-weight MLP
// input are rounded.
#include "conv_fin.cuh"

namespace {
__global__ void __launch_bounds__(dbfr::kThreads, 2) knn_conv_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kKnn>(a);
}

__global__ void __launch_bounds__(dbfr::kThreads, 2) knn_conv_fin_kernel(dbfr::ConvArgs a) {
  dbfr::conv_fin_block<dbfr::kKnn>(a);
}

__global__ void __launch_bounds__(dbfr::kThreads, 2) knn_conv_bf16_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kKnn, true>(a);
}

dbfr::ConvArgs knn_args(
    const void* pos, const void* x, const void* idx, const void* valid,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* wf1, const void* bf1, const void* wf2,
    const void* bf2, const void* ck, const void* gs_off, const void* out_meta,
    void* out, int n, int k, int din, int dout, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff) {
  dbfr::ConvArgs a = {};
  a.tgt_pos = (const float*)pos;
  a.src_pos = (const float*)pos;
  a.tgt_x = (const float*)x;
  a.src_x = (const float*)x;
  a.knn_idx = (const int*)idx;
  a.knn_valid = (const float*)valid;
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
  a.nt = n;
  a.nsrc = n;
  a.din = din;
  a.dout = dout;
  a.nb = 0;
  a.k = k;
  a.ns = ns;
  a.he = he;
  a.hf = hf;
  a.nw = nw;
  a.kdim = kdim;
  a.gs_n = gs_n;
  a.gs_coeff = gs_coeff;
  return a;
}
}  // namespace

extern "C" int dbfr_knn_conv_fin(
    const void* pos, const void* x, const void* idx, const void* valid,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* wf1, const void* bf1, const void* wf2,
    const void* bf2, const void* ck, const void* gs_off, const void* out_meta,
    void* out, int batch, int n, int k, int din, int dout, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, const void* cnt,
    const void* mix_w, const void* ln_w, const void* ln_ms, const void* ln_b,
    const void* mix_meta, const void* ln_slots, int out_dim, int n_slots, int mix_numel,
    void* stream) {
  dbfr::ConvArgs a = knn_args(pos, x, idx, valid, cutoff, w1, b1, w2, b2, wf1, bf1, wf2, bf2,
                              ck, gs_off, out_meta, out, n, k, din, dout, ns, he, hf, nw, kdim,
                              gs_n, gs_coeff);
  dbfr::set_fin(a, cnt, mix_w, ln_w, ln_ms, ln_b, mix_meta, ln_slots, out_dim, n_slots,
                mix_numel);
  return out_dim > 0
             ? dbfr::launch<dbfr::kKnn>(knn_conv_fin_kernel, a, batch, (cudaStream_t)stream)
             : dbfr::launch<dbfr::kKnn>(knn_conv_kernel, a, batch, (cudaStream_t)stream);
}

// B3: the sums alone (no finalize)
extern "C" int dbfr_knn_conv(
    const void* pos, const void* x, const void* idx, const void* valid,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* wf1, const void* bf1, const void* wf2,
    const void* bf2, const void* ck, const void* gs_off, const void* out_meta,
    void* out, int batch, int n, int k, int din, int dout, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, void* stream) {
  return dbfr_knn_conv_fin(pos, x, idx, valid, cutoff, w1, b1, w2, b2, wf1, bf1, wf2, bf2, ck,
                           gs_off, out_meta, out, batch, n, k, din, dout, ns, he, hf, nw, kdim,
                           gs_n, gs_coeff, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, 0, 0, 0, stream);
}

// B11-knn: the sums with the bf16 chain (the arguments of dbfr_knn_conv)
extern "C" int dbfr_knn_conv_bf16(
    const void* pos, const void* x, const void* idx, const void* valid,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* wf1, const void* bf1, const void* wf2,
    const void* bf2, const void* ck, const void* gs_off, const void* out_meta,
    void* out, int batch, int n, int k, int din, int dout, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, void* stream) {
  dbfr::ConvArgs a = knn_args(pos, x, idx, valid, cutoff, w1, b1, w2, b2, wf1, bf1, wf2, bf2,
                              ck, gs_off, out_meta, out, n, k, din, dout, ns, he, hf, nw, kdim,
                              gs_n, gs_coeff);
  a.bf16_chain = 1;
  a.bf_tgt_sc = 1;
  a.bf_src_sc = 1;
  return dbfr::launch<dbfr::kKnn>(knn_conv_bf16_kernel, a, batch, (cudaStream_t)stream);
}
