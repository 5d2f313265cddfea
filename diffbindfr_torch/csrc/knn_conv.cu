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
// make_knn_conv_t(dw_dtype='bfloat16'): the gathered neighbour rows and the
// target scalars move rounded to bf16 (pallas_conv_t.py:842, :848), so both
// scalar halves of the TP-weight MLP input are rounded. It runs a knn grid
// of its own: a 1-D grid of blocks, each owning g_k atoms of one sample
// (every sample's blocks in atom order), that compacts its atoms' valid
// neighbour slots in slot order and walks them in 64-pair tiles on
// conv_fwd_wide.cuh's chain with BF set (register-tiled MLPs over 16-row
// cp.async weight stages, the bf16 chain per output column), as B10's atom
// blocks run their knn conv (layer_conv.cu) but without the la pass and the
// finalize. Every atom's sum is its block's own, in list order: no atomics,
// two calls give the same bits. The host picks g_k from the shapes and the
// SM count (nn/trunk_convs.py knn_row_groups: tile fill against the wave
// tail) and reads nothing, so a CUDA graph captures the call. One block per
// SM (its tiles, weight stages and g_k rows of sums take most of the shared
// memory). With `cycles` set, thread 0 of each block writes the block's
// clock64() cycles there (grid order).
// Bound on the H100: fp32 FMA in the edge and TP-weight MLPs (operations).
#include "conv_fwd_wide.cuh"

namespace {
__global__ void __launch_bounds__(dbfr::kThreads, 2) knn_conv_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kKnn>(a);
}

__global__ void __launch_bounds__(dbfr::kThreads, 2) knn_conv_fin_kernel(dbfr::ConvArgs a) {
  dbfr::conv_fin_block<dbfr::kKnn>(a);
}

struct KnnArgs {
  dbfr::ConvArgs a;
  int n_blocks;  // per sample
  long long* cycles;
};

__global__ void __launch_bounds__(dbfr::kThreads, 1) knn_conv_bf16_wide_kernel(KnnArgs K) {
  using namespace dbfr;
  const long long c0 = clock64();
  const ConvArgs& a = K.a;
  const FwdRegions F = carve_fwd(fwd_plan(a, kKnn));
  const int b = blockIdx.x / K.n_blocks;
  const int t0 = (blockIdx.x % K.n_blocks) * a.g;
  wide_conv_sums<kKnn, true>(a, b, t0, F);  // ends after a barrier: acc complete
  for (int i = threadIdx.x; i < a.g * a.dout; i += kThreads) {
    const int t = t0 + i / a.dout;
    if (t < a.nt) a.out[((size_t)b * a.nt + t) * a.dout + (i % a.dout)] = F.R.acc[i];
  }
  if (K.cycles != nullptr && threadIdx.x == 0) K.cycles[blockIdx.x] = clock64() - c0;
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

// B11-knn: the sums with the bf16 chain (the arguments of dbfr_knn_conv,
// then g_k atoms per block and the per-block cycles or null)
extern "C" int dbfr_knn_conv_bf16(
    const void* pos, const void* x, const void* idx, const void* valid,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* wf1, const void* bf1, const void* wf2,
    const void* bf2, const void* ck, const void* gs_off, const void* out_meta,
    void* out, int batch, int n, int k, int din, int dout, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, int atom_rows, void* cycles,
    void* stream) {
  using namespace dbfr;
  KnnArgs K;
  K.a = knn_args(pos, x, idx, valid, cutoff, w1, b1, w2, b2, wf1, bf1, wf2, bf2, ck, gs_off,
                 out_meta, out, n, k, din, dout, ns, he, hf, nw, kdim, gs_n, gs_coeff);
  K.a.bf16_chain = 1;
  K.a.bf_tgt_sc = 1;
  K.a.bf_src_sc = 1;
  // atoms per block: the host's choice, checked against the shared memory
  K.a.g = atom_rows;
  if (atom_rows < 1 || n >= 1 << 16) return -1;
  K.n_blocks = (n + atom_rows - 1) / atom_rows;
  K.cycles = (long long*)cycles;
  const int bytes = fwd_plan(K.a, kKnn).words * 4;
  if (bytes > kSmemWords * 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(knn_conv_bf16_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)batch * K.n_blocks;
  if (blocks > 0)
    knn_conv_bf16_wide_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(K);
  return (int)cudaGetLastError();
}
