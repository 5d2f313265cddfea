// B2: ligand-ligand pair conv over the dense [nl, nl] block.
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_pair_conv_t (the
// pallas_call at :433); contract of the XLA twin make_pair_twin
// (nn/pallas_conv.py:227-292): component-major f32 features in, masked
// message SUM out, batch axis B in place of the vmap.
// Mask: (d <= cutoff and not self) or bonded, and both nodes valid.
// Bound on the H100: fp32 FMA in the per-pair MLPs (operations); the design
// skips masked pairs entirely and keeps every per-pair tensor on chip.
// B2 runs trunk_conv.cuh's 32-pair body, one ligand row per block.
//
// B11-pair: dbfr_pair_conv_bf16 is B2 with the bf16 depthwise chain of
// make_pair_conv_t(dw_dtype='bfloat16') (trunk_conv.cuh conv_sums<., true>):
// the target scalars enter the TP-weight MLP rounded to bf16
// (pallas_conv_t.py:328), the source scalars exact (:332).
//
// B8: dbfr_pair_conv_fin is the same conv with the finalize of
// diffbindfr_tpu/nn/pallas_conv.py:make_pair_conv(fin=) (the pallas_call at
// :653): sums / max(cnt, 1) -> irreps Linear -> LayerNorm; out is [B, nt,
// out_dim]. It runs on the forward wide tiles (conv_fwd_wide.cuh
// wide_rows<kDense, true>, as B7 and B9 do): a 1-D grid of blocks, each
// owning g_p ligand rows of one sample (every sample's blocks in row
// order), that compacts its rows' valid sources in source order, walks them
// in 64-pair tiles (the edge input [Gaussian | bond features];
// register-tiled MLPs over 16-row cp.async weight stages; the TP's source
// rows staged in shared memory) and adds each pair's message to its row's
// sum in list order, then finalizes its rows with their output rows and
// LayerNorm statistics in the weight stages, free after the sums
// (fin_after_sums). Every row's sum is its block's own: no atomics, two
// calls give the same bits. The host picks g_p from the batch, the shapes
// and the SM count (nn/trunk_convs.py pair_row_groups: at the 3dbs bucket
// a real ligand row has ~13 pairs, so ~5 rows fill a tile) and reads
// nothing, so a CUDA graph captures the call. One block per SM (its tiles,
// weight stages and g_p rows of sums take most of the shared memory). With
// `cycles` set, thread 0 of each block writes the block's clock64() cycles
// there (grid order).
// Bound on the H100: fp32 FMA in the edge and TP-weight MLPs (operations).
// B8's arguments come as arrays indexed by the enums below, which
// diffbindfr_torch/nn/trunk_convs.py (PAIR_PTRS, PAIR_INTS) mirrors name for
// name.
#include "conv_fwd_wide.cuh"

namespace {

enum PairPtr {
  P_TGT_POS, P_SRC_POS, P_TGT_X, P_SRC_X, P_TGT_MASK, P_SRC_MASK, P_CAB, P_CUT, P_BOND_FEAT,
  P_BOND_MASK, P_W_IN, P_BEFF, P_W2, P_B2, P_WF1, P_BF1, P_WF2, P_BF2, P_CK, P_GS_OFF,
  P_OUT_META, P_OUT,
  P_FIN,  // the finalize: cnt, mix, ln_w, ln_ms, ln_b
  P_MIX_META = P_FIN + 5, P_LN_SLOTS, P_CYCLES, P_COUNT
};
enum PairInt {
  I_BATCH, I_NT, I_NSRC, I_DIN, I_DOUT, I_NB, I_NS, I_HE, I_HF, I_NW, I_KDIM, I_GS_N,
  I_OUT_DIM, I_N_SLOTS, I_MIX_NUMEL, I_LIG_ROWS, I_COUNT
};
enum PairFloat { F_GS_COEFF, F_COUNT };

__global__ void __launch_bounds__(dbfr::kThreads, 2) pair_conv_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kDense>(a);
}

__global__ void __launch_bounds__(dbfr::kThreads, 2) pair_conv_bf16_kernel(dbfr::ConvArgs a) {
  dbfr::conv_block<dbfr::kDense, true>(a);
}

struct PairArgs {
  dbfr::ConvArgs a;
  int n_blocks;  // per sample
  long long* cycles;
};

// the conv's plan, its finalize's output rows and statistics moved into the
// weight stages
__host__ __device__ inline dbfr::FwdPlan pair_plan(const dbfr::ConvArgs& a) {
  return dbfr::fin_after_sums(dbfr::fwd_plan(a, dbfr::kDense), a);
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) pair_conv_fin_wide_kernel(PairArgs P) {
  using namespace dbfr;
  const long long c0 = clock64();
  const FwdRegions F = carve_fwd(pair_plan(P.a));
  wide_rows<kDense, true>(P.a, blockIdx.x / P.n_blocks, (blockIdx.x % P.n_blocks) * P.a.g, F);
  if (P.cycles != nullptr && threadIdx.x == 0) P.cycles[blockIdx.x] = clock64() - c0;
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

// B2: the sums alone
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
  const dbfr::ConvArgs a = pair_args(tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab,
                                     cab_on_tgt, cutoff, bond_feat, bond_mask, w1, b1, w2, b2,
                                     wf1, bf1, wf2, bf2, ck, gs_off, out_meta, out, nt, nsrc, din,
                                     dout, nb, ns, he, hf, nw, kdim, gs_n, gs_coeff, flip,
                                     exclude_self);
  return dbfr::launch<dbfr::kDense>(pair_conv_kernel, a, batch, (cudaStream_t)stream);
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

// B8: the sums, finalized; the score net's configuration (cab on the source
// side, self pairs excluded, no flip). g_p = n[I_LIG_ROWS] ligand rows per
// block, the host's choice, checked against the shared memory: an error,
// and no launch, where the plan does not fit.
extern "C" int dbfr_pair_conv_fin(const void* const* p, int n_ptrs, const int* n, int n_ints,
                                  const float* f, int n_floats, void* stream) {
  using namespace dbfr;
  if (n_ptrs != P_COUNT || n_ints != I_COUNT || n_floats != F_COUNT) return -1;
  const int batch = n[I_BATCH], nt = n[I_NT], nsrc = n[I_NSRC], g = n[I_LIG_ROWS];
  if (n[I_OUT_DIM] < 1 || g < 1 || nt >= 1 << 16 || nsrc >= 1 << 16) return -1;
  PairArgs P;
  P.a = pair_args(p[P_TGT_POS], p[P_SRC_POS], p[P_TGT_X], p[P_SRC_X], p[P_TGT_MASK],
                  p[P_SRC_MASK], p[P_CAB], 0, p[P_CUT], p[P_BOND_FEAT], p[P_BOND_MASK],
                  p[P_W_IN], p[P_BEFF], p[P_W2], p[P_B2], p[P_WF1], p[P_BF1], p[P_WF2],
                  p[P_BF2], p[P_CK], p[P_GS_OFF], p[P_OUT_META], (void*)p[P_OUT], nt, nsrc,
                  n[I_DIN], n[I_DOUT], n[I_NB], n[I_NS], n[I_HE], n[I_HF], n[I_NW], n[I_KDIM],
                  n[I_GS_N], f[F_GS_COEFF], 0, 1);
  set_fin(P.a, p[P_FIN], p[P_FIN + 1], p[P_FIN + 2], p[P_FIN + 3], p[P_FIN + 4], p[P_MIX_META],
          p[P_LN_SLOTS], n[I_OUT_DIM], n[I_N_SLOTS], n[I_MIX_NUMEL]);
  P.a.g = g;
  P.n_blocks = (nt + g - 1) / g;
  P.cycles = (long long*)p[P_CYCLES];
  const int bytes = pair_plan(P.a).words * 4;
  if (bytes > kSmemWords * 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pair_conv_fin_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)batch * P.n_blocks;
  if (blocks > 0)
    pair_conv_fin_wide_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
