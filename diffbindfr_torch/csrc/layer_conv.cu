// B10: one whole score-net trunk layer in one launch. Replaces
// diffbindfr_tpu/nn/pallas_layer.py:make_layer_conv (the pallas_call at
// :552); contract of its twin (:581-686), batch axis B in place of the vmap:
//
//   lig_next = pad(lig_x) + fin_lig(pair sums) + fin_al(al sums)
//   atm_next = pad(atm_x) + fin_atom(knn sums) + fin_la(la sums)
//
// component-major f32 in and out, where fin = divide by max(count, 1) ->
// irreps Linear -> LayerNorm (conv_fin.cuh) and pad appends zero columns
// (the irreps ladder only appends slots).
//
// Two kinds of block, one grid, one shared-memory layout (the largest of
// the four convs' plans, conv_fwd_wide.cuh):
//  * ligand-row blocks own g_l ligand rows: the pair conv over every ligand
//    source (bond features, self excluded, cutoff or bonded), its finalize,
//    then the al direction over the atoms and its finalize;
//  * atom-row blocks own g_a atoms: the knn conv over their neighbour
//    slots, its finalize, then the la direction over the ligand rows
//    (flipped edges) and its finalize.
// Each conv runs conv_fwd_wide.cuh's chain: the block's valid pairs in
// candidate order, walked in 64-pair tiles whose MLPs are register-tiled
// products with 16-row cp.async weight stages, each pair's message added
// to its target's sum in list order. Each block holds its rows' complete
// sums, so every finalize and residual add is a per-block epilogue and the
// four update tensors never leave shared memory. The TPU kernel had to
// carry the atom-side sums across its sequential grid and finalize them on
// the last program, and gathered the knn neighbours by one-hot MXU
// products; neither is needed here.
// Rows per block (the host picks them, nn/layer_conv.py row_groups):
// g_l = 4 ligand rows fill a tile with the pair conv's ~14 pairs a row (the
// al pass has ~230 a row); g_a = 16 atoms fill ~3 tiles of knn pairs (~10 a
// row) and ~3 of la pairs, as many as the shared memory holds (one block per
// SM: the tile's rows, the weight stages and g_a rows of sums, mixed rows
// and statistics take 224 KB at flagship width). Ligand-row blocks come
// first in the grid: a ligand row has ~16x an atom's pairs, so the blocks
// that hold real ligand rows are the longest, and they start first.
// Bound on the H100: fp32 FMA in the four TP-weight MLPs (operations).
// With `cycles` set, thread 0 of each block writes the block's clock64()
// cycles there (in grid order), for the share of each kind of block.
//
// Arguments come as arrays indexed by the enums below, which
// diffbindfr_torch/nn/layer_conv.py (PTRS, INTS, FLOATS) mirrors name for name.
#include "conv_fwd_wide.cuh"

namespace {

enum LayerPtr {
  P_LIG_POS, P_ATM_POS, P_LIG_X, P_ATM_X, P_LIG_MASK, P_ATM_MASK, P_CAB, P_LIG_CUT,
  P_CROSS_CUT, P_BOND_FEAT, P_BOND_MASK, P_KNN_IDX, P_KNN_VALID, P_CK, P_OUT_META,
  P_GS_LIG, P_GS_CROSS, P_GS_ATOM, P_MIX_META, P_LN_SLOTS, P_OUT_LIG, P_OUT_ATM,
  P_EMB,                // edge MLPs lig, cross, atom: w_in, beff, w2, b2 each
  P_CONV = P_EMB + 12,  // convs lig, al, la, atom: w1, b1, w2, b2, cnt, mix, ln_w, ln_ms, ln_b
  P_CYCLES = P_CONV + 36,  // [grid] int64 or null
  P_COUNT
};
enum LayerInt {
  I_BATCH, I_NL, I_NA, I_K, I_DIN, I_DOUT, I_NB, I_NS, I_HE_LIG, I_HE_CROSS, I_HE_ATOM,
  I_HF, I_NW, I_KDIM, I_GS_N, I_OUT_DIM, I_N_SLOTS, I_MIX_NUMEL, I_LIG_ROWS, I_ATOM_ROWS, I_COUNT
};
enum LayerFloat { F_GS_LIG, F_GS_CROSS, F_GS_ATOM, F_COUNT };
enum Edge { E_LIG, E_CROSS, E_ATOM };
enum Conv { C_LIG, C_AL, C_LA, C_ATOM };

struct LayerArgs {
  dbfr::ConvArgs pair, al, knn, la;
  int batch, n_lig_blocks, n_atm_blocks;  // per sample
  long long* cycles;
};

__host__ __device__ inline dbfr::FwdPlan layer_plan(const LayerArgs& L) {
  using namespace dbfr;
  return max_fwd_plan(max_fwd_plan(fwd_plan(L.pair, kDense), fwd_plan(L.al, kDense)),
                      max_fwd_plan(fwd_plan(L.knn, kKnn), fwd_plan(L.la, kDense)));
}

// One 1-D grid: the ligand-row blocks of every sample, then the atom-row
// blocks of every sample, so the long ligand-row blocks start first.
__global__ void __launch_bounds__(dbfr::kThreads, 1) layer_conv_kernel(LayerArgs L) {
  using namespace dbfr;
  const long long c0 = clock64();
  const FwdRegions F = carve_fwd(layer_plan(L));
  const int lig_blocks = L.batch * L.n_lig_blocks;
  if ((int)blockIdx.x < lig_blocks) {
    const int b = blockIdx.x / L.n_lig_blocks;
    const int t0 = (blockIdx.x % L.n_lig_blocks) * L.pair.g;
    init_oacc(L.pair, b, t0, L.pair.tgt_x, F.R);
    wide_conv_sums<kDense>(L.pair, b, t0, F);
    fin_epilogue(L.pair, b, t0, F.R);
    wide_conv_sums<kDense>(L.al, b, t0, F);
    fin_epilogue(L.al, b, t0, F.R);
    store_oacc(L.pair, b, t0, L.pair.out, F.R);
  } else {
    const int i = blockIdx.x - lig_blocks;
    const int b = i / L.n_atm_blocks;
    const int t0 = (i % L.n_atm_blocks) * L.knn.g;
    init_oacc(L.knn, b, t0, L.knn.tgt_x, F.R);
    wide_conv_sums<kKnn>(L.knn, b, t0, F);
    fin_epilogue(L.knn, b, t0, F.R);
    wide_conv_sums<kDense>(L.la, b, t0, F);
    fin_epilogue(L.la, b, t0, F.R);
    store_oacc(L.knn, b, t0, L.knn.out, F.R);
  }
  if (L.cycles != nullptr && threadIdx.x == 0) L.cycles[blockIdx.x] = clock64() - c0;
}

const float* fp(const void* const* p, int i) { return (const float*)p[i]; }

// edge MLP e (Gaussian rows + folded time embedding) and TP-weight MLP c with
// its finalize, on top of the sizes every conv of the layer shares
dbfr::ConvArgs conv_args(const void* const* p, const int* n, const float* f, int e, int c) {
  dbfr::ConvArgs a = {};
  a.din = n[I_DIN];
  a.dout = n[I_DOUT];
  a.ns = n[I_NS];
  a.he = n[I_HE_LIG + e];
  a.hf = n[I_HF];
  a.nw = n[I_NW];
  a.kdim = n[I_KDIM];
  a.gs_n = n[I_GS_N];
  a.gs_coeff = f[F_GS_LIG + e];
  a.gs_off = fp(p, P_GS_LIG + e);
  a.ck = fp(p, P_CK);
  a.out_meta = (const int*)p[P_OUT_META];
  a.w1 = fp(p, P_EMB + 4 * e);
  a.b1 = fp(p, P_EMB + 4 * e + 1);
  a.w2 = fp(p, P_EMB + 4 * e + 2);
  a.b2 = fp(p, P_EMB + 4 * e + 3);
  const int q = P_CONV + 9 * c;
  a.wf1 = fp(p, q);
  a.bf1 = fp(p, q + 1);
  a.wf2 = fp(p, q + 2);
  a.bf2 = fp(p, q + 3);
  dbfr::set_fin(a, p[q + 4], p[q + 5], p[q + 6], p[q + 7], p[q + 8], p[P_MIX_META],
                p[P_LN_SLOTS], n[I_OUT_DIM], n[I_N_SLOTS], n[I_MIX_NUMEL]);
  return a;
}

}  // namespace

extern "C" int dbfr_layer_conv(const void* const* p, int n_ptrs, const int* n, int n_ints,
                               const float* f, int n_floats, void* stream) {
  using namespace dbfr;
  if (n_ptrs != P_COUNT || n_ints != I_COUNT || n_floats != F_COUNT) return -1;
  const int batch = n[I_BATCH], nl = n[I_NL], na = n[I_NA];
  LayerArgs L;
  // ligand <- ligand: bond features, self excluded, no CA/CB flag
  L.pair = conv_args(p, n, f, E_LIG, C_LIG);
  L.pair.tgt_pos = L.pair.src_pos = fp(p, P_LIG_POS);
  L.pair.tgt_x = L.pair.src_x = fp(p, P_LIG_X);
  L.pair.tgt_mask = L.pair.src_mask = fp(p, P_LIG_MASK);
  L.pair.cutoff = fp(p, P_LIG_CUT);
  L.pair.bond_feat = fp(p, P_BOND_FEAT);
  L.pair.bond_mask = fp(p, P_BOND_MASK);
  L.pair.nb = n[I_NB];
  L.pair.exclude_self = 1;
  L.pair.nt = L.pair.nsrc = nl;
  L.pair.out = (float*)p[P_OUT_LIG];
  // ligand <- atoms (al): vec = atom - ligand, CA/CB flag on the atoms
  L.al = conv_args(p, n, f, E_CROSS, C_AL);
  L.al.tgt_pos = fp(p, P_LIG_POS);
  L.al.src_pos = fp(p, P_ATM_POS);
  L.al.tgt_x = fp(p, P_LIG_X);
  L.al.src_x = fp(p, P_ATM_X);
  L.al.tgt_mask = fp(p, P_LIG_MASK);
  L.al.src_mask = fp(p, P_ATM_MASK);
  L.al.cab = fp(p, P_CAB);
  L.al.cutoff = fp(p, P_CROSS_CUT);
  L.al.nt = nl;
  L.al.nsrc = na;
  // atoms <- ligand (la): the same edges with the atoms as targets
  L.la = conv_args(p, n, f, E_CROSS, C_LA);
  L.la.tgt_pos = fp(p, P_ATM_POS);
  L.la.src_pos = fp(p, P_LIG_POS);
  L.la.tgt_x = fp(p, P_ATM_X);
  L.la.src_x = fp(p, P_LIG_X);
  L.la.tgt_mask = fp(p, P_ATM_MASK);
  L.la.src_mask = fp(p, P_LIG_MASK);
  L.la.cab = fp(p, P_CAB);
  L.la.cab_on_tgt = 1;
  L.la.flip = 1;
  L.la.cutoff = fp(p, P_CROSS_CUT);
  L.la.nt = na;
  L.la.nsrc = nl;
  // atoms <- atoms over the neighbour list
  L.knn = conv_args(p, n, f, E_ATOM, C_ATOM);
  L.knn.tgt_pos = L.knn.src_pos = fp(p, P_ATM_POS);
  L.knn.tgt_x = L.knn.src_x = fp(p, P_ATM_X);
  L.knn.knn_idx = (const int*)p[P_KNN_IDX];
  L.knn.knn_valid = fp(p, P_KNN_VALID);
  L.knn.k = n[I_K];
  L.knn.nt = L.knn.nsrc = na;
  L.knn.out = (float*)p[P_OUT_ATM];
  // rows per block: the host's choice, checked against the shared memory
  L.pair.g = L.al.g = n[I_LIG_ROWS];
  L.la.g = L.knn.g = n[I_ATOM_ROWS];
  if (L.pair.g < 1 || L.knn.g < 1 || nl >= 1 << 16 || na >= 1 << 16) return -1;
  L.batch = batch;
  L.n_lig_blocks = (nl + L.pair.g - 1) / L.pair.g;
  L.n_atm_blocks = (na + L.knn.g - 1) / L.knn.g;
  L.cycles = (long long*)p[P_CYCLES];
  const int bytes = layer_plan(L).words * 4;
  if (bytes > kSmemWords * 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(layer_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)batch * (L.n_lig_blocks + L.n_atm_blocks);
  if (blocks > 0)
    layer_conv_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}
