// B1: dual ligand<->pocket cross conv over the dense [nl, na] block.
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_cross_conv_t (the
// pallas_call at :693); contract of the XLA twin make_cross_twin
// (nn/pallas_conv.py:295-356). Mask: CA/CB atom or d <= 0.2 sigma_tr + 5,
// and both nodes valid. Outputs the masked message sums `al` [B, nl, dout]
// (atoms -> ligand rows, fc_al) and `la` [B, na, dout] (ligand -> atom
// columns, fc_la; same edge features and spherical harmonics, vec = atom -
// ligand in both).
//
// B7: dbfr_cross_conv_fin is the same conv with the finalize of
// diffbindfr_tpu/nn/pallas_conv.py:make_cross_conv(fin=) (the pallas_call at
// :1008) on both outputs: al / max(cnt_al, 1) and la / max(cnt_la, 1), each
// through its own irreps Linear and LayerNorm (conv_fin.cuh), as a per-block
// epilogue; the TPU kernel finalized the atom side on its last grid step,
// here the blocks that own the atoms hold their complete sums.
//
// One launch, one 1-D grid, two kinds of block (csrc/conv_fwd_wide.cuh's
// chain in each, as B10 runs it):
//  * al blocks own g_l ligand rows of one sample and walk their valid atoms;
//  * la blocks own g_a atoms and walk their valid ligand rows.
// A block compacts its candidates in candidate order, runs them in 64-pair
// tiles (register-tiled MLPs over 16-row cp.async weight stages, the TP's
// source rows staged in shared memory) and sums each pair's message into
// its target in list order: every sum is the block's own, in one fixed
// order, with no atomics, so two calls give the same bits. The la direction
// recomputes the edge MLP and geometry the al direction computed (~6% of
// the pair work) rather than reduce partial sums across blocks.
// At the 3dbs bucket a real ligand row has ~230 cross pairs (~3.6 tiles)
// and an atom ~9, so the al blocks that hold real rows are the grid's
// longest: they come first (every sample's al blocks, then the la blocks),
// and the la blocks fill the SMs behind them. The host picks g_l from the
// batch so that one al block stays within the mean tiles per SM, and g_a as
// large as the shared memory holds, so that la tiles fill
// (nn/trunk_convs.py cross_row_groups says why).
// Shared memory: the larger of the two directions' plans, region by region
// (fwd_plan). B7 finalizes once, after the sums, so its output rows and
// LayerNorm statistics take the weight-stage region, free by then, and the
// la blocks hold as many atoms as B1's.
// Bound on the H100: fp32 FMA in the two TP-weight MLPs (operations); masked
// pairs are skipped, so the work follows the cutoff, not nl x na.
// With `cycles` set, thread 0 of each block writes the block's clock64()
// cycles there (grid order), for the share of each kind of block.
//
// B11-cross: dbfr_cross_conv_bf16 is B1 with the bf16 depthwise chain of
// make_cross_conv_t(dw_dtype='bfloat16'): the same one-launch grid (al
// blocks, then la blocks) on conv_fwd_wide.cuh's chain with BF set. The
// ligand rows move rounded to bf16 (pallas_conv_t.py:584-585), so their
// scalars enter both TP-weight MLPs rounded (al blocks: the targets; la
// blocks: the sources), the atom scalars exact (:590-593); the la sums stay
// fp32 (:640-649). Its half-size w and cb tiles leave room for more atoms
// per la block than B1 holds (the BF plan, fwd_plan).
//
// B1's, B7's and B11-cross's arguments come as arrays indexed by the enums
// below, which diffbindfr_torch/nn/trunk_convs.py (CROSS_PTRS, CROSS_INTS)
// mirrors name for name.
#include "conv_fwd_wide.cuh"

namespace {

enum CrossPtr {
  P_LIG_POS, P_ATM_POS, P_LIG_X, P_ATM_X, P_LIG_MASK, P_ATM_MASK, P_CAB, P_CUT,
  P_W_IN, P_BEFF, P_W2, P_B2, P_AL_W1, P_AL_B1, P_AL_W2, P_AL_B2, P_LA_W1, P_LA_B1,
  P_LA_W2, P_LA_B2, P_CK, P_GS_OFF, P_OUT_META, P_OUT_AL, P_OUT_LA,
  P_AL_FIN,               // al finalize: cnt, mix, ln_w, ln_ms, ln_b (B7)
  P_LA_FIN = P_AL_FIN + 5,  // la finalize, the same five (B7)
  P_MIX_META = P_LA_FIN + 5, P_LN_SLOTS, P_CYCLES, P_COUNT
};
enum CrossInt {
  I_BATCH, I_NL, I_NA, I_DIN, I_DOUT, I_NS, I_HE, I_HF, I_NW, I_KDIM, I_GS_N, I_OUT_DIM,
  I_N_SLOTS, I_MIX_NUMEL, I_LIG_ROWS, I_ATOM_ROWS, I_COUNT
};
enum CrossFloat { F_GS_COEFF, F_COUNT };

struct CrossArgs {
  dbfr::ConvArgs al, la;
  int batch, n_al_blocks, n_la_blocks;  // per sample
  long long* cycles;
};

// the two directions' plans, region by region the larger; with a finalize,
// its output rows and statistics moved into the weight stages
__host__ __device__ inline dbfr::FwdPlan cross_plan(const CrossArgs& C) {
  using namespace dbfr;
  return fin_after_sums(max_fwd_plan(fwd_plan(C.al, kDense), fwd_plan(C.la, kDense)), C.al);
}

// One 1-D grid: the al blocks of every sample, then the la blocks.
template <bool FIN, bool BF = false>
__device__ __forceinline__ void cross_block(const CrossArgs& C) {
  using namespace dbfr;
  const long long c0 = clock64();
  const FwdRegions F = carve_fwd(cross_plan(C));
  const int al_blocks = C.batch * C.n_al_blocks;
  if ((int)blockIdx.x < al_blocks) {
    const int b = blockIdx.x / C.n_al_blocks;
    wide_rows<kDense, FIN, BF>(C.al, b, (blockIdx.x % C.n_al_blocks) * C.al.g, F);
  } else {
    const int i = blockIdx.x - al_blocks;
    wide_rows<kDense, FIN, BF>(C.la, i / C.n_la_blocks, (i % C.n_la_blocks) * C.la.g, F);
  }
  if (C.cycles != nullptr && threadIdx.x == 0) C.cycles[blockIdx.x] = clock64() - c0;
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) cross_conv_wide_kernel(CrossArgs C) {
  cross_block<false>(C);
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) cross_conv_fin_wide_kernel(CrossArgs C) {
  cross_block<true>(C);
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) cross_conv_bf16_wide_kernel(CrossArgs C) {
  cross_block<false, true>(C);
}

const float* fp(const void* const* p, int i) { return (const float*)p[i]; }

// the al direction (ligand rows are the targets, atoms the sources) and the
// la direction (atoms are the targets, ligand rows the sources), without
// finalize, from the argument arrays
void cross_directions(const void* const* p, const int* n, const float* f, CrossArgs* C) {
  dbfr::ConvArgs a = {};
  a.cab = fp(p, P_CAB);
  a.cutoff = fp(p, P_CUT);
  a.w1 = fp(p, P_W_IN);
  a.b1 = fp(p, P_BEFF);
  a.w2 = fp(p, P_W2);
  a.b2 = fp(p, P_B2);
  a.ck = fp(p, P_CK);
  a.gs_off = fp(p, P_GS_OFF);
  a.out_meta = (const int*)p[P_OUT_META];
  a.din = n[I_DIN];
  a.dout = n[I_DOUT];
  a.ns = n[I_NS];
  a.he = n[I_HE];
  a.hf = n[I_HF];
  a.nw = n[I_NW];
  a.kdim = n[I_KDIM];
  a.gs_n = n[I_GS_N];
  a.gs_coeff = f[F_GS_COEFF];

  // al: ligand rows are the targets, atoms the sources (vec = atom - ligand)
  dbfr::ConvArgs& al = C->al;
  al = a;
  al.tgt_pos = fp(p, P_LIG_POS);
  al.src_pos = fp(p, P_ATM_POS);
  al.tgt_x = fp(p, P_LIG_X);
  al.src_x = fp(p, P_ATM_X);
  al.tgt_mask = fp(p, P_LIG_MASK);
  al.src_mask = fp(p, P_ATM_MASK);
  al.nt = n[I_NL];
  al.nsrc = n[I_NA];
  al.wf1 = fp(p, P_AL_W1);
  al.bf1 = fp(p, P_AL_B1);
  al.wf2 = fp(p, P_AL_W2);
  al.bf2 = fp(p, P_AL_B2);
  al.out = (float*)p[P_OUT_AL];

  // la: atoms are the targets, ligand rows the sources; flip keeps
  // vec = atom - ligand, so distances, masks and sh match the al direction
  dbfr::ConvArgs& la = C->la;
  la = a;
  la.tgt_pos = fp(p, P_ATM_POS);
  la.src_pos = fp(p, P_LIG_POS);
  la.tgt_x = fp(p, P_ATM_X);
  la.src_x = fp(p, P_LIG_X);
  la.tgt_mask = fp(p, P_ATM_MASK);
  la.src_mask = fp(p, P_LIG_MASK);
  la.nt = n[I_NA];
  la.nsrc = n[I_NL];
  la.cab_on_tgt = 1;
  la.flip = 1;
  la.wf1 = fp(p, P_LA_W1);
  la.bf1 = fp(p, P_LA_B1);
  la.wf2 = fp(p, P_LA_W2);
  la.bf2 = fp(p, P_LA_B2);
  la.out = (float*)p[P_OUT_LA];
}

// B1 (neither flag), B7 (fin) or B11-cross (bf16): one launch of the
// wide-tile grid
int launch_wide(const void* const* p, int n_ptrs, const int* n, int n_ints, const float* f,
                int n_floats, void* stream, bool fin, bool bf16) {
  using namespace dbfr;
  if (n_ptrs != P_COUNT || n_ints != I_COUNT || n_floats != F_COUNT) return -1;
  const int batch = n[I_BATCH], nl = n[I_NL], na = n[I_NA];
  CrossArgs C;
  cross_directions(p, n, f, &C);
  if (bf16) {
    if (fin) return -1;
    C.al.bf16_chain = C.la.bf16_chain = 1;
    C.al.bf_tgt_sc = 1;  // the ligand rows: targets of al, sources of la
    C.la.bf_src_sc = 1;
  }
  if (fin) {
    if (n[I_OUT_DIM] < 1) return -1;
    set_fin(C.al, p[P_AL_FIN], p[P_AL_FIN + 1], p[P_AL_FIN + 2], p[P_AL_FIN + 3],
            p[P_AL_FIN + 4], p[P_MIX_META], p[P_LN_SLOTS], n[I_OUT_DIM], n[I_N_SLOTS],
            n[I_MIX_NUMEL]);
    set_fin(C.la, p[P_LA_FIN], p[P_LA_FIN + 1], p[P_LA_FIN + 2], p[P_LA_FIN + 3],
            p[P_LA_FIN + 4], p[P_MIX_META], p[P_LN_SLOTS], n[I_OUT_DIM], n[I_N_SLOTS],
            n[I_MIX_NUMEL]);
  }
  // rows per block: the host's choice, checked against the shared memory
  C.al.g = n[I_LIG_ROWS];
  C.la.g = n[I_ATOM_ROWS];
  if (C.al.g < 1 || C.la.g < 1 || nl >= 1 << 16 || na >= 1 << 16) return -1;
  C.batch = batch;
  C.n_al_blocks = (nl + C.al.g - 1) / C.al.g;
  C.n_la_blocks = (na + C.la.g - 1) / C.la.g;
  C.cycles = (long long*)p[P_CYCLES];
  const int bytes = cross_plan(C).words * 4;
  if (bytes > kSmemWords * 4) return (int)cudaErrorInvalidValue;
  void (*kernel)(CrossArgs) = fin    ? cross_conv_fin_wide_kernel
                              : bf16 ? cross_conv_bf16_wide_kernel
                                     : cross_conv_wide_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)batch * (C.n_al_blocks + C.n_la_blocks);
  if (blocks > 0) kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(C);
  return (int)cudaGetLastError();
}
}  // namespace

// B1: the two directions' sums
extern "C" int dbfr_cross_conv(const void* const* p, int n_ptrs, const int* n, int n_ints,
                               const float* f, int n_floats, void* stream) {
  return launch_wide(p, n_ptrs, n, n_ints, f, n_floats, stream, false, false);
}

// B7: the two directions' sums, finalized
extern "C" int dbfr_cross_conv_fin(const void* const* p, int n_ptrs, const int* n, int n_ints,
                                   const float* f, int n_floats, void* stream) {
  return launch_wide(p, n_ptrs, n, n_ints, f, n_floats, stream, true, false);
}

// B11-cross: the two directions' sums with the bf16 chain
extern "C" int dbfr_cross_conv_bf16(const void* const* p, int n_ptrs, const int* n, int n_ints,
                                    const float* f, int n_floats, void* stream) {
  return launch_wide(p, n_ptrs, n, n_ints, f, n_floats, stream, false, true);
}
