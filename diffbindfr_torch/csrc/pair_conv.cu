// B2: ligand-ligand pair conv over the dense [nl, nl] block.
// Replaces diffbindfr_tpu/nn/pallas_conv_t.py:make_pair_conv_t (the
// pallas_call at :433); contract of the XLA twin make_pair_twin
// (nn/pallas_conv.py:227-292) in the score net's configuration (bond
// features, cab flags on the source side, self pairs excluded, no flip):
// component-major f32 features in, masked message SUM [B, nt, dout] out,
// batch axis B in place of the vmap.
// Mask: (d <= cutoff and not self) or bonded, and both nodes valid.
//
// B11-pair: dbfr_pair_conv_bf16 is B2 with the bf16 depthwise chain of
// make_pair_conv_t(dw_dtype='bfloat16'): the target scalars enter the
// TP-weight MLP rounded to bf16 (pallas_conv_t.py:328; ConvArgs::
// bf_tgt_sc), the source scalars exact (:332); w, cb and the staged source
// rows are bf16 tiles (the bf16 plan of fwd_plan).
//
// B8: dbfr_pair_conv_fin is the same conv with the finalize of
// diffbindfr_tpu/nn/pallas_conv.py:make_pair_conv(fin=) (the pallas_call at
// :653): sums / max(cnt, 1) -> irreps Linear -> LayerNorm; out is [B, nt,
// out_dim].
//
// The three run one kernel body (pair_block<FIN, BF>), each under its own
// symbol, on one grid of ligand rows, as knn_conv.cu's three run the knn
// grid: a 1-D grid of blocks, each owning g_p ligand rows of one sample
// (every sample's blocks in row order), that compacts its rows' valid
// sources in source order, walks them in conv_fwd_wide.cuh's 64-pair tiles
// (wide_rows<kDense, FIN, BF>: the edge input [Gaussian | bond features];
// register-tiled MLPs over 16-row cp.async weight stages; the TP's source
// rows staged in shared memory; BF: the bf16 chain per output column) and
// adds each pair's message to its row's sum in list order. B2 and B11-pair
// then write their rows' sums, zeros included (the caller's output needs no
// clearing); B8 finalizes its rows with their output rows and LayerNorm
// statistics in the weight stages, free after the sums (fin_after_sums).
// Every row's sum is its block's own: no atomics, two calls give the same
// bits. The host picks g_p from the batch, the shapes and the SM count
// (nn/trunk_convs.py pair_row_groups: at the 3dbs bucket a real ligand row
// has ~13 pairs, so ~5 rows fill a tile; a block of padded rows costs B8
// its finalize, B2 and B11-pair only its scan and its zero stores) and
// reads nothing, so a CUDA graph captures the call. One block per SM (its
// tiles, weight stages and g_p rows of sums take most of the shared
// memory). With `cycles` set, thread 0 of each block writes the block's
// clock64() cycles there (grid order).
// Bound on the H100: fp32 FMA in the edge and TP-weight MLPs (operations).
// The arguments come as arrays indexed by the enums below, which
// diffbindfr_torch/nn/trunk_convs.py (PAIR_PTRS, PAIR_INTS) mirrors name for
// name; B2 and B11-pair take out_dim 0 and null finalize pointers.
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

struct PairArgs {
  dbfr::ConvArgs a;
  int n_blocks;  // per sample
  long long* cycles;
};

// the conv's plan (BF: the bf16 plan); with a finalize, its output rows and
// statistics moved into the weight stages
__host__ __device__ inline dbfr::FwdPlan pair_plan(const dbfr::ConvArgs& a) {
  return dbfr::fin_after_sums(dbfr::fwd_plan(a, dbfr::kDense), a);
}

template <bool FIN, bool BF>
__device__ __forceinline__ void pair_block(const PairArgs& P) {
  using namespace dbfr;
  const long long c0 = clock64();
  const FwdRegions F = carve_fwd(pair_plan(P.a));
  wide_rows<kDense, FIN, BF>(P.a, blockIdx.x / P.n_blocks, (blockIdx.x % P.n_blocks) * P.a.g, F);
  if (P.cycles != nullptr && threadIdx.x == 0) P.cycles[blockIdx.x] = clock64() - c0;
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) pair_conv_wide_kernel(PairArgs P) {
  pair_block<false, false>(P);
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) pair_conv_bf16_wide_kernel(PairArgs P) {
  pair_block<false, true>(P);
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) pair_conv_fin_wide_kernel(PairArgs P) {
  pair_block<true, false>(P);
}

// the conv's arguments from the arrays, in the score net's configuration:
// cab on the source side, self pairs excluded, no flip
dbfr::ConvArgs pair_args(const void* const* p, const int* n, const float* f) {
  dbfr::ConvArgs a = {};
  a.tgt_pos = (const float*)p[P_TGT_POS];
  a.src_pos = (const float*)p[P_SRC_POS];
  a.tgt_x = (const float*)p[P_TGT_X];
  a.src_x = (const float*)p[P_SRC_X];
  a.tgt_mask = (const float*)p[P_TGT_MASK];
  a.src_mask = (const float*)p[P_SRC_MASK];
  a.cab = (const float*)p[P_CAB];
  a.bond_feat = (const float*)p[P_BOND_FEAT];
  a.bond_mask = (const float*)p[P_BOND_MASK];
  a.cutoff = (const float*)p[P_CUT];
  a.w1 = (const float*)p[P_W_IN];
  a.b1 = (const float*)p[P_BEFF];
  a.w2 = (const float*)p[P_W2];
  a.b2 = (const float*)p[P_B2];
  a.wf1 = (const float*)p[P_WF1];
  a.bf1 = (const float*)p[P_BF1];
  a.wf2 = (const float*)p[P_WF2];
  a.bf2 = (const float*)p[P_BF2];
  a.ck = (const float*)p[P_CK];
  a.gs_off = (const float*)p[P_GS_OFF];
  a.out_meta = (const int*)p[P_OUT_META];
  a.out = (float*)p[P_OUT];
  a.nt = n[I_NT];
  a.nsrc = n[I_NSRC];
  a.din = n[I_DIN];
  a.dout = n[I_DOUT];
  a.nb = n[I_NB];
  a.ns = n[I_NS];
  a.he = n[I_HE];
  a.hf = n[I_HF];
  a.nw = n[I_NW];
  a.kdim = n[I_KDIM];
  a.gs_n = n[I_GS_N];
  a.gs_coeff = f[F_GS_COEFF];
  a.exclude_self = 1;
  return a;
}

// One launch of `kernel` on the grid of ligand rows from the argument
// arrays; fin: with the finalize (out_dim > 0), else none (out_dim 0); bf:
// the bf16 chain. g_p = n[I_LIG_ROWS] ligand rows per block, the host's
// choice, checked against the shared memory: an error, and no launch, where
// the plan does not fit.
int launch_pair(void (*kernel)(PairArgs), bool fin, bool bf, const void* const* p, int n_ptrs,
                const int* n, int n_ints, const float* f, int n_floats, void* stream) {
  using namespace dbfr;
  if (n_ptrs != P_COUNT || n_ints != I_COUNT || n_floats != F_COUNT) return -1;
  const int batch = n[I_BATCH], nt = n[I_NT], nsrc = n[I_NSRC], g = n[I_LIG_ROWS];
  if ((n[I_OUT_DIM] > 0) != fin || g < 1 || nt >= 1 << 16 || nsrc >= 1 << 16) return -1;
  PairArgs P;
  P.a = pair_args(p, n, f);
  if (fin)
    set_fin(P.a, p[P_FIN], p[P_FIN + 1], p[P_FIN + 2], p[P_FIN + 3], p[P_FIN + 4],
            p[P_MIX_META], p[P_LN_SLOTS], n[I_OUT_DIM], n[I_N_SLOTS], n[I_MIX_NUMEL]);
  if (bf) {
    P.a.bf16_chain = 1;
    P.a.bf_tgt_sc = 1;  // the target scalars rounded, the source scalars exact
  }
  P.a.g = g;
  P.n_blocks = (nt + g - 1) / g;
  P.cycles = (long long*)p[P_CYCLES];
  const int bytes = pair_plan(P.a).words * 4;
  if (bytes > kSmemWords * 4) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)batch * P.n_blocks;
  if (blocks > 0) kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
}  // namespace

// B2: the sums alone (out_dim 0)
extern "C" int dbfr_pair_conv(const void* const* p, int n_ptrs, const int* n, int n_ints,
                              const float* f, int n_floats, void* stream) {
  return launch_pair(pair_conv_wide_kernel, false, false, p, n_ptrs, n, n_ints, f, n_floats,
                     stream);
}

// B11-pair: the sums with the bf16 chain (out_dim 0)
extern "C" int dbfr_pair_conv_bf16(const void* const* p, int n_ptrs, const int* n, int n_ints,
                                   const float* f, int n_floats, void* stream) {
  return launch_pair(pair_conv_bf16_wide_kernel, false, true, p, n_ptrs, n, n_ints, f, n_floats,
                     stream);
}

// B8: the sums, finalized (out_dim > 0)
extern "C" int dbfr_pair_conv_fin(const void* const* p, int n_ptrs, const int* n, int n_ints,
                                  const float* f, int n_floats, void* stream) {
  return launch_pair(pair_conv_fin_wide_kernel, true, false, p, n_ptrs, n, n_ints, f, n_floats,
                     stream);
}
