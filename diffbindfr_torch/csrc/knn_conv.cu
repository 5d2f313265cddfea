// B3: pocket-atom conv over the fixed neighbour list idx/valid [na, k]
// (knn_edges, 4 A). Replaces diffbindfr_tpu/nn/pallas_conv_t.py:
// make_knn_conv_t (the pallas_call at :935); contract of the XLA twin
// make_knn_twin (nn/pallas_conv.py:359-405): the masked message sums over
// each atom's valid neighbour slots, [B, n, dout] component-major.
//
// B9: dbfr_knn_conv_fin is the same conv with the finalize of
// diffbindfr_tpu/nn/pallas_conv.py:make_knn_conv(fin=) (the pallas_call at
// :1225): sums / max(sum of valid, 1) -> irreps Linear -> LayerNorm, as a
// per-block epilogue (conv_fin.cuh); `cnt` is the valid count per atom.
//
// B11-knn: dbfr_knn_conv_bf16 is B3 with the bf16 depthwise chain of
// make_knn_conv_t(dw_dtype='bfloat16'): the gathered neighbour rows and the
// target scalars move rounded to bf16 (pallas_conv_t.py:842, :848), so both
// scalar halves of the TP-weight MLP input are rounded.
//
// The three run one kernel body (knn_block<FIN, BF>), each under its own
// symbol, on one knn grid: a 1-D grid of blocks, each owning g_k atoms of
// one sample (every sample's blocks in atom order), that compacts its
// atoms' valid neighbour slots in slot order and walks them in 64-pair
// tiles on conv_fwd_wide.cuh's chain (register-tiled MLPs over 16-row
// cp.async weight stages; the TP's source rows staged in shared memory; BF:
// the bf16 chain per output column), as B10's atom blocks run their knn
// conv (layer_conv.cu) but without the la pass. B9 then finalizes its rows
// as B7's blocks do (cross_conv.cu): its output rows and LayerNorm
// statistics take the weight-stage region, free after the sums, so its
// blocks hold as many atoms as B3's. Every atom's sum is its block's own,
// in list order: no atomics, two calls give the same bits. The host picks
// g_k from the shapes and the SM count (nn/trunk_convs.py knn_row_groups:
// tile fill against the wave tail; the fp32 plan's full-size w and cb tiles
// and staged source rows hold fewer atoms than the bf16 plan's) and reads
// nothing, so a CUDA graph captures the call. One block per SM (its tiles,
// weight stages and g_k rows of sums take most of the shared memory). With
// `cycles` set, thread 0 of each block writes the block's clock64() cycles
// there (grid order).
// Bound on the H100: fp32 FMA in the edge and TP-weight MLPs (operations).
#include "conv_fwd_wide.cuh"

namespace {

struct KnnArgs {
  dbfr::ConvArgs a;
  int n_blocks;  // per sample
  long long* cycles;
};

// the conv's plan; with a finalize, its output rows and statistics moved
// into the weight stages
__host__ __device__ inline dbfr::FwdPlan knn_plan(const dbfr::ConvArgs& a) {
  return dbfr::fin_after_sums(dbfr::fwd_plan(a, dbfr::kKnn), a);
}

template <bool FIN, bool BF>
__device__ __forceinline__ void knn_block(const KnnArgs& K) {
  using namespace dbfr;
  const long long c0 = clock64();
  const FwdRegions F = carve_fwd(knn_plan(K.a));
  wide_rows<kKnn, FIN, BF>(K.a, blockIdx.x / K.n_blocks, (blockIdx.x % K.n_blocks) * K.a.g, F);
  if (K.cycles != nullptr && threadIdx.x == 0) K.cycles[blockIdx.x] = clock64() - c0;
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) knn_conv_wide_kernel(KnnArgs K) {
  knn_block<false, false>(K);
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) knn_conv_fin_wide_kernel(KnnArgs K) {
  knn_block<true, false>(K);
}

__global__ void __launch_bounds__(dbfr::kThreads, 1) knn_conv_bf16_wide_kernel(KnnArgs K) {
  knn_block<false, true>(K);
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

// one launch of `kernel` on the knn grid, g_k = atom_rows atoms per block
// (the host's choice, checked against the shared memory: an error, and no
// launch, where the plan does not fit)
int launch_knn(void (*kernel)(KnnArgs), const dbfr::ConvArgs& a, int batch, int atom_rows,
               void* cycles, void* stream) {
  using namespace dbfr;
  KnnArgs K;
  K.a = a;
  K.a.g = atom_rows;
  if (atom_rows < 1 || a.nt >= 1 << 16) return -1;
  K.n_blocks = (a.nt + atom_rows - 1) / atom_rows;
  K.cycles = (long long*)cycles;
  const int bytes = knn_plan(K.a).words * 4;
  if (bytes > kSmemWords * 4) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)batch * K.n_blocks;
  if (blocks > 0) kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(K);
  return (int)cudaGetLastError();
}
}  // namespace

// B3: the sums (then g_k atoms per block and the per-block cycles or null)
extern "C" int dbfr_knn_conv(
    const void* pos, const void* x, const void* idx, const void* valid,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* wf1, const void* bf1, const void* wf2,
    const void* bf2, const void* ck, const void* gs_off, const void* out_meta,
    void* out, int batch, int n, int k, int din, int dout, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, int atom_rows, void* cycles,
    void* stream) {
  const dbfr::ConvArgs a = knn_args(pos, x, idx, valid, cutoff, w1, b1, w2, b2, wf1, bf1, wf2,
                                    bf2, ck, gs_off, out_meta, out, n, k, din, dout, ns, he, hf,
                                    nw, kdim, gs_n, gs_coeff);
  return launch_knn(knn_conv_wide_kernel, a, batch, atom_rows, cycles, stream);
}

// B9: the sums, finalized (B3's arguments, the finalize's, then g_k and
// the cycles)
extern "C" int dbfr_knn_conv_fin(
    const void* pos, const void* x, const void* idx, const void* valid,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* wf1, const void* bf1, const void* wf2,
    const void* bf2, const void* ck, const void* gs_off, const void* out_meta,
    void* out, int batch, int n, int k, int din, int dout, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, const void* cnt,
    const void* mix_w, const void* ln_w, const void* ln_ms, const void* ln_b,
    const void* mix_meta, const void* ln_slots, int out_dim, int n_slots, int mix_numel,
    int atom_rows, void* cycles, void* stream) {
  dbfr::ConvArgs a = knn_args(pos, x, idx, valid, cutoff, w1, b1, w2, b2, wf1, bf1, wf2, bf2,
                              ck, gs_off, out_meta, out, n, k, din, dout, ns, he, hf, nw, kdim,
                              gs_n, gs_coeff);
  if (out_dim < 1) return -1;
  dbfr::set_fin(a, cnt, mix_w, ln_w, ln_ms, ln_b, mix_meta, ln_slots, out_dim, n_slots,
                mix_numel);
  return launch_knn(knn_conv_fin_wide_kernel, a, batch, atom_rows, cycles, stream);
}

// B11-knn: the sums with the bf16 chain (the arguments of dbfr_knn_conv)
extern "C" int dbfr_knn_conv_bf16(
    const void* pos, const void* x, const void* idx, const void* valid,
    const void* cutoff, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* wf1, const void* bf1, const void* wf2,
    const void* bf2, const void* ck, const void* gs_off, const void* out_meta,
    void* out, int batch, int n, int k, int din, int dout, int ns, int he,
    int hf, int nw, int kdim, int gs_n, float gs_coeff, int atom_rows, void* cycles,
    void* stream) {
  dbfr::ConvArgs a = knn_args(pos, x, idx, valid, cutoff, w1, b1, w2, b2, wf1, bf1, wf2, bf2,
                              ck, gs_off, out_meta, out, n, k, din, dout, ns, he, hf, nw, kdim,
                              gs_n, gs_coeff);
  a.bf16_chain = 1;
  a.bf_tgt_sc = 1;
  a.bf_src_sc = 1;
  return launch_knn(knn_conv_bf16_wide_kernel, a, batch, atom_rows, cycles, stream);
}
