"""The probe kernels P1 (`csrc/probe_bf16.cu`, all three arithmetics) and
P2-vpu (`csrc/probe_mxu_ops.cu` chain_vpu) against their plain versions on
the card, and the reading of P1's step loop from its SASS.

Marked `cuda` (skipped, with a reason, where no GPU is present) except the
SASS reader's test on a fixed listing and P1's refusal of steps past its
float counter, which run anywhere. Imports no JAX,
so it runs on the GPU machine with

    python -m pytest tests/test_torch_probes_cuda.py --noconftest -p no:cacheprovider

Gates are chip_smoke.py's (phases 17 and 24): P1 f32 max|err| <= 1e-5 *
max|ref| (the kernel's fma rounds once where the plain chain rounds the
product and the sum), bf16x2 mul/add bit for bit (both round every
operation), bf16x2 fma 2^-8 (one rounding fewer than the plain chain, which
rounds the exact product-sum once); P2-vpu 1e-6 (the group sums in the
butterfly's order; bf16 sums that torch rounds through f32).
"""
import os
import shutil
import subprocess

import pytest
import torch

from diffbindfr_torch.probes import bf16_chain as P
from diffbindfr_torch.probes import mxu_ops as M

P1_TOL = {"f32_fma": 1e-5, "bf16x2_mul_add": 0.0, "bf16x2_fma": 2.0 ** -8}
# (rows, lanes): the gate's shape, and element counts whose last block (128
# vectors of 4 f32 or 8 bf16) leaves threads with 3, 2 or 1 of their 4
# vectors: (3, 1000) 4 and 3; (1, 40) 1; (8, 89) f32 2 and 1, bf16 3 and 2
P1_SHAPES = [(256, 1024), (3, 1000), (1, 40), (8, 89)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,lanes", P1_SHAPES)
@pytest.mark.parametrize("variant", P.VARIANTS)
def test_p1_kernel_matches_plain(dev, variant, rows, lanes):
    x, w = P.inputs(rows, lanes, variant, dev)
    before = P.launches[f"probe_bf16/{variant}"]
    got = P.chain(x, w, 8, variant)
    ref = P.chain_plain(x, w, 8, variant)
    torch.cuda.synchronize()
    assert P.launches[f"probe_bf16/{variant}"] == before + 1
    assert got.shape == x.shape and got.dtype == x.dtype and bool(torch.isfinite(got).all())
    err = _rel(got, ref)
    assert err <= P1_TOL[variant], (variant, rows, lanes, err)


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    pytest.skip("cuobjdump not found")


@pytest.mark.cuda
def test_p1_step_loop_adds_little_to_its_work(dev):
    """The compiled step loop runs a thread's four vectors: per step its
    chain instructions (2, 1.5, 1 per element for 16 f32 or 32 bf16 chains)
    and at most 6 more (the pert, the counter, the loop)."""
    from diffbindfr_torch.utils import cuda_build

    sass = subprocess.run([_cuobjdump(), "-sass", cuda_build.build()], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    got = P.sass_steps(sass)
    work = {"f32_fma": 32, "bf16x2_mul_add": 48, "bf16x2_fma": 32}
    for v, r in got.items():
        print(v, r)
        assert work[v] <= r["per_step"] <= work[v] + 6, (v, r)


SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_116probe_f32_kernelEPK6float4S2_PS0_ii
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;               /* 0x0000000000007919 */
        /*0020*/                   FMUL R3, R2, 9.9999999747524270788e-07 ;   /* 0x358637bd02037820 */
        /*0030*/                   FFMA R4, R4, R5, R6 ;           /* 0x0000000504047223 */
        /*0040*/                   FADD R4, R4, R3 ;               /* 0x0000000304047221 */
        /*0050*/                   FMUL R3, R2, 9.9999999747524270788e-07 ;
        /*0060*/                   FFMA R4, R4, R5, R6 ;
        /*0070*/                   FADD R4, R4, R3 ;
        /*0080*/                   IADD3 R7, R7, 0x2, RZ ;
        /*0090*/              @!P0 BRA 0x20 ;                      /* 0xfffffffc00e08947 */
        /*00a0*/                   FMUL R3, R2, 9.9999999747524270788e-07 ;
        /*00b0*/                   FFMA R4, R4, R5, R6 ;
        /*00c0*/               @P1 BRA 0xa0 ;
        /*00d0*/                   EXIT ;
                Function : _ZN12_GLOBAL__N_117probe_bf16_kernelILb0EEEvPK5uint4S2_PS0_ii
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   FMUL R3, R2, 9.9999999747524270788e-07 ;
        /*0020*/                   F2FP.BF16.F32.PACK_AB R3, R3, R3 ;
        /*0030*/                   HMUL2.BF16_V2 R4, R4, R5 ;
        /*0040*/                   HADD2.BF16_V2 R4, R4, R6 ;
        /*0050*/                   HADD2.BF16_V2 R4, R4, R3 ;
        /*0060*/               @P0 BRA 0x10 ;
        /*0070*/                   EXIT ;
                Function : _ZN12_GLOBAL__N_117probe_bf16_kernelILb1EEEvPK5uint4S2_PS0_ii
        /*0000*/                   FMUL R3, R2, 9.9999999747524270788e-07 ;
        /*0010*/                   HFMA2.BF16_V2 R4, R4, R5, R6 ;
        /*0020*/                   BRA 0x30 ;
        /*0030*/                   HADD2.BF16_V2 R4, R4, R3 ;
        /*0040*/              @!P1 BRA 0x0 ;
        /*0050*/                   EXIT ;
"""


def test_sass_steps_reads_the_widest_loop():
    """The widest of two loops; a forward branch is no loop; the loop's
    FMULs count its steps."""
    got = P.sass_steps(SASS)
    assert got["f32_fma"]["steps"] == 2 and got["f32_fma"]["loop_instructions"] == 8
    assert got["f32_fma"]["per_step"] == 4.0
    assert got["f32_fma"]["opcodes_per_step"] == {"BRA": 0.5, "FADD": 1.0, "FFMA": 1.0,
                                                  "FMUL": 1.0, "IADD3": 0.5}
    assert got["bf16x2_mul_add"]["loop_instructions"] == 6
    assert got["bf16x2_mul_add"]["per_element_step"] == 6 / 32
    assert got["bf16x2_fma"]["loop_instructions"] == 5 and got["bf16x2_fma"]["steps"] == 1


@pytest.mark.parametrize("variant", P.VARIANTS)
def test_p1_refuses_steps_past_its_float_counter(variant):
    """The kernel counts steps in a float, exact up to 2**24: past that
    the wrapper refuses, on either device, rather than compute another
    function than chain_plain."""
    x, w = P.inputs(1, 8, variant)
    with pytest.raises(ValueError, match="float step counter"):
        P.chain(x, w, 2**24 + 1, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("nblk,reps", [(8, 64), (M.NBLK, M.REPS)])
def test_p2_vpu_kernel_matches_plain(dev, nblk, reps):
    src, w, cb = M.chain_inputs(nblk, dev)
    before = M.launches["probe_mxu_ops/chain_vpu"]
    got = M.chain_vpu(src, w, cb, reps)
    ref = M.chain_vpu_plain(src, w, cb, reps)
    torch.cuda.synchronize()
    assert M.launches["probe_mxu_ops/chain_vpu"] == before + 1
    assert got.shape == (reps, M.plan()[3], 8) and bool(torch.isfinite(got).all())
    assert not bool(got[..., 4:].any())
    err = _rel(got, ref)
    print(f"chain_vpu nblk {nblk} reps {reps}: max|err|/max|ref| {err:.2e}, "
          f"elements that differ {int((got != ref).sum())} of {got.numel()}")
    assert err <= 1e-6, err
