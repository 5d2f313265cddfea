"""B2's and B11-pair's grid (csrc/pair_conv.cu pair_conv_wide_kernel and
pair_conv_bf16_wide_kernel, the body pair_block<FIN, BF> that B8 runs with
its finalize, over conv_fwd_wide.cuh's 64-pair tiles) as plain PyTorch:
nn/trunk_convs.py pair_conv_tiled_plain (the conv computed by walking
pair_tile_plan's blocks of g_p ligand rows and their 64-pair tiles, the
bond features as the edge input's extra rows; with bf16_chain, each tile's
messages through the bf16 chain, the target scalars rounded and the source
scalars exact), and the host's plan and choice of rows per block for the
three kernels of the grid (pair_plan_words, pair_row_groups).

Checks: at g_p in {the rule's pick, 1, 3, 5, 48}, the tiled f32 model against
pair_conv_plain and against the JAX package's make_pair_conv_t in
interpret mode, the tiled bf16 model against pair_conv_plain(bf16_chain=
True) and against make_pair_conv_t(dw_dtype='bfloat16'), whose distance to
the f32 model (the control) must lie beyond the bf16 bound; rows without a
valid pair give zero sums; the row groups with and without a finalize and
on the bf16 plan fit the card's shared memory at flagship width and depend
on the shapes alone; the bf16 plan equals its region sums. The small
system is tests/test_torch_pair_wide.py's: NS 8, NV 4, nl 40, B = 3 (sample
2 without ligand rows), a ragged bond chain with bonds stretched beyond the
cutoff, JAX-initialised weights. Tolerances: f32 max|err| <= 1e-5 of
max|ref| (f32 sums in another order); bf16 2e-3, as tests/
test_torch_bf16_wide.py holds B11-cross and B11-knn (two implementations
that round at the same points differ where f32 sums taken in another order
cross a bf16 rounding boundary). Torch and JAX on the CPU, one torch
thread.
"""
import numpy as np
import pytest
import torch
from test_torch_pair_wide import B, CUT, EDIM, FLAGSHIP, GSN, NL, NS, SED, _rel, system  # noqa: F401

from diffbindfr_tpu.nn import pallas_conv_t as PT
from diffbindfr_torch.nn import trunk_convs as TC

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

TOL, BF16_TOL = 1e-5, 2e-3
# flagship width at layer 5 of the 3dbs bucket: B2's sizes (no finalize)
# and B11-pair's (the bf16 plan)
SUMS = dict(FLAGSHIP, out_dim=0, n_slots=0, mix_numel=0)
SUMS_BF16 = dict(SUMS, bf16_chain=1)


def _conv_args(args):
    """pair_conv's arguments from B8's (the finalize's constants, its
    parameters and the counts dropped)."""
    return (args[0], *args[2:15])


def _ints(args, bf16_chain=False):
    c, nb = args[0], args[13].shape[-1]
    dims = (NS, 3 * NS, c.spec.weight_numel, c.tables[0].shape[1])
    return TC._pair_ints(c, dims, B, NL, NL, nb, bf16_chain=bf16_chain)


@pytest.fixture(scope="module")
def jax_sums(system):
    """Per sample, the JAX package's make_pair_conv_t in interpret mode: f32
    and dw_dtype='bfloat16'."""
    cs, samples, params, _ = system
    zl = np.zeros(NL, np.float32)
    out = {}
    for dw in ("float32", "bfloat16"):
        conv = PT.make_pair_conv_t(cs.dw, din=cs.dw.in1.dim, ns=NS, sed=SED, gs_stop=CUT,
                                   gs_n=GSN, edge_extra=EDIM, exclude_self=True,
                                   cab_on_src=True, interpret=True, dw_dtype=dw)
        out[dw] = [np.asarray(conv(s["pos"], s["pos"], s["cm"], s["cm"], s["mask"], s["mask"],
                                   zl, zl, s["temb"], CUT, params, s["bond_feat"],
                                   s["bond_mask"])) for s in samples]
    return out


# "rule": pair_row_groups' pick for the system on 132 SMs, which is 1 row (its
# 3 x 40 rows spread over the SMs); 3 and 5 rows cut a block's list into
# tiles at other places, 48 rows hold a whole sample
GROUPS = ["rule", 1, 3, 5, 48]


def _groups(args, g_p, bf16_chain=False):
    return TC.pair_row_groups(_ints(args, bf16_chain), 132) if g_p == "rule" else g_p


def _dead_rows_are_zero(args, got):
    ok = TC.pair_valid(args[2], args[3], args[6], args[7], args[9],
                       TC._cutoffs(CUT, B, args[2].device), args[14])
    dead = ok.sum(-1) == 0
    assert bool(dead[2].all()) and bool(dead[:2, 30:].all())
    assert not got[dead].any()


@pytest.mark.parametrize("g_p", GROUPS)
def test_pair_sums_tiled_model_matches_plain_and_jax_kernel(system, jax_sums, g_p):
    *_, args = system
    a = _conv_args(args)
    got = TC.pair_conv_tiled_plain(*a, _groups(args, g_p))
    assert got.shape == (B, NL, a[0].dout)
    assert _rel(got.numpy(), TC.pair_conv_plain(*a).numpy()) <= TOL
    for b in range(B):
        err = _rel(got[b].numpy(), jax_sums["float32"][b]) if b < 2 else float(
            np.abs(jax_sums["float32"][b]).max())
        print(f"g_p {g_p} sample {b}: tiled f32 vs JAX make_pair_conv_t {err:.2e}")
        assert err <= TOL
    _dead_rows_are_zero(args, got)


@pytest.mark.parametrize("g_p", GROUPS)
def test_pair_sums_bf16_tiled_model_matches_plain_and_jax_kernel(system, jax_sums, g_p):
    *_, args = system
    a = _conv_args(args)
    got = TC.pair_conv_tiled_plain(*a, _groups(args, g_p, True), bf16_chain=True)
    assert _rel(got.numpy(), TC.pair_conv_plain(*a, bf16_chain=True).numpy()) <= BF16_TOL
    f32 = TC.pair_conv_tiled_plain(*a, _groups(args, g_p))
    for b in range(2):  # sample 2 has no ligand rows: zero on every side
        want = jax_sums["bfloat16"][b]
        err, ctl = _rel(got[b].numpy(), want), _rel(f32[b].numpy(), want)
        print(f"g_p {g_p} sample {b}: tiled bf16 vs JAX bf16 kernel {err:.2e}, "
              f"f32 (control) {ctl:.2e}")
        assert err <= BF16_TOL < ctl
    assert not np.abs(jax_sums["bfloat16"][2]).any()
    _dead_rows_are_zero(args, got)


def test_pair_row_groups_of_the_three_kernels_fit_and_follow_the_shapes(system):
    """At flagship width on 132 SMs B2 and B11-pair, whose blocks of padded
    rows only scan their candidates and store zeros (PAIR_SCAN_TILES), take
    1 and 2 rows at B = 1 and 4, where B8, whose every block finalizes
    (PAIR_FIN_TILES), takes 2 and 3; all three take 8 at B = 16, whose 4
    rows a block would put a sample's working blocks just past the SMs once
    the ligand fills more than 32 of its 128 rows; at B = 64 B11-pair's
    smaller bf16 plan holds 32 rows. Every pick fits the shared memory, the
    same shapes give the same pick whatever else the call sees, more SMs
    never give more rows, and a block that cannot fit is refused."""
    fin = {bsz: TC.pair_row_groups(dict(FLAGSHIP, batch=bsz), 132) for bsz in (1, 4, 16, 64)}
    assert fin == {1: 2, 4: 3, 16: 8, 64: 16}
    for ints, big in ((SUMS, 16), (SUMS_BF16, 32)):
        got = {bsz: TC.pair_row_groups(dict(ints, batch=bsz), 132) for bsz in (1, 4, 16, 64)}
        assert got == {1: 1, 4: 2, 16: 8, 64: big}
        for bsz, g in got.items():
            assert TC.pair_plan_words(dict(ints, batch=bsz), g) <= TC.SMEM_WORDS
        assert TC.pair_row_groups(dict(ints, batch=16, extra=1), 132) == got[16]
        assert TC.pair_row_groups(dict(ints, batch=16), 264) <= got[16]
        with pytest.raises(ValueError):
            TC.pair_row_groups(dict(ints, batch=16, nw=900, hf=900), 132)
    # without the fixed cost of a finalize, more blocks of fewer rows pay
    assert TC.PAIR_SCAN_TILES < TC.PAIR_FIN_TILES
    # the small system: _pair_ints without fin plans no finalize, and names the plan
    *_, args = system
    assert [(n["out_dim"], n["bf16_chain"]) for n in (_ints(args), _ints(args, True))] == [
        (0, 0), (0, 1)]
    assert TC.pair_plan_words(_ints(args, True), 4) < TC.pair_plan_words(_ints(args), 4)


def test_pair_plan_equals_its_region_sums_on_the_bf16_plan():
    """The bf16 plan's regions at layer 5 in 4-byte words, reckoned by hand:
    p1 max(he, hf) x 68 = 9,792 (the bf16 cb tile, 68 x 34 = 2,312, fits),
    p2 max(gs_n + nb, 3 ns) x 68 = 9,792 = the bf16 w tile 288 x 34, sh 9 x
    68, ws the two 16-row weight stages of 9 x 32 columns (9,216; the bf16
    source rows, 168 x 34 = 5,712, fit), ck 612, misc 264; per ligand row
    624 sums and 128 list slots. The f32 plan's p2 holds the f32 w tile,
    288 x 68 = 19,584, so a B2 block, like B8's, holds 23 rows and a
    B11-pair block 37."""
    fixed, per_row = 9792 + 9792 + 612 + 9216 + 612 + 264, 624 + 128
    for g in (1, 4, 8, 16, 37):
        assert TC.pair_plan_words(SUMS_BF16, g) == fixed + per_row * g
    assert TC.pair_plan_words(SUMS_BF16, 4) * 4 == 133184
    assert TC.pair_plan_words(SUMS_BF16, 37) <= TC.SMEM_WORDS < TC.pair_plan_words(SUMS_BF16, 38)
    f32_fixed = fixed + 19584 - 9792
    for g in (1, 4, 23):
        assert TC.pair_plan_words(SUMS, g) == f32_fixed + per_row * g
        assert TC.pair_plan_words(SUMS, g) == TC.pair_plan_words(FLAGSHIP, g)
    assert TC.pair_plan_words(SUMS, 23) <= TC.SMEM_WORDS < TC.pair_plan_words(SUMS, 24)
