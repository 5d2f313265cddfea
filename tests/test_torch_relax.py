"""The relax commands of the PyTorch port against the JAX package's, on the
CPU: the flex path of ops/vina.py (build_flex_receptor, flex_atom14, the
flex energies, joint_minimize_batch), `relax -i results.csv` in its five
modes, `predict --cart-relax` and `eval_cli --cart-relax`.

Inputs are in the repo: runs/pb_bench/3dbs (its contact-chain PDB and its
crystal ligand moved by seeded numpy noise) for the flex path and the relax
command, the tracked prep caches for predict, a copy of runs/pb_bench's
2zec and 3mhw for eval (the small net of tests/fixtures/torch_predict_ref.npz).
Tolerances: builders equal; flex_atom14 1e-5 A; energies and gradients
1e-5 relative; 30 joint-minimizer steps 1e-4 A; the relax command's SDF
and `_relaxed.pdb` coordinates 1e-3 A (4 and 3 decimals in the files),
its vina_score 1e-3; eval's validity_prerelax.csv, validity.csv and
relax_ab.json byte for byte against the JAX eval_cli's on the same poses.
"""
import copy
import csv
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import cli as JCLI
from diffbindfr_tpu.app import eval_cli as JE
from diffbindfr_tpu.app import pipeline as JP
from diffbindfr_tpu.chem.ligand_feats import featurize_ligand as jfeat
from diffbindfr_tpu.chem.mol import perceive as jperceive
from diffbindfr_tpu.chem.protein_feats import build_pocket_record as jpocket
from diffbindfr_tpu.io.pdb import parse_pdb as jparse_pdb
from diffbindfr_tpu.io.sdf import parse_ligand_file as jparse_lig
from diffbindfr_tpu.ops import vina as JV
from diffbindfr_torch.app import cli
from diffbindfr_torch.app import eval_cli as TE
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.chem.ligand_feats import featurize_ligand
from diffbindfr_torch.chem.mol import perceive
from diffbindfr_torch.chem.protein_feats import build_pocket_record
from diffbindfr_torch.io.pdb import parse_pdb
from diffbindfr_torch.io.sdf import parse_ligand_file, parse_sdf, to_sdf_block
from diffbindfr_torch.ops import vina as TV

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "runs/pb_bench")
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
SMALL_CKPT = os.path.join(ROOT, "tests/fixtures/torch_predict_ref.npz")
STEPS = 30
MODES = {"rigid": [], "angular": ["--angular-hb"], "explicit_h": ["--explicit-h"],
         "flex": ["--flex"], "cartesian": ["--cartesian"]}


def _write_pose(dst, seed):
    """A results.csv in dst with one row: 3dbs's crystal ligand moved by
    seeded noise (0.3 A) as lig_final.sdf, beside a copy of its contact-chain
    PDB as prot_final.pdb."""
    os.makedirs(dst)
    lig = parse_sdf(os.path.join(PB, "3dbs", "3dbs_ligand.sdf"))[0]
    noise = np.random.default_rng(seed).normal(scale=0.3, size=lig.coords.shape)
    sdf, pdb = os.path.join(dst, "lig_final.sdf"), os.path.join(dst, "prot_final.pdb")
    with open(sdf, "w") as fh:
        fh.write(to_sdf_block(lig, (lig.coords + noise).astype(np.float32)))
    shutil.copy(os.path.join(PB, "3dbs", "3dbs_protein_contact_chains.pdb"), pdb)
    path = os.path.join(dst, "results.csv")
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["complex_name", "pose", "lig_sdf", "prot_pdb"])
        w.writerow(["3dbs", 0, sdf, pdb])
    return path, sdf


@pytest.fixture(scope="module")
def flex_inputs(tmp_path_factory):
    """The 3dbs pose of _write_pose(seed 0), featurised, and the pocket
    within 8 A (relax's default), by each package: (JAX lig, pocket), (port
    lig, pocket), the padded pose."""
    path, sdf = _write_pose(str(tmp_path_factory.mktemp("flex") / "p"), seed=0)
    pdb = os.path.join(os.path.dirname(path), "prot_final.pdb")
    jr = jparse_lig(sdf)[0]
    jl = jfeat(jperceive(jr), jr.name)
    tr = parse_ligand_file(sdf)[0]
    tl = featurize_ligand(perceive(tr), tr.name)
    jpk = jpocket(jparse_pdb(pdb), jl.pos, cutoff=8.0)
    tpk = build_pocket_record(parse_pdb(pdb), tl.pos, cutoff=8.0)
    pad_n = -(-tl.num_atoms // 8) * 8
    pos = np.pad(tl.pos - tpk.center, ((0, pad_n - tl.num_atoms), (0, 0))).astype(np.float32)
    return (jl, jpk), (tl, tpk), pos


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _flex_tables(flex_inputs):
    (jl, jpk), (tl, tpk), pos = flex_inputs
    pad_n, pad_r = pos.shape[0], -(-tpk.num_res // 8) * 8
    nt = max(tl.num_torsions, 1)
    return (JV.build_ligand(jl, pad_n, nt), JV.build_flex_receptor(jpk, pad_r),
            TV.build_ligand(tl, pad_n, nt), TV.build_flex_receptor(tpk, pad_r))


def test_flex_builder_atom14_and_energies_match_jax(flex_inputs):
    """build_flex_receptor equal field for field; flex_atom14 at seeded chi
    offsets within 1e-5 A; flex_inter_energy (with and without the angular
    term) plus receptor_clash_energy over flex_clash_exclusion, and its
    gradient in the ligand coordinates and the chi offsets, 1e-5
    relative."""
    jl, jf, tl, tf = _flex_tables(flex_inputs)
    pos = flex_inputs[2]
    for f in jf._fields:
        want, got = np.asarray(getattr(jf, f)), np.asarray(getattr(tf, f))
        assert want.dtype == got.dtype and want.shape == got.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    L, F = TV.stack_to_device([tl], "cpu"), TV.stack_to_device([tf], "cpu")
    dchi = np.random.default_rng(3).normal(scale=0.4, size=tf.chi_mask.shape).astype(np.float32)
    got14 = TV.flex_atom14(F, torch.from_numpy(dchi[None]))[0].numpy()
    np.testing.assert_allclose(got14, np.asarray(JV.flex_atom14(jf, jnp.asarray(dchi))),
                               atol=1e-5)
    jexcl = JV.flex_clash_exclusion(jf)
    texcl = TV.flex_clash_exclusion(F)
    np.testing.assert_array_equal(texcl[0].numpy(), np.asarray(jexcl))
    for ahb in (False, True):
        def jenergy(x, d):
            p14 = JV.flex_atom14(jf, d)
            return (JV.flex_inter_energy(x, jl, jf, p14, angular_hb=ahb)
                    + JV.receptor_clash_energy(jf, p14, jexcl))

        je, (jgx, jgd) = jax.jit(jax.value_and_grad(jenergy, argnums=(0, 1)))(
            jnp.asarray(pos), jnp.asarray(dchi))
        leaves = [torch.from_numpy(pos[None]).requires_grad_(True),
                  torch.from_numpy(dchi[None]).requires_grad_(True)]
        p14 = TV.flex_atom14(F, leaves[1])
        te = (TV.flex_inter_energy(leaves[0], L, F, p14, angular_hb=ahb)
              + TV.receptor_clash_energy(F, p14, texcl))
        gx, gd = torch.autograd.grad(te.sum(), leaves)
        assert _rel(te.item(), je) <= 1e-5, ahb
        assert _rel(gx[0].numpy(), jgx) <= 1e-5, ahb
        assert _rel(gd[0].numpy(), jgd) <= 1e-5, ahb
        assert np.abs(np.asarray(jgd)).max() > 0


def test_joint_minimize_30_steps_matches_jax(flex_inputs):
    """joint_minimize_batch at B = 1 (angular H-bonds on), 30 steps, against
    the JAX joint_minimize under jit: ligand and rebuilt receptor atoms
    within 1e-4 A, affinity 1e-4 relative; ligand and side chains moved."""
    jl, jf, tl, tf = _flex_tables(flex_inputs)
    pos = flex_inputs[2]
    jpos, j14, jaff = jax.jit(lambda p, l_, f_: JV.joint_minimize(
        p, l_, f_, steps=STEPS, angular_hb=True, tor_unroll=1))(jnp.asarray(pos), jl, jf)
    tpos, t14, taff = TV.joint_minimize_batch(
        torch.from_numpy(pos[None]), TV.stack_to_device([tl], "cpu"),
        TV.stack_to_device([tf], "cpu"), steps=STEPS, angular_hb=True)
    a14_0 = np.asarray(JV.flex_atom14(jf, jnp.zeros_like(jf.chi_mask)))
    print(f"moved: ligand {np.abs(np.asarray(jpos) - pos).max():.3f} A, side chains "
          f"{np.abs(np.asarray(j14) - a14_0).max():.3f} A")
    assert np.abs(np.asarray(jpos) - pos).max() > 0.05
    assert np.abs(np.asarray(j14) - a14_0).max() > 0.01
    assert np.abs(tpos[0].numpy() - np.asarray(jpos)).max() <= 1e-4
    assert np.abs(t14[0].numpy() - np.asarray(j14)).max() <= 1e-4
    assert _rel(taff[0].item(), jaff) <= 1e-4


@pytest.mark.parametrize("mode", list(MODES))
def test_relax_command_matches_jax(mode, tmp_path):
    """`relax -i results.csv --cpu --steps 30` with the mode's flags on one
    copy of the pose, the JAX command on another: the rewritten SDFs within
    1e-3 A and their vina_score within 1e-3 (pose-space modes), the
    `_relaxed.pdb` (flex, Cartesian) within 1e-3 A with the same atoms; the
    pose moved (the control)."""
    outs = {}
    for key, main in (("port", cli.main), ("jax", JCLI.main)):
        path, sdf = _write_pose(str(tmp_path / key), seed=1)
        raw = parse_ligand_file(sdf)[0]
        before = featurize_ligand(perceive(raw), raw.name).pos  # the heavy atoms relax writes
        assert main(["relax", "-i", path, "--cpu", "--steps", str(STEPS)] + MODES[mode]) == 0
        mol = parse_sdf(sdf)[0]
        relaxed = sdf[: -len(".sdf")] + "_relaxed.pdb"
        prot = parse_pdb(relaxed) if os.path.exists(relaxed) else None
        outs[key] = (mol, prot)
    (tm, tp), (jm, jp) = outs["port"], outs["jax"]
    print(f"{mode}: moved {np.abs(jm.coords - before).max():.3f} A, port vs JAX "
          f"{np.abs(tm.coords - jm.coords).max():.2e} A")
    assert np.abs(jm.coords - before).max() > 0.05
    assert np.abs(tm.coords - jm.coords).max() <= 1e-3
    assert tm.elements == jm.elements and np.array_equal(tm.bonds, jm.bonds)
    if mode in ("flex", "cartesian"):
        assert tp is not None and jp is not None
        np.testing.assert_array_equal(tp.atom_mask, jp.atom_mask)
        assert np.abs(tp.atom_positions - jp.atom_positions).max() <= 1e-3
        assert set(tm.props) == set(jm.props) == ({"vina_score"} if mode == "flex" else set())
    else:
        assert tp is None and jp is None
    if "vina_score" in jm.props:
        assert abs(float(tm.props["vina_score"]) - float(jm.props["vina_score"])) <= 1e-3


def test_relax_refusals_match_jax(tmp_path, capsys):
    """--explicit-h with --flex and --cartesian with a pose-space flag exit
    before any file is touched; --explicit-h alone says it implies
    --angular-hb."""
    path, sdf = _write_pose(str(tmp_path / "p"), seed=2)
    with open(sdf, "rb") as fh:
        before = fh.read()
    for flags in (["--explicit-h", "--flex"], ["--cartesian", "--angular-hb"],
                  ["--cartesian", "--flex"], ["--cartesian", "--explicit-h"]):
        for main in (cli.main, JCLI.main):
            with pytest.raises(SystemExit) as e:
                main(["relax", "-i", path, "--cpu"] + flags)
            assert e.value.code not in (0, None), flags
    with open(sdf, "rb") as fh:
        assert fh.read() == before
    assert cli.main(["relax", "-i", path, "--cpu", "--steps", "1", "--explicit-h"]) == 0
    assert "--explicit-h implies --angular-hb" in capsys.readouterr().out


def test_predict_cart_relax_runs_after_ec(tmp_path):
    """`predict --cpu --cart-relax --cart-steps 5` on 3dbs and 3mhw from
    their caches (the small net, 2 poses each): the relax runs after EC at
    -bs with --cart-steps, moves the poses (and receptor atoms), keeps the
    vina scores, and the exported lig_final.sdf is the relaxed pose."""
    out = tmp_path / "out"
    os.makedirs(out / "prep_cache")
    jobs = tmp_path / "jobs.csv"
    with open(jobs, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["protein", "protein_name", "ligand", "ligand_name", "complex_name"])
        for n in ("3dbs", "3mhw"):
            d = os.path.join(PB, n)
            w.writerow([f"{d}/{n}_protein_contact_chains.pdb", n, f"{d}/{n}_ligand.sdf", n, n])
            for ext in (".npz", ".rec.pkl"):
                shutil.copy(os.path.join(PREP, f"{n}_r12{ext}"), out / "prep_cache")
    calls = []
    orig = {k: getattr(TP, k) for k in ("error_correct", "cartesian_relax")}

    def spy(name):
        def run(prepared, results, **kw):
            before = copy.deepcopy(results)
            orig[name](prepared, results, **kw)
            calls.append((name, kw, before, copy.deepcopy(results), prepared))
        return run

    with pytest.MonkeyPatch.context() as mp:
        for k in orig:
            mp.setattr(TP, k, spy(k))
        assert cli.main(["predict", "--cpu", "-i", str(jobs), "-o", str(out), "-np", "2", "-bs",
                         "2", "-st", "2", "--ec-steps", "2", "--cart-relax", "--cart-steps", "5",
                         "-no_score", "--cfg-options", "score_net.ns=8", "score_net.nv=4",
                         "score_net.num_conv_layers=2"]) == 0
    assert [c[0] for c in calls] == ["error_correct", "cartesian_relax"]
    _, kw, before, after, prepared = calls[1]
    assert kw["steps"] == 5 and kw["batch_size"] == 2 and str(kw["device"]) == "cpu"
    # a pose the small net left out of its pocket (vina_score 0) moves no receptor atom
    assert any(np.abs(a.atom14_pos - b.atom14_pos).max() > 1e-4 for a, b in zip(before, after))
    for a, b in zip(before, after):
        assert np.abs(a.lig_pos - b.lig_pos).max() > 1e-3
        assert a.vina_score == b.vina_score
        pair = prepared[b.pair_idx]
        got = parse_sdf(os.path.join(out, pair.name, f"pose_{b.pose_idx}", "lig_final.sdf"))[0]
        na = pair.lig.num_atoms
        assert np.abs(got.coords - (b.lig_pos[:na] + pair.pocket.center)).max() <= 1e-3


def _copy_pb(dst, names):
    for n in names:
        os.makedirs(os.path.join(dst, n))
        for k in ("ligand.sdf", "protein_contact_chains.pdb"):
            shutil.copy(os.path.join(PB, n, f"{n}_{k}"), os.path.join(dst, n))
    return str(dst)


def test_eval_cart_relax_ab_matches_jax(tmp_path):
    """`eval_cli --cpu --cart-relax --cart-steps 30` (small net, 2zec and
    3mhw, 2 poses each): validity_prerelax.csv, validity.csv and
    relax_ab.json equal, byte for byte, what the JAX eval_cli writes when
    its stages hand it the port's poses before and after the relax (the
    relax itself is held against the JAX one in test_torch_cartesian.py);
    the relax moved every pose."""
    seen = {}
    relax = TP.cartesian_relax

    def spy(prepared, results, **kw):
        seen["names"] = [p.name for p in prepared]
        seen["pre"] = copy.deepcopy(results)
        relax(prepared, results, **kw)
        seen["post"] = copy.deepcopy(results)

    data = _copy_pb(tmp_path / "data", ("2zec", "3mhw"))
    out = str(tmp_path / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "cartesian_relax", spy)
        assert TE.main(["--cpu", "-d", data, "-o", out, "-ckt", SMALL_CKPT, "--ns", "8", "--nv",
                        "4", "--layers", "2", "-st", "2", "--ec-steps", "5", "-np", "2", "-bs",
                        "2", "--cart-relax", "--cart-steps", str(STEPS), "-no_score"]) == 0
    def by_key(stage):
        """(complex, pose) -> the port's result before or after the relax."""
        return {(seen["names"][r.pair_idx], r.pose_idx): r for r in seen[stage]}

    def jax_dock(prepared, *a, **kw):
        """The port's pre-relax poses as the JAX package's results."""
        names = [p.job.complex_name for p in prepared]
        return [JP.PoseResult(names.index(seen["names"][r.pair_idx]), r.pose_idx,
                              r.lig_pos.copy(), r.atom14_pos.copy(), np.zeros(1),
                              vina_score=r.vina_score) for r in seen["pre"]]

    def jax_relax(prepared, results, **kw):
        post = by_key("post")
        for r in results:
            p = post[(prepared[r.pair_idx].job.complex_name, r.pose_idx)]
            r.lig_pos, r.atom14_pos = p.lig_pos.copy(), p.atom14_pos.copy()

    jout = str(tmp_path / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "dock", jax_dock)
        mp.setattr(JP, "error_correct", lambda *a, **kw: None)
        mp.setattr(JP, "cartesian_relax", jax_relax)
        mp.setattr("diffbindfr_tpu.utils.load_checkpoint", lambda *a, **kw: ({}, 0))
        assert JE.main(["--cpu", "-d", data, "-o", jout, "-ckt", SMALL_CKPT, "-np", "2", "-bs",
                        "2", "--cart-relax", "--cart-steps", str(STEPS), "-no_score"]) == 0
    for f in ("validity_prerelax.csv", "validity.csv", "relax_ab.json"):
        with open(os.path.join(out, f), "rb") as a, open(os.path.join(jout, f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(out, "relax_ab.json")) as fh:
        assert '"oracle_mean_pre"' in fh.read()

    post, pre = by_key("post"), by_key("pre")
    assert all(np.abs(post[k].lig_pos - pre[k].lig_pos).max() > 1e-3 for k in post)
