"""The port's training command (diffbindfr_torch/app/train_cli.py) from job
tables, against the JAX package's train_cli: its batch draws, the
validation loop and ckpt_best.npz, the training pin of the depthwise chain,
and the refused 'fc' mode.

Inputs: copies of runs/pb_bench's 3mhw, 2zec and 3dbs contact-chain
receptors with their ligands as `<stem>_crystal.sdf` beside them (the
crystal pose `-p` discovers), and those ligands as `-l`: 9 jobs, receptor x
ligand as `make_jobs` pairs them, of which `--holdout 2zec_2zec` holds one
out. Small config (ns=8, nv=4, 2 layers), the CPU.
"""
import csv
import os
import shutil

import numpy as np
import pytest
import torch

from diffbindfr_tpu import train as JTR
from diffbindfr_tpu.app import train_cli as jcli
from diffbindfr_tpu.data import sample as JDS
from diffbindfr_torch.app import cli, pipeline, train_cli  # noqa: F401 (pipeline: bound before the spies)
from diffbindfr_torch.data import sample as TDS
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.train import tree_leaves
from diffbindfr_torch.utils.checkpoint import load_checkpoint, load_train_state

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "runs/pb_bench")
NAMES = ("3mhw", "2zec", "3dbs")
SMALL = ["--ns", "8", "--nv", "4", "--layers", "2"]
DRAW = ["--steps", "3", "-bs", "2", "--seed", "7", "--holdout", "2zec_2zec", "--val-batches",
        "1", "--val-every", "3"]


@pytest.fixture(scope="module")
def pb_copy(tmp_path_factory):
    """(-p paths, -l paths) of the receptor/ligand copies."""
    d = tmp_path_factory.mktemp("pb")
    recs, ligs = [], []
    for n in NAMES:
        src = os.path.join(PB, n)
        shutil.copy(os.path.join(src, f"{n}_protein_contact_chains.pdb"), d / f"{n}.pdb")
        shutil.copy(os.path.join(src, f"{n}_ligand.sdf"), d / f"{n}_crystal.sdf")
        shutil.copy(os.path.join(src, f"{n}_ligand.sdf"), d / f"{n}_lig.sdf")
        recs.append(str(d / f"{n}.pdb"))
        ligs.append(str(d / f"{n}_lig.sdf"))
    return recs, ligs


def _drawn(monkeypatch, module):
    """A list that receives, per stack_samples call of `module`, the batch's
    samples as (n real ligand atoms, n real pocket atoms, ligand position
    sum): which prepared pairs a batch holds."""
    seen, real = [], module.stack_samples

    def spy(samples):
        seen.append([(int(np.sum(s.lig_mask)), int(np.sum(s.atm_mask)),
                      round(float(np.sum(s.lig_pos)), 3)) for s in samples])
        return real(samples)

    monkeypatch.setattr(module, "stack_samples", spy)
    return seen


def _chain_calls(monkeypatch):
    """A list that receives bf16_chain of every trunk conv call."""
    calls = []
    for name in ("pair_conv", "cross_conv", "knn_conv"):
        real = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _fn=real, **k: calls.append(
            k.get("bf16_chain", False)) or _fn(*a, **k))
    return calls


def _jax_draws(monkeypatch, pb_copy, out):
    """The batches the JAX train_cli draws for DRAW (its train and eval
    steps replaced by no-ops: only the draws are read)."""
    recs, ligs = pb_copy
    monkeypatch.setenv("DIFFBINDFR_CACHE_DIR", "off")
    metrics = {k: 0.0 for k in ("loss", "tr_loss", "rot_loss", "tor_loss", "sc_loss")}
    monkeypatch.setattr(JTR, "make_train_step",
                        lambda *a: lambda state, batch, key: (state, metrics))
    monkeypatch.setattr(JTR, "make_eval_step", lambda *a: lambda p, batch, key: metrics)
    seen = _drawn(monkeypatch, JDS)
    assert jcli.main(["--cpu", "-p", *recs, "-l", *ligs, "-o", out, *SMALL, *DRAW,
                      "--log-every", "100"]) == 0
    return seen


def test_diffusion_from_job_tables_matches_jax_draws(monkeypatch, pb_copy, tmp_path, capsys):
    """`train_cli -p -l --holdout --val-poses` at its default precision
    (bf16) on the CPU: the validation batches and every step's batch hold
    the pairs the JAX train_cli draws for the same seed; each step's loss is
    finite; the validation line logs val_*, val_ema_* and the dock's
    val_best_lrmsd_*; ckpt_best.npz holds the trained EMA at the last step,
    and `predict -ckt <run dir>` picks it; every trunk conv call of the run
    (training and the validation dock) has bf16_chain False, while predict's
    own bf16 dock (pallas_dw_dtype 'auto') takes the bf16 chain."""
    want = _jax_draws(monkeypatch, pb_copy, str(tmp_path / "jax"))
    monkeypatch.undo()
    recs, ligs = pb_copy
    seen, calls = _drawn(monkeypatch, TDS), _chain_calls(monkeypatch)
    out = str(tmp_path / "run")
    res = train_cli.main(["--cpu", "-p", *recs, "-l", *ligs, "-o", out, *SMALL, *DRAW,
                          "--log-every", "1", "--val-poses", "1"])
    assert seen == want and len(want) == 1 + 3  # the validation batch, three steps
    assert res["steps"] == 3 and all(np.isfinite(res["losses"]))
    assert calls and not any(calls)
    printed = capsys.readouterr().out
    val = [line for line in printed.splitlines() if line.startswith("[val 3]")][-1]
    for k in ("val_loss=", "val_ema_sc_loss=", "val_best_lrmsd_mean=", "val_best_lrmsd_lt2="):
        assert k in val, k
    state = load_train_state(os.path.join(out, "train_state.npz"), "cpu")
    best, step = load_checkpoint(os.path.join(out, "ckpt_best.npz"), use_ema=True, device="cpu")
    assert step == 3 and all(torch.equal(a, b) for a, b in zip(
        tree_leaves(best), tree_leaves(state.ema_params)))

    calls.clear()
    jobs = tmp_path / "jobs.csv"
    with open(jobs, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["protein", "protein_name", "ligand", "ligand_name", "complex_name",
                    "crystal_ligand"])
        w.writerow([recs[1], "2zec", ligs[1], "2zec_lig", "2zec", ligs[1]])
    pred = str(tmp_path / "pred")
    assert cli.main(["predict", "--cpu", "-i", str(jobs), "-o", pred, "-ckt", out, "-np", "1",
                     "-bs", "1", "-st", "2", "--ec-steps", "2", "--cfg-options",
                     "score_net.ns=8", "score_net.nv=4", "score_net.num_conv_layers=2"]) == 0
    assert "checkpoint policy: best-val" in capsys.readouterr().out
    with open(os.path.join(pred, "results.csv")) as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["l_rmsd"]))
    assert calls and all(calls)


@pytest.mark.parametrize("argv", [["--conv-mode", "fc"],
                                  ["--conv-mode", "fc", "--model", "mdn", "--pallas"]])
def test_fc_mode_is_refused_by_name(argv, tmp_path):
    """--conv-mode fc exits naming its ROADMAP item ('fc' training, A15)
    before any work."""
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--cpu", "-i", "none.csv", "-o", str(tmp_path / "out")] + argv)
    assert "--conv-mode fc" in str(e.value.code) and "ROADMAP A15" in str(e.value.code)
    assert not os.path.exists(tmp_path / "out")


def test_flags_and_defaults_are_the_jax_ones():
    """Every flag of the JAX train_cli, with its default; the port adds only
    --device."""
    jp, tp = jcli.build_parser(), train_cli.build_parser()
    jflags = {a.dest: a.default for a in jp._actions if a.dest != "help"}
    tflags = {a.dest: a.default for a in tp._actions if a.dest != "help"}
    assert set(tflags) - set(jflags) == {"device"}
    assert {k: tflags[k] for k in jflags} == jflags and tflags["dtype"] == "bfloat16"
    for a, b in zip([x for x in jp._actions if x.dest != "help"],
                    [x for x in tp._actions if x.dest in jflags]):
        assert (a.option_strings, a.nargs, a.type, a.choices) == (
            b.option_strings, b.nargs, b.type, b.choices), a.dest
