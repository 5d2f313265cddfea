"""Reference-checkpoint import: DiffBindFR ``.pth`` -> the port's npz.

The port's counterpart of diffbindfr_tpu/utils/torch_import.py: the same
maps, report and command line, on the port's models; the npz it writes
loads with utils/checkpoint.load_checkpoint (and with the JAX package's).

    python -m diffbindfr_torch.utils.torch_import ref.pth -o mdn.npz
    python -m diffbindfr_torch.utils.torch_import ref.pth -o net.npz \
        --arch score_net --unverified-scorenet

The reference ships paper weights as an mmcv-style torch checkpoint
(``{'meta': ..., 'state_dict': OrderedDict}``, loaded by
``DiffBindFR/common/engines.py:161`` via mmcv ``load_checkpoint``; default
path ``weights/diffbindfr_paper.pth``, ``common/args.py:90``).  This
module reads such a checkpoint with torch (CPU) and maps parameters onto
this package's parameter trees, writing the result in our npz checkpoint
format.

Import stance — what converts EXACTLY and what does not:

* **MDN scoring head** (``mdn_layer.*`` of ``scoring/architecture/
  KarmaDock_sc.py``): exact at inference.  The reference's first pair
  layer is ``Linear(2h, h)`` over ``cat(lig, pro)``; ours is the same
  function split across the concat boundary (``pair_l``/``pair_p``), so
  the torch weight is sliced and transposed.  The eval-mode
  ``BatchNorm1d`` that follows is a fixed per-channel affine
  (``y = (x - mean) / sqrt(var + eps) * gamma + beta``); it is folded to
  ``pair_norm = {scale, shift}`` which ``mdn_head`` applies verbatim when
  present (from-scratch checkpoints use the mask-safe LayerNorm instead).
  ``z_pi/z_sigma/z_mu/atom_types/bond_types`` transpose directly, and the
  surrounding activation conventions already match (softmax /
  ``elu()+1.1`` / ``elu()+1``).

* **GVP/GraphTransformer scorer encoders: NOT imported — from-scratch
  weights are the supported path.**  The encoders here are independent
  re-derivations with deliberately different featurization (on-device
  protein features, dense masked attention, own RBF placement), so
  reference encoder weights do not correspond parameter-for-parameter
  to a function this package computes.

* **SE(3) diffusion score net: imports via a derived basis-change map,
  EXPLICITLY UNVERIFIED** (``--unverified-scorenet``).  This package
  uses its own real-SH basis and numerical CG solver (``nn/irreps.py``)
  rather than e3nn's conventions
  (``druglib/models/Docking/interaction/tpscore.py``).  The two are
  related by fixed orthogonal transforms per degree l; ``e3nn_compat``
  derives them numerically, proves every derived factor self-consistent
  (orthogonality, Wigner intertwining, CG proportionality, conv-level
  function equality against a numpy e3nn-semantics evaluator), and
  ``import_score_net`` maps 100% of the reference tensors — scalar
  tensors copy directly, per-edge TP-weight emitters get per-path
  permutation + sign, and a fixed ``readout_rot`` reproduces the
  reference's raw-slot vector readout.  What CANNOT be checked here is
  the assumption set about e3nn itself (``e3nn_compat`` A1-A4: SH
  ordering, w3j sign rule, irrep sort order, path normalization) —
  e3nn is not a dependency and no reference score-net weights ship with
  the repository.  Hence the gate flag: the conversion is complete
  and internally consistent, but a convention mismatch would produce a
  silently mis-rotated model, so validate against known outputs before
  trusting an imported score net.

Every conversion returns a report listing exactly which source keys were
mapped, which were skipped, and which target leaves remain at their
initialization — no silent partial imports. The trees start from the
models' init_params with torch.Generator seed 0 (the JAX package draws from
PRNGKey(0)), so a leaf left at init differs between the two packages; the
report's lists are the same.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field

import numpy as np
import torch


def load_torch_state_dict(path: str) -> dict:
    """Read a torch checkpoint into {key: np.float32 array}.

    Handles the mmcv layout ({'state_dict': ...}, optional 'ema_state_dict')
    and raw state dicts; strips DataParallel 'module.' prefixes
    (reference druglib checkpoint conventions)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for k in ("ema_state_dict", "state_dict", "model"):
            if k in obj and isinstance(obj[k], dict):
                obj = obj[k]
                break
    out = {}
    for k, v in obj.items():
        if not hasattr(v, "numpy"):
            continue
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = np.asarray(v.detach().to(torch.float32).numpy())
    return out


def fold_batchnorm(gamma, beta, mean, var, eps: float = 1e-5):
    """Eval-mode BatchNorm1d == fixed affine: returns (scale, shift) with
    y = x * scale + shift."""
    scale = gamma / np.sqrt(var + eps)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


@dataclass
class ImportReport:
    mapped: list = field(default_factory=list)  # source keys converted
    skipped: list = field(default_factory=list)  # source keys not mapped
    untouched: list = field(default_factory=list)  # target leaves left at init

    def __str__(self):
        lines = [f"[import] {len(self.mapped)} source keys mapped exactly"]
        if self.skipped:
            lines.append(
                f"[import] {len(self.skipped)} source keys NOT mapped "
                "(no exact counterpart — see utils/torch_import.py stance):")
            for k in self.skipped:
                lines.append(f"  - {k}")
        if self.untouched:
            lines.append(
                f"[import] {len(self.untouched)} target leaves left at "
                "initialization:")
            for k in self.untouched:
                lines.append(f"  - {k}")
        return "\n".join(lines)


def _lin(sd, key):
    """torch Linear -> our {'w': [in, out], 'b': [out]}."""
    p = {"w": sd[f"{key}.weight"].T.copy()}
    if f"{key}.bias" in sd:
        p["b"] = sd[f"{key}.bias"].copy()
    return p


def _numpy_tree(tree):
    """A tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def import_mdn_head(sd: dict, params: dict, prefix: str = "mdn_layer."):
    """Map the reference MDN_Block head onto our MDN parameter tree (exact at
    inference; see module docstring). Mutates and returns params."""
    report = ImportReport()
    h = params["pair_l"]["w"].shape[0]

    w0 = sd[f"{prefix}MLP.0.weight"]  # [h, 2h]
    if w0.shape != (h, 2 * h):
        raise ValueError(
            f"MLP.0 weight {w0.shape} incompatible with hidden={h}")
    params["pair_l"] = {"w": w0[:, :h].T.copy(),
                        "b": sd[f"{prefix}MLP.0.bias"].copy()}
    params["pair_p"] = {"w": w0[:, h:].T.copy()}
    report.mapped += [f"{prefix}MLP.0.weight", f"{prefix}MLP.0.bias"]

    scale, shift = fold_batchnorm(
        sd[f"{prefix}MLP.1.weight"], sd[f"{prefix}MLP.1.bias"],
        sd[f"{prefix}MLP.1.running_mean"], sd[f"{prefix}MLP.1.running_var"])
    params["pair_norm"] = {"scale": scale, "shift": shift}
    report.mapped += [f"{prefix}MLP.1.{s}" for s in
                      ("weight", "bias", "running_mean", "running_var")]

    for name in ("z_pi", "z_sigma", "z_mu", "atom_types", "bond_types"):
        params[name] = _lin(sd, f"{prefix}{name}")
        report.mapped += [f"{prefix}{name}.weight", f"{prefix}{name}.bias"]

    mapped = set(report.mapped)
    report.skipped = sorted(
        k for k in sd
        if k not in mapped and "num_batches_tracked" not in k)
    report.untouched = sorted(
        k for k in ("seq_emb", "pro_node_in", "pro_edge_in", "gvp_layers",
                    "pro_out", "lig_node_in", "lig_edge_in", "gt_layers")
        if k in params)
    return params, report


def _mlp(sd, prefix, report, bias=True):
    """Reference SimpleLinear (Sequential 0=Linear,1=act,2=Dropout,
    3=Linear) -> our {'l1','l2'} MLP pytree."""
    p = {"l1": _lin(sd, f"{prefix}.lin.0"), "l2": _lin(sd, f"{prefix}.lin.3")}
    report.mapped += [f"{prefix}.lin.0.weight", f"{prefix}.lin.3.weight"]
    if bias:
        report.mapped += [f"{prefix}.lin.0.bias", f"{prefix}.lin.3.bias"]
    return p


def _conv(sd, prefix, report, perm=None, scale=None):
    """Reference TensorProductConvLayer -> our fc-mode conv pytree.

    The e3nn FCTP itself is weightless (shared_weights=False); the fc
    MLP's LAST linear emits the per-edge TP weights, so the path
    permutation + per-path basis scale land on its output columns. The
    irreps LayerNorm parameters are per-channel scalars (basis-free)."""
    p = {"fc": _mlp(sd, f"{prefix}.fc", report)}
    w2 = p["fc"]["l2"]["w"]  # [hidden, numel]
    b2 = p["fc"]["l2"]["b"]
    if perm is not None:
        w2, b2 = w2[:, perm], b2[perm]
    if scale is not None:
        w2 = w2 * scale[None, :]
        b2 = b2 * scale
    p["fc"]["l2"] = {"w": w2.astype(np.float32), "b": b2.astype(np.float32)}
    if f"{prefix}.batch_norm.affine_weight" in sd:
        p["ln"] = {
            "mean_shift": sd[f"{prefix}.batch_norm.mean_shift"].reshape(-1),
            "weight": sd[f"{prefix}.batch_norm.affine_weight"],
            "bias": sd[f"{prefix}.batch_norm.affine_bias"],
        }
        report.mapped += [f"{prefix}.batch_norm.{s}" for s in
                          ("mean_shift", "affine_weight", "affine_bias")]
    return p


def import_score_net(sd: dict, cfg=None):
    """Map a reference TensorProductModel state dict (tpscore.py:203-411)
    onto this package's score-net tree (numpy leaves) — the UNVERIFIED e3nn
    import (gated behind --unverified-scorenet).

    Both models share the DiffDock irreps ladder, layer structure, and
    edge-attr conventions; the bases differ. Every tensor maps as:
      * scalar-space tensors (all embedding/edge/head MLPs, LayerNorm
        affines, embedding tables): copied (transposed) directly —
        l=0 features are basis-independent.
      * per-edge TP weight emitters (each conv's fc.lin.3): output
        columns permuted into this package's path enumeration and scaled
        by the per-path basis-change scalar (utils/e3nn_compat
        .convert_fctp_weights / convert_tor_fctp_weights; the derivation
        and its machine-checked invariants live there, together with the
        A1-A4 assumption set that CANNOT be verified without e3nn
        — that is what makes this import 'unverified').
      * a fixed rotation params['readout_rot'] = B_1 so the tr/rot
        readout reproduces the reference's raw-slot vector convention
        (models/score_net.py applies it when present).

    Requires cfg.conv_mode == 'fc' (the reference-exact per-edge uvw TP);
    the separable default factorization has no exact parameter map."""
    from ..models import score_net as sn
    from . import e3nn_compat as EC

    print(
        "[import] WARNING: e3nn conversion rests on assumptions A1-A4 "
        "(e3nn_compat docstring). The (1,2,1) Wigner-3j SIGN in "
        "particular is anchored only by the documented (1,1,0)/(1,1,1) "
        "values; if e3nn's (1,2,1) sign differs, every sh-l=2 path "
        "contribution is silently mis-signed. Validate the imported "
        "model against known reference outputs before use."
    )

    cfg = cfg or sn.ScoreNetConfig(conv_mode="fc")
    if cfg.conv_mode != "fc":
        raise ValueError(
            "score-net import requires ScoreNetConfig(conv_mode='fc') — "
            "the separable conv factorization has no exact e3nn "
            "parameter correspondence")
    report = ImportReport()
    params = _numpy_tree(sn.init_params(torch.Generator().manual_seed(0), cfg))
    sh_s = "1x0e+1x1o+1x2e"

    # early shape sanity: the first conv's weight-emitter output dim
    # pins (ns, nv); a mismatch means the cfg does not describe this
    # checkpoint — fail with the fix, not a broadcast error downstream
    key0 = "lig_conv_layers.0.fc.lin.3.weight"
    if key0 in sd:
        from ..nn import irreps as IRR

        in_ir, out_ir = cfg.layer_irreps(0)
        want = IRR.compile_fc_tensor_product(in_ir, sh_s, out_ir).weight_numel
        got = sd[key0].shape[0]
        if got != want:
            raise ValueError(
                f"checkpoint conv-0 emits {got} TP weights but the given "
                f"config (ns={cfg.ns}, nv={cfg.nv}) needs {want} — pass "
                "the ScoreNetConfig matching the reference model (CLI: "
                "--ns/--nv/--layers/--sed/--ded)")

    # --- scalar embeddings
    params["lig_node_emb"] = _mlp(sd, "lig_node_embedding", report)
    params["lig_edge_emb"] = _mlp(sd, "lig_edge_embedding", report)
    params["atom_edge_emb"] = _mlp(sd, "atom_edge_embedding", report)
    params["la_edge_emb"] = _mlp(sd, "la_edge_embedding", report)
    params["center_edge_emb"] = _mlp(sd, "center_edge_embedding", report)
    params["tor_edge_emb"] = _mlp(sd, "tor_edge_embedding", report)
    ae = params["atom_node_emb"]
    for i in range(len(ae["embs"])):
        key = f"atom_node_embedding.atom_emb_list.{i}.weight"
        ae["embs"][i] = {"emb": sd[key].copy()}
        report.mapped.append(key)
    ae["scalar_lin"] = {
        "w": sd["atom_node_embedding.scalar_lin.weight"].T.copy()}
    report.mapped.append("atom_node_embedding.scalar_lin.weight")

    # --- trunk convs (4 families x L layers)
    fam = {"lig_convs": "lig_conv_layers",
           "atom_convs": "atom_conv_layers",
           "al_convs": "cross_al_conv_layers",
           "la_convs": "cross_la_conv_layers"}
    for li in range(cfg.num_conv_layers):
        in_ir, out_ir = cfg.layer_irreps(li)
        scale = EC.convert_fctp_weights(in_ir, sh_s, out_ir)
        for ours, theirs in fam.items():
            params[ours][li] = _conv(sd, f"{theirs}.{li}", report,
                                     scale=scale)

    # --- heads
    final_in = cfg.layer_irreps(cfg.num_conv_layers - 1)[1]
    params["final_conv"] = _conv(
        sd, "final_conv", report,
        scale=EC.convert_fctp_weights(final_in, sh_s, "2x1o+2x1e"))
    params["readout_rot"] = EC.basis_change(1).astype(np.float32)
    params["tr_final"] = _mlp(sd, "tr_final_layer", report)
    params["rot_final"] = _mlp(sd, "rot_final_layer", report)
    ns = cfg.ns
    tor_out = f"{ns}x0o+{ns}x0e"
    perm, tscale, _ = EC.convert_tor_fctp_weights(final_in, "1x2e", tor_out)
    params["tor_bond_conv"] = _conv(sd, "tor_bond_conv", report,
                                    perm=perm, scale=tscale)
    params["tor_final"] = _mlp(sd, "tor_final_layer", report, bias=False)
    if not cfg.no_sc_torsion:
        params["sc_edge_emb"] = _mlp(sd, "sc_edge_embedding", report)
        params["sc_tor_bond_conv"] = _conv(sd, "sc_tor_bond_conv", report,
                                           perm=perm, scale=tscale)
        params["sc_tor_final"] = _mlp(sd, "sc_tor_final_layer", report,
                                      bias=False)

    mapped = set(report.mapped)
    report.skipped = sorted(
        k for k in sd if k not in mapped and "num_batches_tracked" not in k)
    return params, report


def import_checkpoint(path: str, arch: str = "mdn", cfg=None,
                      unverified_scorenet: bool = False):
    """Load a reference .pth and map it onto a fresh pytree of `arch`.

    arch='mdn': the KarmaDock_sc scorer — MDN head imports exactly,
    encoders stay at initialization (reported).
    arch='score_net': the e3nn diffusion model — converts via the
    derived basis-change map (import_score_net) ONLY when
    unverified_scorenet=True; refused otherwise with the stance."""
    if arch == "score_net":
        if not unverified_scorenet:
            raise NotImplementedError(
                "Score-net import crosses the e3nn basis boundary. The "
                "full map is derived and self-consistency-tested "
                "(utils/e3nn_compat.py), but its assumption set about "
                "e3nn's conventions (A1-A4 there) CANNOT be verified in "
                "this environment — no e3nn, no reference weights. Pass "
                "--unverified-scorenet to convert anyway; validate the "
                "result against known outputs before trusting it.")
        sd = load_torch_state_dict(path)
        return import_score_net(sd, cfg)
    if arch != "mdn":
        raise ValueError(f"unknown arch {arch!r}")
    from ..models import mdn_scorer as mdn

    sd = load_torch_state_dict(path)
    cfg = cfg or mdn.MDNConfig()
    params = _numpy_tree(mdn.init_params(torch.Generator().manual_seed(0), cfg))
    return import_mdn_head(sd, params)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert a reference DiffBindFR .pth checkpoint to the "
                    "npz format of diffbindfr_torch (see module docstring "
                    "for what imports exactly).")
    ap.add_argument("pth")
    ap.add_argument("-o", "--out", required=True, help="output .npz")
    ap.add_argument("--arch", choices=["mdn", "score_net"], default="mdn")
    ap.add_argument("--unverified-scorenet", action="store_true",
                    help="convert the e3nn score net via the derived "
                         "basis-change map (self-consistency-tested but "
                         "not verified against e3nn itself — see "
                         "utils/e3nn_compat.py A1-A4)")
    ap.add_argument("--ns", type=int, default=48,
                    help="score_net arch: scalar channels of the "
                         "reference model (paper default 48)")
    ap.add_argument("--nv", type=int, default=12)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--sed", type=int, default=32,
                    help="sigma embedding dim")
    ap.add_argument("--ded", type=int, default=32,
                    help="distance embedding dim")
    args = ap.parse_args(argv)

    from .checkpoint import save_checkpoint

    cfg = None
    if args.arch == "score_net":
        from ..models.score_net import ScoreNetConfig

        cfg = ScoreNetConfig(
            ns=args.ns, nv=args.nv, num_conv_layers=args.layers,
            sigma_embed_dim=args.sed, distance_embed_dim=args.ded,
            conv_mode="fc")
    params, report = import_checkpoint(
        args.pth, arch=args.arch, cfg=cfg,
        unverified_scorenet=args.unverified_scorenet)
    print(report)
    save_checkpoint(args.out, params)
    print(f"[import] wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
