"""The row-major kernel configurations of the port against the JAX package.

The plain versions of the finalize kernels B7-B9 (`*_conv_fin_plain`) and of
the whole-layer kernel B10 (`layer_conv_plain`) against the JAX package's
twins (nn/pallas_conv.py make_*_twin(fin=...), nn/pallas_layer.py
make_layer_conv(...).twin), on tests/test_pallas_layer.py's small system
(NS 8, NV 4, nl 20, na 200, K 8, seed 7; a layer whose out_dim > din), in a
batch of two samples with some rows fully masked; the same weights on both
sides (JAX initialisers, LayerNorm perturbed, carried across through
params_from_numpy). The JAX side runs its plain twins, not Pallas interpret
mode. Then the score net's dispatch of the config fields.

Tolerance: f32 against f32 with sums in another order -> max|err| <= 1e-5 of
max|ref|, as tests/test_torch_trunk_convs.py holds the other plain versions.
Fully masked rows come out as exactly the LayerNorm's 0e bias (the count is
clamped to 1 and the sum is 0), on both sides.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.nn import pallas_conv as PC
from diffbindfr_tpu.nn import pallas_layer as PL
from diffbindfr_torch.data.sample import _load_sample_npz, stack_samples, to_device
from diffbindfr_torch.models import score_net as tsn
from diffbindfr_torch.nn import layer_conv as LC
from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.utils.checkpoint import params_from_numpy

NS, NV = 8, 4
IN = f"{NS}x0e+{NV}x1o"
OUT = f"{NS}x0e+{NV}x1o+{NV}x1e"
SH = "1x0e+1x1o+1x2e"
SED, GSN = 16, 16
LIG_CUT, CROSS_CUT, ATOM_CUT = 6.0, 9.0, 4.5
K, EDIM, NL, NA, B = 8, 6, 20, 200, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3dbs_r12.npz")
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _counts(lig_pos, atm_pos, lig_mask, atm_mask, cab, bond_mask, valid, cut):
    """The four message counts, from the masks the kernels rebuild."""
    d_ll = np.linalg.norm(lig_pos[None] - lig_pos[:, None] + 1e-12, axis=-1)
    m_ll = ((d_ll <= LIG_CUT) & ~np.eye(NL, dtype=bool)) | (bond_mask > 0)
    m_ll &= (lig_mask[:, None] > 0) & (lig_mask[None, :] > 0)
    d_c = np.linalg.norm(atm_pos[None] - lig_pos[:, None] + 1e-12, axis=-1)
    m_c = ((cab[None, :] > 0) | (d_c <= cut)) & (lig_mask[:, None] > 0) & (atm_mask[None] > 0)
    return [m_ll.sum(1), m_c.sum(1), m_c.sum(0), valid.sum(1)]


@pytest.fixture(scope="module")
def system():
    """Two samples of the small system (the second with its ligand moved and
    another cutoff), numpy inputs, JAX parameters and counts."""
    rng = np.random.default_rng(7)
    cs = JL.make_conv_spec(IN, SH, OUT, "sep")
    din = cs.dw.in1.dim
    atm_pos = (rng.normal(size=(NA, 3)) * 7).astype(np.float32)
    lig0 = (rng.normal(size=(NL, 3)) * 3).astype(np.float32)
    bond_mask = np.zeros((NL, NL), np.float32)
    bond_feat = np.zeros((NL, NL, EDIM), np.float32)
    for _ in range(NL - 1):
        a, b = rng.integers(0, NL, 2)
        if a != b:
            bond_mask[a, b] = bond_mask[b, a] = 1.0
            bond_feat[a, b] = bond_feat[b, a] = rng.normal(size=EDIM).astype(np.float32)
    samples = []
    for i in range(B):
        lig_pos = lig0 + np.float32(i) * rng.normal(size=3).astype(np.float32) * 2.0
        lig_mask = (rng.random(NL) > 0.1).astype(np.float32)
        atm_mask = (rng.random(NA) > 0.1).astype(np.float32)
        lig_mask[3] = 0.0  # a fully masked ligand row, and an atom
        atm_mask[5] = 0.0
        cab = (rng.random(NA) > 0.85).astype(np.float32)
        idx, valid = JL.knn_edges(jnp.asarray(atm_pos), jnp.asarray(atm_pos),
                                  jnp.asarray(atm_mask), jnp.asarray(atm_mask), K, ATOM_CUT,
                                  exclude_self=True)
        idx, valid = np.asarray(idx), np.asarray(valid).astype(np.float32)
        cut = np.float32(CROSS_CUT - 1.5 * i)
        samples.append(dict(
            lig_pos=lig_pos, atm_pos=atm_pos, lig_x=rng.normal(size=(NL, din)).astype(np.float32),
            atm_x=rng.normal(size=(NA, din)).astype(np.float32), lig_mask=lig_mask,
            atm_mask=atm_mask, cab=cab, temb=rng.normal(size=SED).astype(np.float32),
            cut=cut, bond_feat=bond_feat, bond_mask=bond_mask, idx=idx, valid=valid,
            cnt=_counts(lig_pos, atm_pos, lig_mask, atm_mask, cab, bond_mask, valid, cut)))
        samples[-1]["lig_cm"] = np.asarray(PC.cm_from_irreps(cs.dw.in1, samples[-1]["lig_x"]))
        samples[-1]["atm_cm"] = np.asarray(PC.cm_from_irreps(cs.dw.in1, samples[-1]["atm_x"]))
    ks = iter(jax.random.split(jax.random.PRNGKey(3), 32))
    params = {"emb_lig": JL.mlp_init(next(ks), EDIM + SED + GSN, NS),
              "emb_cross": JL.mlp_init(next(ks), SED + GSN, NS),
              "emb_atom": JL.mlp_init(next(ks), SED + GSN, NS)}
    for t in ("lig", "al", "la", "atom"):
        tp = JL.tp_conv_init(next(ks), cs, 3 * NS)
        ln = tp["ln"]
        params[f"fc_{t}"], params[f"mix_{t}"] = tp["fc"], tp["mix"]
        params[f"ln_{t}"] = {  # non-trivial LayerNorm parameters
            "weight": ln["weight"] * (1.0 + 0.1 * jax.random.normal(next(ks), ln["weight"].shape)),
            "mean_shift": ln["mean_shift"],
            "bias": ln["bias"] + 0.05 * jax.random.normal(next(ks), ln["bias"].shape)}
    params = jax.tree.map(np.asarray, params)
    return cs, samples, params


def _port(system):
    """The port's side: LayerConsts, batched tensors and parameters."""
    cs_j, samples, params = system
    cs = TL.make_conv_spec(IN, SH, OUT)
    lc = LC.LayerConsts(cs, TC.ConvConsts(cs.dw, NS, SED, LIG_CUT, GSN),
                        TC.ConvConsts(cs.dw, NS, SED, CROSS_CUT, GSN),
                        TC.ConvConsts(cs.dw, NS, SED, ATOM_CUT, GSN))

    def st(k, dtype=torch.float32):
        return torch.from_numpy(np.stack([s[k] for s in samples])).to(dtype)

    t = {k: st(k) for k in ("lig_pos", "atm_pos", "lig_cm", "atm_cm", "lig_mask", "atm_mask",
                            "cab", "temb", "cut", "bond_feat", "bond_mask", "valid")}
    t["idx"] = st("idx", torch.int64)
    t["cnt"] = [torch.from_numpy(np.stack([s["cnt"][i] for s in samples])).float()
                for i in range(4)]
    return lc, t, params_from_numpy(params, device="cpu")


def _fin_j(params, tag):
    return {"mix": params[f"mix_{tag}"], "ln": params[f"ln_{tag}"]}


def _bias_rows(ln_bias):
    """The finalize of a fully masked row: the 0e bias, zeros elsewhere (the
    0e slot comes first in the ladder)."""
    out = np.zeros(TL.make_conv_spec(IN, SH, OUT).out.dim, np.float32)
    out[: ln_bias.shape[0]] = ln_bias
    return out


def test_pair_fin_plain_matches_jax_twin(system):
    cs, samples, params = system
    lc, t, p = _port(system)
    zero = torch.zeros_like(t["lig_mask"])
    got = TC.pair_conv_fin_plain(
        lc.lig, lc.fin, t["lig_pos"], t["lig_pos"], t["lig_cm"], t["lig_cm"], t["lig_mask"],
        t["lig_mask"], zero, zero, t["temb"], LIG_CUT,
        {**TC.pair_params(p["emb_lig"], p["fc_lig"]), **_fin_j(p, "lig")},
        t["bond_feat"], t["bond_mask"], t["cnt"][0]).numpy()
    twin = PC.make_pair_twin(cs.dw, din=cs.dw.in1.dim, ns=NS, sed=SED, gs_stop=LIG_CUT, gs_n=GSN,
                             edge_extra=EDIM, exclude_self=True, cab_on_src=True, fin=cs)
    zl = np.zeros(NL, np.float32)
    for b, s in enumerate(samples):
        want = np.asarray(twin(s["lig_pos"], s["lig_pos"], s["lig_cm"], s["lig_cm"],
                               s["lig_mask"], s["lig_mask"], zl, zl, s["temb"], LIG_CUT,
                               {**TC.pair_params(params["emb_lig"], params["fc_lig"]),
                                **_fin_j(params, "lig")}, s["bond_feat"],
                               s["bond_mask"], cnt=s["cnt"][0]))
        assert _rel(got[b], want) <= TOL
        bias = _bias_rows(params["ln_lig"]["bias"])
        np.testing.assert_allclose(got[b, 3], bias, atol=1e-7)
        np.testing.assert_allclose(want[3], bias, atol=1e-7)


def test_cross_fin_plain_matches_jax_twin(system):
    cs, samples, params = system
    lc, t, p = _port(system)
    al, la = TC.cross_conv_fin_plain(
        lc.cross, lc.fin, t["lig_pos"], t["atm_pos"], t["lig_cm"], t["atm_cm"], t["lig_mask"],
        t["atm_mask"], t["cab"], t["temb"], t["cut"], p["emb_cross"], p["fc_al"], p["fc_la"],
        _fin_j(p, "al"), _fin_j(p, "la"), t["cnt"][1], t["cnt"][2])
    twin = PC.make_cross_twin(cs.dw, din=cs.dw.in1.dim, ns=NS, sed=SED, gs_stop=CROSS_CUT,
                              gs_n=GSN, fin=cs)
    for b, s in enumerate(samples):
        al_j, la_j = twin(s["lig_pos"], s["atm_pos"], s["lig_cm"], s["atm_cm"], s["lig_mask"],
                          s["atm_mask"], s["cab"], s["temb"], s["cut"], params["emb_cross"],
                          params["fc_al"], params["fc_la"], fin_al=_fin_j(params, "al"),
                          fin_la=_fin_j(params, "la"), cnt_al=s["cnt"][1], cnt_la=s["cnt"][2])
        assert _rel(al[b].numpy(), al_j) <= TOL and _rel(la[b].numpy(), la_j) <= TOL
        np.testing.assert_allclose(al[b, 3].numpy(), _bias_rows(params["ln_al"]["bias"]),
                                   atol=1e-7)
        np.testing.assert_allclose(la[b, 5].numpy(), _bias_rows(params["ln_la"]["bias"]),
                                   atol=1e-7)


def test_knn_fin_plain_matches_jax_twin(system):
    cs, samples, params = system
    lc, t, p = _port(system)
    got = TC.knn_conv_fin_plain(
        lc.atom, lc.fin, t["atm_pos"], t["atm_cm"], t["atm_mask"], t["idx"], t["valid"],
        t["temb"], {"emb": p["emb_atom"], "fc": p["fc_atom"], **_fin_j(p, "atom")}).numpy()
    twin = PC.make_knn_twin(cs.dw, din=cs.dw.in1.dim, ns=NS, sed=SED, gs_stop=ATOM_CUT, gs_n=GSN,
                            k=K, fin=cs)
    for b, s in enumerate(samples):
        want = np.asarray(twin(s["atm_pos"], s["atm_cm"], s["atm_mask"], s["idx"], s["valid"],
                               s["temb"], {"emb": params["emb_atom"], "fc": params["fc_atom"],
                                           **_fin_j(params, "atom")}))
        assert _rel(got[b], want) <= TOL
        np.testing.assert_allclose(got[b, 5], _bias_rows(params["ln_atom"]["bias"]), atol=1e-7)


def test_layer_plain_matches_jax_layer_twin(system):
    cs, samples, params = system
    lc, t, p = _port(system)
    assert lc.fin.out_dim > lc.lig.din
    lig, atm = LC.layer_conv_plain(
        lc, t["lig_pos"], t["atm_pos"], t["lig_cm"], t["atm_cm"], t["lig_mask"], t["atm_mask"],
        t["cab"], t["temb"], t["cut"], t["bond_feat"], t["bond_mask"], t["idx"], t["valid"],
        *t["cnt"], p)
    layer = PL.make_layer_conv(cs, din=cs.dw.in1.dim, ns=NS, sed=SED, lig_gs_stop=LIG_CUT,
                               cross_gs_stop=CROSS_CUT, atom_gs_stop=ATOM_CUT, gs_n=GSN,
                               lig_edge_dim=EDIM, k=K, interpret=True)
    for b, s in enumerate(samples):
        lig_j, atm_j = layer.twin(s["lig_pos"], s["atm_pos"], s["lig_cm"], s["atm_cm"],
                                  s["lig_mask"], s["atm_mask"], s["cab"], s["temb"], s["cut"],
                                  s["bond_feat"], s["bond_mask"], s["idx"], s["valid"],
                                  *s["cnt"], params)
        assert _rel(lig[b].numpy(), lig_j) <= TOL and _rel(atm[b].numpy(), atm_j) <= TOL
        # the masked ligand row: residual + the two 0e biases
        want = (np.pad(s["lig_cm"][3], (0, lc.fin.out_dim - lc.lig.din))
                + _bias_rows(params["ln_lig"]["bias"]) + _bias_rows(params["ln_al"]["bias"]))
        np.testing.assert_allclose(lig[b, 3].numpy(), want, atol=1e-6)


def test_fin_tables_reproduce_the_dense_mix_and_ln_slots(system):
    """FinConsts' block-sparse tables against the JAX package's dense mix
    matrix (dense_mix_cm) and LayerNorm slot table (ln_tables)."""
    cs, _, params = system
    fin = TC.FinConsts(TL.make_conv_spec(IN, SH, OUT))
    meta, slots = fin.tables
    w = params["mix_al"]
    dense = np.asarray(PC.dense_mix_cm(cs.lin, jnp.asarray(w)))
    ours = np.zeros_like(dense)
    for j, row in enumerate(meta):
        for sg in range(row[0]):
            base, m, wb = row[2 + 3 * sg : 5 + 3 * sg]
            ours[base : base + m, j] = w[wb + np.arange(m) * row[1]]
    np.testing.assert_array_equal(ours, dense)
    jslots, n_w, n_b = PC.ln_tables(cs.out)
    assert (n_w, n_b) == (fin.n_w, fin.n_b)
    for s, js in zip(slots, jslots):
        assert tuple(s[:5]) == (js["off"], js["mul"], js["d"], js["iw"], js["ib"])


@pytest.fixture(scope="module")
def net():
    cfg = tsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2)
    params = tsn.init_params(torch.Generator().manual_seed(0), cfg)
    batch = to_device(stack_samples([_load_sample_npz(SAMPLE)]), "cpu")
    t = torch.tensor([0.6])
    sched = {"tr_sigma_min": 0.1, "tr_sigma_max": 6.0, "rot_sigma_min": 0.03,
             "rot_sigma_max": 1.55, "tor_sigma_min": 0.0314, "tor_sigma_max": 3.14,
             "sc_tor_sigma_min": 0.0314, "sc_tor_sigma_max": 3.14}
    # unit output scales: no SO(3) / torus tables needed (building them costs minutes)
    ones = torch.ones(1)
    return cfg, params, batch, t, tsn.sigmas_from_t(t, sched), tsn.SigmaScales(ones, ones, ones)


@pytest.mark.parametrize("fields, use_kernels, called", [
    (dict(fused_epilogue=True, fused_layer=True), True, "pair_conv"),  # cmt ignores both
    (dict(pallas_layout="rowmajor"), True, "pair_conv"),
    (dict(pallas_layout="rowmajor", fused_epilogue=True), True, "pair_conv_fin"),
    (dict(pallas_layout="rowmajor", fused_epilogue=True, fused_layer=True), True, "layer_conv"),
    (dict(pallas_layout="rowmajor", fused_layer=True), False, None),  # plain path
])
def test_score_net_dispatches_the_kernel_configuration(net, monkeypatch, fields, use_kernels,
                                                       called):
    cfg, params, batch, t, sig, scales = net
    calls = []
    for mod, name in ((TC, "pair_conv"), (TC, "pair_conv_fin"), (LC, "layer_conv")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n)
                            or _fn(*a, **k))
    with torch.no_grad():
        out = tsn.apply(params, dataclasses.replace(cfg, **fields), batch, t, sig,
                        use_kernels=use_kernels, scales=scales)
    assert all(np.isfinite(getattr(out, f).numpy()).all() for f in out._fields)
    assert calls == ([called] * cfg.num_conv_layers if called else [])


def test_unknown_layout_is_refused_only_on_the_kernel_path(net):
    cfg, params, batch, t, sig, scales = net
    bad = dataclasses.replace(cfg, pallas_layout="colmajor")
    with pytest.raises(ValueError):
        bad.kernel_mode
    with torch.no_grad():
        tsn.apply(params, bad, batch, t, sig, use_kernels=False, scales=scales)


def test_wrappers_use_plain_versions_on_cpu(system):
    """On CPU tensors the B7-B10 wrappers are their plain versions and
    count no launch."""
    lc, t, p = _port(system)
    TC.reset_launches()
    args = (lc, t["lig_pos"], t["atm_pos"], t["lig_cm"], t["atm_cm"], t["lig_mask"],
            t["atm_mask"], t["cab"], t["temb"], t["cut"], t["bond_feat"], t["bond_mask"],
            t["idx"], t["valid"], *t["cnt"], p)
    for a, b in zip(LC.layer_conv(*args), LC.layer_conv_plain(*args)):
        assert torch.equal(a, b)
    kargs = (lc.atom, lc.fin, t["atm_pos"], t["atm_cm"], t["atm_mask"], t["idx"], t["valid"],
             t["temb"], {"emb": p["emb_atom"], "fc": p["fc_atom"], **_fin_j(p, "atom")})
    assert torch.equal(TC.knn_conv_fin(*kargs), TC.knn_conv_fin_plain(*kargs))
    assert all(v == 0 for v in TC.launches.values())
