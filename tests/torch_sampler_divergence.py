"""Why the port's and the JAX package's free-running samplers part on short
grids: prints, per grid (inference_steps/actual_steps) and complex, the
largest difference of the final poses between the packages (ligand and
atom14 in A, chi in rad), the JAX sampler's own spread when its weights are
moved up by one ulp, and the first step whose input graphs differ between
the two packages' states, with the length of the first edge that differs
and, for the atom graph, the distances of its query atom's k-th and
(k+1)-th neighbours (the atom itself is the 0-th): an edge crosses the
cutoff, or two neighbours swap ranks at k.

The set-up is tests/test_torch_predict.py's: the small net (ns=8, nv=4, 2
layers) with the fixture's weights, BSZ copies each of 3dbs and 3mhw, the
JAX noise replayed into the port. Runs on the CPU in a few minutes:

    JAX_PLATFORMS=cpu python tests/torch_sampler_divergence.py [sde|ode ...]
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_predict as T  # noqa: E402
from diffbindfr_tpu import sampler as JSP  # noqa: E402
from diffbindfr_tpu.app import jobs as JJ  # noqa: E402
from diffbindfr_tpu.app import pipeline as JP  # noqa: E402
from diffbindfr_tpu.geometry import so3 as JSO3  # noqa: E402
from diffbindfr_tpu.geometry import torus as JTOR  # noqa: E402
from diffbindfr_tpu.models import score_net as jsn  # noqa: E402
from diffbindfr_torch import sampler as TSP  # noqa: E402
from diffbindfr_torch.app import jobs as TJ  # noqa: E402
from diffbindfr_torch.app import pipeline as TP  # noqa: E402
from diffbindfr_torch.data.sample import stack_samples, to_device  # noqa: E402
from diffbindfr_torch.geometry import so3 as TSO3  # noqa: E402
from diffbindfr_torch.geometry import torus as TTOR  # noqa: E402
from diffbindfr_torch.models import score_net as tsn  # noqa: E402
from diffbindfr_torch.nn import layers as L  # noqa: E402
from diffbindfr_torch.utils.checkpoint import load_checkpoint  # noqa: E402

GRIDS = ((22, 3), (12, 3), (8, 3), (5, 3), (5, 5), (22, 20))
BSZ = T.BSZ


def _graphs(b, lig, a14, cfg, tr_sigma):
    """Edge sets of the score net's graphs on a state, as score_net.apply
    builds them: ligand pairs within lig_cutoff, the atom graph (knn within
    atom_cutoff), the cross graph, and the two pseudotorque neighbour lists."""
    atm = TSP._pack_atoms(b, a14)
    out = {}
    ll = torch.linalg.norm(lig[:, None] - lig[:, :, None] + 1e-9, dim=-1)
    both = (b.lig_mask[:, :, None] * b.lig_mask[:, None, :]) > 0
    out["ligand"] = {tuple(e) for e in torch.nonzero((ll <= cfg.lig_cutoff) & both).tolist()}
    cl = torch.linalg.norm(atm[:, None] - lig[:, :, None] + 1e-9, dim=-1)
    both = (b.lig_mask[:, :, None] * b.atm_mask[:, None, :]) > 0
    out["cross"] = {tuple(e) for e in torch.nonzero(
        (cl <= (tr_sigma * 0.2 + 5.0)[:, None, None]) & both).tolist()}

    def knn(name, q, k, cutoff, qmask, kpos, kmask, **kw):
        idx, val = L.knn_edges(q, kpos, qmask, kmask, k=k, cutoff=cutoff, **kw)
        out[name] = {(i, j, int(idx[i, j, n])) for i, j, n in torch.nonzero(val).tolist()}

    knn("atom", atm, cfg.atom_knn, cfg.atom_cutoff, b.atm_mask, atm, b.atm_mask,
        exclude_self=True)
    g = lambda p, ix: torch.gather(p, 1, ix[..., None].expand(-1, -1, 3))  # noqa: E731
    src, dst = b.sc_src.reshape(BSZ, -1), b.sc_dst.reshape(BSZ, -1)
    knn("side-chain torsion", 0.5 * (g(atm, src) + g(atm, dst)), 24, cfg.atom_cutoff,
        b.chi_mask.reshape(BSZ, -1), atm, b.atm_mask)
    knn("ligand torsion", 0.5 * (g(lig, b.tor_src) + g(lig, b.tor_dst)),
        min(32, lig.shape[1]), cfg.lig_cutoff, b.tor_mask, lig, b.lig_mask)
    return out, atm


def main(kinds):
    torch.set_num_threads(4)
    TSO3.set_tables(TSO3.SO3Tables.from_numpy("cpu", **JSO3.tables()._asdict()))
    tt = JTOR.tables()
    TTOR.set_tables(TTOR.TorusTables.from_numpy("cpu", score=tt.score, score_norm=tt.score_norm))
    with tempfile.TemporaryDirectory() as tmp:
        jobs_csv = T._write_jobs(os.path.join(tmp, "jobs.csv"), T.NAMES)
        tpairs, _ = TP.prep(TJ.load_jobs_csv(jobs_csv), 12.0, cache_dir=T.PREP, verbose=False)
        jpairs, _ = JP.prep(JJ.load_jobs_csv(jobs_csv), 12.0, cache_dir=T.PREP, verbose=False)
    tp, _ = load_checkpoint(T.FIXTURE, use_ema=False, device="cpu")
    jcfg = jsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2, dropout=0.0)
    jp = jsn.init_params(jax.random.PRNGKey(0), jcfg)
    jp_ulp = jax.tree.map(lambda x: jnp.nextafter(x, jnp.inf) if x.dtype == jnp.float32 else x,
                          jp)
    for kind in kinds:
        for inf, act in GRIDS:
            jscfg = JSP.SamplerConfig(kind=kind, inference_steps=inf, actual_steps=act)
            tscfg = TSP.SamplerConfig(kind=kind, inference_steps=inf, actual_steps=act)
            for pi, name in enumerate(T.NAMES):
                key = jax.random.PRNGKey(20 + pi)
                jb = jax.tree.map(lambda x: jnp.asarray(np.stack([x] * BSZ)), jpairs[pi].sample)
                jr = JSP.sample(jp, jcfg, jscfg, jb, key, keep_trajectory=True)
                ju = JSP.sample(jp_ulp, jcfg, jscfg, jb, key)
                s = tpairs[pi].sample
                b = to_device(stack_samples([s] * BSZ), "cpu")
                with torch.no_grad():
                    tr = TSP.sample(tp, T.TCFG, tscfg, b, T._replay_noise(key, s, jscfg),
                                    keep_trajectory=True)

                def gap(a, c):
                    pos = max(np.abs(np.asarray(a.lig_pos) - np.asarray(c.lig_pos)).max(),
                              np.abs(np.asarray(a.atom14_pos) - np.asarray(c.atom14_pos)).max())
                    return f"{pos:.3g} A / {np.abs(np.asarray(a.chi) - np.asarray(c.chi)).max():.3g} rad"

                line = (f"{kind} {inf}/{act} {name}: port-JAX {gap(tr, jr)}; "
                        f"JAX one-ulp weights {gap(ju, jr)}")
                ts = TSP.t_schedule(tscfg)
                for i in range(1, act):
                    trs = tsn.sigmas_from_t(ts[i], tscfg.schedule).tr.expand(BSZ)
                    gp, ap = _graphs(b, tr.lig_traj[i - 1], tr.atom14_traj[i - 1], T.TCFG, trs)
                    gj, aj = _graphs(b, torch.from_numpy(np.asarray(jr.lig_traj[i - 1])),
                                     torch.from_numpy(np.asarray(jr.atom14_traj[i - 1])),
                                     T.TCFG, trs)
                    diff = {g: sorted(gp[g] ^ gj[g]) for g in gp if gp[g] ^ gj[g]}
                    if diff:
                        g, (bb, q, j) = next(iter(diff.items()))[0], next(iter(diff.values()))[0]
                        state = max(np.abs(np.asarray(jr.lig_traj[i - 1])
                                           - tr.lig_traj[i - 1].numpy()).max(),
                                    np.abs(np.asarray(jr.atom14_traj[i - 1])
                                           - tr.atom14_traj[i - 1].numpy()).max())
                        ln = ""
                        if g == "atom":  # the edge's length and the k-th, (k+1)-th neighbours'
                            k = T.TCFG.atom_knn
                            for who, a in (("port", ap), ("JAX", aj)):
                                d = (a[bb] - a[bb, q]).norm(dim=-1) + (1 - b.atm_mask[bb]) * 1e9
                                near = torch.sort(d)[0]
                                ln += (f", {who} |x{q}-x{j}| {float(d[j]):.6f} A (neighbours {k}, "
                                       f"{k + 1} at {float(near[k]):.6f}, {float(near[k + 1]):.6f})")
                            ln += f"; cutoff {T.TCFG.atom_cutoff}"
                        line += (f"; graphs first differ at the input of step {i} (states "
                                 f"{state:.3g} A apart): {g} edge {(bb, q, j)}{ln}")
                        break
                print(line, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["sde", "ode"])
