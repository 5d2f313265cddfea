"""DG-lite multi-conformer embedding (the ETKDG analogue), the port's copy of
diffbindfr_tpu/chem/embed.py.

Conformers are regenerated from topology and the stereo assignment alone,
so docking never starts from the input (often crystal) geometry: 1-2 and
1-3 target distances, planarity of aromatic/sp2 rings and stereo double
bonds, chiral signed volumes and E/Z 1-4 distances copied from the input
assignment, vdW lower bounds on pairs at graph distance >= 3. Classical-MDS
starts (numpy, the JAX package's code: the same seed gives the same starts,
bit for bit) are refined by two phases of Adam on the restraint loss, a
batch of conformers at once, in PyTorch on `device` (on the card each
phase's update is captured once as a CUDA graph and replayed, since the
~100 small kernels of an update launched from the host would set the
pace); conformers that fail the quality filter are dropped and the batch
redrawn. On the card an embedding holds CARD_LOCK through its card work:
while a capture is open, work that another thread sends to the card's
legacy default stream invalidates it (CUDA's stream-capture rules), so a
thread that does card work beside embeddings (serve's dock worker, whose
handler threads embed) holds the lock around that work.

The host half (build_restraints, _distance_bounds, _mds_init) is numpy, and
torch is imported only inside embed_conformers, so host prep stays without
torch when it embeds nothing.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np

from .records import LigandRecord

_VDW = {
    "H": 1.1, "C": 1.7, "N": 1.55, "O": 1.52, "F": 1.47, "P": 1.8,
    "S": 1.8, "Cl": 1.75, "Br": 1.85, "I": 1.98, "B": 1.92, "Si": 2.1,
}
# the two refinement phases: (non-bonded weight, initial learning rate); the
# first untangles the MDS start without the vdW hinge, the second adds it
PHASES = ((0.02, 0.08), (2.0, 0.03))
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# held by embed_conformers through its card work on a CUDA device, and by
# any thread that does card work beside it
CARD_LOCK = threading.Lock()


class EmbedRestraints(NamedTuple):
    """Host-built static restraint tables for one ligand."""

    pair_idx: np.ndarray  # [P, 2] 1-2 and 1-3 pairs
    pair_target: np.ndarray  # [P]
    nb_mask: np.ndarray  # [A, A] graph distance >= 3
    lower: np.ndarray  # [A, A] lower bounds for nb pairs
    planar_quads: np.ndarray  # [Q, 4] signed volume -> 0
    chiral_quads: np.ndarray  # [S, 4] center + 3 neighbors
    chiral_sign: np.ndarray  # [S] sign of input signed volume
    ez_pairs: np.ndarray  # [Z, 2] substituent pairs across double bonds
    ez_target: np.ndarray  # [Z] input 1-4 distance (cis short / trans long)


def build_restraints(lig: LigandRecord) -> EmbedRestraints:
    from ..app.validity import (_graph_distance_ge3, _neighbor_lists,
                                _sp2_rings, _stereo_double_bonds)

    na = lig.num_atoms
    pos0 = lig.pos - lig.pos.mean(0)
    bonds = lig.bonds
    nbrs = _neighbor_lists(bonds, na)

    # 1-2 + 1-3 pairs with targets from the input conformer (these encode
    # element/hybridization-typical geometry, not the pose)
    pairs, targets = [], []
    for a, b in map(tuple, bonds):
        pairs.append((a, b))
        targets.append(np.linalg.norm(pos0[a] - pos0[b]))
    for j, ns in nbrs.items():
        for x in range(len(ns)):
            for y in range(x + 1, len(ns)):
                a, b = ns[x], ns[y]
                pairs.append((a, b))
                targets.append(np.linalg.norm(pos0[a] - pos0[b]))

    nb_mask = _graph_distance_ge3(bonds, na)
    radii = np.array([_VDW.get(e, 1.7) for e in lig.elements], np.float32)
    lower = 0.75 * (radii[:, None] + radii[None, :])

    # planarity: aromatic rings (consecutive quadruples) + stereo double
    # bonds (the two substituent quadruples)
    quads = []
    for ring in _sp2_rings(lig):
        n = len(ring)
        for k in range(n):
            quads.append([ring[k], ring[(k + 1) % n], ring[(k + 2) % n],
                          ring[(k + 3) % n]])
    stereo = _stereo_double_bonds(lig)
    for a, b, sa, sb, saa, sbb in stereo:
        quads.append([sa, a, b, sb])

    # chirality: atoms with >= 3 heavy neighbors keep their input signed
    # volume's sign (stereo assignment, not geometry)
    cquads, csigns = [], []
    for j, ns in nbrs.items():
        if len(ns) < 3:
            continue
        ns3 = sorted(ns)[:3]
        v = np.dot(
            np.cross(pos0[ns3[0]] - pos0[j], pos0[ns3[1]] - pos0[j]),
            pos0[ns3[2]] - pos0[j],
        )
        if abs(v) < 0.25:  # effectively planar center (sp2) — skip
            continue
        cquads.append([j] + ns3)
        csigns.append(np.sign(v))

    # E/Z: 1-4 distance across each stereo double bond for EVERY
    # substituent pair (fixes the full cis/trans pattern)
    ez_p, ez_t = [], []
    for a, b, sa, sb, saa, sbb in stereo:
        for x in saa:
            for y in sbb:
                ez_p.append((x, y))
                ez_t.append(np.linalg.norm(pos0[x] - pos0[y]))

    z = lambda n: np.zeros((0, n), np.int32)  # noqa: E731
    return EmbedRestraints(
        pair_idx=np.asarray(pairs, np.int32) if pairs else z(2),
        pair_target=np.asarray(targets, np.float32),
        nb_mask=nb_mask,
        lower=lower.astype(np.float32),
        planar_quads=np.asarray(quads, np.int32) if quads else z(4),
        chiral_quads=np.asarray(cquads, np.int32) if cquads else z(4),
        chiral_sign=np.asarray(csigns, np.float32),
        ez_pairs=np.asarray(ez_p, np.int32) if ez_p else z(2),
        ez_target=np.asarray(ez_t, np.float32),
    )


def _distance_bounds(lig: LigandRecord, r: EmbedRestraints):
    """Classic DG bounds: upper = shortest bond-path sum, lower = vdW (or
    the exact 1-2/1-3 target). [A, A] (lo, hi) float64."""
    na = lig.num_atoms
    inf = 1e6
    hi = np.full((na, na), inf)
    np.fill_diagonal(hi, 0.0)
    for (a, b), t in zip(r.pair_idx, r.pair_target):
        hi[a, b] = hi[b, a] = min(hi[a, b], t)
    # Floyd-Warshall on the 1-2/1-3 skeleton
    for k in range(na):
        hi = np.minimum(hi, hi[:, k, None] + hi[None, k, :])
    lo = r.lower.astype(np.float64).copy()
    for (a, b), t in zip(r.pair_idx, r.pair_target):
        lo[a, b] = lo[b, a] = t
        hi[a, b] = hi[b, a] = t
    np.fill_diagonal(lo, 0.0)
    return lo, np.minimum(np.maximum(hi, lo), 40.0)


def _mds_init(lo, hi, rng):
    """Random-distance-matrix metric embedding (the classic DG move that
    ETKDG refines): sample D within bounds, double-center, take the top-3
    eigenvectors of the Gram matrix."""
    na = lo.shape[0]
    # bias long-range distances toward the upper (extended) bound: compact
    # random matrices embed as interlocked tangles the refiner cannot undo
    d = lo + (hi - lo) * np.sqrt(rng.random((na, na)))
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    d2 = d**2
    j = np.eye(na) - np.ones((na, na)) / na
    g = -0.5 * j @ d2 @ j
    w, v = np.linalg.eigh(g)
    idx = np.argsort(w)[::-1][:3]
    return (v[:, idx] * np.sqrt(np.maximum(w[idx], 1e-6))).astype(np.float32)


def mirrored_inits(inits: np.ndarray, r: EmbedRestraints) -> np.ndarray:
    """Hand every init the input handedness before refinement: mirror z
    when the first defined stereo center disagrees (the hinge restraint
    then only fine-tunes, never flips through planarity). In place."""
    if r.chiral_quads.shape[0]:
        q = r.chiral_quads[0]
        s0 = r.chiral_sign[0]
        for i in range(inits.shape[0]):
            p = inits[i]
            v = np.dot(np.cross(p[q[1]] - p[q[0]], p[q[2]] - p[q[0]]),
                       p[q[3]] - p[q[0]])
            if np.sign(v) != s0:
                inits[i, :, 2] *= -1.0
    return inits


# ---------------------------------------------------------------------------
# the refinement, in PyTorch on a batch of conformers [N, A, 3]
# ---------------------------------------------------------------------------


def restraint_tensors(r: EmbedRestraints, device):
    """The restraint tables as tensors on `device` (index arrays int64)."""
    import torch

    out = {}
    for k, v in r._asdict().items():
        dt = torch.int64 if v.dtype.kind in "iu" else (
            torch.bool if v.dtype == bool else torch.float32)
        out[k] = torch.as_tensor(np.asarray(v), dtype=dt, device=device)
    return out


def _vol(pos, quad):
    import torch

    p0, p1, p2, p3 = (pos[:, quad[:, k]] for k in range(4))
    return (torch.cross(p1 - p0, p2 - p0, dim=-1) * (p3 - p0)).sum(-1)


def _dist(pos, pairs):
    import torch

    return torch.linalg.norm(pos[:, pairs[:, 0]] - pos[:, pairs[:, 1]] + 1e-9, dim=-1)


def restraint_terms(pos, t, w_nb: float) -> dict:
    """Each weighted term of the JAX package's restraint loss, per
    conformer [N], for pos [N, A, 3] and the tables `t`
    (restraint_tensors); an empty table's term is absent."""
    import torch

    terms = {}
    if t["pair_idx"].shape[0]:
        terms["pairs"] = 30.0 * ((_dist(pos, t["pair_idx"]) - t["pair_target"]) ** 2).sum(-1)
    dall = torch.linalg.norm(pos[:, :, None, :] - pos[:, None, :, :] + 1e-9, dim=-1)
    hinge = torch.clamp(t["lower"] - dall, min=0.0) ** 2
    terms["nonbonded"] = w_nb * torch.where(t["nb_mask"], hinge, torch.zeros_like(hinge)).sum(
        dim=(1, 2))
    if t["planar_quads"].shape[0]:
        terms["planar"] = 3.0 * (_vol(pos, t["planar_quads"]) ** 2).sum(-1)
    if t["chiral_quads"].shape[0]:
        # hinge: keep the signed volume on the input side with margin
        terms["chiral"] = 6.0 * (torch.clamp(
            0.5 - t["chiral_sign"] * _vol(pos, t["chiral_quads"]), min=0.0) ** 2).sum(-1)
    if t["ez_pairs"].shape[0]:
        terms["ez"] = 10.0 * ((_dist(pos, t["ez_pairs"]) - t["ez_target"]) ** 2).sum(-1)
    return terms


def restraint_loss(pos, t, w_nb: float):
    """The restraint loss per conformer [N], its terms summed in the JAX
    package's order."""
    e = 0.0
    for v in restraint_terms(pos, t, w_nb).values():
        e = e + v
    return e


def adam_scalars(count: int, n: int, lr0: float):
    """(learning rate, 1 - b1^t, 1 - b2^t) of optax's adam over
    cosine_decay_schedule(lr0, n) at update `count` (t = count + 1), in
    float32 as the JAX package computes them."""
    f = np.float32
    c = f(min(count, n))
    lr = f(lr0) * (f(0.5) * (f(1.0) + np.cos(f(np.pi) * c / f(n))))
    t = f(count + 1)
    return float(lr), float(f(1.0) - f(ADAM_B1) ** t), float(f(1.0) - f(ADAM_B2) ** t)


def adam_step(pos, mu, nu, count: int, t, w_nb: float, n: int, lr0: float):
    """One update of optax.adam(cosine_decay_schedule(lr0, n)) on the
    restraint loss: returns (pos, mu, nu, per-conformer loss before it)."""
    import torch

    x = pos.detach().requires_grad_(True)
    loss = restraint_loss(x, t, w_nb)
    (g,) = torch.autograd.grad(loss.sum(), x)
    lr, c1, c2 = adam_scalars(count, n, lr0)
    mu = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
    nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu
    update = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
    return pos + (-lr) * update, mu, nu, loss.detach()


def _graphed_phase(pos, t, w_nb: float, n: int, lr0: float):
    """n updates of adam_step from a fresh Adam state, as one CUDA graph of
    an update replayed n times: the same kernels as the eager loop, the
    update's learning rate and bias corrections read from a device table
    (adam_scalars) at a device counter. The eager loop launches ~100 small
    kernels an update from the host, which sets its pace. No other thread
    may use the card meanwhile (embed_conformers holds CARD_LOCK)."""
    import torch

    dev = pos.device
    table = torch.tensor([adam_scalars(c, n, lr0) for c in range(n)], dtype=torch.float32,
                         device=dev)
    x, mu, nu = pos.clone(), torch.zeros_like(pos), torch.zeros_like(pos)
    k = torch.zeros(1, dtype=torch.int64, device=dev)

    def update():
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(restraint_loss(xg, t, w_nb).sum(), xg)
        lr, c1, c2 = torch.index_select(table, 0, k)[0].unbind(0)
        m = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
        v = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu
        x.copy_(x + (-lr) * ((m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)))
        mu.copy_(m)
        nu.copy_(v)
        k.add_(1)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm-up before the capture, then reset
        update()
    torch.cuda.current_stream(dev).wait_stream(side)
    x.copy_(pos)
    mu.zero_()
    nu.zero_()
    k.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        update()
    for _ in range(n):
        graph.replay()
    return x


def refine(inits: np.ndarray, t, steps: int, device, graph: bool | None = None):
    """Both phases of `steps` Adam updates from inits [N, A, 3] (each
    phase from a fresh Adam state): (conformers centred [N, A, 3], loss
    at w_nb 2.0 [N]) as numpy. `graph` (default: on a CUDA device) replays
    each phase's update as a CUDA graph (_graphed_phase), else the updates
    run eagerly."""
    import torch

    pos = torch.as_tensor(inits, dtype=torch.float32, device=device)
    if graph is None:
        graph = pos.device.type == "cuda"
    for w_nb, lr0 in PHASES:
        if graph:
            pos = _graphed_phase(pos, t, w_nb, steps, lr0)
            continue
        mu, nu = torch.zeros_like(pos), torch.zeros_like(pos)
        for count in range(steps):
            pos, mu, nu, _ = adam_step(pos, mu, nu, count, t, w_nb, steps, lr0)
    with torch.no_grad():
        loss = restraint_loss(pos, t, PHASES[-1][0])
    pos = pos - pos.mean(dim=1, keepdim=True)
    return pos.cpu().numpy(), loss.cpu().numpy()


def conformer_ok(c: np.ndarray, lig: LigandRecord, r: EmbedRestraints) -> bool:
    """The JAX package's quality filter: every bond within 8% of its input
    length and every non-bonded pair (graph distance >= 3) above 1.9 A."""
    bonds = lig.bonds
    blen0 = np.linalg.norm((lig.pos[bonds[:, 0]] - lig.pos[bonds[:, 1]]), axis=-1)
    blen = np.linalg.norm(c[bonds[:, 0]] - c[bonds[:, 1]], axis=-1)
    if np.max(np.abs(blen - blen0) / blen0) > 0.08:
        return False
    d = np.linalg.norm(c[:, None] - c[None, :] + 1e-9, axis=-1)
    return bool(d[r.nb_mask].min() > 1.9) if r.nb_mask.any() else True


def embed_conformers(
    lig: LigandRecord,
    n_conf: int,
    seed: int = 0,
    steps: int = 500,
    lr: float = 0.02,
    device="cuda",
) -> np.ndarray:
    """[n_conf, A, 3] embedded conformers (float32), centred, sorted by
    restraint loss (best first). Up to 4 rounds: a round draws 2 x (still
    needed) MDS starts from the numpy rng of `seed`, refines them on
    `device` (the card unless the caller asks for the CPU) and keeps those
    that pass conformer_ok; if fewer than n_conf pass, the lowest-loss of
    the rest fill up. On a CUDA device the card work runs under CARD_LOCK.
    `lr` is accepted and unused, as in the JAX package."""
    from contextlib import nullcontext

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    r = build_restraints(lig)
    rng = np.random.default_rng(seed)
    lo, hi = _distance_bounds(lig, r)

    def batch(n_try):
        inits = mirrored_inits(np.stack([_mds_init(lo, hi, rng) for _ in range(n_try)]), r)
        with CARD_LOCK if dev.type == "cuda" else nullcontext():
            return refine(inits, restraint_tensors(r, dev), steps, dev)

    # MDS inits occasionally land in interlocked basins the refiner cannot
    # undo; quality-filter and resample until n_conf pass (bounded retries)
    good: list = []
    fallback: list = []
    for _ in range(4):
        need = n_conf - len(good)
        if need <= 0:
            break
        pos, losses = batch(2 * need)
        order = np.argsort(np.asarray(losses))
        for i in order:
            c = np.asarray(pos[i])
            fallback.append((float(losses[i]), c))
            if conformer_ok(c, lig, r) and len(good) < n_conf:
                good.append(c)
    if len(good) < n_conf:
        fallback.sort(key=lambda x: x[0])
        for _, c in fallback:
            if len(good) >= n_conf:
                break
            if not any(c is g for g in good):
                good.append(c)
    return np.stack(good[:n_conf])
