"""AutoDock-Vina-style scoring and the batched pose minimizer of the error
correction stage (counterpart of diffbindfr_tpu/ops/vina.py, the rigid
receptor path that `predict` runs).

The typed receptor and ligand are built on the host in numpy
(`build_receptor`, `build_ligand`: the same arrays as the JAX package's
builders, bit for bit); the energies and the minimizer are batched PyTorch
on tensors with a leading batch axis B. Scoring terms (Trott & Olson 2010):

    gauss1      exp(-(d/0.5)^2)                       w = -0.035579
    gauss2      exp(-((d-3)/2)^2)                     w = -0.005156
    repulsion   d^2 for d < 0                         w = +0.840245
    hydrophobic ramp 1->0 over d in [0.5, 1.5]        w = -0.035069
    h-bond      ramp 1->0 over d in [-0.7, 0]         w = -0.587439

with d the surface distance (pair distance minus vdW radii), an 8 A cutoff,
and affinity = E_inter / (1 + 0.05846 * N_rot).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import ligands as lc
from ..constants import residues as rc
from ..geometry.torsion import pose_transform

W_GAUSS1 = -0.035579
W_GAUSS2 = -0.005156
W_REPULSION = 0.840245
W_HYDROPHOBIC = -0.035069
W_HBOND = -0.587439
W_NROT = 0.05846
CUTOFF = 8.0

# X-Score vdW radii by element
_RADII = {
    "C": 1.9, "N": 1.8, "O": 1.7, "S": 2.0, "P": 2.1,
    "F": 1.5, "Cl": 1.8, "Br": 2.0, "I": 2.2, "H": 1.0,
}
_DEFAULT_RADIUS = 1.9

# residue-internal heavy-atom bonds, for the Vina carbon rule (a carbon is
# hydrophobic iff it has no heteroatom neighbour)
_BACKBONE_BONDS = [("N", "CA"), ("CA", "C"), ("C", "O"), ("CA", "CB")]
_SIDECHAIN_BONDS = {
    "ALA": [],
    "ARG": [("CB", "CG"), ("CG", "CD"), ("CD", "NE"), ("NE", "CZ"),
            ("CZ", "NH1"), ("CZ", "NH2")],
    "ASN": [("CB", "CG"), ("CG", "OD1"), ("CG", "ND2")],
    "ASP": [("CB", "CG"), ("CG", "OD1"), ("CG", "OD2")],
    "CYS": [("CB", "SG")],
    "GLN": [("CB", "CG"), ("CG", "CD"), ("CD", "OE1"), ("CD", "NE2")],
    "GLU": [("CB", "CG"), ("CG", "CD"), ("CD", "OE1"), ("CD", "OE2")],
    "GLY": [],
    "HIS": [("CB", "CG"), ("CG", "ND1"), ("ND1", "CE1"), ("CE1", "NE2"),
            ("NE2", "CD2"), ("CD2", "CG")],
    "ILE": [("CB", "CG1"), ("CB", "CG2"), ("CG1", "CD1")],
    "LEU": [("CB", "CG"), ("CG", "CD1"), ("CG", "CD2")],
    "LYS": [("CB", "CG"), ("CG", "CD"), ("CD", "CE"), ("CE", "NZ")],
    "MET": [("CB", "CG"), ("CG", "SD"), ("SD", "CE")],
    "PHE": [("CB", "CG"), ("CG", "CD1"), ("CD1", "CE1"), ("CE1", "CZ"),
            ("CZ", "CE2"), ("CE2", "CD2"), ("CD2", "CG")],
    "PRO": [("CB", "CG"), ("CG", "CD"), ("CD", "N")],
    "SER": [("CB", "OG")],
    "THR": [("CB", "OG1"), ("CB", "CG2")],
    "TRP": [("CB", "CG"), ("CG", "CD1"), ("CD1", "NE1"), ("NE1", "CE2"),
            ("CE2", "CD2"), ("CD2", "CG"), ("CE2", "CZ2"), ("CZ2", "CH2"),
            ("CH2", "CZ3"), ("CZ3", "CE3"), ("CE3", "CD2")],
    "TYR": [("CB", "CG"), ("CG", "CD1"), ("CD1", "CE1"), ("CE1", "CZ"),
            ("CZ", "CE2"), ("CE2", "CD2"), ("CD2", "CG"), ("CZ", "OH")],
    "VAL": [("CB", "CG1"), ("CB", "CG2")],
}
_DONOR_ATOMS = {
    "*": {"N"},  # backbone amide
    "ARG": {"NE", "NH1", "NH2"},
    "ASN": {"ND2"},
    "GLN": {"NE2"},
    "HIS": {"ND1", "NE2"},
    "LYS": {"NZ"},
    "SER": {"OG"},
    "THR": {"OG1"},
    "TRP": {"NE1"},
    "TYR": {"OH"},
}
_ACCEPTOR_ATOMS = {
    "*": {"O"},  # backbone carbonyl
    "ASP": {"OD1", "OD2"},
    "GLU": {"OE1", "OE2"},
    "ASN": {"OD1"},
    "GLN": {"OE1"},
    "HIS": {"ND1", "NE2"},
    "SER": {"OG"},
    "THR": {"OG1"},
    "TYR": {"OH"},
}


def _protein_type_tables():
    """[21, 14] arrays: radius, hydrophobic, donor, acceptor."""
    radius = np.full((21, 14), _DEFAULT_RADIUS, np.float32)
    hydro = np.zeros((21, 14), np.float32)
    donor = np.zeros((21, 14), np.float32)
    accept = np.zeros((21, 14), np.float32)
    for res3, names in rc.restype_name_to_atom14_names.items():
        if res3 == "UNK":
            continue
        ri = rc.restype_order[rc.restype_3to1[res3]]
        bonds = _BACKBONE_BONDS + _SIDECHAIN_BONDS.get(res3, [])
        nbrs: dict = {}
        for a, b in bonds:
            nbrs.setdefault(a, set()).add(b)
            nbrs.setdefault(b, set()).add(a)
        for slot, name in enumerate(names):
            if not name:
                continue
            el = name[0]
            radius[ri, slot] = _RADII.get(el, _DEFAULT_RADIUS)
            if el == "C":
                het = any(n[0] in "NOS" for n in nbrs.get(name, ()))
                hydro[ri, slot] = 0.0 if het else 1.0
            if name in _DONOR_ATOMS.get(res3, set()) | _DONOR_ATOMS["*"]:
                donor[ri, slot] = 1.0
            if name in _ACCEPTOR_ATOMS.get(res3, set()) | _ACCEPTOR_ATOMS["*"]:
                accept[ri, slot] = 1.0
    return radius, hydro, donor, accept


_PTABLES = _protein_type_tables()


class VinaReceptor(NamedTuple):
    pos: object  # [NA, 3] (pocket frame)
    mask: object  # [NA]
    radius: object  # [NA]
    hydro: object
    donor: object
    acceptor: object
    hb_dir: object  # [NA, 3] donor-H / lone-pair axis (the angular H-bond term)
    hb_has: object  # [NA] 1 = direction defined


class VinaLigand(NamedTuple):
    radius: object  # [NL]
    hydro: object
    donor: object
    acceptor: object
    mask: object  # [NL]
    intra_mask: object  # [NL, NL] pairs >= 4 bonds apart
    tor_bonds: object  # [T, 2]
    rot_node_mask: object  # [T, NL]
    tor_mask: object  # [T]
    n_rot: object  # scalar
    bond_adj: object  # [NL, NL] covalent adjacency


# ---------------------------------------------------------------------------
# builders (host numpy)
# ---------------------------------------------------------------------------


def _res_local_dirs_np(pos14, mask14):
    """H-bond axes of [R, 14] receptor atoms from within-residue geometric
    bonds (d < 1.9 A): e_i = -mean of the unit bond vectors."""
    diff = pos14[:, None, :, :] - pos14[:, :, None, :]
    dn = np.linalg.norm(diff + 1e-9, axis=-1)
    eye = np.eye(pos14.shape[1], dtype=bool)[None]
    adj = ((dn < 1.9) & ~eye
           & (mask14[:, :, None] > 0) & (mask14[:, None, :] > 0))
    u = diff / np.maximum(dn[..., None], 1e-6)
    e_raw = -np.sum(adj[..., None] * u, axis=2)
    nrm = np.linalg.norm(e_raw + 1e-12, axis=-1, keepdims=True)
    has = ((np.sum(adj, axis=2) > 0) & (nrm[..., 0] > 0.2)).astype(
        np.float32)
    return (e_raw / np.maximum(nrm, 1e-6)).astype(np.float32), has


def build_receptor(pocket, pad_atoms: int) -> VinaReceptor:
    """Typed receptor (numpy) from the packed pocket atoms of a PocketRecord,
    pocket frame, padded to `pad_atoms`; implicit polar hydrogens."""
    exists = pocket.atom14_mask.astype(bool)
    ridx, aidx = np.nonzero(exists)
    rad, hyd, don, acc = _PTABLES
    aat = pocket.aatype

    def pack(tab):
        return np.pad(tab[aat][ridx, aidx], (0, pad_atoms - ridx.shape[0]))

    pos = pocket.atom14_pos.reshape(-1, 3)[ridx * 14 + aidx]
    pos = np.pad(pos, ((0, pad_atoms - ridx.shape[0]), (0, 0)))
    mask = np.zeros(pad_atoms, np.float32)
    mask[: ridx.shape[0]] = 1
    e14, has14 = _res_local_dirs_np(
        np.asarray(pocket.atom14_pos, np.float32),
        np.asarray(pocket.atom14_mask, np.float32))
    e14 = e14.reshape(-1, 3)[ridx * 14 + aidx]
    has14 = has14.reshape(-1)[ridx * 14 + aidx]
    return VinaReceptor(
        pos=np.asarray(pos, np.float32),
        mask=np.asarray(mask, np.float32),
        radius=np.asarray(pack(rad), np.float32),
        hydro=np.asarray(pack(hyd), np.float32),
        donor=np.asarray(pack(don), np.float32),
        acceptor=np.asarray(pack(acc), np.float32),
        hb_dir=np.asarray(
            np.pad(e14, ((0, pad_atoms - ridx.shape[0]), (0, 0))), np.float32),
        hb_has=np.asarray(
            np.pad(has14, (0, pad_atoms - ridx.shape[0])), np.float32),
    )


def _within_bonds(adj: np.ndarray, hops: int) -> np.ndarray:
    """[A, A] bool: atom pairs joined by a path of at most `hops` bonds
    (every atom reaches itself in 0)."""
    a = adj.astype(np.int64)
    reach = np.eye(adj.shape[0], dtype=bool)
    front = reach.astype(np.int64)
    for _ in range(hops):
        front = ((front @ a) > 0).astype(np.int64)
        reach |= front > 0
    return reach


def build_ligand(lig, pad_atoms: int, pad_tor: int) -> VinaLigand:
    """Typed ligand (numpy) from a LigandRecord, padded to `pad_atoms` atoms
    and `pad_tor` torsions."""
    na = lig.num_atoms
    els = lig.elements
    radius = np.array([_RADII.get(e, _DEFAULT_RADIUS) for e in els], np.float32)
    don_id = lc.pharmacophore_to_id["Donor"]
    acc_id = lc.pharmacophore_to_id["Acceptor"]
    # pharmacophore block sits at the tail of the 27-dim node features
    ph = lig.node_feat[:, -lc.num_pharmacophores :]
    donor = ph[:, don_id].astype(np.float32)
    acceptor = ph[:, acc_id].astype(np.float32)

    bond_graph = np.zeros((na, na), bool)
    for a, b in map(tuple, lig.bonds):
        if a != b:
            bond_graph[a, b] = bond_graph[b, a] = True
    hydro = np.zeros(na, np.float32)
    for i in range(na):
        if els[i] == "C" and not any(
            els[j] in ("N", "O", "S", "P") for j in np.nonzero(bond_graph[i])[0]
        ):
            hydro[i] = 1.0
    # intra pairs: topological distance >= 4 (Vina's movable-pair set)
    intra = np.where(_within_bonds(bond_graph, 3), 0.0, 1.0).astype(np.float32)

    t = lig.rot_node_mask.shape[0]
    pad = lambda a, n: np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))
    tor_bonds = np.stack(
        [
            lig.edge_index[0][lig.tor_edge_mask],
            lig.edge_index[1][lig.tor_edge_mask],
        ],
        axis=-1,
    ).astype(np.int32)
    rnm = pad(
        np.pad(lig.rot_node_mask.astype(np.float32), ((0, 0), (0, pad_atoms - na))),
        pad_tor,
    )
    mask = np.zeros(pad_atoms, np.float32)
    mask[:na] = 1
    intra_p = np.zeros((pad_atoms, pad_atoms), np.float32)
    intra_p[:na, :na] = intra
    tor_mask = np.zeros(pad_tor, np.float32)
    tor_mask[:t] = 1
    adj = np.zeros((pad_atoms, pad_atoms), np.float32)
    for a, b in map(tuple, lig.bonds):
        adj[a, b] = adj[b, a] = 1.0
    return VinaLigand(
        radius=np.pad(radius, (0, pad_atoms - na)),
        hydro=np.pad(hydro, (0, pad_atoms - na)),
        donor=np.pad(donor, (0, pad_atoms - na)),
        acceptor=np.pad(acceptor, (0, pad_atoms - na)),
        mask=mask,
        intra_mask=intra_p,
        tor_bonds=pad(tor_bonds, pad_tor),
        rot_node_mask=rnm.astype(np.float32),
        tor_mask=tor_mask,
        n_rot=np.float32(t),
        bond_adj=adj,
    )


def stack_to_device(items: list, device):
    """Host VinaLigands (or VinaReceptors) of one bucket -> one of tensors
    with a leading batch axis on `device` (index fields int64)."""
    out = []
    for vals in zip(*items):
        t = torch.as_tensor(np.stack([np.asarray(v) for v in vals]))
        t = t.to(torch.float32) if t.is_floating_point() else t.to(torch.int64)
        out.append(t.to(device))
    return type(items[0])(*out)


# ---------------------------------------------------------------------------
# energy (batched: positions [B, NL, 3], ligand and receptor fields [B, ...])
# ---------------------------------------------------------------------------


def _pair_terms(d_surf, hyd_i, hyd_j, don_i, acc_i, don_j, acc_j):
    gauss1 = torch.exp(-((d_surf / 0.5) ** 2))
    gauss2 = torch.exp(-(((d_surf - 3.0) / 2.0) ** 2))
    repulsion = torch.where(d_surf < 0, d_surf**2, 0.0)
    hydro = hyd_i * hyd_j * torch.clamp((1.5 - d_surf) / 1.0, 0.0, 1.0)
    hb_pair = don_i * acc_j + acc_i * don_j
    hbond = torch.clamp(hb_pair, max=1.0) * torch.clamp(-d_surf / 0.7, 0.0, 1.0)
    return (
        W_GAUSS1 * gauss1
        + W_GAUSS2 * gauss2
        + W_REPULSION * repulsion
        + W_HYDROPHOBIC * hydro
        + W_HBOND * hbond
    )


def _dist(a, b):
    """[B, I, J] pair distances of the reference's form |a_i - b_j + 1e-9|."""
    return torch.linalg.vector_norm(a[:, :, None, :] - b[:, None, :, :] + 1e-9, dim=-1)


def inter_energy(lig_pos, lig: VinaLigand, rec: VinaReceptor):
    """[B] ligand-receptor energy."""
    d = _dist(lig_pos, rec.pos)
    d_surf = d - lig.radius[:, :, None] - rec.radius[:, None, :]
    e = _pair_terms(
        d_surf,
        lig.hydro[:, :, None], rec.hydro[:, None, :],
        lig.donor[:, :, None], lig.acceptor[:, :, None],
        rec.donor[:, None, :], rec.acceptor[:, None, :],
    )
    keep = (d <= CUTOFF) & (lig.mask[:, :, None] > 0) & (rec.mask[:, None, :] > 0)
    return torch.where(keep, e, 0.0).sum(dim=(-1, -2))


def intra_energy(lig_pos, lig: VinaLigand):
    """[B] ligand internal energy over pairs >= 4 bonds apart."""
    d = _dist(lig_pos, lig_pos)
    d_surf = d - lig.radius[:, :, None] - lig.radius[:, None, :]
    e = _pair_terms(
        d_surf,
        lig.hydro[:, :, None], lig.hydro[:, None, :],
        lig.donor[:, :, None], lig.acceptor[:, :, None],
        lig.donor[:, None, :], lig.acceptor[:, None, :],
    )
    keep = (
        (d <= CUTOFF)
        & (lig.intra_mask > 0)
        & (lig.mask[:, :, None] > 0)
        & (lig.mask[:, None, :] > 0)
    )
    return 0.5 * torch.where(keep, e, 0.0).sum(dim=(-1, -2))  # each pair counted once


def affinity(lig_pos, lig: VinaLigand, rec: VinaReceptor):
    """[B] Vina-style predicted affinity (kcal/mol-like; lower = better)."""
    return inter_energy(lig_pos, lig, rec) / (1.0 + W_NROT * lig.n_rot)


# ---------------------------------------------------------------------------
# local minimization over (tr, rot, torsions)
# ---------------------------------------------------------------------------


class _PairTab(NamedTuple):
    """Pose-independent pair tables, built once per minimization."""

    rr: torch.Tensor  # [B, I, J] radius_i + radius_j
    hyd: torch.Tensor  # [B, I, J] hydro_i * hydro_j
    hbp: torch.Tensor  # [B, I, J] min(don_i*acc_j + acc_i*don_j, 1)
    mask: torch.Tensor  # [B, I, J] static pair mask (bool)


def _pair_terms_tab(d_surf, tab: _PairTab):
    gauss1 = torch.exp(-((d_surf / 0.5) ** 2))
    gauss2 = torch.exp(-(((d_surf - 3.0) / 2.0) ** 2))
    repulsion = torch.where(d_surf < 0, d_surf**2, 0.0)
    hydro = tab.hyd * torch.clamp((1.5 - d_surf) / 1.0, 0.0, 1.0)
    hbond = tab.hbp * torch.clamp(-d_surf / 0.7, 0.0, 1.0)
    return (
        W_GAUSS1 * gauss1
        + W_GAUSS2 * gauss2
        + W_REPULSION * repulsion
        + W_HYDROPHOBIC * hydro
        + W_HBOND * hbond
    )


def _tab(rad_i, hyd_i, don_i, acc_i, mask_i, rad_j, hyd_j, don_j, acc_j, mask_j) -> _PairTab:
    return _PairTab(
        rr=rad_i[:, :, None] + rad_j[:, None, :],
        hyd=hyd_i[:, :, None] * hyd_j[:, None, :],
        hbp=torch.clamp(don_i[:, :, None] * acc_j[:, None, :]
                        + acc_i[:, :, None] * don_j[:, None, :], max=1.0),
        mask=(mask_i[:, :, None] > 0) & (mask_j[:, None, :] > 0),
    )


def _inter_tab(lig: VinaLigand, rec: VinaReceptor) -> _PairTab:
    return _tab(lig.radius, lig.hydro, lig.donor, lig.acceptor, lig.mask,
                rec.radius, rec.hydro, rec.donor, rec.acceptor, rec.mask)


def _intra_tab(lig: VinaLigand) -> _PairTab:
    t = _tab(lig.radius, lig.hydro, lig.donor, lig.acceptor, lig.mask,
             lig.radius, lig.hydro, lig.donor, lig.acceptor, lig.mask)
    return t._replace(mask=t.mask & (lig.intra_mask > 0))


def _inter_energy_tab(lig_pos, rec_pos, tab: _PairTab):
    d = _dist(lig_pos, rec_pos)
    e = _pair_terms_tab(d - tab.rr, tab)
    return torch.where((d <= CUTOFF) & tab.mask, e, 0.0).sum(dim=(-1, -2))


def _intra_energy_tab(lig_pos, tab: _PairTab):
    d = _dist(lig_pos, lig_pos)
    e = _pair_terms_tab(d - tab.rr, tab)
    return 0.5 * torch.where((d <= CUTOFF) & tab.mask, e, 0.0).sum(dim=(-1, -2))


def minimize_batch(lig_pos0, ligs: VinaLigand, recs: VinaReceptor, steps: int = 200,
                   lr: float = 0.05, n_tor: int | None = None):
    """Gradient local minimization of B poses in pose-parameter space
    (translation, rotation about the centroid, torsions; the smina
    `--minimize` role). Returns (positions [B, NL, 3], affinity [B]).

    Each step is the gradient of the summed energies: the poses are
    independent, so each gets its own gradient. The optimizer is optax's
    adam(cosine_decay_schedule(lr, steps)) written out: b1 0.9, b2 0.999,
    eps 1e-8, bias correction by count + 1, and lr_t = lr * (1 + cos(pi t /
    steps)) / 2 at the update's 0-based count t.

    `n_tor` is how many leading torsion slots the torsion loop visits (None:
    all of them, as the reference's loop over the padded slots). A slot past
    every pose's real torsions has zero gradient, stays at 0 and moves no
    atom, so any `n_tor` at or above the batch's largest torsion count gives
    the same result.
    """
    nt = ligs.tor_mask.shape[-1] if n_tor is None else n_tor
    node_mask = ligs.mask > 0
    tor_bonds = ligs.tor_bonds[:, :nt]
    frag_mask = ligs.rot_node_mask[:, :nt] > 0
    tor_mask = ligs.tor_mask[:, :nt] > 0
    lig_pos0 = lig_pos0.detach()

    def pose(tr, rot, tor):
        return pose_transform(lig_pos0, node_mask, tr, rot, tor_bonds, frag_mask, tor,
                              tor_mask)

    ti = _inter_tab(ligs, recs)
    tii = _intra_tab(ligs)
    B, dev = lig_pos0.shape[0], lig_pos0.device
    params = [torch.zeros(B, 3, device=dev), torch.zeros(B, 3, device=dev),
              torch.zeros(B, nt, device=dev)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    for count in range(steps):
        with torch.enable_grad():
            leaves = [p.requires_grad_(True) for p in params]
            pos = pose(*leaves)
            e = _inter_energy_tab(pos, recs.pos, ti) + _intra_energy_tab(pos, tii)
            # a batch without torsions leaves `tor` [B, 0] out of the graph
            grads = torch.autograd.grad(e.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        # optax's float32 bias corrections and cosine schedule
        c = np.float32(count + 1)
        bc1 = float(1 - np.float32(b1) ** c)
        bc2 = float(1 - np.float32(b2) ** c)
        lr_t = float(np.float32(lr) * (np.float32(0.5) * (1 + np.cos(
            np.float32(math.pi) * np.float32(min(count, steps)) / np.float32(steps)))))
        with torch.no_grad():
            new = []
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * (g * g))
                upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                new.append(p.detach() + upd * -lr_t)
            params = new
    with torch.no_grad():
        pos = pose(*params)
        return pos, affinity(pos, ligs, recs)
