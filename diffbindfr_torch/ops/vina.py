"""AutoDock-Vina-style scoring and the batched pose minimizers: the
counterpart of diffbindfr_tpu/ops/vina.py. The rigid-receptor minimizer
(`minimize_batch`) serves error correction and `relax` (with the angular
H-bond term and explicit polar hydrogens there); the joint ligand +
side-chain minimizer (`joint_minimize_batch` over `VinaFlexReceptor`)
serves `relax --flex`.

The typed receptors and ligand are built on the host in numpy
(`build_receptor`, `build_ligand`, `build_flex_receptor`: the same arrays
as the JAX package's builders); the energies and the minimizers are batched
PyTorch on tensors with a leading batch axis B, one autograd graph per step
for the whole batch. Scoring terms (Trott & Olson 2010):

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


def build_receptor(pocket, pad_atoms: int, explicit_polar_h: bool = False,
                   opt_acceptors=None) -> VinaReceptor:
    """Typed receptor (numpy) from the packed pocket atoms of a PocketRecord,
    pocket frame, padded to `pad_atoms`.

    The angular-H-bond axis of an atom is the opposite of the mean of its
    within-residue bond directions (implicit hydrogens). With
    `explicit_polar_h` the polar hydrogens are placed (chem/protonate.py),
    the rotatable ones turned towards the receptor's acceptors plus
    `opt_acceptors` [K, 3] (the ligand's acceptors, pocket frame), and each
    donor's axis becomes its mean H direction; acceptor-only atoms keep the
    implicit axis."""
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
    if explicit_polar_h:
        from ..chem.protonate import donor_h_axes, optimize_rotatable, protein_polar_h

        ph = protein_polar_h(pocket.aatype, pocket.atom14_pos, pocket.atom14_mask)
        flat_pos = pocket.atom14_pos.reshape(-1, 3)
        acc_pos = pos[: ridx.shape[0]][pack(acc)[: ridx.shape[0]] > 0]
        if opt_acceptors is not None and len(opt_acceptors):
            acc_pos = np.concatenate([acc_pos, np.asarray(opt_acceptors, np.float32)], axis=0)
        ph = optimize_rotatable(ph, acc_pos)
        axes, has_h = donor_h_axes(ph, flat_pos, flat_pos.shape[0])
        axes, has_h = axes[ridx * 14 + aidx], has_h[ridx * 14 + aidx]
        use = (has_h > 0) & (pack(don)[: ridx.shape[0]] > 0)
        e14 = np.where(use[:, None], axes, e14)
        has14 = np.where(use, 1.0, has14).astype(np.float32)
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


def _clip01(x):
    """jnp.clip(x, 0, 1) with JAX's gradient: half to each side at a bound
    (torch.clamp passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _floor(x, lo: float):
    """jnp.maximum(x, lo), with its balanced gradient at a tie."""
    return torch.maximum(x, x.new_tensor(lo))


def _pair_terms(d_surf, hyd_i, hyd_j, don_i, acc_i, don_j, acc_j, hb_scale=None):
    gauss1 = torch.exp(-((d_surf / 0.5) ** 2))
    gauss2 = torch.exp(-(((d_surf - 3.0) / 2.0) ** 2))
    repulsion = torch.where(d_surf < 0, d_surf**2, 0.0)
    hydro = hyd_i * hyd_j * torch.clamp((1.5 - d_surf) / 1.0, 0.0, 1.0)
    hb_pair = don_i * acc_j + acc_i * don_j
    hbond = torch.clamp(hb_pair, max=1.0) * torch.clamp(-d_surf / 0.7, 0.0, 1.0)
    if hb_scale is not None:
        hbond = hbond * hb_scale
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


# angular H-bond model (implicit hydrogens): the donor-H / acceptor lone-pair
# axis of a heavy atom is the opposite of the mean of its covalent bond
# directions, and the hbond pair term is scaled by a smooth cone at both ends.

HB_COS0 = -0.25  # cone edge: zero gain beyond ~104 deg off-axis


def _hb_dirs(pos, adj):
    """H-bond axes from covalent adjacency: e_i = -mean of the unit bond
    vectors. pos [B, A, 3], adj [B, A, A] -> (e [B, A, 3], has [B, A])."""
    diff = pos[:, None, :, :] - pos[:, :, None, :]
    dn = torch.linalg.vector_norm(diff + 1e-9, dim=-1, keepdim=True)
    u = diff / _floor(dn, 1e-6)
    e_raw = -(adj[..., None] * u).sum(dim=-2)
    nrm = torch.linalg.vector_norm(e_raw + 1e-12, dim=-1, keepdim=True)
    has = ((adj.sum(dim=-1) > 0) & (nrm[..., 0] > 0.2)).to(pos.dtype)
    return e_raw / _floor(nrm, 1e-6), has


def _ang_ramp(c):
    return _clip01((c - HB_COS0) / (1.0 - HB_COS0))


def _hb_scale(lig_pos, e_l, has_l, rec_pos, e_r, has_r, d):
    """[B, NL, NA] angular factor: the cone at the ligand end times the cone
    at the receptor end; an atom without a defined axis contributes 1."""
    u = (rec_pos[:, None, :, :] - lig_pos[:, :, None, :]) / d[..., None]
    cl = (u * e_l[:, :, None, :]).sum(dim=-1)
    cr = (-u * e_r[:, None, :, :]).sum(dim=-1)
    fl = 1.0 + has_l[:, :, None] * (_ang_ramp(cl) - 1.0)
    fr = 1.0 + has_r[:, None, :] * (_ang_ramp(cr) - 1.0)
    return fl * fr


def _res_local_dirs(pos14, mask14):
    """H-bond axes of [..., R, 14] receptor atoms from within-residue
    geometric bonds (d < 1.9 A), on rebuilt (flex) coordinates: the torch
    twin of _res_local_dirs_np."""
    diff = pos14[..., None, :, :] - pos14[..., :, None, :]
    dn = torch.linalg.vector_norm(diff + 1e-9, dim=-1)
    eye = torch.eye(pos14.shape[-2], dtype=torch.bool, device=pos14.device)
    adj = ((dn < 1.9) & ~eye & (mask14[..., :, None] > 0) & (mask14[..., None, :] > 0))
    u = diff / _floor(dn[..., None], 1e-6)
    e_raw = -(adj[..., None] * u).sum(dim=-2)
    nrm = torch.linalg.vector_norm(e_raw + 1e-12, dim=-1, keepdim=True)
    has = ((adj.sum(dim=-1) > 0) & (nrm[..., 0] > 0.2)).to(pos14.dtype)
    return e_raw / _floor(nrm, 1e-6), has


def inter_energy(lig_pos, lig: VinaLigand, rec: VinaReceptor, angular_hb: bool = False):
    """[B] ligand-receptor energy (`angular_hb`: the hbond term scaled by
    the receptor's hb_dir / hb_has cones and the ligand's own)."""
    d = _dist(lig_pos, rec.pos)
    d_surf = d - lig.radius[:, :, None] - rec.radius[:, None, :]
    hb_scale = None
    if angular_hb:
        e_l, has_l = _hb_dirs(lig_pos, lig.bond_adj)
        hb_scale = _hb_scale(lig_pos, e_l, has_l, rec.pos, rec.hb_dir, rec.hb_has, d)
    e = _pair_terms(
        d_surf,
        lig.hydro[:, :, None], rec.hydro[:, None, :],
        lig.donor[:, :, None], lig.acceptor[:, :, None],
        rec.donor[:, None, :], rec.acceptor[:, None, :],
        hb_scale=hb_scale,
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


def _pair_terms_tab(d_surf, tab: _PairTab, hb_scale=None):
    gauss1 = torch.exp(-((d_surf / 0.5) ** 2))
    gauss2 = torch.exp(-(((d_surf - 3.0) / 2.0) ** 2))
    repulsion = torch.where(d_surf < 0, d_surf**2, 0.0)
    hydro = tab.hyd * torch.clamp((1.5 - d_surf) / 1.0, 0.0, 1.0)
    hbond = tab.hbp * torch.clamp(-d_surf / 0.7, 0.0, 1.0)
    if hb_scale is not None:
        hbond = hbond * hb_scale
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


def _inter_energy_tab(lig_pos, rec_pos, tab: _PairTab, hb=None):
    """[B] inter energy on the hoisted tables; `hb` = (ligand bond_adj,
    receptor hb_dir, hb_has) turns the angular H-bond term on."""
    d = _dist(lig_pos, rec_pos)
    hb_scale = None
    if hb is not None:
        bond_adj, hb_dir, hb_has = hb
        e_l, has_l = _hb_dirs(lig_pos, bond_adj)
        hb_scale = _hb_scale(lig_pos, e_l, has_l, rec_pos, hb_dir, hb_has, d)
    e = _pair_terms_tab(d - tab.rr, tab, hb_scale=hb_scale)
    return torch.where((d <= CUTOFF) & tab.mask, e, 0.0).sum(dim=(-1, -2))


def _intra_energy_tab(lig_pos, tab: _PairTab):
    d = _dist(lig_pos, lig_pos)
    e = _pair_terms_tab(d - tab.rr, tab)
    return 0.5 * torch.where((d <= CUTOFF) & tab.mask, e, 0.0).sum(dim=(-1, -2))


class Adam:
    """optax.adam(cosine_decay_schedule(lr, steps)) written out in f32, for
    leaves that are tensors of a batch of independent problems: b1 0.9, b2
    0.999, eps 1e-8, bias correction by count + 1, and lr_t = lr * (1 +
    cos(pi t / steps)) / 2 at the update's 0-based count t. One instance is
    one optax.adam: its own moments (optax.multi_transform is one instance
    per group of leaves)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: list, lr: float, steps: int):
        self.lr, self.steps = lr, steps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, params: list, grads: list, count: int) -> list:
        """The leaves after the update of 0-based `count` (detached)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        # optax's float32 bias corrections and cosine schedule
        c = np.float32(count + 1)
        bc1 = float(1 - np.float32(b1) ** c)
        bc2 = float(1 - np.float32(b2) ** c)
        lr_t = float(np.float32(self.lr) * (np.float32(0.5) * (1 + np.cos(
            np.float32(math.pi) * np.float32(min(count, self.steps)) / np.float32(self.steps)))))
        new = []
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g * g))
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            new.append(p.detach() + upd * -lr_t)
        return new


def grads_of(energy, leaves: list) -> list:
    """Gradients of the summed [B] energy at `leaves` (a leaf the energy
    does not reach, such as torsions [B, 0], gets zeros)."""
    with torch.enable_grad():
        leaves = [p.requires_grad_(True) for p in leaves]
        grads = torch.autograd.grad(energy(*leaves).sum(), leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _pose_fn(lig_pos0, ligs: VinaLigand, nt: int):
    """pose(tr, rot, tor): the ligand moved by the pose parameters."""
    node_mask = ligs.mask > 0
    tor_bonds = ligs.tor_bonds[:, :nt]
    frag_mask = ligs.rot_node_mask[:, :nt] > 0
    tor_mask = ligs.tor_mask[:, :nt] > 0
    lig_pos0 = lig_pos0.detach()

    def pose(tr, rot, tor):
        return pose_transform(lig_pos0, node_mask, tr, rot, tor_bonds, frag_mask, tor,
                              tor_mask)

    return pose


def _pose_params(lig_pos0, nt: int) -> list:
    B, dev = lig_pos0.shape[0], lig_pos0.device
    return [torch.zeros(B, 3, device=dev), torch.zeros(B, 3, device=dev),
            torch.zeros(B, nt, device=dev)]


def minimize_batch(lig_pos0, ligs: VinaLigand, recs: VinaReceptor, steps: int = 200,
                   lr: float = 0.05, n_tor: int | None = None, angular_hb: bool = False):
    """Gradient local minimization of B poses in pose-parameter space
    (translation, rotation about the centroid, torsions; the smina
    `--minimize` role) against rigid receptors. Returns (positions
    [B, NL, 3], affinity [B]); the JAX package's `minimize` is this at B = 1.

    Each step is the gradient of the summed energies: the poses are
    independent, so each gets its own gradient; `Adam` steps them.
    `angular_hb` adds the angular H-bond term (receptor hb_dir / hb_has) to
    the minimized energy; the affinity stays the distance-only one.

    `n_tor` is how many leading torsion slots the torsion loop visits (None:
    all of them, as the reference's loop over the padded slots). A slot past
    every pose's real torsions has zero gradient, stays at 0 and moves no
    atom, so any `n_tor` at or above the batch's largest torsion count gives
    the same result.
    """
    nt = ligs.tor_mask.shape[-1] if n_tor is None else n_tor
    pose = _pose_fn(lig_pos0, ligs, nt)
    ti = _inter_tab(ligs, recs)
    tii = _intra_tab(ligs)
    hb = (ligs.bond_adj, recs.hb_dir, recs.hb_has) if angular_hb else None

    def energy(tr, rot, tor):
        pos = pose(tr, rot, tor)
        return _inter_energy_tab(pos, recs.pos, ti, hb=hb) + _intra_energy_tab(pos, tii)

    params = _pose_params(lig_pos0, nt)
    adam = Adam(params, lr, steps)
    for count in range(steps):
        params = adam.update(params, grads_of(energy, params), count)
    with torch.no_grad():
        pos = pose(*params)
        return pos, affinity(pos, ligs, recs)


# ---------------------------------------------------------------------------
# joint ligand + side-chain minimization (`relax --flex`): the chi DOFs enter
# the same gradient minimizer through the rigid-group atom14 rebuild
# ---------------------------------------------------------------------------


class VinaFlexReceptor(NamedTuple):
    """Chi-flexible typed receptor: atom positions are a differentiable
    function of per-residue chi offsets (geometry/chi.py build_atom14)."""

    torsion0: object  # [R, 5] initial (psi, chi1-4) radians
    chi_mask: object  # [R, 4] movable chis
    backbone_rots: object  # [R, 3, 3]
    backbone_transl: object  # [R, 3] (pocket frame)
    default_frame: object  # [R, 8, 4, 4]
    template_pos: object  # [R, 14, 3]
    group_idx: object  # [R, 14]
    atom14_mask: object  # [R, 14]
    radius: object  # [R, 14]
    hydro: object  # [R, 14]
    donor: object  # [R, 14]
    acceptor: object  # [R, 14]


def build_flex_receptor(pocket, pad_res: int) -> VinaFlexReceptor:
    """Typed chi-flexible receptor (numpy) from a PocketRecord (pocket
    frame), padded to `pad_res` residues."""
    r = pocket.num_res
    rad, hyd, don, acc = _PTABLES
    aat = pocket.aatype

    def padr(a, dtype):
        return np.pad(a, [(0, pad_res - r)] + [(0, 0)] * (a.ndim - 1)).astype(dtype)

    f32 = np.float32
    return VinaFlexReceptor(
        torsion0=padr(pocket.torsion_angle, f32),
        chi_mask=padr(pocket.chi_mask, f32),
        backbone_rots=padr(pocket.backbone_rots, f32),
        backbone_transl=padr(pocket.backbone_transl, f32),
        default_frame=padr(pocket.default_frame, f32),
        template_pos=padr(pocket.rigid_group_positions, f32),
        group_idx=padr(pocket.group_idx, np.int32),
        atom14_mask=padr(pocket.atom14_mask, f32),
        radius=padr(rad[aat], f32),
        hydro=padr(hyd[aat], f32),
        donor=padr(don[aat], f32),
        acceptor=padr(acc[aat], f32),
    )


def flex_atom14(frec: VinaFlexReceptor, dchi):
    """Pocket atom14 positions [B, R, 14, 3] rebuilt with chi offsets dchi
    [B, R, 4]; psi (backbone O) stays fixed: side chains only."""
    from ..geometry.chi import build_atom14

    zero = torch.zeros_like(frec.torsion0[..., :1])
    tor = frec.torsion0 + torch.cat([zero, dchi * frec.chi_mask], dim=-1)
    sincos = torch.stack([torch.sin(tor), torch.cos(tor)], dim=-1)
    return build_atom14(sincos, frec.backbone_rots, frec.backbone_transl, frec.default_frame,
                        frec.template_pos, frec.group_idx, frec.atom14_mask)


def _flex_flat(frec: VinaFlexReceptor, pos14):
    """[B, R, 14] receptor fields -> packed [B, R*14] atom arrays."""
    B = pos14.shape[0]
    flat = lambda a: a.reshape(B, -1)  # noqa: E731
    return (pos14.reshape(B, -1, 3), flat(frec.atom14_mask), flat(frec.radius),
            flat(frec.hydro), flat(frec.donor), flat(frec.acceptor))


def flex_inter_energy(lig_pos, lig: VinaLigand, frec: VinaFlexReceptor, pos14,
                      angular_hb: bool = False):
    """[B] ligand energy against the rebuilt receptor atoms pos14."""
    rpos, rmask, rrad, rhyd, rdon, racc = _flex_flat(frec, pos14)
    d = _dist(lig_pos, rpos)
    d_surf = d - lig.radius[:, :, None] - rrad[:, None, :]
    hb_scale = None
    if angular_hb:
        e_l, has_l = _hb_dirs(lig_pos, lig.bond_adj)
        e14, has14 = _res_local_dirs(pos14, frec.atom14_mask)
        hb_scale = _hb_scale(lig_pos, e_l, has_l, rpos, e14.reshape(rpos.shape),
                             has14.reshape(rmask.shape), d)
    e = _pair_terms(
        d_surf,
        lig.hydro[:, :, None], rhyd[:, None, :],
        lig.donor[:, :, None], lig.acceptor[:, :, None],
        rdon[:, None, :], racc[:, None, :],
        hb_scale=hb_scale,
    )
    keep = (d <= CUTOFF) & (lig.mask[:, :, None] > 0) & (rmask[:, None, :] > 0)
    return torch.where(keep, e, 0.0).sum(dim=(-1, -2))


def receptor_clash_energy(frec: VinaFlexReceptor, pos14, excl):
    """[B] quadratic vdW-overlap penalty between receptor atoms of the pairs
    that `excl` [B, RA, RA] leaves in (flex_clash_exclusion): only the new
    clashes that chi moves introduce."""
    rpos, rmask, rrad, *_ = _flex_flat(frec, pos14)
    d = _dist(rpos, rpos)
    d_surf = d - rrad[:, :, None] - rrad[:, None, :]
    keep = (rmask[:, :, None] > 0) & (rmask[:, None, :] > 0) & (excl == 0)
    overlap = torch.where(keep, _floor(-d_surf, 0.0), 0.0)
    return 0.5 * (overlap**2).sum(dim=(-1, -2))


def flex_clash_exclusion(frec: VinaFlexReceptor, margin: float = 0.3):
    """[B, RA, RA] 1 = pair left out of the receptor clash term: the same
    residue, or already within `margin` of vdW contact at the input chis."""
    pos14 = flex_atom14(frec, torch.zeros_like(frec.chi_mask))
    rpos, rmask, rrad, *_ = _flex_flat(frec, pos14)
    res_of = torch.arange(rpos.shape[1], device=rpos.device) // 14
    same_res = res_of[:, None] == res_of[None, :]
    surf0 = _dist(rpos, rpos) - rrad[:, :, None] - rrad[:, None, :]
    return (same_res | (surf0 < margin)).to(torch.float32)


def joint_minimize_batch(lig_pos0, ligs: VinaLigand, frec: VinaFlexReceptor, steps: int = 200,
                         lr: float = 0.05, chi_lr_scale: float = 0.5, w_clash: float = 2.0,
                         w_chi: float = 1.0, angular_hb: bool = False,
                         n_tor: int | None = None):
    """Joint local minimization of B poses over the ligand's (tr, rot, tor)
    and the receptor's chi offsets, each pose with its own receptor row of
    `frec` (fields [B, ...]). The chis are restrained to the input rotamers
    ((1 - cos) per movable chi, `w_chi`) and receptor overlaps the chi moves
    introduce are penalized (`w_clash`). Two `Adam`s, as the JAX package's
    optax.multi_transform: one on the pose leaves at `lr`, one on the chis
    at `lr * chi_lr_scale`. Returns (lig_pos [B, NL, 3], atom14_pos
    [B, R, 14, 3], affinity [B]); the JAX package's `joint_minimize` is this
    at B = 1. `n_tor` as in minimize_batch."""
    nt = ligs.tor_mask.shape[-1] if n_tor is None else n_tor
    pose = _pose_fn(lig_pos0, ligs, nt)
    excl = flex_clash_exclusion(frec)
    # pose-independent pair tables: receptor positions change with the chis,
    # their typing, radii and masks do not
    B = lig_pos0.shape[0]
    flat = lambda a: a.reshape(B, -1)  # noqa: E731
    rmask_f, rrad_f = flat(frec.atom14_mask), flat(frec.radius)
    ti = _tab(ligs.radius, ligs.hydro, ligs.donor, ligs.acceptor, ligs.mask,
              rrad_f, flat(frec.hydro), flat(frec.donor), flat(frec.acceptor), rmask_f)
    tii = _intra_tab(ligs)
    rr_clash = rrad_f[:, :, None] + rrad_f[:, None, :]
    keep_clash = (rmask_f[:, :, None] > 0) & (rmask_f[:, None, :] > 0) & (excl == 0)

    def energy(tr, rot, tor, dchi):
        pos = pose(tr, rot, tor)
        pos14 = flex_atom14(frec, dchi)
        restraint = (frec.chi_mask * (1.0 - torch.cos(dchi))).sum(dim=(-1, -2))
        rpos = pos14.reshape(B, -1, 3)
        d = _dist(pos, rpos)
        hb_scale = None
        if angular_hb:
            e_l, has_l = _hb_dirs(pos, ligs.bond_adj)
            e14, has14 = _res_local_dirs(pos14, frec.atom14_mask)
            hb_scale = _hb_scale(pos, e_l, has_l, rpos, e14.reshape(rpos.shape),
                                 has14.reshape(rmask_f.shape), d)
        e_inter = torch.where((d <= CUTOFF) & ti.mask,
                              _pair_terms_tab(d - ti.rr, ti, hb_scale=hb_scale),
                              0.0).sum(dim=(-1, -2))
        overlap = torch.where(keep_clash, _floor(rr_clash - _dist(rpos, rpos), 0.0), 0.0)
        return (e_inter + _intra_energy_tab(pos, tii)
                + w_clash * 0.5 * (overlap**2).sum(dim=(-1, -2)) + w_chi * restraint)

    params = _pose_params(lig_pos0, nt) + [torch.zeros_like(frec.chi_mask)]
    pose_adam = Adam(params[:3], lr, steps)
    chi_adam = Adam(params[3:], lr * chi_lr_scale, steps)
    for count in range(steps):
        grads = grads_of(energy, params)
        params = (pose_adam.update(params[:3], grads[:3], count)
                  + chi_adam.update(params[3:], grads[3:], count))
    with torch.no_grad():
        pos = pose(*params[:3])
        pos14 = flex_atom14(frec, params[3])
        rpos, rmask, rrad, rhyd, rdon, racc = _flex_flat(frec, pos14)
        # affinity reads neither hb field
        rec = VinaReceptor(pos=rpos, mask=rmask, radius=rrad, hydro=rhyd, donor=rdon,
                           acceptor=racc, hb_dir=torch.zeros_like(rpos),
                           hb_has=torch.zeros_like(rmask))
        return pos, pos14, affinity(pos, ligs, rec)
