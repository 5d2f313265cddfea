"""Batched all-atom Cartesian fine-relaxation of docked complexes: the
counterpart of diffbindfr_tpu/ops/cartesian.py (`predict --cart-relax`,
`eval_cli --cart-relax`, `relax --cartesian`).

The role is the reference's OpenMM relax stage (DiffBindFR/relax/pl.py):
the complex is minimized in Cartesian space to repair the local strain and
the steric clashes that pose-space moves cannot reach. Energy (per pose):

ligand internal geometry, restrained to the input-conformer reference:
  * harmonic bond lengths            k (|r| - |r0|)^2
  * harmonic bond angles             k (cos th - cos th0)^2
  * planarity: every torsion quad across a double or aromatic bond
    penalized by k sin^2(phi) (minima at 0 and pi: cis/trans kept)
  * sp2 pyramidalization: out-of-plane height of a 3-neighbour sp2 centre
  * tetrahedral chirality and E/Z: hinges keeping the input record's signs
steric terms, at the PoseBusters thresholds of app/validity.py with a 10%
margin:
  * ligand internal clash (graph distance >= 3) above 0.7 x Bondi sum
  * ligand-protein clash above 0.75 x Bondi sum
the Vina inter + intra energy (ops/vina.py), and restraints: receptor heavy
atoms harmonically about their input (per-pose) positions, ligand atoms
weakly about the input pose.

The builders are host numpy (the JAX package's arrays). The minimizer moves
ligand coordinates [B, NL, 3] and receptor displacements [B, NA, 3] of a
batch of poses in one autograd graph per step, Adam on a cosine schedule
(ops/vina.py `Adam`). The bonded terms read their atoms through one index
gather per evaluation.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import residues as rc
from . import vina
from .vina import _clip01, _dist, _floor

# Bondi van-der-Waals radii (A): the PoseBusters clash criterion radii
BONDI = {
    "H": 1.20, "C": 1.70, "N": 1.55, "O": 1.52, "S": 1.80, "P": 1.80,
    "F": 1.47, "Cl": 1.75, "Br": 1.85, "I": 1.98, "B": 1.92, "Se": 1.90,
}
BONDI_DEFAULT = 1.70

CLASH_SCALE_INTERNAL = 0.7   # PoseBusters internal-clash scale
CLASH_SCALE_PROTEIN = 0.75   # PoseBusters protein-clash scale
CLASH_MARGIN = 1.10          # relax 10% past the check threshold


class RelaxWeights(NamedTuple):
    """Energy weights (Vina-unit scale; positions in Angstrom)."""

    k_bond: float = 100.0      # per A^2
    k_angle: float = 50.0      # per cos^2
    k_planar: float = 10.0     # per sin^2
    k_sp2: float = 25.0        # per A^2 of out-of-plane height
    k_int_clash: float = 30.0  # per A^2 of overlap past the margin
    k_prot_clash: float = 30.0
    k_pos_lig: float = 0.3     # per A^2 (weak anchor to the input pose)
    k_pos_rec: float = 2.0     # per A^2 (heavy-atom restraint)
    k_chiral: float = 15.0     # signed-volume hinge (per A^6)
    k_ez: float = 15.0         # E/Z cos-sign hinge
    w_vina: float = 1.0


class CartesianLigand(NamedTuple):
    """Fixed-shape bonded-topology tables of one ligand."""

    bonds: object        # [NB, 2] int32
    bond_mask: object    # [NB]
    ref_len: object      # [NB] input-conformer bond lengths
    angles: object       # [NG, 3] int32 (i, j=apex, k)
    angle_mask: object   # [NG]
    ref_cos: object      # [NG] input-conformer cos(angle)
    quads: object        # [NQ, 4] int32 (x, a, b, y) planar torsions
    quad_mask: object    # [NQ]
    sp2: object          # [NS, 4] int32 (center, n1, n2, n3)
    sp2_mask: object     # [NS]
    nb3_mask: object     # [NL, NL] graph-distance >= 3 pairs
    bondi: object        # [NL]
    mask: object         # [NL]
    chiral: object       # [NC, 4] int32 (center, n1, n2, n3)
    chiral_mask: object  # [NC]
    chiral_sign: object  # [NC] input-record signed-volume sign
    ez_quads: object     # [NZ, 4] int32 (sa, a, b, sb) stereo double bonds
    ez_mask: object      # [NZ]
    ez_sign: object      # [NZ] sign of cos(phi) in the input record


class CartesianReceptor(NamedTuple):
    """Packed-pocket receptor typing and the atom14 gather map, so that each
    pose's own atom14 coordinates are packed on the device."""

    pack_idx: object  # [NA] int32 into flattened [R*14] arrays
    mask: object      # [NA]
    radius: object    # [NA] X-Score radii (Vina terms)
    hydro: object
    donor: object
    acceptor: object
    bondi: object     # [NA] Bondi radii (clash criterion)


def _protein_bondi_table() -> np.ndarray:
    """[21, 14] Bondi radius by (restype, atom14 slot)."""
    out = np.full((21, 14), BONDI_DEFAULT, np.float32)
    for res3, names in rc.restype_name_to_atom14_names.items():
        if res3 == "UNK":
            continue
        ri = rc.restype_order[rc.restype_3to1[res3]]
        for slot, name in enumerate(names):
            if name:
                out[ri, slot] = BONDI.get(name[0], BONDI_DEFAULT)
    return out


_PBONDI = _protein_bondi_table()


def _pad_rows(a: np.ndarray, n: int, what: str) -> np.ndarray:
    if a.shape[0] > n:
        raise ValueError(
            f"cartesian relax: {what} count {a.shape[0]} exceeds pad {n} "
            f"(grow the bucket-derived pad in build_cartesian_ligand)")
    return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))


def build_cartesian_ligand(lig, pad_atoms: int, pad_bonds: int | None = None,
                           pad_angles: int | None = None,
                           pad_quads: int | None = None) -> CartesianLigand:
    """Host-numpy topology tables of a LigandRecord, its input conformer the
    reference. Pads default to multiples of `pad_atoms`: heavy-atom degree
    <= 4 bounds bonds by 2 NL and angles by 6 NL; a planar bond carries at
    most 4 quads."""
    from ..app.validity import _stereo_double_bonds

    na = lig.num_atoms
    ref = np.asarray(lig.pos[:na], np.float64)
    bonds = np.asarray(lig.bonds, np.int32).reshape(-1, 2)
    orders = np.asarray(lig.bond_orders).reshape(-1)
    pad_bonds = pad_bonds or 2 * pad_atoms
    pad_angles = pad_angles or 6 * pad_atoms
    pad_quads = pad_quads or 6 * pad_atoms

    nbrs: dict = {i: [] for i in range(na)}
    for a, b in map(tuple, bonds):
        nbrs[a].append(int(b))
        nbrs[b].append(int(a))

    ref_len = np.linalg.norm(ref[bonds[:, 0]] - ref[bonds[:, 1]], axis=-1)
    nb = bonds.shape[0]

    # angles (apex j)
    trips = []
    for j, ns in nbrs.items():
        for x in range(len(ns)):
            for y in range(x + 1, len(ns)):
                trips.append((ns[x], j, ns[y]))
    trips = np.asarray(trips, np.int32).reshape(-1, 3)
    if trips.size:
        v1 = ref[trips[:, 0]] - ref[trips[:, 1]]
        v2 = ref[trips[:, 2]] - ref[trips[:, 1]]
        ref_cos = np.sum(v1 * v2, -1) / (
            np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-9)
    else:
        ref_cos = np.zeros((0,))
    ng = trips.shape[0]

    # planar torsion quads across double (2) / aromatic (4) bonds
    quads = []
    sp2_atoms = set()
    for (a, b), o in zip(map(tuple, bonds), orders):
        if int(o) not in (2, 4):
            continue
        sp2_atoms.update((a, b))
        for x in nbrs[a]:
            if x == b:
                continue
            for y in nbrs[b]:
                if y == a:
                    continue
                quads.append((x, a, b, y))
    quads = np.asarray(quads, np.int32).reshape(-1, 4)
    nq = quads.shape[0]

    # sp2 pyramidalization centres: 3-neighbour atoms on a planar bond
    sp2 = [(j, *nbrs[j][:3]) for j in sorted(sp2_atoms) if len(nbrs[j]) == 3]
    sp2 = np.asarray(sp2, np.int32).reshape(-1, 4)
    ns2 = sp2.shape[0]

    # tetrahedral chirality: atoms with >= 3 heavy neighbours keep the sign
    # of their input-record signed volume (validity's stereo reference)
    cquads, csigns = [], []
    for j, ns in nbrs.items():
        if len(ns) < 3:
            continue
        ns3 = sorted(ns)[:3]
        v = np.dot(np.cross(ref[ns3[0]] - ref[j], ref[ns3[1]] - ref[j]), ref[ns3[2]] - ref[j])
        if abs(v) < 0.25:  # effectively planar centre (sp2): skip
            continue
        cquads.append([j] + ns3)
        csigns.append(np.sign(v))
    cquads = np.asarray(cquads, np.int32).reshape(-1, 4)
    nc = cquads.shape[0]

    # E/Z: the sign of cos(phi) across each stereo double bond, on the
    # substituent quad the validity check uses
    ezq, ezs = [], []
    for a, b, sa, sb, _, _ in _stereo_double_bonds(lig):
        b0 = ref[a] - ref[sa]
        b1 = ref[b] - ref[a]
        b2 = ref[sb] - ref[b]
        n1 = np.cross(b0, b1)
        n2 = np.cross(b1, b2)
        cos = float(np.dot(n1, n2) / (np.linalg.norm(n1) * np.linalg.norm(n2) + 1e-9))
        if abs(cos) < 0.3:  # ill-defined in the reference geometry
            continue
        ezq.append((sa, a, b, sb))
        ezs.append(np.sign(cos))
    ezq = np.asarray(ezq, np.int32).reshape(-1, 4)
    nz = ezq.shape[0]

    # non-bonded (graph distance >= 3) pair mask
    adj = np.zeros((na, na), bool)
    adj[bonds[:, 0], bonds[:, 1]] = True
    adj |= adj.T
    two = (adj @ adj) | adj
    np.fill_diagonal(two, True)
    nb3 = np.zeros((pad_atoms, pad_atoms), np.float32)
    nb3[:na, :na] = (~two).astype(np.float32)

    bondi = np.array([BONDI.get(e, BONDI_DEFAULT) for e in lig.elements], np.float32)
    mask = np.zeros(pad_atoms, np.float32)
    mask[:na] = 1.0

    def ones(n, pad):
        m = np.zeros(pad, np.float32)
        m[:n] = 1.0
        return m

    return CartesianLigand(
        bonds=_pad_rows(bonds, pad_bonds, "bond"),
        bond_mask=ones(nb, pad_bonds),
        ref_len=np.pad(ref_len.astype(np.float32), (0, pad_bonds - nb), constant_values=1.5),
        angles=_pad_rows(trips, pad_angles, "angle"),
        angle_mask=ones(ng, pad_angles),
        ref_cos=np.pad(ref_cos.astype(np.float32), (0, pad_angles - ng)),
        quads=_pad_rows(quads, pad_quads, "planar quad"),
        quad_mask=ones(nq, pad_quads),
        sp2=_pad_rows(sp2, pad_atoms, "sp2 center"),
        sp2_mask=ones(ns2, pad_atoms),
        nb3_mask=nb3,
        bondi=np.pad(bondi, (0, pad_atoms - na)),
        mask=mask,
        chiral=_pad_rows(cquads, pad_atoms, "chiral center"),
        chiral_mask=np.pad(np.ones(nc, np.float32), (0, pad_atoms - nc)),
        chiral_sign=np.pad(np.asarray(csigns, np.float32), (0, pad_atoms - nc)),
        ez_quads=_pad_rows(ezq, pad_atoms, "stereo double bond"),
        ez_mask=np.pad(np.ones(nz, np.float32), (0, pad_atoms - nz)),
        ez_sign=np.pad(np.asarray(ezs, np.float32), (0, pad_atoms - nz)),
    )


def build_cartesian_receptor(pocket, pad_atoms: int) -> CartesianReceptor:
    """Typing and gather map of the packed existing pocket atoms (numpy).
    Positions are not baked in: each pose's atom14 coordinates are packed
    through `pack_idx` (the sampler moves the side chains per pose)."""
    exists = pocket.atom14_mask.astype(bool)
    ridx, aidx = np.nonzero(exists)
    n = ridx.shape[0]
    rad, hyd, don, acc = vina._PTABLES
    aat = pocket.aatype

    def pack(tab):
        return np.asarray(np.pad(tab[aat][ridx, aidx], (0, pad_atoms - n)), np.float32)

    mask = np.zeros(pad_atoms, np.float32)
    mask[:n] = 1.0
    return CartesianReceptor(
        pack_idx=np.pad((ridx * 14 + aidx).astype(np.int32), (0, pad_atoms - n)),
        mask=mask, radius=pack(rad), hydro=pack(hyd), donor=pack(don), acceptor=pack(acc),
        bondi=pack(_PBONDI))


# ---------------------------------------------------------------------------
# energy (batched: ligand [B, NL, 3], receptor [B, NA, 3], tables [B, ...])
# ---------------------------------------------------------------------------


class _BondedGather(NamedTuple):
    """Every bonded-term index column in one [B, K, 3] gather index, and
    each term's row count, so one gather per evaluation serves all."""

    idx: torch.Tensor  # [B, K, 3] int64
    sizes: tuple


def _bonded_gather(cl: CartesianLigand) -> _BondedGather:
    cols = [cl.bonds[..., 0], cl.bonds[..., 1],
            cl.angles[..., 0], cl.angles[..., 1], cl.angles[..., 2],
            *(cl.quads[..., k] for k in range(4)),
            *(cl.sp2[..., k] for k in range(4)),
            *(cl.chiral[..., k] for k in range(4)),
            *(cl.ez_quads[..., k] for k in range(4))]
    idx = torch.cat(cols, dim=-1)
    return _BondedGather(idx=idx[..., None].expand(*idx.shape, 3),
                         sizes=tuple(c.shape[-1] for c in cols))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def ligand_bonded_energy(x, cl: CartesianLigand, w: RelaxWeights,
                         gat: _BondedGather | None = None):
    """[B] restraint energy of the ligand's internal geometry about the
    input-conformer reference. `gat` (built once per minimization, outside
    the step loop) is the gather of every term's atoms."""
    if gat is None:
        gat = _bonded_gather(cl)
    (bu, bv, a0, a1, a2, q0, q1, q2, q3, s0, s1, s2, s3, c0, c1, c2, c3,
     z0, z1, z2, z3) = torch.gather(x, 1, gat.idx).split(gat.sizes, dim=1)

    # bonds
    d = _norm(bu - bv + 1e-9)
    e_bond = w.k_bond * (cl.bond_mask * (d - cl.ref_len) ** 2).sum(dim=-1)
    # angles (arccos-free: finite gradients at linear configurations)
    v1 = a0 - a1
    v2 = a2 - a1
    cos = (v1 * v2).sum(dim=-1) / (_norm(v1 + 1e-9) * _norm(v2 + 1e-9) + 1e-9)
    e_ang = w.k_angle * (cl.angle_mask * (cos - cl.ref_cos) ** 2).sum(dim=-1)
    # planar torsions: sin^2(phi), minima at 0 and pi
    n1 = _cross(q1 - q0, q2 - q1)
    n2 = _cross(q2 - q1, q3 - q2)
    cos_t2 = (n1 * n2).sum(dim=-1) ** 2 / (
        (n1 * n1).sum(dim=-1) * (n2 * n2).sum(dim=-1) + 1e-9)
    e_quad = w.k_planar * (cl.quad_mask * (1.0 - _clip01(cos_t2))).sum(dim=-1)
    # sp2 out-of-plane height
    nrm = _cross(s2 - s1, s3 - s1)
    nrm = nrm / (_norm(nrm + 1e-9, keepdim=True) + 1e-9)
    h = ((s0 - s1) * nrm).sum(dim=-1)
    e_sp2 = w.k_sp2 * (cl.sp2_mask * h**2).sum(dim=-1)
    # tetrahedral chirality hinge: each centre's signed volume stays on the
    # input record's side with margin
    vol = (_cross(c1 - c0, c2 - c0) * (c3 - c0)).sum(dim=-1)
    e_chi = w.k_chiral * (cl.chiral_mask * _floor(0.5 - cl.chiral_sign * vol, 0.0) ** 2
                          ).sum(dim=-1)
    # E/Z hinge: cos(phi) across the stereo double bond stays on the input
    # record's side (the planar term alone would keep a flipped bond)
    en1 = _cross(z1 - z0, z2 - z1)
    en2 = _cross(z2 - z1, z3 - z2)
    ecos = (en1 * en2).sum(dim=-1) / torch.sqrt(
        (en1 * en1).sum(dim=-1) * (en2 * en2).sum(dim=-1) + 1e-9)
    e_ez = w.k_ez * (cl.ez_mask * _floor(0.5 - cl.ez_sign * ecos, 0.0) ** 2).sum(dim=-1)
    return e_bond + e_ang + e_quad + e_sp2 + e_chi + e_ez


class _PairTabs(NamedTuple):
    """Pose-independent pair tables, built once per minimization."""

    lim: torch.Tensor     # [B, NL, NL] internal-clash limit
    pair_m: torch.Tensor  # [B, NL, NL] internal-clash pair mask
    plim: torch.Tensor    # [B, NL, NA] ligand-protein clash limit
    pm: torch.Tensor      # [B, NL, NA] ligand-protein pair mask
    vtab: vina._PairTab   # ligand-receptor Vina typing
    itab: vina._PairTab   # ligand intra Vina typing


def _pair_tabs(cl: CartesianLigand, vl: vina.VinaLigand, cr: CartesianReceptor) -> _PairTabs:
    return _PairTabs(
        lim=CLASH_MARGIN * CLASH_SCALE_INTERNAL * (cl.bondi[:, :, None] + cl.bondi[:, None, :]),
        pair_m=cl.nb3_mask * cl.mask[:, :, None] * cl.mask[:, None, :],
        plim=CLASH_MARGIN * CLASH_SCALE_PROTEIN * (cl.bondi[:, :, None] + cr.bondi[:, None, :]),
        pm=cl.mask[:, :, None] * cr.mask[:, None, :],
        vtab=vina._tab(vl.radius, vl.hydro, vl.donor, vl.acceptor, vl.mask,
                       cr.radius, cr.hydro, cr.donor, cr.acceptor, cr.mask),
        itab=vina._intra_tab(vl),
    )


def clash_energy(x, rec_pos, tabs: _PairTabs, w: RelaxWeights):
    """[B] quadratic overlap penalties at the PoseBusters thresholds (with
    CLASH_MARGIN headroom): ligand internal and ligand-protein."""
    e_int = 0.5 * (tabs.pair_m * _floor(tabs.lim - _dist(x, x), 0.0) ** 2).sum(dim=(-1, -2))
    e_prot = (tabs.pm * _floor(tabs.plim - _dist(x, rec_pos), 0.0) ** 2).sum(dim=(-1, -2))
    return w.k_int_clash * e_int + w.k_prot_clash * e_prot


def relax_energy(x, drec, x0, rec_pos0, cl: CartesianLigand, vl: vina.VinaLigand,
                 cr: CartesianReceptor, w: RelaxWeights, gat: _BondedGather | None = None,
                 tabs: _PairTabs | None = None):
    """[B] relax energy of ligand coordinates x and receptor displacements
    drec about the inputs x0, rec_pos0."""
    if tabs is None:
        tabs = _pair_tabs(cl, vl, cr)
    rec_pos = rec_pos0 + drec
    e = ligand_bonded_energy(x, cl, w, gat=gat)
    e = e + clash_energy(x, rec_pos, tabs, w)
    e = e + w.w_vina * (vina._inter_energy_tab(x, rec_pos, tabs.vtab)
                        + vina._intra_energy_tab(x, tabs.itab))
    e = e + w.k_pos_lig * (cl.mask[..., None] * (x - x0) ** 2).sum(dim=(-1, -2))
    e = e + w.k_pos_rec * (cr.mask[..., None] * drec**2).sum(dim=(-1, -2))
    return e


# ---------------------------------------------------------------------------
# minimization
# ---------------------------------------------------------------------------


def pack_receptor(atom14_pos, cr: CartesianReceptor):
    """[B, NA, 3] packed receptor atoms of per-pose atom14 [B, R, 14, 3]."""
    flat = atom14_pos.reshape(atom14_pos.shape[0], -1, 3)
    return torch.gather(flat, 1, cr.pack_idx[..., None].expand(*cr.pack_idx.shape, 3))


def cartesian_minimize_batch(lig_pos0, atom14_pos, cls: CartesianLigand,
                             vls: vina.VinaLigand, crs: CartesianReceptor, steps: int = 300,
                             lr: float = 0.02, weights: RelaxWeights = RelaxWeights()):
    """All-atom Cartesian fine-relax of B complexes: lig_pos0 [B, NL, 3],
    atom14_pos [B, R, 14, 3] (pocket frame), tables with a batch axis.
    Returns (lig_pos [B, NL, 3], atom14_pos [B, R, 14, 3]): padded ligand
    rows keep their input, receptor displacements are added back into the
    atom14 layout. The JAX package's `cartesian_minimize` is this at B = 1."""
    lig_pos0 = lig_pos0.detach()
    B = lig_pos0.shape[0]
    rec_pos0 = pack_receptor(atom14_pos, crs)
    gat = _bonded_gather(cls)
    tabs = _pair_tabs(cls, vls, crs)

    def energy(x, d):
        return relax_energy(x, d, lig_pos0, rec_pos0, cls, vls, crs, weights, gat=gat,
                            tabs=tabs)

    params = [lig_pos0.clone(), torch.zeros_like(rec_pos0)]
    adam = vina.Adam(params, lr, steps)
    for count in range(steps):
        params = adam.update(params, vina.grads_of(energy, params), count)
    with torch.no_grad():
        x = torch.where(cls.mask[..., None] > 0, params[0], lig_pos0)
        d = params[1] * crs.mask[..., None]
        a14 = atom14_pos.reshape(B, -1, 3).scatter_add(
            1, crs.pack_idx[..., None].expand(*crs.pack_idx.shape, 3), d)
        return x, a14.reshape(atom14_pos.shape)
