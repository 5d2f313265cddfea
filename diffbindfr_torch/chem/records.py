"""Prep records of a (pocket, ligand) pair, their reader and the ligand's
identity.

Prep writes, beside each prep-cache npz, a pickle `<stem>.rec.pkl`: a dict
with the featurised ligand (`lig`), the pocket (`pocket`), the bucket
(`bucket`), the crystal ligand pose (`crystal_pos`) and optional entries.
A record the JAX package wrote names that package's record classes;
`load_prep_record` maps them onto the copies below, so reading a record
imports neither that package nor JAX, and it reads the records the port's
own prep writes (app/pipeline.py), which name these classes. Field for
field the copies match diffbindfr_tpu/chem/ligand_feats.py:27-49
(LigandRecord), diffbindfr_tpu/chem/protein_feats.py:28-68 (PocketRecord)
and diffbindfr_tpu/app/analysis.py:70-89 (HoloRef, the `holo_ref` entry of
a record written for an apo->holo job).

The port's records also carry `lig_src` (`ligand_source`): the ligand path
as the job names it (with its `#i`) and a sha256 of that record's text, so a
cache entry written for another ligand, or for an edited or reordered
library, is recomputed instead of served; and `pocket_src`
(`pocket_source`): the receptor file's sha256 and the pocket reference (the
centre, or the crystal ligand file's sha256), so an entry whose receptor or
pocket reference changed is recomputed too.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import pickle

import numpy as np

from ..data.sample import Buckets
from ..io.sdf import _record_address, file_key, read_record


@dataclasses.dataclass
class LigandRecord:
    """Featurised ligand ready for padding/batching."""

    name: str
    pos: np.ndarray  # [A, 3]
    node_feat: np.ndarray  # [A, 27]
    edge_index: np.ndarray  # [2, E] directed, both ways
    edge_feat: np.ndarray  # [E, 10]
    tor_edge_mask: np.ndarray  # [E] bool
    rot_node_mask: np.ndarray  # [T, A] bool (fragment that rotates)
    elements: list
    bonds: np.ndarray  # [B, 2] undirected
    bond_orders: np.ndarray  # [B]
    formal_charges: np.ndarray  # [A]

    @property
    def num_atoms(self) -> int:
        return self.pos.shape[0]

    @property
    def num_torsions(self) -> int:
        return self.rot_node_mask.shape[0]


@dataclasses.dataclass
class PocketRecord:
    """Pocket residues; every coordinate is already in the pocket frame (CA
    centroid at the origin), `center` is that centroid in the input frame."""

    aatype: np.ndarray  # [R]
    atom14_pos: np.ndarray  # [R, 14, 3]
    atom14_mask: np.ndarray  # [R, 14]
    backbone_rots: np.ndarray  # [R, 3, 3]
    backbone_transl: np.ndarray  # [R, 3]
    default_frame: np.ndarray  # [R, 8, 4, 4]
    rigid_group_positions: np.ndarray  # [R, 14, 3]
    torsion_angle: np.ndarray  # [R, 5] radians (psi, chi1-4)
    chi_mask: np.ndarray  # [R, 4] diffusable chi angles
    node_feat: np.ndarray  # [R, 14, 5] categorical
    center: np.ndarray  # [3] pocket CA centroid in input coordinates
    residue_index: np.ndarray  # [R] author numbering
    chain_index: np.ndarray  # [R]
    pocket_res_indices: np.ndarray  # [R] indices into the full protein
    group_idx: np.ndarray  # [R, 14] rigid-group index per atom
    res_extra: np.ndarray | None = None  # [R, K] optional per-residue features
    # [R, 14] atoms the input structure had (atom14_mask is after repair);
    # None in records written before the field existed
    atom14_input_mask: np.ndarray | None = None
    chain_ids: list | None = None  # author chain letters, indexed by chain_index

    @property
    def num_res(self) -> int:
        return self.aatype.shape[0]


@dataclasses.dataclass
class HoloRef:
    """Side-chain reference of an apo->holo job: the holo structure's atoms
    at the apo pocket's residues, superposed into the apo world frame (so
    `center` is zero). Row k is pocket residue k; unmatched rows have mask
    0. Export grades the rebuilt side chains against it in place of the
    input pocket."""

    aatype: np.ndarray  # [R] (the apo pocket's)
    atom14_pos: np.ndarray  # [R, 14, 3] apo world frame
    atom14_mask: np.ndarray  # [R, 14] holo atoms that exist (0 where unmatched)
    center: np.ndarray  # [3] zeros
    n_matched: int = 0
    ca_rmsd: float = float("nan")  # apo-vs-holo pocket CA RMSD after the fit

    @property
    def atom14_input_mask(self):
        return self.atom14_mask


# (module, name) in the pickle -> the class it builds here: the JAX
# package's classes, and the port's own
_RECORD_CLASSES = {
    ("diffbindfr_tpu.chem.ligand_feats", "LigandRecord"): LigandRecord,
    ("diffbindfr_tpu.chem.protein_feats", "PocketRecord"): PocketRecord,
    ("diffbindfr_tpu.data.sample", "Buckets"): Buckets,
    ("diffbindfr_tpu.app.analysis", "HoloRef"): HoloRef,
    **{(c.__module__, c.__name__): c for c in (LigandRecord, PocketRecord, Buckets, HoloRef)},
}
# numpy's array reconstruction: numpy >= 2 pickles name numpy._core, older
# ones numpy.core; either file is read under either numpy
_NUMPY_NAMES = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"), ("numpy.core.multiarray", "scalar"),
}
# what pickle itself may name for plain objects, containers and (protocols
# 0-2) bytes
_BUILTIN_NAMES = {
    ("copyreg", "_reconstructor"), ("copyreg", "__newobj__"), ("_codecs", "encode"),
    ("builtins", "object"), ("builtins", "list"), ("builtins", "dict"),
    ("builtins", "tuple"), ("builtins", "set"), ("builtins", "frozenset"),
}


def _multiarray():
    try:
        return importlib.import_module("numpy._core.multiarray")
    except ImportError:  # numpy < 2
        return importlib.import_module("numpy.core.multiarray")


class _RecordUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _RECORD_CLASSES.get((module, name))
        if cls is not None:
            return cls
        if (module, name) in _NUMPY_NAMES:
            if module == "numpy":
                return getattr(np, name)
            return getattr(_multiarray(), name)
        if (module, name) in _BUILTIN_NAMES:
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(f"prep record names a class not allowed here: {module}.{name}")


def load_prep_record(path: str) -> dict:
    """Read a `<stem>.rec.pkl` prep record: a dict whose `lig`, `pocket`,
    `bucket` and, where present, `holo_ref` are this module's LigandRecord,
    PocketRecord, the port's Buckets and this module's HoloRef. Classes
    other than those, numpy arrays and plain containers are refused."""
    with open(path, "rb") as fh:
        return _RecordUnpickler(fh).load()


def ligand_source(path: str) -> tuple:
    """`lig_src` of a job's ligand: (path as the job gives it, sha256 of the
    text of the record it names; io/sdf.read_record)."""
    return path, read_record(path)[1]


_DIGESTS: dict = {}  # io/sdf.file_key -> sha256 hex of the file's bytes


def _file_digest(path: str) -> str:
    """sha256 hex of a file's bytes, read once while the file is unchanged."""
    key = file_key(path)
    if key not in _DIGESTS:
        if len(_DIGESTS) >= 64:
            _DIGESTS.clear()
        with open(path, "rb") as fh:
            _DIGESTS[key] = hashlib.sha256(fh.read()).hexdigest()
    return _DIGESTS[key]


def pocket_source(job) -> tuple:
    """`pocket_src` of a job's pocket: (sha256 of its receptor file, the
    pocket reference's kind, the reference: the centre, or (sha256 of the
    crystal ligand's file, its record index or None))."""
    kind, ref = job.pocket_ref()
    if kind == "center":
        return _file_digest(job.protein), kind, tuple(float(x) for x in np.ravel(ref))
    base, idx = _record_address(ref)
    return _file_digest(job.protein), kind, (_file_digest(base), idx)
