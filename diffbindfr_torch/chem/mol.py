"""Ligand perception: rings, aromaticity, hybridization, valence, H counts;
the port's counterpart of diffbindfr_tpu/chem/mol.py.

The molecular graph is the port's own adjacency structure (`MolGraph`), in
place of the JAX package's networkx graph. The ring list decides aromaticity
and the ring-membership features, and in fused ring systems which cycles
form the basis (and in what cyclic order) depends on the traversal, so
`cycle_basis` follows networkx 3.6.1's `cycle_basis` step for step (Paton's
algorithm, CACM 491): the same cycles, in the same order, each starting at
the same atom. Neighbours iterate in the order their bonds were added, as in
networkx's adjacency dicts.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from ..constants import ligands as lc
from ..constants import periodic as pt
from ..io.sdf import RawMol


class MolGraph:
    """Undirected graph on atoms 0..n-1: one insertion-ordered dict per atom,
    neighbour -> bond order (networkx's Graph adjacency, edge data 'order')."""

    def __init__(self, n: int):
        self.adj = [dict() for _ in range(n)]

    def add_edge(self, a: int, b: int, order: int = 1) -> None:
        self.adj[a][b] = order
        self.adj[b][a] = order

    def remove_edge(self, a: int, b: int) -> None:
        del self.adj[a][b]
        if a != b:
            del self.adj[b][a]

    def neighbors(self, i: int):
        return iter(self.adj[i])

    def degree(self, i: int) -> int:
        # networkx counts a self loop twice
        return len(self.adj[i]) + (i in self.adj[i])

    def order(self, a: int, b: int) -> int:
        return self.adj[a][b]

    def copy(self) -> "MolGraph":
        g = MolGraph(0)
        g.adj = [dict(d) for d in self.adj]
        return g

    def component(self, source: int) -> set:
        """Atoms connected to `source` (breadth first)."""
        seen = {source}
        todo = deque([source])
        while todo:
            for nbr in self.adj[todo.popleft()]:
                if nbr not in seen:
                    seen.add(nbr)
                    todo.append(nbr)
        return seen

    def has_path(self, a: int, b: int) -> bool:
        if a == b:
            return True
        seen = {a}
        todo = deque([a])
        while todo:
            for nbr in self.adj[todo.popleft()]:
                if nbr == b:
                    return True
                if nbr not in seen:
                    seen.add(nbr)
                    todo.append(nbr)
        return False


def cycle_basis(g: MolGraph) -> list:
    """A fundamental set of cycles of g: networkx 3.6.1's
    `cycle_basis(G)` on the same graph, cycle for cycle, in its order.
    Each component's spanning tree grows from the LAST remaining atom and
    pops its stack last-in first-out; a non-tree edge (z, nbr) closes the
    cycle nbr, z, pred(z), ... up to the first atom already joined to
    nbr."""
    gnodes = dict.fromkeys(range(len(g.adj)))  # insertion-ordered set
    cycles = []
    while gnodes:
        root = gnodes.popitem()[0]
        stack = [root]
        pred = {root: root}
        used = {root: set()}
        while stack:
            z = stack.pop()
            zused = used[z]
            for nbr in g.adj[z]:
                if nbr not in used:  # new atom
                    pred[nbr] = z
                    stack.append(nbr)
                    used[nbr] = {z}
                elif nbr == z:  # self loop
                    cycles.append([z])
                elif nbr not in zused:  # found a cycle
                    pn = used[nbr]
                    cycle = [nbr, z]
                    p = pred[z]
                    while p not in pn:
                        cycle.append(p)
                        p = pred[p]
                    cycle.append(p)
                    cycles.append(cycle)
                    used[nbr].add(z)
        for node in pred:
            gnodes.pop(node, None)
    return cycles


@dataclasses.dataclass
class Molecule:
    raw: RawMol
    graph: MolGraph
    elements: list[str]
    coords: np.ndarray  # [A, 3]
    bonds: np.ndarray  # [B, 2]
    bond_orders: np.ndarray  # [B]
    formal_charges: np.ndarray  # [A]
    rings: list[list[int]]
    aromatic_atoms: np.ndarray  # [A] bool
    aromatic_bonds: np.ndarray  # [B] bool
    degree: np.ndarray  # [A]
    explicit_valence: np.ndarray  # [A] sum of bond orders (aromatic=1.5)
    implicit_h: np.ndarray  # [A]
    hybridization: list[str]
    in_ring_of_size: np.ndarray  # [A, 6] sizes 3..8
    num_rings_per_atom: np.ndarray  # [A]

    @property
    def num_atoms(self) -> int:
        return len(self.elements)


def perceive(raw: RawMol, remove_hs: bool = True) -> Molecule:
    """Build a Molecule with perceived chemistry from a parsed RawMol."""
    elements = list(raw.elements)
    coords = raw.coords.copy()
    bonds = raw.bonds.copy()
    orders = raw.bond_orders.copy()
    charges = raw.formal_charges.copy()

    explicit_h_count = np.zeros(len(elements), dtype=np.int64)
    if remove_hs and "H" in elements:
        heavy = np.array([e != "H" for e in elements])
        remap = -np.ones(len(elements), dtype=np.int64)
        remap[heavy] = np.arange(heavy.sum())
        keep_bonds = []
        for (a, b), o in zip(bonds, orders):
            if elements[a] == "H" and elements[b] != "H":
                explicit_h_count[b] += 1
            elif elements[b] == "H" and elements[a] != "H":
                explicit_h_count[a] += 1
            elif elements[a] != "H" and elements[b] != "H":
                keep_bonds.append((remap[a], remap[b], o))
        elements = [e for e, h in zip(elements, heavy) if h]
        coords = coords[heavy]
        charges = charges[heavy]
        explicit_h_count = explicit_h_count[heavy]
        if keep_bonds:
            arr = np.array(keep_bonds, dtype=np.int64)
            bonds, orders = arr[:, :2], arr[:, 2]
        else:
            bonds = np.zeros((0, 2), dtype=np.int64)
            orders = np.zeros(0, dtype=np.int64)

    na = len(elements)
    g = MolGraph(na)
    for (a, b), o in zip(bonds, orders):
        g.add_edge(int(a), int(b), int(o))

    rings = cycle_basis(g)
    ring_sets = [set(r) for r in rings]

    aromatic_atoms = np.zeros(na, dtype=bool)
    aromatic_bonds = np.zeros(len(bonds), dtype=bool)
    # 1) explicit aromatic orders
    for i, ((a, b), o) in enumerate(zip(bonds, orders)):
        if o == 4:
            aromatic_bonds[i] = True
            aromatic_atoms[a] = aromatic_atoms[b] = True
    # 2) kekulized aromatic rings: 5/6-rings of sp2-capable atoms with
    #    alternating single/double pattern
    bond_index = {(min(a, b), max(a, b)): i for i, (a, b) in enumerate(map(tuple, bonds))}
    for ring in rings:
        if len(ring) not in (5, 6):
            continue
        ring_bonds = []
        ok = True
        for k in range(len(ring)):
            a, b = ring[k], ring[(k + 1) % len(ring)]
            bi = bond_index.get((min(a, b), max(a, b)))
            if bi is None:
                ok = False
                break
            ring_bonds.append(bi)
        if not ok:
            continue
        if not all(elements[a] in ("C", "N", "O", "S") for a in ring):
            continue
        ring_orders = orders[ring_bonds]
        n_double = int(np.sum(ring_orders == 2) + np.sum(ring_orders == 4))
        # benzene-like: 3 doubles in 6-ring; heteroaromatics: 2 doubles in
        # 5-ring with one lone-pair donor
        if (len(ring) == 6 and n_double >= 3) or (len(ring) == 5 and n_double >= 2):
            for a in ring:
                aromatic_atoms[a] = True
            for bi in ring_bonds:
                aromatic_bonds[bi] = True

    degree = np.array([g.degree(i) for i in range(na)], dtype=np.int64)

    # explicit valence: sum of bond orders; aromatic counts 1.5 then rounded
    ev = np.zeros(na, dtype=np.float64)
    for i, ((a, b), o) in enumerate(zip(bonds, orders)):
        v = 1.5 if (o == 4 or aromatic_bonds[i]) else float(o)
        ev[a] += v
        ev[b] += v
    explicit_valence = np.ceil(ev - 1e-6).astype(np.int64) + explicit_h_count

    implicit_h = np.zeros(na, dtype=np.int64)
    for i, el in enumerate(elements):
        dv = pt.DEFAULT_VALENCE.get(el)
        if dv is None:
            continue
        target = dv + int(charges[i]) if el in ("N", "O", "S", "P", "C") else dv
        implicit_h[i] = max(0, target - explicit_valence[i])

    hybridization = []
    for i, el in enumerate(elements):
        if el in ("F", "Cl", "Br", "I", "H"):
            hybridization.append("other")
            continue
        nbo = [orders[bond_index[(min(i, j), max(i, j))]] for j in g.neighbors(i)]
        if aromatic_atoms[i]:
            hybridization.append("SP2")
        elif 3 in nbo or (nbo.count(2) >= 2 and el == "C"):
            hybridization.append("SP")
        elif 2 in nbo:
            hybridization.append("SP2")
        else:
            heavy_nb = degree[i] + implicit_h[i] + explicit_h_count[i]
            if heavy_nb > 4 and el in ("P", "S"):
                hybridization.append("SP3D" if heavy_nb == 5 else "SP3D2")
            else:
                hybridization.append("SP3")

    in_ring_of_size = np.zeros((na, lc.num_ring_sizes), dtype=np.float32)
    num_rings_per_atom = np.zeros(na, dtype=np.int64)
    for rs in ring_sets:
        size = len(rs)
        for a in rs:
            num_rings_per_atom[a] += 1
            if 3 <= size <= 8:
                in_ring_of_size[a, size - 3] = 1.0

    return Molecule(
        raw=raw,
        graph=g,
        elements=elements,
        coords=coords,
        bonds=bonds,
        bond_orders=orders,
        formal_charges=charges,
        rings=rings,
        aromatic_atoms=aromatic_atoms,
        aromatic_bonds=aromatic_bonds,
        degree=degree + explicit_h_count,
        explicit_valence=explicit_valence,
        implicit_h=implicit_h,
        hybridization=hybridization,
        in_ring_of_size=in_ring_of_size,
        num_rings_per_atom=num_rings_per_atom,
    )


def ring_bond_mask(mol: Molecule) -> np.ndarray:
    """[B] bool: bond participates in any ring."""
    out = np.zeros(len(mol.bonds), dtype=bool)
    g2 = mol.graph.copy()
    for i, (a, b) in enumerate(map(tuple, mol.bonds)):
        o = g2.order(a, b)
        g2.remove_edge(a, b)
        # a bond is in a ring iff removing it keeps endpoints connected
        out[i] = g2.has_path(a, b)
        g2.add_edge(a, b, o)
    return out
