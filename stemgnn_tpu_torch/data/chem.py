"""SMILES -> text-attributed molecular graphs, without RDKit (the port's
copy of ``stemgnn_tpu/data/chem.py``: the same parser, perception passes,
texts and bundles, so both packages featurize a SMILES string alike).

Re-design of the reference chem featurizer
(STEM-GNN/dataset/data/chemmol/gen_raw_graph.py:93-196 and
gen_data.py:66-110): the reference parses SMILES with RDKit and emits a
*text* description per atom and per bond ("feature node. atom: Carbon , …",
"feature edge. chemical bond. SINGLE bond , …") which the sentence encoder
turns into features; unique texts are deduplicated across the dataset and
graphs store integer ids into the unique tables.

RDKit is not available in this build, so this module implements a
self-contained SMILES reader plus the chemical perception needed to
reproduce the reference's text fields:

  element name / atomic number / chirality / total degree / formal charge /
  total H count / radical electrons / hybridization / aromatic / in-ring
  (atoms), and bond type / stereo / conjugation (bonds).

Perception notes (documented approximations — the features feed a text
encoder, so near-miss perception degrades gracefully):

  * Aromaticity is taken from the input notation (lowercase atoms / ``:``
    bonds).  ``aromatize=True`` additionally upgrades 6-membered
    alternating-Kekulé carbon/nitrogen rings found in the fundamental cycle
    basis, so Kekulé-written benzenoids match aromatic-written inputs.
    No full Hückel perception.
  * Implicit hydrogens follow the Daylight organic-subset valence rules
    (aromatic atoms donate one valence to the ring pi system).
  * Hybridization: aromatic -> SP2; triple or cumulated double -> SP;
    any double -> SP2; else SP3 (SP3D/SP3D2 for 5/6 sigma neighbors).
  * Conjugation: aromatic bonds; single bonds whose both endpoints carry
    another pi bond or an N/O/S lone pair; multiple bonds adjacent to such
    a conjugated single bond.
  * Bond stereo: E/Z from SMILES directional bonds around a double bond;
    no CIP ranking beyond the written substituents.
  * Radical electrons are reported as 0 (the reference's datasets carry
    none through RDKit's default sanitization of drug-like SMILES).

The emitted strings replicate the reference byte-for-byte — including its
"not aromatric" spelling (gen_raw_graph.py:112) — so text-feature caches
and hash-encoder features line up exactly.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------- elements

# symbol -> (atomic number, element name); mirrors the reference's
# id2element.csv lookup (gen_raw_graph.py:11-16).
_ELEMENTS = {
    "H": (1, "Hydrogen"), "He": (2, "Helium"), "Li": (3, "Lithium"),
    "Be": (4, "Beryllium"), "B": (5, "Boron"), "C": (6, "Carbon"),
    "N": (7, "Nitrogen"), "O": (8, "Oxygen"), "F": (9, "Fluorine"),
    "Ne": (10, "Neon"), "Na": (11, "Sodium"), "Mg": (12, "Magnesium"),
    "Al": (13, "Aluminum"), "Si": (14, "Silicon"), "P": (15, "Phosphorus"),
    "S": (16, "Sulfur"), "Cl": (17, "Chlorine"), "Ar": (18, "Argon"),
    "K": (19, "Potassium"), "Ca": (20, "Calcium"), "Sc": (21, "Scandium"),
    "Ti": (22, "Titanium"), "V": (23, "Vanadium"), "Cr": (24, "Chromium"),
    "Mn": (25, "Manganese"), "Fe": (26, "Iron"), "Co": (27, "Cobalt"),
    "Ni": (28, "Nickel"), "Cu": (29, "Copper"), "Zn": (30, "Zinc"),
    "Ga": (31, "Gallium"), "Ge": (32, "Germanium"), "As": (33, "Arsenic"),
    "Se": (34, "Selenium"), "Br": (35, "Bromine"), "Kr": (36, "Krypton"),
    "Rb": (37, "Rubidium"), "Sr": (38, "Strontium"), "Y": (39, "Yttrium"),
    "Zr": (40, "Zirconium"), "Nb": (41, "Niobium"), "Mo": (42, "Molybdenum"),
    "Tc": (43, "Technetium"), "Ru": (44, "Ruthenium"), "Rh": (45, "Rhodium"),
    "Pd": (46, "Palladium"), "Ag": (47, "Silver"), "Cd": (48, "Cadmium"),
    "In": (49, "Indium"), "Sn": (50, "Tin"), "Sb": (51, "Antimony"),
    "Te": (52, "Tellurium"), "I": (53, "Iodine"), "Xe": (54, "Xenon"),
    "Cs": (55, "Cesium"), "Ba": (56, "Barium"), "La": (57, "Lanthanum"),
    "Gd": (64, "Gadolinium"), "W": (74, "Tungsten"), "Re": (75, "Rhenium"),
    "Os": (76, "Osmium"), "Ir": (77, "Iridium"), "Pt": (78, "Platinum"),
    "Au": (79, "Gold"), "Hg": (80, "Mercury"), "Tl": (81, "Thallium"),
    "Pb": (82, "Lead"), "Bi": (83, "Bismuth"), "Po": (84, "Polonium"),
    "Ra": (88, "Radium"), "U": (92, "Uranium"),
}

# Daylight organic subset default valences (implicit-H rules apply only to
# atoms written without brackets).
_DEFAULT_VALENCES = {
    "B": (3,), "C": (4,), "N": (3, 5), "O": (2,), "P": (3, 5),
    "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,),
}
_ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC_OK = {"b", "c", "n", "o", "p", "s", "se", "as", "te"}


@dataclass
class Atom:
    symbol: str                      # canonical case ("C", "Cl", …)
    aromatic: bool = False
    charge: int = 0
    explicit_h: Optional[int] = None  # None = organic subset (implicit rules)
    chiral: str = ""                 # "", "@", "@@"
    isotope: int = 0
    neighbors: List[int] = field(default_factory=list)
    bond_ids: List[int] = field(default_factory=list)


@dataclass
class Bond:
    a: int
    b: int
    order: float                     # 1, 2, 3 (1.5 flagged via aromatic)
    aromatic: bool = False
    direction: int = 0               # +1 '/', -1 '\' (as written a->b)
    stereo: str = "STEREONONE"
    conjugated: bool = False


@dataclass
class Mol:
    atoms: List[Atom]
    bonds: List[Bond]


class SmilesError(ValueError):
    pass


_BRACKET_RE = re.compile(
    r"^(?P<iso>\d+)?(?P<sym>[A-Z][a-z]?|[a-z][a-z]?)(?P<chiral>@{1,2})?"
    r"(?P<h>H\d*)?(?P<chg>[+-]+\d*|[+-]\d*)?(?::\d+)?$")


def parse_smiles(s: str) -> Mol:
    """A complete reader for the SMILES subset used by molecular datasets:
    organic subset + bracket atoms (isotope / chirality / H-count / charge),
    branches, ring closures (incl. ``%nn``), bond symbols ``- = # : / \\``,
    dot-separated fragments, aromatic lowercase atoms."""
    atoms: List[Atom] = []
    bonds: List[Bond] = []
    prev: Optional[int] = None
    stack: List[Optional[int]] = []
    pending_bond: Optional[str] = None
    rings: Dict[str, Tuple[int, Optional[str]]] = {}
    i, n = 0, len(s)

    def add_atom(atom: Atom) -> int:
        atoms.append(atom)
        return len(atoms) - 1

    def add_bond(a: int, b: int, sym: Optional[str]):
        aromatic = False
        direction = 0
        if sym == "=":
            order = 2.0
        elif sym == "#":
            order = 3.0
        elif sym == ":":
            order, aromatic = 1.5, True
        elif sym in ("/", "\\"):
            order = 1.0
            direction = 1 if sym == "/" else -1
        elif sym == "-":
            order = 1.0
        else:  # implicit: aromatic if both atoms aromatic
            if atoms[a].aromatic and atoms[b].aromatic:
                order, aromatic = 1.5, True
            else:
                order = 1.0
        bid = len(bonds)
        bonds.append(Bond(a, b, order, aromatic, direction))
        atoms[a].neighbors.append(b)
        atoms[a].bond_ids.append(bid)
        atoms[b].neighbors.append(a)
        atoms[b].bond_ids.append(bid)

    def attach(idx: int):
        nonlocal prev, pending_bond
        if prev is not None:
            add_bond(prev, idx, pending_bond)
        prev = idx
        pending_bond = None

    def ring_closure(label: str):
        nonlocal pending_bond
        if label in rings:
            other, sym0 = rings.pop(label)
            sym = pending_bond or sym0
            if prev is None:
                raise SmilesError(f"ring closure {label} with no open atom")
            add_bond(other, prev, sym)
        else:
            if prev is None:
                raise SmilesError(f"ring open {label} with no atom")
            rings[label] = (prev, pending_bond)
        pending_bond = None

    while i < n:
        c = s[i]
        if c in "-=#:/\\":
            pending_bond = c
            i += 1
        elif c == "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError("unbalanced ')'")
            prev = stack.pop()
            i += 1
        elif c == ".":
            prev = None
            pending_bond = None
            i += 1
        elif c.isdigit():
            ring_closure(c)
            i += 1
        elif c == "%":
            if i + 2 >= n or not s[i + 1: i + 3].isdigit():
                raise SmilesError(f"bad ring label at {i}")
            ring_closure(s[i + 1: i + 3])
            i += 3
        elif c == "[":
            j = s.find("]", i)
            if j < 0:
                raise SmilesError("unterminated bracket atom")
            m = _BRACKET_RE.match(s[i + 1: j])
            if not m:
                raise SmilesError(f"bad bracket atom {s[i: j + 1]!r}")
            sym = m.group("sym")
            aromatic = sym[0].islower()
            if aromatic and sym not in _AROMATIC_OK:
                raise SmilesError(f"non-aromatic element written lowercase: {sym}")
            canon = sym.capitalize() if aromatic else sym
            h = m.group("h")
            h_count = 0 if h is None else (int(h[1:]) if len(h) > 1 else 1)
            chg_s = m.group("chg") or ""
            if chg_s in ("", None):
                charge = 0
            elif chg_s.strip("+-").isdigit() and chg_s.strip("+-"):
                charge = int(chg_s.strip("+-")) * (1 if "+" in chg_s else -1)
            else:
                charge = chg_s.count("+") - chg_s.count("-")
            atom = Atom(symbol=canon, aromatic=aromatic, charge=charge,
                        explicit_h=h_count,
                        chiral=m.group("chiral") or "",
                        isotope=int(m.group("iso") or 0))
            attach(add_atom(atom))
            i = j + 1
        else:
            # organic-subset atom, two-letter first (Cl/Br)
            two = s[i: i + 2]
            if two in ("Cl", "Br"):
                attach(add_atom(Atom(symbol=two)))
                i += 2
            elif c.upper() in _ORGANIC_SUBSET and len(c) == 1:
                aromatic = c.islower()
                if aromatic and c not in _AROMATIC_OK:
                    raise SmilesError(f"bad aromatic atom {c!r}")
                attach(add_atom(Atom(symbol=c.upper(), aromatic=aromatic)))
                i += 1
            else:
                raise SmilesError(f"unexpected character {c!r} at {i} in {s!r}")
    if rings:
        raise SmilesError(f"unclosed ring bonds: {sorted(rings)}")
    if stack:
        raise SmilesError("unbalanced '('")
    return Mol(atoms, bonds)


# ---------------------------------------------------------------- perception

def _remove_explicit_h(mol: Mol) -> Mol:
    """Fold explicit [H] atoms into their heavy neighbor's H count
    (RDKit MolFromSmiles removeHs=True default, gen_raw_graph.py:157)."""
    drop = [i for i, a in enumerate(mol.atoms)
            if a.symbol == "H" and a.charge == 0 and a.isotope == 0
            and len(a.neighbors) == 1]
    if not drop:
        return mol
    dropset = set(drop)
    for i in drop:
        nb = mol.atoms[i].neighbors[0]
        if nb in dropset:          # H-H: keep as-is
            return mol
        a = mol.atoms[nb]
        a.explicit_h = (a.explicit_h or 0) + 1
    remap = {}
    atoms = []
    for i, a in enumerate(mol.atoms):
        if i not in dropset:
            remap[i] = len(atoms)
            atoms.append(Atom(a.symbol, a.aromatic, a.charge, a.explicit_h,
                              a.chiral, a.isotope))
    bonds = []
    for b in mol.bonds:
        if b.a in dropset or b.b in dropset:
            continue
        bid = len(bonds)
        nb = Bond(remap[b.a], remap[b.b], b.order, b.aromatic, b.direction,
                  b.stereo, b.conjugated)
        bonds.append(nb)
        atoms[nb.a].neighbors.append(nb.b)
        atoms[nb.a].bond_ids.append(bid)
        atoms[nb.b].neighbors.append(nb.a)
        atoms[nb.b].bond_ids.append(bid)
    return Mol(atoms, bonds)


def _find_bridges(mol: Mol) -> set:
    """Bridge bond ids (iterative Tarjan).  Non-bridge bonds are in rings."""
    n = len(mol.atoms)
    disc = [-1] * n
    low = [0] * n
    bridges = set()
    timer = 0
    for root in range(n):
        if disc[root] != -1:
            continue
        stack = [(root, -1, iter(zip(mol.atoms[root].neighbors,
                                     mol.atoms[root].bond_ids)))]
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            u, pb, it = stack[-1]
            advanced = False
            for v, bid in it:
                if bid == pb:
                    continue
                if disc[v] == -1:
                    disc[v] = low[v] = timer
                    timer += 1
                    stack.append((v, bid, iter(zip(mol.atoms[v].neighbors,
                                                   mol.atoms[v].bond_ids))))
                    advanced = True
                    break
                low[u] = min(low[u], disc[v])
            if advanced:
                continue
            stack.pop()
            if stack:
                p = stack[-1][0]
                low[p] = min(low[p], low[u])
                if low[u] > disc[p]:
                    bridges.add(pb)
    return bridges


def _fundamental_cycles(mol: Mol) -> List[List[int]]:
    """Cycles of a BFS spanning forest (the nx.cycle_basis analog used for
    the reference's cycle score, gen_raw_graph.py:137-148)."""
    n = len(mol.atoms)
    parent = [-2] * n
    parent_bond = [-1] * n
    depth = [0] * n
    cycles = []
    for root in range(n):
        if parent[root] != -2:
            continue
        parent[root] = -1
        queue = [root]
        seen_bonds = set()
        while queue:
            u = queue.pop()
            for v, bid in zip(mol.atoms[u].neighbors, mol.atoms[u].bond_ids):
                if bid in seen_bonds:
                    continue
                seen_bonds.add(bid)
                if parent[v] == -2:
                    parent[v] = u
                    parent_bond[v] = bid
                    depth[v] = depth[u] + 1
                    queue.append(v)
                else:
                    # non-tree edge: fundamental cycle u..lca..v
                    path_u, path_v = [u], [v]
                    uu, vv = u, v
                    while depth[uu] > depth[vv]:
                        uu = parent[uu]
                        path_u.append(uu)
                    while depth[vv] > depth[uu]:
                        vv = parent[vv]
                        path_v.append(vv)
                    while uu != vv:
                        uu, vv = parent[uu], parent[vv]
                        path_u.append(uu)
                        path_v.append(vv)
                    cycles.append(path_u + path_v[-2::-1])
    return cycles


def _aromatize_kekule(mol: Mol):
    """Upgrade 6-membered alternating single/double C/N rings to aromatic
    so Kekulé-written benzenoids match aromatic-written inputs."""
    bond_of = {}
    for bid, b in enumerate(mol.bonds):
        bond_of[(b.a, b.b)] = bid
        bond_of[(b.b, b.a)] = bid
    for cyc in _fundamental_cycles(mol):
        if len(cyc) != 6:
            continue
        if any(mol.atoms[i].symbol not in ("C", "N") for i in cyc):
            continue
        bids = [bond_of[(cyc[k], cyc[(k + 1) % 6])] for k in range(6)]
        orders = [mol.bonds[bid].order for bid in bids]
        if sorted(set(orders)) != [1.0, 2.0]:
            continue
        alternating = all(orders[k] != orders[(k + 1) % 6] for k in range(6))
        if not alternating:
            continue
        for bid in bids:
            mol.bonds[bid].order = 1.5
            mol.bonds[bid].aromatic = True
        for i in cyc:
            mol.atoms[i].aromatic = True


def _implicit_h(atom: Atom, bond_order_sum: float, n_arom: int) -> int:
    if atom.explicit_h is not None:          # bracket atom: explicit only
        return atom.explicit_h
    if atom.symbol not in _DEFAULT_VALENCES:
        return 0
    if atom.aromatic:
        # one valence goes to the ring pi system (Daylight rule)
        used = len(atom.neighbors) + 1
    else:
        used = int(np.ceil(bond_order_sum))
    for v in _DEFAULT_VALENCES[atom.symbol]:
        if v >= used:
            return v - used
    return 0


def _hybridization(atom: Atom, mol: Mol, total_h: int) -> str:
    if atom.aromatic:
        return "SP2"
    orders = [mol.bonds[bid].order for bid in atom.bond_ids]
    if any(o == 3.0 for o in orders) or sum(1 for o in orders if o == 2.0) >= 2:
        return "SP"
    sigma = len(atom.neighbors) + total_h
    if sigma >= 6:
        return "SP3D2"
    if sigma == 5:
        return "SP3D"
    if any(o == 2.0 for o in orders):
        return "SP2"
    return "SP3"


_LONE_PAIR = {"N", "O", "S"}


def _perceive_conjugation(mol: Mol):
    def has_other_pi(atom: Atom, bid0: int) -> bool:
        return any(bid != bid0 and (mol.bonds[bid].order >= 2.0
                                    or mol.bonds[bid].aromatic)
                   for bid in atom.bond_ids)

    def contributor(atom: Atom, bid0: int) -> bool:
        if has_other_pi(atom, bid0):
            return True
        return atom.symbol in _LONE_PAIR and atom.charge <= 0

    conj_single = set()
    for bid, b in enumerate(mol.bonds):
        if b.aromatic:
            b.conjugated = True
        elif b.order == 1.0:
            if contributor(mol.atoms[b.a], bid) and \
                    contributor(mol.atoms[b.b], bid):
                b.conjugated = True
                conj_single.add(bid)
    for b in mol.bonds:
        if b.order >= 2.0 and not b.conjugated:
            adjacent = set(mol.atoms[b.a].bond_ids) | \
                set(mol.atoms[b.b].bond_ids)
            if any(a_bid in conj_single or mol.bonds[a_bid].aromatic
                   for a_bid in adjacent):
                b.conjugated = True


def _perceive_stereo(mol: Mol):
    """E/Z from directional single bonds flanking each double bond."""
    for b in mol.bonds:
        if b.order != 2.0 or b.aromatic:
            continue

        def side_slope(atom_idx: int) -> Optional[int]:
            for bid in mol.atoms[atom_idx].bond_ids:
                d = mol.bonds[bid]
                if d.direction == 0:
                    continue
                # written X d A (neighbor first): slope = d
                # written A d X (atom first):     slope = -d
                if d.b == atom_idx:
                    return d.direction
                if d.a == atom_idx:
                    return -d.direction
            return None

        s1, s2 = side_slope(b.a), side_slope(b.b)
        if s1 is None or s2 is None:
            continue
        # F/C=C/F: substituents sit on opposite sides of the bond axis
        # (slopes differ under this convention) -> trans (E).
        b.stereo = "STEREOE" if s1 != s2 else "STEREOZ"


# ---------------------------------------------------------------- text

_CHIRALITY_TEXT = {"": "unspecified", "@": "tetrahedral counter-clockwise",
                   "@@": "tetrahedral clockwise"}
_STEREO_TEXT = {"STEREONONE": "none", "STEREOZ": "Z", "STEREOE": "E",
                "STEREOCIS": "CIS", "STEREOTRANS": "TRANS",
                "STEREOANY": "ANY"}


def _atom_text(atom: Atom, mol: Mol) -> str:
    """Byte-for-byte the reference's atom_to_feature (gen_raw_graph.py:93-116),
    incl. its 'not aromatric' spelling."""
    num, name = _ELEMENTS.get(atom.symbol, (0, atom.symbol))
    order_sum = sum(mol.bonds[bid].order for bid in atom.bond_ids)
    n_arom = sum(1 for bid in atom.bond_ids if mol.bonds[bid].aromatic)
    h = _implicit_h(atom, order_sum, n_arom)
    degree = len(atom.neighbors) + h          # GetTotalDegree (H included)
    in_ring = getattr(atom, "_in_ring", False)
    fields = [
        name,
        "atomic number is " + str(num),
        _CHIRALITY_TEXT.get(atom.chiral, "misc") + " chirality",
        "degree of " + str(degree),
        "formal charge of " + str(atom.charge),
        "num of hydrogen is " + str(h),
        "num of radical electrons is 0",
        "hybridization is " + _hybridization(atom, mol, h),
        "is aromatic" if atom.aromatic else "not aromatric",
        "is in ring" if in_ring else "not in ring",
    ]
    return "feature node. atom: " + " , ".join(fields)


_BOND_TYPE_TEXT = {1.0: "SINGLE", 1.5: "AROMATIC", 2.0: "DOUBLE",
                   3.0: "TRIPLE"}


def _bond_text(bond: Bond) -> str:
    """bond_to_feature (gen_raw_graph.py:119-134)."""
    fields = [
        _BOND_TYPE_TEXT.get(bond.order, "misc") + " bond",
        "bond stereo is " + _STEREO_TEXT[bond.stereo],
        "is conjugated" if bond.conjugated else "not conjugated",
    ]
    return "feature edge. chemical bond. " + " , ".join(fields)


# ---------------------------------------------------------------- public API

def smiles2graph(smiles: str, *, removeHs: bool = True,
                 aromatize: bool = True) -> dict:
    """SMILES -> {node_feat: [texts], edge_feat: [texts], edge_list [E,2]
    (both directions), cycle: score} — the reference's smiles2graph contract
    (gen_raw_graph.py:150-196)."""
    mol = parse_smiles(smiles)
    if removeHs:
        mol = _remove_explicit_h(mol)
    if aromatize:
        _aromatize_kekule(mol)
    bridges = _find_bridges(mol)
    ring_atoms = set()
    for bid, b in enumerate(mol.bonds):
        if bid not in bridges:
            ring_atoms.update((b.a, b.b))
    for i, a in enumerate(mol.atoms):
        a._in_ring = i in ring_atoms
    _perceive_conjugation(mol)
    _perceive_stereo(mol)

    cycles = _fundamental_cycles(mol)
    max_cycle = max((len(c) for c in cycles), default=0)
    cycle_score = -(max_cycle - 6) if max_cycle > 6 else 0

    node_texts = [_atom_text(a, mol) for a in mol.atoms]
    edges, edge_texts = [], []
    for b in mol.bonds:
        t = _bond_text(b)
        edges.append((b.a, b.b))
        edge_texts.append(t)
        edges.append((b.b, b.a))
        edge_texts.append(t)
    edge_list = np.asarray(edges, np.int64) if edges else np.zeros((0, 2),
                                                                   np.int64)
    return {"edge_list": edge_list, "edge_feat": edge_texts,
            "node_feat": node_texts, "cycle": cycle_score}


def mol_dataset_from_smiles(smiles_list: Sequence[str],
                            labels: np.ndarray,
                            split_names: Sequence[str],
                            encoder=None, dim: int = 768,
                            indexed: bool = False):
    """Full chem dataset assembly (gen_data.py:66-110): parse every SMILES,
    deduplicate node/edge texts across the dataset, encode unique texts once,
    and return (graphs, labels, split) in the graph-task bundle format
    consumed by ``run_finetune(task='graph')``.

    ``labels``: [G, T] float with NaN for absent tasks.  ``split_names``:
    per-graph 'train'|'valid'|'test'.  ``encoder``: a text encoder with
    ``.encode(list[str]) -> [K, D]`` (default: offline hash encoder).

    ``indexed=True`` returns an :class:`IndexedGraphList` — per-graph int
    ids into the shared dedup tables instead of materialized [n_i, D]
    feature rows.  At chempcba scale (437k molecules x 768 dims) the
    materialized form needs ~30 GB host RAM and makes every epoch's batch
    building memcpy-bound; the indexed form is ~100 B/graph and gathers
    features on device (see BASELINE.md graph-eval measurement).
    """
    from stemgnn_tpu_torch.core.graph import IndexedGraphList
    from stemgnn_tpu_torch.data.dataset import make_index_splits
    from stemgnn_tpu_torch.data.text_encoder import get_text_encoder

    if encoder is None:
        encoder = get_text_encoder("hash", dim=dim)
    parsed = [smiles2graph(s) for s in smiles_list]

    node2id: Dict[str, int] = {}
    edge2id: Dict[str, int] = {}
    for g in parsed:
        for t in g["node_feat"]:
            node2id.setdefault(t, len(node2id))
        for t in g["edge_feat"]:
            edge2id.setdefault(t, len(edge2id))
    node_table = encoder.encode(list(node2id)) if node2id else \
        np.zeros((0, dim), np.float32)
    edge_table = encoder.encode(list(edge2id)) if edge2id else \
        np.zeros((1, dim), np.float32)

    if indexed:
        items = []
        for g in parsed:
            items.append({
                "x": np.asarray([node2id[t] for t in g["node_feat"]],
                                np.int32),
                "senders": g["edge_list"][:, 0].astype(np.int32),
                "receivers": g["edge_list"][:, 1].astype(np.int32),
                "xe": np.asarray([edge2id[t] for t in g["edge_feat"]],
                                 np.int32)})
        graphs = IndexedGraphList(items, node_table.astype(np.float32),
                                  edge_table.astype(np.float32))
    else:
        graphs = []
        for g in parsed:
            nf = node_table[[node2id[t] for t in g["node_feat"]]]
            if len(g["edge_feat"]):
                ef = edge_table[[edge2id[t] for t in g["edge_feat"]]]
            else:
                ef = np.zeros((0, node_table.shape[1]), np.float32)
            graphs.append({"node_feat": nf.astype(np.float32),
                           "senders": g["edge_list"][:, 0].astype(np.int32),
                           "receivers": g["edge_list"][:, 1].astype(np.int32),
                           "edge_feat": ef.astype(np.float32)})

    idx = {"train": [], "valid": [], "test": []}
    for i, name in enumerate(split_names):
        idx[name].append(i)
    split = make_index_splits(len(graphs), idx["train"], idx["valid"],
                              idx["test"])
    return graphs, np.asarray(labels, np.float64), split
