"""Protein-like structures from a seed: the one generator every traffic mix
reads its parameters into.

A structure is a chain of residues. Residue counts follow a lognormal size
law (median and sigma in log, clipped), taken at stratified quantiles so
that every seed gets the same set of sizes in another order. Residue types
are the 20 standard amino acids at UniProt frequencies, each with its real
heavy-atom names (elements follow from the names). The CA trace is a
random walk of 3.8 A steps confined to a sphere that holds the structure's
heavy atoms at a folded protein's density; the other atoms of a residue sit
at fixed template offsets from its CA, turned by a random rotation.

`make_records` gives the records the port's PDB reader produces (after its
clean-up); `pdb_text` writes them as PDB text, vectorised.
"""

import statistics

import numpy as np

# UniProtKB/Swiss-Prot amino-acid composition (%), release statistics
AA_FREQ = {
    "ALA": 8.25, "ARG": 5.53, "ASN": 4.06, "ASP": 5.45, "CYS": 1.37,
    "GLN": 3.93, "GLU": 6.75, "GLY": 7.07, "HIS": 2.27, "ILE": 5.96,
    "LEU": 9.66, "LYS": 5.84, "MET": 2.42, "PHE": 3.86, "PRO": 4.70,
    "SER": 6.56, "THR": 5.34, "TRP": 1.08, "TYR": 2.92, "VAL": 6.87,
}
SIDE = {
    "GLY": (), "ALA": ("CB",), "SER": ("CB", "OG"), "CYS": ("CB", "SG"),
    "VAL": ("CB", "CG1", "CG2"), "THR": ("CB", "OG1", "CG2"), "PRO": ("CB", "CG", "CD"),
    "ILE": ("CB", "CG1", "CG2", "CD1"), "LEU": ("CB", "CG", "CD1", "CD2"),
    "ASP": ("CB", "CG", "OD1", "OD2"), "ASN": ("CB", "CG", "OD1", "ND2"),
    "GLU": ("CB", "CG", "CD", "OE1", "OE2"), "GLN": ("CB", "CG", "CD", "OE1", "NE2"),
    "LYS": ("CB", "CG", "CD", "CE", "NZ"), "MET": ("CB", "CG", "SD", "CE"),
    "HIS": ("CB", "CG", "ND1", "CD2", "CE1", "NE2"),
    "PHE": ("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"),
    "TYR": ("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"),
    "ARG": ("CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"),
    "TRP": ("CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"),
}
RESNAMES = tuple(AA_FREQ)
STEP = 3.8            # A between consecutive CAs
DENSITY = 0.055       # heavy atoms per A^3 (1.35 g/cm^3)
GRID = 8              # coordinates are multiples of 1/GRID A


def _templates():
    """Per residue type: atom names (CA first) and offsets from the CA.
    Backbone atoms sit 1.45-2.4 A away, side atoms 1.5 A further per step
    along the side chain, each bond turned off the chain's axis, so no two
    atoms of a residue come within 1.2 A."""
    rng = np.random.default_rng(20260917)  # fixed: templates are part of the generator
    names, offsets = {}, {}
    for rn in RESNAMES:
        side = SIDE[rn]
        atoms = ("CA", "N", "C", "O") + side
        off = np.zeros((len(atoms), 3))
        off[1] = (-0.55, 1.35, 0.0)            # N
        off[2] = (1.52, 0.0, 0.0)              # C
        off[3] = (2.15, 1.05, 0.2)             # O
        pos = np.zeros(3)
        axis = np.array([-0.5, -0.6, 0.9])
        axis /= np.linalg.norm(axis)
        for j in range(len(side)):
            d = axis + 0.5 * rng.standard_normal(3)
            pos = pos + 1.5 * d / np.linalg.norm(d)
            off[4 + j] = pos
        names[rn] = atoms
        offsets[rn] = off.astype(np.float64)
    return names, offsets


TEMPLATE_NAMES, TEMPLATE_OFFSETS = _templates()
MEAN_ATOMS_PER_RES = sum(AA_FREQ[r] * len(TEMPLATE_NAMES[r]) for r in RESNAMES) / sum(AA_FREQ.values())
# every (residue type, atom) of the templates as one "kind": its residue
# type's first kind, and per kind the offset, the names and a PDB line
# with the per-atom columns (serial, resid, coordinates) left blank
RES_SIZES = np.array([len(TEMPLATE_NAMES[r]) for r in RESNAMES])
RES_FIRST = np.concatenate([[0], np.cumsum(RES_SIZES)[:-1]])
KIND_OFFSET = np.concatenate([TEMPLATE_OFFSETS[r] for r in RESNAMES])
KIND_NAME = np.array([a for r in RESNAMES for a in TEMPLATE_NAMES[r]], dtype="U4")
KIND_RESNAME = np.array([r for r in RESNAMES for _ in TEMPLATE_NAMES[r]], dtype="U3")
KIND_ELEMENT = KIND_NAME.astype("U1").astype("U2")
KIND_LINE = np.array([list(b"ATOM        %-4s %3s A                                  0.00  0.00          %2s  \n"
                           % (f" {a}".encode(), r.encode(), a[:1].encode()))
                      for r in RESNAMES for a in TEMPLATE_NAMES[r]], dtype=np.uint8)


def size_law(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """Residue counts of n structures: the lognormal's quantiles at
    (i + 1/2) / n, clipped to [lo, hi], in ascending order."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def _random_rotations(rng, n):
    """n uniformly random 3x3 rotations (from unit quaternions)."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def _ca_traces(rng, n_res: np.ndarray) -> list:
    """One confined random walk per structure, walked for all structures at
    once: CA coordinates [n_res_i, 3] each."""
    n = len(n_res)
    L = int(n_res.max())
    radius = (3 * n_res * MEAN_ATOMS_PER_RES / (4 * np.pi * DENSITY)) ** (1 / 3)
    pos = np.zeros((n, 3))
    out = np.zeros((L, n, 3))
    steps = rng.standard_normal((L, n, 3))
    steps *= STEP / np.linalg.norm(steps, axis=2, keepdims=True)
    for i in range(1, L):
        nxt = pos + steps[i]
        outside = np.linalg.norm(nxt, axis=1) > radius
        nxt[outside] = pos[outside] - steps[i][outside]
        r = np.linalg.norm(nxt, axis=1)
        over = r > radius
        nxt[over] *= (radius[over] / r[over])[:, None]
        pos = nxt
        out[i] = pos
    return [out[: int(k), i] for i, k in enumerate(n_res)]


def on_grid(xyz: np.ndarray, rng) -> np.ndarray:
    """Coordinates moved to multiples of 1/GRID A, centred so that their
    sum is exactly 0 on each axis, no two atoms at one point. Every
    squared distance, norm and dot product of such coordinates (under
    128 A from the centre: at most 12 x 1024^2 < 2^24 in units of
    1/GRID^2) is exact in float32, so a Gram-form and a direct difference
    give the same neighbours, ties to the lower index alike; 3 decimals
    write them exactly."""
    k = np.rint((xyz - xyz.mean(0)) * GRID).astype(np.int64)

    def repeats():
        key = ((k[:, 0] + 1024) << 22) | ((k[:, 1] + 1024) << 11) | (k[:, 2] + 1024)
        _, first = np.unique(key, return_index=True)
        return np.setdiff1d(np.arange(len(k)), first)

    for _ in range(32):
        dup = repeats()
        k[dup, rng.integers(0, 3, len(dup))] += rng.choice((-1, 1), len(dup))
        for a in range(3):
            excess = int(k[:, a].sum())
            if excess:
                who = rng.choice(len(k), size=abs(excess), replace=abs(excess) > len(k))
                np.add.at(k[:, a], who, -np.sign(excess))
        if not len(dup) and not len(repeats()):
            break
    if np.abs(k).max() >= 1024 or len(repeats()) or k.sum(0).any():
        raise ValueError("coordinates do not fit the exact grid")
    return (k / GRID).astype(np.float32)


def make_records(seed: int, n: int, median: float, sigma: float, lo: int, hi: int,
                 max_atoms: int = None, with_kinds: bool = False):
    """n structure records from `seed`, in a seeded order of the size law's
    counts. A record has
    the fields of the port's reader after clean-up: xyz float32, name,
    element, resname, resid (1..n_res), het_flag, chain_name, icode.
    max_atoms caps a structure's heavy atoms by dropping its last
    residues. with_kinds also returns each record's template kinds, which
    `pdb_text` takes."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    counts = size_law(n, median, sigma, lo, hi)
    counts = counts[rng.permutation(n)]
    probs = np.array([AA_FREQ[r] for r in RESNAMES])
    probs /= probs.sum()
    types = [rng.choice(len(RESNAMES), size=int(k), p=probs) for k in counts]
    if max_atoms is not None:
        sizes = np.array([len(TEMPLATE_NAMES[r]) for r in RESNAMES])
        for i, t in enumerate(types):
            cum = np.cumsum(sizes[t])
            types[i] = t[: int(np.searchsorted(cum, max_atoms, side="right"))]
        counts = np.array([len(t) for t in types])
    traces = _ca_traces(rng, counts)
    records, kinds = [], []
    for t, ca in zip(types, traces):
        sizes = RES_SIZES[t]
        rep = np.repeat(np.arange(len(t)), sizes)
        within = np.arange(len(rep)) - np.repeat(np.cumsum(sizes) - sizes, sizes)
        kind = RES_FIRST[t][rep] + within
        rot = _random_rotations(rng, len(t))
        xyz = ca[rep] + np.einsum("aij,aj->ai", rot[rep], KIND_OFFSET[kind])
        m = len(rep)
        records.append({
            "xyz": on_grid(xyz, rng),
            "name": KIND_NAME[kind],
            "element": KIND_ELEMENT[kind],
            "resname": KIND_RESNAME[kind],
            "resid": rep.astype(np.int64) + 1,
            "het_flag": np.full(m, "A"),
            "chain_name": np.full(m, "A:0", dtype="U32"),
            "icode": np.full(m, ""),
        })
        kinds.append(kind)
    return (records, kinds) if with_kinds else records


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    """Non-negative integers -> [n, width] uint8 of right-aligned decimal
    digits, leading blanks."""
    v = np.asarray(v, np.int64)
    place = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    d = (v[:, None] // place[None, :]) % 10
    lead = np.cumsum(d != 0, axis=1) == 0
    lead[:, -1] = False
    return np.where(lead, ord(" "), ord("0") + d).astype(np.uint8)


def _fixed3(x: np.ndarray) -> np.ndarray:
    """float -> [n, 8] uint8 in the PDB's %8.3f."""
    milli = np.rint(np.asarray(x, np.float64) * 1000).astype(np.int64)
    neg = milli < 0
    a = np.abs(milli)
    ip, fp = a // 1000, a % 1000
    out = np.full((len(x), 8), ord(" "), np.uint8)
    out[:, 4] = ord(".")
    frac = _digits(fp + 1000, 4)[:, 1:]  # zero-padded three digits
    out[:, 5:8] = frac
    out[:, 0:4] = _digits(ip, 4)
    # the minus sign goes just before the first digit
    first = np.argmax(out[:, 0:4] != ord(" "), axis=1)
    rows = np.nonzero(neg)[0]
    out[rows, first[rows] - 1] = ord("-")
    return out


def pdb_text(rec: dict, kind: np.ndarray) -> bytes:
    """A record as PDB ATOM lines (serial, name, resname, chain A, resid,
    coordinates, occupancy and B-factor 0, element), then END; `kind` is
    the record's from `make_records(..., with_kinds=True)`."""
    n = len(rec["xyz"])
    line = KIND_LINE[kind]
    line[:, 6:11] = _digits(np.arange(1, n + 1), 5)
    line[:, 22:26] = _digits(np.asarray(rec["resid"]), 4)
    for c in range(3):
        line[:, 30 + 8 * c : 38 + 8 * c] = _fixed3(rec["xyz"][:, c])
    return line.tobytes() + b"END\n"
