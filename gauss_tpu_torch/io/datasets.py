"""Dataset registry: the reference's test-matrix library, regenerated.

The reference ships seven Harwell-Boeing-style sparse matrices in ``.dat``
coordinate form, replicated into five directories (SURVEY.md §2 C8):
matrix_10, jpwh_991, orsreg_1, sherman5, saylr4, sherman3, memplus, plus a
``matrix_2000`` that its README references but the mirror stripped (to be
regenerated with matrix_gen). Those files are third-party data we do not
copy; instead this module regenerates, deterministically, stand-in matrices
with the **same names, dimensions, and nonzero counts** (taken from each
reference file's header line), so every workflow that consumes the reference
dataset — external-input solves, cross-engine comparisons, the benchmark
grid — runs against the same shapes and sparsity budgets.

Stand-ins are strictly diagonally dominant (diag = 1 + sum |row off-diag|),
hence nonsingular and well-conditioned, with entries from a name-seeded
PCG64 stream — bitwise reproducible across runs and machines.

When a reference checkout is present (see :mod:`gauss_tpu_torch.io.reference_data`),
:func:`dataset_dense` can read the REAL matrices in place instead
(``source="reference"`` or ``"auto"``) — the real Harwell-Boeing conditioning,
not the deliberately easy stand-ins, is what the external benchmark grid and
golden tests exercise on this machine.
"""

from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np

from gauss_tpu_torch.io import datfile, synthetic

# name -> (n, nnz) from the reference .dat headers (SURVEY.md §2 C8).
REGISTRY: Dict[str, Tuple[int, int]] = {
    "matrix_10": (10, 100),
    "jpwh_991": (991, 6027),
    "orsreg_1": (2205, 14133),
    "sherman5": (3312, 20793),
    "saylr4": (3564, 22316),
    "sherman3": (5005, 20033),
    "memplus": (17758, 126150),
    # README-referenced, stripped from the mirror; dense generator family.
    "matrix_2000": (2000, 4_000_000),
}


def dataset_names():
    return tuple(REGISTRY)


def dataset_coords(name: str):
    """(n, rows, cols, vals) for a registry matrix, deterministic by name."""
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(REGISTRY)}")
    n, nnz = REGISTRY[name]

    if name in ("matrix_10", "matrix_2000"):
        # Dense generator-family matrices: exactly the matrix_gen emission.
        dense = synthetic.generator_matrix(n)
        cc, rr = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        return n, rr.ravel(), cc.ravel(), dense[rr.ravel(), cc.ravel()]

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n_off = nnz - n
    # Sample off-diagonal coordinates without replacement (rejection loop;
    # nnz << n^2 so a couple of rounds suffice).
    seen = set()
    rows = np.empty(n_off, dtype=np.int64)
    cols = np.empty(n_off, dtype=np.int64)
    filled = 0
    while filled < n_off:
        need = n_off - filled
        r = rng.integers(0, n, size=2 * need + 16)
        c = rng.integers(0, n, size=2 * need + 16)
        for ri, ci in zip(r, c):
            if ri == ci or (ri, ci) in seen:
                continue
            seen.add((ri, ci))
            rows[filled] = ri
            cols[filled] = ci
            filled += 1
            if filled == n_off:
                break
    vals = rng.uniform(-1.0, 1.0, size=n_off)

    # Strict diagonal dominance -> nonsingular, well-conditioned.
    diag = np.ones(n)
    np.add.at(diag, rows, np.abs(vals))
    all_rows = np.concatenate([rows, np.arange(n)])
    all_cols = np.concatenate([cols, np.arange(n)])
    all_vals = np.concatenate([vals, diag])
    order = np.lexsort((all_cols, all_rows))
    return n, all_rows[order], all_cols[order], all_vals[order]


def resolve_source(name: str, source: str = "standin") -> str:
    """Resolve a requested dataset source to the one that will be used.

    "standin"   — the deterministic regenerated matrix (always available).
    "reference" — the real reference .dat file, read in place (raises if the
                  reference checkout or the file is absent).
    "auto"      — "reference" when the real file exists, else "standin".
    """
    if source not in ("standin", "reference", "auto"):
        raise ValueError(f"unknown source {source!r}; options: "
                         "('standin', 'reference', 'auto')")
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(REGISTRY)}")
    if source == "standin":
        return "standin"
    from gauss_tpu_torch.io import reference_data

    if reference_data.find_dat(name) is not None:
        return "reference"
    if source == "reference":
        detail = (f"checkout at {reference_data.reference_root()} does not "
                  f"ship {name}.dat" if reference_data.available() else
                  f"no reference checkout under "
                  f"{reference_data.reference_root()} "
                  f"(set ${reference_data.ROOT_ENV})")
        raise KeyError(f"real reference matrix {name!r} not available: {detail}")
    return "standin"


def dataset_dense(name: str, dtype=np.float64,
                  source: str = "standin") -> np.ndarray:
    """Densified registry matrix (memplus at f64 is ~2.5 GB — mind the RAM,
    exactly as with the reference's external-input programs).

    ``source``: see :func:`resolve_source`; "standin" (the default) keeps
    results bitwise reproducible on machines without a reference checkout.
    """
    if resolve_source(name, source) == "reference":
        from gauss_tpu_torch.io import reference_data

        return reference_data.load_dense(name, dtype=dtype)
    n, rows, cols, vals = dataset_coords(name)
    return datfile.densify(n, rows, cols, vals, dtype=dtype)


def write_dataset(name: str, path) -> None:
    """Emit a registry matrix as a reference-format .dat file."""
    n, rows, cols, vals = dataset_coords(name)
    datfile.write_dat(path, n=n, rows=rows, cols=cols, vals=vals)
