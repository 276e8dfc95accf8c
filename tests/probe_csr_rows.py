"""Forward CSRs for K2's CSR route, shared by the CPU test
(``test_torch_probe_csr.py``) and the card's (``test_torch_cuda.py``).

- ``edge_csr``: a CSR from a dict of sorted rows;
- ``row_cases``: rows to the edge at one width (empty forward rows,
  disjoint and touching ranges, equal rows, one shared id, rows longer than
  the width, random rows of every length up to it) and the (src, dst)
  pairs that read them, first the seven whose counts are fixed
  (``FIXED_COUNTS``);
- ``numpy_counts``: the count of each pair by ``np.intersect1d``, each row
  cut to the width;
- ``clique_and_sparse`` / ``random_graph``: small graphs whose forward
  degrees fill the w512 bucket, or stay narrow;
- ``offset_copy``: a copy of a 1-D tensor that starts ``k`` ints past a
  16-byte boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.formats import edges_to_csr

# the counts of the first seven pairs of ``row_cases``: an empty row on
# either side and on both, disjoint ranges both ways, touching both ways
FIXED_COUNTS = [0, 0, 0, 0, 0, 1, 1]


def edge_csr(rows, n: int):
    """(row_ptr, col) int32 tensors of n rows from {row: sorted ids}; rows
    not in the dict are empty. ``col`` carries one slot past the last row,
    as a prepped forward CSR's padding does."""
    lens = np.zeros(n, np.int64)
    for r, ids in rows.items():
        lens[r] = len(ids)
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    col = np.concatenate([np.asarray(rows.get(r, []), np.int32)
                          for r in range(n)] + [np.zeros(1, np.int32)])
    return torch.from_numpy(row_ptr), torch.from_numpy(col)


def row_cases(width: int, seed: int, pairs: int = 60):
    """Rows to the edge at ``width`` and ``pairs`` random pairs besides the
    fixed ones. Returns (rows, n, [(src, dst), ...])."""
    rng = np.random.default_rng(seed)
    n = 4 * width + 64

    def ids(k, lo=0, hi=None):
        hi = n if hi is None else hi
        return np.sort(rng.choice(np.arange(lo, hi), size=k, replace=False))

    half = max(1, width // 2)
    rows = {
        0: [],                                   # an empty forward row
        1: ids(width),
        2: ids(half, 0, n // 2),                 # below 3's range
        3: ids(half, n // 2, n),                 # above 2's range
        5: ids(min(width + 7, n)),               # longer than the width
        6: ids(1),
    }
    # touches 3's range: its last id is 3's first
    rows[4] = np.concatenate([ids(half - 1, 0, n // 2), rows[3][:1]])
    rows[7] = rows[1].copy()                     # equal to row 1
    rows[8] = np.unique(np.concatenate([ids(half), rows[6]]))[:width]
    for r in range(9, 40):
        rows[r] = ids(int(rng.integers(1, width + 1)))
    fixed = [(0, 1), (1, 0), (0, 0), (2, 3), (3, 2), (4, 3), (3, 4)]
    more = [(1, 7), (7, 1), (6, 8), (8, 6), (5, 1), (1, 5), (5, 5)]
    more += [tuple(int(x) for x in rng.integers(1, 40, 2))
             for _ in range(pairs)]
    return rows, n, fixed + more


def numpy_counts(rows, pairs, width: int) -> np.ndarray:
    return np.array([len(np.intersect1d(np.asarray(rows.get(a, []))[:width],
                                        np.asarray(rows.get(b, []))[:width]))
                     for a, b in pairs], dtype=np.int32)


def clique_and_sparse(k: int, n: int, m: int, seed: int):
    """A k-clique on random ids among n vertices plus m random edges: the
    clique's forward degrees run up to k - 1, so k = 200 fills the w512
    bucket (and the top bucket under narrower widths)."""
    rng = np.random.default_rng(seed)
    members = rng.permutation(n)[:k]
    i, j = np.triu_indices(k, 1)
    src = np.concatenate([members[i], rng.integers(0, n, m)])
    dst = np.concatenate([members[j], rng.integers(0, n, m)])
    return edges_to_csr(src, dst, n=n, name=f"clique{k}")


def random_graph(n: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    return edges_to_csr(rng.integers(0, n, m), rng.integers(0, n, m), n=n,
                        name="random")


def offset_copy(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of 1-D ``t`` whose data starts ``k`` elements
    past the start of its allocation (4·k bytes off 16-byte alignment for
    int32 and k in 1..3)."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:]
    view.copy_(t)
    return view
