"""Row families for the probe strategy (K2), shared by the CPU parity test
(``test_torch_intersect.py``) and the card's (``test_torch_cuda.py``).

Every family gives a seeded numpy pair of (E, W) int32 arrays whose rows
are sorted ascending and keep the sentinel contract: in-row padding n (u)
and n + 1 (v), whole padding rows -1 (u) and -2 (v). The families aim at
what the kernel decides per row or per batch of rows:

- ``random``: sorted unique ids below n with random row lengths and a few
  whole padding rows at the end;
- ``dups``: ids drawn with replacement from a narrow range, so u and v both
  hold duplicates and u's duplicates occur in v;
- ``touch``: full rows whose id ranges meet at one id, ``u[0] == v[W-1]``
  on even rows and ``u[W-1] == v[0]`` on odd rows;
- ``disjoint``: rows whose ranges cannot meet, u above v on even rows and
  below it on odd rows;
- ``padding``: whole padding rows only;
- ``mixed``: ``random`` rows with about 40 % whole padding rows scattered
  among them, so batches hold both;
- ``holes``: the rows a labeled triangle query gives the probe strategy
  (``subgraph_match_triangle``): ``random`` rows whose u keeps about half
  its real ids, the rest replaced by the sentinel n in place, then sorted
  again as that caller does (K2 merges, so its rows must be sorted).
  ``holes`` gives both forms.
"""

from __future__ import annotations

import numpy as np

FAMILIES = ("random", "dups", "touch", "disjoint", "padding", "mixed",
            "holes")

WIDTHS = (1, 3, 31, 32, 33, 127, 128, 129, 257, 511, 512, 513, 8192, 8200)


def _rows(rng, e: int, w: int, lo: int, hi: int, *, unique: bool,
          fill=None) -> np.ndarray:
    """(e, w) sorted ids in [lo, hi); with ``fill``, each row keeps a random
    length and pads its tail with ``fill``."""
    if unique:
        keys = rng.random((e, hi - lo)).argsort(axis=1)[:, :w] + lo
    else:
        keys = rng.integers(lo, hi, size=(e, w))
    rows = np.sort(keys, axis=1).astype(np.int32)
    if fill is not None:
        deg = rng.integers(0, w + 1, size=e)
        rows[np.arange(w)[None, :] >= deg[:, None]] = fill
    return rows


def holes(e: int, w: int, seed: int = 0):
    """(u with holes, the same rows sorted, v): ``random`` rows whose u
    ids are replaced by n where a coin says so, as a labeled query replaces
    the neighbours without the third label; the middle form is what the
    caller hands the kernel."""
    rng = np.random.default_rng(seed)
    n = 3 * w + 50
    u = _rows(rng, e, w, 0, n, unique=True, fill=n)
    v = _rows(rng, e, w, 0, n, unique=True, fill=n + 1)
    u[rng.random((e, w)) < 0.5] = n
    return u, np.sort(u, axis=1), v


def family(name: str, e: int, w: int, seed: int = 0):
    """The (u, v) pair of family ``name`` at (E, W) = (e, w)."""
    if name == "holes":
        _, u, v = holes(e, w, seed)
        return u, v
    rng = np.random.default_rng(seed)
    n = 3 * w + 50
    if name in ("random", "mixed"):
        u = _rows(rng, e, w, 0, n, unique=True, fill=n)
        v = _rows(rng, e, w, 0, n, unique=True, fill=n + 1)
        if name == "random":
            pad = e // 10
            if pad:
                u[-pad:], v[-pad:] = -1, -2
        else:
            dead = rng.random(e) < 0.4
            u[dead], v[dead] = -1, -2
        return u, v
    if name == "dups":
        span = max(2, w // 2)
        return (_rows(rng, e, w, 0, span, unique=False, fill=n),
                _rows(rng, e, w, 0, span, unique=False, fill=n + 1))
    if name == "padding":
        return (np.full((e, w), -1, np.int32), np.full((e, w), -2, np.int32))
    if name in ("touch", "disjoint"):
        m = n // 2
        u = np.empty((e, w), np.int32)
        v = np.empty((e, w), np.int32)
        for r in range(e):
            below = _rows(rng, 1, w, 0, m, unique=False)[0]
            above = _rows(rng, 1, w, m + 1, n, unique=False)[0]
            if name == "touch":
                below[-1], above[0] = m, m
            # even rows: u above v; odd rows: u below v
            u[r], v[r] = (above, below) if r % 2 == 0 else (below, above)
        if name == "disjoint":
            # in-row padding on the side whose end it leaves disjoint
            deg = rng.integers(1, w + 1, size=e)
            tail = np.arange(w)[None, :] >= deg[:, None]
            even = (np.arange(e) % 2 == 0)[:, None]
            u[tail & even] = n
            v[tail & ~even] = n + 1
        return u, v
    raise ValueError(f"unknown family {name!r}")


def cases(wide_e: int = 9):
    """(family, E, W) cases: every family at narrow and wide rows, every
    width of ``WIDTHS``, and E below one 32-row batch, not a multiple of
    it, and spanning several batches. ``wide_e`` rows at W ≥ 8192."""
    out = [("random", 40 if w < 8192 else wide_e, w) for w in WIDTHS]
    for name in FAMILIES:
        for w in (1, 33, 512):
            out.append((name, 70, w))
    out += [("random", 1, 128), ("mixed", 5, 128), ("mixed", 33, 512),
            ("mixed", 300, 128), ("dups", wide_e, 8192), ("touch", 3, 8200)]
    return out


def tiled(name: str, e: int, w: int, seed: int = 0, cap: int = 1 << 22):
    """``family`` rows repeated down to E rows: a pair past what the
    generator makes quickly (at most ``cap`` ids drawn a side)."""
    base = max(1, min(e, cap // (3 * w + 50)))
    u, v = family(name, base, w, seed)
    reps = -(-e // base)
    return np.tile(u, (reps, 1))[:e].copy(), np.tile(v, (reps, 1))[:e].copy()


def offset_view(t):
    """The rows of tensor ``t`` as a contiguous view that starts one element
    into a larger allocation, so that they are not 16-byte aligned."""
    buf = t.new_empty(t.numel() + 1)
    buf[1:].copy_(t.flatten())
    return buf[1:].view(t.shape)


CPU_CASES = cases()

# the card's: wide rows at more rows; E past one sweep of the persistent grid
# (its teams times 32 rows, ~68K rows at W = 512); W past the shared-memory
# staging cap, where the kernel merges straight from global memory
CARD_CASES = cases(wide_e=100) + [
    ("random", 100_000, 512), ("mixed", 300_000, 128), ("random", 5_000, 8192),
    ("random", 7, 10_000), ("dups", 5, 20_000)]
