"""Row families for the broadcast (K1) and bitmap (K3) strategies, shared
by the CPU parity test (``test_torch_intersect.py``), the card's
(``test_torch_cuda.py``) and ``chip_smoke.py``.

Every family gives a seeded numpy pair of (E, W) int32 arrays and the
bitmap capacity it aims at. Neither kernel reads the rows' order, so the
families aim at what the kernels decide per row and per warp instead:

- ``sorted``: the engine's rows, sorted unique ids below n = 2·W + 8 (so
  that rows share many ids) with in-row padding n (u) and n + 1 (v),
  random row lengths, and a tenth of the rows whole padding (-1 / -2) at
  the end;
- ``unsorted``: ``sorted`` rows, each shuffled on its own (sentinels
  included);
- ``dups``: ids drawn with replacement from a narrow range, unshuffled, so
  u and v both hold duplicates, not adjacent: K1 counts each equal pair;
- ``outside``: ids around the bitmap's range: negatives, ``num_bits``,
  ``num_bits + 1`` and the int32 extremes beside ids in [0, num_bits)
  (K3 masks the ones outside; for K1 any int32 is an id);
- ``padding``: whole padding rows only;
- ``mixed``: ``sorted`` rows with about 40 % whole padding rows scattered
  among them.

The bitmap's plain version packs v by first occurrences (the reference's
contract), so ``bitmap_family`` gives the same rows with each v row's equal
ids moved next to each other, in an order unrelated to their values: the
kernel still sees unsorted rows with duplicates.

W runs from 1 to 63 (every width under the broadcast cut-off, W % 4 ≠ 0
included); the cases' E are not multiples of the rows a warp takes, and the
card's run past one sweep of the persistent grids. ``BITMAP_WIDE`` adds
K3's chunked rows (W past 32 ids a lane, and past the 256 a warp's
registers hold).
"""

from __future__ import annotations

import numpy as np

FAMILIES = ("sorted", "unsorted", "dups", "outside", "padding", "mixed")

# every width class of K1's register route: groups of 1, 2, 4, 8 and 16
# lanes, whole and partial quads, the slab route's edge at 63
WIDTHS = (1, 2, 3, 4, 5, 7, 8, 9, 12, 15, 16, 17, 24, 31, 32, 33, 40, 47,
          60, 61, 63)

# K3's rows past 32 ids: 2, 4 and 8 ids a lane, and past 256 (chunks beyond
# the registers, the bitmap cleared whole or v walked again)
BITMAP_WIDE = (64, 100, 128, 129, 511, 512, 513, 1000, 2100)

_INT32 = np.iinfo(np.int32)


def _ceil32(x: int) -> int:
    return max(32, -(-int(x) // 32) * 32)


def _sorted_rows(rng, e: int, w: int, n: int, fill: int) -> np.ndarray:
    """(e, w) sorted unique ids below n, each row a random length, the tail
    ``fill``."""
    keys = rng.random((e, n)).argsort(axis=1)[:, :w]
    rows = np.sort(keys, axis=1).astype(np.int32)
    deg = rng.integers(0, w + 1, size=e)
    rows[np.arange(w)[None, :] >= deg[:, None]] = fill
    return rows


def family(name: str, e: int, w: int, seed: int = 0):
    """(u, v, num_bits) of family ``name`` at (E, W) = (e, w); ``num_bits``
    is the bitmap capacity the family aims at."""
    rng = np.random.default_rng(seed)
    n = 2 * w + 8
    bits = _ceil32(n + 2)  # every id and both in-row sentinels
    if name in ("sorted", "unsorted", "mixed"):
        u = _sorted_rows(rng, e, w, n, n)
        v = _sorted_rows(rng, e, w, n, n + 1)
        if name == "mixed":
            dead = rng.random(e) < 0.4
            u[dead], v[dead] = -1, -2
        else:
            pad = e // 10
            if pad:
                u[-pad:], v[-pad:] = -1, -2
        if name == "unsorted":
            u = rng.permuted(u, axis=1)
            v = rng.permuted(v, axis=1)
        return u, v, bits
    if name == "dups":
        span = max(2, w // 2)
        return (rng.integers(0, span, size=(e, w)).astype(np.int32),
                rng.integers(0, span, size=(e, w)).astype(np.int32),
                _ceil32(span))
    if name == "outside":
        bits = _ceil32(w + 1)
        odd = np.array([_INT32.min, -2, -1, bits, bits + 1, _INT32.max],
                       dtype=np.int64)

        def side():
            ids = rng.integers(0, bits, size=(e, w))
            far = rng.random((e, w)) < 0.3
            ids[far] = odd[rng.integers(0, odd.size, size=int(far.sum()))]
            return ids.astype(np.int32)
        return side(), side(), bits
    if name == "padding":
        return (np.full((e, w), -1, np.int32), np.full((e, w), -2, np.int32),
                32)
    raise ValueError(f"unknown family {name!r}")


def adjacent_runs(v: np.ndarray) -> np.ndarray:
    """Each row of v with its equal ids next to each other, in an order set
    by a hash of the id rather than by the id (what the bitmap's plain
    packer needs; the kernel reads no order)."""
    key = (v.astype(np.int64) * 2654435761 + 12345) % (1 << 32)
    return np.take_along_axis(v, np.argsort(key, axis=1, kind="stable"),
                              axis=1)


def bitmap_family(name: str, e: int, w: int, seed: int = 0):
    """``family`` with each v row in ``adjacent_runs``."""
    u, v, bits = family(name, e, w, seed)
    return u, adjacent_runs(v), bits


def tiled(make, name: str, e: int, w: int, seed: int = 0,
          cap: int = 1 << 22):
    """``make(name, ...)`` rows repeated down to E rows: a pair past what
    the generator makes quickly (at most ``cap`` ids drawn a side)."""
    base = max(1, min(e, cap // (2 * w + 8)))
    u, v, bits = make(name, base, w, seed)
    reps = -(-e // base)
    return (np.tile(u, (reps, 1))[:e].copy(), np.tile(v, (reps, 1))[:e].copy(),
            bits)


def cases(sweep_e: int, family_e: int):
    """(family, E, W) cases: ``sorted`` at every width of ``WIDTHS`` with
    ``sweep_e`` rows, every family at narrow and partial-quad widths with
    ``family_e`` rows, and E around the rows a warp takes at W = 8 (16) and
    W = 32 (4)."""
    out = [("sorted", sweep_e, w) for w in WIDTHS]
    for name in FAMILIES:
        for w in (3, 8, 33, 63):
            out.append((name, family_e, w))
    out += [("unsorted", 1, 8), ("dups", 15, 8), ("sorted", 17, 8),
            ("outside", 3, 32), ("mixed", 5, 32), ("dups", 7, 1)]
    return out


CPU_CASES = cases(37, 70)

# the card's: more rows, and E past one sweep of each persistent grid (K1's
# is about 170K rows at W = 8 and 42K at W = 32; K3's a few thousand)
CARD_CASES = cases(1001, 4099) + [
    ("sorted", 600_000, 8), ("mixed", 1_000_001, 8),
    ("unsorted", 300_001, 32), ("dups", 200_001, 33),
    ("outside", 250_000, 61), ("padding", 100_000, 12)]

# K3 only: its wide rows
BITMAP_WIDE_CASES = [("sorted", 301, w) for w in BITMAP_WIDE] + [
    ("unsorted", 101, 513), ("dups", 77, 1000), ("outside", 201, 129),
    ("sorted", 20_001, 512)]
