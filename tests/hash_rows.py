"""Hash-probe cases for K5, shared by the CPU tests
(``test_torch_hash_compact.py``), the card's (``test_torch_cuda.py``) and
``chip_smoke.py``.

Every case is seeded numpy data: (E, W) int32 candidate rows, (E,) int32
anchors, optionally (E,) int32 row ends (else ``probe_row_ends`` gives
them), and a table given either as padded oriented rows with a bucket count
(built by ``build_compact_hash_table``) or as a dense (n, B, D) table
(compacted by ``compact_hash_table``). The families aim at what the kernel
decides per row, per anchor and per launch:

- ``built``: sorted unique neighbour rows below n (in-row padding n), rows
  in anchor order as the lane gives them, candidates drawn from the same
  rows (many probes hit; sentinel n + 1) and the last tenth whole padding
  rows (-2);
- ``shuffled``: ``built`` with the anchors in random order, so nearly every
  row changes the anchor;
- ``holes``: a dense table with empty slots inside chains, an id repeated
  in its chain, ids in the wrong bucket and slot values outside [0, n)
  (n, n + 1, -5, 2³⁰); candidates drawn from [-3, n + 3);
- ``ends``: rows whose end is 0 (all sentinels), rows with a valid id
  after a sentinel, and rows whose only valid id is the last (end W);
- ``cut``: ``built`` rows with given row ends drawn from [-2, W + 3], so
  the kernel must stop at the given end (or clamp it into [0, W]);
- ``wide``: a dense table whose low anchors hold up to B·D ids, more than a
  warp stages in shared memory, beside anchors with a few ids: both of the
  kernel's routes in one launch;
- ``bigB``: ``built`` at B = 4096, whose B + 1 offsets alone exceed the
  staging room, so every anchor takes the global-memory route.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import hash_tc as ht

FAMILIES = ("built", "shuffled", "holes", "ends", "cut", "wide", "bigB")


def _nbrs(rng, n: int, w: int) -> np.ndarray:
    """(n, w) sorted unique ids below n, random lengths, in-row padding n."""
    nbrs = np.full((n, w), n, dtype=np.int32)
    keys = rng.random((n, n)).argsort(axis=1)[:, :w]
    for r, d in enumerate(rng.integers(0, w + 1, size=n)):
        nbrs[r, :d] = np.sort(keys[r, :d])
    return nbrs


def _cand(rng, nbrs: np.ndarray, e: int, n: int) -> np.ndarray:
    cand = nbrs[rng.integers(0, nbrs.shape[0], size=e)].copy()
    cand[cand == n] = n + 1
    cand[e - e // 10:] = -2
    return cand


def case(family: str, e: int, w: int, num_buckets: int = 32,
         seed: int = 0) -> dict:
    """One case: ``cand``, ``src``, ``row_end`` (or None) and either
    ``nbrs`` with ``num_buckets`` or ``dense``."""
    rng = np.random.default_rng(seed)
    n = max(2 * w, 64)
    if family in ("built", "shuffled", "cut", "bigB"):
        b = 4096 if family == "bigB" else num_buckets
        nbrs = _nbrs(rng, n, w)
        src = rng.integers(0, n, size=e).astype(np.int32)
        if family != "shuffled":
            src.sort()
        row_end = None
        if family == "cut":
            row_end = rng.integers(-2, w + 4, size=e).astype(np.int32)
        return dict(cand=_cand(rng, nbrs, e, n), src=src, row_end=row_end,
                    nbrs=nbrs, num_buckets=b)
    if family == "ends":
        nbrs = _nbrs(rng, n, w)
        cand = _cand(rng, nbrs, e, n)
        kind = rng.integers(0, 3, size=e)
        for r in range(e):
            if kind[r] == 0:  # no valid id: end 0
                cand[r] = rng.choice([-2, -1, n, n + 1], size=w)
            elif kind[r] == 1 and w > 1:  # a valid id after a sentinel
                cand[r, rng.integers(0, w - 1)] = n + 1
            else:  # the only valid id is the last: end W
                cand[r, :-1] = n + 1
        src = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
        return dict(cand=cand, src=src, row_end=None, nbrs=nbrs,
                    num_buckets=num_buckets)
    if family in ("holes", "wide"):
        b, d = (num_buckets, 4) if family == "holes" else (8, 64)
        # in-bucket ids: slot (v, bk, k) may hold bk + B·j, which probes find
        rows = rng.integers(0, max(1, n // b), size=(n, b, d)) * b
        dense = (rows + np.arange(b)[None, :, None]).astype(np.int32)
        if family == "holes":
            dense[rng.random(dense.shape) < 0.4] = -1  # holes, mid-chain too
            odd = rng.random(dense.shape) < 0.05  # out of range, wrong bucket
            dense[odd] = rng.choice([n, n + 1, -5, 1 << 30, 3], size=odd.sum())
            dense[:, :, 1] = np.where(rng.random((n, b)) < 0.3,
                                      dense[:, :, 0], dense[:, :, 1])  # repeats
        else:
            # anchors 0-3 hold B·D = 512 ids (more than a warp stages), the
            # rest at most one a bucket
            dense[4:, :, 1:] = -1
            dense[4:, :, 0][rng.random((n - 4, b)) < 0.75] = -1
        cand = rng.integers(-3, n + 3, size=(e, w)).astype(np.int32)
        src = np.sort(rng.integers(-1, n + 2, size=e)).astype(np.int32)
        return dict(cand=cand, src=src, row_end=None, dense=dense)
    raise ValueError(f"unknown family {family!r}")


def tensors(c: dict, dev, *, offset: bool = False):
    """(w_lists, src, row_end, compact) on ``dev``; with ``offset`` the
    candidate rows, anchors and row ends are views that start one element
    into larger allocations (not 16-byte aligned)."""
    put = offset_view if offset else (lambda t: t)
    w_lists = put(torch.from_numpy(c["cand"]).to(dev))
    src = put(torch.from_numpy(c["src"]).to(dev))
    if "dense" in c:
        compact = ht.compact_hash_table(torch.from_numpy(c["dense"]).to(dev))
    else:
        compact, _ = ht.build_compact_hash_table(
            torch.from_numpy(c["nbrs"]).to(dev), c["num_buckets"])
    if c["row_end"] is None:
        row_end = ht.probe_row_ends(w_lists, compact.n)
    else:
        row_end = torch.from_numpy(c["row_end"]).to(dev)
    return w_lists, src, put(row_end), compact


def offset_view(t):
    """Tensor ``t`` as a contiguous view that starts one element into a
    larger allocation, so that it is not 16-byte aligned."""
    buf = t.new_empty(t.numel() + 1)
    buf[1:].copy_(t.flatten())
    return buf[1:].view(t.shape)


def cases(shapes) -> list:
    """(family, e, w, num_buckets) for every family at each (e, w) and the
    bucket counts the lane gives such widths."""
    out = []
    for e, w in shapes:
        for fam in FAMILIES:
            for b in ((8, 512) if fam in ("built", "shuffled") else (32,)):
                out.append((fam, e, w, b))
    return out


CPU_CASES = cases([(1, 1), (7, 8), (100, 33), (257, 64)])

# the card's: E past many slices of 64 rows, W past one chunk of 128
CARD_CASES = cases([(1, 1), (7, 8), (1000, 33), (4097, 128), (3000, 512)])
