"""Packed-bitmap set intersection (the ``bitmap`` strategy).

TRUST-style dense core: pack each v row into ``num_bits/32`` words (bit i
set iff id i is in the row), then test each u element with one word gather
plus shift/AND. K3 of the port: ``intersect_counts_bitmap_kernel`` launches
the CUDA kernel ``bitmap_warp_kernel`` (``csrc/intersect.cu``: one bitmap a
warp in shared memory for the whole launch, set from v's row, tested by u's,
then cleared word by word from v's row again, so a row costs O(W)), which
replaces the TPU kernel ``_bitmap_kernel`` /
``intersect_counts_bitmap_pallas`` of ``repro/kernels/intersect/bitmap.py``.
``intersect_counts_bitmap`` is its plain torch version.

Contract (shared by the kernel, the plain version and the numpy ref):

* rows sorted ascending: real values strictly increasing, then a run of one
  repeated padding sentinel. Strictness lets the plain packer add bits
  instead of OR-ing them (each kept value owns a distinct bit); what it
  needs is that equal v ids are adjacent. The kernel ORs bits and reads no
  order, and u may be in any order on every path: each u element counts,
  with multiplicity, if its id is in v.
* values outside ``[0, num_bits)`` never match, on either side. Callers
  that need exact agreement with the other strategies choose
  ``num_bits`` ≥ the id range (the engine uses ``n + 2``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.intersect import _launch

__all__ = [
    "BITMAP_MAX_BITS",
    "intersect_counts_bitmap",
    "intersect_counts_bitmap_kernel",
    "intersect_counts_bitmap_ref",
    "intersect_matches_bitmap",
]

# hard cap on any bitmap's capacity: the kernel keeps num_bits/32 words a
# warp in shared memory (8 KB at the cap), and the reference refuses larger
# bitmaps the same way
BITMAP_MAX_BITS = 1 << 16

# packed words (or u elements) materialized per chunk of the plain version
_CHUNK_ELEMS = 1 << 24


def _check_bits(num_bits: int) -> int:
    num_bits = int(num_bits)
    if num_bits <= 0 or num_bits % 32:
        raise ValueError(f"num_bits must be a positive multiple of 32, got {num_bits}")
    return num_bits


def _pack_rows(v: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Pack each sorted row of v into (E, num_bits/32) int64 words (the
    low 32 bits of each word are used)."""
    e, w = v.shape
    # first occurrence of each value, so the per-word sum equals the OR
    first = torch.ones_like(v, dtype=torch.bool)
    first[:, 1:] = v[:, 1:] != v[:, :-1]
    valid = first & (v >= 0) & (v < num_bits)
    word = torch.where(valid, v // 32, 0).long()
    contrib = torch.where(valid, torch.bitwise_left_shift(
        torch.ones_like(v, dtype=torch.int64), (v % 32).long()), 0)
    words = torch.zeros(e, num_bits // 32, dtype=torch.int64, device=v.device)
    return words.scatter_add_(1, word, contrib)


def _probe_bits(words: torch.Tensor, u: torch.Tensor, num_bits: int) -> torch.Tensor:
    """(E, W) bool: gather each u element's word and test its bit."""
    valid = (u >= 0) & (u < num_bits)
    word = torch.where(valid, u // 32, 0).long()
    bit = torch.where(valid, u % 32, 0).long()
    hits = torch.bitwise_right_shift(torch.gather(words, 1, word), bit) & 1
    return (hits != 0) & valid


def _row_step(w: int, num_bits: int) -> int:
    return max(1, _CHUNK_ELEMS // max(w, num_bits // 32, 1))


def intersect_matches_bitmap(u_lists: torch.Tensor, v_lists: torch.Tensor,
                             *, num_bits: int) -> torch.Tensor:
    """Bitmap membership mask: (E, W) bool, ``out[e, j]`` iff
    ``u_lists[e, j]`` is in ``v_lists[e]`` and within [0, num_bits)."""
    num_bits = _check_bits(num_bits)
    e, w = u_lists.shape
    out = torch.zeros(e, w, dtype=torch.bool, device=u_lists.device)
    step = _row_step(w, num_bits)
    for s in range(0, e if w else 0, step):
        out[s:s + step] = _probe_bits(_pack_rows(v_lists[s:s + step], num_bits),
                                      u_lists[s:s + step], num_bits)
    return out


def intersect_counts_bitmap(u_lists: torch.Tensor, v_lists: torch.Tensor,
                            *, num_bits: int) -> torch.Tensor:
    """Plain torch bitmap counts: (E,) int32 per-row intersection sizes
    restricted to ids in [0, num_bits)."""
    num_bits = _check_bits(num_bits)
    e, w = u_lists.shape
    out = torch.zeros(e, dtype=torch.int32, device=u_lists.device)
    step = _row_step(w, num_bits)
    for s in range(0, e if w else 0, step):
        out[s:s + step] = _probe_bits(
            _pack_rows(v_lists[s:s + step], num_bits), u_lists[s:s + step],
            num_bits).sum(dim=1, dtype=torch.int32)
    return out


def intersect_counts_bitmap_kernel(u_lists: torch.Tensor, v_lists: torch.Tensor,
                                   *, num_bits: int) -> torch.Tensor:
    """Per-row bitmap counts: K3 on a CUDA tensor, the plain version on a
    CPU tensor.

    Args:
      u_lists, v_lists: (E, W) int32, contiguous, rows sorted (see the
        module contract); any E and W.
      num_bits: bitmap capacity, a positive multiple of 32 (the kernel
        keeps ``num_bits/32`` words a warp in shared memory, so it is
        capped at ``BITMAP_MAX_BITS``).

    Returns:
      (E,) int32 counts restricted to ids in [0, num_bits).

    Raises:
      ValueError: bad inputs, ``num_bits``, or device.
      RuntimeError: the kernel did not build or launch.
    """
    _launch.check_lists(u_lists, v_lists)
    num_bits = _check_bits(num_bits)
    if num_bits > BITMAP_MAX_BITS:
        raise ValueError(f"num_bits={num_bits} exceeds BITMAP_MAX_BITS="
                         f"{BITMAP_MAX_BITS} (the kernel's shared-memory bitmap)")
    if u_lists.device.type == "cpu":
        return intersect_counts_bitmap(u_lists, v_lists, num_bits=num_bits)
    return _launch.launch_counts("bitmap", u_lists, v_lists, num_bits)


def intersect_counts_bitmap_ref(u_lists, v_lists, *, num_bits: int) -> np.ndarray:
    """Numpy reference for the bitmap masking contract (tests only), via
    Python sets: ids outside [0, num_bits) are ignored, v is a set.

    Returns:
      (E,) int32 numpy array of per-row counts.
    """
    u = np.asarray(u_lists)
    v = np.asarray(v_lists)
    out = np.zeros(u.shape[0], dtype=np.int32)
    for e in range(u.shape[0]):
        members = {x for x in v[e].tolist() if 0 <= x < num_bits}
        out[e] = sum(1 for x in u[e].tolist() if 0 <= x < num_bits and x in members)
    return out
