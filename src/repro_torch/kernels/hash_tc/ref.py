"""Reference implementation for the hash-probe cores.

The port of ``repro.kernels.hash_tc.ref``. ``hash_probe_counts_ref`` is the
semantic oracle (what ``backend="ref"`` dispatches to): it ignores the
bucket structure entirely and compares every probe against every table
slot, so a bucketing or ranking bug in the build path cannot hide in it.
O(E·W·B·D): tests and ``backend="ref"`` only.

``hash_probe_compact_ref`` is the same oracle for the compact table (what
the hash lane's ``backend="ref"`` dispatches to): it compares every
candidate before the row end with every id of the anchor's whole compact
row, ignoring chain boundaries. O(E·W·deg): tests and ``backend="ref"``
only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hash_tc.build import CompactHashTable

__all__ = ["hash_probe_compact_ref", "hash_probe_counts_ref"]


def hash_probe_counts_ref(w_lists: torch.Tensor, src: torch.Tensor,
                          table: torch.Tensor) -> torch.Tensor:
    """Bucket-structure-independent membership oracle.

    Args:
      w_lists: (E, W) int32 candidate rows (in-row sentinel n + 1, whole
        padding rows -2).
      src: (E,) int32 anchor vertex per row.
      table: (n, B, D) int32 hash table; empty slots -1. Slot positions are
        irrelevant here: only the multiset of stored ids matters.

    Returns:
      (E,) int32 — per-edge count of (candidate, slot) pairs that are equal
      anywhere in ``table[src]``. It matches the bucketed cores because
      stored ids are unique per row and no sentinel (-2, -1, n, n + 1)
      collides with a stored id; on a table with a repeated id it counts
      every copy.
    """
    e = int(w_lists.shape[0])
    n = int(table.shape[0])
    if e == 0 or n == 0:
        return torch.zeros(e, dtype=torch.int32, device=w_lists.device)
    # the reference's gather clamps an out-of-range anchor into [0, n)
    flat = table[src.long().clamp(0, n - 1)].reshape(e, -1)  # (E, B·D)
    eq = flat[:, :, None] == w_lists[:, None, :]
    return eq.sum(dim=(1, 2)).to(torch.int32)


def hash_probe_compact_ref(w_lists: torch.Tensor, src: torch.Tensor,
                           row_end: torch.Tensor,
                           compact: CompactHashTable) -> torch.Tensor:
    """Chain-blind membership oracle for the compact table.

    Args:
      w_lists: (E, W) int32 candidate rows (in-row sentinel n + 1, whole
        padding rows -2).
      src: (E,) int32 anchor vertex per row (clamped into [0, n)).
      row_end: (E,) int32; candidates at or past it are not counted.
      compact: the ``CompactHashTable``; only the multiset of each
        vertex's ids matters here, not which chain holds them.

    Returns:
      (E,) int32 — per-edge count of (candidate, id) pairs that are equal,
      over the candidates before the row end that lie in [0, n) and the
      ids of the anchor's compact row. As for ``hash_probe_counts_ref``, a
      repeated id counts every copy.
    """
    ptr, vals, num_buckets = compact
    e, w = int(w_lists.shape[0]), int(w_lists.shape[1])
    n = compact.n
    if e == 0 or n == 0 or w == 0:
        return torch.zeros(e, dtype=torch.int32, device=w_lists.device)
    anchor = src.long().clamp(0, n - 1)
    start = ptr[anchor * num_buckets].long()
    deg = ptr[(anchor + 1) * num_buckets].long() - start
    k = torch.arange(max(1, int(deg.max())), device=w_lists.device)
    held = k < deg[:, None]
    ids = torch.where(held, vals[torch.where(held, start[:, None] + k, 0)]
                      if vals.numel() else -1, -1)  # (E, max deg), -1 empty
    pos = torch.arange(w, device=w_lists.device)
    cand = torch.where((pos < row_end[:, None].long()) & (w_lists >= 0)
                       & (w_lists < n), w_lists, -2)
    eq = ids[:, :, None] == cand[:, None, :]
    return eq.sum(dim=(1, 2)).to(torch.int32)
