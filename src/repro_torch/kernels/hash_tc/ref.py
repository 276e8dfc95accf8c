"""Reference implementation for the hash-probe cores.

The port of ``repro.kernels.hash_tc.ref``. ``hash_probe_counts_ref`` is the
semantic oracle (what ``backend="ref"`` dispatches to): it ignores the
bucket structure entirely and compares every probe against every table
slot, so a bucketing or ranking bug in the build path cannot hide in it.
O(E·W·B·D): tests and ``backend="ref"`` only.
"""

from __future__ import annotations

import torch

__all__ = ["hash_probe_counts_ref"]


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
