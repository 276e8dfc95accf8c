"""Per-vertex hash-table construction for the TRUST-style hash lane.

The port of ``repro.kernels.hash_tc.build``, as torch ops (the reference
has no Pallas here). The table is dense and statically shaped:

    table[v, b, d]  —  (n, B, D) int32

where B (``num_buckets``, a power of two) buckets neighbour ``w`` of ``v``
at ``b = w & (B - 1)`` and D (``depth``) is the longest chain over the
whole graph, so every (vertex, bucket) chain fits. Empty slots hold -1,
never a probe. The planner rounds D to a power of two.

Each entry's slot within its chain is its rank among the row's entries of
the same bucket, in row order: a stable sort by bucket id along the row, a
running maximum of segment starts (``torch.cummax``), and a scatter back.
So every id lands in the same slot as in the reference's table, bit for
bit.

Two things differ from the reference's ``.at[...].set(mode="drop")``: on a
CUDA device an out-of-range scatter index is a fault, not a dropped write,
so invalid entries (in-row padding, ranks past ``depth``) are masked out
before the scatter; and the flat indices are int64, since a scale-17 R-MAT
table already has 2³² elements.
"""

from __future__ import annotations

import torch

__all__ = ["build_hash_table", "hash_table_depth"]


def _bucket_ranks(b: torch.Tensor) -> torch.Tensor:
    """Per-row rank of each entry within its bucket chain.

    Args:
      b: (n, W) integer bucket ids (invalid entries mapped to a bucket id
        that sorts after all real ones, e.g. ``num_buckets``).

    Returns:
      (n, W) int64 — ``rank[v, j]`` = number of row-``v`` entries with the
      same bucket id before entry ``j``.
    """
    n, w = b.shape
    idx = torch.arange(w, dtype=torch.int64, device=b.device)
    sb, order = torch.sort(b, dim=1, stable=True)  # ties keep row order
    is_start = torch.ones_like(sb, dtype=torch.bool)
    is_start[:, 1:] = sb[:, 1:] != sb[:, :-1]
    start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    rank = torch.empty((n, w), dtype=torch.int64, device=b.device)
    return rank.scatter_(1, order, idx - start)


def _valid_buckets(nbrs: torch.Tensor, num_buckets: int):
    """(valid, bucket id) per entry: ids below n are entries (the in-row
    padding n is not), and invalid entries take bucket id B."""
    valid = nbrs < nbrs.shape[0]
    return valid, torch.where(valid, nbrs & (num_buckets - 1), num_buckets)


def hash_table_depth(nbrs: torch.Tensor, num_buckets: int) -> int:
    """Longest bucket chain over all (vertex, bucket) pairs.

    Args:
      nbrs: (n, W) int32 padded oriented neighbour rows, in-row padding n.
      num_buckets: B, a power of two.

    Returns:
      The smallest table depth D that loses no entry (0 for an empty
      graph). The planner's one scalar sync.
    """
    if nbrs.numel() == 0:
        return 0
    valid, b = _valid_buckets(nbrs, int(num_buckets))
    rank = _bucket_ranks(b)
    return int(torch.where(valid, rank + 1, 0).max())


def build_hash_table(nbrs: torch.Tensor, *, num_buckets: int,
                     depth: int) -> torch.Tensor:
    """Scatter oriented neighbour rows into the (n, B, D) hash table.

    Args:
      nbrs: (n, W) int32 padded oriented neighbour rows (N⁺ lists, in-row
        padding n, rows sorted ascending).
      num_buckets: B, a power of two; bucket(w) = ``w & (B - 1)``.
      depth: D; entries ranked past it are dropped, as the reference's
        ``mode="drop"`` drops them, so callers size D with
        ``hash_table_depth`` first.

    Returns:
      (n, B, D) int32 table on ``nbrs``' device, empty slots -1.
    """
    n, w = (int(x) for x in nbrs.shape)
    num_buckets, depth = int(num_buckets), int(depth)
    size = n * num_buckets * depth
    # one spare slot past the table takes every masked-out entry, so the
    # scatter needs no sync to count the kept ones
    flat_table = torch.full((size + 1,), -1, dtype=torch.int32,
                            device=nbrs.device)
    if n and w and depth:
        valid, b = _valid_buckets(nbrs, num_buckets)
        rank = _bucket_ranks(b)
        rows = torch.arange(n, dtype=torch.int64, device=nbrs.device)[:, None]
        flat = (rows * num_buckets + b) * depth + rank
        flat = torch.where(valid & (rank < depth), flat, size)
        flat_table.scatter_(0, flat.reshape(-1),
                            nbrs.reshape(-1).to(torch.int32))
    return flat_table[:size].view(n, num_buckets, depth)
