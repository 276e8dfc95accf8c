"""Per-vertex hash-table construction for the TRUST-style hash lane.

The port of ``repro.kernels.hash_tc.build``, as torch ops (the reference
has no Pallas here). The reference's table is dense and statically shaped:

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

The hash lane holds the same chains compactly (``CompactHashTable``): each
chain at its real length, in the dense table's slot order, behind an
(n·B + 1,) int32 offset array. R-MAT ids cluster in their low bits, so a
few chains are long and D with them, while almost every chain is empty: at
scale 17 the dense table is (131072, 512, 64), 16 GiB, and the compact one
1,864,319 ids and 67,108,865 offsets, 0.28 GB. ``build_compact_hash_table``
builds it straight from the padded rows, ``compact_hash_table`` from any
dense table, and ``expand_hash_table`` gives the dense table back.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = [
    "CompactHashTable",
    "build_compact_hash_table",
    "build_hash_table",
    "compact_hash_table",
    "expand_hash_table",
    "hash_table_depth",
]

_INT_MAX = 2 ** 31 - 1

# rows one step of the compact build sorts at once: bounds its (rows, W)
# sort and scatter transients
_BUILD_CHUNK_ELEMS = 1 << 24


class CompactHashTable(NamedTuple):
    """The hash table with each (vertex, bucket) chain at its real length.

    ``chain_vals[chain_ptr[v·B + b] : chain_ptr[v·B + b + 1]]`` is chain
    (v, b), its ids in slot order; the chains lie in (v, b) order, so
    vertex v's ids are ``chain_vals[chain_ptr[v·B] : chain_ptr[(v + 1)·B]]``.

    Fields:
      chain_ptr: (n·B + 1,) int32 chain offsets, ``chain_ptr[0] == 0`` and
        ``chain_ptr[-1] == chain_vals.numel()``.
      chain_vals: (nnz,) int32 ids.
      num_buckets: B, a power of two.
    """

    chain_ptr: torch.Tensor
    chain_vals: torch.Tensor
    num_buckets: int

    @property
    def n(self) -> int:
        return (int(self.chain_ptr.numel()) - 1) // int(self.num_buckets)

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in (self.chain_ptr, self.chain_vals))


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


def _check_nnz(nnz: int) -> None:
    if nnz > _INT_MAX:
        raise ValueError(f"the compact hash table holds {nnz} ids, past the "
                         f"int32 offsets of its chains ({_INT_MAX})")


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """(K + 1,) int32 exclusive prefix sum of (K,) int32 chain lengths."""
    ptr = torch.zeros(counts.numel() + 1, dtype=torch.int32,
                      device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=ptr[1:])
    return ptr


def build_compact_hash_table(nbrs: torch.Tensor, num_buckets: int
                             ) -> Tuple[CompactHashTable, int]:
    """Build the compact hash table of padded oriented rows on their device,
    without the dense (n, B, D) table.

    Each row's entries are stably sorted by bucket id (the sort of
    ``_bucket_ranks``), so each chain keeps row order, which is the dense
    table's slot order; rows go in order. Entries are ids below n (the
    in-row padding n is not), as for ``build_hash_table``.

    Args:
      nbrs: (n, W) int32 padded oriented neighbour rows, in-row padding n.
      num_buckets: B, a power of two.

    Returns:
      (table, longest): the ``CompactHashTable`` and the longest chain (the
      ``hash_table_depth`` of the rows), read in the build's one host sync.

    Raises:
      ValueError: the table would hold more ids than int32 offsets reach.
    """
    n, w = (int(x) for x in nbrs.shape)
    num_buckets = int(num_buckets)
    dev = nbrs.device
    # one spare slot past the chains takes every invalid entry's count
    counts = torch.zeros(n * num_buckets + 1, dtype=torch.int32, device=dev)
    valid, b = _valid_buckets(nbrs, num_buckets)
    rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    chain = torch.where(valid, rows * num_buckets + b, n * num_buckets)
    counts.index_add_(0, chain.reshape(-1),
                      torch.ones(1, dtype=torch.int32, device=dev).expand(n * w))
    del chain
    ptr = _offsets(counts[:-1])
    longest = counts[:-1].max() if n * num_buckets else counts.new_zeros(())
    nnz, longest = (int(x) for x in torch.stack(
        [ptr[-1].long(), longest.long()]).tolist())
    _check_nnz(nnz)
    del counts
    vals = torch.empty(nnz + 1, dtype=torch.int32, device=dev)
    step = max(1, _BUILD_CHUNK_ELEMS // max(1, w))
    idx = torch.arange(w, dtype=torch.int64, device=dev)
    for s in range(0, n if w else 0, step):
        sb, order = torch.sort(b[s:s + step], dim=1, stable=True)
        # valid entries sort first in each row: slot j of the sorted row is
        # the vertex's j-th id in (bucket, rank) order
        start = ptr[(torch.arange(s, s + sb.shape[0], device=dev)
                     * num_buckets)].long()
        pos = torch.where(sb < num_buckets, start[:, None] + idx, nnz)
        vals.scatter_(0, pos.reshape(-1),
                      torch.gather(nbrs[s:s + step], 1, order).reshape(-1))
    return CompactHashTable(ptr, vals[:nnz], num_buckets), longest


def compact_hash_table(table: torch.Tensor) -> CompactHashTable:
    """Compact any dense (n, B, D) table: each chain keeps its slots whose
    value lies in [0, n), in slot order.

    This keeps every count of the dense probe: no other slot value can
    equal a valid probe (0 ≤ w < n), and a repeated id still counts once
    under "any slot equals". One host sync (the number of ids kept).

    Raises:
      ValueError: ``table`` is not (n, B, D) int32 with B a power of two,
        or it keeps more ids than int32 offsets reach.
    """
    if not isinstance(table, torch.Tensor) or table.dim() != 3 \
            or table.dtype != torch.int32:
        raise ValueError(f"need an (n, B, D) int32 table, got "
                         f"{getattr(table, 'dtype', type(table))} "
                         f"{tuple(getattr(table, 'shape', ()))}")
    n, num_buckets, _ = (int(x) for x in table.shape)
    if num_buckets < 1 or num_buckets & (num_buckets - 1):
        raise ValueError(f"the table's bucket count B = {num_buckets} must "
                         f"be a power of two")
    keep = (table >= 0) & (table < n)
    ptr = _offsets(keep.sum(dim=2, dtype=torch.int32).reshape(-1))
    _check_nnz(int(ptr[-1]))
    return CompactHashTable(ptr, table[keep], num_buckets)


def expand_hash_table(compact: CompactHashTable, depth: int) -> torch.Tensor:
    """The dense (n, B, D) int32 table of a compact one: chain (v, b)'s k-th
    id in slot k, empty slots -1, ids ranked past ``depth`` dropped (as
    ``build_hash_table`` drops them). For tests and the dense entry point.
    """
    ptr, vals, num_buckets = compact
    n, depth = compact.n, int(depth)
    chains = n * num_buckets
    flat_table = torch.full((chains * depth + 1,), -1, dtype=torch.int32,
                            device=vals.device)
    if vals.numel() and depth:
        lengths = (ptr[1:] - ptr[:-1]).long()
        chain = torch.repeat_interleave(
            torch.arange(chains, dtype=torch.int64, device=vals.device),
            lengths, output_size=int(vals.numel()))
        rank = torch.arange(vals.numel(), dtype=torch.int64,
                            device=vals.device) - ptr[chain].long()
        flat = torch.where(rank < depth, chain * depth + rank, chains * depth)
        flat_table.scatter_(0, flat, vals)
    return flat_table[:chains * depth].view(n, num_buckets, depth)
