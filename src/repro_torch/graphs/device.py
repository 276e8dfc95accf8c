"""Device-resident graph containers and prep primitives (torch).

The port of ``repro.graphs.device``: CSR build by sorting, degree-rank
forward orientation, padded neighbour gathers, the degree-class bucket
layout, the 2-core peel and the BFS levels of the bfs lane (with its
level orientation), the packed undirected-edge keys of the edge and
dynamic lanes and the dynamic lane's in-place update step, as torch ops on
an explicit ``torch.device``; and the round-robin deal of the buckets
across a mesh's shards (``ShardedDeviceCSR``) that the sharded lanes
hold, one shard a rank.

Packed edge keys are ``lo·(n+1)+hi``: int32 while ``(n+1)² ≤ int32 max``
(n ≤ 46,339), int64 ("wide") past it or when asked for, with the dtype's
max as the dead-slot sentinel. Each key is computed in int64 and cast to
the mode's dtype, so an int32 session holds int32 keys, as the reference
does.

``ShapePolicy`` rounds every data-dependent extent (edge-array lengths,
per-bucket edge counts) up to a power of two, padding with the repo-wide
whole-row sentinels (``-1`` for u rows, ``-2`` for v rows), so bucket shapes
equal the reference's and same-policy graphs share cached launch
configurations.

Sentinel conventions (see ``repro_torch.kernels.intersect.ops``): in-row
padding uses ``n`` (u side) / ``n + 1`` (v side); whole padding rows use
``-1`` / ``-2``; padded ``col_idx`` slots use ``n``.

Every sort here is stable (``stable=True``): the bucket layout depends on
kept edges staying in CSR order, as the reference's ``jnp.argsort`` keeps
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.graphs.formats import Graph
from repro_torch.spans import span

__all__ = [
    "DEFAULT_SHAPE_POLICY",
    "DeviceCSR",
    "DeviceGraph",
    "EDGE_KEY_MODES",
    "EDGE_KEY_SENTINEL",
    "GraphTooLargeError",
    "ShapePolicy",
    "ShardedBucket",
    "ShardedDeviceCSR",
    "WIDE_EDGE_KEY_SENTINEL",
    "bfs_levels",
    "deal_across_shards",
    "deal_shard",
    "dynamic_update_step",
    "edge_key_dtype",
    "edge_key_sentinel",
    "fits_int32_pair_keys",
    "fits_int64_pair_keys",
    "next_pow2",
    "resolve_device",
    "resolve_edge_key_mode",
    "shard_valid_counts",
]

#: Valid values for every ``key_mode`` parameter.
EDGE_KEY_MODES: Tuple[str, ...] = ("auto", "int32", "wide")

#: Dead-slot sentinels of the two key modes (each dtype's max): they sort
#: past every real key, and no real key reaches them.
EDGE_KEY_SENTINEL: int = int(np.iinfo(np.int32).max)
WIDE_EDGE_KEY_SENTINEL: int = int(np.iinfo(np.int64).max)


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.

    Raises:
      RuntimeError: ``device`` is None or names CUDA and no CUDA device is
        available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run its plain torch paths"
        )
    return dev


class GraphTooLargeError(ValueError):
    """The graph exceeds a lane's packed-edge-key capacity.

    Raised from :func:`resolve_edge_key_mode` when ``key_mode="int32"`` is
    forced past ``fits_int32_pair_keys`` (n ≤ 46339), or when n is so large
    that even int64 keys would overflow (n ≳ 3e9)."""


def next_pow2(x: int) -> int:
    """Smallest power of two ≥ ``x`` (and ≥ 1)."""
    x = int(x)
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def fits_int32_pair_keys(n: int) -> bool:
    """Whether ``(n + 1)²`` fits the int32 range (n ≤ 46339)."""
    return (n + 1) ** 2 <= np.iinfo(np.int32).max


def fits_int64_pair_keys(n: int) -> bool:
    """Whether ``(n + 1)²`` fits the int64 range (n ≲ 3e9)."""
    return (n + 1) ** 2 <= np.iinfo(np.int64).max


def resolve_edge_key_mode(n: int, key_mode: str = "auto", *,
                          lane: str = "edge") -> str:
    """The capacity checkpoint: resolve a requested key mode for a graph.

    Torch has int64 natively, so the port builds its packed keys in int64
    in every mode; the checkpoint keeps the reference's contract so that a
    forced ``"int32"`` past the bound still raises.

    Returns:
      "int32" or "wide".

    Raises:
      ValueError: unknown ``key_mode``.
      GraphTooLargeError: ``key_mode="int32"`` past ``fits_int32_pair_keys``,
        or n past ``fits_int64_pair_keys`` in any mode.
    """
    if key_mode not in EDGE_KEY_MODES:
        raise ValueError(
            f"key_mode must be one of {EDGE_KEY_MODES}, got {key_mode!r}"
        )
    if not fits_int64_pair_keys(n):
        raise GraphTooLargeError(
            f"the {lane} lane packs vertex pairs into (n+1)-radix keys and "
            f"(n+1)^2 overflows even int64 for n={n}; no key mode supports "
            f"this graph (the matrix / hash / bfs lanes use no packed keys "
            f"and remain available)"
        )
    if fits_int32_pair_keys(n):
        return "wide" if key_mode == "wide" else "int32"
    if key_mode == "int32":
        raise GraphTooLargeError(
            f"the {lane} lane was forced to key_mode='int32' but "
            f"(n+1)^2 > int32 max for n={n} (the int32 fast path needs "
            f"n <= 46339); use key_mode='auto' or 'wide' for this graph, "
            f"or the matrix / hash / bfs lanes, which use no packed keys"
        )
    return "wide"


def edge_key_dtype(mode: str) -> torch.dtype:
    """The dtype of packed edge keys in a resolved key mode."""
    return torch.int64 if mode == "wide" else torch.int32


def edge_key_sentinel(mode: str) -> int:
    """The dead-slot sentinel (the dtype's max) of a resolved key mode."""
    return WIDE_EDGE_KEY_SENTINEL if mode == "wide" else EDGE_KEY_SENTINEL


@dataclasses.dataclass(frozen=True)
class ShapePolicy:
    """How data-dependent extents are rounded into static shape classes.

    Attributes:
      edge_rounding: "pow2" (default) rounds every edge extent up to the
        next power of two; "exact" keeps true extents (the parity-testing
        configuration).
      min_edges: floor on any rounded extent.
    """

    edge_rounding: str = "pow2"
    min_edges: int = 8

    def __post_init__(self):
        if self.edge_rounding not in ("pow2", "exact"):
            raise ValueError(
                f"edge_rounding must be 'pow2' or 'exact', "
                f"got {self.edge_rounding!r}"
            )
        if not isinstance(self.min_edges, int) or isinstance(self.min_edges, bool) \
                or self.min_edges < 1:
            raise ValueError(
                f"min_edges must be a positive int, got {self.min_edges!r}"
            )

    def round_edges(self, count: int) -> int:
        """The static extent an array of ``count`` edge rows is padded to."""
        count = int(count)
        if self.edge_rounding == "exact":
            return max(count, 1)
        return max(self.min_edges, next_pow2(count))

    def key(self) -> tuple:
        """Hashable identity used in options/cache keys."""
        return (self.edge_rounding, self.min_edges)


DEFAULT_SHAPE_POLICY = ShapePolicy()


# ---------------------------------------------------------------------------
# Prep primitives — int32 tensors in and out, int64 only for indexing/keys
# ---------------------------------------------------------------------------

def _edge_sources(row_ptr: torch.Tensor, *, n: int, m_pad: int) -> torch.Tensor:
    """src[i] = CSR row owning slot i (the device analogue of np.repeat)."""
    slots = torch.arange(m_pad, dtype=torch.int32, device=row_ptr.device)
    src = torch.searchsorted(row_ptr, slots, right=True, out_int32=True) - 1
    return src.clamp_(0, max(n - 1, 0))


def _csr_from_edges(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                    *, n: int, m_pad: int):
    """Sort-based CSR build from a (possibly unsorted, masked) edge list.

    Assumes the valid (src, dst) pairs are deduplicated directed edges;
    invalid slots sort to the end. Returns (row_ptr, col_idx, m) with
    ``col_idx`` padded with the sentinel ``n`` and ``m`` the valid count.
    """
    key = src.long() * (n + 1) + dst.long()
    key.masked_fill_(~valid, torch.iinfo(torch.int64).max)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    m = int(valid.sum())
    pos = torch.arange(m_pad, device=src.device)
    col = torch.where(pos < m, dst[order], n).to(torch.int32)
    row_starts = torch.arange(n + 1, dtype=torch.int64, device=src.device) * (n + 1)
    row_ptr = torch.searchsorted(skey, row_starts, out_int32=True)
    return row_ptr, col, m


def _orient_by_rank_dev(row_ptr: torch.Tensor, col_idx: torch.Tensor, m: int,
                        rank: torch.Tensor, *, n: int, m_pad: int, mf_pad: int):
    """Forward orientation by ``(rank, id)``, compacted to static shape.

    Keeps u→v iff (rank(u), u) < (rank(v), v), so each undirected edge is
    kept in exactly one direction: ``rank`` is the degree for the forward
    lanes and the BFS level for the bfs lane. The kept edges occupy the
    leading slots in CSR order; ``kvalid`` marks them. Returns (fwd_src,
    fwd_dst, kvalid, fwd_row_ptr, fwd_deg).
    """
    dev = row_ptr.device
    src = _edge_sources(row_ptr, n=n, m_pad=m_pad)
    dst = col_idx
    valid = torch.arange(m_pad, device=dev) < m
    ru = rank[src.long()]
    rv = rank[dst.long().clamp(0, max(n - 1, 0))]
    keep = valid & ((ru < rv) | ((ru == rv) & (src < dst)))
    # stable: kept edges first, CSR order intact
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    take = order[:mf_pad]
    kvalid = keep[take]
    fsrc = torch.where(kvalid, src[take], 0).to(torch.int32)
    fdst = torch.where(kvalid, dst[take], 0).to(torch.int32)
    fdeg = torch.zeros(max(n, 1), dtype=torch.int32, device=dev)
    fdeg.index_add_(0, fsrc.long(), kvalid.to(torch.int32))
    fdeg = fdeg[:n]
    frow_ptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    frow_ptr[1:] = torch.cumsum(fdeg, 0)
    return fsrc, fdst, kvalid, frow_ptr, fdeg


def _padded_neighbors_dev(src: torch.Tensor, dst: torch.Tensor,
                          valid: torch.Tensor, row_ptr: torch.Tensor,
                          *, n: int, width: int) -> torch.Tensor:
    """(n, width) neighbour matrix padded with the in-row sentinel ``n``.

    Edge slot i lands at column ``i - row_ptr[src[i]]`` (edges are in CSR
    order, so each row's slots are contiguous). Slots that are invalid or
    past ``width`` are masked out before the scatter: an out-of-range index
    is a device fault on CUDA, not a dropped write.
    """
    src_l = src.long()
    pos = torch.arange(src.shape[0], device=src.device) - row_ptr[src_l]
    keep = valid & (pos < width)
    out = torch.full((n, width), n, dtype=torch.int32, device=src.device)
    out[src_l[keep], pos[keep]] = dst[keep].to(torch.int32)
    return out


def _bucket_sort_dev(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                     deg: torch.Tensor, bounds: torch.Tensor,
                     *, n: int, num_bounds: int):
    """Stable-sort edges into degree-class buckets.

    Bucket of an edge = first bound ≥ max(deg[src], deg[dst]); invalid
    slots sort into a trailing overflow class. Returns (sorted_src,
    sorted_dst, counts, starts) with counts/starts per real bucket.
    """
    lim = max(n - 1, 0)
    w = torch.maximum(deg[src.long().clamp(0, lim)],
                      deg[dst.long().clamp(0, lim)])
    b = torch.searchsorted(bounds, w.to(bounds.dtype), out_int32=True)
    b = torch.where(valid, b, num_bounds)
    order = torch.argsort(b, stable=True)  # CSR order kept within a bucket
    counts = torch.bincount(b, minlength=num_bounds + 1)[:num_bounds]
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])[:num_bounds]
    return src[order], dst[order], counts, starts


def _gather_bucket_dev(sorted_src: torch.Tensor, sorted_dst: torch.Tensor,
                       start: int, count: int, nbrs: torch.Tensor,
                       *, n: int, e_pad: int, width: int):
    """Materialize one bucket's padded (e_pad, width) neighbour-list pair.

    Rows past ``count`` are whole-row padding: u = -1, v = -2. Within real
    rows u keeps the in-row sentinel ``n`` and v's is rewritten to
    ``n + 1``. Returns (u_lists, v_lists, src, dst) as int32; padding rows
    carry src = dst = 0 (their match counts are zero). Built in place, so
    the largest transient is one (e_pad, width) bool mask.
    """
    return _gather_bucket_rows_dev(sorted_src, sorted_dst, start, count, nbrs,
                                   n=n, lo=0, hi=e_pad, width=width)


def _gather_bucket_rows_dev(sorted_src: torch.Tensor, sorted_dst: torch.Tensor,
                            start: int, count: int, nbrs: torch.Tensor,
                            *, n: int, lo: int, hi: int, width: int):
    """Rows [lo, hi) of one bucket's padded layout (see
    ``_gather_bucket_dev``), so an over-budget bucket can be gathered one
    chunk at a time: the largest transient is one (hi - lo, width) mask."""
    dev = sorted_src.device
    rows = hi - lo
    real = max(0, min(hi, count) - lo)  # rows of this range below count
    sb = torch.zeros(rows, dtype=torch.int32, device=dev)
    db = torch.zeros(rows, dtype=torch.int32, device=dev)
    sb[:real] = sorted_src[start + lo:start + lo + real]
    db[:real] = sorted_dst[start + lo:start + lo + real]
    cols = nbrs[:, :width]
    u = cols.index_select(0, sb.long())
    u[real:] = -1
    v = cols.index_select(0, db.long())
    v.masked_fill_(v == n, n + 1)
    v[real:] = -2
    return u, v, sb, db


def _sorted_edge_keys_dev(src: torch.Tensor, dst: torch.Tensor,
                          valid: torch.Tensor, *, n1: int, wide: bool = False):
    """Sorted packed keys of a masked undirected edge list, and the sort
    permutation.

    A live slot's key is ``min(src, dst)·n1 + max(src, dst)`` (``n1`` =
    n + 1), so ascending keys are ascending (lo, hi) pairs, the order of
    ``Graph.edge_list_unique``. Dead slots take the dtype's max and sort to
    the end. The sort is stable, so ``perm``'s dead slots stay in slot
    order, as the reference's ``jnp.argsort`` leaves them. Returns
    ``(sorted_keys, perm)`` with ``sorted_keys = keys[perm]``: int32 keys,
    or int64 when ``wide``, and an int32 ``perm``.
    """
    kdt = torch.int64 if wide else torch.int32
    lo = torch.minimum(src, dst).long()
    hi = torch.maximum(src, dst).long()
    key = torch.where(valid, lo * n1 + hi,
                      WIDE_EDGE_KEY_SENTINEL if wide else EDGE_KEY_SENTINEL)
    sorted_keys, perm = torch.sort(key.to(kdt), stable=True)
    return sorted_keys, perm.to(torch.int32)


def _two_core_peel_dev(src: torch.Tensor, dst: torch.Tensor,
                       valid: torch.Tensor, init_alive: torch.Tensor,
                       *, n: int) -> Tuple[torch.Tensor, int]:
    """Fixed-point 2-core peel over a masked static edge list.

    Each round counts every vertex's live edges (``valid`` and both ends
    alive) with one ``index_add_`` and drops the vertices left with fewer
    than two; the loop ends when a round changes nothing, one host sync a
    round. Endpoints are clamped before every gather and scatter (padding
    ``col_idx`` slots hold ``n``); such slots are masked by ``valid``.
    Returns (alive, rounds).
    """
    lim = max(n - 1, 0)
    src_c = src.long().clamp(0, lim)
    dst_c = dst.long().clamp(0, lim)
    alive = init_alive.clone()
    rounds = 0
    while True:
        rounds += 1
        live = valid & alive[src_c] & alive[dst_c]
        deg = torch.zeros(n, dtype=torch.int32, device=src.device)
        deg.index_add_(0, src_c, live.to(torch.int32))
        new_alive = alive & (deg >= 2)
        if torch.equal(new_alive, alive):
            return alive, rounds
        alive = new_alive


def _bfs_levels_dev(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                    *, n: int) -> Tuple[torch.Tensor, int]:
    """Multi-source BFS levels over a masked static directed edge list.

    Sources are the id-local minima — vertices with no smaller-id
    neighbour — so every connected component holds one (its minimum-id
    vertex) and isolated vertices are their own sources; every vertex ends
    at a finite level. Levels relax as a frontier fixed point,
    ``lvl[v] = min(lvl[v], 1 + min over in-edges of lvl[u])``: one masked
    ``scatter_reduce_(..., "amin")`` over clamped ids a round, and the loop
    ends when a round changes nothing, one host sync a round. Returns
    ((n,) int32 levels, rounds run).
    """
    dev = src.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev), 0
    lim = n - 1
    src_c = src.long().clamp(0, lim)
    dst_c = dst.long().clamp(0, lim)
    inf = n  # BFS levels are hop counts < n
    smaller = torch.zeros(n, dtype=torch.int32, device=dev)
    smaller.index_add_(0, dst_c, (valid & (src < dst)).to(torch.int32))
    lvl = torch.where(smaller > 0, inf, 0).to(torch.int32)
    rounds = 0
    while True:
        rounds += 1
        through = torch.where(valid, lvl[src_c] + 1, inf)
        cand = torch.full((n,), inf, dtype=torch.int32, device=dev)
        cand.scatter_reduce_(0, dst_c, through, "amin")
        new = torch.minimum(lvl, cand)
        if torch.equal(new, lvl):
            return lvl, rounds
        lvl = new


def bfs_levels(dg: "DeviceGraph") -> torch.Tensor:
    """(n,) int32 BFS levels of a ``DeviceGraph`` (see ``_bfs_levels_dev``).

    The bfs counting lane orders vertices by ``(level, id)`` — a total
    order, so orienting every edge toward its larger-rank endpoint yields a
    DAG in which each triangle has exactly one wedge vertex (its
    rank-minimum) and is closed exactly once.
    """
    return _bfs_levels_dev(dg.edge_sources(), dg.csr.col_idx, dg.edge_valid(),
                           n=dg.n)[0]


def _induced_compact_dev(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                         alive: torch.Tensor, m: int, *, n: int, m_pad: int):
    """Compact the directed edges with both endpoints alive (CSR order kept).

    Vertex ids are not renumbered: dead vertices end with empty rows, so
    per-vertex scatters downstream stay in original-id space. The stable
    sort on an integer key keeps the kept edges in CSR order, as the
    reference's ``jnp.argsort(~keep)`` does. Returns (row_ptr_sub, col_sub,
    kept) with ``col_sub`` padded with ``n`` and ``kept`` a 0-d tensor.
    """
    dev = row_ptr.device
    src = _edge_sources(row_ptr, n=n, m_pad=m_pad)
    valid = torch.arange(m_pad, device=dev) < m
    lim = max(n - 1, 0)
    keep = valid & alive[src.long()] & alive[col_idx.long().clamp(0, lim)]
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    kval = keep[order]
    col = torch.where(kval, col_idx[order], n).to(torch.int32)
    ksrc = torch.where(kval, src[order], 0).long()
    deg = torch.zeros(max(n, 1), dtype=torch.int32, device=dev)
    deg.index_add_(0, ksrc, kval.to(torch.int32))
    row_ptr_sub = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    row_ptr_sub[1:] = torch.cumsum(deg[:n], 0)
    return row_ptr_sub, col, keep.sum()


def _anchor_rows(keys: torch.Tensor, rkeys: torch.Tensor, verts: torch.Tensor,
                 valid: torch.Tensor, *, n: int, width: int):
    """Padded adjacency rows of a batch of anchor vertices, read straight
    from the two sorted key orderings (no (n, W) matrix is built).

    Vertex v's neighbours above v are the run of ``keys`` (sorted
    ``lo·(n+1)+hi``) in ``[v·(n+1), v·(n+1) + n)``, those below it the same
    run of ``rkeys`` (sorted ``hi·(n+1)+lo``); two searches a side find
    them. The reverse run goes first, so each row ascends, padded with the
    in-row sentinel ``n``. Invalid anchors get all-padding rows and degree
    0. Returns ``(rows (B, width) int32, deg (B,) int32)``; the key dtype
    follows ``keys``.
    """
    cap = int(keys.shape[0])
    kdt = keys.dtype
    n1 = n + 1
    v = verts.long().clamp(0, max(n - 1, 0))
    base = (v * n1).to(kdt)
    # v·n1 + n is in range for either dtype: resolve_edge_key_mode rules
    # out the int32 overflow
    top = (v * n1 + n).to(kdt)
    sf = torch.searchsorted(keys, base)
    ef = torch.searchsorted(keys, top)
    sr = torch.searchsorted(rkeys, base)
    er = torch.searchsorted(rkeys, top)
    df = torch.where(valid, ef - sf, 0)
    dr = torch.where(valid, er - sr, 0)
    lanes = torch.arange(width, device=keys.device)[None, :]
    rev = rkeys[(sr[:, None] + lanes).clamp_(0, cap - 1)] % n1
    fwd = keys[(sf[:, None] + lanes - dr[:, None]).clamp_(0, cap - 1)] % n1
    rows = torch.where(lanes < dr[:, None], rev,
                       torch.where(lanes < (dr + df)[:, None], fwd, n))
    return rows.to(torch.int32), (df + dr).to(torch.int32)


def dynamic_update_step(keys: torch.Tensor, rkeys: torch.Tensor,
                        upd_keys: torch.Tensor, upd_rkeys: torch.Tensor,
                        upd_ins: torch.Tensor, upd_valid: torch.Tensor,
                        *, n: int, width: int):
    """One step of the dynamic lane: apply a padded batch of edge updates
    to the device-resident edge set.

    The edge set is two sorted orderings of packed keys, ``keys`` by
    ``lo·(n+1)+hi`` and ``rkeys`` by ``hi·(n+1)+lo``, each of capacity
    ``keys.shape[0]`` with the dtype's max in dead slots; together they are
    the adjacency (a vertex's row is two contiguous runs). The step:

    1. resolves the batch against the set: effective deletes are requested
       deletes that are present, effective inserts requested inserts that
       are absent;
    2. tombstones each deleted slot in both orderings, then merges the
       inserts in and compacts each ordering with one sort (the caller has
       grown the capacity so that the live edges fit);
    3. gathers the anchor rows of every update edge's endpoints at the
       ``width`` class, before the update (for Δ⁻) and after it (for Δ⁺),
       with :func:`_anchor_rows`;
    4. finds every vertex's degree in the new set with one search of each
       ordering, for the max-degree statistic.

    Nothing here syncs with the host. Returns (new_keys, new_rkeys,
    eff_ins, eff_del, ins_skeys, del_skeys, old_lo_rows, old_hi_rows,
    old_lo_deg, old_hi_deg, new_lo_rows, new_hi_rows, new_lo_deg,
    new_hi_deg, stats): ``ins_skeys`` / ``del_skeys`` are the sorted
    effective update keys (sentinel-padded), the row blocks (ub, width)
    int32, the degrees (ub,) int32, and ``stats`` the (4,) int32
    ``[live_edges, max_degree, num_inserted, num_deleted]``.
    """
    cap = int(keys.shape[0])
    kdt = keys.dtype
    sent = WIDE_EDGE_KEY_SENTINEL if kdt == torch.int64 else EDGE_KEY_SENTINEL
    n1 = n + 1
    # -- resolve: which requests take effect against the current set
    idx = torch.searchsorted(keys, upd_keys).clamp_(0, cap - 1)
    present = (keys[idx] == upd_keys) & upd_valid
    eff_del = present & ~upd_ins
    eff_ins = upd_valid & upd_ins & ~present
    del_skeys = torch.sort(torch.where(eff_del, upd_keys, sent)).values
    ins_skeys = torch.sort(torch.where(eff_ins, upd_keys, sent)).values
    # -- apply: tombstone deletes, then merge the inserts and compact; a
    # masked index lands on a scratch slot past the end (mode="drop" in the
    # reference: an out-of-range index is a device fault in torch)
    ins_keys = torch.where(eff_ins, upd_keys, sent)
    ins_rkeys = torch.where(eff_ins, upd_rkeys, sent)
    ridx = torch.searchsorted(rkeys, upd_rkeys).clamp_(0, cap - 1)
    new = []
    for ordering, pos, inserts in ((keys, idx, ins_keys),
                                   (rkeys, ridx, ins_rkeys)):
        tomb = torch.cat([ordering, ordering.new_full((1,), sent)])
        tomb[torch.where(eff_del, pos, cap)] = sent
        new.append(torch.sort(torch.cat([tomb[:cap], inserts])).values[:cap])
    new_keys, new_rkeys = new
    # -- gather: anchor rows for the delta passes
    lo = torch.where(upd_valid, upd_keys // n1, 0).to(torch.int32)
    hi = torch.where(upd_valid, upd_keys % n1, 0).to(torch.int32)
    old_lo_rows, old_lo_deg = _anchor_rows(keys, rkeys, lo, upd_valid,
                                           n=n, width=width)
    old_hi_rows, old_hi_deg = _anchor_rows(keys, rkeys, hi, upd_valid,
                                           n=n, width=width)
    new_lo_rows, new_lo_deg = _anchor_rows(new_keys, new_rkeys, lo,
                                           upd_valid, n=n, width=width)
    new_hi_rows, new_hi_deg = _anchor_rows(new_keys, new_rkeys, hi,
                                           upd_valid, n=n, width=width)
    # -- degrees of the new set: one n-query search of each ordering
    live = (new_keys != sent).sum()
    bnds = (torch.arange(n, device=keys.device) * n1).to(kdt)
    tail = live.reshape(1)
    deg = (torch.diff(torch.cat([torch.searchsorted(new_keys, bnds), tail]))
           + torch.diff(torch.cat([torch.searchsorted(new_rkeys, bnds), tail])))
    stats = torch.stack([
        live,
        torch.cat([deg, deg.new_zeros(1)]).max(),  # max(initial=0)
        eff_ins.sum(),
        eff_del.sum(),
    ]).to(torch.int32)
    return (new_keys, new_rkeys, eff_ins, eff_del, ins_skeys, del_skeys,
            old_lo_rows, old_hi_rows, old_lo_deg, old_hi_deg,
            new_lo_rows, new_hi_rows, new_lo_deg, new_hi_deg, stats)


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceCSR:
    """Device-resident CSR arrays (undirected-symmetric or oriented).

    ``col_idx`` is padded to a policy-rounded length with the sentinel
    ``n``; ``m`` is the true directed edge count.
    """

    n: int
    m: int
    row_ptr: torch.Tensor  # (n+1,) int32
    col_idx: torch.Tensor  # (m_pad,) int32, padded with n

    @property
    def m_pad(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def degrees(self) -> torch.Tensor:
        return torch.diff(self.row_ptr)

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @classmethod
    def from_graph(cls, g: Graph, policy: ShapePolicy = DEFAULT_SHAPE_POLICY,
                   *, device: Union[str, torch.device]) -> "DeviceCSR":
        """Upload a host ``Graph``, padding ``col_idx`` to the policy extent."""
        m_pad = policy.round_edges(g.m_directed)
        col = np.full(m_pad, g.n, dtype=np.int32)
        col[:g.m_directed] = g.col_idx
        return cls(n=g.n, m=g.m_directed,
                   row_ptr=torch.as_tensor(g.row_ptr, dtype=torch.int32).to(device),
                   col_idx=torch.from_numpy(col).to(device))

    @classmethod
    def from_edges(cls, src, dst, n: int, *, valid=None,
                   policy: ShapePolicy = DEFAULT_SHAPE_POLICY,
                   key_mode: str = "auto",
                   device: Union[str, torch.device]) -> "DeviceCSR":
        """Sort-based CSR build from deduplicated directed edges.

        Args:
          src, dst: equal-length integer arrays or tensors of directed
            edges; need not be sorted.
          n: vertex count.
          valid: optional bool mask of live slots.
          policy: extent-rounding policy for the arrays.
          key_mode: checked by ``resolve_edge_key_mode`` (keys are int64 in
            every mode).
          device: where the arrays live.

        Raises:
          GraphTooLargeError: see :func:`resolve_edge_key_mode`.
        """
        resolve_edge_key_mode(n, key_mode, lane="csr-build")
        src = torch.as_tensor(src).to(device=device, dtype=torch.int32)
        dst = torch.as_tensor(dst).to(device=device, dtype=torch.int32)
        e = int(src.shape[0])
        valid = torch.ones(e, dtype=torch.bool, device=src.device) \
            if valid is None else torch.as_tensor(valid).to(src.device, torch.bool)
        m_pad = policy.round_edges(e)
        pad = m_pad - e
        if pad:
            src = torch.cat([src, src.new_zeros(pad)])
            dst = torch.cat([dst, dst.new_zeros(pad)])
            valid = torch.cat([valid, valid.new_zeros(pad)])
        row_ptr, col, m = _csr_from_edges(src, dst, valid, n=n, m_pad=m_pad)
        return cls(n=int(n), m=m, row_ptr=row_ptr, col_idx=col)


@dataclasses.dataclass
class ForwardEdges:
    """The degree-rank-oriented edge set of a ``DeviceGraph``."""

    src: torch.Tensor      # (mf_pad,) int32, kept edges first
    dst: torch.Tensor      # (mf_pad,) int32
    kvalid: torch.Tensor   # (mf_pad,) bool
    row_ptr: torch.Tensor  # (n+1,) int32
    degrees: torch.Tensor  # (n,) int32 forward out-degrees
    m: int                 # kept edge count (= m_directed // 2)


class DeviceGraph:
    """A graph resident on a device, with cached prep structure.

    Wraps a ``DeviceCSR`` and a ``ShapePolicy``; the forward orientation and
    padded neighbour matrices are computed lazily and cached on the
    instance.
    """

    def __init__(self, csr: DeviceCSR, policy: ShapePolicy = DEFAULT_SHAPE_POLICY,
                 name: str = "graph"):
        self.csr = csr
        self.policy = policy
        self.name = name
        self._fwd: Optional[ForwardEdges] = None
        self._nbrs: Dict[Tuple[int, bool], torch.Tensor] = {}

    @property
    def n(self) -> int:
        return self.csr.n

    @property
    def m(self) -> int:
        """True directed edge count."""
        return self.csr.m

    @property
    def m_undirected(self) -> int:
        return self.csr.m // 2

    @property
    def device(self) -> torch.device:
        return self.csr.device

    def edge_sources(self) -> torch.Tensor:
        """(m_pad,) CSR row of every directed edge slot."""
        return _edge_sources(self.csr.row_ptr, n=self.n, m_pad=self.csr.m_pad)

    def edge_valid(self) -> torch.Tensor:
        """(m_pad,) mask of live (non-padding) edge slots."""
        return torch.arange(self.csr.m_pad, device=self.device) < self.m

    @classmethod
    def from_graph(cls, g: Graph, policy: ShapePolicy = DEFAULT_SHAPE_POLICY,
                   *, device: Union[str, torch.device]) -> "DeviceGraph":
        with span("tc.prep.upload"):
            return cls(DeviceCSR.from_graph(g, policy, device=device),
                       policy=policy, name=g.name)

    def forward(self) -> ForwardEdges:
        """Degree-rank forward orientation (rank = (degree, id)), cached."""
        if self._fwd is None:
            with span("tc.prep.orient"):
                mf_pad = max(1, self.csr.m_pad // 2)
                fsrc, fdst, kvalid, frow_ptr, fdeg = _orient_by_rank_dev(
                    self.csr.row_ptr, self.csr.col_idx, self.m,
                    torch.diff(self.csr.row_ptr), n=self.n,
                    m_pad=self.csr.m_pad, mf_pad=mf_pad,
                )
                self._fwd = ForwardEdges(fsrc, fdst, kvalid, frow_ptr, fdeg,
                                         m=self.m // 2)
        return self._fwd

    def level_oriented(self, lvl: torch.Tensor) -> ForwardEdges:
        """The edges oriented by ``(lvl, id)`` (the bfs lane's order), in
        the layout of ``forward()``; not cached."""
        mf_pad = max(1, self.csr.m_pad // 2)
        fsrc, fdst, kvalid, frow_ptr, fdeg = _orient_by_rank_dev(
            self.csr.row_ptr, self.csr.col_idx, self.m, lvl,
            n=self.n, m_pad=self.csr.m_pad, mf_pad=mf_pad,
        )
        return ForwardEdges(fsrc, fdst, kvalid, frow_ptr, fdeg, m=self.m // 2)

    def padded_neighbors(self, width: int, *, oriented: bool) -> torch.Tensor:
        """(n, width) neighbour matrix (in-row sentinel ``n``), cached.

        ``oriented=True`` gathers the forward (N⁺) lists; ``False`` the full
        undirected adjacency rows.
        """
        key = (int(width), bool(oriented))
        if key in self._nbrs:
            return self._nbrs[key]
        if oriented:
            fwd = self.forward()
            args = (fwd.src, fwd.dst, fwd.kvalid, fwd.row_ptr)
        else:
            args = (self.edge_sources(), self.csr.col_idx, self.edge_valid(),
                    self.csr.row_ptr)
        with span("tc.prep.neighbors"):
            self._nbrs[key] = _padded_neighbors_dev(*args, n=self.n,
                                                    width=int(width))
        return self._nbrs[key]

    def __repr__(self) -> str:
        return (f"DeviceGraph(name={self.name!r}, n={self.n}, "
                f"m_undirected={self.m_undirected}, policy={self.policy}, "
                f"device={self.device})")


# ---------------------------------------------------------------------------
# ShardedDeviceCSR: the (degree class × shard) edge partition
# ---------------------------------------------------------------------------

def shard_valid_counts(total: int, num_shards: int) -> np.ndarray:
    """Real rows of each shard under the round-robin deal.

    Row ``j`` goes to shard ``j % num_shards``, so shard ``s`` owns
    ``ceil((total - s) / num_shards)`` real rows: the shards differ by at
    most one row. Returns a (num_shards,) int32 array.
    """
    s = np.arange(int(num_shards), dtype=np.int64)
    return np.maximum(0, (int(total) - s + num_shards - 1) // num_shards) \
        .astype(np.int32)


def deal_shard(arr: torch.Tensor, num_shards: int, rows: int, shard: int, *,
               fill) -> torch.Tensor:
    """Row ``shard`` of ``deal_across_shards``: the ``(rows, ...)`` block
    whose position ``p`` holds input row ``p * num_shards + shard``, and
    ``fill`` where that row does not exist. One strided copy on ``arr``'s
    device; the other shards' rows are never materialised. With one shard
    and no fill needed, the block is ``arr``'s leading rows, shared and
    not copied (a world-1 mesh holds no second copy of its buckets)."""
    if int(num_shards) == 1 and int(rows) <= arr.shape[0]:
        return arr[: int(rows)]
    taken = arr[int(shard)::int(num_shards)][: int(rows)]
    out = torch.full((int(rows),) + tuple(arr.shape[1:]), fill,
                     dtype=arr.dtype, device=arr.device)
    out[: taken.shape[0]] = taken
    return out


def deal_across_shards(arr, num_shards: int, rows: int, *, fill) -> torch.Tensor:
    """Round-robin deal of axis 0 into a ``(num_shards, rows, ...)`` stack,
    as the reference deals it: shard ``s``, position ``p`` holds input row
    ``p * num_shards + s``, and ``fill`` past the input's end. A
    heavy-first schedule (the matrix lane's triples) or a bucket of rows of
    one width so hands every shard an equal mix of heavy and light work.
    The sharded lanes take one row of it on each rank (``deal_shard``)."""
    arr = torch.as_tensor(arr)
    return torch.stack([deal_shard(arr, num_shards, rows, s, fill=fill)
                        for s in range(int(num_shards))])


def _deal_chunk(rows: int) -> int:
    """The reference's length-gating granularity of one sharded bucket: the
    largest power of two ≤ 64 dividing ``rows`` (1 for ``rows`` ≤ 0). The
    port launches each shard's real rows exactly; the chunk sets the rows a
    shard is counted as dispatching (``ShardedBucket.dispatched_rows``) and
    rides in the cache key, as in the reference."""
    rows = int(rows)
    if rows <= 0:
        return 1
    return math.gcd(rows, 64)


@dataclasses.dataclass
class ShardedBucket:
    """One degree-class bucket dealt round-robin across a mesh's shards, as
    one rank holds it.

    ``u_lists`` / ``v_lists`` are this rank's ``(rows_per_shard, width)``
    int32 rows, row ``[shard]`` of the reference's stack: the first
    ``shard_rows[shard]`` are real, the rest whole-row padding (u = -1,
    v = -2). ``shard_rows`` keeps every shard's real-row count on the host.
    """

    width: int
    edges: int            # real rows over all shards
    rows_per_shard: int   # the policy-rounded extent of each shard
    chunk: int            # the reference's gating granularity
    u_lists: torch.Tensor  # (rows_per_shard, width), this shard's
    v_lists: torch.Tensor
    shard_rows: Tuple[int, ...]
    shard: int            # this rank's shard

    @property
    def num_shards(self) -> int:
        return len(self.shard_rows)

    @property
    def valid(self) -> int:
        """This shard's real rows: the rows its launches read."""
        return self.shard_rows[self.shard]

    @property
    def shape(self) -> tuple:
        """The per-shard shape ``(rows_per_shard, width)``."""
        return (self.rows_per_shard, self.width)

    @property
    def nbytes(self) -> int:
        """Device bytes of this shard's u and v rows."""
        return int(self.u_lists.numel() * 4 + self.v_lists.numel() * 4)

    def dispatched_rows(self) -> Tuple[int, ...]:
        """Each shard's real rows rounded up to the chunk, as the
        reference's length-gated loop dispatches them."""
        c = self.chunk
        return tuple(int(-(-r // c) * c) if r else 0 for r in self.shard_rows)


@dataclasses.dataclass
class ShardedDeviceCSR:
    """A graph's degree-class buckets dealt across a ``DeviceMesh``, as one
    rank holds them.

    Every rank preps the whole graph (the stable sorts make the buckets
    equal on every rank), deals each bucket round-robin over the mesh's
    flattened ranks (``deal_shard``) and keeps its own shard's rows only:
    the shards' work differs by at most one row a bucket.
    """

    mesh: Any               # torch.distributed.device_mesh.DeviceMesh
    variant: str
    buckets: list           # List[ShardedBucket]
    policy: ShapePolicy
    n: int
    edges: int              # real forward edges over all buckets
    shard: int

    @property
    def num_shards(self) -> int:
        return int(self.mesh.size())

    def shard_work(self) -> Tuple[int, ...]:
        """Dispatched rows of each shard, summed over the buckets (the
        reference's ``meta["shard_work"]``)."""
        work = np.zeros(self.num_shards, dtype=np.int64)
        for b in self.buckets:
            work += np.asarray(b.dispatched_rows(), dtype=np.int64)
        return tuple(int(w) for w in work)

    @property
    def nbytes(self) -> int:
        """Device bytes of this rank's rows over all buckets."""
        return sum(b.nbytes for b in self.buckets)

    @classmethod
    def from_buckets(cls, buckets, mesh, *, variant: str,
                     policy: Optional[ShapePolicy] = None, n: int = 0,
                     shard: Optional[int] = None) -> "ShardedDeviceCSR":
        """Deal prepped ``DeviceBucket``s across ``mesh``'s shards and keep
        shard ``shard`` (None: this rank's, ``mesh_shard_index``). Each
        shard's extent is ``policy.round_edges(ceil(edges / P))``."""
        from repro_torch.launch.mesh import mesh_shard_index

        policy = policy if policy is not None else DEFAULT_SHAPE_POLICY
        ndev = int(mesh.size())
        shard = mesh_shard_index(mesh) if shard is None else int(shard)
        out, total = [], 0
        for b in buckets:
            edges = int(b.edges)
            total += edges
            rows = policy.round_edges(-(-edges // ndev))
            out.append(ShardedBucket(
                width=int(b.width), edges=edges, rows_per_shard=int(rows),
                chunk=_deal_chunk(rows),
                u_lists=deal_shard(b.u_lists, ndev, rows, shard, fill=-1),
                v_lists=deal_shard(b.v_lists, ndev, rows, shard, fill=-2),
                shard_rows=tuple(int(x) for x in shard_valid_counts(edges, ndev)),
                shard=shard,
            ))
        return cls(mesh=mesh, variant=variant, buckets=out, policy=policy,
                   n=int(n), edges=total, shard=shard)

    @classmethod
    def from_graph(cls, g, mesh, *, device: Union[str, torch.device],
                   variant: str = "filtered", widths=(8, 32, 128, 512),
                   policy: Optional[ShapePolicy] = None,
                   prep_backend: str = "device",
                   shard: Optional[int] = None) -> "ShardedDeviceCSR":
        """Prep ``g``'s degree-class buckets on ``device`` (the torch prep,
        or the numpy one under ``prep_backend="host"``) and deal them."""
        from repro_torch.core.engine import _buckets_for_plan  # imports this module

        policy = policy if policy is not None else DEFAULT_SHAPE_POLICY
        buckets = _buckets_for_plan(g, variant, widths, prep_backend, policy,
                                    torch.device(device))
        return cls.from_buckets(buckets, mesh, variant=variant, policy=policy,
                                n=int(g.n), shard=shard)

    def __repr__(self) -> str:
        return (f"ShardedDeviceCSR(num_shards={self.num_shards}, "
                f"shard={self.shard}, variant={self.variant!r}, "
                f"edges={self.edges}, "
                f"buckets={[(b.shape, b.chunk) for b in self.buckets]})")
