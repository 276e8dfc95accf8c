"""Plan/execute engine for exact triangle counting.

The port of ``repro.core.engine`` for the paper's three formulations and
the two lanes built on the same buckets:

* ``"intersection"`` — per-edge set intersection over degree-class buckets;
* ``"subgraph"`` — a 2-core peel (FILTER), the induced graph
  (RECONSTRUCT), then the intersection join on the survivors;
* ``"matrix"`` — the fused masked block-SpGEMM over a heavy-first tile
  schedule;
* ``"hash"`` — the TRUST-style lane: the filtered buckets' candidate rows
  probed against a per-vertex hash table, held compactly;
* ``"bfs"`` — BFS levels order the vertices by (level, id), and the
  level-oriented buckets run through the intersection launches;
* ``"edge"`` — per-edge support over the filtered buckets and the
  k-truss peel (``TrussPlan``);
* ``"dynamic"`` — an edge set kept as two sorted orderings of packed keys
  on the device, updated in batches with an incrementally maintained
  count (``DynamicPlan``); its full recount runs the filtered
  intersection plan.

Planning runs the prep stage once on the session's device and binds each
work unit (a bucket, or the tile triples' unique tiles and indices) to a
cached launch configuration; ``count()`` then replays the resident buffers
through the kernels only:

    plan = plan_triangle_count(g, "intersection", device="cuda")
    plan.count()   # one kernel launch per stage, one host sync
    plan.count()   # the same buffers again; no prep runs

Each bucket's strategy (broadcast / probe / bitmap) comes from the
documented cost model in ``repro_torch.kernels.intersect.ops`` (or the
per-plan override), is part of the cache key, and is surfaced as
``meta["bucket_strategies"]``.

Every stage's counts are summed in int64 on the device. (The reference
sums each bucket's int32 counts in int32, hash buckets too, so a bucket
total past 2³¹ wraps there, and it adds the matrix lane's float32 partials in float32, which can
round once a count passes 2²⁴; every partial is an exact integer, so the
port's int64 sum is exact.)
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.graphs.formats import (
    Graph,
    csr_to_padded_neighbors,
    edges_to_csr,
    induced_subgraph,
    orient_forward,
)
from repro_torch.graphs.device import (
    DEFAULT_SHAPE_POLICY,
    DeviceCSR,
    DeviceGraph,
    ShapePolicy,
    ShardedDeviceCSR,
    deal_shard,
    dynamic_update_step,
    edge_key_dtype,
    edge_key_sentinel,
    next_pow2,
    resolve_device,
    resolve_edge_key_mode,
    shard_valid_counts,
)
from repro_torch.launch.mesh import (
    mesh_axes,
    mesh_ranks,
    mesh_shard_index,
    world_mesh,
)
from repro_torch.core import prep
from repro_torch.core.options import BACKENDS, DEFAULT_WIDTHS
from repro_torch.core.prep import (
    DeviceBucket,
    _bucket_nbytes,
    _tile_chunk_rows,
    bucket_is_tiled,
)
from repro_torch.core.registry import register_algorithm
from repro_torch.kernels.intersect.ops import (
    STRATEGIES,
    choose_strategy,
    intersect_counts,
    intersect_counts_csr,
    intersect_matches,
    intersect_matches_both,
    resolve_mask_strategy,
    resolve_strategy,
)
from repro_torch.kernels.hash_tc.ops import (
    CompactHashTable,
    build_compact_hash_table,
    hash_num_buckets,
    hash_probe_compact_counts,
    probe_row_ends,
)
from repro_torch.kernels.masked_spgemm import launch_order
from repro_torch.kernels.masked_spgemm.ops import masked_spgemm_gathered_counts
from repro_torch.spans import span

__all__ = [
    "ALGORITHMS",
    "BatchLaunch",
    "CsrProbeLaunch",
    "DISTRIBUTED_ALGORITHMS",
    "DeltaLaunch",
    "DynamicPlan",
    "DynamicStepLaunch",
    "EdgeLaunch",
    "GraphBatch",
    "HashLaunch",
    "IntersectLaunch",
    "MatrixLaunch",
    "STRATEGIES",
    "TrianglePlan",
    "TrussPlan",
    "VertexLaunch",
    "cache_info",
    "choose_strategy",
    "clear_caches",
    "clear_executable_cache",
    "executable_cache_info",
    "get_batch_executable",
    "get_executable",
    "mesh_cache_component",
    "mesh_group",
    "plan_bfs_count",
    "plan_dynamic_count",
    "plan_edge_support",
    "plan_hash_count",
    "plan_triangle_count",
    "prepare_intersection_buckets",
    "resolve_strategy",
    "set_cache_limit",
]


# ---------------------------------------------------------------------------
# Launch-configuration cache, shared across plans
# ---------------------------------------------------------------------------

class _BoundedLRU:
    """Thread-safe, size-bounded LRU of bound launch configurations.

    ``get_or_build`` is the single get-or-build gate: a hit moves the key to
    the MRU end; a miss claims the key under the lock, releases it, builds,
    then inserts and evicts from the LRU end. Racing requests for the same
    key wait on the claimant's event and pick up the one built entry
    (counted as hits). Eviction only drops the cache reference: live plans
    hold their entries directly.
    """

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"cache maxsize must be >= 1, got {maxsize}")
        self._data: "OrderedDict[tuple, Callable]" = OrderedDict()
        self._lock = threading.RLock()
        self._pending: Dict[tuple, threading.Event] = {}
        self.maxsize = int(maxsize)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key: tuple, builder: Callable[[], Callable]):
        while True:
            with self._lock:
                fn = self._data.get(key)
                if fn is not None:
                    self._data.move_to_end(key)
                    self.hits += 1
                    return fn
                ev = self._pending.get(key)
                if ev is None:
                    self._pending[key] = threading.Event()
                    self.misses += 1
                    break
            ev.wait()  # someone else is building this key; re-check
        try:
            with span("tc.cache.build"):
                fn = builder()
        except BaseException:
            with self._lock:
                self._pending.pop(key).set()
            raise
        with self._lock:
            self._data[key] = fn
            self._data.move_to_end(key)
            self._evict_locked()
            self._pending.pop(key).set()
        return fn

    def _evict_locked(self) -> None:
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
            self.evictions += 1

    def set_maxsize(self, maxsize: int) -> int:
        if maxsize < 1:
            raise ValueError(f"cache maxsize must be >= 1, got {maxsize}")
        with self._lock:
            old = self.maxsize
            self.maxsize = int(maxsize)
            self._evict_locked()
            return old

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    def info(self, include_keys: bool = False) -> dict:
        with self._lock:
            d = dict(size=len(self._data), hits=self.hits,
                     misses=self.misses, maxsize=self.maxsize,
                     evictions=self.evictions)
            if include_keys:
                d["keys"] = tuple(self._data.keys())
            return d

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


_EXECUTABLE_CACHE = _BoundedLRU(512)

#: The lanes ``plan_triangle_count`` plans.
ALGORITHMS = ("intersection", "matrix", "subgraph", "hash", "bfs")

#: The sharded lanes ``plan_triangle_count(..., mesh=)`` plans: each rank of
#: a ``DeviceMesh`` holds its shard of the dealt work, launches its kernels
#: on it, and one all-reduce over the mesh's ranks gives the count.
DISTRIBUTED_ALGORITHMS = ("intersection_distributed", "matrix_distributed")


def mesh_cache_component(mesh) -> tuple:
    """The mesh's identity in cache keys: ``(dim names, mesh shape, flat
    ranks)``, the reference's ``(axis names, shape, flat device ids)``.
    Plans over meshes with equal components share cached launches; a
    change of shard layout ((4,) → (2, 2)) misses once."""
    return (mesh_axes(mesh), tuple(int(s) for s in mesh.mesh.shape),
            mesh_ranks(mesh))


_MESH_GROUPS: Dict[tuple, Any] = {}
_MESH_GROUPS_LOCK = threading.Lock()


def mesh_group(mesh):
    """The process group of all the mesh's ranks, which a sharded count
    reduces over in ONE all-reduce whatever the mesh's rank: the default
    group when the mesh spans the world, else a group made once by
    ``dist.new_group`` (collective over the mesh's ranks) and cached by
    ``mesh_cache_component``."""
    ranks = mesh_ranks(mesh)
    if sorted(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    key = mesh_cache_component(mesh)
    with _MESH_GROUPS_LOCK:
        group = _MESH_GROUPS.get(key)
        if group is None:
            group = _MESH_GROUPS[key] = dist.new_group(
                list(ranks), use_local_synchronization=True)
    return group


def _check_mesh_device(mesh, device: torch.device) -> None:
    """A mesh's device type must be the plan's or the session's."""
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh's device type {mesh.device_type!r} is "
                         f"not that of the device {str(device)!r}")

# u elements the per-vertex stage handles per row chunk (bounds its
# (rows, W) mask and int64 index transients on the largest buckets)
_VERTEX_CHUNK_ELEMS = 1 << 22


@dataclasses.dataclass(frozen=True)
class IntersectLaunch:
    """One bucket shape's bound launch configuration: the resolved strategy,
    backend and bitmap capacity. Calling it on a (u, v) pair runs the
    strategy's kernel and returns the bucket total as an int64 scalar
    tensor on the bucket's device."""

    strategy: str
    backend: str
    bitmap_bits: Optional[int]

    def __call__(self, u_lists: torch.Tensor, v_lists: torch.Tensor) -> torch.Tensor:
        counts = intersect_counts(u_lists, v_lists, strategy=self.strategy,
                                  backend=self.backend,
                                  bitmap_bits=self.bitmap_bits)
        return counts.sum(dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class CsrProbeLaunch:
    """A resident probe bucket's launch on the forward CSR: calling it on
    ``(row_ptr, col, src, dst)``, the forward-oriented CSR and the
    bucket's real rows' endpoints, reads each row pair from the CSR at its
    real length (cut to ``width``) and returns the bucket total as an int64
    scalar tensor on the CSR's device."""

    backend: str
    width: int

    def __call__(self, row_ptr: torch.Tensor, col: torch.Tensor,
                 src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        counts = intersect_counts_csr(row_ptr, col, src, dst,
                                      width=self.width, backend=self.backend)
        return counts.sum(dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class MatrixLaunch:
    """The matrix lane's bound launch configuration. Calling it on the
    resident gathered form (the unique L, U and A tiles, the three (T,)
    int32 triple indices and the launch order) runs the masked block-SpGEMM
    and returns the total as an int64 scalar tensor on the tiles' device:
    every float32 partial is an exact integer ≤ B³, so the int64 sum is
    exact past 2²⁴."""

    backend: str

    def __call__(self, l_blocks: torch.Tensor, u_blocks: torch.Tensor,
                 a_blocks: torch.Tensor, l_index: torch.Tensor,
                 u_index: torch.Tensor, a_index: torch.Tensor,
                 order: Optional[torch.Tensor] = None) -> torch.Tensor:
        partials = masked_spgemm_gathered_counts(
            l_blocks, u_blocks, a_blocks, l_index, u_index, a_index,
            order=order, backend=self.backend)
        return partials.to(torch.int64).sum()


@dataclasses.dataclass(frozen=True)
class HashLaunch:
    """The hash lane's bound launch configuration. Calling it on a bucket's
    (v_lists, src, row_end) and the plan-wide compact table's (chain_ptr,
    chain_vals) runs the hash probe and returns the bucket total as an
    int64 scalar tensor on the bucket's device (the reference sums it in
    int32, R5)."""

    backend: str
    num_buckets: int

    def __call__(self, w_lists: torch.Tensor, src: torch.Tensor,
                 row_end: torch.Tensor, chain_ptr: torch.Tensor,
                 chain_vals: torch.Tensor) -> torch.Tensor:
        counts = hash_probe_compact_counts(
            w_lists, src, row_end,
            CompactHashTable(chain_ptr, chain_vals, self.num_buckets),
            backend=self.backend)
        return counts.sum(dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class VertexLaunch:
    """Per-vertex triangle counts for one filtered bucket.

    ``intersect_matches`` marks which u-list entries occur in both forward
    lists; each match (e, j) is one triangle (src[e], dst[e], u[e, j]),
    credited to its three vertices by index adds. The mask strategy is the
    width rule (``resolve_mask_strategy(width, None)``), as the reference's
    traced vertex stage resolves it. Padding never matches, so the clamp on
    the scatter ids is safe.
    """

    n: int
    width: int

    def __call__(self, u_lists, v_lists, src, dst) -> torch.Tensor:
        strategy, bits = resolve_mask_strategy(self.width, None)
        t = torch.zeros(self.n, dtype=torch.int64, device=u_lists.device)
        step = max(1, _VERTEX_CHUNK_ELEMS // max(self.width, 1))
        for s in range(0, int(u_lists.shape[0]), step):
            uc = u_lists[s:s + step]
            matched = intersect_matches(uc, v_lists[s:s + step],
                                        strategy=strategy, bitmap_bits=bits)
            per_edge = matched.sum(dim=1)
            t.index_add_(0, src[s:s + step].long(), per_edge)
            t.index_add_(0, dst[s:s + step].long(), per_edge)
            t += torch.bincount(uc[matched].long().clamp_(0, self.n - 1),
                                minlength=self.n)
        return t


@dataclasses.dataclass(frozen=True)
class EdgeLaunch:
    """Per-edge support contributions of one filtered bucket, in forward
    CSR slot order (each undirected edge owns one forward slot).

    Every match (e, j) of the u row is one triangle (src, dst, w =
    u[e, j]) whose three edges each gain one:

    * (src, dst): slot ``row_ptr[src] + (dst's position in the sorted u
      row)``, the per-row intersection size added once;
    * (src, w): w sits at u-row position j, so slot ``row_ptr[src] + j``,
      from the u-side match mask;
    * (dst, w): slot ``row_ptr[dst] + j`` for a match at v-row position j,
      from the v-side mask (``intersect_matches_both``).

    The reference groups the side masks by vertex into (n, W) arrays and
    adds whole rows; here each matched position goes straight into its
    slot with ``index_add_`` (integer adds, so the result is the same bit
    for bit, without the (n, W) arrays: 512 MiB a W = 512 bucket at n =
    2¹⁸). Rows go through in chunks of ``_VERTEX_CHUNK_ELEMS`` elements.
    Padding rows never match; slots past ``mk`` (which only zero values
    reach) go to a scratch slot, as the reference's ``mode="drop"`` drops
    them. Returns the (mk,) int64 contributions on the bucket's device.
    """

    strategy: str
    bitmap_bits: Optional[int]
    width: int
    mk: int

    def __call__(self, u_lists, v_lists, src, dst, row_ptr) -> torch.Tensor:
        dev = u_lists.device
        w, mk = self.width, self.mk
        supp = torch.zeros(mk + 1, dtype=torch.int64, device=dev)
        lanes = torch.arange(w, device=dev)

        def add(slots, values):
            supp.index_add_(0, torch.where(slots < mk, slots, mk),
                            values.to(torch.int64))

        step = max(1, _VERTEX_CHUNK_ELEMS // max(w, 1))
        for s in range(0, int(u_lists.shape[0]), step):
            uc, vc = u_lists[s:s + step], v_lists[s:s + step]
            dc = dst[s:s + step]
            mu, mv = intersect_matches_both(uc, vc, strategy=self.strategy,
                                            bitmap_bits=self.bitmap_bits)
            base_j = torch.searchsorted(uc, dc[:, None]).squeeze(1)
            src_base = row_ptr[src[s:s + step].long()].long()
            dst_base = row_ptr[dc.long()].long()
            add(src_base + base_j.clamp_(0, w - 1), mu.sum(dim=1))
            add((src_base[:, None] + lanes).reshape(-1), mu.reshape(-1))
            add((dst_base[:, None] + lanes).reshape(-1), mv.reshape(-1))
        return supp[:mk]


@dataclasses.dataclass(frozen=True)
class DynamicStepLaunch:
    """The dynamic lane's bound update step at one (capacity, update rows,
    n, width) class: ``graphs.device.dynamic_update_step``."""

    n: int
    width: int

    def __call__(self, keys, rkeys, upd_keys, upd_rkeys, upd_ins, upd_valid):
        return dynamic_update_step(keys, rkeys, upd_keys, upd_rkeys, upd_ins,
                                   upd_valid, n=self.n, width=self.width)


def _resolve_delta_classes(bounds: Sequence[int], n: int, strategy: str,
                           bitmap_bits: Optional[int]) -> tuple:
    """The match-mask strategy of each width class of a delta launch: the
    edge lane's cost model over id range n + 2, with the forced
    ``bitmap_bits`` override."""
    return tuple(_resolve_bucket_strategy(int(w), n + 2, strategy, bitmap_bits,
                                          resolve_mask_strategy)
                 for w in bounds)


@dataclasses.dataclass(frozen=True)
class DeltaLaunch:
    """Weighted triangle deltas of one padded batch of anchor edges.

    The anchor edges are re-bucketed by degree class
    (``prep.delta_update_buckets``); each class runs its match mask, and
    every matched triangle (lo, hi, w) is weighed by how many of its three
    edges are anchors (looked up in the sorted, sentinel-padded anchor keys
    ``skeys``): a triangle with k anchor edges is found once per anchor
    edge, so weights 6/k (the table [0, 6, 3, 2]) make the total exactly
    6 × the triangles that touch the anchor set. The caller checks the
    divisibility by 6 and divides. Keys are computed in int64 and cast to
    ``skeys``' dtype; padding rows go negative or meet sentinels and never
    match a key. Returns an int64 scalar on the device (the reference sums
    in int32).
    """

    n: int
    bounds: tuple
    resolved: tuple  # ((strategy, bitmap_bits), ...) per class

    def __call__(self, lo_rows, hi_rows, lo_deg, hi_deg, lo, hi, valid,
                 skeys) -> torch.Tensor:
        dev = lo.device
        kdt = skeys.dtype
        n1 = self.n + 1
        ub = int(skeys.shape[0])
        weight = torch.tensor([0, 6, 3, 2], dtype=torch.int64, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        classes = prep.delta_update_buckets(lo_rows, hi_rows, lo_deg, hi_deg,
                                            lo, hi, valid, n=self.n,
                                            bounds=self.bounds)
        for (_, u, v, sb, db), (strat, bits) in zip(classes, self.resolved):
            matched = intersect_matches(u, v, strategy=strat, bitmap_bits=bits)
            uk = u.long()
            k = torch.ones(u.shape, dtype=torch.int64, device=dev)
            for end in (sb, db):
                e = end.long()[:, None]
                key = (torch.minimum(e, uk) * n1 + torch.maximum(e, uk)).to(kdt)
                i = torch.searchsorted(skeys, key).clamp_(0, ub - 1)
                k += skeys[i] == key
            total += torch.where(matched, weight[k], 0).sum()
        return total


def get_executable(algorithm: str, backend: str, shape_key: tuple, *,
                   strategy: Optional[str] = None,
                   bitmap_bits: Optional[int] = None, mesh=None) -> Callable:
    """Fetch (or build) the cached launch configuration for one work unit.

    Args:
      algorithm: "intersection" (a bucket's count; the subgraph and bfs
        lanes' buckets use it too), "intersection_csr" (a resident probe
        bucket's count read from the forward CSR; ``shape_key`` ``(E, W)``),
        "matrix" (the tile triples' unique
        tiles and indices, ``shape_key`` ``(T, B, B)``), "hash" (a
        bucket's hash probe, ``shape_key`` ``(E, W, B, D)``: the shape
        class of the reference's dense table rides in the key), "vertex"
        (a filtered bucket's per-vertex counts; ``shape_key`` is
        ``(E, W, n)``), "edge" (a filtered bucket's slot-ordered edge
        support; ``(E, W, mk, n + 1, max_peel_iters, peel_early_exit)``:
        the peel knobs ride in the key, as in the reference), or the
        dynamic lane's "dynamic_step" (``(capacity, update rows, n + 1,
        width)``) and "delta" (``(update rows, n + 1, *bounds)``), each
        with a trailing ``"wide"`` in the wide key mode; or a sharded
        stage, "intersection_distributed" (``(rows_per_shard, W,
        chunk)``), "matrix_distributed" (``(tiles_per_shard, B, B)``) or
        "edge_distributed" (``(rows_per_shard, W, mk, n + 1, *peel
        knobs)``), which bind the same launches as their single-card
        stages and need ``mesh``.
      backend: "kernel" | "ref".
      shape_key: the work unit's array shape.
      strategy: the resolved set-intersection strategy ("intersection"),
        the resolved mask strategy ("edge"), or the dynamic session's
        strategy, resolved per class ("delta").
      bitmap_bits: the bitmap capacity when strategy="bitmap".
      mesh: the ``DeviceMesh`` of a sharded stage; its
        ``mesh_cache_component`` is appended to the key.

    Returns:
      The entry cached under ``(algorithm, strategy, backend, bitmap_bits,
      shape_key)`` (and the mesh component); plans over same-shaped
      buckets share it.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if algorithm.endswith("_distributed") and mesh is None:
        raise ValueError(f"algorithm {algorithm!r} needs a mesh; pass mesh=")
    if algorithm in ("intersection", "edge", "intersection_distributed",
                     "edge_distributed", "intersection_csr") \
            and strategy not in STRATEGIES:
        raise ValueError(f"unresolved strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    # the wide key mode's trailing marker keeps the two key dtypes apart
    dims = tuple(shape_key[:-1]) if shape_key and shape_key[-1] == "wide" \
        else tuple(shape_key)
    if algorithm in ("intersection", "intersection_distributed"):
        builder = functools.partial(IntersectLaunch, strategy, backend, bitmap_bits)
    elif algorithm == "intersection_csr":
        if strategy != "probe":
            raise ValueError(f"the CSR route is the probe strategy's, not "
                             f"{strategy!r}'s")
        builder = functools.partial(CsrProbeLaunch, backend, int(shape_key[1]))
    elif algorithm in ("matrix", "matrix_distributed"):
        builder = functools.partial(MatrixLaunch, backend)
    elif algorithm == "hash":
        builder = functools.partial(HashLaunch, backend, int(shape_key[2]))
    elif algorithm == "vertex":
        builder = functools.partial(VertexLaunch, int(shape_key[2]), int(shape_key[1]))
    elif algorithm in ("edge", "edge_distributed"):
        builder = functools.partial(EdgeLaunch, strategy, bitmap_bits,
                                    int(shape_key[1]), int(shape_key[2]))
    elif algorithm == "dynamic_step":
        builder = functools.partial(DynamicStepLaunch, int(dims[2]) - 1,
                                    int(dims[3]))
    elif algorithm == "delta":
        n = int(dims[1]) - 1
        bounds = tuple(int(w) for w in dims[2:])
        builder = lambda: DeltaLaunch(  # noqa: E731
            n, bounds, _resolve_delta_classes(bounds, n, strategy, bitmap_bits))
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    key = (algorithm, strategy, backend, bitmap_bits, tuple(shape_key))
    if mesh is not None:
        key = key + (mesh_cache_component(mesh),)
    return _EXECUTABLE_CACHE.get_or_build(key, builder)


@dataclasses.dataclass(frozen=True)
class BatchLaunch:
    """A stacked batch layout's bound launch configuration. Calling it on
    the flattened (u, v) stacks, each (B, E, W) and contiguous, runs ONE
    intersection launch per width over the stack viewed as (B·E, W), sums
    each graph's rows in int64 (``.view(B, E).sum(1)``; the reference sums
    in int32, which wraps like R5) and returns the (B,) int64 totals on the
    stacks' device."""

    specs: tuple  # ((strategy, bitmap_bits, (e_pad, width)), ...) per width
    backend: str

    def __call__(self, *arrays: torch.Tensor) -> torch.Tensor:
        total = torch.zeros(arrays[0].shape[0], dtype=torch.int64,
                            device=arrays[0].device)
        for i, (strat, bits, (e, w)) in enumerate(self.specs):
            u, v = arrays[2 * i], arrays[2 * i + 1]
            b = int(u.shape[0])
            counts = intersect_counts(u.view(b * e, w), v.view(b * e, w),
                                      strategy=strat, backend=self.backend,
                                      bitmap_bits=bits)
            total += counts.view(b, e).sum(1, dtype=torch.int64)
        return total


def get_batch_executable(specs: tuple, backend: str, batch: int) -> Callable:
    """Fetch (or build) the bound launch of one stacked batch layout.

    Cached in the process-wide cache under ``("intersection_batch", None,
    backend, None, (batch,) + specs)``, as the reference keys it: two
    batches whose policy-rounded layouts collide share one entry.
    """
    key = ("intersection_batch", None, backend, None,
           (int(batch),) + tuple(specs))
    return _EXECUTABLE_CACHE.get_or_build(
        key, functools.partial(BatchLaunch, tuple(specs), backend))


def executable_cache_info() -> dict:
    """``{'size', 'hits', 'misses', 'maxsize', 'evictions'}``."""
    return _EXECUTABLE_CACHE.info()


def cache_info() -> dict:
    """``executable_cache_info()`` plus the live ``keys`` tuple (MRU last)."""
    return _EXECUTABLE_CACHE.info(include_keys=True)


def clear_caches() -> None:
    """Drop every cached entry and zero the hit/miss/eviction counters."""
    _EXECUTABLE_CACHE.clear()


clear_executable_cache = clear_caches  # the reference's name


def prepare_intersection_buckets(g: Graph, variant: str = "filtered",
                                 widths: Sequence[int] = DEFAULT_WIDTHS
                                 ) -> list:
    """The numpy intersection prep (the parity path): see
    ``prep.prepare_intersection_buckets_host``. Plans prep on the device
    unless ``prep_backend="host"``."""
    return prep.prepare_intersection_buckets_host(g, variant=variant,
                                                  widths=widths)


def set_cache_limit(maxsize: int) -> int:
    """Re-bound the process-wide cache; returns the old bound. Shrinking
    evicts LRU entries at once; live plans keep their entries."""
    return _EXECUTABLE_CACHE.set_maxsize(maxsize)


# ---------------------------------------------------------------------------
# TrianglePlan — the device-resident, replayable count
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Stage:
    executable: Callable
    args: Tuple[torch.Tensor, ...]  # resident (u, v), (l, u, a) or (v, src, table)
    shape_key: tuple
    # the profiler span run() records under, named when the stage is bound
    span_name: str
    strategy: Optional[str] = None
    bitmap_bits: Optional[int] = None
    # (src, dst) per row — filtered stages only, for the per-vertex path
    vertex_args: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    # the bucket's padded (u, v) rows where ``args`` hold the forward CSR
    # instead (a resident probe bucket); the per-vertex path reads them
    rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def run(self) -> torch.Tensor:
        """One stage: the kernel launch plus its int64 reduction."""
        with span(self.span_name):
            return self.executable(*self.args)


def _matrix_chunk_args(views: Tuple[torch.Tensor, ...]) -> tuple:
    """A matrix chunk's (l, u, l_index, u_index, a_index, order) as
    ``MatrixLaunch`` takes them: the U tiles serve as the A tiles too."""
    l, u, li, ui, ai, order = views
    return l, u, u, li, ui, ai, order


@dataclasses.dataclass
class _TiledStage:
    """A work unit over the ``max_device_bytes`` budget, streamed through
    one cached chunk-shaped launch instead of held resident.

    ``chunks`` are the unit's host arrays, chunk by chunk (pinned on a CUDA
    device): row views of a bucket's padded (u, v), or the matrix lane's
    per-chunk tiles and re-based indices. ``run()`` copies chunk i + 1 into
    one of two device slots on a side stream while the kernel reads chunk i
    from the other. Events order each copy after the launch that last read
    its slot, and each launch after its copy. A chunk shorter than its slot
    is padded with ``fills`` (the inert rows -1 / -2) or, where the fill is
    None, passed as the slot's leading part. The partials accumulate in an
    int64 device scalar: ``TrianglePlan.count()`` syncs once. On a CPU
    device the chunks are the kernels' inputs as they are.
    """

    executable: Callable
    chunks: List[Tuple[torch.Tensor, ...]]
    fills: Tuple[Optional[int], ...]
    chunk_rows: int
    shape_key: tuple        # the whole unit's shape (meta parity with _Stage)
    chunk_shape_key: tuple  # the launch's shape class
    device: torch.device
    span_name: str
    strategy: Optional[str] = None
    bitmap_bits: Optional[int] = None
    # host (src, dst) row views per chunk: filtered stages only
    vertex_chunks: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
    launch_args: Callable = tuple  # device views -> the executable's args
    args: Tuple = ()  # nothing resident
    _slots: Optional[list] = dataclasses.field(default=None, repr=False)
    _side: Any = dataclasses.field(default=None, repr=False)

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def streamed_bytes(self) -> int:
        """Host-to-device bytes one ``run()`` copies."""
        return sum(x.numel() * x.element_size()
                   for chunk in self.chunks for x in chunk)

    def run(self) -> torch.Tensor:
        """Stream every chunk through the cached launch; the int64 total
        stays on the device."""
        with span(self.span_name):
            total = torch.zeros((), dtype=torch.int64, device=self.device)

            def consume(views):
                total.add_(self.executable(*self.launch_args(views)))

            if self._slots is None and self.device.type == "cuda":
                self._slots = self._allocate(self.chunks, self.fills)
            self._stream(self.chunks, self.fills, consume, self._slots)
            return total

    def run_vertex(self, fn: Callable, total: torch.Tensor) -> None:
        """Stream (u, v, src, dst) chunks through the per-vertex launch
        ``fn``, adding into ``total`` (the slots live for this call only)."""
        chunks = [c + v for c, v in zip(self.chunks, self.vertex_chunks)]
        fills = self.fills + (0, 0)
        slots = self._allocate(chunks, fills) \
            if self.device.type == "cuda" else None
        self._stream(chunks, fills,
                     lambda views: total.add_(fn(*views)), slots)

    def _slot_rows(self, chunks, j: int, fill) -> int:
        if fill is not None:
            return self.chunk_rows
        return max(int(c[j].shape[0]) for c in chunks)

    def _allocate(self, chunks, fills) -> list:
        """Two device slots, each one buffer per host array; the side
        stream writes them, so the allocator is told it uses them."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        first = chunks[0]
        slots = []
        for _ in range(2):
            bufs = []
            for j, (x, f) in enumerate(zip(first, fills)):
                buf = torch.empty((self._slot_rows(chunks, j, f),)
                                  + tuple(x.shape[1:]), dtype=x.dtype,
                                  device=self.device)
                buf.record_stream(self._side)
                bufs.append(buf)
            slots.append(tuple(bufs))
        return slots

    def _stream(self, chunks, fills, consume, slots) -> None:
        if self.device.type != "cuda":
            for chunk in chunks:
                consume(tuple(_pad_rows(x, self.chunk_rows, f)
                              for x, f in zip(chunk, fills)))
            return
        main = torch.cuda.current_stream(self.device)
        side = self._side
        ready = [torch.cuda.Event(), torch.cuda.Event()]
        freed: List[Optional[torch.cuda.Event]] = [None, None]

        def copy(i: int) -> tuple:
            k = i % 2
            views = []
            with torch.cuda.stream(side):
                if freed[k] is not None:  # the launch that read slot k
                    side.wait_event(freed[k])
                for buf, x, f in zip(slots[k], chunks[i], fills):
                    r = int(x.shape[0])
                    buf[:r].copy_(x, non_blocking=True)
                    if f is None:
                        views.append(buf[:r])
                        continue
                    if r < buf.shape[0]:
                        buf[r:].fill_(f)
                    views.append(buf)
                ready[k].record(side)
            return tuple(views)

        upcoming = copy(0)
        for i in range(len(chunks)):
            views = upcoming
            if i + 1 < len(chunks):
                upcoming = copy(i + 1)  # overlaps launch i below
            main.wait_event(ready[i % 2])
            consume(views)
            ev = torch.cuda.Event()
            ev.record(main)
            freed[i % 2] = ev


def _pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``x`` padded to ``rows`` rows with ``fill`` (None: as it is)."""
    if fill is None or x.shape[0] >= rows:
        return x
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


# the serving coalescer pads a member's rows into its stack (u = -1, v = -2,
# zero matches) as GraphBatch.from_graphs does
_pad_bucket_rows = _pad_rows


@dataclasses.dataclass
class TrianglePlan:
    """A prepared triangle count: device buffers + bound launches.

    ``count()`` replays the device stage only; a ``_TiledStage`` streams
    its chunks from host memory through the same kind of launch. Build via
    ``plan_triangle_count``.
    """

    algorithm: str
    backend: str
    device: torch.device
    stages: List[_Stage]
    divisor: int  # 6 for the full intersection variant (each triangle ×6)
    meta: Dict[str, Any]
    prep_seconds: float
    executions: int = 0
    group: Any = None  # the mesh's process group (sharded lanes)

    def count(self) -> int:
        """Exact triangle count: every stage's kernel, summed on the
        device in int64, with one host sync. On a sharded lane every rank
        sums its own stages (none on a shard without rows) and joins ONE
        all-reduce over the mesh's ranks before the sync.

        Raises:
          RuntimeError: the full variant's total is not a multiple of 6
            (a broken kernel or layout).
        """
        with span("tc.plan.count"):
            total = torch.zeros((), dtype=torch.int64, device=self.device)
            for st in self.stages:
                total += st.run()
            if self.group is not None:
                with span("tc.allreduce"):
                    dist.all_reduce(total, group=self.group)
            with span("tc.sync"):
                total = int(total)
        if total % self.divisor:
            raise RuntimeError(
                f"total {total} is not a multiple of divisor {self.divisor}")
        self.executions += 1
        return total // self.divisor

    def count_with_stats(self) -> Tuple[int, dict]:
        """Count once and return ``(count, meta)``; meta carries the plan's
        statistics — prune fractions, tile schedule sizes, bucket shapes
        and, on the intersection/subgraph/bfs lanes, ``bucket_strategies`` (one
        ``(width, strategy)`` pair per bucket). The subgraph lane adds
        ``num_embeddings`` = 6 × count (the join's ordered embeddings)."""
        c = self.count()
        stats = dict(self.meta)
        if self.algorithm == "subgraph":
            stats["num_embeddings"] = 6 * c
        return c, stats

    def triangles_per_vertex(self) -> np.ndarray:
        """Per-vertex triangle counts, replayed through the plan's resident
        buckets.

        The subgraph lane's stages count on the induced graph: the device
        prep keeps the original ids; the host prep renumbers, and the counts
        scatter back through ``meta["vertex_map"]`` (peeled vertices are in
        no triangle). The bfs lane's level-oriented stages carry the same
        (src, dst) layout as the filtered intersection lane's.

        Returns:
          (n,) int64 numpy array, t[v] = number of triangles containing v.

        Raises:
          NotImplementedError: the matrix and hash lanes or the full
            intersection variant, whose stages carry no forward endpoints
            to credit matches to (``TriangleCounter`` then answers from a
            filtered sidecar plan).
        """
        if self.algorithm not in ("intersection", "subgraph", "bfs") \
                or self.divisor != 1 \
                or any((st.vertex_chunks if isinstance(st, _TiledStage)
                        else st.vertex_args) is None for st in self.stages):
            raise NotImplementedError(
                f"per-vertex counts need filtered-intersection stages; "
                f"algorithm={self.algorithm!r} divisor={self.divisor} does "
                f"not carry them"
            )
        n_local = int(self.meta.get("vertex_n", self.meta["n"]))
        total = torch.zeros(n_local, dtype=torch.int64, device=self.device)
        for st in self.stages:
            if isinstance(st, _TiledStage):  # the same chunks, with (src, dst)
                e, w = st.chunk_shape_key
                fn = get_executable("vertex", self.backend, (e, w, n_local))
                st.run_vertex(fn, total)
                continue
            e, w = st.shape_key
            fn = get_executable("vertex", self.backend, (e, w, n_local))
            total += fn(*(st.rows or st.args), *st.vertex_args)
        total = total.cpu().numpy()
        vertex_map = self.meta.get("vertex_map")
        if vertex_map is not None:  # host-prep subgraph: pruned ids -> original
            out = np.zeros(int(self.meta["n"]), dtype=np.int64)
            out[vertex_map] = total
            return out
        return total

    def synchronize(self) -> "TrianglePlan":
        """Wait for the device (useful before timing counts)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def shape_keys(self) -> List[tuple]:
        return [st.shape_key for st in self.stages]


def _resolve_bucket_strategy(width: int, id_range: int, strategy: str,
                             bitmap_bits: Optional[int],
                             resolver: Callable = resolve_strategy):
    """Resolve one bucket's (strategy, bitmap_bits) with ``resolver`` (the
    counting cost model, or ``resolve_mask_strategy`` for the mask lanes),
    honouring a forced ``bitmap_bits`` override (which must cover the id
    range)."""
    strat, bits = resolver(width, id_range, strategy=strategy)
    if bitmap_bits is not None and strat == "bitmap":
        if bitmap_bits < id_range:
            raise ValueError(
                f"bitmap_bits={bitmap_bits} cannot represent id range "
                f"{id_range} (n + 2 sentinel ids); ids past the capacity "
                f"would silently never match"
            )
        bits = int(bitmap_bits)
    return strat, bits


def _buckets_for_plan(g: Graph, variant: str, widths: Sequence[int],
                      prep_backend: str, policy: Optional[ShapePolicy],
                      device: torch.device,
                      max_device_bytes: Optional[int] = None
                      ) -> List[DeviceBucket]:
    """Run the prep stage on the requested backend; either way the result
    is ``DeviceBucket``s on ``device`` (the host path uploads its arrays),
    except the buckets over ``max_device_bytes``, which stay in host memory
    (pinned on a CUDA device) for their tiled stages."""
    if prep_backend == "device":
        return prep.prepare_intersection_buckets_device(
            g, variant=variant, widths=widths, policy=policy, device=device,
            max_device_bytes=max_device_bytes,
        )
    host = prep.prepare_intersection_buckets_host(g, variant=variant,
                                                  widths=widths)
    out = []
    for b in host:
        tiled = bucket_is_tiled(b["u_lists"].shape[0], b["width"],
                                max_device_bytes)

        def place(a, tiled=tiled):
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
            if not tiled:
                return t.to(device)
            return t.pin_memory() if device.type == "cuda" else t

        out.append(DeviceBucket(
            width=b["width"], edges=int(b["u_lists"].shape[0]),
            u_lists=place(b["u_lists"]), v_lists=place(b["v_lists"]),
            src=place(b["src"]), dst=place(b["dst"])))
    return out


def _plan_intersection(g: Graph, variant: str, backend: str,
                       widths: Sequence[int], strategy: str,
                       bitmap_bits: Optional[int], prep_backend: str,
                       shape_policy: Optional[ShapePolicy],
                       device: torch.device,
                       max_device_bytes: Optional[int] = None,
                       ) -> Tuple[List[_Stage], int, dict]:
    """The intersection lane's stages over ``g`` (a host ``Graph``, or a
    ``DeviceGraph`` with ``prep_backend="device"``). A device-prepped
    filtered plan hands its forward CSR to the stages, so that a resident
    probe bucket reads its rows from there (``CsrProbeLaunch``)."""
    policy = shape_policy if shape_policy is not None else DEFAULT_SHAPE_POLICY
    csr = None
    if prep_backend == "device" and variant == "filtered":
        dg = g if isinstance(g, DeviceGraph) \
            else DeviceGraph.from_graph(g, policy, device=device)
        buckets = _buckets_for_plan(dg, variant, widths, prep_backend,
                                    shape_policy, device, max_device_bytes)
        if buckets:  # the stages keep the CSR's two tensors, not the graph
            fwd = dg.forward()
            csr = (fwd.row_ptr, fwd.dst)
        del dg
    else:
        buckets = _buckets_for_plan(g, variant, widths, prep_backend,
                                    shape_policy, device, max_device_bytes)
    stages, bucket_meta = _bucket_stages(buckets, g.n, backend, strategy,
                                         bitmap_bits,
                                         per_vertex=(variant == "filtered"),
                                         max_device_bytes=max_device_bytes,
                                         device=device, csr=csr)
    tiled = [st for st in stages if isinstance(st, _TiledStage)]
    meta = dict(
        variant=variant,
        widths=tuple(widths),
        strategy=strategy,
        prep_backend=prep_backend,
        shape_policy=policy.key() if prep_backend == "device" else None,
        **bucket_meta,
        **_tiled_meta(tiled, max_device_bytes),
    )
    return stages, (6 if variant == "full" else 1), meta


def _tiled_meta(tiled: List[_TiledStage],
                max_device_bytes: Optional[int]) -> dict:
    """The reference's budget keys (``max_device_bytes``, ``tiled_buckets``,
    ``num_chunks``) plus the host-to-device bytes one count streams."""
    return dict(
        max_device_bytes=max_device_bytes,
        tiled_buckets=[dict(shape=st.shape_key, chunk_rows=st.chunk_rows,
                            num_chunks=st.num_chunks) for st in tiled],
        num_chunks=int(sum(st.num_chunks for st in tiled)),
        streamed_bytes=int(sum(st.streamed_bytes for st in tiled)),
    )


def _bucket_stages(buckets: List[DeviceBucket], n: int, backend: str,
                   strategy: str, bitmap_bits: Optional[int], *,
                   per_vertex: bool, max_device_bytes: Optional[int] = None,
                   device: Optional[torch.device] = None,
                   csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   ) -> Tuple[list, dict]:
    """Bind each bucket to its cached intersection launch, with the
    strategy resolved per bucket; ``per_vertex`` keeps the forward
    endpoints for the per-vertex stage. A bucket over ``max_device_bytes``
    (held on the host by the prep) becomes a ``_TiledStage`` whose launch
    is cached at the chunk shape ``(chunk_rows, W)``. Given the forward
    CSR ``(row_ptr, col)`` the buckets were gathered from, a resident
    probe bucket reads its real rows from it instead of its padded copies
    (``CsrProbeLaunch`` on the bucket's first ``edges`` endpoints; the
    padded rows stay for the per-vertex path). Returns the stages and
    their bucket meta (shapes, strategies, edges)."""
    # real ids [0, n) plus the in-row sentinels n (u) and n + 1 (v); whole
    # padding rows (-1/-2) are negative and never match in any core
    id_range = n + 2
    stages = []
    with span("tc.prep.bind"):
        for b in buckets:
            strat, bits = _resolve_bucket_strategy(b.width, id_range,
                                                   strategy, bitmap_bits)
            if bucket_is_tiled(b.e_pad, b.width, max_device_bytes):
                chunk = _tile_chunk_rows(b.e_pad, _bucket_nbytes(1, b.width),
                                         max_device_bytes)
                cuts = range(0, b.e_pad, chunk)
                stages.append(_TiledStage(
                    executable=get_executable("intersection", backend,
                                              (chunk, b.width),
                                              strategy=strat,
                                              bitmap_bits=bits),
                    chunks=[(b.u_lists[s:s + chunk], b.v_lists[s:s + chunk])
                            for s in cuts],
                    fills=(-1, -2),  # whole-row padding: zero matches
                    chunk_rows=chunk,
                    shape_key=b.shape,
                    chunk_shape_key=(chunk, b.width),
                    device=device,
                    strategy=strat,
                    bitmap_bits=bits,
                    vertex_chunks=[(b.src[s:s + chunk], b.dst[s:s + chunk])
                                   for s in cuts] if per_vertex else None,
                    span_name=f"tc.stage {strat} w{b.width} tiled",
                ))
                continue
            if csr is not None and strat == "probe":
                stages.append(_Stage(
                    executable=get_executable("intersection_csr", backend,
                                              b.shape, strategy=strat),
                    args=csr + (b.src[:b.edges], b.dst[:b.edges]),
                    shape_key=b.shape,
                    strategy=strat,
                    vertex_args=(b.src, b.dst) if per_vertex else None,
                    rows=(b.u_lists, b.v_lists),
                    span_name=f"tc.stage {strat} w{b.width}",
                ))
                continue
            stages.append(_Stage(
                executable=get_executable("intersection", backend, b.shape,
                                          strategy=strat, bitmap_bits=bits),
                args=(b.u_lists, b.v_lists),
                shape_key=b.shape,
                strategy=strat,
                bitmap_bits=bits,
                vertex_args=(b.src, b.dst) if per_vertex else None,
                span_name=f"tc.stage {strat} w{b.width}",
            ))
    return stages, dict(
        bucket_shapes=[s.shape_key for s in stages],
        bucket_strategies=[(s.shape_key[1], s.strategy) for s in stages],
        bucket_edges=[b.edges for b in buckets],
        edges=int(sum(b.edges for b in buckets)),
    )


def _plan_matrix(g: Graph, block, permute: bool, backend: str,
                 device: torch.device,
                 max_device_bytes: Optional[int] = None,
                 ) -> Tuple[List[_Stage], int, dict]:
    """The matrix lane: the host tile schedule, then one stage holding the
    gathered form on the device: the unique tiles (bf16 at a B of K4's
    tensor-core route, else float32), the (T,) int32 triple indices and the
    launch order (``launch_order``, made once here). Its shape key is
    (T, B, B). T = 0 gives no stage, so the count is 0.

    Under ``max_device_bytes`` the reference's rule decides: the three
    (T, B, B) float32 stacks it would hold (3·B²·4 bytes a triple) over the
    budget make a ``_TiledStage`` of ``_tile_chunk_rows(T, 3·B²·4, budget)``
    consecutive triples a chunk, each with its own distinct tiles and
    re-based indices on the host (``TileSchedule.host_chunks``), streamed
    through the launch cached at (chunk, B, B). A chunk names at most
    3 × chunk tiles, so it stays within the budget."""
    if block == "auto":
        block = prep.choose_block(g)
    t0 = time.perf_counter()
    sched = prep.tile_schedule(g, block=block, permute=permute)
    t1 = time.perf_counter()
    stages = []
    tile_bytes = 0
    t = sched.num_triples
    stack_row_bytes = 3 * block * block * 4
    if t and max_device_bytes is not None \
            and t * stack_row_bytes > max_device_bytes:
        chunk = _tile_chunk_rows(t, stack_row_bytes, max_device_bytes)
        chunk_key = (chunk, block, block)
        stages.append(_TiledStage(
            executable=get_executable("matrix", backend, chunk_key),
            chunks=sched.host_chunks(chunk, device),
            fills=(None,) * 6,  # a short last chunk launches fewer triples
            chunk_rows=chunk,
            shape_key=(t, block, block),
            chunk_shape_key=chunk_key,
            device=device,
            launch_args=_matrix_chunk_args,
            span_name=f"tc.stage matrix b{block} tiled",
        ))
    elif t:
        l_blocks, u_blocks, l_index, u_index, a_index = sched.to_device(device)
        order = launch_order(l_index, a_index)
        args = (l_blocks, u_blocks, u_blocks, l_index, u_index, a_index, order)
        tile_bytes = sum(x.numel() * x.element_size() for x in
                         (l_blocks, u_blocks, l_index, u_index, a_index, order))
        shape_key = (sched.num_triples, block, block)
        stages.append(_Stage(
            executable=get_executable("matrix", backend, shape_key),
            args=args, shape_key=shape_key,
            span_name=f"tc.stage matrix b{block}"))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    tiled = [st for st in stages if isinstance(st, _TiledStage)]
    meta = dict(permute=permute, schedule_seconds=t1 - t0,
                upload_seconds=time.perf_counter() - t1, tile_bytes=tile_bytes,
                **_tiled_meta(tiled, max_device_bytes), **sched.stats)
    return stages, 1, meta


def _plan_subgraph(g: Graph, backend: str, widths: Sequence[int],
                   strategy: str, bitmap_bits: Optional[int],
                   prep_backend: str, shape_policy: Optional[ShapePolicy],
                   device: torch.device,
                   max_device_bytes: Optional[int] = None,
                   ) -> Tuple[List[_Stage], int, dict]:
    """The subgraph lane: FILTER (2-core peel to its fixed point),
    RECONSTRUCT (the induced graph) and the forward-filtered intersection
    JOIN on the survivors, which counts each triangle once. The budget
    passes through to the join's buckets."""
    if prep_backend == "device":
        # the induced graph keeps the original ids (dead vertices just lose
        # their rows), so stage counts scatter straight into id space
        policy = shape_policy if shape_policy is not None \
            else DEFAULT_SHAPE_POLICY
        dg = DeviceGraph.from_graph(g, policy, device=device)
        alive, rounds = prep.peel_to_two_core_device(dg)
        sub_dg = prep.induced_device_graph(dg, alive)
        alive_count = int(alive.sum())
        stages, _, inner = _plan_intersection(
            sub_dg, "filtered", backend, widths, strategy, bitmap_bits,
            "device", policy, device, max_device_bytes)
        meta = dict(
            vertices_pruned=int(g.n - alive_count),
            prune_fraction=float(1.0 - alive_count / max(g.n, 1)),
            edges_after=sub_dg.m_undirected,
            edges_before=g.m_undirected,
            vertex_n=g.n,
            peel_rounds=rounds,
            **inner,
        )
        return stages, 1, meta

    alive = prep.peel_to_two_core(g)
    sub, old_ids = induced_subgraph(g, alive)
    stages, _, inner = _plan_intersection(
        sub, "filtered", backend, widths, strategy, bitmap_bits, "host",
        None, device, max_device_bytes)
    meta = dict(
        vertices_pruned=int(g.n - alive.sum()),
        prune_fraction=float(1.0 - alive.sum() / max(g.n, 1)),
        edges_after=sub.m_undirected,
        edges_before=g.m_undirected,
        # stage counts are on the renumbered graph's ids; per-vertex counts
        # scatter back through old_ids
        vertex_n=sub.n,
        vertex_map=np.asarray(old_ids),
        **inner,
    )
    return stages, 1, meta


def _plan_hash(g: Graph, backend: str, widths: Sequence[int],
               prep_backend: str, shape_policy: Optional[ShapePolicy],
               device: torch.device) -> Tuple[List[_Stage], int, dict]:
    """The TRUST-style vertex-centric hash lane (arXiv:2103.08053).

    Prep reuses the filtered degree-class buckets (the candidate rows are
    the intersection lane's ``v_lists`` = N⁺(dst)), plus one plan-wide
    structure: the per-vertex hash table over the oriented rows, held
    compactly (``repro_torch.kernels.hash_tc.CompactHashTable``: each
    (vertex, bucket) chain at its real length, in the reference's dense
    (n, B, D) slot order). Each stage probes its bucket's candidates, up to
    each row's end, against the anchor's chains, so every forward edge
    (u, v) adds |N⁺(v) ∩ N⁺(u)| and every triangle is counted once. The
    build's one scalar sync reads the table's size and its longest chain,
    which, rounded to a power of two, is the reference's depth D; B and D
    stay in the shape key.

    The stages bind ``(v_lists, src, row_end, chain_ptr, chain_vals)``:
    the buckets' u rows are dropped before the table is built, and each
    bucket's row ends are found once, here. The device prep's
    ``DeviceGraph`` serves the table's padded rows too (the reference
    builds a second one; the arrays are equal).
    """
    policy = shape_policy if shape_policy is not None else DEFAULT_SHAPE_POLICY
    dg = DeviceGraph.from_graph(g, policy, device=device) \
        if prep_backend == "device" else None
    buckets = _buckets_for_plan(dg if dg is not None else g, "filtered",
                                widths, prep_backend, shape_policy, device)
    rows = [(b.width, b.edges, b.v_lists, b.src) for b in buckets]
    del buckets  # frees the u rows, which no hash stage reads
    meta = dict(
        variant="filtered",
        widths=tuple(widths),
        prep_backend=prep_backend,
        shape_policy=policy.key() if prep_backend == "device" else None,
    )
    stages: List[_Stage] = []
    if rows:
        table_width = max(w for w, *_ in rows)
        num_buckets = hash_num_buckets(table_width)
        if dg is not None:
            nbrs = dg.padded_neighbors(table_width, oriented=True)
        else:
            nbrs = torch.from_numpy(csr_to_padded_neighbors(
                orient_forward(g), pad_to=table_width)).to(device)
        compact, longest = build_compact_hash_table(nbrs, num_buckets)
        depth = next_pow2(max(1, longest))
        del nbrs, dg
        for width, _, v_lists, src in rows:
            shape_key = (int(v_lists.shape[0]), width, num_buckets, depth)
            stages.append(_Stage(
                executable=get_executable("hash", backend, shape_key),
                args=(v_lists, src, probe_row_ends(v_lists, g.n),
                      compact.chain_ptr, compact.chain_vals),
                shape_key=shape_key,
                span_name=f"tc.stage hash w{width}",
            ))
        meta.update(hash_num_buckets=num_buckets, hash_depth=depth,
                    table_width=table_width, table_bytes=compact.nbytes)
    meta.update(
        bucket_shapes=[s.shape_key for s in stages],
        bucket_edges=[e for _, e, _, _ in rows],
        edges=int(sum(e for _, e, _, _ in rows)),
    )
    return stages, 1, meta


def _plan_bfs(g: Graph, backend: str, widths: Sequence[int], strategy: str,
              bitmap_bits: Optional[int], shape_policy: Optional[ShapePolicy],
              device: torch.device) -> Tuple[List[_Stage], int, dict]:
    """The BFS-based lane (Fast BFS-Based Triangle Counting,
    arXiv:1909.02127).

    BFS levels (``graphs.device._bfs_levels_dev``, one host sync a round)
    replace the degree rank: every edge is oriented toward its larger
    ``(level, id)`` endpoint, a total order, so each triangle closes once
    at its rank-minimum wedge. The count is the forward wedge closure
    |N_f(u) ∩ N_f(v)| over level-oriented degree-class buckets (the edges
    in CSR order, as the reference's ``bucket_edges_by_degree`` takes
    them), so the stages bind the shared intersection launches; only the
    oriented rows differ. The orientation, the buckets and their padded
    rows are built on the device: hub out-degrees are not bounded by this
    order, and the wide buckets' host gather is what the device saves.
    """
    policy = shape_policy if shape_policy is not None else DEFAULT_SHAPE_POLICY
    meta = dict(
        variant="bfs-forward",
        widths=tuple(widths),
        strategy=strategy,
        shape_policy=policy.key(),
    )
    if g.n == 0 or g.m_undirected == 0:
        meta.update(bucket_shapes=[], bucket_strategies=[], bucket_edges=[],
                    edges=0, levels_max=0, bfs_sources=int(g.n), bfs_rounds=0)
        return [], 1, meta
    dg = DeviceGraph.from_graph(g, policy, device=device)
    buckets, lvl, rounds = prep.prepare_bfs_buckets_device(dg, widths=widths)
    stages, bucket_meta = _bucket_stages(buckets, g.n, backend, strategy,
                                         bitmap_bits, per_vertex=True)
    meta.update(
        **bucket_meta,
        levels_max=int(lvl.max()),
        bfs_sources=int((lvl == 0).sum()),
        bfs_rounds=rounds,
    )
    return stages, 1, meta


def _mesh_meta(mesh) -> dict:
    return dict(mesh_axes=mesh_axes(mesh),
                mesh_shape=tuple(int(s) for s in mesh.mesh.shape),
                num_shards=int(mesh.size()))


def _shard_stages(sharded: ShardedDeviceCSR, backend: str, strategy: str,
                  bitmap_bits: Optional[int], mesh) -> Tuple[list, list]:
    """Bind each dealt bucket to its cached sharded launch, keyed by the
    per-shard shape ``(rows_per_shard, W, chunk)`` and the mesh. A stage
    reads its shard's first ``valid`` rows only, so the dealt padding is
    never launched; a shard without rows in a bucket gets no stage (it
    still joins the count's all-reduce). Returns the stages and every
    bucket's ``(shape_key, strategy)``."""
    id_range = sharded.n + 2  # real ids and the in-row sentinels n, n + 1
    stages, specs = [], []
    for b in sharded.buckets:
        strat, bits = _resolve_bucket_strategy(b.width, id_range, strategy,
                                               bitmap_bits)
        shape_key = b.shape + (b.chunk,)
        specs.append((shape_key, strat))
        fn = get_executable("intersection_distributed", backend, shape_key,
                            strategy=strat, bitmap_bits=bits, mesh=mesh)
        if b.valid:
            stages.append(_Stage(
                executable=fn,
                args=(b.u_lists[:b.valid], b.v_lists[:b.valid]),
                shape_key=shape_key, strategy=strat, bitmap_bits=bits,
                span_name=f"tc.stage {strat} w{b.width}"))
    return stages, specs


def _plan_intersection_distributed(
        g: Graph, mesh, variant: str, backend: str, widths: Sequence[int],
        strategy: str, bitmap_bits: Optional[int], prep_backend: str,
        shape_policy: Optional[ShapePolicy], device: torch.device,
) -> Tuple[List[_Stage], int, dict]:
    """The intersection lane over a ``ShardedDeviceCSR``: every rank preps
    the whole graph, deals each degree bucket round-robin over the mesh
    and keeps its shard's rows; its stages launch K1/K2/K3 on them, and
    ``TrianglePlan.count()`` all-reduces the shards' int64 partials once.
    The bucket strategies resolve as on the single-card lane."""
    policy = shape_policy if shape_policy is not None else DEFAULT_SHAPE_POLICY
    sharded = ShardedDeviceCSR.from_graph(
        g, mesh, device=device, variant=variant, widths=widths,
        policy=policy, prep_backend=prep_backend)
    stages, specs = _shard_stages(sharded, backend, strategy, bitmap_bits,
                                  mesh)
    meta = dict(
        variant=variant,
        widths=tuple(widths),
        strategy=strategy,
        prep_backend=prep_backend,
        shape_policy=policy.key(),
        core_backend=backend,
        bucket_shapes=[k for k, _ in specs],
        bucket_strategies=[(k[1], st) for k, st in specs],
        bucket_edges=[b.edges for b in sharded.buckets],
        edges=sharded.edges,
        **_mesh_meta(mesh),
        rows_per_shard=[b.rows_per_shard for b in sharded.buckets],
        shard_valid=[b.shard_rows for b in sharded.buckets],
        shard_work=sharded.shard_work(),
        shard=sharded.shard,
        shard_bytes=sharded.nbytes,
    )
    return stages, (6 if variant == "full" else 1), meta


def _plan_matrix_distributed(g: Graph, mesh, block, permute: bool,
                             backend: str, device: torch.device,
                             ) -> Tuple[List[_Stage], int, dict]:
    """The matrix lane over the mesh: the host's heavy-first tile triples
    dealt round-robin (every shard an equal mix of dense and sparse
    triples). Each rank holds the distinct tiles its triples name, with
    re-based indices (``TileSchedule.shard``), and its one stage launches
    K4 on its triples only; ``TrianglePlan.count()`` all-reduces."""
    if block == "auto":
        block = prep.choose_block(g)
    t0 = time.perf_counter()
    sched = prep.tile_schedule(g, block=block, permute=permute)
    t1 = time.perf_counter()
    ndev, shard = int(mesh.size()), mesh_shard_index(mesh)
    t = sched.num_triples
    tiles_ps = -(-t // ndev) if t else 0
    valid = shard_valid_counts(t, ndev)
    stages, tile_bytes = [], 0
    if t:
        shape_key = (tiles_ps, block, block)
        fn = get_executable("matrix_distributed", backend, shape_key,
                            mesh=mesh)
        if valid[shard]:
            l_blocks, u_blocks, *index = sched.shard(shard, ndev, device)
            args = (l_blocks, u_blocks, u_blocks, *index)
            tile_bytes = sum(x.numel() * x.element_size()
                             for x in (l_blocks, u_blocks, *index))
            stages.append(_Stage(executable=fn, args=args,
                                 shape_key=shape_key,
                                 span_name=f"tc.stage matrix b{block}"))
    meta = dict(
        permute=permute,
        schedule_seconds=t1 - t0,
        upload_seconds=time.perf_counter() - t1,
        tile_bytes=tile_bytes,
        **sched.stats,
        **_mesh_meta(mesh),
        tiles_per_shard=tiles_ps,
        shard_valid=[tuple(int(x) for x in valid)],
        shard_work=tuple(int(x) for x in valid),
        shard=shard,
    )
    return stages, 1, meta


def plan_triangle_count(
    g: Graph,
    algorithm: str = "intersection",
    *,
    backend: str = "kernel",
    variant: str = "filtered",
    widths: Sequence[int] = DEFAULT_WIDTHS,
    strategy: str = "auto",
    block: Union[int, str] = "auto",
    permute: bool = True,
    bitmap_bits: Optional[int] = None,
    prep_backend: str = "device",
    shape_policy: Optional[ShapePolicy] = None,
    max_device_bytes: Optional[int] = None,
    device: Union[None, str, torch.device] = None,
    mesh=None,
) -> TrianglePlan:
    """Run the prep stage once and return a device-resident ``TrianglePlan``.

    Args:
      g: the input ``Graph`` (undirected simple CSR).
      algorithm: "intersection" | "subgraph" | "matrix" | "hash" (the
        TRUST-style per-vertex hash lane) | "bfs" (level-ordered wedge
        closure); ``ALGORITHMS``; or a sharded lane,
        "intersection_distributed" | "matrix_distributed"
        (``DISTRIBUTED_ALGORITHMS``: the degree buckets or the heavy-first
        tile triples dealt round-robin over ``mesh``, each rank launching
        its shard, one all-reduce a count).
      backend: "kernel" | "ref" per-stage execution path.
      variant: intersection lane only — "filtered" (forward algorithm) or
        "full" (every directed edge, each triangle found 6×).
      widths: degree-class bucket widths (all lanes but matrix).
      strategy: intersection/subgraph/bfs lanes — "auto" (the
        ``choose_strategy`` cost model per bucket) or a forced
        "broadcast" | "probe" | "bitmap".
      block: matrix lane tile edge B, or "auto" (``prep.choose_block``).
      permute: matrix lane degree-order permutation toggle.
      bitmap_bits: optional forced capacity for bitmap buckets (must cover
        ``n + 2``).
      prep_backend: intersection/subgraph/hash lanes — "device" (torch
        prep) or "host" (the numpy path); the bfs lane always preps on the
        device.
      shape_policy: the ``ShapePolicy``; None means ``DEFAULT_SHAPE_POLICY``.
      max_device_bytes: intersection/subgraph/matrix lanes — optional
        per-bucket device-bytes budget. A bucket (or the matrix lane's
        triples) whose resident arrays would exceed it stays in host memory
        (pinned on a CUDA device) and streams through one launch cached at
        a pow2 chunk shape at ``count()`` time (``_TiledStage``); the
        counts equal the resident plan's. None plans everything resident.
        The hash and bfs lanes take no budget, as in the reference, nor do
        the sharded lanes: the deal already divides the working set.
      device: where the buckets live and the kernels run; None means the
        CUDA device (see ``resolve_device``).
      mesh: the ``torch.distributed`` ``DeviceMesh`` of a sharded lane
        (``launch.mesh.make_mesh``), whose device type must be the
        plan's; None there takes the 1-D ``("data",)`` mesh over the
        default process group's world. Every rank of the mesh plans the
        same graph, in the same order. The single-card lanes ignore it.

    Raises:
      ValueError: unknown algorithm or backend, or a mesh whose device
        type is not the plan's.
      RuntimeError: ``device`` is None or CUDA and no card is present; on a
        CUDA device, host memory that cannot be pinned.
      ProcessGroupNotInitializedError: a sharded lane without a mesh and
        without an initialised process group.
    """
    if algorithm not in ALGORITHMS + DISTRIBUTED_ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one of "
                         f"{ALGORITHMS + DISTRIBUTED_ALGORITHMS}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    device = resolve_device(device)
    group = None
    if algorithm in DISTRIBUTED_ALGORITHMS:
        mesh = world_mesh(device.type) if mesh is None else mesh
        _check_mesh_device(mesh, device)
        group = mesh_group(mesh)
    with span("tc.prep"):
        t0 = time.perf_counter()
        if algorithm == "intersection":
            stages, divisor, meta = _plan_intersection(
                g, variant, backend, widths, strategy, bitmap_bits,
                prep_backend, shape_policy, device, max_device_bytes,
            )
        elif algorithm == "matrix":
            stages, divisor, meta = _plan_matrix(
                g, block, permute, backend, device, max_device_bytes)
        elif algorithm == "subgraph":
            stages, divisor, meta = _plan_subgraph(
                g, backend, widths, strategy, bitmap_bits, prep_backend,
                shape_policy, device, max_device_bytes,
            )
        elif algorithm == "hash":
            stages, divisor, meta = _plan_hash(
                g, backend, widths, prep_backend, shape_policy, device)
        elif algorithm == "bfs":
            stages, divisor, meta = _plan_bfs(
                g, backend, widths, strategy, bitmap_bits, shape_policy,
                device)
        elif algorithm == "intersection_distributed":
            stages, divisor, meta = _plan_intersection_distributed(
                g, mesh, variant, backend, widths, strategy, bitmap_bits,
                prep_backend, shape_policy, device)
        else:
            stages, divisor, meta = _plan_matrix_distributed(
                g, mesh, block, permute, backend, device)
        if group is not None:
            meta["mesh"] = mesh_cache_component(mesh)
        meta["graph"] = g.name
        meta["n"], meta["m"] = g.n, g.m_undirected
        meta["device"] = str(device)
        plan = TrianglePlan(algorithm=algorithm, backend=backend,
                            device=device, stages=stages, divisor=divisor,
                            meta=meta, prep_seconds=0.0, group=group)
        with span("tc.prep.sync"):
            plan.synchronize()
        plan.prep_seconds = time.perf_counter() - t0
        return plan


def plan_hash_count(
    g: Graph,
    *,
    backend: str = "kernel",
    widths: Sequence[int] = DEFAULT_WIDTHS,
    prep_backend: str = "device",
    shape_policy: Optional[ShapePolicy] = None,
    device: Union[None, str, torch.device] = None,
) -> TrianglePlan:
    """Plan the TRUST-style hash lane (see ``_plan_hash``).

    Args mirror ``plan_triangle_count``'s shared subset; the lane has no
    ``strategy`` knob — its count core is the hash probe (K5), not the
    sorted merge. Returns a ``TrianglePlan`` with ``algorithm="hash"``.
    """
    return plan_triangle_count(
        g, "hash", backend=backend, widths=widths, prep_backend=prep_backend,
        shape_policy=shape_policy, device=device,
    )


def plan_bfs_count(
    g: Graph,
    *,
    backend: str = "kernel",
    widths: Sequence[int] = DEFAULT_WIDTHS,
    strategy: str = "auto",
    bitmap_bits: Optional[int] = None,
    shape_policy: Optional[ShapePolicy] = None,
    device: Union[None, str, torch.device] = None,
) -> TrianglePlan:
    """Plan the BFS-based lane (see ``_plan_bfs``).

    Args mirror ``plan_triangle_count``'s shared subset; ``strategy`` /
    ``bitmap_bits`` select the per-bucket intersection core exactly as on
    the intersection lane (the launches are shared). Returns a
    ``TrianglePlan`` with ``algorithm="bfs"``.
    """
    return plan_triangle_count(
        g, "bfs", backend=backend, widths=widths, strategy=strategy,
        bitmap_bits=bitmap_bits, shape_policy=shape_policy, device=device,
    )


def _intersection_planner(g: Graph, options, *, device, mesh=None):
    """Registry planner: CountOptions → intersection-lane TrianglePlan (a
    mesh is ignored, as on every single-card lane)."""
    return plan_triangle_count(g, "intersection", device=device,
                               **options.plan_kwargs("intersection"))


def _hash_planner(g: Graph, options, *, device, mesh=None):
    """Registry planner: CountOptions → hash-lane TrianglePlan."""
    return plan_hash_count(g, device=device, **options.plan_kwargs("hash"))


def _bfs_planner(g: Graph, options, *, device, mesh=None):
    """Registry planner: CountOptions → bfs-lane TrianglePlan."""
    return plan_bfs_count(g, device=device, **options.plan_kwargs("bfs"))


register_algorithm("intersection", _intersection_planner)
register_algorithm("hash", _hash_planner)
register_algorithm("bfs", _bfs_planner)


# ---------------------------------------------------------------------------
# TrussPlan — the edge lane: per-edge support and the k-truss peel
# ---------------------------------------------------------------------------

def _decode_edge_keys(keys: np.ndarray, n1: int):
    """Packed ``lo·n1 + hi`` keys → (lo, hi) int32 arrays (host side)."""
    keys = np.asarray(keys, dtype=np.int64)
    return (keys // n1).astype(np.int32), (keys % n1).astype(np.int32)


@dataclasses.dataclass
class _EdgeStage:
    executable: Callable
    args: Tuple[torch.Tensor, ...]  # (u_lists, v_lists, src, dst, row_ptr)
    shape_key: tuple
    strategy: str  # the resolved mask strategy (broadcast | probe | bitmap)


def _edge_stages(g: Union[Graph, DeviceGraph], *, widths: Sequence[int],
                 strategy: str, bitmap_bits: Optional[int], prep_backend: str,
                 policy: ShapePolicy, peel_key: tuple, key_mode: str,
                 device: torch.device, mesh=None):
    """One graph's edge-support stages: the filtered buckets, the sorted
    edge keys with the slot permutation and the forward row_ptr, and each
    bucket bound to its cached edge launch. A host graph is uploaded once:
    the buckets and the keys share its forward orientation.

    With ``mesh``, each bucket's rows (and their endpoints) are dealt
    round-robin over the mesh's shards and this rank keeps its shard's
    real rows: its stage adds their matches into the full (mk,) slot
    vector (``EdgeLaunch``, cached as "edge_distributed" under the mesh),
    and ``TrussPlan`` all-reduces that vector once a support. A shard
    without rows in a bucket gets no stage.

    Returns (stages, edge_keys, perm, m_edges, meta): ``edge_keys`` is the
    (mk,) sorted key array whose first ``m_edges`` entries are the real
    edges, and ``perm`` reorders slot-ordered support into key order.
    """
    n = g.n
    mode = prep.check_edge_key_range(n, key_mode)
    if prep_backend == "device":
        dg = g if isinstance(g, DeviceGraph) \
            else DeviceGraph.from_graph(g, policy, device=device)
        buckets = prep.prepare_intersection_buckets_device(
            dg, variant="filtered", widths=widths)
        keys, perm, row_ptr, m_edges = prep.forward_edge_keys_device(
            dg, key_mode=mode)
    else:
        buckets = _buckets_for_plan(g, "filtered", widths, "host", policy,
                                    device)
        keys_h, perm_h, row_ptr_h, m_edges = prep.forward_edge_keys_host(
            g, mode)
        keys = torch.from_numpy(keys_h).to(device)
        perm = torch.from_numpy(perm_h).to(device)
        row_ptr = torch.from_numpy(row_ptr_h).to(device)
    mk, n1 = int(keys.shape[0]), n + 1
    id_range = n + 2  # real ids and the in-row sentinels n (u) and n+1 (v)
    bucket_edges = [b.edges for b in buckets]
    if mesh is not None:
        ndev, shard = int(mesh.size()), mesh_shard_index(mesh)
    stages, specs = [], []
    for b in buckets:
        strat, bits = _resolve_bucket_strategy(b.width, id_range, strategy,
                                               bitmap_bits,
                                               resolve_mask_strategy)
        if mesh is None:
            shape_key = b.shape + (mk, n1) + tuple(peel_key)
            specs.append((shape_key, strat))
            stages.append(_EdgeStage(
                executable=get_executable("edge", "kernel", shape_key,
                                          strategy=strat, bitmap_bits=bits),
                args=(b.u_lists, b.v_lists, b.src, b.dst, row_ptr),
                shape_key=shape_key,
                strategy=strat,
            ))
            continue
        rows = policy.round_edges(-(-b.edges // ndev))
        shape_key = (rows, b.width, mk, n1) + tuple(peel_key)
        specs.append((shape_key, strat))
        fn = get_executable("edge_distributed", "kernel", shape_key,
                            strategy=strat, bitmap_bits=bits, mesh=mesh)
        valid = int(shard_valid_counts(b.edges, ndev)[shard])
        if valid:
            stages.append(_EdgeStage(
                executable=fn,
                args=tuple(deal_shard(x, ndev, valid, shard, fill=f) for x, f
                           in ((b.u_lists, -1), (b.v_lists, -2), (b.src, 0),
                               (b.dst, 0))) + (row_ptr,),
                shape_key=shape_key,
                strategy=strat,
            ))
    del buckets  # a rank keeps its shard's rows only
    meta = dict(
        bucket_shapes=[k[:2] for k, _ in specs],
        bucket_strategies=[(k[1], st) for k, st in specs],
        bucket_edges=bucket_edges,
        key_mode=mode,
    )
    if mesh is not None:
        meta.update(mesh=mesh_cache_component(mesh), num_shards=ndev,
                    shard=shard)
    return stages, keys, perm, m_edges, meta


@dataclasses.dataclass
class TrussPlan:
    """A prepared edge-analytics session: resident buckets, the sorted edge
    keys and cached edge launches for per-edge support, and the k-truss
    peel.

    Construction runs the prep once; ``support()`` / ``edge_support()`` /
    ``count()`` replay the stages. ``k_truss(k)`` peels (support → filter →
    re-orient through ``DeviceCSR.from_edges`` and the device prep) until
    its fixed point or ``max_peel_iters`` rounds, one host sync a round;
    rounds whose rounded shapes collide reuse cached launches. The host
    enumeration in ``repro_torch.core.listing`` is never called. Build via
    ``plan_edge_support``.

    With a ``mesh`` the stages are the rank's shard of each bucket, and
    every support (each ``support()``, ``count()`` and peel round) sums
    them and all-reduces the (mk,) vector once over the mesh's ranks, so
    every rank holds the whole support and peels alike; each round
    re-deals the survivor graph over the same mesh.
    """

    graph: Graph
    stages: List[_EdgeStage]
    edge_keys: torch.Tensor  # (mk,) sorted keys; padding = the dtype's max
    perm: torch.Tensor  # (mk,) slot → key-order permutation
    m_edges: int
    widths: Tuple[int, ...]
    strategy: str
    bitmap_bits: Optional[int]
    prep_backend: str
    policy: ShapePolicy
    max_peel_iters: int
    peel_early_exit: bool
    meta: Dict[str, Any]
    prep_seconds: float
    device: torch.device
    executions: int = 0
    key_mode: str = "int32"  # the resolved packed-key mode (int32 | wide)
    mesh: Any = None   # the DeviceMesh of sharded stages
    group: Any = None  # its process group

    algorithm: str = "edge"

    def _run_stages(self, stages: List[_EdgeStage], keys: torch.Tensor,
                    perm: torch.Tensor) -> torch.Tensor:
        """The stages' slot-ordered supports summed in int64 (and, sharded,
        all-reduced once over the mesh), reordered into key order (one
        gather)."""
        total = torch.zeros(keys.shape[0], dtype=torch.int64,
                            device=keys.device)
        for st in stages:
            total += st.executable(*st.args)
        if self.group is not None:
            dist.all_reduce(total, group=self.group)
        return total[perm.long()]

    def support(self) -> np.ndarray:
        """(m,) int64 per-edge triangle counts in ``edge_list_unique``
        order."""
        total = self._run_stages(self.stages, self.edge_keys, self.perm)
        self.executions += 1
        return total[: self.m_edges].cpu().numpy()

    def edge_support(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, support) with src < dst, in ``edge_list_unique``
        order (int32, int32, int64), as ``listing.edge_support`` gives
        them."""
        keys = self.edge_keys[: self.m_edges].cpu().numpy()
        su, sv = _decode_edge_keys(keys, self.graph.n + 1)
        return su, sv, self.support()

    def count(self) -> int:
        """Exact triangle count: each triangle adds 1 to each of its three
        edges, so Σ support = 3Δ (summed on the device, one sync).

        Raises:
          RuntimeError: Σ support is not a multiple of 3.
        """
        supp = self._run_stages(self.stages, self.edge_keys, self.perm)
        total = int(supp[: self.m_edges].sum())
        self.executions += 1
        if total % 3:
            raise RuntimeError(
                f"edge support total {total} is not a multiple of 3")
        return total // 3

    def count_with_stats(self) -> Tuple[int, dict]:
        return self.count(), dict(self.meta)

    def _peel(self, start: Optional[Graph], k: int,
              max_iters: int) -> Tuple[np.ndarray, int, bool]:
        """Bulk k-truss peel to its fixed point (or ``max_iters`` rounds):
        every round removes all edges with support < k − 2 at once, as the
        host oracle does. ``start=None`` peels the plan's own graph with
        its first-round stages. Returns (the surviving keys as int64,
        rounds run, converged)."""
        thresh = int(k) - 2
        kw = dict(widths=self.widths, strategy=self.strategy,
                  bitmap_bits=self.bitmap_bits,
                  prep_backend=self.prep_backend, policy=self.policy,
                  peel_key=(self.max_peel_iters, self.peel_early_exit),
                  key_mode=self.key_mode, device=self.device, mesh=self.mesh)
        if start is None:
            stages, keys, perm, m_cur = (self.stages, self.edge_keys,
                                         self.perm, self.m_edges)
        else:
            stages, keys, perm, m_cur, _ = _edge_stages(start, **kw)
        n, n1 = self.graph.n, self.graph.n + 1
        rounds, converged = 0, (m_cur == 0)
        while rounds < max_iters and m_cur > 0:
            supp = self._run_stages(stages, keys, perm)
            keep = supp[:m_cur] >= thresh
            kept = int(keep.sum())  # the round's one host sync
            rounds += 1
            if kept == m_cur:
                converged = True
                if self.peel_early_exit:
                    break
                continue  # the fixed point is stable; later rounds are no-ops
            if kept == 0:
                m_cur, converged = 0, True  # the empty set is a fixed point
                break
            if self.prep_backend == "device":
                # survivors symmetrized through the sort-based CSR build
                lo = (keys[:m_cur] // n1).to(torch.int32)
                hi = (keys[:m_cur] % n1).to(torch.int32)
                csr = DeviceCSR.from_edges(
                    torch.cat([lo, hi]), torch.cat([hi, lo]), n,
                    valid=torch.cat([keep, keep]), policy=self.policy,
                    key_mode=self.key_mode, device=self.device)
                cur = DeviceGraph(csr, policy=self.policy,
                                  name=self.graph.name + "+peel")
            else:
                keys_h = keys[:m_cur][keep].cpu().numpy()
                su, sv = _decode_edge_keys(keys_h, n1)
                cur = edges_to_csr(su, sv, n=n, name=self.graph.name + "+peel")
            stages, keys, perm, m_cur, _ = _edge_stages(cur, **kw)
        self.executions += rounds
        return keys[:m_cur].cpu().numpy().astype(np.int64), rounds, converged

    def k_truss(self, k: int, *, max_iters: Optional[int] = None) -> Graph:
        """The maximal subgraph whose every edge is in ≥ k − 2 triangles.

        Peels until the fixed point (``peel_early_exit``) or ``max_iters``
        rounds (default: the plan's ``max_peel_iters``); the surviving edge
        set equals ``listing.k_truss``'s. ``meta["peel_rounds"]`` and
        ``meta["peel_converged"]`` record the last peel.
        """
        max_iters = self.max_peel_iters if max_iters is None else int(max_iters)
        keys, rounds, converged = self._peel(None, k, max_iters)
        self.meta["peel_rounds"] = rounds
        self.meta["peel_converged"] = converged
        su, sv = _decode_edge_keys(keys, self.graph.n + 1)
        return edges_to_csr(su, sv, n=self.graph.n,
                            name=self.graph.name + f"+truss{k}")

    def truss_decomposition(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-edge trussness, the largest k whose k-truss keeps the edge
        (2 for edges in no triangle): (src, dst, trussness) with src < dst,
        in ``edge_list_unique`` order.

        Peels level by level, each k-truss from the previous level's
        survivors; the edges a level removes have trussness k − 1.

        Raises:
          ValueError: a level's peel stopped at ``max_peel_iters`` before
            its fixed point (trussness is defined only there).
        """
        n1 = self.graph.n + 1
        orig = self.edge_keys[: self.m_edges].cpu().numpy().astype(np.int64)
        truss = np.full(orig.shape[0], 2, dtype=np.int64)
        cur_keys, cur_graph, k = orig, None, 3
        while cur_keys.size:
            nxt_keys, _, converged = self._peel(cur_graph, k,
                                                self.max_peel_iters)
            if not converged:
                raise ValueError(
                    f"truss_decomposition needs every peel level to reach "
                    f"its fixpoint, but the {k}-truss peel was truncated at "
                    f"max_peel_iters={self.max_peel_iters}; raise the "
                    f"max_peel_iters option"
                )
            removed = cur_keys[~np.isin(cur_keys, nxt_keys)]
            truss[np.searchsorted(orig, removed)] = k - 1
            su, sv = _decode_edge_keys(nxt_keys, n1)
            cur_graph = edges_to_csr(su, sv, n=self.graph.n,
                                     name=self.graph.name + f"+truss{k}")
            cur_keys, k = nxt_keys, k + 1
        su, sv = _decode_edge_keys(orig, n1)
        return su, sv, truss

    def synchronize(self) -> "TrussPlan":
        """Wait for the device (useful before timing)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def shape_keys(self) -> List[tuple]:
        return [st.shape_key for st in self.stages]


def plan_edge_support(
    g: Graph,
    *,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    strategy: str = "auto",
    bitmap_bits: Optional[int] = None,
    prep_backend: str = "device",
    shape_policy: Optional[ShapePolicy] = None,
    max_peel_iters: int = 1000,
    peel_early_exit: bool = True,
    key_mode: str = "auto",
    device: Union[None, str, torch.device] = None,
    mesh=None,
) -> TrussPlan:
    """Run the edge lane's prep once and return a replayable ``TrussPlan``.

    Args:
      g: the input ``Graph``. Packed edge keys are int32 while
        ``(n + 1)² ≤ int32 max`` (n ≤ 46,339) and int64 past it under
        ``key_mode="auto"``.
      widths: degree-class bucket widths.
      strategy: the match-mask core of each bucket: "auto"
        (``resolve_mask_strategy``: bitmap while the id range fits ~4·W
        packed bits, probe for W ≥ 64, broadcast below) or a forced
        "broadcast" | "probe" | "bitmap".
      bitmap_bits: optional forced bitmap capacity (must cover n + 2).
      prep_backend: "device" (torch prep and peel on the device) or "host"
        (the numpy prep, uploaded; the support still runs on the device).
      shape_policy: the ``ShapePolicy``; None means the default.
      max_peel_iters: the k-truss peel's round bound.
      peel_early_exit: stop the peel at its fixed point (default) or run
        exactly ``max_peel_iters`` rounds (same result). Both knobs ride in
        the edge launches' cache keys.
      key_mode: "auto" | "int32" | "wide"
        (``graphs.device.resolve_edge_key_mode``).
      device: where the plan lives; None means the CUDA device.
      mesh: an optional ``DeviceMesh`` (device type the plan's): each
        bucket's rows are dealt round-robin over its ranks, each rank adds
        its shard's matches into the (mk,) slot vector, and one vector
        all-reduce a support combines them; peel rounds re-deal the
        survivor graph over the same mesh. Every rank of the mesh plans
        the same graph. None keeps the single-card stages.

    Raises:
      ValueError: ``max_peel_iters`` < 1, a ``bitmap_bits`` that cannot
        cover the id range, or a mesh whose device type is not the plan's.
      GraphTooLargeError: the key mode cannot represent the graph.
      RuntimeError: ``device`` is None or CUDA and no card is present.
    """
    policy = shape_policy if shape_policy is not None else DEFAULT_SHAPE_POLICY
    max_peel_iters = int(max_peel_iters)
    peel_early_exit = bool(peel_early_exit)
    if max_peel_iters < 1:
        raise ValueError(f"max_peel_iters must be ≥ 1, got {max_peel_iters}")
    device = resolve_device(device)
    group = None
    if mesh is not None:
        _check_mesh_device(mesh, device)
        group = mesh_group(mesh)
    t0 = time.perf_counter()
    stages, keys, perm, m_edges, bucket_meta = _edge_stages(
        g, widths=tuple(widths), strategy=strategy, bitmap_bits=bitmap_bits,
        prep_backend=prep_backend, policy=policy,
        peel_key=(max_peel_iters, peel_early_exit), key_mode=key_mode,
        device=device, mesh=mesh,
    )
    meta = dict(
        graph=g.name,
        n=g.n,
        m=g.m_undirected,
        edges=m_edges,
        widths=tuple(widths),
        strategy=strategy,
        prep_backend=prep_backend,
        shape_policy=policy.key() if prep_backend == "device" else None,
        max_peel_iters=max_peel_iters,
        peel_early_exit=peel_early_exit,
        device=str(device),
        **bucket_meta,
    )
    plan = TrussPlan(
        graph=g, stages=stages, edge_keys=keys, perm=perm, m_edges=m_edges,
        widths=tuple(widths), strategy=strategy, bitmap_bits=bitmap_bits,
        prep_backend=prep_backend, policy=policy,
        max_peel_iters=max_peel_iters, peel_early_exit=peel_early_exit,
        meta=meta, prep_seconds=0.0, device=device,
        key_mode=bucket_meta["key_mode"], mesh=mesh, group=group,
    )
    plan.synchronize()
    plan.prep_seconds = time.perf_counter() - t0
    return plan


def _edge_planner(g: Graph, options, *, device, mesh=None):
    """Registry planner: CountOptions → edge-lane TrussPlan (its support
    stages sharded over ``mesh`` when the session carries one)."""
    return plan_edge_support(g, device=device, mesh=mesh,
                             **options.plan_kwargs("edge"))


register_algorithm("edge", _edge_planner)


# ---------------------------------------------------------------------------
# DynamicPlan — the dynamic lane: batched edge updates, incremental count
# ---------------------------------------------------------------------------

class DynamicPlan:
    """Device state and cached launches of one dynamic-graph session.

    The plan owns the live edge set as two sorted orderings of packed keys
    on the device, ``lo·(n+1)+hi`` and ``hi·(n+1)+lo`` (int32 while
    ``(n+1)² ≤ int32 max``, else int64), with the dtype's max in dead
    slots; the orderings are the adjacency. It keeps the exact triangle
    count across batches of ``EdgeUpdate``s:

    1. the "dynamic_step" launch resolves the batch against the key set
       (tombstones deletes, merges inserts, one sort an ordering) and
       gathers the anchor rows of the batch's endpoints before and after
       the update, touching O(batch) adjacency;
    2. the "delta" launch counts the triangles on the effective deletes in
       the old adjacency (Δ⁻) and on the effective inserts in the new one
       (Δ⁺), weighted 6/k (``DeltaLaunch``);
    3. count = count − Δ⁻ + Δ⁺.

    A chunk syncs with the host three times: the step's stats (live edges,
    max degree, inserts, deletes) and the two delta sums. Every extent
    (key capacity, update rows, the top width class) is a ``ShapePolicy``
    class that only grows, so steady-state batches add no cache entry; a
    class that grows adds one (visible in ``executable_cache_info()``).
    Every ``recount_interval`` batches, and on ``recount()``, a full
    recount through the filtered intersection plan (K1–K3 on the card)
    checks the count and raises on drift.
    """

    algorithm = "dynamic"

    def __init__(self, g: Graph, *, backend: str = "kernel",
                 widths: Sequence[int] = DEFAULT_WIDTHS,
                 strategy: str = "auto",
                 bitmap_bits: Optional[int] = None,
                 shape_policy: Optional[ShapePolicy] = None,
                 update_batch_size: int = 256,
                 recount_interval: int = 64,
                 key_mode: str = "auto",
                 device: Union[None, str, torch.device] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one "
                             f"of {BACKENDS}")
        self.key_mode = resolve_edge_key_mode(g.n, key_mode, lane="dynamic")
        self._sentinel = edge_key_sentinel(self.key_mode)
        self._key_dtype = edge_key_dtype(self.key_mode)
        self._np_key_dtype = np.int64 if self.key_mode == "wide" else np.int32
        update_batch_size = int(update_batch_size)
        recount_interval = int(recount_interval)
        if update_batch_size < 1:
            raise ValueError(
                f"update_batch_size must be ≥ 1, got {update_batch_size}")
        if recount_interval < 0:
            raise ValueError(
                f"recount_interval must be ≥ 0 (0 disables the periodic "
                f"oracle), got {recount_interval}")
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        self.graph = g
        self.name = g.name
        self.n = int(g.n)
        self.backend = backend
        self.widths = tuple(int(w) for w in widths)
        self.strategy = strategy
        self.bitmap_bits = bitmap_bits
        self.policy = (shape_policy if shape_policy is not None
                       else DEFAULT_SHAPE_POLICY)
        self.update_batch_size = update_batch_size
        self.recount_interval = recount_interval
        self.ub = self.policy.round_edges(update_batch_size)
        # the width classes: the widths plus a pow2 top that only grows
        self._extra_top: Optional[int] = None
        dmax = int(g.max_degree)
        if dmax > self.widths[-1]:
            self._extra_top = next_pow2(dmax)
        lo, hi = g.edge_list_unique()
        self.m = int(lo.shape[0])
        self.cap = self.policy.round_edges(self.m)
        n1 = self.n + 1
        host = []
        for a, b in ((lo, hi), (hi, lo)):
            keys = np.full(self.cap, self._sentinel, np.int64)
            keys[: self.m] = np.sort(a.astype(np.int64) * n1 + b)
            host.append(torch.from_numpy(keys.astype(self._np_key_dtype)))
        self._keys, self._rkeys = (k.to(self.device) for k in host)
        self.batches = 0
        self.inserted = 0
        self.deleted = 0
        self.recounts = 0
        self.executions = 0
        # prime: one all-padding step binds this shape class
        self._apply_step(
            np.full(self.ub, self._sentinel, np.int64),
            np.full(self.ub, self._sentinel, np.int64),
            np.zeros(self.ub, bool), np.zeros(self.ub, bool))
        self._count = self._full_recount()
        self.meta = dict(
            graph=self.name, n=self.n, m=self.m,
            key_mode=self.key_mode,
            widths=self.widths, strategy=self.strategy,
            shape_policy=self.policy.key(),
            update_batch_size=self.update_batch_size,
            update_rows=self.ub,
            recount_interval=self.recount_interval,
            bounds=self.bounds, capacity=self.cap,
            bucket_strategies=self._bucket_strategies(),
            batches=0, inserted=0, deleted=0, recounts=0,
            device=str(self.device),
        )
        self.synchronize()
        self.prep_seconds = time.perf_counter() - t0

    # -- shape classes ------------------------------------------------------

    @property
    def bounds(self) -> tuple:
        """The session's width classes (widths plus the monotone top)."""
        if self._extra_top is not None:
            return self.widths + (self._extra_top,)
        return self.widths

    def _bucket_strategies(self) -> list:
        id_range = self.n + 2
        return [(int(w), resolve_mask_strategy(int(w), id_range,
                                               self.strategy)[0])
                for w in self.bounds]

    def _maybe_grow_width(self, dmax: int) -> bool:
        if dmax <= self.bounds[-1]:
            return False
        self._extra_top = next_pow2(dmax)
        return True

    def _grow_capacity(self, needed: int) -> None:
        new_cap = self.policy.round_edges(needed)
        if new_cap <= self.cap:  # pragma: no cover - rounding is monotone
            raise AssertionError("capacity growth must be monotone")
        pad = torch.full((new_cap - self.cap,), self._sentinel,
                         dtype=self._key_dtype, device=self.device)
        self._keys = torch.cat([self._keys, pad])
        self._rkeys = torch.cat([self._rkeys, pad])
        self.cap = new_cap

    # -- cached launches ----------------------------------------------------

    def _step_executable(self) -> Callable:
        wide = ("wide",) if self.key_mode == "wide" else ()
        return get_executable(
            "dynamic_step", "kernel",
            (self.cap, self.ub, self.n + 1, int(self.bounds[-1])) + wide)

    def _delta_executable(self) -> Callable:
        wide = ("wide",) if self.key_mode == "wide" else ()
        return get_executable(
            "delta", "kernel", (self.ub, self.n + 1) + self.bounds + wide,
            strategy=self.strategy, bitmap_bits=self.bitmap_bits)

    # -- update path --------------------------------------------------------

    def _upload(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(a if dtype is None else a.astype(dtype)) \
            .to(self.device)

    def _apply_step(self, upd_keys: np.ndarray, upd_rkeys: np.ndarray,
                    upd_ins: np.ndarray, upd_valid: np.ndarray):
        """Run one padded step and return its whole output tuple."""
        return self._step_executable()(
            self._keys, self._rkeys,
            self._upload(upd_keys, self._np_key_dtype),
            self._upload(upd_rkeys, self._np_key_dtype),
            self._upload(upd_ins), self._upload(upd_valid))

    def apply_updates(self, lo: np.ndarray, hi: np.ndarray,
                      insert: np.ndarray) -> dict:
        """Apply a normalized update stream and keep the count.

        Args are the arrays of ``graphs.formats.normalize_edge_updates``
        (lo < hi pairs, no self loops, last-wins deduplicated). The stream
        runs in chunks of ``update_batch_size``, each one step and two
        delta launches. Returns the refreshed ``meta``.
        """
        lo = np.asarray(lo, dtype=np.int32)
        hi = np.asarray(hi, dtype=np.int32)
        insert = np.asarray(insert, dtype=bool)
        ubs = self.update_batch_size
        for s in range(0, int(lo.shape[0]), ubs):
            self._apply_chunk(lo[s:s + ubs], hi[s:s + ubs], insert[s:s + ubs])
        return self._sync_meta()

    def _apply_chunk(self, lo_c: np.ndarray, hi_c: np.ndarray,
                     ins_c: np.ndarray) -> None:
        nu = int(lo_c.shape[0])
        if nu == 0:
            return
        # grow the key arrays before the step, so that a capacity class is
        # bound once, not once a batch
        n_ins_req = int(ins_c.sum())
        if self.m + n_ins_req > self.cap:
            self._grow_capacity(self.m + n_ins_req)
        n1 = self.n + 1
        upd_keys = np.full(self.ub, self._sentinel, np.int64)
        upd_keys[:nu] = lo_c.astype(np.int64) * n1 + hi_c
        upd_rkeys = np.full(self.ub, self._sentinel, np.int64)
        upd_rkeys[:nu] = hi_c.astype(np.int64) * n1 + lo_c
        upd_ins = np.zeros(self.ub, bool)
        upd_ins[:nu] = ins_c
        upd_valid = np.zeros(self.ub, bool)
        upd_valid[:nu] = True
        d_lo = np.zeros(self.ub, np.int32)
        d_lo[:nu] = lo_c
        d_hi = np.zeros(self.ub, np.int32)
        d_hi[:nu] = hi_c
        step_out = self._apply_step(upd_keys, upd_rkeys, upd_ins, upd_valid)
        d_lo, d_hi = self._upload(d_lo), self._upload(d_hi)
        # Δ⁻: delete-anchored triangles in the old adjacency, launched
        # before the stats sync (the old rows fit the old class)
        (_, _, eff_ins, eff_del, ins_skeys, del_skeys,
         old_lr, old_hr, old_ld, old_hd, _, _, _, _, st) = step_out
        sum_del = self._delta_executable()(old_lr, old_hr, old_ld, old_hd,
                                           d_lo, d_hi, eff_del, del_skeys)
        m_new, dmax_new, n_ins, n_del = st.tolist()  # the step's one sync
        if self._maybe_grow_width(dmax_new):
            # the same step again at the grown width class, so that the Δ⁺
            # rows hold the whole new adjacency (nothing is committed yet)
            step_out = self._apply_step(upd_keys, upd_rkeys, upd_ins,
                                        upd_valid)
        (new_keys, new_rkeys, eff_ins, eff_del, ins_skeys, del_skeys,
         _, _, _, _, new_lr, new_hr, new_ld, new_hd, st) = step_out
        # Δ⁺: insert-anchored triangles in the new adjacency
        sum_ins = self._delta_executable()(new_lr, new_hr, new_ld, new_hd,
                                           d_lo, d_hi, eff_ins, ins_skeys)
        sdel, sins = int(sum_del), int(sum_ins)
        if sdel % 6 or sins % 6:
            raise RuntimeError(
                f"dynamic delta drift on {self.name!r}: weighted anchor "
                f"sums ({sdel}, {sins}) are not divisible by 6")
        self._count += sins // 6 - sdel // 6
        self._keys, self._rkeys = new_keys, new_rkeys
        self.m = m_new
        self.inserted += n_ins
        self.deleted += n_del
        self.executions += 1
        self.batches += 1
        if self.recount_interval and self.batches % self.recount_interval == 0:
            self.recount()

    # -- counting and the parity oracle -------------------------------------

    def _full_recount(self) -> int:
        """Count the live edge set from scratch through the filtered
        intersection plan (K1–K3 on the card), with one host sync."""
        if self.m == 0:
            return 0
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for st in self.recount_stages():
            total += st.run()
        return int(total)

    def recount_stages(self) -> list:
        """The filtered intersection stages of the live edge set, as the
        full recount builds them. The CSR is built on the device: both
        orderings together are every directed edge ``src·(n+1)+dst``, and
        one sort puts them in CSR order."""
        if self.m == 0:
            return []
        n, n1 = self.n, self.n + 1
        directed = torch.sort(torch.cat([self._keys[: self.m],
                                         self._rkeys[: self.m]]).long()).values
        row_ptr = torch.searchsorted(
            directed, torch.arange(n + 1, device=self.device) * n1)
        csr = DeviceCSR(n=n, m=2 * self.m, row_ptr=row_ptr.to(torch.int32),
                        col_idx=(directed % n1).to(torch.int32))
        dg = DeviceGraph(csr, policy=self.policy, name=self.name + "+recount")
        stages, _, _ = _plan_intersection(
            dg, "filtered", self.backend, self.widths, self.strategy,
            self.bitmap_bits, "device", self.policy, self.device)
        return stages

    def count(self) -> int:
        """The incrementally kept exact triangle count (O(1))."""
        return self._count

    def count_with_stats(self):
        """(count, meta) with the meta refreshed to the current state."""
        return self._count, self._sync_meta()

    def recount(self) -> int:
        """Count the live edges from scratch and raise ``RuntimeError`` if
        the kept count has drifted."""
        full = self._full_recount()
        self.recounts += 1
        if full != self._count:
            raise RuntimeError(
                f"incremental triangle count drifted on {self.name!r}: "
                f"incremental={self._count}, full recount={full} after "
                f"{self.batches} update batches")
        return full

    def snapshot(self) -> Graph:
        """The live edge set as a host ``Graph``."""
        keys = self._keys.cpu().numpy().astype(np.int64)
        keys = keys[keys != self._sentinel]
        lo, hi = _decode_edge_keys(keys, self.n + 1)
        return edges_to_csr(lo, hi, n=self.n, name=self.name + "+dynamic")

    def synchronize(self) -> "DynamicPlan":
        """Wait for the device (useful before timing)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _sync_meta(self) -> dict:
        self.meta.update(
            m=self.m, capacity=self.cap, bounds=self.bounds,
            bucket_strategies=self._bucket_strategies(),
            batches=self.batches, inserted=self.inserted,
            deleted=self.deleted, recounts=self.recounts)
        return dict(self.meta)

    def __repr__(self) -> str:
        return (f"DynamicPlan(graph={self.name!r}, n={self.n}, m={self.m}, "
                f"count={self._count}, batches={self.batches}, "
                f"device={str(self.device)!r})")


def plan_dynamic_count(
    g: Graph,
    *,
    backend: str = "kernel",
    widths: Sequence[int] = DEFAULT_WIDTHS,
    strategy: str = "auto",
    bitmap_bits: Optional[int] = None,
    shape_policy: Optional[ShapePolicy] = None,
    update_batch_size: int = 256,
    recount_interval: int = 64,
    key_mode: str = "auto",
    device: Union[None, str, torch.device] = None,
) -> DynamicPlan:
    """Open a dynamic-graph counting session seeded from ``g``.

    Args:
      g: the seed ``Graph`` (may be empty).
      backend / widths / strategy / bitmap_bits / shape_policy: as on the
        intersection lane; they set the delta launches' mask strategies and
        the full recount.
      update_batch_size: updates a step; longer streams are chunked. Padded
        to a policy extent (the "update rows" class).
      recount_interval: run the full recount every this many batches (0:
        never; ``recount()`` is always there).
      key_mode: "auto" | "int32" | "wide"
        (``graphs.device.resolve_edge_key_mode``).
      device: where the session lives; None means the CUDA device.

    Raises:
      ValueError: an unknown backend, ``update_batch_size`` < 1 or
        ``recount_interval`` < 0.
      GraphTooLargeError: the key mode cannot represent the graph.
      RuntimeError: ``device`` is None or CUDA and no card is present.
    """
    return DynamicPlan(
        g, backend=backend, widths=widths, strategy=strategy,
        bitmap_bits=bitmap_bits, shape_policy=shape_policy,
        update_batch_size=update_batch_size,
        recount_interval=recount_interval, key_mode=key_mode, device=device)


def _dynamic_planner(g: Graph, options, *, device, mesh=None):
    """Registry planner: CountOptions → dynamic-lane DynamicPlan."""
    return plan_dynamic_count(g, device=device,
                              **options.plan_kwargs("dynamic"))


register_algorithm("dynamic", _dynamic_planner)


# ---------------------------------------------------------------------------
# GraphBatch — graphs of one policy stacked into one launch per width
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GraphBatch:
    """A batch of graphs prepped under one ``ShapePolicy`` and stacked, so
    the whole batch is counted by ONE intersection launch per width.

    Build via ``from_graphs``: each member runs the device intersection
    prep, each width's buckets are harmonized to the largest policy-rounded
    extent across members (a width a member lacks becomes all-padding
    rows, which count zero), and each width's (u, v) pairs are stored
    contiguous as (B, E, W) stacks. ``counts()`` passes each stack viewed as
    (B·E, W) to one K1/K2/K3 launch (``BatchLaunch``, from the shared cache
    under the reference's ``"intersection_batch"`` key) and makes one host
    sync for the batch. This is the ``TriangleCounter.count_many`` fast
    path.
    """

    graphs: List[Graph]
    backend: str
    device: torch.device
    divisor: int
    specs: tuple  # ((strategy, bitmap_bits, (e_pad, width)), ...) per width
    arrays: List[torch.Tensor]  # flattened (u, v) stacks, (B, E, W) each
    meta: Dict[str, Any]
    prep_seconds: float
    executions: int = 0

    @property
    def batch_size(self) -> int:
        return len(self.graphs)

    @property
    def shape_keys(self) -> List[tuple]:
        return [shape for _, _, shape in self.specs]

    def counts(self) -> np.ndarray:
        """(B,) exact triangle counts: one launch per width, one sync.

        Raises:
          RuntimeError: a full-variant total that is not a multiple of 6.
        """
        if not self.specs:
            out = np.zeros(self.batch_size, dtype=np.int64)
        else:
            fn = get_batch_executable(self.specs, self.backend,
                                      self.batch_size)
            out = fn(*self.arrays).cpu().numpy()
        if self.divisor != 1:
            if (out % self.divisor).any():
                raise RuntimeError(f"totals {out.tolist()} are not multiples "
                                   f"of divisor {self.divisor}")
            out //= self.divisor
        self.executions += 1
        return out

    def synchronize(self) -> "GraphBatch":
        """Wait for the device (useful before timing counts)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    @classmethod
    def from_graphs(cls, graphs: Sequence[Graph], options=None, *,
                    device: Union[None, str, torch.device] = None,
                    **overrides) -> "GraphBatch":
        """Prep and stack ``graphs`` under one options bag.

        Args:
          graphs: host ``Graph``s of any mix of sizes; each width's stack
            takes the largest policy-rounded extent among the members.
          options: a ``CountOptions``; None builds one from ``**overrides``.
            It must have ``backend="kernel"`` and ``prep_backend="device"``
            (the defaults). The strategy resolves per width with
            ``id_range = max n + 2`` across the members.
          device: where the stacks live and the kernels run; None means the
            CUDA device (see ``resolve_device``).

        Raises:
          ValueError: an empty batch, or options outside the batchable
            regime.
          RuntimeError: ``device`` is None or CUDA and no card is present.
        """
        from repro_torch.core.options import CountOptions

        if options is None:
            options = CountOptions(**overrides)
        elif overrides:
            options = options.replace(**overrides)
        graphs = list(graphs)
        if not graphs:
            raise ValueError("GraphBatch needs at least one graph")
        if options.backend != "kernel":
            raise ValueError(
                f"GraphBatch requires backend='kernel' (each width's stack "
                f"goes through one kernel launch); got {options.backend!r}")
        if options.prep_backend != "device":
            raise ValueError(
                "GraphBatch requires prep_backend='device' (the stacked "
                "layout is defined by the device prep's ShapePolicy)")
        device = resolve_device(device)
        policy = options.resolved_shape_policy
        t0 = time.perf_counter()
        per_graph = [
            {b.width: b for b in prep.prepare_intersection_buckets_device(
                g, variant=options.variant, widths=options.widths,
                policy=policy, device=device)}
            for g in graphs
        ]
        widths_union = sorted({w for bs in per_graph for w in bs})
        id_range = max(g.n for g in graphs) + 2
        specs, arrays = [], []
        for w in widths_union:
            members = [bs.get(w) for bs in per_graph]
            e_pad = max(policy.round_edges(1) if b is None else b.e_pad
                        for b in members)
            u = torch.full((len(graphs), e_pad, w), -1, dtype=torch.int32,
                           device=device)
            v = torch.full((len(graphs), e_pad, w), -2, dtype=torch.int32,
                           device=device)
            for i, b in enumerate(members):
                if b is not None:
                    u[i, :b.e_pad] = b.u_lists
                    v[i, :b.e_pad] = b.v_lists
            strat, bits = _resolve_bucket_strategy(
                w, id_range, options.strategy, options.bitmap_bits)
            specs.append((strat, bits, (e_pad, w)))
            arrays.extend([u, v])
        del per_graph
        batch = cls(
            graphs=graphs,
            backend=options.backend,
            device=device,
            divisor=6 if options.variant == "full" else 1,
            specs=tuple(specs),
            arrays=arrays,
            meta=dict(
                batch_size=len(graphs),
                variant=options.variant,
                widths=tuple(options.widths),
                strategy=options.strategy,
                shape_policy=policy.key(),
                prep_backend="device",
                bucket_shapes=[s[2] for s in specs],
                bucket_strategies=[(s[2][1], s[0]) for s in specs],
                graphs=[g.name for g in graphs],
                device=str(device),
            ),
            prep_seconds=0.0,
        )
        batch.synchronize()
        batch.prep_seconds = time.perf_counter() - t0
        return batch
