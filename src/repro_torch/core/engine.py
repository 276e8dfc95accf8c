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
  level-oriented buckets run through the intersection launches.

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

from repro_torch.graphs.formats import (
    Graph,
    csr_to_padded_neighbors,
    induced_subgraph,
    orient_forward,
)
from repro_torch.graphs.device import (
    DEFAULT_SHAPE_POLICY,
    DeviceGraph,
    ShapePolicy,
    next_pow2,
    resolve_device,
)
from repro_torch.core import prep
from repro_torch.core.options import BACKENDS, DEFAULT_WIDTHS
from repro_torch.core.prep import DeviceBucket
from repro_torch.core.registry import register_algorithm
from repro_torch.kernels.intersect.ops import (
    STRATEGIES,
    intersect_counts,
    intersect_matches,
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

__all__ = [
    "ALGORITHMS",
    "HashLaunch",
    "IntersectLaunch",
    "MatrixLaunch",
    "TrianglePlan",
    "VertexLaunch",
    "cache_info",
    "clear_caches",
    "executable_cache_info",
    "get_executable",
    "plan_bfs_count",
    "plan_hash_count",
    "plan_triangle_count",
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


def get_executable(algorithm: str, backend: str, shape_key: tuple, *,
                   strategy: Optional[str] = None,
                   bitmap_bits: Optional[int] = None) -> Callable:
    """Fetch (or build) the cached launch configuration for one work unit.

    Args:
      algorithm: "intersection" (a bucket's count; the subgraph and bfs
        lanes' buckets use it too), "matrix" (the tile triples' unique
        tiles and indices, ``shape_key`` ``(T, B, B)``), "hash" (a
        bucket's hash probe, ``shape_key`` ``(E, W, B, D)``: the shape
        class of the reference's dense table rides in the key) or
        "vertex" (a filtered bucket's per-vertex counts; ``shape_key`` is
        ``(E, W, n)``).
      backend: "kernel" | "ref".
      shape_key: the work unit's array shape.
      strategy: the resolved set-intersection strategy ("intersection").
      bitmap_bits: the bitmap capacity when strategy="bitmap".

    Returns:
      The entry cached under ``(algorithm, strategy, backend, bitmap_bits,
      shape_key)``; plans over same-shaped buckets share it.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if algorithm == "intersection":
        if strategy not in STRATEGIES:
            raise ValueError(f"unresolved strategy {strategy!r}; "
                             f"expected one of {STRATEGIES}")
        builder = functools.partial(IntersectLaunch, strategy, backend, bitmap_bits)
    elif algorithm == "matrix":
        builder = functools.partial(MatrixLaunch, backend)
    elif algorithm == "hash":
        builder = functools.partial(HashLaunch, backend, int(shape_key[2]))
    elif algorithm == "vertex":
        builder = functools.partial(VertexLaunch, int(shape_key[2]), int(shape_key[1]))
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    key = (algorithm, strategy, backend, bitmap_bits, tuple(shape_key))
    return _EXECUTABLE_CACHE.get_or_build(key, builder)


def executable_cache_info() -> dict:
    """``{'size', 'hits', 'misses', 'maxsize', 'evictions'}``."""
    return _EXECUTABLE_CACHE.info()


def cache_info() -> dict:
    """``executable_cache_info()`` plus the live ``keys`` tuple (MRU last)."""
    return _EXECUTABLE_CACHE.info(include_keys=True)


def clear_caches() -> None:
    """Drop every cached entry and zero the hit/miss/eviction counters."""
    _EXECUTABLE_CACHE.clear()


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
    strategy: Optional[str] = None
    bitmap_bits: Optional[int] = None
    # (src, dst) per row — filtered stages only, for the per-vertex path
    vertex_args: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def run(self) -> torch.Tensor:
        """One stage: the kernel launch plus its int64 reduction."""
        return self.executable(*self.args)


@dataclasses.dataclass
class TrianglePlan:
    """A prepared triangle count: device buffers + bound launches.

    ``count()`` replays the device stage only. Build via
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

    def count(self) -> int:
        """Exact triangle count: every stage's kernel, summed on the
        device in int64, with one host sync.

        Raises:
          RuntimeError: the full variant's total is not a multiple of 6
            (a broken kernel or layout).
        """
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for st in self.stages:
            total += st.run()
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
                or any(st.vertex_args is None for st in self.stages):
            raise NotImplementedError(
                f"per-vertex counts need filtered-intersection stages; "
                f"algorithm={self.algorithm!r} divisor={self.divisor} does "
                f"not carry them"
            )
        n_local = int(self.meta.get("vertex_n", self.meta["n"]))
        total = torch.zeros(n_local, dtype=torch.int64, device=self.device)
        for st in self.stages:
            e, w = st.shape_key
            fn = get_executable("vertex", self.backend, (e, w, n_local))
            total += fn(*st.args, *st.vertex_args)
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
                             bitmap_bits: Optional[int]):
    """Resolve one bucket's (strategy, bitmap_bits), honouring a forced
    ``bitmap_bits`` override (which must cover the id range)."""
    strat, bits = resolve_strategy(width, id_range, strategy=strategy)
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
                      device: torch.device) -> List[DeviceBucket]:
    """Run the prep stage on the requested backend; either way the result
    is ``DeviceBucket``s on ``device`` (the host path uploads its arrays)."""
    if prep_backend == "device":
        return prep.prepare_intersection_buckets_device(
            g, variant=variant, widths=widths, policy=policy, device=device,
        )
    host = prep.prepare_intersection_buckets_host(g, variant=variant,
                                                  widths=widths)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return [
        DeviceBucket(width=b["width"], edges=int(b["u_lists"].shape[0]),
                     u_lists=up(b["u_lists"]), v_lists=up(b["v_lists"]),
                     src=up(b["src"]), dst=up(b["dst"]))
        for b in host
    ]


def _plan_intersection(g: Graph, variant: str, backend: str,
                       widths: Sequence[int], strategy: str,
                       bitmap_bits: Optional[int], prep_backend: str,
                       shape_policy: Optional[ShapePolicy],
                       device: torch.device) -> Tuple[List[_Stage], int, dict]:
    buckets = _buckets_for_plan(g, variant, widths, prep_backend,
                                shape_policy, device)
    stages, bucket_meta = _bucket_stages(buckets, g.n, backend, strategy,
                                         bitmap_bits,
                                         per_vertex=(variant == "filtered"))
    policy = shape_policy if shape_policy is not None else DEFAULT_SHAPE_POLICY
    meta = dict(
        variant=variant,
        widths=tuple(widths),
        strategy=strategy,
        prep_backend=prep_backend,
        shape_policy=policy.key() if prep_backend == "device" else None,
        **bucket_meta,
    )
    return stages, (6 if variant == "full" else 1), meta


def _bucket_stages(buckets: List[DeviceBucket], n: int, backend: str,
                   strategy: str, bitmap_bits: Optional[int], *,
                   per_vertex: bool) -> Tuple[List[_Stage], dict]:
    """Bind each bucket to its cached intersection launch, with the
    strategy resolved per bucket; ``per_vertex`` keeps the forward
    endpoints for the per-vertex stage. Returns the stages and their
    bucket meta (shapes, strategies, edges)."""
    # real ids [0, n) plus the in-row sentinels n (u) and n + 1 (v); whole
    # padding rows (-1/-2) are negative and never match in any core
    id_range = n + 2
    stages = []
    for b in buckets:
        strat, bits = _resolve_bucket_strategy(b.width, id_range, strategy,
                                               bitmap_bits)
        stages.append(_Stage(
            executable=get_executable("intersection", backend, b.shape,
                                      strategy=strat, bitmap_bits=bits),
            args=(b.u_lists, b.v_lists),
            shape_key=b.shape,
            strategy=strat,
            bitmap_bits=bits,
            vertex_args=(b.src, b.dst) if per_vertex else None,
        ))
    return stages, dict(
        bucket_shapes=[s.shape_key for s in stages],
        bucket_strategies=[(s.shape_key[1], s.strategy) for s in stages],
        bucket_edges=[b.edges for b in buckets],
        edges=int(sum(b.edges for b in buckets)),
    )


def _plan_matrix(g: Graph, block, permute: bool, backend: str,
                 device: torch.device) -> Tuple[List[_Stage], int, dict]:
    """The matrix lane: the host tile schedule, then one stage holding the
    gathered form on the device: the unique tiles (bf16 at a B of K4's
    tensor-core route, else float32), the (T,) int32 triple indices and the
    launch order (``launch_order``, made once here). Its shape key is
    (T, B, B). T = 0 gives no stage, so the count is 0."""
    if block == "auto":
        block = prep.choose_block(g)
    t0 = time.perf_counter()
    sched = prep.tile_schedule(g, block=block, permute=permute)
    t1 = time.perf_counter()
    stages = []
    tile_bytes = 0
    if sched.num_triples:
        l_blocks, u_blocks, l_index, u_index, a_index = sched.to_device(device)
        order = launch_order(l_index, a_index)
        args = (l_blocks, u_blocks, u_blocks, l_index, u_index, a_index, order)
        tile_bytes = sum(x.numel() * x.element_size() for x in
                         (l_blocks, u_blocks, l_index, u_index, a_index, order))
        shape_key = (sched.num_triples, block, block)
        stages.append(_Stage(
            executable=get_executable("matrix", backend, shape_key),
            args=args, shape_key=shape_key))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    meta = dict(permute=permute, schedule_seconds=t1 - t0,
                upload_seconds=time.perf_counter() - t1, tile_bytes=tile_bytes,
                **sched.stats)
    return stages, 1, meta


def _plan_subgraph(g: Graph, backend: str, widths: Sequence[int],
                   strategy: str, bitmap_bits: Optional[int],
                   prep_backend: str, shape_policy: Optional[ShapePolicy],
                   device: torch.device) -> Tuple[List[_Stage], int, dict]:
    """The subgraph lane: FILTER (2-core peel to its fixed point),
    RECONSTRUCT (the induced graph) and the forward-filtered intersection
    JOIN on the survivors, which counts each triangle once."""
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
            "device", policy, device)
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
        None, device)
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
) -> TrianglePlan:
    """Run the prep stage once and return a device-resident ``TrianglePlan``.

    Args:
      g: the input ``Graph`` (undirected simple CSR).
      algorithm: "intersection" | "subgraph" | "matrix" | "hash" (the
        TRUST-style per-vertex hash lane) | "bfs" (level-ordered wedge
        closure); ``ALGORITHMS``.
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
      max_device_bytes: must be None: tiled streaming is not ported yet.
      device: where the buckets live and the kernels run; None means the
        CUDA device (see ``resolve_device``).

    Raises:
      ValueError: unknown algorithm or backend.
      NotImplementedError: ``max_device_bytes`` is set.
      RuntimeError: ``device`` is None or CUDA and no card is present.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one of "
                         f"{ALGORITHMS}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if max_device_bytes is not None:
        raise NotImplementedError(
            "max_device_bytes (tiled streaming of buckets or tile stacks "
            "over a device budget) is not ported yet; see ROADMAP.md "
            "Queue 1 item 10"
        )
    device = resolve_device(device)
    t0 = time.perf_counter()
    if algorithm == "intersection":
        stages, divisor, meta = _plan_intersection(
            g, variant, backend, widths, strategy, bitmap_bits, prep_backend,
            shape_policy, device,
        )
    elif algorithm == "matrix":
        stages, divisor, meta = _plan_matrix(g, block, permute, backend,
                                             device)
    elif algorithm == "subgraph":
        stages, divisor, meta = _plan_subgraph(
            g, backend, widths, strategy, bitmap_bits, prep_backend,
            shape_policy, device,
        )
    elif algorithm == "hash":
        stages, divisor, meta = _plan_hash(g, backend, widths, prep_backend,
                                           shape_policy, device)
    else:
        stages, divisor, meta = _plan_bfs(g, backend, widths, strategy,
                                          bitmap_bits, shape_policy, device)
    meta["graph"] = g.name
    meta["n"], meta["m"] = g.n, g.m_undirected
    meta["device"] = str(device)
    plan = TrianglePlan(algorithm=algorithm, backend=backend, device=device,
                        stages=stages, divisor=divisor, meta=meta,
                        prep_seconds=0.0)
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


def _intersection_planner(g: Graph, options, *, device):
    """Registry planner: CountOptions → intersection-lane TrianglePlan."""
    return plan_triangle_count(g, "intersection", device=device,
                               **options.plan_kwargs("intersection"))


def _hash_planner(g: Graph, options, *, device):
    """Registry planner: CountOptions → hash-lane TrianglePlan."""
    return plan_hash_count(g, device=device, **options.plan_kwargs("hash"))


def _bfs_planner(g: Graph, options, *, device):
    """Registry planner: CountOptions → bfs-lane TrianglePlan."""
    return plan_bfs_count(g, device=device, **options.plan_kwargs("bfs"))


register_algorithm("intersection", _intersection_planner)
register_algorithm("hash", _hash_planner)
register_algorithm("bfs", _bfs_planner)
