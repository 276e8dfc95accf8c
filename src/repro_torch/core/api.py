"""One front door for triangle counting: ``TriangleCounter`` + ``CountResult``.

The port of ``repro.core.api``:

    from repro_torch.core import TriangleCounter, DynamicTriangleCounter

    tc = TriangleCounter(g)                  # on the card; algorithm="auto"
    res = tc.count()                         # CountResult
    res.count, res.algorithm, res.bucket_strategies
    tc.triangles_per_vertex()                # (n,) int64, cached plan
    tc.count_many(graphs, batch_size=16)     # one launch per width a batch
    tc.edge_support()                        # (src, dst, support), edge lane
    tc.k_truss(5), tc.truss_decomposition()

    dc = DynamicTriangleCounter(g)           # the dynamic lane
    dc.apply_updates([(0, 1), (2, 3, False)])  # CountResult, kept exact
    dc.recount(), dc.snapshot()

    mesh = make_mesh((world,), ("data",))    # repro_torch.launch.mesh
    TriangleCounter(g, mesh=mesh).count()    # auto → a sharded lane

A session runs on the CUDA device unless it is given another
(``device="cpu"`` runs the plain torch versions of the kernels). It owns
one plan, built lazily through the algorithm registry, so every
``count()`` is a device replay (a ``DynamicTriangleCounter``'s count is
kept, not recomputed).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
import warnings
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.engine import (
    GraphBatch,
    _check_mesh_device,
    executable_cache_info,
    plan_triangle_count,
)
from repro_torch.core.options import CountOptions
from repro_torch.graphs.device import resolve_device
from repro_torch.graphs.formats import Graph, normalize_edge_updates
from repro_torch.spans import span

__all__ = ["CountResult", "CounterSession", "DynamicTriangleCounter",
           "TriangleCounter", "graph_fingerprint", "warn_deprecated"]


def graph_fingerprint(g: Graph) -> str:
    """A stable content hash of a graph's CSR (32 hex chars).

    Graphs with equal ``(n, row_ptr, col_idx)`` fingerprint alike whatever
    their ``name``: blake2b-16 over ``n`` and the int64 bytes of both
    arrays, so the hex equals the reference's for the same graph. The
    serving layer keys its session and prep caches on it. One pass over
    the CSR on the host.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(str(int(g.n)).encode())
    h.update(np.ascontiguousarray(g.row_ptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(g.col_idx, dtype=np.int64).tobytes())
    return h.hexdigest()


def warn_deprecated(old: str, new: str) -> None:
    """Emit the front door's standard ``DeprecationWarning`` (the
    ``listing`` shims use it; the stack level points at the shim's
    caller)."""
    warnings.warn(
        f"{old} is deprecated; use {new} (see README.md §Migration)",
        DeprecationWarning,
        stacklevel=3,
    )


@dataclasses.dataclass(eq=False)
class CountResult:
    """One triangle count plus how it was produced.

    Attributes:
      count: the exact triangle count.
      algorithm: the lane that ran (the resolution of ``"auto"``).
      options: the session's ``CountOptions``.
      bucket_strategies: the per-bucket ``(width, strategy)`` picks.
      prep_seconds: the plan's one-time prep stage.
      exec_seconds: this count's device replay, measured around ``count()``
        (which ends in a host sync).
      plan: the live plan (``TrianglePlan``, ``TrussPlan`` or
        ``DynamicPlan``).
      meta: the plan's statistics dict.

    Compares equal to ints via ``count``.
    """

    count: int
    algorithm: str
    options: CountOptions
    bucket_strategies: Optional[List[Tuple[int, str]]]
    prep_seconds: float
    exec_seconds: float
    plan: Any
    meta: Dict[str, Any]

    def __int__(self) -> int:
        return self.count

    def __index__(self) -> int:
        return self.count

    def __eq__(self, other) -> bool:
        if isinstance(other, CountResult):
            return self.count == other.count
        if isinstance(other, (int, np.integer)):
            return self.count == int(other)
        return NotImplemented

    def __repr__(self) -> str:
        return (f"CountResult(count={self.count}, "
                f"algorithm={self.algorithm!r}, "
                f"prep_seconds={self.prep_seconds:.4f}, "
                f"exec_seconds={self.exec_seconds:.4f})")


class CounterSession:
    """Shared machinery of a counting session: one graph, one
    ``CountOptions``, one device, one lazily built plan.

    Args:
      g: the input ``Graph``.
      options: a ``CountOptions``; None builds one from ``**overrides``.
      device: where the plan lives and the kernels run. None means the
        CUDA device; without a card that raises ``RuntimeError`` (pass
        ``device="cpu"``).
      mesh: a ``torch.distributed`` ``DeviceMesh`` (``launch.mesh``), its
        device type the session's: the sharded lanes deal their work over
        it, the edge lane shards its supports, and ``algorithm="auto"``
        promotes its pick to a sharded lane when it has more than one
        rank. Every rank runs the same session on the same graph. The
        other lanes ignore it.
      **overrides: ``CountOptions`` field overrides.

    Raises:
      ValueError: a mesh whose device type is not the session's.
    """

    def __init__(self, g: Graph, options: Optional[CountOptions] = None,
                 *, device: Union[None, str, torch.device] = None, mesh=None,
                 **overrides):
        if options is None:
            options = CountOptions(**overrides)
        elif overrides:
            options = options.replace(**overrides)
        if not isinstance(options, CountOptions):
            raise TypeError(
                f"options must be a CountOptions, got {type(options).__name__}"
            )
        if mesh is not None:
            _check_mesh_device(mesh, torch.device(
                "cuda" if device is None else device))
        self.device = resolve_device(device)
        self.mesh = mesh
        self.graph = g
        self.options = options
        self.algorithm = self._resolve_algorithm()
        self._plan = None

    def _resolve_algorithm(self) -> str:
        if self.options.algorithm != "auto":
            return self.options.algorithm
        return self._choose_auto(self.graph)

    def _choose_auto(self, g: Graph) -> str:
        """Resolve ``algorithm="auto"`` for ``g`` per ``options.chooser``:
        "measured" consults the calibration table (``core.calibrate``, the
        heuristic when there is none), "heuristic" the registry's
        chooser; either promotes its pick under the session's mesh."""
        if self.options.chooser == "measured":
            from repro_torch.core.calibrate import choose_measured
            return choose_measured(g, mesh=self.mesh)
        return registry.choose_algorithm(g, mesh=self.mesh)

    @property
    def plan(self):
        """The session's plan, built on first access via the registry."""
        if self._plan is None:
            planner = registry.get_algorithm(self.algorithm)
            self._plan = planner(self.graph, self.options, device=self.device,
                                 mesh=self.mesh)
        return self._plan

    def count(self) -> CountResult:
        """Count triangles (a device replay after the first call)."""
        with span("tc.count"):
            plan = self.plan
            t0 = time.perf_counter()
            c = plan.count()
            exec_seconds = time.perf_counter() - t0
            meta = dict(plan.meta)
            if self.algorithm == "subgraph":
                meta["num_embeddings"] = 6 * c  # all |Aut(K3)| automorphisms
            return CountResult(
                count=c,
                algorithm=self.algorithm,
                options=self.options,
                bucket_strategies=meta.get("bucket_strategies"),
                prep_seconds=float(plan.prep_seconds),
                exec_seconds=exec_seconds,
                plan=plan,
                meta=meta,
            )

    def count_with_stats(self) -> Tuple[int, Dict[str, Any]]:
        """``(count, stats)``: the count and the plan's meta, with the
        resolved lane under ``"algorithm"``."""
        res = self.count()
        stats = dict(res.meta)
        stats["algorithm"] = res.algorithm
        return res.count, stats

    @staticmethod
    def cache_stats() -> Dict[str, int]:
        """Process-wide launch-configuration cache statistics."""
        return executable_cache_info()

    def session_key(self) -> tuple:
        """The session's reuse identity, ``(graph_fingerprint(graph),
        options.key())``: sessions with equal keys are interchangeable,
        which is what the serving layer's session cache keys on."""
        return (graph_fingerprint(self.graph), self.options.key())


class TriangleCounter(CounterSession):
    """A static counting session (see ``CounterSession``), with the
    per-vertex and per-edge analysis accessors routed through the cached
    plan (or a memoized sidecar plan of the lane that has them)."""

    def __init__(self, g: Graph, options: Optional[CountOptions] = None,
                 *, device: Union[None, str, torch.device] = None, mesh=None,
                 **overrides):
        super().__init__(g, options, device=device, mesh=mesh, **overrides)
        self._vertex_counts: Optional[np.ndarray] = None
        self._edge_sidecar = None
        self._warned_mesh_fallback = False

    def count_many(self, graphs: Iterable[Graph],
                   *, batch_size: int = 8) -> List[CountResult]:
        """Count a batch of graphs under this session's options and device.

        The input is consumed lazily, ``batch_size`` graphs at a time. In
        each chunk, every graph whose lane resolves to the batchable regime
        (``intersection``, ``backend="kernel"``, ``prep_backend="device"``:
        the defaults) is device-prepped and stacked into one
        ``GraphBatch``, counted by one launch per width and one host sync.
        Successive chunks whose policy-rounded layouts collide reuse the
        cached batch launch. A chunk with a single batchable graph counts
        it in a plain session; graphs outside the regime get per-graph
        sessions, and the session's own graph reuses the session plan.
        Under a mesh of more than one rank, ``auto`` promotes to the
        sharded lanes, which do not batch: each such graph is counted in a
        sharded session of its own, and the first one warns
        (``UserWarning``) once a session.

        Results come back in input order. Batched results share their
        ``GraphBatch`` as ``plan``, and their ``prep_seconds`` /
        ``exec_seconds`` are the whole chunk's (``meta["batched"]`` and
        ``meta["batch_size"]`` mark them).

        Raises:
          ValueError: ``batch_size`` < 1.
        """
        return list(self.iter_counts(graphs, batch_size=batch_size))

    def iter_counts(self, graphs: Iterable[Graph],
                    *, batch_size: int = 8) -> Iterator[CountResult]:
        """Generator form of ``count_many``: yields results in input order,
        pulling at most ``batch_size`` graphs ahead of the consumer."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be ≥ 1, got {batch_size}")
        it = iter(graphs)
        while True:
            chunk = list(itertools.islice(it, batch_size))
            if not chunk:
                return
            yield from self._count_chunk(chunk)

    def _batchable(self, lane: str) -> bool:
        return (lane == "intersection"
                and self.options.backend == "kernel"
                and self.options.prep_backend == "device")

    def _count_chunk(self, chunk: List[Graph]) -> List[CountResult]:
        results: List[Optional[CountResult]] = [None] * len(chunk)
        batchable: List[Tuple[int, Graph]] = []
        for pos, g in enumerate(chunk):
            if g is self.graph:
                results[pos] = self.count()
                continue
            lane = (self.options.algorithm
                    if self.options.algorithm != "auto"
                    else self._choose_auto(g))
            if self._batchable(lane):
                batchable.append((pos, g))
            else:
                if self.mesh is not None and not self._warned_mesh_fallback:
                    self._warned_mesh_fallback = True
                    warnings.warn(
                        f"count_many: lane {lane!r} under a mesh is not "
                        f"batchable; graph {g.name!r} and every other such "
                        f"graph are counted in sessions of their own, not "
                        f"in one stacked launch", UserWarning, stacklevel=4)
                results[pos] = TriangleCounter(g, self.options,
                                               device=self.device,
                                               mesh=self.mesh).count()
        if len(batchable) == 1:  # nothing to stack; a plain session is cheaper
            pos, g = batchable[0]
            results[pos] = TriangleCounter(g, self.options, device=self.device,
                                           mesh=self.mesh).count()
        elif batchable:
            opts = self.options if self.options.algorithm == "intersection" \
                else self.options.replace(algorithm="intersection")
            batch = GraphBatch.from_graphs([g for _, g in batchable], opts,
                                           device=self.device)
            t0 = time.perf_counter()
            counts = batch.counts()
            exec_seconds = time.perf_counter() - t0
            for (pos, g), c in zip(batchable, counts):
                results[pos] = CountResult(
                    count=int(c),
                    algorithm="intersection",
                    options=self.options,
                    bucket_strategies=batch.meta["bucket_strategies"],
                    prep_seconds=batch.prep_seconds,
                    exec_seconds=exec_seconds,
                    plan=batch,
                    meta=dict(batch.meta, graph=g.name, n=g.n,
                              m=g.m_undirected, batched=True),
                )
        return results

    # -- per-edge analysis (support, k-truss), through the edge lane -------

    def _edge_plan(self):
        """The session's edge-lane ``TrussPlan``: the session plan itself
        when ``algorithm="edge"``, else a sidecar built once from the same
        options on the same device and mesh (sharded supports under a
        mesh)."""
        if self.algorithm == "edge":
            return self.plan
        if self._edge_sidecar is None:
            planner = registry.get_algorithm("edge")
            self._edge_sidecar = planner(self.graph, self.options,
                                         device=self.device, mesh=self.mesh)
        return self._edge_sidecar

    def edge_support(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, support) with src < dst: each undirected edge's
        triangle count, in ``Graph.edge_list_unique`` order (int32, int32,
        int64), replayed through the edge lane's cached launches."""
        return self._edge_plan().edge_support()

    def k_truss(self, k: int, *, max_iters: Optional[int] = None) -> Graph:
        """The maximal subgraph whose every edge is in ≥ k − 2 triangles:
        the edge lane's peel (support → filter → re-orient, until its fixed
        point or ``max_iters`` rounds, default the session's
        ``max_peel_iters``). Returns a ``Graph``."""
        return self._edge_plan().k_truss(k, max_iters=max_iters)

    def truss_decomposition(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, trussness) with src < dst: each edge's largest k whose
        k-truss keeps it (2 for edges in no triangle).

        Raises:
          ValueError: ``max_peel_iters`` stopped a level's peel before its
            fixed point.
        """
        return self._edge_plan().truss_decomposition()

    def triangles_per_vertex(self) -> np.ndarray:
        """(n,) int64 per-vertex triangle counts.

        Replays the session plan's buckets when it carries forward
        endpoints (the filtered variant); the full variant falls back to a
        filtered sidecar plan over the same widths on the same device. The
        result is memoized on the session.
        """
        if self._vertex_counts is None:
            try:
                t = self.plan.triangles_per_vertex()
            except NotImplementedError:
                t = _vertex_counts_sidecar(self.graph, self.options, self.device)
            self._vertex_counts = t
        return self._vertex_counts.copy()

    def clustering_coefficients(self) -> np.ndarray:
        """cc[v] = 2·t(v) / (d(v)·(d(v)−1)); 0 where degree < 2."""
        t = self.triangles_per_vertex().astype(np.float64)
        d = self.graph.degrees.astype(np.float64)
        denom = d * (d - 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(denom > 0, 2.0 * t / denom, 0.0)

    def transitivity(self) -> float:
        """3 · #triangles / #wedges (= Σ t(v) / #wedges)."""
        t = int(self.triangles_per_vertex().sum())
        d = self.graph.degrees.astype(np.int64)
        wedges = int((d * (d - 1) // 2).sum())
        return float(t) / wedges if wedges else 0.0

    def __repr__(self) -> str:
        return (f"TriangleCounter(graph={self.graph.name!r}, "
                f"algorithm={self.algorithm!r}, device={str(self.device)!r}, "
                f"planned={self._plan is not None})")


class DynamicTriangleCounter(CounterSession):
    """A dynamic-graph session: batched edge updates, a kept exact count.

    Seed it with a ``Graph`` (it may be empty), then stream batches through
    ``apply_updates``::

        dc = DynamicTriangleCounter(g, update_batch_size=256)
        dc.count()                                   # the seed's count
        dc.apply_updates([EdgeUpdate(0, 1),          # insert (default)
                          EdgeUpdate(2, 3, insert=False),
                          (4, 5)])                   # a pair inserts
        dc.count()                                   # kept, O(1)

    Updates are normalized on the host (``lo < hi``, no self loops, last
    wins within a batch), then applied ``update_batch_size`` at a time by
    the cached step and delta launches of ``engine.DynamicPlan`` on the
    session's device. Inserting a present edge and deleting an absent one
    are no-ops. Every ``recount_interval`` batches (0: never) a full
    recount checks the kept count; ``recount()`` runs it on demand and
    ``snapshot()`` returns the live edge set as a host ``Graph``.

    The session always runs the "dynamic" lane: any other ``algorithm``
    raises ``ValueError``.
    """

    def _resolve_algorithm(self) -> str:
        if self.options.algorithm not in ("auto", "dynamic"):
            raise ValueError(
                f"DynamicTriangleCounter always runs the dynamic lane; "
                f"got algorithm={self.options.algorithm!r} "
                f"(expected one of ('auto', 'dynamic'))")
        return "dynamic"

    def apply_updates(self, updates) -> CountResult:
        """Apply one batch of edge updates and return the kept count.

        ``updates`` is any iterable of ``EdgeUpdate``s, ``(u, v)`` pairs
        (insert) or ``(u, v, insert)`` triples, with ids in ``[0, n)``. The
        result's ``exec_seconds`` covers the whole batch, and its ``meta``
        is the session's state after it.
        """
        lo, hi, ins = normalize_edge_updates(updates, self.graph.n)
        plan = self.plan
        t0 = time.perf_counter()
        plan.apply_updates(lo, hi, ins)
        res = self.count()
        res.exec_seconds = time.perf_counter() - t0
        return res

    def recount(self) -> int:
        """The full recount now (raises ``RuntimeError`` on drift)."""
        return self.plan.recount()

    def snapshot(self) -> Graph:
        """The live edge set as a host ``Graph``."""
        return self.plan.snapshot()

    @property
    def m_undirected(self) -> int:
        """The number of live undirected edges."""
        return self.plan.m

    def __repr__(self) -> str:
        return (f"DynamicTriangleCounter(graph={self.graph.name!r}, "
                f"device={str(self.device)!r}, "
                f"planned={self._plan is not None})")


def _vertex_counts_sidecar(g: Graph, options: CountOptions,
                           device: torch.device) -> np.ndarray:
    """Per-vertex counts for plans without forward endpoints (the full
    variant): a filtered plan over the same widths."""
    plan = plan_triangle_count(g, "intersection", variant="filtered",
                               widths=options.widths, device=device)
    return plan.triangles_per_vertex()
