"""``TriangleService``: the concurrent front end over the counting engine.

The port of ``repro.serve.service``. One dispatcher thread drains a
bounded admission queue (``queueing.py``); count requests that can be
coalesced (the same resolved ``CountOptions.key()``, which folds in the
``ShapePolicy`` layout class) are grouped within a batching window and
counted by one launch per width (``coalescer.py``); every other kind
(per-vertex counts, edge support, k-truss, dynamic-session updates) runs
singly through a bounded session cache keyed by
``CounterSession.session_key()``. Every request resolves exactly one way:
a ``ServeResult`` on its future, the request's own exception, or a typed
``RequestShed`` (queue full / deadline expired / shutdown). The service
never queues without bound and never hangs a caller.

    from repro_torch.serve import ServeConfig, TriangleService

    with TriangleService(algorithm="intersection") as svc:   # on the card
        svc.warmup([g1, g2])                    # optional: fix the layout
        futs = [svc.submit("count", g, tenant="a") for g in graphs]
        results = [f.result() for f in futs]    # ServeResult each
        svc.snapshot()                          # metrics + cache counters

The service runs on the card unless it is given another device
(``device="cpu"`` runs the plain versions); its sessions and the
coalescer's preps live there, and the dispatcher thread enters that
device before it launches anything. The launch configurations are
process-wide (the engine's bounded LRU), so a second service inherits
every warm one. A kernel or launch error reaches the request's future
like any other error; on a CUDA device such an error is sticky, so a
caller should stop at the first errored future.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Iterable, List, Optional, Union

import torch

from repro_torch.core import registry
from repro_torch.core.api import (
    DynamicTriangleCounter,
    TriangleCounter,
    graph_fingerprint,
)
from repro_torch.core.engine import _BoundedLRU
from repro_torch.core.options import CountOptions
from repro_torch.graphs.device import resolve_device
from repro_torch.serve.coalescer import Coalescer, _pow2_chunks
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.queueing import (
    SHED_DEADLINE,
    SHED_SHUTDOWN,
    AdmissionQueue,
    QueuedRequest,
    RequestShed,
)

__all__ = ["KINDS", "ServeConfig", "ServeResult", "TriangleService"]

KINDS = ("count", "vertex", "edge_support", "k_truss", "update")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The service's admission / batching / cache knobs.

    Attributes:
      max_queue_depth: admission bound — request ``max_queue_depth + 1``
        is shed with ``"queue-full"`` instead of buffered.
      batch_window_ms: how long the dispatcher holds a coalescible head
        request open for compatible arrivals (0 disables waiting; already
        queued compatible requests still coalesce).
      max_batch: the largest group one window may collect (chunks run
        as powers of two, so 8 means batch launches for 2/4/8).
      default_deadline_ms: deadline applied to requests that do not carry
        their own (None = no deadline). Expired requests are shed with
        ``"deadline"`` at admission or at dispatch, never executed late.
      plan_cache_size: bound of the coalescer's prep LRU, in graphs
        (fingerprint + prep options -> device buckets).
      session_cache_size: bound of the single-execution session LRU
        (``session_key()`` -> ``TriangleCounter``); 0 disables session
        reuse (a fresh session per request).
    """

    max_queue_depth: int = 64
    batch_window_ms: float = 2.0
    max_batch: int = 8
    default_deadline_ms: Optional[float] = None
    plan_cache_size: int = 128
    session_cache_size: int = 32

    def __post_init__(self):
        if self.max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, "
                             f"got {self.max_queue_depth}")
        if self.batch_window_ms < 0:
            raise ValueError(f"batch_window_ms must be >= 0, "
                             f"got {self.batch_window_ms}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.default_deadline_ms is not None \
                and self.default_deadline_ms <= 0:
            raise ValueError(f"default_deadline_ms must be positive or None, "
                             f"got {self.default_deadline_ms}")
        if self.plan_cache_size < 1:
            raise ValueError(f"plan_cache_size must be >= 1, "
                             f"got {self.plan_cache_size}")
        if self.session_cache_size < 0:
            raise ValueError(f"session_cache_size must be >= 0, "
                             f"got {self.session_cache_size}")


@dataclasses.dataclass
class ServeResult:
    """What a served request resolves to.

    ``count`` is the exact triangle count for "count" and "update" kinds
    (None otherwise); ``value`` carries the analysis payload (per-vertex
    array, (src, dst, support) triple, or the k-truss ``Graph``).
    ``batch_size`` is the size of the launch group that served this
    request (1 = single pass-through), ``batch_id`` groups requests that
    shared a window. ``exec_s`` is the whole dispatch's execution time:
    shared, not per request, for coalesced members.
    """

    request_id: int
    kind: str
    tenant: str
    count: Optional[int]
    value: Any
    algorithm: str
    batch_id: int
    batch_size: int
    queue_wait_s: float
    exec_s: float
    total_s: float

    def __int__(self) -> int:
        if self.count is None:
            raise TypeError(f"{self.kind!r} results carry no count")
        return self.count


class TriangleService:
    """The concurrent, coalescing, load-shedding triangle-counting front
    end. See the module docstring for the lifecycle; constructor options
    mirror ``CounterSession`` (an optional ``CountOptions`` plus field
    overrides, and ``device``: None means the card) with a
    ``config=ServeConfig(...)`` for the serving knobs."""

    def __init__(self, options: Optional[CountOptions] = None, *,
                 config: Optional[ServeConfig] = None,
                 device: Union[None, str, torch.device] = None,
                 **overrides):
        if options is None:
            options = CountOptions(**overrides)
        elif overrides:
            options = options.replace(**overrides)
        if not isinstance(options, CountOptions):
            raise TypeError(f"options must be a CountOptions, "
                            f"got {type(options).__name__}")
        self.options = options
        self.device = resolve_device(device)
        self.config = config or ServeConfig()
        self.metrics = MetricsRegistry()
        self._queue = AdmissionQueue(self.config.max_queue_depth)
        self._coalescer = Coalescer(self.config.plan_cache_size,
                                    device=self.device)
        self._sessions: Optional[_BoundedLRU] = (
            _BoundedLRU(self.config.session_cache_size)
            if self.config.session_cache_size else None
        )
        self._dyn: Dict[str, DynamicTriangleCounter] = {}
        self._dyn_lock = threading.Lock()
        self._req_seq = itertools.count()
        self._batch_seq = itertools.count()
        self._dyn_seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "TriangleService":
        """Spawn the dispatcher thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stopping.clear()
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="tc-serve-dispatcher",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True,
             timeout: Optional[float] = 30.0) -> None:
        """Stop admitting and shut the dispatcher down.

        ``drain=True`` (default) serves everything already queued first;
        ``drain=False`` sheds the backlog with reason ``"shutdown"``.
        """
        self._queue.close()
        if not drain:
            for req in self._queue.drain():
                self._shed(req, SHED_SHUTDOWN, "service stopping")
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for req in self._queue.drain():  # anything the join left behind
            self._shed(req, SHED_SHUTDOWN, "service stopped")

    def __enter__(self) -> "TriangleService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission ---------------------------------------------------------

    def submit(self, kind: str, graph=None, *, tenant: str = "default",
               options: Optional[CountOptions] = None,
               deadline_ms: Optional[float] = None,
               **payload) -> Future:
        """Enqueue one request; returns its future immediately.

        The future resolves to a ``ServeResult``, raises the request's own
        error, or raises ``RequestShed`` when admission control rejects it
        (queue full / deadline / shutdown) — it never blocks forever while
        the service runs. ``kind`` is one of ``KINDS``; "k_truss" takes
        ``k=...``, "update" takes ``handle=...`` and ``updates=[...]`` (and
        no graph — updates target the handle's dynamic session and always
        bypass coalescing).
        """
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
        if kind == "update":
            if graph is not None:
                raise ValueError("update requests target a dynamic-session "
                                 "handle, not a graph")
            handle = payload.get("handle")
            with self._dyn_lock:
                if handle not in self._dyn:
                    raise KeyError(f"unknown dynamic session {handle!r}")
            if "updates" not in payload:
                raise ValueError("update requests need updates=[...]")
        else:
            if graph is None:
                raise ValueError(f"{kind!r} requests need a graph")
            if kind == "k_truss" and "k" not in payload:
                raise ValueError("k_truss requests need k=...")
        opts = options if options is not None else self.options
        if not isinstance(opts, CountOptions):
            raise TypeError(f"options must be a CountOptions, "
                            f"got {type(opts).__name__}")

        ddl_ms = deadline_ms if deadline_ms is not None \
            else self.config.default_deadline_ms
        deadline = (time.perf_counter() + ddl_ms / 1e3
                    if ddl_ms is not None else None)

        fingerprint = graph_fingerprint(graph) if graph is not None else None
        compat_key = None
        if kind == "count":
            lane = self._resolve_lane(graph, opts)
            if self._batchable(lane, opts):
                compat_key = ("count", lane, opts.key())

        req = QueuedRequest(
            request_id=next(self._req_seq), kind=kind, tenant=tenant,
            graph=graph, options=opts, compat_key=compat_key,
            fingerprint=fingerprint, payload=dict(payload),
            deadline=deadline,
        )
        self.metrics.inc("offered")
        reason = self._queue.offer(req)
        if reason is not None:
            self._shed(req, reason,
                       f"depth={self._queue.depth}/{self._queue.max_depth}")
        else:
            self.metrics.inc("accepted")
        return req.future

    def count(self, graph, **kwargs) -> ServeResult:
        """Blocking convenience: ``submit("count", ...).result()``."""
        return self.submit("count", graph, **kwargs).result()

    # -- dynamic sessions ---------------------------------------------------

    def open_dynamic_session(self, graph, *, tenant: str = "default",
                             options: Optional[CountOptions] = None) -> str:
        """Create a per-tenant ``DynamicTriangleCounter`` and return its
        handle; stream batches through ``submit("update", handle=...,
        updates=[...])`` (FIFO per handle — the dispatcher is the only
        executor, so update order is submission order)."""
        opts = options if options is not None else self.options
        if opts.algorithm not in ("auto", "dynamic"):
            opts = opts.replace(algorithm="dynamic")
        handle = f"dyn-{tenant}-{next(self._dyn_seq)}"
        session = DynamicTriangleCounter(graph, opts, device=self.device)
        with self._dyn_lock:
            self._dyn[handle] = session
        return handle

    def close_dynamic_session(self, handle: str) -> None:
        with self._dyn_lock:
            self._dyn.pop(handle)

    # -- warmup / introspection ---------------------------------------------

    def warmup(self, graphs: Iterable, *,
               options: Optional[CountOptions] = None) -> dict:
        """Deterministically prime every cache a request pool will touch.

        Batchable graphs are prepped into the plan cache (fixing the
        coalescer's monotone layout) and one synthetic dispatch runs per
        pow-2 chunk size up to ``max_batch`` plus the single pass-through;
        non-batchable graphs get a counted session in the session cache.
        After a warmup over the pool, steady-state serving builds no launch
        configuration: ``snapshot()["engine_cache"]["misses"]`` stays flat.
        """
        opts = options if options is not None else self.options
        t0 = time.perf_counter()
        by_key: Dict[tuple, List[tuple]] = {}
        singles = 0
        for g in graphs:
            lane = self._resolve_lane(g, opts)
            fp = graph_fingerprint(g)
            if self._batchable(lane, opts):
                key = ("count", lane, opts.key())
                by_key.setdefault(key, []).append((g, fp))
            else:
                singles += 1
                req = QueuedRequest(
                    request_id=-1, kind="count", tenant="warmup", graph=g,
                    options=opts, compat_key=None, fingerprint=fp,
                    payload={},
                )
                self._session(req).count()
        for key, members in by_key.items():
            self._coalescer.warmup(key, members, opts,
                                   self.config.max_batch)
        return dict(
            seconds=time.perf_counter() - t0,
            batchable=sum(len(m) for m in by_key.values()),
            singles=singles,
            layouts=len(by_key),
        )

    def snapshot(self) -> dict:
        """The full metrics snapshot: request counters, latency stats,
        coalesce factor, engine-cache counters, plus the serve-local plan
        and session cache counters and the live queue depth."""
        snap = self.metrics.snapshot()
        snap["plan_cache"] = self._coalescer.cache_info()
        snap["session_cache"] = (
            self._sessions.info() if self._sessions is not None
            else dict(size=0, maxsize=0, hits=0, misses=0, evictions=0)
        )
        snap["queue_depth"] = self._queue.depth
        return snap

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _batchable(lane: str, opts: CountOptions) -> bool:
        # mirrors TriangleCounter._batchable: the stacked-launch regime
        return (lane == "intersection" and opts.backend == "kernel"
                and opts.prep_backend == "device")

    @staticmethod
    def _resolve_lane(graph, opts: CountOptions) -> str:
        if opts.algorithm != "auto":
            return opts.algorithm
        if opts.chooser == "measured":
            from repro_torch.core.calibrate import choose_measured
            return choose_measured(graph)
        return registry.choose_algorithm(graph)

    def _shed(self, req: QueuedRequest, reason: str,
              detail: str = "") -> None:
        self.metrics.inc("shed")
        self.metrics.inc(f"shed_{reason}")
        if not req.future.done():
            req.future.set_exception(RequestShed(reason, detail))

    def _session(self, req: QueuedRequest) -> TriangleCounter:
        """The request's ``TriangleCounter``, through the bounded session
        cache (``session_key()``-equal requests share prep + plan)."""
        def build() -> TriangleCounter:
            return TriangleCounter(req.graph, req.options, device=self.device)

        if self._sessions is None:
            return build()
        key = (req.fingerprint, req.options.key())
        return self._sessions.get_or_build(key, build)

    def _dispatch_loop(self) -> None:
        # the current CUDA device is per thread: launch on the service's
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._drain()
        else:
            self._drain()

    def _drain(self) -> None:
        while True:
            req = self._queue.pop(timeout=0.05)
            if req is None:
                if self._stopping.is_set() and self._queue.depth == 0:
                    return
                continue
            try:
                if req.compat_key is not None:
                    self._dispatch_group(self._collect_group(req))
                else:
                    self._execute_single(req)
            except BaseException as e:  # the loop must outlive any request
                if not req.future.done():
                    self.metrics.inc("errors")
                    req.future.set_exception(e)

    def _collect_group(self, head: QueuedRequest) -> List[QueuedRequest]:
        """Fill the batching window: everything compatible already queued,
        then wait (up to ``batch_window_ms``) for stragglers, flushing
        early once ``max_batch`` is reached or the service is stopping."""
        group = [head]
        limit = self.config.max_batch
        group += self._queue.take_compatible(head.compat_key,
                                             limit - len(group))
        window_end = time.perf_counter() + self.config.batch_window_ms / 1e3
        while len(group) < limit and not self._stopping.is_set():
            remaining = window_end - time.perf_counter()
            if remaining <= 0:
                break
            self._queue.wait_for_arrival(min(remaining, 0.01))
            group += self._queue.take_compatible(head.compat_key,
                                                 limit - len(group))
        return group

    def _dispatch_group(self, group: List[QueuedRequest]) -> None:
        now = time.perf_counter()
        live = []
        for r in group:
            if r.expired(now):
                self._shed(r, SHED_DEADLINE, "deadline expired in queue")
            else:
                live.append(r)
        if not live:
            return
        exec_start = time.perf_counter()
        try:
            prepped = [
                self._coalescer.prep(r.graph, r.fingerprint, r.options)
                for r in live
            ]
            counts, chunk_sizes = self._coalescer.count_group(
                live[0].compat_key, prepped, live[0].options
            )
        except BaseException as e:
            for r in live:
                if not r.future.done():
                    self.metrics.inc("errors")
                    r.future.set_exception(e)
            return
        exec_s = time.perf_counter() - exec_start
        batch_id = next(self._batch_seq)
        chunks = _pow2_chunks(len(live))
        self.metrics.inc("dispatches", len(chunks))
        self.metrics.inc("dispatched_requests", len(live))
        self.metrics.inc("coalesced_requests",
                         sum(c for c in chunks if c >= 2))
        for r, c, bs in zip(live, counts, chunk_sizes):
            self._complete(r, count=int(c), value=None,
                           algorithm="intersection", batch_id=batch_id,
                           batch_size=bs, exec_start=exec_start,
                           exec_s=exec_s)

    def _execute_single(self, req: QueuedRequest) -> None:
        if req.expired():
            self._shed(req, SHED_DEADLINE, "deadline expired in queue")
            return
        exec_start = time.perf_counter()
        try:
            if req.kind == "update":
                with self._dyn_lock:
                    dyn = self._dyn[req.payload["handle"]]
                res = dyn.apply_updates(req.payload["updates"])
                count, value, algorithm = int(res), None, "dynamic"
            else:
                session = self._session(req)
                algorithm = session.algorithm
                count, value = None, None
                if req.kind == "count":
                    r = session.count()
                    count = r.count
                elif req.kind == "vertex":
                    value = session.triangles_per_vertex()
                elif req.kind == "edge_support":
                    value = session.edge_support()
                else:  # k_truss
                    value = session.k_truss(req.payload["k"])
        except BaseException as e:
            self.metrics.inc("errors")
            if not req.future.done():
                req.future.set_exception(e)
            return
        exec_s = time.perf_counter() - exec_start
        self.metrics.inc("dispatches")
        self.metrics.inc("dispatched_requests")
        self._complete(req, count=count, value=value, algorithm=algorithm,
                       batch_id=next(self._batch_seq), batch_size=1,
                       exec_start=exec_start, exec_s=exec_s)

    def _complete(self, req: QueuedRequest, *, count, value, algorithm,
                  batch_id: int, batch_size: int, exec_start: float,
                  exec_s: float) -> None:
        done = time.perf_counter()
        queue_wait = exec_start - req.submitted
        total = done - req.submitted
        self.metrics.observe("queue_wait", queue_wait)
        self.metrics.observe("exec", exec_s)
        self.metrics.observe("total", total)
        self.metrics.inc("completed")
        result = ServeResult(
            request_id=req.request_id, kind=req.kind, tenant=req.tenant,
            count=count, value=value, algorithm=algorithm,
            batch_id=batch_id, batch_size=batch_size,
            queue_wait_s=queue_wait, exec_s=exec_s, total_s=total,
        )
        if not req.future.done():
            req.future.set_result(result)
