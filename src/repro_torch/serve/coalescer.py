"""Compatible-request coalescing: shared prep, stable layouts, one launch
per width.

The port of ``repro.serve.coalescer``. A burst of count requests with the
same resolved ``CountOptions.key()`` (which folds in the ``ShapePolicy``
layout class) is stacked and counted by one ``BatchLaunch``: one K1/K2/K3
launch per width over the stack viewed as (B·E, W), the ``GraphBatch``
path of ``count_many``, but fed from caches so steady state runs no host
prep and builds no launch configuration:

* **Prep cache**: a bounded LRU from ``(graph_fingerprint, the options the
  bucket layout depends on)`` to the graph's ``DeviceBucket`` list on the
  service's device. A repeat request for a graph skips the prep; that is
  most of the gain over a loop of per-request sessions.
* **Monotone layouts**: per compatibility key the coalescer keeps the
  union of bucket widths, the largest policy-rounded ``e_pad`` per width
  and the largest vertex count seen. The layout only grows, so once the
  request pool has been seen (or ``warmup()`` has swept it) every group
  of a given size stacks into the same specs and hits the same cached
  batch launch.
* **Power-of-two chunks**: a group of k requests runs as power-of-two
  chunks (7 → 4 + 2 + 1), so a layout has at most log2(max_batch) batch
  launches. A chunk of one is not stacked: the graph's own buckets go
  through the ordinary single-graph launches (the pass-through).

Stacking pads each member bit for bit as ``GraphBatch.from_graphs`` does
(whole rows u = -1, v = -2, which never match). The batch sums are int64
(the reference's int32 sum wraps past 2³¹, R5).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch

# the engine's LRU and bucket helpers are shared on purpose: the coalescer
# must resolve strategies and pad rows exactly as GraphBatch.from_graphs
# does, or coalesced counts would drift from the front door's
from repro_torch.core.engine import (
    _BoundedLRU,
    _pad_bucket_rows,
    _resolve_bucket_strategy,
    get_batch_executable,
    get_executable,
)
from repro_torch.core import prep
from repro_torch.graphs.device import resolve_device

__all__ = ["Coalescer", "PreppedGraph", "prep_cache_key"]


@dataclass
class PreppedGraph:
    """One graph's device-resident prep, reusable across requests."""

    buckets: List[Any]  # List[DeviceBucket]
    n: int
    name: str
    divisor: int  # 6 for the full variant, else 1


def prep_cache_key(fingerprint: str, options) -> tuple:
    """The prep cache key: the graph's content and every option the bucket
    layout depends on (variant, widths, shape policy). Strategy and bitmap
    knobs resolve at dispatch, so they do not key the prep: forcing
    ``strategy="probe"`` reuses the same buckets."""
    return (fingerprint, options.variant, options.widths,
            options.resolved_shape_policy.key())


@dataclass
class _Layout:
    """The monotone stacked layout of one compatibility key."""

    e_pads: Dict[int, int] = field(default_factory=dict)  # width -> e_pad
    max_n: int = 0

    def absorb(self, pg: PreppedGraph) -> None:
        self.max_n = max(self.max_n, pg.n)
        for b in pg.buckets:
            self.e_pads[b.width] = max(self.e_pads.get(b.width, 0), b.e_pad)


def _pow2_chunks(k: int) -> List[int]:
    """k as descending powers of two (7 -> [4, 2, 1])."""
    out, p = [], 1
    while p * 2 <= k:
        p *= 2
    while k:
        if p <= k:
            out.append(p)
            k -= p
        p //= 2
    return out


class Coalescer:
    """Grouped counting over the bounded prep cache, on one device
    (thread-safe; the service calls it from its dispatcher thread).

    Args:
      plan_cache_size: the prep cache's bound, in graphs (not bytes).
      device: where the preps live and the kernels run; None means the
        card (``device="cpu"`` runs the plain versions).
    """

    def __init__(self, plan_cache_size: int = 128, *,
                 device: Union[None, str, torch.device] = None):
        self.device = resolve_device(device)
        self._plans = _BoundedLRU(plan_cache_size)
        self._layouts: Dict[tuple, _Layout] = {}
        self._lock = threading.Lock()

    # -- prep ---------------------------------------------------------------

    def prep(self, g, fingerprint: str, options) -> PreppedGraph:
        """The graph's ``DeviceBucket`` list, through the bounded cache."""
        key = prep_cache_key(fingerprint, options)

        def build() -> PreppedGraph:
            buckets = prep.prepare_intersection_buckets_device(
                g, variant=options.variant, widths=options.widths,
                policy=options.resolved_shape_policy, device=self.device,
            )
            return PreppedGraph(
                buckets=buckets, n=int(g.n), name=g.name,
                divisor=6 if options.variant == "full" else 1,
            )

        return self._plans.get_or_build(key, build)

    def cache_info(self) -> dict:
        """The prep cache's size/hits/misses/maxsize/evictions."""
        return self._plans.info()

    # -- counting -----------------------------------------------------------

    def _frozen_layout(self, compat_key: tuple,
                       prepped: Sequence[PreppedGraph]
                       ) -> Tuple[Dict[int, int], int]:
        """Grow ``compat_key``'s layout by ``prepped`` and return this
        dispatch's view of it: (width -> e_pad, id range)."""
        with self._lock:
            layout = self._layouts.setdefault(compat_key, _Layout())
            for pg in prepped:
                layout.absorb(pg)
            return dict(layout.e_pads), layout.max_n + 2

    def count_group(self, compat_key: tuple, prepped: Sequence[PreppedGraph],
                    options) -> Tuple[List[int], List[int]]:
        """Count a compatible group; returns (counts, chunk_sizes), both
        aligned with ``prepped``: ``chunk_sizes[i]`` is the size of the
        launch group that served request i."""
        e_pads, id_range = self._frozen_layout(compat_key, prepped)
        counts: List[int] = []
        chunk_sizes: List[int] = []
        pos = 0
        for size in _pow2_chunks(len(prepped)):
            chunk = prepped[pos:pos + size]
            pos += size
            if size == 1:
                counts.append(self._count_single(chunk[0], options))
            else:
                counts.extend(self._count_batch(chunk, options, e_pads,
                                                id_range))
            chunk_sizes.extend([size] * size)
        return counts, chunk_sizes

    def _count_single(self, pg: PreppedGraph, options) -> int:
        """The single-request pass-through: the graph's own bucket shapes
        through the ordinary per-bucket launches (those every session
        plan shares), summed on the device, one host sync."""
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for b in pg.buckets:
            strat, bits = _resolve_bucket_strategy(
                b.width, pg.n + 2, options.strategy, options.bitmap_bits
            )
            fn = get_executable("intersection", options.backend, b.shape,
                                strategy=strat, bitmap_bits=bits)
            total += fn(b.u_lists, b.v_lists)
        total = int(total)
        if pg.divisor != 1:
            assert total % pg.divisor == 0, total
            total //= pg.divisor
        return total

    def _count_batch(self, chunk: Sequence[PreppedGraph], options,
                     e_pads: Dict[int, int], id_range: int) -> List[int]:
        """Stack ``chunk`` into the layout, (k, e_pad, W) a width on the
        device, and count it with one launch per width and one host sync.
        A width a member lacks becomes all-padding rows; the stacks are
        built anew for each dispatch."""
        specs, arrays = [], []
        for w in sorted(e_pads):
            e_pad = e_pads[w]
            us, vs = [], []
            for pg in chunk:
                b = next((b for b in pg.buckets if b.width == w), None)
                if b is None:
                    us.append(torch.full((e_pad, w), -1, dtype=torch.int32,
                                         device=self.device))
                    vs.append(torch.full((e_pad, w), -2, dtype=torch.int32,
                                         device=self.device))
                else:
                    us.append(_pad_bucket_rows(b.u_lists, e_pad, -1))
                    vs.append(_pad_bucket_rows(b.v_lists, e_pad, -2))
            strat, bits = _resolve_bucket_strategy(
                w, id_range, options.strategy, options.bitmap_bits
            )
            specs.append((strat, bits, (e_pad, w)))
            arrays.extend([torch.stack(us), torch.stack(vs)])
        if not specs:
            return [0] * len(chunk)
        fn = get_batch_executable(tuple(specs), options.backend, len(chunk))
        out = fn(*arrays).tolist()
        divisor = 6 if options.variant == "full" else 1
        if divisor != 1:
            assert all(c % divisor == 0 for c in out), out
            out = [c // divisor for c in out]
        return out

    # -- warmup -------------------------------------------------------------

    def warmup(self, compat_key: tuple, graphs_with_fps: Sequence[tuple],
               options, max_batch: int) -> float:
        """Fill everything steady state needs for a request pool: prep and
        cache every graph (fixing the monotone layout), run each through
        the single pass-through, and run one batch of each power-of-two
        size ≤ ``max_batch``. Serving any mix of pool graphs in any group
        size then builds no launch configuration. Returns the wall-clock
        seconds spent."""
        t0 = time.perf_counter()
        prepped = [self.prep(g, fp, options) for g, fp in graphs_with_fps]
        e_pads, id_range = self._frozen_layout(compat_key, prepped)
        for pg in prepped:
            self._count_single(pg, options)
        size = 2
        while size <= max_batch:
            chunk = [prepped[i % len(prepped)] for i in range(size)]
            self._count_batch(chunk, options, e_pads, id_range)
            size *= 2
        return time.perf_counter() - t0
