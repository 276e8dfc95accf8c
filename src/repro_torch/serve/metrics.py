"""Serving metrics: counters, bounded latency stats, one snapshot dict.

The service records every request's queue-wait / execution / total latency,
admission outcomes (offered / completed / shed-by-reason / errors), and
coalescing effectiveness (device dispatches vs requests they carried).
``MetricsRegistry.snapshot()`` folds in the engine's launch-configuration
cache counters so a single dict answers three questions of a load step:
how long do requests wait (p50/p99), how many ride per device dispatch
(coalesce factor), and does steady state build any new launch
configuration (hit/miss deltas).

Everything here is thread-safe under one lock per object; the histograms
keep a bounded reservoir of the most recent samples (default 4096) so a
long-lived service never grows without bound.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, List, Optional

__all__ = ["LatencyStat", "MetricsRegistry", "quantile"]

DEFAULT_RESERVOIR = 4096


def quantile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank quantile of an ascending-sorted non-empty list."""
    if not sorted_values:
        raise ValueError("quantile of an empty sample")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    n = len(sorted_values)
    rank = min(n, max(1, int(math.ceil(q * n))))
    return float(sorted_values[rank - 1])


class LatencyStat:
    """One latency series: exact count/total/max plus a bounded reservoir
    of the most recent samples for the quantile snapshot."""

    def __init__(self, reservoir: int = DEFAULT_RESERVOIR):
        if reservoir < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir}")
        self._lock = threading.Lock()
        self._recent: "deque[float]" = deque(maxlen=reservoir)
        self._count = 0
        self._total = 0.0
        self._max = 0.0

    def record(self, seconds: float) -> None:
        s = float(seconds)
        with self._lock:
            self._recent.append(s)
            self._count += 1
            self._total += s
            if s > self._max:
                self._max = s

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> dict:
        """``{count, mean_ms, p50_ms, p90_ms, p99_ms, max_ms}`` (zeros when
        no sample has landed); quantiles come from the bounded reservoir,
        count/mean/max from the exact running totals."""
        with self._lock:
            count, total, mx = self._count, self._total, self._max
            recent = sorted(self._recent)
        if not count:
            return dict(count=0, mean_ms=0.0, p50_ms=0.0, p90_ms=0.0,
                        p99_ms=0.0, max_ms=0.0)
        return dict(
            count=count,
            mean_ms=1e3 * total / count,
            p50_ms=1e3 * quantile(recent, 0.50),
            p90_ms=1e3 * quantile(recent, 0.90),
            p99_ms=1e3 * quantile(recent, 0.99),
            max_ms=1e3 * mx,
        )


class MetricsRegistry:
    """Named counters + named latency series behind one lock.

    Counter names the service uses (all monotone):
      offered / accepted / completed / errors — request admission outcomes
      shed, shed_queue-full, shed_deadline, shed_shutdown — load-shedding,
        total and by reason
      dispatches / dispatched_requests — device dispatches and the requests
        they carried; their ratio is the coalesce factor
      coalesced_requests — requests that shared a dispatch with >= 1 other
    Latency series: queue_wait / exec / total (seconds in, ms out).
    """

    def __init__(self, reservoir: int = DEFAULT_RESERVOIR):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._latency: Dict[str, LatencyStat] = {}
        self._reservoir = int(reservoir)

    def inc(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(delta)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            stat = self._latency.get(name)
            if stat is None:
                stat = self._latency[name] = LatencyStat(self._reservoir)
        stat.record(seconds)

    def latency(self, name: str) -> Optional[LatencyStat]:
        with self._lock:
            return self._latency.get(name)

    def coalesce_factor(self) -> float:
        """Mean requests per device dispatch (1.0 = no coalescing yet)."""
        with self._lock:
            d = self._counters.get("dispatches", 0)
            r = self._counters.get("dispatched_requests", 0)
        return (r / d) if d else 1.0

    def snapshot(self) -> dict:
        """One plain dict: counters, per-series latency stats, the coalesce
        factor, and the engine's cache counters (so callers can assert
        that steady state builds no new launch configuration)."""
        from repro_torch.core.engine import executable_cache_info

        with self._lock:
            counters = dict(self._counters)
            latency = dict(self._latency)
        return dict(
            counters=counters,
            latency={name: stat.snapshot() for name, stat in latency.items()},
            coalesce_factor=self.coalesce_factor(),
            engine_cache=executable_cache_info(),
        )
