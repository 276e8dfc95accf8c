"""Bounded admission: the queue between ``submit()`` and the dispatcher.

Admission control is where the service keeps its two hard promises — never
OOM (depth is bounded; request ``max_queue_depth + 1`` is rejected at the
door, not buffered) and never hang (every request either completes, fails
with its own error, or fails fast with a typed ``RequestShed`` carrying the
reason). The dispatcher side adds the coalescing hook:
``take_compatible`` pulls every queued request sharing a compatibility key
without disturbing the FIFO order of the rest, which is how a batching
window fills from work that is *already waiting* instead of re-sorting the
whole queue.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

__all__ = [
    "AdmissionQueue",
    "QueuedRequest",
    "RequestShed",
    "SHED_DEADLINE",
    "SHED_QUEUE_FULL",
    "SHED_SHUTDOWN",
]

SHED_QUEUE_FULL = "queue-full"
SHED_DEADLINE = "deadline"
SHED_SHUTDOWN = "shutdown"


class RequestShed(RuntimeError):
    """A request the service rejected instead of serving.

    ``reason`` is one of ``"queue-full"`` (admission depth exceeded),
    ``"deadline"`` (the request's deadline budget expired before execution
    started), or ``"shutdown"`` (the service is stopping). Raised out of
    the request's future, never silently dropped.
    """

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"request shed ({reason})"
                         + (f": {detail}" if detail else ""))


@dataclasses.dataclass
class QueuedRequest:
    """One admitted request, queue-resident until dispatch."""

    request_id: int
    kind: str              # "count" | "vertex" | "edge_support" | "k_truss"
    #                        | "update"
    tenant: str
    graph: Any             # Graph for graph kinds; None for "update"
    options: Any           # resolved CountOptions
    compat_key: Optional[tuple]  # non-None => coalescible count request
    fingerprint: Optional[str]   # graph content hash (session/plan reuse)
    payload: Dict[str, Any]      # kind-specific extras (k, updates, handle)
    future: Future = dataclasses.field(default_factory=Future)
    submitted: float = dataclasses.field(default_factory=time.perf_counter)
    deadline: Optional[float] = None  # absolute perf_counter seconds

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline


class AdmissionQueue:
    """A bounded FIFO with load-shedding admission and compatible-take.

    ``offer`` returns None on admission or the shed reason string when the
    request must be rejected (queue at ``max_depth``, queue closed, or the
    request's deadline already expired at the door) — the caller owns
    failing the future, the queue never buffers a rejected request.
    """

    def __init__(self, max_depth: int):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = int(max_depth)
        self._items: "deque[QueuedRequest]" = deque()
        self._lock = threading.Lock()
        self._arrival = threading.Condition(self._lock)
        self._closed = False

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def offer(self, req: QueuedRequest) -> Optional[str]:
        """Admit ``req`` (None) or return the shed reason."""
        now = time.perf_counter()
        with self._lock:
            if self._closed:
                return SHED_SHUTDOWN
            if req.expired(now):
                return SHED_DEADLINE
            if len(self._items) >= self.max_depth:
                return SHED_QUEUE_FULL
            self._items.append(req)
            self._arrival.notify_all()
            return None

    def pop(self, timeout: Optional[float] = None) -> Optional[QueuedRequest]:
        """Head of the queue, waiting up to ``timeout`` for an arrival;
        None on timeout (or immediately when closed and empty)."""
        with self._lock:
            if not self._items and not self._closed:
                self._arrival.wait(timeout)
            if self._items:
                return self._items.popleft()
            return None

    def take_compatible(self, compat_key: tuple,
                        limit: int) -> List[QueuedRequest]:
        """Remove and return up to ``limit`` queued requests whose
        ``compat_key`` equals ``compat_key`` (queue order), leaving the
        relative order of everything else untouched."""
        taken: List[QueuedRequest] = []
        if limit <= 0:
            return taken
        with self._lock:
            kept: "deque[QueuedRequest]" = deque()
            while self._items:
                r = self._items.popleft()
                if len(taken) < limit and r.compat_key == compat_key:
                    taken.append(r)
                else:
                    kept.append(r)
            self._items = kept
        return taken

    def wait_for_arrival(self, timeout: float) -> None:
        """Block up to ``timeout`` for the next ``offer`` (or close)."""
        with self._lock:
            self._arrival.wait(timeout)

    def close(self) -> None:
        """Stop admitting; queued items stay poppable (drain)."""
        with self._lock:
            self._closed = True
            self._arrival.notify_all()

    def drain(self) -> List[QueuedRequest]:
        """Remove and return everything still queued (shutdown shedding)."""
        with self._lock:
            items = list(self._items)
            self._items.clear()
            return items
