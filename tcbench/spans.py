"""The program's ``tc.*`` spans in a traced window, and where the device's
busy and idle time went among them.

The program marks its layers with ``record_function`` spans whose names
start with ``tc.`` (``repro_torch.spans``): ``tc.count`` around the front
door's ``count()``, ``tc.plan.count`` inside it, one ``tc.stage ...`` a
stage, ``tc.launch`` around each kernel launch, ``tc.sync`` around the
host sync, and the prep's ``tc.prep.*``. They share the profiler's clock
with the device events and the harness's ``window`` and ``count`` marks.

``collect`` sorts the profiler's events into those inputs; ``reduce`` is
plain interval arithmetic over them, kept apart from the profiler so that
it can be tested without a card; ``program_spans`` runs it over what
``collect`` found:

* A device operation goes to the innermost span other than ``tc.launch``
  that was open on the host when the runtime call that launched it
  started. The launch's host time decides, not the device time, so the
  attribution does not rest on the host's and the device's clocks
  agreeing.
* An idle gap is cut where spans and the harness's marks begin and end,
  and each piece goes to the innermost span open over it (the span open
  at its middle); where that is ``tc.launch``, the key names the
  enclosing span too. A gap from the end of one count's work to the next
  count's first launch thus goes to the sync's tail, the front door, the
  harness and the next count's launches in their shares. This does rest
  on the clocks agreeing: the trace's ``launch_lag_us`` is the check. A
  piece with no span open is the harness's, inside its ``count`` mark or
  between counts.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from tcbench.trace import TOP, busy_intervals, idle_gaps

__all__ = ["COUNT", "LAUNCH", "Collected", "ProgramSpans", "collect",
           "program_spans", "reduce"]

COUNT = "tc.count"
LAUNCH = "tc.launch"
PREFIX = "tc."
KEY_CHARS = 64  # longest key of a breakdown
NO_SPAN = "(no span)"  # a device op launched outside every span
NOT_FOUND = "(launch not traced)"  # a device op whose launch is missing
IN_COUNT = "harness: in count"
BETWEEN = "harness: between counts"

# (start_ns, end_ns, name, host thread)
Span = Tuple[int, int, str, int]
# (device start_ns, device end_ns, launch start_ns or None, launch thread)
DeviceOp = Tuple[int, int, Optional[int], Optional[int]]
Interval = Tuple[int, int]



def _is_runtime(name: str) -> bool:
    """A CUDA runtime (``cudaLaunchKernel``) or driver (``cuLaunchKernel``)
    call, by its name: not every torch release gives an event's kind."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


@dataclasses.dataclass
class Collected:
    """A traced window's events, sorted for ``reduce``.

    Attributes:
      window: the harness's ``window`` mark, or None.
      marks: the harness's ``count`` marks, ``(start, end, "count")``.
      spans: the program's ``tc.*`` spans on the host.
      device: each device operation (kernel, copy, fill) with the host
        start time and thread of what launched it.
      linked: how many device operations were linked to their runtime
        call, how many only to the host operation or span open at the
        launch, and how many to nothing.
    """

    window: Optional[Interval]
    marks: List[Tuple[int, int, str]]
    spans: List[Span]
    device: List[DeviceOp]
    linked: Dict[str, int]


def collect(events: Iterable) -> Collected:
    """Sort ``torch.profiler``'s Kineto events into a ``Collected``.

    A device operation and the runtime (or driver) call that launched it
    share a correlation id: that call's start is the launch. Where the
    trace holds no such call, the launch is the start of the host event
    the device operation's linked correlation id names: the innermost
    torch operation or ``record_function`` open when it was launched.
    """
    import torch

    cpu = torch.autograd.DeviceType.CPU
    window, marks, spans, device = None, [], [], []
    runtime: Dict[int, Tuple[int, int]] = {}
    frontend: Dict[int, Tuple[int, int]] = {}
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() != cpu:
            if not ev.is_user_annotation():
                device.append((s, e, ev.correlation_id(),
                               ev.linked_correlation_id()))
            continue
        name = ev.name()
        if ev.is_user_annotation():
            if name == "window":
                window = (s, e)
            elif name == "count":
                marks.append((s, e, "count"))
            elif name.startswith(PREFIX):
                spans.append((s, e, name, ev.start_thread_id()))
        at = (s, ev.start_thread_id())
        if _is_runtime(name):  # linked to nothing where launched by ctypes
            runtime[ev.correlation_id()] = at
        elif ev.linked_correlation_id() == 0:
            frontend[ev.correlation_id()] = at
    ops, linked = [], {"runtime": 0, "host op": 0, "none": 0}
    for s, e, own, parent in device:
        at = runtime.get(own) if own else None
        if at is not None:
            linked["runtime"] += 1
        else:
            at = frontend.get(parent) if parent else None
            linked["host op" if at is not None else "none"] += 1
        ops.append((s, e) + (at if at is not None else (None, None)))
    return Collected(window=window, marks=marks, spans=spans, device=ops,
                     linked=linked)


@dataclasses.dataclass
class ProgramSpans:
    """Where a traced window's host, device and idle time went among the
    program's spans.

    Attributes:
      by_name: per span name, ``calls``, ``total_s`` (summed durations),
        ``self_s`` (durations less what child spans cover), ``device_s``
        (device time of the operations it launched, as the innermost span
        other than ``tc.launch``) and ``idle_s`` (idle time while it was
        the innermost open span).
      device_by_span: device seconds by key: the span name, ``(no span)``
        or ``(launch not traced)``.
      idle_by_span: idle seconds by key: the span name, ``tc.launch in
        <enclosing span>``, or the harness's share.
      counts: the number of ``tc.count`` spans.
      count_self_s: their summed host self time.
      count_device_s: device time of the operations launched inside them.
      count_idle_s: idle time that falls inside them.
    """

    by_name: Dict[str, Dict[str, float]]
    device_by_span: Dict[str, float]
    idle_by_span: Dict[str, float]
    counts: int
    count_self_s: float
    count_device_s: float
    count_idle_s: float

    def top(self, which: str) -> List[list]:
        """``device_by_span`` or ``idle_by_span`` as ``[key, seconds]``,
        most first, at most ``TOP`` of them."""
        d = getattr(self, which)
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def api_self_us(self) -> Optional[float]:
        """Mean host self time of ``tc.count`` (less ``tc.plan.count``),
        in us."""
        return self.count_self_s / self.counts * 1e6 if self.counts else None

    def count_idle_us(self) -> Optional[float]:
        """Device-idle time inside ``tc.count`` spans a count, in us."""
        return self.count_idle_s / self.counts * 1e6 if self.counts else None

    def count_device_ms(self) -> Optional[float]:
        """Device time of the operations launched inside ``tc.count``
        spans a count, in ms."""
        return self.count_device_s / self.counts * 1e3 if self.counts else None


class _Tree:
    """One host thread's spans, nested: each one's parent, the time its
    children cover, whether it lies in a ``tc.count``, and the innermost
    span open at a given time."""

    def __init__(self, spans: List[Span]):
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _, _ in self.spans]
        self.parent: List[int] = []
        self.child_ns = [0] * len(self.spans)
        self.in_count: List[bool] = []
        stack: List[int] = []
        for i, (s, e, name, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                stack.pop()
            p = stack[-1] if stack else -1
            self.parent.append(p)
            self.in_count.append(name == COUNT
                                 or (p >= 0 and self.in_count[p]))
            if p >= 0:
                self.child_ns[p] += e - s
            stack.append(i)

    def innermost(self, t: int) -> int:
        """The index of the innermost span open at ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] <= t:
            i = self.parent[i]
        return i


def _key(text: str) -> str:
    return text[:KEY_CHARS]


def _overlap(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(spans: Sequence[Span], device: Sequence[DeviceOp],
           gaps: Sequence[Interval], marks: Sequence[Tuple[int, int, str]],
           window: Interval) -> ProgramSpans:
    """Put a window's device time and idle gaps down to the program's
    spans (all times in ns on one clock).

    Spans and device operations are taken where they overlap ``window``,
    and device time is clipped to it, as the trace's busy time is. A launch
    is looked up among the spans of its own host thread where that thread
    has any, else among every thread's (the profiler numbers the threads
    of runtime calls and of spans apart); a piece of an idle gap among
    every thread's. Spans of one thread nest.
    """
    lo, hi = window
    threads: Dict[int, List[Span]] = {}
    for sp in spans:
        if sp[2].startswith(PREFIX) and sp[0] < hi and sp[1] > lo:
            threads.setdefault(sp[3], []).append(sp)
    trees = {tid: _Tree(sps) for tid, sps in threads.items()}

    def innermost(t: int, tid: Optional[int]) -> Tuple[Optional[_Tree], int]:
        if tid in trees:
            return trees[tid], trees[tid].innermost(t)
        best, at = None, -1
        for tree in trees.values():
            i = tree.innermost(t)
            if i >= 0 and (best is None
                           or tree.spans[i][0] > best.spans[at][0]):
                best, at = tree, i
        return best, at

    by_name: Dict[str, Dict[str, float]] = {}
    count_iv: List[Interval] = []
    count_self = 0
    for tree in trees.values():
        for i, (s, e, name, _) in enumerate(tree.spans):
            own = e - s - tree.child_ns[i]
            d = by_name.setdefault(name, dict(calls=0, total_s=0.0,
                                              self_s=0.0, device_s=0.0,
                                              idle_s=0.0))
            d["calls"] += 1
            d["total_s"] += (e - s) * 1e-9
            d["self_s"] += own * 1e-9
            if name == COUNT:
                count_self += own
                count_iv.append((s, e))

    device_by: Dict[str, float] = {}
    count_device = 0
    for s, e, launch, tid in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if launch is None:
            key, name = NOT_FOUND, None
        else:
            tree, i = innermost(launch, tid)
            if i >= 0 and tree.spans[i][2] == LAUNCH \
                    and tree.parent[i] >= 0:
                i = tree.parent[i]
            name = tree.spans[i][2] if i >= 0 else None
            key = name or NO_SPAN
            if i >= 0 and tree.in_count[i]:
                count_device += e - s
        device_by[_key(key)] = device_by.get(_key(key), 0.0) + (e - s) * 1e-9
        if name is not None:
            by_name[name]["device_s"] += (e - s) * 1e-9

    idle_by: Dict[str, float] = {}
    mark_tree = _Tree([(s, e, n, 0) for s, e, n in marks])
    cuts = sorted({t for tree in trees.values() for s, e, _, _ in tree.spans
                   for t in (s, e)} | {t for s, e, _ in marks
                                       for t in (s, e)})
    for a, b in gaps:
        edges = [a] + cuts[bisect.bisect_right(cuts, a):
                           bisect.bisect_left(cuts, b)] + [b]
        for x, y in zip(edges, edges[1:]):
            mid = (x + y) // 2
            tree, i = innermost(mid, None)
            if i < 0:
                key = IN_COUNT if mark_tree.innermost(mid) >= 0 else BETWEEN
            else:
                key = tree.spans[i][2]
                by_name[key]["idle_s"] += (y - x) * 1e-9
                p = tree.parent[i]
                if key == LAUNCH and p >= 0:
                    key = f"{LAUNCH} in {tree.spans[p][2]}"
            idle_by[_key(key)] = idle_by.get(_key(key), 0.0) \
                + (y - x) * 1e-9
    count_idle = _overlap(busy_intervals(count_iv, lo, hi), gaps)

    return ProgramSpans(by_name=by_name, device_by_span=device_by,
                        idle_by_span=idle_by, counts=len(count_iv),
                        count_self_s=count_self * 1e-9,
                        count_device_s=count_device * 1e-9,
                        count_idle_s=count_idle * 1e-9)


def program_spans(ev: Collected) -> Optional[ProgramSpans]:
    """``reduce`` over a traced window's collected events (the harness's
    ``window`` mark bounds it; None without one), with the idle gaps the
    trace summary finds."""
    if ev.window is None:
        return None
    lo, hi = ev.window
    busy = busy_intervals([(s, e) for s, e, _, _ in ev.device], lo, hi)
    return reduce(ev.spans, ev.device, idle_gaps(busy, lo, hi), ev.marks,
                  ev.window)
