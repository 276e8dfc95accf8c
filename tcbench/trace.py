"""The traced run: device activity from ``torch.profiler``, reduced to the
busy time, the kernels that took the most of it and the idle gaps, each gap
labelled with what the host was doing.

The harness marks its own calls with ``record_function``: ``window``
around the measured loop and ``count`` around each call into the program.
Device events (kernels, copies, fills) and those host marks share the
profiler's clock. The reduction is plain interval arithmetic over
``(start_ns, end_ns)`` pairs, kept apart from the profiler so that it can
be tested without a card.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["TraceSummary", "Trace", "busy_intervals", "idle_gaps",
           "label_gaps", "summarise", "top_level"]

Interval = Tuple[int, int]
Named = Tuple[int, int, str]

TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class TraceSummary:
    """What the traced window showed.

    Attributes:
      window_s: the length of the traced window (the harness's ``window``
        mark).
      busy_s: seconds in which some device operation ran, within it.
      device_ops: ``[name, seconds]`` of the operations that took the most
        device time, most first.
      idle_gaps: ``[label, seconds]``: idle device time summed by what the
        host was doing, most first.
      timer: "profiler", or "cuda_events" where the profiler gave no
        device event and CUDA events around each count stood in.
      launch_lag_us: the least and the median time from the start of a
        host operation to the start of a device operation it launched, and
        the share of such pairs whose lag is negative: a check that the
        host's and the device's clocks agree, on which the gaps' labels
        rest. Where many lags are negative the labels are not to be
        trusted; the busy time and the idle share are the device's own.
    """

    window_s: float
    busy_s: float
    device_ops: List[list]
    idle_gaps: List[list]
    timer: str = "profiler"
    launch_lag_us: Optional[Tuple[float, float, float]] = None


def busy_intervals(intervals: Sequence[Interval], lo: int,
                   hi: int) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], sorted and
    disjoint."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of [lo, hi] that no busy interval covers."""
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def top_level(spans: Sequence[Named]) -> List[Named]:
    """The outermost of nested host spans: sorted, disjoint."""
    out: List[Named] = []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if not out or s >= out[-1][1]:
            out.append((s, e, name))
    return out


def _covering(spans: List[Named], starts: List[int],
              t: int) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] > t:
        return spans[i][2]
    return None


def label_gaps(gaps: Sequence[Interval], marks: Sequence[Named],
               host_ops: Sequence[Named]) -> Dict[str, float]:
    """Idle seconds by label. A gap is labelled by the harness mark open at
    its middle ("count", or "harness" between counts) and the outermost
    host operation running then ("python" where none is): ``count:
    aten::zeros``."""
    marks, ops = top_level(marks), top_level(host_ops)
    mark_starts, op_starts = [m[0] for m in marks], [o[0] for o in ops]
    out: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        mark = _covering(marks, mark_starts, mid) or "harness"
        op = _covering(ops, op_starts, mid) or "python"
        label = f"{mark}: {op}"
        out[label] = out.get(label, 0.0) + (e - s) * 1e-9
    return out


def summarise(device: Sequence[Named], window: Interval,
              marks: Sequence[Named], host_ops: Sequence[Named],
              timer: str = "profiler") -> TraceSummary:
    """Reduce a window's device events and host spans (all in ns on one
    clock) to a ``TraceSummary``."""
    lo, hi = window
    busy = busy_intervals([(s, e) for s, e, _ in device], lo, hi)
    by_name: Dict[str, float] = {}
    for s, e, name in device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    gaps = label_gaps(idle_gaps(busy, lo, hi), marks, host_ops)
    return TraceSummary(
        window_s=(hi - lo) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        device_ops=[[k, v] for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[k, v] for k, v in sorted(gaps.items(),
                                            key=lambda kv: -kv[1])[:TOP]],
        timer=timer,
    )


class Trace:
    """``torch.profiler`` over the measured window, or nothing.

    ``mark(name)`` gives the context that marks one harness call.
    ``start()`` and ``stop()`` bracket the window; ``summary()`` reduces
    what was recorded. With ``enabled=False`` every method is inert.
    """

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self._prof = None
        self._window = None
        self._events: List[tuple] = []  # (start, end) CUDA events a count

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = record_function("window")
        self._window.__enter__()

    def mark(self, name: str):
        if not self.enabled:
            return _NULL
        from torch.profiler import record_function
        return record_function(name)

    def cuda_pair(self):
        """A (start, end) pair of CUDA events to record around one count,
        kept for the fallback timer; None when not traced on a card."""
        if not (self.enabled and self.cuda):
            return None
        import torch
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        self._events.append(pair)
        return pair

    def stop(self) -> None:
        if not self.enabled:
            return
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def summary(self) -> Optional[TraceSummary]:
        if not self.enabled:
            return None
        import torch
        results = self._prof.profiler.kineto_results
        device, marks, host, window = [], [], [], None
        launched, started = {}, {}  # host op id -> its start; its device ops'
        for ev in results.events():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() != torch.autograd.DeviceType.CPU:
                if not ev.is_user_annotation():
                    device.append((s, e, ev.name()))
                    c = ev.linked_correlation_id()
                    started[c] = min(s, started.get(c, s))
            elif ev.is_user_annotation():
                if ev.name() == "window":
                    window = (s, e)
                elif ev.name() == "count":
                    marks.append((s, e, "count"))
            else:
                host.append((s, e, ev.name()))
                launched[ev.correlation_id()] = s
        if window is None:
            raise RuntimeError("the profiler recorded no 'window' mark")
        if device or not self._events:
            out = summarise(device, window, marks, host)
            lags = sorted(started[c] - launched[c] for c in started
                          if c and c in launched)
            if lags:
                out.launch_lag_us = (lags[0] * 1e-3,
                                     lags[len(lags) // 2] * 1e-3,
                                     sum(x < 0 for x in lags) / len(lags))
            return out
        # no device event: each count's CUDA-event span stands in, so busy
        # time counts the device's own gaps inside a count as busy
        torch.cuda.synchronize()
        busy_s = sum(a.elapsed_time(b) for a, b in self._events) * 1e-3
        win_s = (window[1] - window[0]) * 1e-9
        return TraceSummary(window_s=win_s, busy_s=min(busy_s, win_s),
                            device_ops=[["count (CUDA events)", busy_s]],
                            idle_gaps=[], timer="cuda_events")


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()
