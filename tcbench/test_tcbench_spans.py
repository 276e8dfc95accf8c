"""The span reduction (``tcbench.spans``) on the CPU: synthetic event
lists with known answers, the trace summary and the readers left as they
were by the program's spans, and a real CPU profile of two counts.
"""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from tcbench import harness, spans, spec
from tcbench.trace import Trace

STAGE = "tc.stage probe w512"


def _reduce(sp, device=(), gaps=(), marks=(), window=(0, 1000)):
    return spans.reduce([s + (1,) if len(s) == 3 else s for s in sp],
                        list(device), list(gaps), list(marks), window)


# a count: tc.count ⊃ tc.plan.count ⊃ (a stage ⊃ tc.launch), tc.sync
COUNT = [(0, 100, "tc.count"), (10, 90, "tc.plan.count"),
         (20, 60, STAGE), (25, 35, "tc.launch"), (70, 85, "tc.sync")]


def test_device_ops_go_to_the_innermost_span_but_the_launch():
    device = [(200, 210, 30, 7),     # launched inside tc.launch: the stage
              (210, 230, 50, 7),     # inside the stage, after the launch
              (230, 235, 65, 7),     # inside tc.plan.count only
              (240, 250, 150, 7),    # outside every span
              (250, 256, None, None)]  # its launch is not in the trace
    p = _reduce(COUNT, device)
    assert p.device_by_span == pytest.approx({
        STAGE: 30e-9, "tc.plan.count": 5e-9, spans.NO_SPAN: 10e-9,
        spans.NOT_FOUND: 6e-9})
    assert p.by_name[STAGE]["device_s"] == pytest.approx(30e-9)
    assert p.by_name["tc.launch"]["device_s"] == 0
    assert p.count_device_s == pytest.approx(35e-9)
    assert p.count_device_ms() == pytest.approx(35e-9 * 1e3)


def test_a_launch_with_no_enclosing_span_keeps_its_own_name():
    p = _reduce([(0, 10, "tc.launch")], [(20, 30, 5, 1)])
    assert p.device_by_span == pytest.approx({"tc.launch": 10e-9})
    assert p.count_device_s == 0 and p.counts == 0


def test_self_time_is_the_duration_less_the_children():
    p = _reduce(COUNT + [(120, 150, "tc.count")])
    assert p.by_name["tc.count"]["calls"] == 2
    assert p.by_name["tc.count"]["total_s"] == pytest.approx(130e-9)
    assert p.by_name["tc.count"]["self_s"] == pytest.approx((20 + 30) * 1e-9)
    assert p.by_name["tc.plan.count"]["self_s"] == pytest.approx(25e-9)
    assert p.by_name[STAGE]["self_s"] == pytest.approx(30e-9)
    assert p.counts == 2
    assert p.api_self_us() == pytest.approx(25e-9 * 1e6)


def test_idle_goes_to_the_spans_open_over_each_piece_of_a_gap():
    gaps = [(26, 34),     # inside tc.launch, inside the stage
            (40, 60),     # the stage itself
            (80, 96),     # tc.sync to 85, tc.plan.count to 90, tc.count
            (98, 104),    # tc.count to 100, then the harness's count mark
            (300, 400)]   # between counts
    marks = [(0, 105, "count")]
    p = _reduce(COUNT, gaps=gaps, marks=marks)
    assert p.idle_by_span == pytest.approx({
        f"tc.launch in {STAGE}": 8e-9, STAGE: 20e-9, "tc.sync": 5e-9,
        "tc.plan.count": 5e-9, "tc.count": 8e-9, spans.IN_COUNT: 4e-9,
        spans.BETWEEN: 100e-9})
    assert p.by_name["tc.launch"]["idle_s"] == pytest.approx(8e-9)
    # a gap inside one span goes to the span open at its middle
    for a, b in gaps[:2]:
        mid = _reduce(COUNT, gaps=[(a, b)]).idle_by_span
        assert list(mid.values()) == pytest.approx([(b - a) * 1e-9])
    # the idle time inside tc.count spans is their overlap with the gaps
    assert p.count_idle_s == pytest.approx((8 + 20 + 16 + 2) * 1e-9)
    assert p.count_idle_us() == pytest.approx(46e-9 * 1e6)
    assert [k for k, _ in p.top("idle_by_span")][0] == spans.BETWEEN


def test_spans_on_two_threads_and_a_launch_on_a_third():
    # the profiler numbers a runtime call's thread apart from the spans'
    sp = [(0, 100, "tc.count", 1), (10, 90, STAGE, 1),
          (0, 100, "tc.count", 2), (40, 60, "tc.sync", 2)]
    p = _reduce(sp, [(200, 210, 50, 12345), (210, 220, 20, 1)],
                gaps=[(45, 55)])
    assert p.device_by_span == pytest.approx({"tc.sync": 10e-9,
                                              STAGE: 10e-9})
    assert p.idle_by_span == pytest.approx({"tc.sync": 10e-9})
    assert p.counts == 2


def test_window_bounds_spans_and_device_time():
    sp = [(0, 100, "tc.count"), (2000, 2100, "tc.count")]
    p = _reduce(sp, [(900, 1100, 50, 1)], window=(0, 1000))
    assert p.counts == 1
    assert p.device_by_span == pytest.approx({"tc.count": 100e-9})


def test_keys_are_at_most_64_characters():
    long = "tc.stage " + "x" * 80
    p = _reduce([(0, 100, long), (10, 20, "tc.launch")],
                [(200, 210, 50, 1)], gaps=[(12, 18)])
    keys = list(p.device_by_span) + list(p.idle_by_span)
    assert keys and all(len(k) <= spans.KEY_CHARS == 64 for k in keys)
    assert list(p.idle_by_span)[0].startswith("tc.launch in tc.stage x")


def test_readings_are_none_without_count_spans():
    for p in (_reduce([]), _reduce([(0, 10, STAGE)], [(20, 30, 5, 1)],
                                   gaps=[(0, 20)])):
        assert p.counts == 0
        assert p.api_self_us() is None
        assert p.count_idle_us() is None
        assert p.count_device_ms() is None


class _Ev:
    """A Kineto event as ``Trace.summary`` and ``spans.collect`` read it:
    a device operation and its runtime call share a correlation id, and
    both link to the host operation (or span) open at the launch."""

    def __init__(self, name, s, e, *, device=False, annotation=False,
                 corr=0, linked=0, tid=1):
        self._v = (name, s, e, device, annotation, corr, linked, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] \
            else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def start_thread_id(self):
        return self._v[7]


def _events(with_spans: bool):
    """Two counts in a window: a kernel each, launched by a runtime call
    inside an aten op, then an item() sync and its copy; the program's
    spans, with their device-side twins, optionally."""
    out = [_Ev("window", 0, 1000, annotation=True, corr=1)]
    for k, t in enumerate((100, 500)):
        c, op, item = 10 + k, 100 + k, 200 + k
        out += [
            _Ev("count", t, t + 300, annotation=True, corr=2 + k),
            _Ev("aten::sum", t + 20, t + 60, corr=op),
            # a launch through ctypes: the runtime call links to no op
            _Ev("cudaLaunchKernel", t + 30, t + 40, corr=c, tid=4242),
            _Ev("probe_merge_kernel", t + 50, t + 200, device=True, corr=c),
            _Ev("aten::item", t + 210, t + 280, corr=item),
            _Ev("cuMemcpyAsync", t + 230, t + 235, corr=c + 50, linked=item,
                tid=4242),
            _Ev("Memcpy DtoH", t + 240, t + 250, device=True, corr=c + 50,
                linked=item),
        ]
        if with_spans:
            out += [
                _Ev("tc.count", t + 5, t + 295, annotation=True, corr=300),
                _Ev("tc.plan.count", t + 10, t + 290, annotation=True,
                    corr=301),
                _Ev(STAGE, t + 15, t + 70, annotation=True, corr=302),
                _Ev("tc.launch", t + 25, t + 45, annotation=True, corr=303),
                _Ev("tc.sync", t + 205, t + 285, annotation=True, corr=304),
                _Ev(STAGE, t + 50, t + 200, device=True, annotation=True),
            ]
    return out


def _summary(events):
    tr = Trace(True, True)
    results = types.SimpleNamespace(events=lambda: list(events))
    tr._prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))
    return tr.summary()


def _run(trace):
    return harness.Run(
        workload="g.warm", config="g", traffic="warm", mode="resident",
        seed=1, n=9, m_undirected=1000, setup_s=1.0, window_s=1e-6,
        latencies_s=[3e-7, 3e-7], exec_s=[2.8e-7, 2.8e-7], prep_s=[0.1],
        counts=[5, 5], lanes=["intersection"], launches={"intersect.probe": 2},
        failed=0, session_peak_bytes=2**30, process_peak_bytes=2**31,
        device_kind="NVIDIA H100 80GB HBM3",
        peaks=harness.PEAKS["NVIDIA H100 80GB HBM3"], trace=trace,
        setup_phases={}, reference=5, reference_s=0.1)


def test_program_spans_leave_the_trace_summary_and_readers_alone():
    before, after = _summary(_events(False)), _summary(_events(True))
    assert dataclasses.asdict(after) == dataclasses.asdict(before)
    assert before.busy_s == pytest.approx(320e-9)
    for m in spec.bench_spec()["per_layer"] + spec.bench_spec()["end_to_end"]:
        reader = spec.load_named("metrics", m["name"])
        assert reader.read(_run(after)) == reader.read(_run(before)), m


def test_the_events_reduce_to_each_stage_and_sync():
    p = spans.program_spans(spans.collect(_events(True)))
    assert p.counts == 2
    # each kernel goes to the stage that launched it, each copy to the sync
    assert p.device_by_span == pytest.approx({STAGE: 300e-9,
                                              "tc.sync": 20e-9})
    assert p.count_device_ms() == pytest.approx(160e-9 * 1e3)
    # each gap in pieces: up to each kernel, the harness, the front door,
    # the plan and the stage before the launch, the launch, the stage
    # after it; between kernel and copy, and after the copy, the sync, the
    # plan, the front door, the harness
    assert p.idle_by_span == pytest.approx({
        spans.BETWEEN: 400e-9, spans.IN_COUNT: 20e-9, "tc.count": 20e-9,
        "tc.plan.count": 30e-9, STAGE: 30e-9, f"tc.launch in {STAGE}": 40e-9,
        "tc.sync": 140e-9})
    assert sum(p.idle_by_span.values()) == pytest.approx(680e-9)
    # inside each tc.count: 45 ns before its kernel, 40 in the sync, 45
    # after the copy
    assert p.count_idle_us() == pytest.approx(130e-9 * 1e6)
    assert p.api_self_us() == pytest.approx(10e-9 * 1e6)
    assert spans.program_spans(spans.collect(_events(False))).counts == 0


def test_collect_links_each_device_op_to_its_runtime_call():
    ev = spans.collect(_events(True))
    assert ev.window == (0, 1000)
    assert ev.marks == [(100, 400, "count"), (500, 800, "count")]
    assert len(ev.spans) == 10
    assert ev.device == [(150, 300, 130, 4242), (340, 350, 330, 4242),
                         (550, 700, 530, 4242), (740, 750, 730, 4242)]
    assert ev.linked == {"runtime": 4, "host op": 0, "none": 0}
    # without the runtime calls, the host operation an op links to stands
    # in; the ctypes launch links to none, nor does an id nothing carries
    bare = [e for e in _events(False) if not e.name().startswith("cu")]
    bare.append(_Ev("orphan", 900, 910, device=True, corr=998, linked=999))
    got = spans.collect(bare)
    assert got.device == [(150, 300, None, None), (340, 350, 310, 1),
                          (550, 700, None, None), (740, 750, 710, 1),
                          (900, 910, None, None)]
    assert got.linked == {"runtime": 0, "host op": 2, "none": 3}


def test_a_cpu_profile_of_two_counts():
    """The harness's marks around two counts of a CPU session, profiled:
    no device time, every idle gap inside a count is the program's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import TriangleCounter
    from repro_torch.graphs import rmat_graph

    session = TriangleCounter(rmat_graph(8, edge_factor=8, seed=5),
                              device="cpu")
    session.count()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("window"):
            for _ in range(2):
                with record_function("count"):
                    session.count()
    p = spans.program_spans(spans.collect(
        prof.profiler.kineto_results.events()))
    assert p.counts == 2
    assert p.count_device_ms() == 0
    assert p.api_self_us() > 0
    assert p.by_name["tc.plan.count"]["calls"] == 2
    assert p.by_name["tc.sync"]["calls"] == 2
    assert p.count_idle_s == pytest.approx(p.by_name["tc.count"]["total_s"])
    assert sum(p.idle_by_span.values()) > p.count_idle_s
