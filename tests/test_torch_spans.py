"""The program's ``tc.*`` spans (``repro_torch.spans``) on the CPU.

With no profiler recording, ``span()`` hands out one inert object and never
calls ``record_function``. Under ``torch.profiler`` a session's prep
records ``tc.prep`` and its sub-stages, and each count ``tc.count`` ⊃
``tc.plan.count`` ⊃ one ``tc.stage …`` a stage (named by the stage's
strategy and width, or the lane's block), then ``tc.sync``. Counts are the
same with the profiler on and off.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import TriangleCounter, triangle_count_scipy
from repro_torch.core.engine import clear_caches
from repro_torch.graphs import rmat_graph

CPU = "cpu"
PREP = ("tc.prep.upload", "tc.prep.orient", "tc.prep.bucket_sort",
        "tc.prep.neighbors", "tc.prep.gather", "tc.prep.bind",
        "tc.prep.sync")


@pytest.fixture(scope="module")
def g():
    return rmat_graph(9, edge_factor=8, seed=3)


def _recorded(fn):
    """Run ``fn`` under a CPU profiler; its ``tc.*`` spans as (start, end,
    name), sorted, and what ``fn`` returned."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name().startswith("tc.")]
    return sorted(evs, key=lambda x: (x[0], -x[1])), out


def _inside(spans_, outer):
    s0, e0, _ = outer
    return [x for x in spans_ if s0 <= x[0] and x[1] <= e0 and x != outer]


def _children(spans_, outer):
    """The spans directly inside ``outer``."""
    inner = _inside(spans_, outer)
    return [x for x in inner
            if not any(y != x and y[0] <= x[0] and x[1] <= y[1]
                       for y in inner)]


def test_no_profiler_no_record_function(monkeypatch, g):
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span("tc.a") is spans.span("tc.b")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    session = TriangleCounter(g, device=CPU)
    assert session.count().count == session.count().count \
        == triangle_count_scipy(g)


def test_prep_and_count_spans_nest(g):
    def run():
        session = TriangleCounter(g, device=CPU)
        first = session.count()
        return first, session.count()

    recorded, (first, second) = _recorded(run)
    names = [n for _, _, n in recorded]
    counts = [x for x in recorded if x[2] == "tc.count"]
    assert len(counts) == 2
    # the first count builds the plan inside itself
    prep = [x for x in recorded if x[2] == "tc.prep"]
    assert len(prep) == 1 and prep[0] in _inside(recorded, counts[0])
    assert {n for _, _, n in _inside(recorded, prep[0])} >= set(PREP)
    assert names.count("tc.prep.gather") == len(first.meta["bucket_shapes"])
    assert names.count("tc.prep.sync") == 1
    # the second: tc.count ⊃ tc.plan.count ⊃ a span a stage, then tc.sync
    (plan_count,) = _children(recorded, counts[1])
    assert plan_count[2] == "tc.plan.count"
    kids = _children(recorded, plan_count)
    stages = [f"tc.stage {s} w{w}" for w, s in second.bucket_strategies]
    assert [n for _, _, n in kids] == stages + ["tc.sync"]
    assert all(len(n) < 40 for n in stages)
    assert first.count == second.count == triangle_count_scipy(g)


@pytest.mark.parametrize("lane,options,stage", [
    ("intersection", dict(strategy="probe"), "tc.stage probe w{w}"),
    ("intersection", dict(strategy="bitmap"), "tc.stage bitmap w{w}"),
    ("intersection", dict(max_device_bytes=1 << 13),
     "tc.stage {s} w{w} tiled"),
    ("matrix", dict(block=32), "tc.stage matrix b32"),
    ("hash", {}, "tc.stage hash w{w}"),
])
def test_stage_spans_name_the_strategy_and_width(g, lane, options, stage):
    session = TriangleCounter(g, device=CPU, algorithm=lane, **options)
    session.plan  # prep outside the profile
    recorded, res = _recorded(session.count)
    got = [n for _, _, n in recorded if n.startswith("tc.stage")]
    if lane == "matrix":
        want = [stage]
    elif lane == "hash":
        want = [stage.format(w=k[1]) for k in res.meta["bucket_shapes"]]
    else:
        tiled = {t["shape"] for t in res.meta.get("tiled_buckets", [])}
        want = [(stage if k in tiled or "tiled" not in stage
                 else "tc.stage {s} w{w}").format(s=s, w=w)
                for k, (w, s) in zip(res.meta["bucket_shapes"],
                                     res.bucket_strategies)]
        if "tiled" in stage:
            assert any("tiled" in n for n in got)
    assert got == want
    assert res.count == triangle_count_scipy(g)


def test_a_cache_miss_records_its_build(g):
    clear_caches()
    session = TriangleCounter(g, device=CPU)
    recorded, _ = _recorded(lambda: session.plan)
    builds = [x for x in recorded if x[2] == "tc.cache.build"]
    (bind,) = [x for x in recorded if x[2] == "tc.prep.bind"]
    assert len(builds) == len(session.plan.stages)
    assert all(b in _inside(recorded, bind) for b in builds)
    again, _ = _recorded(lambda: TriangleCounter(g, device=CPU).plan)
    assert not [x for x in again if x[2] == "tc.cache.build"]


def test_counts_equal_with_and_without_the_profiler(g):
    plain = TriangleCounter(g, device=CPU).count().count
    _, traced = _recorded(lambda: TriangleCounter(g, device=CPU).count())
    assert traced.count == plain == triangle_count_scipy(g)
