"""The port's ``TriangleService`` equals the reference's on the CPU.

``repro_torch.serve`` against ``repro.serve``: every request kind's
``ServeResult.count`` / ``value`` on the same graphs, the power-of-two
chunk decomposition and ``Coalescer.count_group``'s chunk sizes for
groups of 1–8, the nearest-rank quantile, the ``snapshot()`` key set,
the ``ServeConfig`` and ``submit`` errors, shedding, draining, no launch
configuration built after ``warmup()``, racing submissions sharing one
prep, the bounded prep cache, dynamic updates in order, and ``auto``
through the measured chooser. The mirror of ``tests/test_serve.py``.
Coalescing is asserted under the reference's wide 250 ms window.
"""

import importlib
import threading

import numpy as np
import pytest

from torch_reference import ref  # noqa: F401

from repro_torch.core import (
    CalibrationTable,
    CountOptions,
    DynamicTriangleCounter,
    TriangleCounter,
    clear_caches,
    executable_cache_info,
    graph_fingerprint,
    set_default_table,
    triangle_count_scipy,
)
from repro_torch.graphs import rmat_graph
from repro_torch.serve import (
    KINDS,
    SHED_DEADLINE,
    SHED_QUEUE_FULL,
    SHED_SHUTDOWN,
    Coalescer,
    RequestShed,
    ServeConfig,
    ServeResult,
    TriangleService,
)
from repro_torch.serve.coalescer import _pow2_chunks, prep_cache_key
from repro_torch.serve.metrics import LatencyStat, quantile

CPU = "cpu"
POOL = [rmat_graph(6, 6, seed=510 + i, name=f"serve-t{i}") for i in range(4)]
ORACLE = [triangle_count_scipy(g) for g in POOL]
OPTS = CountOptions(algorithm="intersection")
WIDE = ServeConfig(batch_window_ms=250.0, max_batch=8)
UPDATES = [[(0, 1), (1, 2), (0, 2)], [(3, 4), (4, 5), (3, 5), (0, 1, False)]]


def _svc(config=WIDE, options=OPTS, **overrides):
    return TriangleService(options, config=config, device=CPU, **overrides)


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _serve_all(service, graphs, make_graph=lambda g: g):
    """Every kind on ``graphs`` through one started service; returns
    {kind: [ServeResult, ...]} and the snapshot."""
    out = {}
    with service as svc:
        gs = [make_graph(g) for g in graphs]
        out["count"] = [f.result(timeout=120) for f in
                        [svc.submit("count", g) for g in gs]]
        out["vertex"] = [svc.submit("vertex", g).result(timeout=120)
                         for g in gs]
        out["edge_support"] = [svc.submit("edge_support", g).result(
            timeout=120) for g in gs]
        out["k_truss"] = [svc.submit("k_truss", g, k=3).result(timeout=120)
                          for g in gs]
        handle = svc.open_dynamic_session(gs[2], tenant="dyn")
        out["update"] = [svc.submit("update", handle=handle,
                                    updates=u).result(timeout=120)
                         for u in UPDATES]
        svc.close_dynamic_session(handle)
        snap = svc.snapshot()
    return out, snap


@pytest.fixture(scope="module")
def served(ref):
    mine = _serve_all(_svc(), POOL)
    ropts = ref.options.CountOptions(algorithm="intersection")
    theirs = _serve_all(
        ref.service.TriangleService(ropts, config=ref.service.ServeConfig(
            batch_window_ms=250.0, max_batch=8)),
        POOL, lambda g: _ref_graph(ref, g))
    return mine, theirs


# --- every kind against the reference ---------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_kind_matches_reference(served, kind):
    (mine, _), (theirs, _) = served
    assert len(mine[kind]) == len(theirs[kind])
    for a, b in zip(mine[kind], theirs[kind]):
        assert isinstance(a, ServeResult) and a.kind == b.kind == kind
        assert a.count == b.count
        assert a.algorithm == b.algorithm
        if kind == "vertex":
            assert a.value.dtype == np.int64
            np.testing.assert_array_equal(a.value, np.asarray(b.value))
        elif kind == "edge_support":
            for x, y in zip(a.value, b.value):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        elif kind == "k_truss":
            assert a.value.n == b.value.n
            np.testing.assert_array_equal(a.value.row_ptr, b.value.row_ptr)
            np.testing.assert_array_equal(a.value.col_idx, b.value.col_idx)
        else:
            assert a.value is None and b.value is None
    if kind == "count":
        assert [r.count for r in mine[kind]] == ORACLE
    if kind == "update":
        assert all(r.batch_size == 1 for r in mine[kind])


def test_snapshot_key_set_matches_reference(served):
    (_, snap), (_, ref_snap) = served
    assert set(snap) == set(ref_snap)
    assert set(snap["counters"]) == set(ref_snap["counters"])
    assert snap["counters"] == ref_snap["counters"]
    assert set(snap["latency"]) == set(ref_snap["latency"])
    for name, stat in snap["latency"].items():
        assert set(stat) == set(ref_snap["latency"][name])
    for part in ("engine_cache", "plan_cache", "session_cache"):
        assert set(snap[part]) == set(ref_snap[part])
    assert snap["session_cache"] == ref_snap["session_cache"]


# --- unit pieces ---------------------------------------------------------------


def test_pow2_chunks_match_reference(ref):
    assert _pow2_chunks(7) == [4, 2, 1]
    for k in range(1, 65):
        assert _pow2_chunks(k) == ref.coalescer._pow2_chunks(k)


@pytest.mark.parametrize("size", range(1, 9))
def test_count_group_chunks_match_reference(ref, size):
    coal = Coalescer(device=CPU)
    rcoal = ref.coalescer.Coalescer()
    ropts = ref.options.CountOptions(algorithm="intersection")
    group = [POOL[i % 4] for i in range(size)]
    prepped = [coal.prep(g, graph_fingerprint(g), OPTS) for g in group]
    rprepped = [rcoal.prep(_ref_graph(ref, g), graph_fingerprint(g), ropts)
                for g in group]
    counts, chunks = coal.count_group(("count", "intersection", OPTS.key()),
                                      prepped, OPTS)
    rcounts, rchunks = rcoal.count_group(
        ("count", "intersection", ropts.key()), rprepped, ropts)
    assert chunks == rchunks
    assert counts == [int(c) for c in rcounts] == \
        [ORACLE[i % 4] for i in range(size)]
    for pg, rpg in zip(prepped, rprepped):
        assert [b.shape for b in pg.buckets] == [b.shape for b in rpg.buckets]


def test_quantile_and_latency_stat_match_reference(ref):
    rng = np.random.default_rng(3)
    vals = sorted(float(v) for v in rng.random(101))
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert quantile(vals, q) == ref.metrics.quantile(vals, q)
    assert quantile(sorted(float(v) for v in range(1, 101)), 0.99) == 99.0
    with pytest.raises(ValueError, match="empty sample"):
        quantile([], 0.5)
    with pytest.raises(ValueError, match="q must be in"):
        quantile([1.0], 1.5)
    a, b = LatencyStat(reservoir=8), ref.metrics.LatencyStat(reservoir=8)
    assert a.snapshot() == b.snapshot()
    for v in vals[:20]:
        a.record(v)
        b.record(v)
    assert a.snapshot() == b.snapshot()


def test_serve_config_errors_match_reference(ref):
    for kw in (dict(max_queue_depth=0), dict(batch_window_ms=-1.0),
               dict(max_batch=0), dict(default_deadline_ms=0.0),
               dict(plan_cache_size=0), dict(session_cache_size=-1)):
        with pytest.raises(ValueError) as mine:
            ServeConfig(**kw)
        with pytest.raises(ValueError) as theirs:
            ref.service.ServeConfig(**kw)
        assert str(mine.value) == str(theirs.value)
    assert ServeConfig() == ServeConfig(max_queue_depth=64,
                                        batch_window_ms=2.0, max_batch=8,
                                        default_deadline_ms=None,
                                        plan_cache_size=128,
                                        session_cache_size=32)


def test_submit_validation():
    svc = _svc()  # not started: validation happens before the queue
    with pytest.raises(ValueError, match="unknown kind"):
        svc.submit("frobnicate", POOL[0])
    with pytest.raises(ValueError, match="need a graph"):
        svc.submit("count")
    with pytest.raises(ValueError, match="k_truss requests need k="):
        svc.submit("k_truss", POOL[0])
    with pytest.raises(KeyError, match="unknown dynamic session"):
        svc.submit("update", handle="nope", updates=[(0, 1)])
    with pytest.raises(ValueError, match="not a graph"):
        svc.submit("update", POOL[0], handle="nope", updates=[(0, 1)])
    with pytest.raises(TypeError, match="options must be a CountOptions"):
        svc.submit("count", POOL[0], options={"algorithm": "matrix"})
    with pytest.raises(TypeError, match="options must be a CountOptions"):
        TriangleService("intersection", device=CPU)
    assert svc.device.type == "cpu"


# --- coalescing ------------------------------------------------------------------


def test_single_request_passes_through():
    with _svc(ServeConfig(batch_window_ms=20.0, max_batch=8)) as svc:
        res = svc.count(POOL[0])
    assert res.count == int(res) == ORACLE[0]
    assert res.batch_size == 1


def test_compatible_burst_coalesces():
    with _svc() as svc:
        svc.warmup(POOL)
        futs = [svc.submit("count", POOL[i % 4], tenant=f"t{i % 2}")
                for i in range(8)]
        results = [f.result(timeout=120) for f in futs]
    assert [r.count for r in results] == [ORACLE[i % 4] for i in range(8)]
    assert max(r.batch_size for r in results) >= 2
    snap = svc.snapshot()
    assert snap["coalesce_factor"] > 1.0
    assert snap["counters"]["completed"] == 8


def test_incompatible_options_never_merge():
    b = OPTS.replace(strategy="probe")
    with _svc() as svc:
        fa = [svc.submit("count", POOL[0], options=OPTS) for _ in range(3)]
        fb = [svc.submit("count", POOL[0], options=b) for _ in range(3)]
        ra = [f.result(timeout=120) for f in fa]
        rb = [f.result(timeout=120) for f in fb]
    assert all(r.count == ORACLE[0] for r in ra + rb)
    assert {r.batch_id for r in ra}.isdisjoint(r.batch_id for r in rb)


def test_full_variant_and_heterogeneous_widths_match_sessions():
    graphs = [rmat_graph(6, e, seed=550 + e, name=f"het{e}")
              for e in (4, 8, 12, 16)]
    for opts in (OPTS, OPTS.replace(variant="full")):
        want = [int(TriangleCounter(g, opts, device=CPU).count())
                for g in graphs]
        with _svc(options=opts) as svc:
            svc.warmup(graphs)
            futs = [svc.submit("count", graphs[i % 4]) for i in range(12)]
            got = [f.result(timeout=120).count for f in futs]
        assert got == [want[i % 4] for i in range(12)]


def test_dynamic_updates_bypass_coalescing_and_stay_fifo():
    oracle = DynamicTriangleCounter(POOL[2], CountOptions(algorithm="dynamic"),
                                    device=CPU)
    expected = [int(oracle.apply_updates(b)) for b in UPDATES]
    with _svc() as svc:
        handle = svc.open_dynamic_session(POOL[2], tenant="dyn")
        cfut = svc.submit("count", POOL[2])
        ufuts = [svc.submit("update", handle=handle, updates=b)
                 for b in UPDATES]
        got = [f.result(timeout=120) for f in ufuts]
        assert cfut.result(timeout=120).count == ORACLE[2]
        svc.close_dynamic_session(handle)
        with pytest.raises(KeyError):
            svc.submit("update", handle=handle, updates=[(0, 1)])
    assert [r.count for r in got] == expected
    assert all(r.batch_size == 1 and r.algorithm == "dynamic" for r in got)


def test_auto_through_the_measured_chooser():
    g = POOL[1]
    t = CalibrationTable(device="x")
    cal = importlib.import_module("repro_torch.core.calibrate")
    t.record(cal.feature_key(cal.graph_features(g)), {"hash": 1e-6},
             "measured")
    prev = set_default_table(t)
    try:
        opts = CountOptions(chooser="measured")
        with _svc(options=opts) as svc:
            res = svc.submit("count", g).result(timeout=120)
        assert res.algorithm == "hash" and res.count == ORACLE[1]
        # the heuristic resolves the same graph to the batchable lane
        with _svc(options=CountOptions()) as svc:
            res = svc.submit("count", g).result(timeout=120)
        assert res.algorithm == "intersection" and res.count == ORACLE[1]
    finally:
        set_default_table(prev)


# --- admission control ----------------------------------------------------------


def test_queue_full_and_shutdown_shed_with_reasons():
    svc = _svc(ServeConfig(max_queue_depth=2, batch_window_ms=0.0))
    f1 = svc.submit("count", POOL[0])
    f2 = svc.submit("count", POOL[1])
    f3 = svc.submit("count", POOL[2])
    with pytest.raises(RequestShed) as ei:
        f3.result(timeout=5)
    assert ei.value.reason == SHED_QUEUE_FULL
    svc.stop(drain=False)
    for f in (f1, f2):
        with pytest.raises(RequestShed) as ei:
            f.result(timeout=5)
        assert ei.value.reason == SHED_SHUTDOWN
    c = svc.snapshot()["counters"]
    assert (c["shed"], c["shed_queue-full"], c["shed_shutdown"]) == (3, 1, 2)
    with pytest.raises(RequestShed) as ei:
        svc.submit("count", POOL[0]).result(timeout=5)
    assert ei.value.reason == SHED_SHUTDOWN


def test_expired_deadlines_shed_not_execute():
    with _svc() as svc:
        with pytest.raises(RequestShed) as ei:
            svc.submit("count", POOL[0], deadline_ms=1e-4).result(timeout=30)
    assert ei.value.reason == SHED_DEADLINE
    assert svc.snapshot()["counters"]["shed_deadline"] == 1
    cfg = ServeConfig(batch_window_ms=0.0, default_deadline_ms=1e-4)
    with _svc(cfg) as svc:
        with pytest.raises(RequestShed) as ei:
            svc.submit("vertex", POOL[0]).result(timeout=30)
    assert ei.value.reason == SHED_DEADLINE


def test_stop_with_drain_serves_the_backlog():
    svc = _svc(ServeConfig(batch_window_ms=0.0, max_batch=8))
    futs = [svc.submit("count", POOL[i % 4]) for i in range(6)]
    svc.start()
    svc.stop(drain=True)
    assert [f.result(timeout=120).count for f in futs] == \
        [ORACLE[i % 4] for i in range(6)]


def test_request_errors_reach_their_future():
    with _svc() as svc:
        bad = svc.submit("k_truss", POOL[0], k="three")
        good = svc.submit("count", POOL[0])
        with pytest.raises(Exception):
            bad.result(timeout=120)
        assert good.result(timeout=120).count == ORACLE[0]
    assert svc.snapshot()["counters"]["errors"] == 1


# --- caches ----------------------------------------------------------------------


def test_warmup_then_no_new_launch_configuration():
    clear_caches()
    with _svc() as svc:
        info = svc.warmup(POOL)
        assert info["batchable"] == len(POOL) and info["layouts"] == 1
        misses0 = executable_cache_info()["misses"]
        for burst in (1, 2, 3, 8):
            futs = [svc.submit("count", POOL[i % 4]) for i in range(burst)]
            for i, f in enumerate(futs):
                assert f.result(timeout=120).count == ORACLE[i % 4]
        assert executable_cache_info()["misses"] == misses0
        with _svc() as svc2:
            svc2.warmup(POOL)
            assert svc2.count(POOL[1]).count == ORACLE[1]
        assert executable_cache_info()["misses"] == misses0
        assert svc.snapshot()["counters"].get("errors", 0) == 0


def test_warmup_sessions_for_other_lanes():
    with _svc(options=CountOptions(algorithm="matrix")) as svc:
        info = svc.warmup(POOL[:2])
        assert (info["batchable"], info["singles"]) == (0, 2)
        assert svc.count(POOL[0]).count == ORACLE[0]
        assert svc.snapshot()["session_cache"]["hits"] >= 1


def test_racing_submissions_share_one_prep():
    with _svc() as svc:
        svc.warmup([POOL[0]])
        base = svc.snapshot()["plan_cache"]["misses"]
        barrier = threading.Barrier(6)
        futs, errs = [], []

        def fire():
            try:
                barrier.wait(timeout=30)
                futs.append(svc.submit("count", POOL[0]))
            except BaseException as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=fire) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs
        assert [f.result(timeout=120).count for f in futs] == [ORACLE[0]] * 6
        assert svc.snapshot()["plan_cache"]["misses"] == base


def test_racing_threads_build_a_prep_once():
    coal = Coalescer(device=CPU)
    fp = graph_fingerprint(POOL[3])
    barrier = threading.Barrier(8)
    got = []

    def prep():
        barrier.wait(timeout=30)
        got.append(coal.prep(POOL[3], fp, OPTS))

    threads = [threading.Thread(target=prep) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(got) == 8 and all(p is got[0] for p in got)
    info = coal.cache_info()
    assert (info["misses"], info["hits"]) == (1, 7)


def test_prep_cache_is_bounded_and_keyed_on_layout():
    coal = Coalescer(plan_cache_size=2, device=CPU)
    for g in POOL[:3]:
        coal.prep(g, graph_fingerprint(g), OPTS)
    info = coal.cache_info()
    assert (info["size"], info["maxsize"], info["evictions"]) == (2, 2, 1)
    fp = graph_fingerprint(POOL[0])
    assert prep_cache_key(fp, OPTS) == \
        prep_cache_key(fp, OPTS.replace(strategy="probe"))
    assert prep_cache_key(fp, OPTS) != \
        prep_cache_key(fp, OPTS.replace(variant="full"))
    pg = coal.prep(POOL[1], graph_fingerprint(POOL[1]), OPTS)
    assert all(b.u_lists.device.type == "cpu" for b in pg.buckets)


def test_session_cache_disabled_builds_per_request():
    cfg = ServeConfig(batch_window_ms=0.0, session_cache_size=0)
    with _svc(cfg) as svc:
        a = svc.submit("vertex", POOL[0]).result(timeout=120).value
        b = svc.submit("vertex", POOL[0]).result(timeout=120).value
        snap = svc.snapshot()
    np.testing.assert_array_equal(a, b)
    assert snap["session_cache"]["maxsize"] == 0
