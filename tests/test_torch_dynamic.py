"""The dynamic lane equals the reference's, bit for bit, batch after batch.

The same seeded update streams go through ``DynamicTriangleCounter(g,
device="cpu")`` and ``repro.core.DynamicTriangleCounter(g)``; after every
batch the count, both key arrays (values and dtype), ``m``, ``capacity``,
``bounds`` and the meta are equal, in both key modes. Streams cover
capacity growth, width-class growth, an empty seed graph, dirty updates and
multi-chunk batches; the cache takes no new entry in steady state; a
planted drift makes ``recount()`` raise; ``recount()`` and the scipy
oracle on ``snapshot()`` agree with the kept count.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import (
    CountOptions,
    CounterSession,
    DynamicPlan,
    DynamicTriangleCounter,
    EdgeUpdate,
    TriangleCounter,
    available_algorithms,
    executable_cache_info,
    plan_dynamic_count,
    triangle_count_scipy,
)
from repro_torch.graphs import (
    ShapePolicy,
    complete_graph,
    edges_to_csr,
    erdos_renyi_graph,
    path_graph,
)

CPU = "cpu"


def _empty(n, name="empty"):
    return edges_to_csr([], [], n=n, name=name)


def _random_updates(rng, n, k, p_insert=0.6):
    u = rng.integers(0, n, size=k)
    v = rng.integers(0, n, size=k)
    ins = rng.random(k) < p_insert
    return [(int(a), int(b), bool(f)) for a, b, f in zip(u, v, ins)]


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _pair(ref, g, **kw):
    mine = DynamicTriangleCounter(g, device=CPU, **kw)
    rkw = dict(kw)
    if kw.get("shape_policy") is not None:
        rkw["shape_policy"] = ref.device.ShapePolicy(
            *dataclasses.astuple(kw["shape_policy"]))
    theirs = ref.api.DynamicTriangleCounter(
        _ref_graph(ref, g), ref.options.CountOptions(**rkw))
    return mine, theirs


def _same_state(mine, theirs, what):
    """Count, both key arrays with their dtype, m, capacity, bounds and
    every shared meta key equal the reference's."""
    p, r = mine.plan, theirs.plan
    assert p.count() == r.count(), what
    for a, b in ((p._keys, r._keys), (p._rkeys, r._rkeys)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, what
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(what))
    assert (p.m, p.cap, p.bounds) == (r.m, r.cap, r.bounds), what
    pm, rm = p._sync_meta(), r._sync_meta()
    for k in rm:
        if k in pm:
            assert pm[k] == rm[k], (what, k, pm[k], rm[k])


STREAMS = {
    # name: (seed graph, session kwargs, batches of updates from the rng)
    "er64": (lambda: erdos_renyi_graph(64, avg_degree=6, seed=3),
             dict(update_batch_size=32), lambda rng, n: _random_updates(rng, n, 50)),
    "er40_chunks": (lambda: erdos_renyi_graph(40, avg_degree=5, seed=5),
                    dict(update_batch_size=8),
                    lambda rng, n: _random_updates(rng, n, 30)),
    "empty12": (lambda: _empty(12, "empty12"), dict(update_batch_size=8),
                lambda rng, n: _random_updates(rng, n, 20, p_insert=0.8)),
    "clique7": (lambda: complete_graph(7), dict(update_batch_size=16),
                lambda rng, n: _random_updates(rng, n, 12, p_insert=0.3)),
}


@pytest.mark.parametrize("key_mode", ["auto", "wide"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streams_match_reference_after_every_batch(ref, name, key_mode):
    make, kw, batch = STREAMS[name]
    g = make()
    mine, theirs = _pair(ref, g, recount_interval=0, key_mode=key_mode, **kw)
    _same_state(mine, theirs, (name, "seed"))
    rng = np.random.default_rng(sum(map(ord, name)))
    for i in range(4):
        ups = batch(rng, g.n)
        a, b = mine.apply_updates(ups), theirs.apply_updates(ups)
        assert a.count == b.count and a.algorithm == "dynamic"
        _same_state(mine, theirs, (name, i))
    want = np.int64 if key_mode == "wide" else np.int32
    assert mine.plan._keys.numpy().dtype == want
    assert mine.recount() == mine.count().count \
        == triangle_count_scipy(mine.snapshot())


@pytest.mark.parametrize("key_mode", ["auto", "wide"])
def test_capacity_growth_matches_reference(ref, key_mode):
    n = 40
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    seed = pairs[:120]
    g = edges_to_csr([p[0] for p in seed], [p[1] for p in seed], n=n,
                     name="capgrow")
    mine, theirs = _pair(ref, g, update_batch_size=16, recount_interval=0,
                         key_mode=key_mode)
    assert mine.plan.cap == 128
    mine.apply_updates([pairs[120]])  # warm: m = 121, inside 128
    theirs.apply_updates([pairs[120]])
    warm = executable_cache_info()
    mine.apply_updates(pairs[121:137])  # m past 128: the class doubles
    theirs.apply_updates(pairs[121:137])
    assert mine.plan.cap == 256
    grown = executable_cache_info()
    assert grown["misses"] == warm["misses"] + 1  # one new step class
    _same_state(mine, theirs, "grown")
    for s in range(137, 185, 16):
        mine.apply_updates(pairs[s:s + 16])
        theirs.apply_updates(pairs[s:s + 16])
        _same_state(mine, theirs, s)
    assert executable_cache_info()["misses"] == grown["misses"]
    assert mine.recount() == mine.count().count


@pytest.mark.parametrize("key_mode", ["auto", "wide"])
def test_width_growth_matches_reference(ref, key_mode):
    g = path_graph(24)
    mine, theirs = _pair(ref, g, update_batch_size=16, recount_interval=0,
                         widths=(8,), key_mode=key_mode)
    assert mine.plan.bounds == (8,)
    star = [(0, b) for b in range(2, 14)]  # degree(0) -> 13 > 8
    before = executable_cache_info()["misses"]
    assert mine.apply_updates(star).count == theirs.apply_updates(star).count
    assert mine.plan.bounds == (8, 16)
    # the batch grows the capacity (23 + 12 > 32) and then the width class:
    # a step at (64, ..., 8), the old class's Δ⁻, the step again at
    # (64, ..., 16) and the grown class's Δ⁺
    assert executable_cache_info()["misses"] - before == 4
    _same_state(mine, theirs, "grown")
    unstar = [(u, v, False) for u, v in star]
    mine.apply_updates(unstar)
    theirs.apply_updates(unstar)
    assert mine.plan.bounds == (8, 16)  # classes never shrink
    _same_state(mine, theirs, "after")
    assert mine.recount() == mine.count().count


def test_steady_state_adds_no_cache_entry():
    rng = np.random.default_rng(3)
    g = erdos_renyi_graph(48, avg_degree=6, seed=1)
    dc = DynamicTriangleCounter(g, device=CPU, update_batch_size=16,
                                recount_interval=0)
    dc.apply_updates(_random_updates(rng, g.n, 16))  # binds the delta launch
    warm = dc.cache_stats()
    for _ in range(5):
        dc.apply_updates(_random_updates(rng, g.n, 16))
    stats = dc.cache_stats()
    assert stats["misses"] == warm["misses"] and stats["size"] == warm["size"]
    assert stats["hits"] > warm["hits"]
    assert dc.recount() == dc.count().count


def test_empty_dense_empty_round_trip(ref):
    n = 10
    mine, theirs = _pair(ref, _empty(n), update_batch_size=16,
                         recount_interval=0)
    allp = [(a, b) for a in range(n) for b in range(a + 1, n)]
    assert mine.apply_updates(allp).count == 120 == \
        theirs.apply_updates(allp).count
    _same_state(mine, theirs, "dense")
    gone = [(a, b, False) for a, b in allp]
    assert mine.apply_updates(gone).count == 0
    theirs.apply_updates(gone)
    _same_state(mine, theirs, "empty")
    assert mine.m_undirected == 0 and mine.snapshot().m_undirected == 0
    assert mine.recount() == 0


def test_dirty_updates_are_noops():
    dc = DynamicTriangleCounter(complete_graph(6), device=CPU,
                                update_batch_size=8, recount_interval=0)
    assert dc.count().count == 20
    dc.apply_updates([(0, 1, True), (0, 1, True)])
    dc.apply_updates([(2, 2, True)])
    assert dc.count().count == 20
    dc2 = DynamicTriangleCounter(_empty(6), device=CPU, update_batch_size=8,
                                 recount_interval=0)
    dc2.apply_updates([EdgeUpdate(0, 1, insert=False)])
    assert dc2.count().count == 0 and dc2.plan.meta["deleted"] == 0


def test_periodic_recount_cadence_matches_reference(ref):
    rng = np.random.default_rng(5)
    g = erdos_renyi_graph(32, avg_degree=4, seed=2)
    mine, theirs = _pair(ref, g, update_batch_size=8, recount_interval=2)
    for _ in range(5):
        ups = _random_updates(rng, g.n, 8)
        mine.apply_updates(ups)
        theirs.apply_updates(ups)
    assert mine.plan.meta["batches"] == 5
    assert mine.plan.meta["recounts"] == 2 == theirs.plan.meta["recounts"]


def test_recount_raises_on_drift():
    dc = DynamicTriangleCounter(complete_graph(7), device=CPU,
                                update_batch_size=8, recount_interval=0)
    dc.plan._count += 1  # a planted drift
    with pytest.raises(RuntimeError, match="drifted"):
        dc.recount()


def test_session_surface_and_errors_match_reference(ref):
    g = complete_graph(5)
    dc = DynamicTriangleCounter(g, device=CPU, recount_interval=0)
    assert isinstance(dc, CounterSession) and isinstance(dc.plan, DynamicPlan)
    c, stats = dc.count_with_stats()
    assert c == 10 and stats["algorithm"] == "dynamic"
    assert set(dc.cache_stats()) == {"size", "hits", "misses", "maxsize",
                                     "evictions"}
    with pytest.raises(ValueError) as pe:
        DynamicTriangleCounter(g, device=CPU, algorithm="matrix")
    with pytest.raises(ValueError) as re_:
        ref.api.DynamicTriangleCounter(
            _ref_graph(ref, g), ref.options.CountOptions(algorithm="matrix"))
    assert str(pe.value) == str(re_.value)
    assert TriangleCounter(g, device=CPU).algorithm != "dynamic"
    assert "dynamic" in available_algorithms()
    for kw in (dict(update_batch_size=0), dict(recount_interval=-1),
               dict(update_batch_size=True)):
        with pytest.raises(ValueError) as pe:
            CountOptions(**kw)
        with pytest.raises(ValueError) as re_:
            ref.options.CountOptions(**kw)
        assert str(pe.value) == str(re_.value)
    with pytest.raises(ValueError, match="update_batch_size"):
        plan_dynamic_count(g, update_batch_size=0, device=CPU)
    with pytest.raises(ValueError, match="recount_interval"):
        plan_dynamic_count(g, recount_interval=-1, device=CPU)
    with pytest.raises(ValueError, match="backend"):
        plan_dynamic_count(g, backend="bogus", device=CPU)
    assert len({CountOptions().key(), CountOptions(update_batch_size=32).key(),
                CountOptions(recount_interval=0).key()}) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DynamicTriangleCounter(g)


def test_exact_policy_and_forced_strategies_stay_exact(ref):
    g = erdos_renyi_graph(24, avg_degree=4, seed=9)
    ups = [(0, 1), (1, 2), (0, 2), (2, 3), (5, 6, False)]
    for kw in (dict(shape_policy=ShapePolicy(edge_rounding="exact")),
               dict(strategy="probe"), dict(strategy="bitmap"),
               dict(strategy="broadcast")):
        mine, theirs = _pair(ref, g, update_batch_size=8, recount_interval=0,
                             **kw)
        mine.apply_updates(ups)
        theirs.apply_updates(ups)
        _same_state(mine, theirs, kw)
        assert mine.recount() == mine.count().count


def test_ref_backend_recount():
    g = erdos_renyi_graph(30, avg_degree=5, seed=4)
    dc = DynamicTriangleCounter(g, device=CPU, backend="ref",
                                update_batch_size=8, recount_interval=1)
    res = dc.apply_updates([(0, 1), (1, 2), (0, 2)])
    assert res.count == triangle_count_scipy(dc.snapshot())
    assert dc.plan.meta["recounts"] == 1
