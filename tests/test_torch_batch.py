"""Batched counting in the port equals the reference's and scipy's.

``TriangleCounter.count_many`` / ``iter_counts`` and ``GraphBatch`` on the
CPU, the mirror of ``tests/test_prep_parity.py``'s batching tests and of
``tests/test_api.py``'s ``count_many`` test: batch = per-graph loop = the
reference's ``count_many`` = scipy, lazy generators, ``batch_size``
validation, the ``ValueError``s of the batchable regime, heterogeneous
sizes in both variants, the reference's stacked layout, and one cache
entry reused by a second batch.
"""

import numpy as np
import pytest

from torch_reference import ref  # noqa: F401

from repro_torch.core import (
    CountOptions,
    GraphBatch,
    TriangleCounter,
    cache_info,
    executable_cache_info,
    prep,
    triangle_count_scipy,
)
from repro_torch.core import api as api_module
from repro_torch.graphs import (
    complete_graph,
    edges_to_csr,
    grid_graph,
    load_dataset,
    rmat_graph,
    star_graph,
)

CPU = "cpu"


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _mixed():
    return ([rmat_graph(6, 5, seed=s) for s in range(5)]
            + [star_graph(12), complete_graph(10),
               grid_graph(6, spur_fraction=0.3, seed=8)])


@pytest.mark.parametrize("algorithm", ["intersection", "auto"])
def test_count_many_agrees_with_loop_and_reference(ref, algorithm):
    graphs = _mixed()
    opts = CountOptions(algorithm=algorithm)
    tc = TriangleCounter(graphs[0], opts, device=CPU)
    res = tc.count_many(graphs, batch_size=4)
    ref_graphs = [_ref_graph(ref, g) for g in graphs]
    rtc = ref.api.TriangleCounter(ref_graphs[0],
                                  ref.options.CountOptions(algorithm=algorithm))
    want = rtc.count_many(ref_graphs, batch_size=4)
    assert len(res) == len(want) == len(graphs)
    for g, r, w in zip(graphs, res, want):
        assert int(r) == int(w) == triangle_count_scipy(g), g.name
        assert r == TriangleCounter(g, opts, device=CPU).count()
        assert r.algorithm == w.algorithm
        assert bool(r.meta.get("batched")) == bool(w.meta.get("batched"))
        if w.meta.get("batched"):
            assert r.meta["batch_size"] == w.meta["batch_size"]
            assert r.meta["bucket_shapes"] == w.meta["bucket_shapes"]
            assert r.bucket_strategies == w.bucket_strategies
    # the session's own graph reused the session plan
    assert res[0].plan is tc.plan


def test_count_many_consumes_generators_lazily():
    pulls = []

    def gen():
        for s in range(12):
            pulls.append(s)
            yield rmat_graph(5, 4, seed=s)

    tc = TriangleCounter(rmat_graph(5, 4, seed=99), device=CPU,
                         algorithm="intersection")
    it = tc.iter_counts(gen(), batch_size=3)
    next(it)
    assert len(pulls) == 3  # only the first chunk before the first result
    rest = list(it)
    assert len(rest) == 11 and len(pulls) == 12


def test_count_many_is_one_batch_per_chunk(monkeypatch):
    """Eight graphs of one policy: one GraphBatch, no per-graph session, no
    host prep; a second batch of the same layout builds nothing new."""
    graphs = [rmat_graph(6, 6, seed=60 + s) for s in range(8)]
    tc = TriangleCounter(rmat_graph(6, 6, seed=59), device=CPU,
                         algorithm="intersection")

    def _boom(*a, **k):
        raise AssertionError("per-graph fallback ran for a batchable graph")

    monkeypatch.setattr(api_module, "TriangleCounter", _boom)
    monkeypatch.setattr(prep, "prepare_intersection_buckets_host", _boom)
    res = tc.count_many(iter(graphs), batch_size=8)
    batch = res[0].plan
    assert isinstance(batch, GraphBatch)
    assert all(r.plan is batch for r in res)
    assert batch.executions == 1
    for g, r in zip(graphs, res):
        assert r == triangle_count_scipy(g)
        assert r.meta["batched"] and r.meta["batch_size"] == 8
        assert r.meta["graph"] == g.name and r.meta["n"] == g.n
    info1 = executable_cache_info()
    res2 = tc.count_many(iter(graphs), batch_size=8)
    info2 = executable_cache_info()
    assert [int(r) for r in res2] == [int(r) for r in res]
    assert info2["misses"] == info1["misses"]
    assert info2["hits"] > info1["hits"]
    key = ("intersection_batch", None, "kernel", None,
           (8,) + res2[0].plan.specs)
    assert key in cache_info()["keys"]


def test_count_many_batch_size_validation():
    tc = TriangleCounter(rmat_graph(5, 4, seed=1), device=CPU)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="batch_size"):
            list(tc.iter_counts([], batch_size=bad))
        with pytest.raises(ValueError, match="batch_size"):
            tc.count_many([rmat_graph(5, 4, seed=2)], batch_size=bad)


def test_graph_batch_rejects_unbatchable_options():
    graphs = [rmat_graph(5, 4, seed=s) for s in range(2)]
    with pytest.raises(ValueError, match="at least one graph"):
        GraphBatch.from_graphs([], CountOptions(algorithm="intersection"),
                               device=CPU)
    with pytest.raises(ValueError, match="backend='kernel'"):
        GraphBatch.from_graphs(
            graphs, CountOptions(algorithm="intersection", backend="ref"),
            device=CPU)
    with pytest.raises(ValueError, match="prep_backend='device'"):
        GraphBatch.from_graphs(
            graphs, CountOptions(algorithm="intersection",
                                 prep_backend="host"), device=CPU)


def test_unbatchable_options_take_per_graph_sessions():
    graphs = [rmat_graph(5, 4, seed=s) for s in range(3)]
    for kw in (dict(backend="ref"), dict(prep_backend="host"),
               dict(algorithm="matrix")):
        tc = TriangleCounter(graphs[0], device=CPU, **kw)
        res = tc.count_many(graphs[1:], batch_size=4)
        for g, r in zip(graphs[1:], res):
            assert r == triangle_count_scipy(g)
            assert "batched" not in r.meta and not isinstance(r.plan,
                                                              GraphBatch)


@pytest.mark.parametrize("variant", ["filtered", "full"])
def test_graph_batch_heterogeneous_sizes(ref, variant):
    """Mixed n and layouts harmonize by padding; the full variant's ×6
    divisor applies per graph; the stacks equal the reference's."""
    graphs = [star_graph(30), complete_graph(12), rmat_graph(5, 6, seed=2),
              edges_to_csr([], [], n=4, name="empty4")]
    truth = [triangle_count_scipy(g) for g in graphs]
    opts = dict(algorithm="intersection", variant=variant)
    batch = GraphBatch.from_graphs(graphs, CountOptions(**opts), device=CPU)
    want = ref.engine.GraphBatch.from_graphs(
        [_ref_graph(ref, g) for g in graphs], ref.options.CountOptions(**opts))
    assert [int(c) for c in batch.counts()] == truth
    assert [int(c) for c in want.counts()] == truth
    assert batch.specs == want.specs
    assert batch.meta["bucket_strategies"] == want.meta["bucket_strategies"]
    assert batch.batch_size == 4 and batch.shape_keys == want.shape_keys
    for a, b in zip(batch.arrays, want.arrays):
        assert a.is_contiguous() and tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_batch_id_range_spans_the_members(ref):
    """The strategy resolves with max n + 2: forced bitmap sizes its
    capacity from the largest member, as the reference does."""
    graphs = [load_dataset("tiny-rmat"), rmat_graph(9, 8, seed=4),
              complete_graph(6)]
    opts = dict(algorithm="intersection", strategy="bitmap")
    batch = GraphBatch.from_graphs(graphs, CountOptions(**opts), device=CPU)
    want = ref.engine.GraphBatch.from_graphs(
        [_ref_graph(ref, g) for g in graphs], ref.options.CountOptions(**opts))
    assert batch.specs == want.specs
    assert all(bits >= max(g.n for g in graphs) + 2
               for _, bits, _ in batch.specs)
    assert [int(c) for c in batch.counts()] == \
        [triangle_count_scipy(g) for g in graphs]


def test_batch_of_one_uses_a_plain_session():
    g0, g1 = rmat_graph(5, 4, seed=1), rmat_graph(5, 4, seed=2)
    tc = TriangleCounter(g0, device=CPU, algorithm="intersection")
    (res,) = tc.count_many([g1])
    assert res == triangle_count_scipy(g1)
    assert "batched" not in res.meta and not isinstance(res.plan, GraphBatch)
