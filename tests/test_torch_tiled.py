"""Tiled out-of-core counting in the port equals the reference's, bit for bit.

``CountOptions(max_device_bytes=...)`` bounds the bytes one bucket (or the
matrix lane's triples) may hold on the device; a unit over it stays in host
memory and streams through one launch cached at a pow2 chunk shape. The
mirror of ``tests/test_tiled.py``, each case held against the reference
(through the ``ref`` fixture) on the CPU:

* the strategy × prep_backend × budget sweep: port tiled = port resident =
  reference tiled = scipy, with ``tiled_buckets`` and ``num_chunks`` equal
  to the reference's;
* both variants, the matrix lane (per-chunk distinct tiles and re-based
  indices), the subgraph lane, steady-state cache misses, per-vertex
  counts and the generous budget;
* the chunked device prep's host arrays bit-equal to the reference's
  buckets, and no neighbour matrix left behind.
"""

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import (
    CountOptions,
    TriangleCounter,
    executable_cache_info,
    prep,
    triangle_count_scipy,
)
from repro_torch.core.engine import _TiledStage, plan_triangle_count
from repro_torch.graphs import erdos_renyi_graph, load_dataset, rmat_graph
from repro_torch.graphs.device import DeviceGraph

CPU = "cpu"


@pytest.fixture(scope="module")
def g_rmat():
    return rmat_graph(8, edge_factor=8, seed=21)


@pytest.fixture(scope="module")
def g_er():
    return erdos_renyi_graph(400, avg_degree=10.0, seed=4)


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _both(ref, g, **kw):
    """(port result on the CPU, reference result) for the same options."""
    got = TriangleCounter(g, device=CPU, **kw).count()
    want = ref.api.TriangleCounter(_ref_graph(ref, g),
                                   ref.options.CountOptions(**kw)).count()
    return got, want


def _same_tiling(got, want):
    assert got.meta["tiled_buckets"] == want.meta["tiled_buckets"]
    assert got.meta["num_chunks"] == want.meta["num_chunks"]
    assert got.meta["max_device_bytes"] == want.meta["max_device_bytes"]


@pytest.mark.parametrize("strategy", ["broadcast", "probe", "bitmap"])
@pytest.mark.parametrize("prep_backend", ["device", "host"])
@pytest.mark.parametrize("budget", [1 << 13, 1 << 16])
def test_tiled_intersection_sweep(ref, g_rmat, strategy, prep_backend, budget):
    oracle = int(triangle_count_scipy(g_rmat))
    kw = dict(algorithm="intersection", strategy=strategy,
              prep_backend=prep_backend)
    mono = TriangleCounter(g_rmat, device=CPU, **kw).count()
    tiled, ref_tiled = _both(ref, g_rmat, max_device_bytes=budget, **kw)
    assert int(mono) == int(tiled) == int(ref_tiled) == oracle
    _same_tiling(tiled, ref_tiled)
    assert tiled.meta["bucket_shapes"] == ref_tiled.meta["bucket_shapes"]
    assert tiled.bucket_strategies == ref_tiled.bucket_strategies
    if budget <= 1 << 13:
        assert tiled.meta["num_chunks"] >= 2 and tiled.meta["tiled_buckets"]
    for tb in tiled.meta["tiled_buckets"]:
        c = tb["chunk_rows"]
        assert c >= 1 and (c & (c - 1)) == 0 and tb["num_chunks"] >= 2
    # only u and v stream: 8·W bytes a padded row of each tiled bucket
    assert tiled.meta["streamed_bytes"] == sum(
        tb["chunk_rows"] * tb["num_chunks"] * 8 * tb["shape"][1]
        if prep_backend == "device" else 8 * tb["shape"][0] * tb["shape"][1]
        for tb in tiled.meta["tiled_buckets"])


@pytest.mark.parametrize("variant", ["filtered", "full"])
def test_tiled_variants(ref, g_er, variant):
    tiled, want = _both(ref, g_er, algorithm="intersection", variant=variant,
                        max_device_bytes=1 << 13)
    assert int(tiled) == int(want) == int(triangle_count_scipy(g_er))
    assert tiled.meta["num_chunks"] >= 2
    _same_tiling(tiled, want)


def test_tiled_matrix(ref, g_er):
    oracle = int(triangle_count_scipy(g_er))
    mono = TriangleCounter(g_er, device=CPU, algorithm="matrix").count()
    tiled, want = _both(ref, g_er, algorithm="matrix",
                        max_device_bytes=1 << 14)
    assert int(mono) == int(tiled) == int(want) == oracle
    assert tiled.meta["num_chunks"] >= 2
    _same_tiling(tiled, want)
    assert tiled.meta["tile_bytes"] == 0 and tiled.meta["streamed_bytes"] > 0


@pytest.mark.parametrize("name,block", [("tiny-rmat", 32), ("tiny-grid", 32),
                                        ("rmat9", 128)])
def test_matrix_chunks_hold_the_schedule(name, block):
    """Each chunk's tiles through its re-based indices are the schedule's
    own tiles for those triples, at most 3 × chunk of them, in the type
    ``to_device`` gives; its order is ``launch_order`` of its indices."""
    from repro_torch.kernels.masked_spgemm import launch_order

    g = rmat_graph(9, 8, seed=1) if name == "rmat9" else load_dataset(name)
    sched = prep.tile_schedule(g, block=block)
    t = sched.num_triples
    rows = 4
    chunks = sched.host_chunks(rows, CPU)
    assert len(chunks) == -(-t // rows)
    dtype = torch.bfloat16 if block == 128 else torch.float32
    for k, (l, u, li, ui, ai, order) in enumerate(chunks):
        sl = slice(k * rows, (k + 1) * rows)
        assert l.dtype == u.dtype == dtype and li.dtype == torch.int32
        assert len(l) + len(u) <= 3 * len(li) and len(li) <= rows
        np.testing.assert_array_equal(
            l[li.long()].float().numpy(), sched.l_blocks[sched.l_index[sl]])
        np.testing.assert_array_equal(
            u[ui.long()].float().numpy(), sched.u_blocks[sched.u_index[sl]])
        np.testing.assert_array_equal(
            u[ai.long()].float().numpy(), sched.u_blocks[sched.a_index[sl]])
        assert torch.equal(order, launch_order(li, ai))


def test_tiled_subgraph(ref, g_er):
    for prep_backend in ("device", "host"):
        tiled, want = _both(ref, g_er, algorithm="subgraph",
                            prep_backend=prep_backend,
                            max_device_bytes=1 << 13)
        assert int(tiled) == int(want) == int(triangle_count_scipy(g_er))
        assert tiled.meta["num_chunks"] >= 2
        _same_tiling(tiled, want)


def test_tiled_steady_state_builds_nothing(g_rmat):
    tc = TriangleCounter(g_rmat, CountOptions(algorithm="intersection",
                                              max_device_bytes=1 << 13),
                         device=CPU)
    first = tc.count()
    assert first.meta["num_chunks"] >= 2
    before = executable_cache_info()["misses"]
    for _ in range(3):
        assert int(tc.plan.count()) == int(first)
    assert executable_cache_info()["misses"] == before


def test_tiled_vertex_counts_match(ref, g_rmat):
    kw = dict(algorithm="intersection", max_device_bytes=1 << 13)
    mono = TriangleCounter(g_rmat, device=CPU, algorithm="intersection")
    tiled = TriangleCounter(g_rmat, device=CPU, **kw)
    want = ref.api.TriangleCounter(_ref_graph(ref, g_rmat),
                                   ref.options.CountOptions(**kw))
    pv_t = tiled.triangles_per_vertex()
    assert any(isinstance(st, _TiledStage) for st in tiled.plan.stages)
    np.testing.assert_array_equal(pv_t, mono.triangles_per_vertex())
    np.testing.assert_array_equal(pv_t, want.triangles_per_vertex())
    assert int(pv_t.sum()) == 3 * int(triangle_count_scipy(g_rmat))


def test_row_by_row_budget():
    """A budget below one row's cost streams one row a chunk."""
    g = load_dataset("tiny-rmat")
    res = TriangleCounter(g, device=CPU, algorithm="intersection",
                          max_device_bytes=1).count()
    assert int(res) == triangle_count_scipy(g)
    assert all(tb["chunk_rows"] == 1 for tb in res.meta["tiled_buckets"])
    assert res.meta["num_chunks"] == sum(s[0] for s in res.meta["bucket_shapes"])


def test_generous_budget_tiles_nothing(ref, g_er):
    res, want = _both(ref, g_er, algorithm="intersection",
                      max_device_bytes=1 << 30)
    assert int(res) == int(want) == int(triangle_count_scipy(g_er))
    assert res.meta["num_chunks"] == 0 and res.meta["tiled_buckets"] == []
    assert res.meta["streamed_bytes"] == 0
    assert not any(isinstance(st, _TiledStage) for st in res.plan.stages)


def test_budget_is_part_of_the_options_key():
    a = CountOptions(algorithm="intersection")
    b = CountOptions(algorithm="intersection", max_device_bytes=1 << 13)
    c = CountOptions(algorithm="intersection", max_device_bytes=1 << 16)
    assert len({a.key(), b.key(), c.key()}) == 3
    for bad in (0, -5, 1.5, True):
        with pytest.raises(ValueError):
            CountOptions(max_device_bytes=bad)


@pytest.mark.parametrize("variant", ["filtered", "full"])
@pytest.mark.parametrize("budget", [1 << 12, 1 << 15])
def test_chunked_device_prep_is_bit_equal(ref, g_rmat, variant, budget):
    """The budgeted device prep gathers over-budget buckets chunk by chunk
    into host arrays equal to the reference's resident buckets."""
    got = prep.prepare_intersection_buckets_device(
        g_rmat, variant=variant, device=CPU, max_device_bytes=budget)
    want = ref.prep.prepare_intersection_buckets_device(
        _ref_graph(ref, g_rmat), variant=variant)
    assert [(b.width, b.edges, b.shape) for b in got] == \
        [(b.width, b.edges, tuple(b.u_lists.shape)) for b in want]
    assert any(prep.bucket_is_tiled(b.e_pad, b.width, budget) for b in got)
    for gb, wb in zip(got, want):
        for name in ("u_lists", "v_lists", "src", "dst"):
            a = getattr(gb, name)
            assert a.dtype == torch.int32 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(getattr(wb, name)))


def test_budgeted_prep_drops_the_neighbour_matrix(g_rmat):
    dg = DeviceGraph.from_graph(g_rmat, device=CPU)
    prep.prepare_intersection_buckets_device(dg, max_device_bytes=1 << 13)
    assert dg._nbrs == {}
    prep.prepare_intersection_buckets_device(dg)  # resident: kept as a cache
    assert dg._nbrs


def test_tiled_stage_chunks_are_host_views(g_rmat):
    """A tiled stage holds nothing resident: its chunks are row views of
    the bucket's host arrays, the last one padded at launch."""
    plan = plan_triangle_count(g_rmat, device=CPU, max_device_bytes=1 << 13)
    tiled = [st for st in plan.stages if isinstance(st, _TiledStage)]
    assert tiled and all(st.args == () for st in tiled)
    for st in tiled:
        base = st.chunks[0][0]
        assert all(c[0].untyped_storage().data_ptr()
                   == base.untyped_storage().data_ptr() for c in st.chunks)
        assert sum(c[0].shape[0] for c in st.chunks) == st.shape_key[0]
        assert st.chunk_shape_key == (st.chunk_rows, st.shape_key[1])
