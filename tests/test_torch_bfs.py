"""The port's bfs lane equals the reference's, bit for bit.

The device BFS levels against ``repro.graphs.device.bfs_levels`` on the
analogues, grids and adversarial graphs (empty, edgeless, star, clique,
isolated vertices, several components, a path); the bfs plan's stage
arrays ``(u_rows, v_rows, src, dst)`` and meta against the reference's
``_plan_bfs``; counts and per-vertex counts against the reference and
scipy, under each forced strategy. Every value is an integer: tolerance 0.
"""

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import TriangleCounter, plan_bfs_count, triangle_count_scipy
from repro_torch.core import prep as port_prep
from repro_torch.graphs import bfs_levels
from repro_torch.graphs import device as port_device
from repro_torch.graphs import generators as port_gen
from repro_torch.graphs.datasets import load_dataset
from repro_torch.graphs.formats import edges_to_csr

CPU = torch.device("cpu")


def _components():
    """A triangle, a 4-cycle whose smallest id is not its first vertex, a
    star, and isolated vertices, interleaved in id order."""
    src = [0, 1, 2, 9, 5, 4, 7, 10, 10, 10]
    dst = [1, 2, 0, 5, 4, 7, 9, 11, 12, 13]
    return edges_to_csr(src, dst, n=16, name="components")


GRAPHS = {
    "empty": lambda: edges_to_csr([], [], n=0, name="empty0"),
    "edgeless": lambda: edges_to_csr([], [], n=7, name="edgeless7"),
    "star": lambda: port_gen.star_graph(30),
    "clique": lambda: port_gen.complete_graph(12),
    "path": lambda: port_gen.path_graph(10),
    "components": _components,
    "tiny-rmat": lambda: load_dataset("tiny-rmat"),
    "tiny-grid": lambda: load_dataset("tiny-grid"),
    "road-like": lambda: load_dataset("road-like"),
    "grid40": lambda: port_gen.grid_graph(40, spur_fraction=0.3, seed=2),
    "grid25-nodiag": lambda: port_gen.grid_graph(25, diagonals=False,
                                                 spur_fraction=0.1, seed=1),
    "rmat10-skew": lambda: port_gen.rmat_graph(10, 16, seed=5),
    "watts": lambda: port_gen.watts_strogatz_graph(200, 8, 0.2, seed=4),
}
POLICIES = {"pow2": port_device.ShapePolicy(),
            "exact": port_device.ShapePolicy("exact", 1)}


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


LEVEL_GRAPHS = dict(GRAPHS, **{
    name: (lambda name=name: load_dataset(name))
    for name in ("coauthors-like", "citpatents-like")})


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", list(LEVEL_GRAPHS))
def test_levels_match_reference(ref, name, policy):
    g = LEVEL_GRAPHS[name]()
    pol = POLICIES[policy]
    dg = port_device.DeviceGraph.from_graph(g, pol, device=CPU)
    lvl = bfs_levels(dg)
    assert lvl.dtype == torch.int32 and lvl.shape == (g.n,)
    if g.n == 0:
        return  # the reference's gather refuses n = 0; its plan never asks
    rdg = ref.device.DeviceGraph.from_graph(
        _ref_graph(ref, g), ref.device.ShapePolicy(pol.edge_rounding,
                                                   pol.min_edges))
    np.testing.assert_array_equal(lvl.numpy(),
                                  np.asarray(ref.device.bfs_levels(rdg)))


def test_levels_and_rounds_on_a_path():
    dg = port_device.DeviceGraph.from_graph(port_gen.path_graph(10), device=CPU)
    lvl, rounds = port_device._bfs_levels_dev(
        dg.edge_sources(), dg.csr.col_idx, dg.edge_valid(), n=dg.n)
    assert lvl.tolist() == list(range(10))
    assert rounds == 10  # nine rounds that change a level, then a quiet one
    assert bfs_levels(port_device.DeviceGraph.from_graph(
        _components(), device=CPU)).tolist() == [
        0, 1, 1, 0, 0, 1, 0, 1, 0, 2, 0, 1, 1, 1, 0, 0]


_META = ("variant", "widths", "strategy", "shape_policy", "bucket_shapes",
         "bucket_strategies", "bucket_edges", "edges", "levels_max",
         "bfs_sources", "n", "m")


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bfs_plan_matches_reference(ref, name, policy):
    g = GRAPHS[name]()
    pol = POLICIES[policy]
    plan = plan_bfs_count(g, shape_policy=pol, device=CPU)
    rplan = ref.engine.plan_triangle_count(
        _ref_graph(ref, g), "bfs", backend="jnp",
        shape_policy=ref.device.ShapePolicy(pol.edge_rounding, pol.min_edges))
    for k in _META:
        assert plan.meta[k] == rplan.meta[k], k
    assert plan.meta["bfs_rounds"] >= (1 if g.m_undirected else 0)
    assert plan.num_stages == len(rplan.stages)
    for st, rst in zip(plan.stages, rplan.stages):
        assert st.shape_key == rst.shape_key
        assert (st.strategy, st.bitmap_bits) == (rst.strategy, rst.bitmap_bits)
        for a, ra in zip(st.args + st.vertex_args, rst.args + rst.vertex_args):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    assert plan.count() == rplan.count() == triangle_count_scipy(g)


def test_bfs_buckets_use_the_intersection_layout():
    # the level-oriented buckets keep the sentinels: u pad -1, v pad -2,
    # in-row n on u and n + 1 on v
    g = GRAPHS["tiny-rmat"]()
    dg = port_device.DeviceGraph.from_graph(g, device=CPU)
    buckets, lvl, rounds = port_prep.prepare_bfs_buckets_device(dg)
    assert rounds >= 1 and int(lvl.max()) >= 1
    for b in buckets:
        real_u, real_v = b.u_lists[:b.edges], b.v_lists[:b.edges]
        assert bool((b.u_lists[b.edges:] == -1).all())
        assert bool((b.v_lists[b.edges:] == -2).all())
        assert bool(((real_u >= 0) & (real_u <= g.n)).all())
        assert bool((real_v != g.n).all()) and bool((real_v >= 0).all())
    assert sum(b.edges for b in buckets) == g.m_undirected


@pytest.mark.parametrize("strategy", ["auto", "broadcast", "probe", "bitmap"])
@pytest.mark.parametrize("name", ["tiny-rmat", "tiny-grid", "components",
                                  "rmat10-skew", "clique"])
def test_bfs_counter_matches_reference(ref, name, strategy):
    g = GRAPHS[name]()
    tc = TriangleCounter(g, device=CPU, algorithm="bfs", strategy=strategy)
    res = tc.count()
    rc = ref.api.TriangleCounter(
        _ref_graph(ref, g),
        ref.options.CountOptions(algorithm="bfs", strategy=strategy))
    want = rc.count()
    assert res.count == want.count == triangle_count_scipy(g)
    assert res.bucket_strategies == want.bucket_strategies
    t = tc.triangles_per_vertex()  # the plan's own level-oriented stages
    np.testing.assert_array_equal(t, rc.triangles_per_vertex())
    np.testing.assert_array_equal(
        t, TriangleCounter(g, device=CPU, algorithm="intersection")
        .triangles_per_vertex())


def test_bfs_lane_on_empty_and_edgeless_graphs():
    for name in ("empty", "edgeless"):
        g = GRAPHS[name]()
        tc = TriangleCounter(g, device=CPU, algorithm="bfs")
        res = tc.count()
        assert res.count == 0 and res.plan.num_stages == 0
        assert res.meta["levels_max"] == 0 and res.meta["bfs_sources"] == g.n
        assert tc.triangles_per_vertex().shape == (g.n,)
