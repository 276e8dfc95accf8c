"""The port's subgraph lane equals the reference's, bit for bit.

The device 2-core peel (alive mask) and the induced device CSR
(``row_ptr`` / ``col_idx`` / kept count) against ``repro``'s jitted ops;
the host peel; the subgraph plan's count, meta and per-vertex counts with
both prep backends and each forced strategy; labeled triangle queries
(``subgraph_match_triangle``); and ``auto`` on a mesh-like graph.
"""

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import (
    TriangleCounter,
    peel_to_two_core,
    subgraph_match_triangle,
    triangle_count_scipy,
)
from repro_torch.core import prep as port_prep
from repro_torch.graphs import device as port_device
from repro_torch.graphs import generators as port_gen
from repro_torch.graphs.datasets import load_dataset
from repro_torch.graphs.formats import edges_to_csr

CPU = torch.device("cpu")


def _cycle_with_tail(n):
    """A cycle with a path hanging off it: the peel strips the tail one
    vertex per round."""
    src = list(range(n)) + list(range(n, n + 5))
    dst = [(i + 1) % n for i in range(n)] + [n - 1] + list(range(n, n + 4))
    return edges_to_csr(src, dst, n=n + 5, name="cycle-tail")


GRAPHS = {
    "empty": lambda: edges_to_csr([], [], n=6, name="empty6"),
    "star": lambda: port_gen.star_graph(16),
    "clique": lambda: port_gen.complete_graph(9),
    "cycle-tail": lambda: _cycle_with_tail(12),
    "tiny-rmat": lambda: load_dataset("tiny-rmat"),
    "tiny-grid": lambda: load_dataset("tiny-grid"),
    "road-like": lambda: load_dataset("road-like"),
    "rmat9": lambda: port_gen.rmat_graph(9, 8),
}
POLICIES = {"pow2": port_device.ShapePolicy(),
            "exact": port_device.ShapePolicy("exact", 1)}


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _device_graphs(ref, g, policy):
    pol = POLICIES[policy]
    dg = port_device.DeviceGraph.from_graph(g, pol, device=CPU)
    rdg = ref.device.DeviceGraph.from_graph(
        _ref_graph(ref, g), ref.device.ShapePolicy(pol.edge_rounding,
                                                   pol.min_edges))
    return dg, rdg


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_peel_and_induced_csr_match_reference(ref, name, policy):
    g = GRAPHS[name]()
    dg, rdg = _device_graphs(ref, g, policy)
    alive, rounds = port_prep.peel_to_two_core_device(dg)
    want = np.asarray(ref.prep.peel_to_two_core_device(rdg))
    assert alive.dtype == torch.bool
    np.testing.assert_array_equal(alive.numpy(), want)
    assert rounds >= (1 if g.m_directed else 0)
    np.testing.assert_array_equal(peel_to_two_core(g),
                                  ref.prep.peel_to_two_core(_ref_graph(ref, g)))
    sub = port_prep.induced_device_graph(dg, alive)
    rsub = ref.prep.induced_device_graph(rdg, ref.prep.peel_to_two_core_device(rdg))
    assert (sub.n, sub.m) == (rsub.n, rsub.m)
    np.testing.assert_array_equal(sub.csr.row_ptr.numpy(),
                                  np.asarray(rsub.csr.row_ptr))
    np.testing.assert_array_equal(sub.csr.col_idx.numpy(),
                                  np.asarray(rsub.csr.col_idx))


def test_peel_rounds_follow_the_tail():
    g = _cycle_with_tail(12)
    dg = port_device.DeviceGraph.from_graph(g, device=CPU)
    alive, rounds = port_prep.peel_to_two_core_device(dg)
    assert rounds == 6  # five tail vertices peel one a round, then a quiet round
    assert alive.numpy().tolist() == [True] * 12 + [False] * 5


def test_labeled_peel_matches_reference(ref):
    g = GRAPHS["rmat9"]()
    labels = np.random.default_rng(3).integers(0, 3, size=g.n)
    for q in range(3):
        np.testing.assert_array_equal(
            peel_to_two_core(g, labels=labels, query_label=q),
            ref.prep.peel_to_two_core(_ref_graph(ref, g), labels=labels,
                                      query_label=q))


_META = ("vertices_pruned", "prune_fraction", "edges_after", "edges_before",
         "vertex_n", "bucket_shapes", "bucket_strategies", "bucket_edges",
         "edges", "widths", "strategy", "prep_backend", "shape_policy",
         "num_embeddings")


@pytest.mark.parametrize("prep_backend", ["device", "host"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_subgraph_plan_matches_reference(ref, name, prep_backend):
    g = GRAPHS[name]()
    tc = TriangleCounter(g, device=CPU, algorithm="subgraph",
                         prep_backend=prep_backend)
    rc = ref.api.TriangleCounter(
        _ref_graph(ref, g),
        ref.options.CountOptions(algorithm="subgraph", prep_backend=prep_backend))
    c, stats = tc.count_with_stats()
    rcount, rstats = rc.count_with_stats()
    assert c == rcount == triangle_count_scipy(g)
    for k in _META:
        assert stats[k] == rstats[k], k
    if prep_backend == "host":
        np.testing.assert_array_equal(stats["vertex_map"], rstats["vertex_map"])
    else:
        assert "vertex_map" not in stats and stats["peel_rounds"] >= 0
    t = tc.triangles_per_vertex()
    np.testing.assert_array_equal(t, rc.triangles_per_vertex())
    np.testing.assert_array_equal(
        t, TriangleCounter(g, device=CPU, algorithm="intersection")
        .triangles_per_vertex())


@pytest.mark.parametrize("strategy", ["broadcast", "probe", "bitmap"])
@pytest.mark.parametrize("name", ["tiny-grid", "rmat9"])
def test_subgraph_forced_strategies_match_reference(ref, name, strategy):
    g = GRAPHS[name]()
    res = TriangleCounter(g, device=CPU, algorithm="subgraph",
                          strategy=strategy).count()
    want = ref.api.TriangleCounter(
        _ref_graph(ref, g),
        ref.options.CountOptions(algorithm="subgraph", strategy=strategy)).count()
    assert res.count == want.count == triangle_count_scipy(g)
    assert res.bucket_strategies == want.bucket_strategies


@pytest.mark.parametrize("query", [(0, 0, 0), (0, 1, 2), (1, 1, 0), (2, 0, 1)])
@pytest.mark.parametrize("name", ["clique", "tiny-grid", "rmat9"])
def test_labeled_triangle_queries_match_reference(ref, name, query):
    g = GRAPHS[name]()
    labels = np.random.default_rng(7).integers(0, 3, size=g.n)
    got = subgraph_match_triangle(g, labels, query, device=CPU)
    want = ref.tc_subgraph.subgraph_match_triangle(_ref_graph(ref, g), labels,
                                                   query)
    assert got == want
    # all-one labels: every ordered embedding of every triangle
    assert subgraph_match_triangle(g, np.zeros(g.n, np.int64), (0, 0, 0),
                                   device=CPU) == 6 * triangle_count_scipy(g)


def test_auto_picks_subgraph_on_mesh(ref):
    g = GRAPHS["tiny-grid"]()
    assert ref.registry.choose_algorithm(_ref_graph(ref, g)) == "subgraph"
    res = TriangleCounter(g, device=CPU).count()
    assert res.algorithm == "subgraph" and res.count == triangle_count_scipy(g)
    assert res.meta["num_embeddings"] == 6 * res.count
    c, stats = res.plan.count_with_stats()
    assert stats["num_embeddings"] == 6 * c
