"""K2's CSR route: each probe row pair read from the forward CSR at its real
length, on the CPU.

``intersect_counts_probe_csr`` (the plain version, which the kernel
wrapper takes on a CPU tensor) must equal ``intersect_counts_probe`` on the
bucket's padded rows row by row, and ``probe_csr_rows`` must rebuild those
rows exactly, on the w128, w512 and top buckets of small graphs; on rows
built to the edge (empty forward rows, disjoint ranges, rows past the
width, rows longer than the kernel's per-warp table) it must equal a
numpy intersection and the reference's Pallas K2 run in interpret mode.
Plans: a device-prepped filtered plan binds each resident probe bucket to
the CSR (``CsrProbeLaunch``, on the bucket's real rows only) on both
backends, and every other route keeps the padded rows.
"""

import numpy as np
import pytest
import torch

from probe_csr_rows import (FIXED_COUNTS, clique_and_sparse, edge_csr,
                            numpy_counts, offset_copy, random_graph,
                            row_cases)
from torch_reference import ref  # noqa: F401

from repro_torch.core import (DynamicTriangleCounter, GraphBatch,
                              TriangleCounter, plan_triangle_count,
                              triangle_count_scipy)
from repro_torch.core import engine, prep
from repro_torch.core.engine import CsrProbeLaunch, IntersectLaunch, _TiledStage
from repro_torch.graphs import rmat_graph
from repro_torch.graphs.device import DeviceGraph
from repro_torch.kernels.intersect import (
    LAUNCHES,
    intersect_counts_csr,
    intersect_counts_probe,
    intersect_counts_probe_csr,
    intersect_counts_probe_csr_kernel,
    probe_csr_rows,
)
from repro_torch.launch import roofline

CPU = torch.device("cpu")

GRAPHS = {
    "rmat12": lambda: rmat_graph(12, 16, seed=1),
    "random": lambda: random_graph(3000, 40000, seed=5),
    "clique200": lambda: clique_and_sparse(200, 3000, 20000, seed=7),
}

# (graph, widths, bucket widths that must appear)
BUCKET_CASES = [
    ("rmat12", (8, 32, 128, 512), {128}),
    ("rmat12", (8, 16), {128}),            # the top bucket, next_pow2(dmax)
    ("random", (4, 8, 16), {32}),          # the top bucket
    ("clique200", (8, 32, 128, 512), {128, 512}),
    ("clique200", (8, 32, 128), {256}),    # the top bucket
]


def forward_buckets(g, widths):
    dg = DeviceGraph.from_graph(g, device=CPU)
    buckets = prep.prepare_intersection_buckets_device(dg, widths=widths)
    fwd = dg.forward()
    return fwd.row_ptr, fwd.dst, buckets


@pytest.mark.parametrize("case", BUCKET_CASES,
                         ids=["{}-{}".format(c[0], "-".join(map(str, c[1])))
                              for c in BUCKET_CASES])
def test_csr_route_equals_padded_probe_row_by_row(case):
    name, widths, must = case
    g = GRAPHS[name]()
    row_ptr, col, buckets = forward_buckets(g, widths)
    assert must <= {b.width for b in buckets}
    total = 0
    for b in buckets:
        e = b.edges
        src, dst = b.src[:e], b.dst[:e]
        u, v = probe_csr_rows(row_ptr, col, src, dst, b.width)
        assert torch.equal(u, b.u_lists[:e]) and torch.equal(v, b.v_lists[:e])
        padded = intersect_counts_probe(b.u_lists, b.v_lists)
        assert not padded[e:].any()  # the padding rows read 0
        for got in (intersect_counts_probe_csr(row_ptr, col, src, dst, b.width),
                    intersect_counts_probe_csr_kernel(row_ptr, col, src, dst,
                                                      b.width),
                    intersect_counts_csr(row_ptr, col, src, dst,
                                         width=b.width)):
            assert got.dtype == torch.int32 and torch.equal(got, padded[:e])
        total += int(padded.sum(dtype=torch.int64))
    assert total == triangle_count_scipy(g)


@pytest.mark.parametrize("width", [1, 5, 33, 128, 512, 1024, 10000])
def test_csr_route_on_rows_to_the_edge(ref, width):
    """At 10000 ids N⁺(src) is longer than the kernel's per-warp table
    (it builds and probes the set in pieces of 2048); the plain version is
    the same function at every width."""
    rows, n, pairs = row_cases(width, seed=width)
    row_ptr, col = edge_csr(rows, n)
    src = torch.tensor([a for a, _ in pairs], dtype=torch.int32)
    dst = torch.tensor([b for _, b in pairs], dtype=torch.int32)
    want = numpy_counts(rows, pairs, width)
    assert list(want[:7]) == FIXED_COUNTS
    got = intersect_counts_probe_csr(row_ptr, col, src, dst, width)
    np.testing.assert_array_equal(got.numpy(), want)
    # a CSR whose ids start mid-allocation reads the same rows
    np.testing.assert_array_equal(
        intersect_counts_probe_csr_kernel(row_ptr, offset_copy(col, 3), src,
                                          dst, width).numpy(), want)
    if width <= 1024:  # the reference's K2 on the gathered rows
        u, v = (x.numpy() for x in probe_csr_rows(row_ptr, col, src, dst,
                                                  width))
        np.testing.assert_array_equal(np.asarray(ref.ops.intersect_counts(
            u, v, strategy="probe", backend="pallas", interpret=True,
            tile_edges=8)), want)


def test_padding_rows_are_not_handed_to_the_csr_route():
    """A bucket's padding rows carry src = dst = 0, which read as CSR rows
    count |N⁺(0)|: the plan's CSR stage takes the real rows only, and its
    total equals the padded stage's, whose padding rows read 0."""
    g = GRAPHS["rmat12"]()
    row_ptr, col, buckets = forward_buckets(g, (8, 32, 128, 512))
    zero = torch.zeros(1, dtype=torch.int32)
    deg0 = int(row_ptr[1] - row_ptr[0])
    assert int(intersect_counts_probe_csr(row_ptr, col, zero, zero, 512)) \
        == min(deg0, 512)
    plan = plan_triangle_count(g, "intersection", device=CPU)
    csr_stages = [st for st in plan.stages
                  if isinstance(st.executable, CsrProbeLaunch)]
    assert csr_stages
    for st in csr_stages:
        b = next(b for b in buckets if b.shape == st.shape_key)
        assert b.e_pad > b.edges  # the bucket has padding rows
        row_ptr_s, col_s, src, dst = st.args
        assert src.shape == dst.shape == (b.edges,)
        assert torch.equal(src, b.src[:b.edges])
        assert torch.equal(dst, b.dst[:b.edges])
        u, v = st.rows
        assert u.shape == v.shape == st.shape_key
        assert int(st.run()) == int(IntersectLaunch("probe", "kernel", None)(
            u, v))


@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_device_prepped_filtered_plan_binds_the_csr(backend, name):
    g = GRAPHS[name]()
    # the random graph's rows are all narrow: probe forced on every bucket
    kw = dict(strategy="probe") if name == "random" else {}
    plan = plan_triangle_count(g, "intersection", backend=backend, device=CPU,
                               **kw)
    probes = [st for st in plan.stages if st.strategy == "probe"]
    assert probes
    for st in plan.stages:
        assert isinstance(st.executable, CsrProbeLaunch) \
            == (st.strategy == "probe")
    dg = DeviceGraph.from_graph(g, device=CPU)
    fwd = dg.forward()
    for st in probes:
        row_ptr, col = st.args[:2]
        assert torch.equal(row_ptr, fwd.row_ptr) and torch.equal(col, fwd.dst)
        assert st.executable is engine.get_executable(
            "intersection_csr", backend, st.shape_key, strategy="probe")
        assert st.span_name == f"tc.stage probe w{st.shape_key[1]}"
        # all probe stages share the plan's one CSR
        assert st.args[0] is probes[0].args[0]
        assert st.args[1] is probes[0].args[1]
    assert plan.count() == triangle_count_scipy(g)
    assert plan.count() == plan_triangle_count(
        g, "intersection", backend=backend, prep_backend="host",
        device=CPU, **kw).count()


def test_csr_plan_per_vertex_counts_and_price():
    g = GRAPHS["clique200"]()
    tc = TriangleCounter(g, algorithm="intersection", device=CPU)
    host = TriangleCounter(g, algorithm="intersection", prep_backend="host",
                           device=CPU)
    np.testing.assert_array_equal(tc.triangles_per_vertex(),
                                  host.triangles_per_vertex())
    for st in tc.plan.stages:  # priced as the padded rows it reads in place of
        assert roofline.price_stage(st) == roofline.stage_cost(
            "intersection", st.shape_key)


def _no_csr(stages):
    return stages and not any(isinstance(getattr(st, "executable", None),
                                         CsrProbeLaunch) for st in stages)


PADDED_ROUTES = {
    "tiled": lambda g: plan_triangle_count(g, "intersection", device=CPU,
                                           max_device_bytes=1 << 15).stages,
    "host_prep": lambda g: plan_triangle_count(g, "intersection", device=CPU,
                                               prep_backend="host").stages,
    "full_variant": lambda g: plan_triangle_count(g, "intersection",
                                                  variant="full",
                                                  device=CPU).stages,
    "bfs": lambda g: plan_triangle_count(g, "bfs", device=CPU).stages,
}


@pytest.mark.parametrize("route", sorted(PADDED_ROUTES))
def test_other_routes_keep_the_padded_rows(route):
    g = GRAPHS["rmat12"]()
    stages = PADDED_ROUTES[route](g)
    assert _no_csr(stages)
    probes = [st for st in stages if st.strategy == "probe"]
    assert probes
    for st in probes:
        if isinstance(st, _TiledStage):
            assert all(c[0].dim() == 2 for c in st.chunks)
        else:
            assert isinstance(st.executable, IntersectLaunch)
            assert st.args[0].dim() == 2 and st.rows is None
    total = int(sum(int(st.run()) for st in stages))
    divisor = 6 if route == "full_variant" else 1
    assert total // divisor == triangle_count_scipy(g)


def test_a_batch_keeps_the_padded_stacks():
    graphs = [GRAPHS["rmat12"](), GRAPHS["random"]()]
    batch = GraphBatch.from_graphs(graphs, device=CPU)
    assert all(a.dim() == 3 for a in batch.arrays)
    np.testing.assert_array_equal(
        batch.counts(), [triangle_count_scipy(g) for g in graphs])


def test_subgraph_and_dynamic_recount_take_the_csr_route():
    g = GRAPHS["clique200"]()
    truth = triangle_count_scipy(g)
    sub = plan_triangle_count(g, "subgraph", device=CPU)
    assert any(isinstance(st.executable, CsrProbeLaunch) for st in sub.stages)
    assert sub.count() == truth
    dyn = DynamicTriangleCounter(g, device=CPU)
    stages = dyn.plan.recount_stages()
    assert any(isinstance(st.executable, CsrProbeLaunch) for st in stages)
    assert sum(int(st.run()) for st in stages) == truth == dyn.recount()


def test_csr_wrapper_validates_inputs_and_never_launches_on_cpu():
    row_ptr, col = edge_csr({0: [1, 2], 1: [2]}, 4)
    src = torch.tensor([0, 1], dtype=torch.int32)
    dst = torch.tensor([1, 0], dtype=torch.int32)
    before = dict(LAUNCHES)
    assert intersect_counts_probe_csr_kernel(row_ptr, col, src, dst,
                                             4).tolist() == [1, 1]
    with pytest.raises(ValueError, match="int32"):
        intersect_counts_probe_csr_kernel(row_ptr.long(), col, src, dst, 4)
    with pytest.raises(ValueError, match="1-D"):
        intersect_counts_probe_csr_kernel(row_ptr, col[None], src, dst, 4)
    with pytest.raises(ValueError, match="one length"):
        intersect_counts_probe_csr_kernel(row_ptr, col, src, dst[:1], 4)
    with pytest.raises(ValueError, match="width"):
        intersect_counts_probe_csr_kernel(row_ptr, col, src, dst, 0)
    with pytest.raises(ValueError, match="contiguous"):
        intersect_counts_probe_csr_kernel(row_ptr, col, src.repeat(2)[::2],
                                          dst, 4)
    with pytest.raises(ValueError, match="unknown backend"):
        intersect_counts_csr(row_ptr, col, src, dst, width=4, backend="pallas")
    with pytest.raises(ValueError, match="probe strategy"):
        engine.get_executable("intersection_csr", "kernel", (2, 4),
                              strategy="broadcast")
    assert intersect_counts_probe_csr_kernel(row_ptr, col, src[:0], dst[:0],
                                             4).shape == (0,)
    assert dict(LAUNCHES) == before  # CPU tensors take the plain version
    assert "probe_csr" in LAUNCHES
