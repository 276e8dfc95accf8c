"""The port's hash lane equals the reference's, bit for bit.

``hash_num_buckets``, ``hash_table_depth`` and ``build_hash_table`` against
``repro.kernels.hash_tc``; the plain hash probe (K5's plain version) and
the structure-blind oracle against the reference's jnp and ref cores on
ragged shapes with sentinels (the reference's Pallas K5 does not run on the
installed JAX); the hash plan's stage arrays and meta against
``repro.core.engine.plan_triangle_count(g, "hash", backend="jnp")`` with
both prep backends; counts against scipy, and ``TriangleCounter`` with its
sidecar per-vertex counts. Every value is an integer: tolerance 0.
"""

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import TriangleCounter, plan_hash_count, triangle_count_scipy
from repro_torch.graphs import generators as port_gen
from repro_torch.graphs.datasets import load_dataset
from repro_torch.graphs.formats import (
    csr_to_padded_neighbors,
    edges_to_csr,
    orient_forward,
)
from repro_torch.kernels import hash_tc as ht
from repro_torch.kernels.hash_tc import probe as port_probe

CPU = torch.device("cpu")

GRAPHS = {
    "empty": lambda: edges_to_csr([], [], n=6, name="empty6"),
    "star": lambda: port_gen.star_graph(40),
    "clique": lambda: port_gen.complete_graph(20),
    "tiny-rmat": lambda: load_dataset("tiny-rmat"),
    "tiny-grid": lambda: load_dataset("tiny-grid"),
    "road-like": lambda: load_dataset("road-like"),
    "rmat9": lambda: port_gen.rmat_graph(9, 8),
    "rmat10-skew": lambda: port_gen.rmat_graph(10, 16, seed=5),
    "erdos": lambda: port_gen.erdos_renyi_graph(300, 12.0, seed=2),
    "watts": lambda: port_gen.watts_strogatz_graph(200, 8, 0.2, seed=4),
}


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _jnp(x):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(x))


def test_hash_num_buckets_matches_reference(ref):
    for w in list(range(0, 70)) + [127, 128, 129, 511, 512, 513, 8192, 10000]:
        assert ht.hash_num_buckets(w) == ref.hashops.hash_num_buckets(w), w


TABLE_GRAPHS = dict(GRAPHS, **{
    name: (lambda name=name: load_dataset(name))
    for name in ("coauthors-like", "citpatents-like")})


@pytest.mark.parametrize("name", list(TABLE_GRAPHS))
def test_depth_and_table_match_reference(ref, name):
    g = TABLE_GRAPHS[name]()
    fwd = orient_forward(g)
    width = max(8, fwd.max_degree)
    nbrs = csr_to_padded_neighbors(fwd, pad_to=width)
    nb_t = torch.from_numpy(nbrs)
    for num_buckets in sorted({8, ht.hash_num_buckets(width), 2 * width}):
        depth = ht.hash_table_depth(nb_t, num_buckets)
        want = int(ref.hashbuild.hash_table_depth(_jnp(nbrs), num_buckets))
        assert depth == want
        for d in sorted({1, max(1, depth), 1 << max(0, depth - 1).bit_length()}):
            table = ht.build_hash_table(nb_t, num_buckets=num_buckets, depth=d)
            rt = np.asarray(ref.hashbuild.build_hash_table(
                _jnp(nbrs), num_buckets=num_buckets, depth=d))
            assert table.dtype == torch.int32 and table.is_contiguous()
            np.testing.assert_array_equal(table.numpy(), rt)


def _ragged(rng, e, w, n):
    """(n, w) sorted unique rows below n (in-row padding n), (E,) anchors in
    [0, n + 3) (past n they clamp), (E, W) candidates drawn from the rows
    with sentinel n + 1 and whole padding rows -2."""
    nbrs = np.full((n, w), n, dtype=np.int32)
    for r in range(n):
        k = int(rng.integers(0, w + 1))
        nbrs[r, :k] = np.sort(rng.choice(n, size=min(k, n), replace=False))
    src = rng.integers(0, n + 3, size=e).astype(np.int32)
    cand = nbrs[rng.integers(0, n, size=e)].copy()
    cand[cand == n] = n + 1
    cand[e - e // 8:] = -2
    return nbrs, src, cand


@pytest.mark.parametrize("bd", [(8, 1), (8, 2), (32, 8), (64, 16)])
@pytest.mark.parametrize("e,w", [(1, 1), (7, 8), (100, 33), (257, 64)])
def test_plain_probe_matches_reference_cores(ref, e, w, bd):
    rng = np.random.default_rng(e * 100 + w)
    n = max(2 * w, 40)
    nbrs, src, cand = _ragged(rng, e, w, n)
    table = ht.build_hash_table(torch.from_numpy(nbrs), num_buckets=bd[0],
                                depth=bd[1])
    args = (torch.from_numpy(cand), torch.from_numpy(src), table)
    rargs = tuple(_jnp(a) for a in args)
    got = ht.hash_probe_counts_chunked(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.hashprobe.hash_probe_counts_jnp(*rargs)))
    np.testing.assert_array_equal(
        ht.hash_probe_counts_ref(*args).numpy(),
        np.asarray(ref.hashref.hash_probe_counts_ref(*rargs)))
    # on CPU tensors the kernel wrapper and the dispatch take the plain version
    assert torch.equal(ht.hash_probe_kernel(*args), got)
    assert torch.equal(ht.hash_probe_counts(*args, backend="kernel"), got)
    if bd[1] >= ht.hash_table_depth(torch.from_numpy(nbrs), bd[0]):
        assert torch.equal(ht.hash_probe_counts(*args, backend="ref"), got)


def test_plain_probe_chunks_agree(monkeypatch):
    rng = np.random.default_rng(3)
    nbrs, src, cand = _ragged(rng, 301, 16, 60)
    table = ht.build_hash_table(torch.from_numpy(nbrs), num_buckets=16, depth=8)
    args = (torch.from_numpy(cand), torch.from_numpy(src), table)
    whole = ht.hash_probe_counts_chunked(*args)
    monkeypatch.setattr(port_probe, "_PROBE_CHUNK_ELEMS", 16 * 8 * 7)
    assert torch.equal(ht.hash_probe_counts_chunked(*args), whole)


def test_any_semantics_on_a_repeated_id(ref):
    # anchor 0's bucket 1 holds id 9 twice: the bucketed cores count the
    # candidate once, the structure-blind oracle counts both copies
    table = np.full((12, 8, 4), -1, dtype=np.int32)
    table[0, 1, :2] = 9
    table[0, 3, 0] = 3
    cand = np.array([[9, 3, 5, 13], [-2, -2, -2, -2]], dtype=np.int32)
    src = np.array([0, 0], dtype=np.int32)
    args = (torch.from_numpy(cand), torch.from_numpy(src),
            torch.from_numpy(table))
    rargs = tuple(_jnp(a) for a in args)
    got = ht.hash_probe_counts_chunked(*args)
    assert got.tolist() == [2, 0]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.hashprobe.hash_probe_counts_jnp(*rargs)))
    oracle = ht.hash_probe_counts_ref(*args)
    assert oracle.tolist() == [3, 0]
    np.testing.assert_array_equal(
        oracle.numpy(), np.asarray(ref.hashref.hash_probe_counts_ref(*rargs)))


def test_probe_input_checks():
    cand = torch.zeros((4, 8), dtype=torch.int32)
    src = torch.zeros(4, dtype=torch.int32)
    table = torch.full((5, 8, 2), -1, dtype=torch.int32)
    assert ht.check_probe_inputs(cand, src, table) == (4, 8, 5, 8, 2)
    for bad, match in (((cand.long(), src, table), "int32"),
                       ((cand, src[:3], table), "src"),
                       ((cand, src, table[:, :6].contiguous()), "power of two"),
                       ((cand[:, ::2], src, table), "contiguous"),
                       ((cand, src, table[0]), "table")):
        with pytest.raises(ValueError, match=match):
            ht.hash_probe_kernel(*bad)
    with pytest.raises(ValueError, match="unknown backend"):
        ht.hash_probe_counts(cand, src, table, backend="jnp")
    assert ht.hash_probe_kernel(cand[:0], src[:0], table).shape == (0,)
    assert ht.hash_probe_counts_chunked(
        cand, src, table[:0]).tolist() == [0, 0, 0, 0]


_META = ("variant", "widths", "prep_backend", "shape_policy",
         "hash_num_buckets", "hash_depth", "table_width", "bucket_shapes",
         "bucket_edges", "edges", "n", "m")


@pytest.mark.parametrize("prep_backend", ["device", "host"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_hash_plan_matches_reference(ref, name, prep_backend):
    g = GRAPHS[name]()
    plan = plan_hash_count(g, prep_backend=prep_backend, device=CPU)
    rplan = ref.engine.plan_triangle_count(_ref_graph(ref, g), "hash",
                                           backend="jnp",
                                           prep_backend=prep_backend)
    for k in _META:
        assert (k in plan.meta) == (k in rplan.meta), k
        if k in rplan.meta:
            assert plan.meta[k] == rplan.meta[k], k
    assert plan.num_stages == len(rplan.stages)
    for st, rst in zip(plan.stages, rplan.stages):
        assert st.shape_key == rst.shape_key
        # (v_lists, src, row_end, chain_ptr, chain_vals) against the
        # reference's (v_lists, src, table)
        assert len(st.args) == 5 and len(rst.args) == 3
        assert all(a.dtype == torch.int32 for a in st.args)
        for a, ra in zip(st.args[:2], rst.args[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
        v = np.asarray(rst.args[0])
        valid = (v >= 0) & (v < g.n)
        np.testing.assert_array_equal(st.args[2].numpy(), np.where(
            valid, np.arange(1, v.shape[1] + 1), 0).max(axis=1, initial=0))
        compact = ht.CompactHashTable(st.args[3], st.args[4],
                                      plan.meta["hash_num_buckets"])
        np.testing.assert_array_equal(
            ht.expand_hash_table(compact, plan.meta["hash_depth"]).numpy(),
            np.asarray(rst.args[2]))
    if plan.num_stages:
        assert plan.meta["table_bytes"] == 4 * (
            plan.stages[0].args[3].numel() + plan.stages[0].args[4].numel())
    if plan.num_stages > 1:  # one plan-wide table, shared by every stage
        assert plan.stages[0].args[3] is plan.stages[-1].args[3]
        assert plan.stages[0].args[4] is plan.stages[-1].args[4]
    assert plan.count() == rplan.count() == triangle_count_scipy(g)


@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("name", ["tiny-rmat", "tiny-grid", "rmat10-skew",
                                  "clique", "star"])
def test_hash_counter_matches_reference(ref, name, backend):
    g = GRAPHS[name]()
    tc = TriangleCounter(g, device=CPU, algorithm="hash", backend=backend)
    res = tc.count()
    rc = ref.api.TriangleCounter(
        _ref_graph(ref, g), ref.options.CountOptions(algorithm="hash"))
    assert res.count == rc.count().count == triangle_count_scipy(g)
    assert res.algorithm == "hash" and res.bucket_strategies is None
    assert tc.count() == res  # a replay of the same plan
    with pytest.raises(NotImplementedError):  # no per-vertex stage ...
        res.plan.triangles_per_vertex()
    t = tc.triangles_per_vertex()  # ... so the filtered sidecar answers
    np.testing.assert_array_equal(t, rc.triangles_per_vertex())
    assert int(t.sum()) == 3 * res.count


def test_hash_lane_on_empty_and_edgeless_graphs():
    for g in (edges_to_csr([], [], n=5), edges_to_csr([], [], n=0),
              port_gen.path_graph(6)):
        tc = TriangleCounter(g, device=CPU, algorithm="hash")
        res = tc.count()
        assert res.count == 0
        assert tc.triangles_per_vertex().shape == (g.n,)
        if g.m_undirected == 0:
            assert res.meta["bucket_shapes"] == [] and res.meta["edges"] == 0
            assert "hash_depth" not in res.meta
