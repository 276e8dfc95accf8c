"""The port's front door equals the reference's, and the port stands alone.

``repro_torch.TriangleCounter(..., device="cpu")`` against
``repro.core.TriangleCounter`` and scipy: counts for each forced strategy
and both variants, per-vertex counts, clustering coefficients,
transitivity and bucket strategies; the options and registry contracts;
and an import audit showing that neither the package nor ``chip_smoke.py``
touches JAX or ``repro``.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

import repro_torch
from repro_torch.core import registry
from repro_torch.core.engine import ALGORITHMS
from repro_torch.core import (
    CountOptions,
    TriangleCounter,
    available_algorithms,
    cache_info,
    clear_caches,
    plan_triangle_count,
    set_cache_limit,
    triangle_count_scipy,
)
from repro_torch.graphs import complete_graph, edges_to_csr, load_dataset, rmat_graph

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"

GRAPHS = {
    "tiny-rmat": lambda: load_dataset("tiny-rmat"),
    "tiny-grid": lambda: load_dataset("tiny-grid"),
    "rmat9": lambda: rmat_graph(9, 8, seed=1),
    "clique12": lambda: complete_graph(12),
}


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _ref_counter(ref, g, **kw):
    return ref.api.TriangleCounter(_ref_graph(ref, g),
                                   ref.options.CountOptions(**kw))


@pytest.mark.parametrize("variant", ["filtered", "full"])
@pytest.mark.parametrize("strategy", ["auto", "broadcast", "probe", "bitmap"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_counts_match_reference_and_scipy(ref, name, strategy, variant):
    g = GRAPHS[name]()
    kw = dict(algorithm="intersection", strategy=strategy, variant=variant)
    got = TriangleCounter(g, device=CPU, **kw).count()
    want = _ref_counter(ref, g, **kw).count()
    assert got.count == want.count == triangle_count_scipy(g)
    assert got.bucket_strategies == want.bucket_strategies
    assert got.meta["bucket_shapes"] == want.meta["bucket_shapes"]
    assert got.algorithm == "intersection"


@pytest.mark.parametrize("variant", ["filtered", "full"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_vertex_analysis_matches_reference(ref, name, variant):
    g = GRAPHS[name]()
    kw = dict(algorithm="intersection", variant=variant)
    tc = TriangleCounter(g, device=CPU, **kw)
    rc = _ref_counter(ref, g, **kw)
    t = tc.triangles_per_vertex()
    assert t.dtype == np.int64
    np.testing.assert_array_equal(t, rc.triangles_per_vertex())
    assert int(t.sum()) == 3 * triangle_count_scipy(g)
    np.testing.assert_allclose(tc.clustering_coefficients(),
                               rc.clustering_coefficients(), rtol=0, atol=1e-12)
    assert abs(tc.transitivity() - rc.transitivity()) <= 1e-12


def test_auto_resolves_like_reference(ref):
    g = GRAPHS["rmat9"]()
    assert TriangleCounter(g, device=CPU).algorithm == \
        ref.registry.choose_algorithm(_ref_graph(ref, g)) == "intersection"
    res = TriangleCounter(g, device=CPU).count()
    assert res.bucket_strategies == _ref_counter(ref, g).count().bucket_strategies


@pytest.mark.parametrize("name", ["tiny-grid", "clique12"])
def test_auto_on_other_lanes_raises_unregistered(ref, name, monkeypatch):
    g = GRAPHS[name]()
    lane = ref.registry.choose_algorithm(_ref_graph(ref, g))
    assert lane in ("subgraph", "matrix")
    # both lanes are registered: auto resolves as the reference does
    tc = TriangleCounter(g, device=CPU)
    assert tc.algorithm == lane and tc.count() == triangle_count_scipy(g)
    # a chosen lane that is not registered still raises the reference's error
    rest = tuple(sorted(set(available_algorithms()) - {lane}))
    assert set(ALGORITHMS) - {lane} <= set(rest)
    monkeypatch.delitem(registry._REGISTRY, lane)
    with pytest.raises(ValueError) as err:
        TriangleCounter(g, device=CPU)
    assert str(err.value) == (f"auto chooser returned unregistered lane "
                              f"{lane!r}; registered: {rest}")


def test_default_device_is_the_card():
    g = GRAPHS["tiny-rmat"]()
    if torch.cuda.is_available():
        assert TriangleCounter(g).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TriangleCounter(g)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            plan_triangle_count(g)


def test_host_prep_and_ref_backend_match():
    g = GRAPHS["rmat9"]()
    want = triangle_count_scipy(g)
    for kw in (dict(prep_backend="host"), dict(backend="ref"),
               dict(prep_backend="host", variant="full", strategy="probe")):
        assert TriangleCounter(g, device=CPU, **kw).count() == want
    assert TriangleCounter(g, device=CPU, prep_backend="host") \
        .count().meta["shape_policy"] is None


def test_empty_and_edgeless_graphs():
    for g in (edges_to_csr([], [], n=5), edges_to_csr([], [], n=0)):
        tc = TriangleCounter(g, device=CPU)
        assert tc.count() == 0
        assert tc.triangles_per_vertex().shape == (g.n,)


def test_options_validate_like_reference(ref):
    bad = [dict(variant="x"), dict(backend="jnp"), dict(strategy="merge"),
           dict(widths=(32, 8)), dict(widths=()), dict(bitmap_bits=33),
           dict(bitmap_bits=1 << 17), dict(prep_backend="gpu"),
           dict(shape_policy="pow2"), dict(max_device_bytes=0),
           dict(algorithm="nope"), dict(widths=5), dict(block=0),
           dict(block="big"), dict(block=True), dict(permute=1),
           dict(chooser="fastest")]
    for kw in bad:
        with pytest.raises(ValueError):
            CountOptions(**kw)
    # messages are the reference's wherever both packages take the field
    for kw in (dict(variant="x"), dict(strategy="merge"), dict(widths=(32, 8)),
               dict(bitmap_bits=33), dict(max_device_bytes=0), dict(block=0),
               dict(permute=1), dict(chooser="fastest")):
        with pytest.raises(ValueError) as pe:
            CountOptions(**kw)
        with pytest.raises(ValueError) as re_:
            ref.options.CountOptions(**kw)
        assert str(pe.value) == str(re_.value)
    a = CountOptions(widths=[8, 32, 128, 512])
    assert a == CountOptions() and hash(a) == hash(CountOptions())
    assert a.key() == CountOptions(shape_policy=a.resolved_shape_policy).key()
    assert a.replace(strategy="probe").key() != a.key()
    assert a.replace(block=32).key() != a.key()
    assert a.replace(permute=False).key() != a.key()
    assert a.chooser == ref.options.CountOptions().chooser == "heuristic"
    assert a.replace(chooser="measured").key() != a.key()
    assert a.replace(chooser="measured").plan_kwargs("intersection") == \
        a.plan_kwargs("intersection")
    assert a.plan_kwargs("intersection")["widths"] == (8, 32, 128, 512)
    for lane in ("matrix", "subgraph", "hash", "bfs", "edge", "dynamic",
                 "intersection_distributed", "matrix_distributed"):
        # the reference's keys, less interpret
        want = set(ref.options.CountOptions().plan_kwargs(lane)) - {"interpret"}
        assert set(a.plan_kwargs(lane)) == want
    with pytest.raises(ValueError, match="unknown engine lane"):
        a.plan_kwargs("edge_distributed")
    assert available_algorithms() == ("bfs", "dynamic", "edge", "hash",
                                      "intersection",
                                      "intersection_distributed", "matrix",
                                      "matrix_distributed", "subgraph")


def test_unported_surfaces_raise_not_implemented(ref):
    """``edge_support`` and ``k_truss`` raised ``NotImplementedError``
    until the edge lane was ported; they now answer as the reference does,
    through a sidecar edge plan of a counting session."""
    g = GRAPHS["tiny-rmat"]()
    tc = TriangleCounter(g, device=CPU)
    theirs = _ref_counter(ref, g)
    for a, b in zip(tc.edge_support(), theirs.edge_support()):
        np.testing.assert_array_equal(a, np.asarray(b))
    mine3, ref3 = tc.k_truss(3), theirs.k_truss(3)
    np.testing.assert_array_equal(mine3.row_ptr, ref3.row_ptr)
    np.testing.assert_array_equal(mine3.col_idx, ref3.col_idx)


def test_launch_cache_is_shared_and_bounded():
    clear_caches()
    g = GRAPHS["rmat9"]()
    p1 = plan_triangle_count(g, device=CPU)
    first = cache_info()
    assert first["misses"] == p1.num_stages and first["hits"] == 0
    p2 = plan_triangle_count(g, device=CPU)
    assert cache_info()["hits"] == p2.num_stages
    assert p1.stages[0].executable is p2.stages[0].executable
    old = set_cache_limit(1)
    try:
        assert cache_info()["size"] == 1 and cache_info()["evictions"] >= 1
        assert p1.count() == p2.count() == triangle_count_scipy(g)
    finally:
        set_cache_limit(old)
        clear_caches()


def test_bitmap_bits_override():
    g = GRAPHS["tiny-rmat"]()
    want = triangle_count_scipy(g)
    assert TriangleCounter(g, device=CPU, strategy="bitmap",
                           bitmap_bits=512).count() == want
    with pytest.raises(ValueError, match="cannot represent id range"):
        TriangleCounter(g, device=CPU, strategy="bitmap", bitmap_bits=64).count()


def test_import_without_jax_or_reference():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch, repro_torch.core, repro_torch.graphs, "
            "repro_torch.kernels.intersect, repro_torch.kernels.masked_spgemm, "
            "repro_torch.kernels.hash_tc, repro_torch.kernels._build, "
            "repro_torch.serve, repro_torch.core.calibrate, "
            "repro_torch.launch.roofline, repro_torch.launch.mesh; "
            "g = repro_torch.graphs.rmat_graph(6, 6, seed=2); "
            "svc = repro_torch.serve.TriangleService(device='cpu').start(); "
            "print(svc.count(g).count); svc.stop(); "
            "print(repro_torch.TriangleCounter(g, device='cpu').count().count)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = triangle_count_scipy(rmat_graph(6, 6, seed=2))
    assert [int(x) for x in out.stdout.split()] == [want, want]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_ast_audit_no_jax_or_reference_imports():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imported_roots(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (f, name)
    assert repro_torch.__name__ == "repro_torch"


def test_front_door_names_match_reference(ref):
    """``repro_torch.core`` exports every name of ``repro.core`` but the
    Pallas-only interpret knobs;
    ``repro_torch.serve`` exports exactly ``repro.serve``'s names."""
    import importlib

    import repro_torch.core
    import repro_torch.serve

    ref_core = importlib.import_module("repro.core")
    ref_serve = importlib.import_module("repro.serve")
    missing = set(ref_core.__all__) - set(repro_torch.core.__all__)
    assert missing == {"DEFAULT_INTERPRET", "resolve_interpret"}
    assert all(hasattr(repro_torch.core, n) for n in repro_torch.core.__all__)
    assert repro_torch.serve.__all__ == ref_serve.__all__
    assert all(hasattr(repro_torch.serve, n)
               for n in repro_torch.serve.__all__)
