"""The edge lane's k-truss peel and truss decomposition equal the
reference's, bit for bit.

``TriangleCounter(g, algorithm="edge", device="cpu")`` against
``repro.core.TriangleCounter(g, algorithm="edge")``: ``k_truss(k)`` (edge
set, ``peel_rounds``, ``peel_converged``) for k = 3…6, every forced
strategy, both prep backends and both key modes, with ``max_iters``
truncation and ``peel_early_exit=False``; ``truss_decomposition()`` and its
``ValueError`` on a truncated level; the port's ``listing`` against the
reference's; the scipy peel and decomposition of ``core/oracle.py``
against the reference's host peel; and a poison test showing that the
device peel never calls the host enumeration or the numpy prep.

The reference's decomposition re-traces every peel round (27 s on
tiny-grid and 40 s on tiny-rmat on a CPU), so its device plan is held on
the smallest graphs, and tiny-rmat, tiny-grid and the rest against the
reference's level-by-level host peel (``listing._k_truss_host``), which
its own tests hold equal to its device plan.
"""

import warnings

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401
from torch_edge_cases import (
    CPU,
    TINY,
    graph,
    listing_trussness,
    pair,
    ref_graph,
    same_graph,
    same_triple,
)

import repro_torch.core.listing as listing
import repro_torch.core.prep as prep_module
from repro_torch.core import (
    CountOptions,
    TriangleCounter,
    k_truss_forward_scipy,
    plan_edge_support,
    triangle_count_scipy,
    truss_decomposition_forward_scipy,
)
from repro_torch.graphs import grid_graph, rmat_graph

# (graph, prep backend) -> the k held; each reference peel round re-traces
KS = {("tiny-rmat", "device"): (3, 4, 5, 6), ("tiny-rmat", "host"): (3, 4),
      ("tiny-grid", "device"): (3, 5), ("rmat9", "device"): (6,)}
# the reference's device decomposition costs seconds only on these
DECOMPOSE_ON_DEVICE = ("empty6", "isolated9", "star16", "clique9",
                       "two-cliques", "path10")


@pytest.mark.parametrize("name,prep_backend", sorted(KS))
def test_k_truss_matches_reference(ref, name, prep_backend):
    g = graph(name)
    mine, theirs = pair(ref, g, prep_backend=prep_backend)
    for k in KS[name, prep_backend]:
        same_graph(mine.k_truss(k), theirs.k_truss(k), f"{name} k={k}")
        for key in ("peel_rounds", "peel_converged"):
            assert mine.plan.meta[key] == theirs.plan.meta[key], (k, key)


@pytest.mark.parametrize("strategy", ["broadcast", "probe", "bitmap"])
def test_k_truss_forced_strategies_match_reference(ref, strategy):
    g = graph("tiny-rmat")
    mine, theirs = pair(ref, g, strategy=strategy)
    for k in (4, 6):
        same_graph(mine.k_truss(k), theirs.k_truss(k), f"{strategy} k={k}")
        assert mine.plan.meta["peel_rounds"] == theirs.plan.meta["peel_rounds"]


@pytest.mark.parametrize("prep_backend", ["device", "host"])
def test_k_truss_wide_keys_match_reference(ref, prep_backend):
    g = graph("tiny-rmat")
    mine, theirs = pair(ref, g, key_mode="wide", prep_backend=prep_backend)
    for k in (4, 5):
        same_graph(mine.k_truss(k), theirs.k_truss(k), f"wide k={k}")
        for key in ("peel_rounds", "peel_converged"):
            assert mine.plan.meta[key] == theirs.plan.meta[key], (k, key)
    assert mine.plan.edge_keys.dtype == torch.int64


def test_k_truss_truncation_and_no_early_exit_match_reference(ref):
    g = grid_graph(6, spur_fraction=0.4, seed=9)  # a multi-round cascade
    mine, theirs = pair(ref, g)
    for iters in (1,):
        same_graph(mine.k_truss(4, max_iters=iters),
                    theirs.k_truss(4, max_iters=iters), f"max_iters={iters}")
        for key in ("peel_rounds", "peel_converged"):
            assert mine.plan.meta[key] == theirs.plan.meta[key]
    assert mine.plan.meta["peel_converged"] is False
    mine, theirs = pair(ref, g, peel_early_exit=False, max_peel_iters=4)
    k3 = [t.k_truss(3) for t in (mine, theirs)]  # converges in round 1
    same_graph(*k3, "no early exit")
    assert mine.plan.meta["peel_rounds"] == theirs.plan.meta["peel_rounds"] == 4
    assert mine.plan.meta["peel_converged"] is True
    # the peel knobs ride in the edge launches' cache keys
    assert mine.plan.shape_keys[0][-2:] == (4, False)
    assert mine.plan.shape_keys == theirs.plan.shape_keys


@pytest.mark.parametrize("name", DECOMPOSE_ON_DEVICE)
def test_truss_decomposition_matches_reference(ref, name):
    g = TINY[name]()
    mine, theirs = pair(ref, g)
    same_triple(mine.truss_decomposition(), theirs.truss_decomposition(),
                name)


@pytest.mark.parametrize("key_mode", ["auto", "wide"])
def test_truss_decomposition_matches_reference_host_peel(ref, key_mode):
    g = graph("tiny-grid")
    tc = TriangleCounter(g, device=CPU, algorithm="edge", key_mode=key_mode)
    same_triple(tc.truss_decomposition(),
                listing_trussness(ref.listing, ref_graph(ref, g)), "tiny-grid")


@pytest.mark.parametrize("prep_backend", ["device", "host"])
@pytest.mark.parametrize("name", ["tiny-rmat", "grid5", "rmat6"])
def test_truss_decomposition_matches_listing_and_scipy(name, prep_backend):
    """On graphs where the reference's decomposition costs tens of seconds:
    the port's decomposition against its own host peel (held to the
    reference's by ``test_listing_matches_reference``) and the scipy one."""
    g = graph(name)
    tc = TriangleCounter(g, device=CPU, algorithm="edge",
                         prep_backend=prep_backend)
    got = tc.truss_decomposition()
    same_triple(got, listing_trussness(listing, g), name)
    same_triple(got, truss_decomposition_forward_scipy(g), name)


def test_truss_decomposition_truncated_level_raises_like_reference(ref):
    g = grid_graph(6, spur_fraction=0.4, seed=9)
    mine, theirs = pair(ref, g, max_peel_iters=1)
    with pytest.raises(ValueError) as pe:
        mine.truss_decomposition()
    with pytest.raises(ValueError) as re_:
        theirs.truss_decomposition()
    assert str(pe.value) == str(re_.value)


def test_bitmap_bits_too_small_raises_like_reference(ref):
    g = graph("tiny-rmat")
    with pytest.raises(ValueError) as pe:
        plan_edge_support(g, strategy="bitmap", bitmap_bits=64, device=CPU)
    with pytest.raises(ValueError) as re_:
        ref.engine.plan_edge_support(ref_graph(ref, g), strategy="bitmap",
                                     bitmap_bits=64)
    assert str(pe.value) == str(re_.value)


@pytest.mark.parametrize("name", ["tiny-rmat", "clique9", "two-cliques",
                                  "empty6"])
def test_listing_matches_reference(ref, name):
    g = graph(name)
    rg = ref_graph(ref, g)
    np.testing.assert_array_equal(listing.enumerate_triangles(g),
                                  ref.listing.enumerate_triangles(rg))
    np.testing.assert_array_equal(listing.triangles_per_vertex(g),
                                  ref.listing.triangles_per_vertex(rg))
    np.testing.assert_array_equal(listing.clustering_coefficients(g),
                                  ref.listing.clustering_coefficients(rg))
    assert listing.transitivity(g) == ref.listing.transitivity(rg)
    same_triple(listing._edge_support_host(g),
                 ref.listing._edge_support_host(rg), name)
    for k in (3, 4, 5):
        same_graph(listing._k_truss_host(g, k),
                    ref.listing._k_truss_host(rg, k), f"{name} k={k}")


def test_listing_shims_warn_and_agree():
    g = rmat_graph(6, 6, seed=5)
    with pytest.warns(DeprecationWarning, match="TriangleCounter"):
        supp = listing.edge_support(g)[2]
    np.testing.assert_array_equal(supp, listing._edge_support_host(g)[2])
    with pytest.warns(DeprecationWarning):
        t = listing.k_truss(g, 4)
    same_graph(t, listing._k_truss_host(g, 4), "shim")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        tc = TriangleCounter(g, device=CPU, algorithm="edge")
        tc.edge_support()
        tc.k_truss(4)
        tc.truss_decomposition()


@pytest.mark.parametrize("name", ["tiny-rmat", "tiny-grid", "two-cliques",
                                  "empty6"])
def test_scipy_peel_and_decomposition_match_listing(ref, name):
    g = graph(name)
    rg = ref_graph(ref, g)
    tc = TriangleCounter(g, device=CPU, algorithm="edge")
    for k in (3, 5):
        truss, rounds = k_truss_forward_scipy(g, k)
        same_graph(truss, ref.listing._k_truss_host(rg, k), f"{name} k={k}")
        tc.k_truss(k)
        assert rounds == tc.plan.meta["peel_rounds"]
    if name != "tiny-rmat":  # the reference's host peel: 20 s there
        same_triple(truss_decomposition_forward_scipy(g),
                    listing_trussness(ref.listing, rg), name)


def test_device_peel_never_calls_host_enumeration(monkeypatch):
    """Under the device prep, edge_support / k_truss / truss_decomposition
    touch neither ``listing``'s enumeration nor the numpy prep helpers."""

    def _boom(*a, **k):
        raise AssertionError("host enumeration ran under the device peel")

    for name in ("enumerate_triangles", "edge_support", "k_truss",
                 "_edge_support_host", "_k_truss_host"):
        monkeypatch.setattr(listing, name, _boom)
    for name in ("prepare_intersection_buckets_host", "forward_edge_keys_host",
                 "orient_forward", "bucket_edges_by_degree",
                 "csr_to_padded_neighbors"):
        monkeypatch.setattr(prep_module, name, _boom)
    g = rmat_graph(6, 8, seed=7)
    tc = TriangleCounter(g, device=CPU, algorithm="edge")
    assert tc.count() == triangle_count_scipy(g)
    assert int(tc.edge_support()[2].sum()) == 3 * triangle_count_scipy(g)
    assert tc.k_truss(4).m_undirected <= g.m_undirected
    assert tc.truss_decomposition()[2].shape == (g.m_undirected,)


def test_truss_plan_surface_and_sidecar(ref):
    g = rmat_graph(6, 6, seed=5)
    tc = TriangleCounter(g, device=CPU, algorithm="edge")
    res = tc.count()
    assert res.plan is tc._edge_plan() and res.meta["edges"] == g.m_undirected
    assert res.plan.executions >= 1 and res.meta["device"] == "cpu"
    tc2 = TriangleCounter(g, device=CPU, algorithm="intersection")
    assert tc2._edge_plan() is tc2._edge_plan()  # one memoized sidecar
    same_graph(tc2.k_truss(3), tc.k_truss(3), "sidecar")
    plan = plan_edge_support(g, device=CPU)
    assert plan.count() == triangle_count_scipy(g)
    assert plan.num_stages == len(plan.shape_keys)
    theirs = ref.engine.plan_edge_support(ref_graph(ref, g))
    assert plan.shape_keys == theirs.shape_keys
    with pytest.raises(ValueError, match="max_peel_iters"):
        plan_edge_support(g, max_peel_iters=0, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA") if not torch.cuda.is_available() \
            else warnings.catch_warnings():
        TriangleCounter(g, algorithm="edge").edge_support()


def test_edge_options_validate_like_reference(ref):
    for kw in (dict(max_peel_iters=0), dict(max_peel_iters=True),
               dict(peel_early_exit=1), dict(key_mode="int64")):
        with pytest.raises(ValueError) as pe:
            CountOptions(**kw)
        with pytest.raises(ValueError) as re_:
            ref.options.CountOptions(**kw)
        assert str(pe.value) == str(re_.value)
    a = CountOptions()
    assert len({a.key(), a.replace(max_peel_iters=5).key(),
                a.replace(peel_early_exit=False).key(),
                a.replace(key_mode="wide").key()}) == 4
