"""The edge lane's per-edge support equals the reference's, bit for bit.

``TriangleCounter(g, algorithm="edge", device="cpu")`` against
``repro.core.TriangleCounter(g, algorithm="edge")``: ``edge_support()``
(arrays and dtypes), ``count()`` and the plan's meta (bucket shapes and
strategies, key mode) for every forced strategy on tiny-rmat, tiny-grid,
coauthors-like and R-MAT scale 9, and in the wide key mode (forced, and on
a graph past n = 46,339); and the scipy oracle ``edge_support_forward_
scipy`` against the reference's ``listing._edge_support_host``.

One case compares against another reference run: the reference's bitmap
mask takes 32 s on coauthors-like on a CPU, so forced bitmap there is held
to the reference's own plan for its meta and to the reference's auto-run
support for its values (the reference holds its strategies equal in
``tests/test_truss.py``).
"""

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401
from torch_edge_cases import (
    SUPPORT_GRAPHS,
    graph,
    pair,
    ref_graph,
    same_meta,
    same_triple,
)

from repro_torch.core import (
    TrussPlan,
    edge_support_forward_scipy,
    triangle_count_scipy,
)
from repro_torch.graphs import edges_to_csr

@pytest.fixture(scope="module")
def auto_support():
    """Graph name -> the reference's auto-strategy support, kept for the
    module's tests."""
    return {}


def _reference_support(ref, name, theirs, strategy, auto_support):
    if name == "coauthors-like" and strategy == "bitmap":
        if name not in auto_support:
            auto_support[name] = pair(ref, graph(name))[1].edge_support()
        return auto_support[name]
    out = theirs.edge_support()
    if strategy == "auto":
        auto_support[name] = out
    return out


@pytest.mark.parametrize("strategy", ["auto", "broadcast", "probe", "bitmap"])
@pytest.mark.parametrize("name", sorted(SUPPORT_GRAPHS))
def test_edge_support_matches_reference(ref, auto_support, name, strategy):
    g = graph(name)
    mine, theirs = pair(ref, g, strategy=strategy)
    want = _reference_support(ref, name, theirs, strategy, auto_support)
    same_triple(mine.edge_support(), want, name)
    res = mine.count()
    assert res.count * 3 == int(np.asarray(want[2]).sum())
    assert res.count == triangle_count_scipy(g)
    assert res.algorithm == "edge" and isinstance(res.plan, TrussPlan)
    same_meta(mine.plan.meta, theirs.plan.meta, name)
    assert mine.plan.shape_keys == theirs.plan.shape_keys
    assert mine.plan.edge_keys.dtype == torch.int32


@pytest.mark.parametrize("prep_backend", ["device", "host"])
@pytest.mark.parametrize("name", ["tiny-rmat", "rmat9"])
def test_wide_keys_match_reference(ref, name, prep_backend):
    g = graph(name)
    mine, theirs = pair(ref, g, key_mode="wide", prep_backend=prep_backend)
    same_triple(mine.edge_support(), theirs.edge_support(), name)
    assert mine.plan.meta["key_mode"] == theirs.plan.meta["key_mode"] == "wide"
    assert mine.plan.edge_keys.dtype == torch.int64
    assert mine.plan.shape_keys == theirs.plan.shape_keys


def test_graph_past_the_int32_bound_takes_wide_keys(ref):
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 1 << 16, size=(2, 4000))
    src = np.concatenate([src, [1, 2, 1]])
    dst = np.concatenate([dst, [2, 3, 3]])  # one triangle at least
    g = edges_to_csr(src, dst, n=1 << 16, name="wide16")
    mine, theirs = pair(ref, g)
    same_triple(mine.edge_support(), theirs.edge_support(), "wide16")
    assert mine.plan.key_mode == theirs.plan.key_mode == "wide"
    assert mine.count() == triangle_count_scipy(g)


@pytest.mark.parametrize("name", ["tiny-rmat", "tiny-grid", "coauthors-like",
                                  "rmat9", "two-cliques", "empty6"])
def test_scipy_support_oracle_matches_listing(ref, name):
    g = graph(name)
    same_triple(edge_support_forward_scipy(g),
                ref.listing._edge_support_host(ref_graph(ref, g)), name)
