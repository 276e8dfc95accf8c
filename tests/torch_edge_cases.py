"""Graphs and comparison helpers shared by the edge-lane parity tests
(``tests/test_torch_edge.py``, ``tests/test_torch_truss.py``)."""

import numpy as np
import torch

from repro_torch.core import TriangleCounter
from repro_torch.graphs import (
    complete_graph,
    edges_to_csr,
    grid_graph,
    load_dataset,
    path_graph,
    rmat_graph,
    star_graph,
)

CPU = torch.device("cpu")


def two_cliques():
    """K6 on {0..5} and K6 on {4..9}, sharing the edge (4, 5)."""
    edges = [(a, b) for a in range(6) for b in range(a + 1, 6)]
    edges += [(a, b) for a in range(4, 10) for b in range(a + 1, 10)]
    return edges_to_csr([e[0] for e in edges], [e[1] for e in edges], n=10,
                        name="two-cliques")


SUPPORT_GRAPHS = {
    "tiny-rmat": lambda: load_dataset("tiny-rmat"),
    "tiny-grid": lambda: load_dataset("tiny-grid"),
    "coauthors-like": lambda: load_dataset("coauthors-like"),
    "rmat9": lambda: rmat_graph(9, 8, seed=1),
}

TINY = {
    "empty6": lambda: edges_to_csr([], [], n=6, name="empty6"),
    "isolated9": lambda: edges_to_csr([0, 1], [1, 2], n=9, name="isolated9"),
    "star16": lambda: star_graph(16),
    "clique9": lambda: complete_graph(9),
    "two-cliques": two_cliques,
    "path10": lambda: path_graph(10),
    "grid5": lambda: grid_graph(5, spur_fraction=0.5, seed=3),
    "rmat6": lambda: rmat_graph(6, 8, seed=7),
}


def graph(name: str):
    return (SUPPORT_GRAPHS.get(name) or TINY[name])()


def ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def pair(ref, g, **kw):
    """The port's edge session on the CPU and the reference's, on ``g``."""
    mine = TriangleCounter(g, device=CPU, algorithm="edge", **kw)
    theirs = ref.api.TriangleCounter(
        ref_graph(ref, g), ref.options.CountOptions(algorithm="edge", **kw))
    return mine, theirs


def same_triple(a, b, what):
    """Equal arrays with equal dtypes, element by element."""
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=str(what))


def same_graph(a, b, what):
    assert a.n == b.n, what
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr, err_msg=str(what))
    np.testing.assert_array_equal(a.col_idx, b.col_idx, err_msg=str(what))


def same_meta(mine, theirs, what):
    """Every meta key both plans carry is equal (bucket shapes and
    strategies and the key mode among them)."""
    shared = [k for k in theirs if k in mine]
    assert {"bucket_shapes", "bucket_strategies", "key_mode"} <= set(shared)
    for k in shared:
        assert mine[k] == theirs[k], (what, k, mine[k], theirs[k])


def listing_trussness(listing, g):
    """Per-edge trussness from a ``listing._k_truss_host`` peel, level by
    level (either package's ``listing``)."""
    su, sv = g.edge_list_unique()
    n1 = g.n + 1
    keys = su.astype(np.int64) * n1 + sv
    truss = np.full(keys.shape[0], 2, dtype=np.int64)
    cur, k = g, 3
    while cur.m_undirected:
        nxt = listing._k_truss_host(cur, k)
        cu, cv = cur.edge_list_unique()
        nu, nv = nxt.edge_list_unique()
        ck = cu.astype(np.int64) * n1 + cv
        removed = ck[~np.isin(ck, nu.astype(np.int64) * n1 + nv)]
        truss[np.searchsorted(keys, removed)] = k - 1
        cur, k = nxt, k + 1
    return su, sv, truss
