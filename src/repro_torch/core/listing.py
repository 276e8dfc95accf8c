"""Triangle enumeration and the paper's downstream applications, on the
host.

The port of ``repro.core.listing``: all three formulations enumerate
triangles as a side product, which serves k-truss, clustering coefficients
and transitivity (the paper's §1). These host paths materialize triangle
lists with numpy on the CPU; the session routes (``TriangleCounter``'s
``triangles_per_vertex`` / ``edge_support`` / ``k_truss`` /
``truss_decomposition``) replay device plans instead. ``edge_support`` and
``k_truss`` here are ``DeprecationWarning`` shims over ``_edge_support_host``
and ``_k_truss_host``, which stay as the oracles the edge lane is held to.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graphs.formats import (
    Graph,
    bucket_edges_by_degree,
    csr_to_padded_neighbors,
    edges_to_csr,
    orient_forward,
)

__all__ = [
    "clustering_coefficients",
    "edge_support",
    "enumerate_triangles",
    "k_truss",
    "transitivity",
    "triangles_per_vertex",
]

# compare elements a row chunk of the (E, W, W) match tensor holds
_CHUNK_ELEMS = 1 << 24


def _matched(u_lists: np.ndarray, v_lists: np.ndarray) -> np.ndarray:
    """(E, W) bool: which u-row entries occur in their v row."""
    e, w = u_lists.shape
    out = np.zeros((e, w), dtype=bool)
    step = max(1, _CHUNK_ELEMS // max(w * w, 1))
    for s in range(0, e, step):
        out[s:s + step] = (u_lists[s:s + step, :, None]
                           == v_lists[s:s + step, None, :]).any(axis=2)
    return out


def enumerate_triangles(g: Graph) -> np.ndarray:
    """All triangles as a (Δ, 3) int32 array (src, dst, w) over forward
    edges src → dst, each triangle listed once, bucket by bucket in the
    reference's order."""
    dag = orient_forward(g)
    src = np.repeat(np.arange(dag.n, dtype=np.int32), dag.degrees)
    dst = dag.col_idx
    if src.size == 0:
        return np.zeros((0, 3), dtype=np.int32)
    buckets = bucket_edges_by_degree(src, dst, dag.degrees)
    out = []
    for b in buckets:
        w = b["width"]
        nbrs = csr_to_padded_neighbors(dag, pad_to=w, fill=g.n)
        u_lists = nbrs[b["src"]]
        v_lists = nbrs[b["dst"]].copy()
        v_lists[v_lists == g.n] = g.n + 1
        e_idx, w_idx = np.nonzero(_matched(u_lists, v_lists))
        tri_w = u_lists[e_idx, w_idx]
        out.append(np.stack([b["src"][e_idx], b["dst"][e_idx], tri_w], axis=1))
    if not out:
        return np.zeros((0, 3), dtype=np.int32)
    return np.concatenate(out, axis=0).astype(np.int32)


def triangles_per_vertex(g: Graph) -> np.ndarray:
    """(n,) int64: the triangles each vertex is in."""
    tris = enumerate_triangles(g)
    return np.bincount(tris.ravel(), minlength=g.n).astype(np.int64)


def clustering_coefficients(g: Graph) -> np.ndarray:
    """cc[v] = 2·t(v) / (d(v)·(d(v)−1)); 0 where degree < 2."""
    t = triangles_per_vertex(g).astype(np.float64)
    d = g.degrees.astype(np.float64)
    denom = d * (d - 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        cc = np.where(denom > 0, 2.0 * t / denom, 0.0)
    return cc


def transitivity(g: Graph) -> float:
    """3 · #triangles / #wedges."""
    tris = enumerate_triangles(g).shape[0]
    d = g.degrees.astype(np.int64)
    wedges = int((d * (d - 1) // 2).sum())
    return 3.0 * tris / wedges if wedges else 0.0


def edge_support(g: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deprecated: each undirected edge's triangle count.

    Use ``TriangleCounter(g).edge_support()``: the same (src, dst,
    support) with src < dst, from the edge lane. The numpy version stays
    as ``_edge_support_host``, the oracle.
    """
    from repro_torch.core.api import warn_deprecated

    warn_deprecated("edge_support(g)", "TriangleCounter(g).edge_support()")
    return _edge_support_host(g)


def _edge_support_host(g: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each undirected edge's triangle count from the enumeration (the
    numpy oracle). Returns (src, dst, support) with src < dst."""
    su, sv = g.edge_list_unique()
    key = su.astype(np.int64) * g.n + sv
    order = np.argsort(key)
    key_sorted = key[order]
    support = np.zeros(su.shape[0], dtype=np.int64)
    tris = enumerate_triangles(g)
    if tris.shape[0]:
        for a, b in ((0, 1), (0, 2), (1, 2)):
            lo = np.minimum(tris[:, a], tris[:, b]).astype(np.int64)
            hi = np.maximum(tris[:, a], tris[:, b]).astype(np.int64)
            pos = np.searchsorted(key_sorted, lo * g.n + hi)
            np.add.at(support, order[pos], 1)
    return su, sv, support


def k_truss(g: Graph, k: int, max_iters: int = 1000) -> Graph:
    """Deprecated: the maximal subgraph whose every edge is in ≥ k − 2
    triangles.

    Use ``TriangleCounter(g).k_truss(k)``: the edge lane's peel gives the
    same edge set. The numpy peel stays as ``_k_truss_host``, the oracle.
    """
    from repro_torch.core.api import warn_deprecated

    warn_deprecated("k_truss(g, k)", "TriangleCounter(g).k_truss(k)")
    return _k_truss_host(g, k, max_iters=max_iters)


def _k_truss_host(g: Graph, k: int, max_iters: int = 1000) -> Graph:
    """The numpy peel (the oracle): every round enumerates the triangles
    again and drops all edges with support < k − 2 at once."""
    cur = g
    for _ in range(max_iters):
        if cur.m_undirected == 0:
            return cur
        su, sv, supp = _edge_support_host(cur)
        keep = supp >= (k - 2)
        if keep.all():
            return cur
        cur = edges_to_csr(su[keep], sv[keep], n=cur.n, name=g.name + f"+truss{k}")
    return cur
