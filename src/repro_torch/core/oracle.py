"""Ground-truth triangle counters (host, scipy/numpy) for tests and checks.

The port's copy of ``repro.core.oracle``, plus
``triangle_count_forward_scipy``: the same forward-algorithm work as a scipy
product over the oriented adjacency, which stays fast on graphs where
``A @ A`` does not (millions of edges); and the edge lane's oracles built
the same way: ``edge_support_forward_scipy``, the k-truss peel
``k_truss_forward_scipy`` and ``truss_decomposition_forward_scipy``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graphs.formats import Graph, edges_to_csr, orient_forward

__all__ = [
    "edge_support_forward_scipy",
    "k_truss_forward_scipy",
    "triangle_count_brute",
    "triangle_count_forward_cpu",
    "triangle_count_forward_scipy",
    "triangle_count_scipy",
    "truss_decomposition_forward_scipy",
]

# forward edges a chunk of the row products L[x]·L[y] takes
_ROW_PRODUCT_CHUNK = 1 << 20


def triangle_count_scipy(g: Graph) -> int:
    """trace(A³)/6 through scipy CSR products."""
    a = g.to_scipy()
    a2 = a @ a
    tri6 = a2.multiply(a).sum()
    return int(tri6) // 6


def triangle_count_forward_scipy(g: Graph) -> int:
    """Σ over forward edges (u, v) of |N⁺(u) ∩ N⁺(v)|, as
    ``((L @ L) ∘ L).sum()`` with L the forward-oriented adjacency."""
    lo = orient_forward(g).to_scipy()
    return int((lo @ lo).multiply(lo).sum())


def triangle_count_brute(g: Graph) -> int:
    """O(n^3) — tiny fixtures only."""
    a = g.to_scipy().toarray().astype(bool)
    count = 0
    for i in range(g.n):
        for j in range(i + 1, g.n):
            if a[i, j]:
                count += int((a[i] & a[j])[j + 1 :].sum())
    return count


def triangle_count_forward_cpu(g: Graph) -> int:
    """Sequential forward algorithm (Schank & Wagner) in numpy."""
    dag = orient_forward(g)
    count = 0
    rp, ci = dag.row_ptr, dag.col_idx
    for u in range(g.n):
        nu = ci[rp[u] : rp[u + 1]]
        for v in nu:
            nv = ci[rp[v] : rp[v + 1]]
            count += np.intersect1d(nu, nv, assume_unique=True).shape[0]
    return int(count)


def _values_at(m, rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """The entries of sparse ``m`` at (rows, cols), 0 where ``m`` has
    none, by a search of its sorted (row, col) keys."""
    m = m.tocsr()
    m.sort_indices()
    mrows = np.repeat(np.arange(n, dtype=np.int64), np.diff(m.indptr))
    mkeys = mrows * n + m.indices
    want = rows.astype(np.int64) * n + cols
    pos = np.minimum(np.searchsorted(mkeys, want), max(mkeys.size - 1, 0))
    if mkeys.size == 0:
        return np.zeros(want.shape, dtype=np.int64)
    return np.where(mkeys[pos] == want, m.data[pos], 0).astype(np.int64)


def edge_support_forward_scipy(g: Graph
                               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each undirected edge's triangle count, through scipy products over
    the forward DAG L (each triangle x → y → z with x → z, in rank order):

    * at (x, z): the y with x → y → z, ``(L @ L) ∘ L``;
    * at (y, z): the x with x → y and x → z, ``(Lᵀ @ L) ∘ L``;
    * at (x, y): the z with x → z and y → z, the row products
      ``L[x] · L[y]``, taken edge by edge in chunks (``L @ Lᵀ`` would hold
      every pair under a hub).

    The sum over the three is the support of each forward edge. Returns
    (src, dst, support) with src < dst in ``Graph.edge_list_unique`` order
    (int32, int32, int64), as ``listing._edge_support_host`` gives them.
    """
    n = g.n
    dag = orient_forward(g)
    lo_m = dag.to_scipy()
    rows, cols = dag.edge_endpoints()
    supp = _values_at((lo_m @ lo_m).multiply(lo_m), rows, cols, n)
    supp += _values_at((lo_m.T @ lo_m).multiply(lo_m), rows, cols, n)
    for s in range(0, rows.shape[0], _ROW_PRODUCT_CHUNK):
        r, c = rows[s:s + _ROW_PRODUCT_CHUNK], cols[s:s + _ROW_PRODUCT_CHUNK]
        supp[s:s + r.shape[0]] += np.asarray(
            lo_m[r].multiply(lo_m[c]).sum(axis=1), dtype=np.int64).ravel()
    lo = np.minimum(rows, cols).astype(np.int64)
    hi = np.maximum(rows, cols).astype(np.int64)
    order = np.argsort(lo * (n + 1) + hi, kind="stable")
    return (lo[order].astype(np.int32), hi[order].astype(np.int32),
            supp[order])


def k_truss_forward_scipy(g: Graph, k: int,
                          max_iters: int = 1000) -> Tuple[Graph, int]:
    """The k-truss by the bulk peel over ``edge_support_forward_scipy``:
    every round drops all edges with support < k − 2 at once, until a round
    drops none (or ``max_iters`` rounds). Returns (the k-truss, support
    rounds run), counted as the edge lane counts ``peel_rounds``."""
    cur, rounds = g, 0
    while rounds < max_iters and cur.m_undirected:
        su, sv, supp = edge_support_forward_scipy(cur)
        rounds += 1
        keep = supp >= (k - 2)
        if keep.all():
            break
        cur = edges_to_csr(su[keep], sv[keep], n=g.n,
                           name=g.name + f"+truss{k}")
    return cur, rounds


def truss_decomposition_forward_scipy(
        g: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each edge's trussness (the largest k whose k-truss keeps it; 2 for
    edges in no triangle) by ``k_truss_forward_scipy`` level by level, each
    level from the last one's survivors. Returns (src, dst, trussness) in
    ``Graph.edge_list_unique`` order."""
    su, sv = g.edge_list_unique()
    n1 = g.n + 1
    keys = su.astype(np.int64) * n1 + sv
    truss = np.full(keys.shape[0], 2, dtype=np.int64)
    cur, k = g, 3
    while cur.m_undirected:
        nxt, _ = k_truss_forward_scipy(cur, k)
        cu, cv = cur.edge_list_unique()
        nu, nv = nxt.edge_list_unique()
        ck = cu.astype(np.int64) * n1 + cv
        removed = ck[~np.isin(ck, nu.astype(np.int64) * n1 + nv)]
        truss[np.searchsorted(keys, removed)] = k - 1
        cur, k = nxt, k + 1
    return su, sv, truss
