"""Ground-truth triangle counters (host, scipy/numpy) for tests and checks.

The port's copy of ``repro.core.oracle``, plus
``triangle_count_forward_scipy``: the same forward-algorithm work as a scipy
product over the oriented adjacency, which stays fast on graphs where
``A @ A`` does not (millions of edges).
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import Graph, orient_forward

__all__ = [
    "triangle_count_brute",
    "triangle_count_forward_cpu",
    "triangle_count_forward_scipy",
    "triangle_count_scipy",
]


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
