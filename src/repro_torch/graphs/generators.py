"""Synthetic graph generators (numpy), the port's copy of
``repro.graphs.generators``.

R-MAT (scale-free, Graph500 parameters), 2D grid + diagonals (road-like
meshes with leaf spurs), Erdős–Rényi and Watts–Strogatz controls, plus
closed-form fixtures (K_n, stars, paths). Each draws from
``numpy.random.default_rng(seed)`` in the reference's order, so a seed gives
the reference's edges bit for bit.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import Graph, edges_to_csr

__all__ = [
    "rmat_graph",
    "grid_graph",
    "erdos_renyi_graph",
    "watts_strogatz_graph",
    "complete_graph",
    "star_graph",
    "path_graph",
]


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    name: str | None = None,
) -> Graph:
    """R-MAT scale-free generator (Graph500 parameters by default)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for lvl in range(scale):
        r = rng.random(m)
        right = r >= ab  # falls into c or d quadrant -> src bit set
        lower = (r >= a) & (r < ab) | (r >= abc)  # b or d quadrant -> dst bit
        src |= right.astype(np.int64) << lvl
        dst |= lower.astype(np.int64) << lvl
    return edges_to_csr(src, dst, n=n, name=name or f"rmat{scale}")


def grid_graph(side: int, diagonals: bool = True, spur_fraction: float = 0.2,
               seed: int = 0, name: str | None = None) -> Graph:
    """Road-network-like mesh: side×side 4-connected grid, optional diagonals
    (which create triangles), plus degree-1 leaf spurs (the mesh-like property
    the paper's SM filtering exploits)."""
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).astype(np.int64)
    edges = []
    edges.append((vid[:, :-1].ravel(), vid[:, 1:].ravel()))  # right
    edges.append((vid[:-1, :].ravel(), vid[1:, :].ravel()))  # down
    if diagonals:
        edges.append((vid[:-1, :-1].ravel(), vid[1:, 1:].ravel()))  # diag
    src = np.concatenate([e[0] for e in edges])
    dst = np.concatenate([e[1] for e in edges])
    n_total = n
    if spur_fraction > 0:
        rng = np.random.default_rng(seed)
        k = int(n * spur_fraction)
        anchors = rng.integers(0, n, size=k)
        leaves = n + np.arange(k)
        src = np.concatenate([src, anchors])
        dst = np.concatenate([dst, leaves])
        n_total = n + k
    return edges_to_csr(src, dst, n=n_total, name=name or f"grid{side}")


def erdos_renyi_graph(n: int, avg_degree: float = 8.0, seed: int = 0,
                      name: str | None = None) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return edges_to_csr(src, dst, n=n, name=name or f"er{n}")


def watts_strogatz_graph(n: int, k: int = 6, p: float = 0.1, seed: int = 0,
                         name: str | None = None) -> Graph:
    """Small-world ring lattice with rewiring — high clustering coefficient,
    the regime where triangle counting is used for small-world detection."""
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int64)
    src_list, dst_list = [], []
    for off in range(1, k // 2 + 1):
        src_list.append(base)
        dst_list.append((base + off) % n)
    src = np.concatenate(src_list)
    dst = np.concatenate(dst_list)
    rewire = rng.random(src.shape[0]) < p
    dst = np.where(rewire, rng.integers(0, n, size=src.shape[0]), dst)
    return edges_to_csr(src, dst, n=n, name=name or f"ws{n}")


def complete_graph(n: int) -> Graph:
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = ii < jj
    return edges_to_csr(ii[keep], jj[keep], n=n, name=f"K{n}")


def star_graph(n: int) -> Graph:
    """Hub + (n-1) leaves: zero triangles, maximally skewed degrees."""
    return edges_to_csr(np.zeros(n - 1, dtype=np.int64),
                        np.arange(1, n, dtype=np.int64), n=n, name=f"star{n}")


def path_graph(n: int) -> Graph:
    return edges_to_csr(np.arange(n - 1, dtype=np.int64),
                        np.arange(1, n, dtype=np.int64), n=n, name=f"path{n}")
