"""Host-side graph containers and format conversions (numpy).

The port's own copy of the host layer of ``repro.graphs.formats``: CSR
construction, forward (degree-rank) orientation, padded neighbour matrices,
degree-class bucketing, the degree-order permutation, induced subgraphs and
the block-sparse (BSR) tiling of the matrix lane. These stay numpy on the
host; the device prep that the counting lanes use lives in
``repro_torch.graphs.device``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "BlockSparse",
    "EdgeUpdate",
    "Graph",
    "apply_permutation",
    "bucket_edges_by_degree",
    "csr_to_padded_neighbors",
    "degree_order_permutation",
    "edges_to_csr",
    "graph_from_arrays",
    "induced_subgraph",
    "normalize_edge_updates",
    "orient_forward",
    "to_block_sparse",
]


class EdgeUpdate(NamedTuple):
    """One streamed edge mutation: insert (default) or delete edge (u, v).

    The dynamic lane (``repro_torch.core.api.DynamicTriangleCounter``)
    consumes batches of these. Endpoints are undirected: ``EdgeUpdate(3,
    7)`` and ``EdgeUpdate(7, 3)`` name the same edge. Inserting a present
    edge and deleting an absent one are both no-ops (set semantics).
    """

    u: int
    v: int
    insert: bool = True


def normalize_edge_updates(
    updates: Iterable[Union[EdgeUpdate, Tuple[int, ...]]], n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonicalize a batch of edge updates for the dynamic lane.

    Accepts ``EdgeUpdate``s, ``(u, v)`` pairs (insert) or ``(u, v,
    insert)`` triples. Endpoints become ``lo < hi``, self loops are
    dropped, and updates naming the same undirected edge are deduplicated
    last-wins, in the order of their last occurrence: the net effect of the
    batch applied in order.

    Args:
      updates: the update batch, in application order.
      n: vertex count; every endpoint must satisfy ``0 <= id < n``.

    Returns:
      (lo, hi, insert): int32 / int32 / bool arrays, one row per surviving
      distinct undirected edge.

    Raises:
      ValueError: malformed update tuples or out-of-range endpoints.
    """
    us, vs, ins = [], [], []
    for upd in updates:
        t = tuple(upd)
        if len(t) == 2:
            u, v, i = t[0], t[1], True
        elif len(t) == 3:
            u, v, i = t
        else:
            raise ValueError(
                f"edge update must be (u, v) or (u, v, insert), got {upd!r}"
            )
        us.append(u)
        vs.append(v)
        ins.append(bool(i))
    u = np.asarray(us, dtype=np.int64)
    v = np.asarray(vs, dtype=np.int64)
    flag = np.asarray(ins, dtype=bool)
    if u.size:
        bad = (u < 0) | (u >= n) | (v < 0) | (v >= n)
        if bad.any():
            j = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"edge update ({int(u[j])}, {int(v[j])}) out of range for "
                f"n={n}; endpoints must satisfy 0 <= id < n"
            )
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    keep = lo != hi  # drop self loops
    lo, hi, flag = lo[keep], hi[keep], flag[keep]
    if lo.size:
        # last wins: the first occurrence of each key in the reversed
        # batch, put back in batch order (int64 keys cannot overflow for
        # int32 ids)
        key = lo * (n + 1) + hi
        _, first_rev = np.unique(key[::-1], return_index=True)
        idx = np.sort(key.shape[0] - 1 - first_rev)
        lo, hi, flag = lo[idx], hi[idx], flag[idx]
    return lo.astype(np.int32), hi.astype(np.int32), flag


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected simple graph in CSR form.

    ``col_idx`` stores both directions of every undirected edge,
    deduplicated, self-loop free, sorted per row.
    """

    n: int
    row_ptr: np.ndarray  # (n+1,) int32
    col_idx: np.ndarray  # (m,) int32, m = #directed edges
    name: str = "graph"

    @property
    def m_directed(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def m_undirected(self) -> int:
        return int(self.col_idx.shape[0]) // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max(initial=0))

    def neighbors(self, v: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[v] : self.row_ptr[v + 1]]

    def edge_endpoints(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) of every directed CSR slot — src repeats each row id
        by its degree."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
        return src, self.col_idx

    def edge_list_unique(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) with src < dst: one row per undirected edge, in
        (src, dst) lexicographic order."""
        src, dst = self.edge_endpoints()
        keep = src < dst
        return src[keep], dst[keep]

    def to_scipy(self):
        import scipy.sparse as sp

        data = np.ones_like(self.col_idx, dtype=np.int64)
        return sp.csr_matrix(
            (data, self.col_idx, self.row_ptr), shape=(self.n, self.n)
        )


@dataclasses.dataclass(frozen=True)
class BlockSparse:
    """Block-sparse matrix with dense B×B tiles (BSR-like, tile list form).

    ``blocks[t]`` is the dense content of tile t, located at block
    coordinates ``(block_row[t], block_col[t])``. Tiles are sorted by
    (row, col).
    """

    n: int  # logical matrix dim (padded to a multiple of block)
    block: int  # tile edge length
    block_row: np.ndarray  # (T,) int32
    block_col: np.ndarray  # (T,) int32
    blocks: np.ndarray  # (T, block, block) float32

    @property
    def num_blocks(self) -> int:
        return int(self.block_row.shape[0])

    @property
    def grid(self) -> int:
        return self.n // self.block

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.n), dtype=self.blocks.dtype)
        b = self.block
        for i in range(self.num_blocks):
            r, c = int(self.block_row[i]) * b, int(self.block_col[i]) * b
            out[r:r + b, c:c + b] = self.blocks[i]
        return out


def graph_from_arrays(n: int, row_ptr, col_idx, name: str = "graph") -> Graph:
    """A ``Graph`` from CSR arrays another package produced.

    Takes the fields of any CSR container (for example the reference
    package's ``Graph``) as plain arrays, so that both packages count the
    same graph. The arrays are copied to int32 and checked for shape.

    Raises:
      ValueError: ``row_ptr`` is not of length ``n + 1``, does not start at
        0, or does not end at ``len(col_idx)``.
    """
    n = int(n)
    row_ptr = np.array(row_ptr, dtype=np.int32).ravel()
    col_idx = np.array(col_idx, dtype=np.int32).ravel()
    if row_ptr.shape[0] != n + 1 or row_ptr[0] != 0 \
            or row_ptr[-1] != col_idx.shape[0]:
        raise ValueError(
            f"row_ptr must have n+1={n + 1} entries from 0 to "
            f"len(col_idx)={col_idx.shape[0]}, got {row_ptr.shape[0]} "
            f"entries ending at {int(row_ptr[-1]) if row_ptr.size else None}"
        )
    return Graph(n=n, row_ptr=row_ptr, col_idx=col_idx, name=name)


def edges_to_csr(
    src: np.ndarray,
    dst: np.ndarray,
    n: Optional[int] = None,
    name: str = "graph",
) -> Graph:
    """Build a simple undirected CSR graph from a (possibly dirty) edge list.

    Symmetrizes, removes self loops, deduplicates parallel edges, and sorts
    each adjacency list by neighbour id.
    """
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    keep = src != dst
    src, dst = src[keep], dst[keep]
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    key = np.unique(u * n + v)  # unique sorts, so rows come out sorted
    u = (key // n).astype(np.int32)
    v = (key % n).astype(np.int32)
    counts = np.bincount(u, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(n=int(n), row_ptr=row_ptr, col_idx=v, name=name)


def orient_forward(g: Graph) -> Graph:
    """Forward DAG orientation: keep u→v iff rank(u) < rank(v), rank =
    (degree, id). Rows of the result are the N⁺ lists, sorted by id."""
    d = g.degrees
    src, dst = g.edge_endpoints()
    du, dv = d[src], d[dst]
    keep = (du < dv) | ((du == dv) & (src < dst))
    src, dst = src[keep], dst[keep]
    counts = np.bincount(src, minlength=g.n)
    row_ptr = np.zeros(g.n + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(n=g.n, row_ptr=row_ptr, col_idx=dst.astype(np.int32),
                 name=g.name + "+fwd")


def csr_to_padded_neighbors(
    g: Graph, pad_to: Optional[int] = None, fill: Optional[int] = None
) -> np.ndarray:
    """(n, pad_to) neighbour matrix padded with ``fill`` (default ``n``, an
    id that never matches a real neighbour). Rows wider than ``pad_to`` are
    truncated; bucketed callers only index rows that fit."""
    width = int(pad_to if pad_to is not None else max(1, g.max_degree))
    fill_v = g.n if fill is None else fill
    out = np.full((g.n, width), fill_v, dtype=np.int32)
    d = g.degrees
    if g.m_directed:
        cols = np.arange(g.m_directed) - np.repeat(g.row_ptr[:-1], d)
        rows = np.repeat(np.arange(g.n), d)
        keep = cols < width
        out[rows[keep], cols[keep]] = g.col_idx[keep]
    return out


def bucket_edges_by_degree(
    src: np.ndarray,
    dst: np.ndarray,
    out_degree: np.ndarray,
    widths: Sequence[int] = (8, 32, 128, 512),
) -> list:
    """Group edges by the max out-degree of their endpoints into buckets of
    static width (the paper's TwoSmall/TwoLarge grouping).

    Returns a list of dicts ``{width, src, dst}``, one per non-empty
    bucket; edges wider than ``widths[-1]`` land in a final bucket of width
    next pow2 ≥ the true max.
    """
    w = np.maximum(out_degree[src], out_degree[dst])
    buckets = []
    prev = 0
    bounds = list(widths)
    maxw = int(w.max(initial=0))
    if maxw > bounds[-1]:
        bounds.append(1 << int(np.ceil(np.log2(max(maxw, 1)))))
    for width in bounds:
        sel = (w > prev) & (w <= width)
        if sel.any():
            buckets.append(
                dict(width=int(width), src=src[sel].copy(), dst=dst[sel].copy())
            )
        prev = width
    return buckets


def degree_order_permutation(g: Graph) -> np.ndarray:
    """perm[new_id] = old_id sorted by (degree, old_id) increasing (the
    matrix lane's step 1: heavy rows go to the bottom-right)."""
    return np.lexsort((np.arange(g.n), g.degrees)).astype(np.int32)


def apply_permutation(g: Graph, perm: np.ndarray) -> Graph:
    """Relabel ``g`` so that new vertex i is old vertex ``perm[i]``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(g.n, dtype=np.int32)
    src, dst = g.edge_endpoints()
    return edges_to_csr(inv[src], inv[dst], n=g.n, name=g.name)


def induced_subgraph(g: Graph, vertex_mask: np.ndarray) -> Tuple[Graph, np.ndarray]:
    """Induced subgraph on ``vertex_mask`` (bool, length n), renumbered.

    Returns:
      (graph, old_ids) with ``old_ids[new] = old``.
    """
    old_ids = np.nonzero(vertex_mask)[0].astype(np.int32)
    remap = np.full(g.n, -1, dtype=np.int64)
    remap[old_ids] = np.arange(old_ids.shape[0])
    src, dst = g.edge_endpoints()
    keep = vertex_mask[src] & vertex_mask[dst]
    sub = edges_to_csr(remap[src[keep]], remap[dst[keep]],
                       n=int(old_ids.shape[0]), name=g.name + "+sub")
    return sub, old_ids


def to_block_sparse(g: Graph, block: int = 128, part: str = "full",
                    dtype=np.float32) -> BlockSparse:
    """Tile the adjacency matrix into dense B×B blocks, keeping only the
    nonzero tiles.

    Args:
      g: undirected simple ``Graph``.
      block: tile edge length B.
      part: "full" (A), "lower" (strict L) or "upper" (strict U).
      dtype: the tiles' dtype (0/1 values).

    Raises:
      ValueError: unknown ``part``.
    """
    if part not in ("full", "lower", "upper"):
        raise ValueError(f"unknown part {part!r}; expected 'full', 'lower' "
                         f"or 'upper'")
    src = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
    dst = g.col_idx.astype(np.int64)
    if part == "lower":
        keep = dst < src
        src, dst = src[keep], dst[keep]
    elif part == "upper":
        keep = dst > src
        src, dst = src[keep], dst[keep]
    n_pad = ((g.n + block - 1) // block) * block
    grid = n_pad // block
    key = (src // block) * grid + dst // block
    order = np.argsort(key, kind="stable")
    src, dst, key = src[order], dst[order], key[order]
    uniq = np.unique(key)
    t = uniq.shape[0]
    blocks = np.zeros((t, block, block), dtype=dtype)
    blocks[np.searchsorted(uniq, key), src % block, dst % block] = 1
    return BlockSparse(n=int(n_pad), block=block,
                       block_row=(uniq // grid).astype(np.int32),
                       block_col=(uniq % grid).astype(np.int32),
                       blocks=blocks)
