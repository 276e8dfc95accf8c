"""Prep stages of the counting lanes: device-resident (torch) with numpy
twins.

The port of ``repro.core.prep``:

* ``prepare_intersection_buckets_device`` — orientation + bucket layout +
  padded gathers on a torch device, returning ``DeviceBucket``s;
* ``prepare_intersection_buckets_host`` — the numpy path, kept as the
  parity reference and for ``prep_backend="host"``;
* ``prepare_bfs_buckets_device`` — the bfs lane's BFS levels, (level, id)
  orientation and buckets, on the device;
* ``peel_to_two_core_device`` / ``induced_device_graph`` — the subgraph
  lane's FILTER (2-core peel) and RECONSTRUCT on the device, keeping the
  original vertex ids; ``peel_to_two_core`` is the host API;
* ``choose_block`` / ``tile_schedule`` / ``build_tile_schedule`` — the
  matrix lane's host stage: degree permutation, BSR tiling and the
  heavy-first (L, U, A) tile-triple schedule.

The only device→host traffic during device prep is a handful of scalars
(the max degree, the per-bucket counts, one "changed" flag per peel or BFS
round, the survivor edge count) needed to pick static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.graphs.formats import (
    Graph,
    apply_permutation,
    bucket_edges_by_degree,
    csr_to_padded_neighbors,
    degree_order_permutation,
    orient_forward,
    to_block_sparse,
)
from repro_torch.graphs.device import (
    DEFAULT_SHAPE_POLICY,
    DeviceCSR,
    DeviceGraph,
    ShapePolicy,
    _bfs_levels_dev,
    _bucket_sort_dev,
    _gather_bucket_dev,
    _induced_compact_dev,
    _padded_neighbors_dev,
    _two_core_peel_dev,
    next_pow2,
)
from repro_torch.core.options import DEFAULT_WIDTHS
from repro_torch.kernels.masked_spgemm.masked_spgemm import WGMMA_BLOCKS

__all__ = [
    "DeviceBucket",
    "TileSchedule",
    "build_tile_schedule",
    "choose_block",
    "induced_device_graph",
    "peel_to_two_core",
    "peel_to_two_core_device",
    "prepare_bfs_buckets_device",
    "prepare_intersection_buckets_device",
    "prepare_intersection_buckets_host",
    "tile_schedule",
]


@dataclasses.dataclass
class DeviceBucket:
    """One degree-class bucket, device-resident and statically shaped.

    ``u_lists``/``v_lists`` are (e_pad, width) int32 sorted neighbour
    lists; the first ``edges`` rows are real, the rest whole-row padding
    (u = -1, v = -2 ⇒ zero matches). ``src``/``dst`` are the (e_pad,) int32
    edge endpoints of each row (padding rows carry 0).
    """

    width: int
    edges: int
    u_lists: torch.Tensor
    v_lists: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor

    @property
    def e_pad(self) -> int:
        return int(self.u_lists.shape[0])

    @property
    def shape(self) -> tuple:
        return (self.e_pad, self.width)


def _check_variant(variant: str) -> None:
    if variant not in ("filtered", "full"):
        raise ValueError(
            f"unknown variant {variant!r}; expected 'filtered' or 'full'"
        )


def prepare_intersection_buckets_device(
    g: Union[Graph, DeviceGraph],
    *,
    variant: str = "filtered",
    widths: Sequence[int] = DEFAULT_WIDTHS,
    policy: Optional[ShapePolicy] = None,
    device: Union[None, str, torch.device] = None,
) -> List[DeviceBucket]:
    """Device-resident intersection prep: orientation + bucket layout +
    padded neighbour gathers.

    Args:
      g: a host ``Graph`` (uploaded once to ``device``) or a
        ``DeviceGraph``, which carries its own device and policy.
      variant: "filtered" (forward orientation; each triangle found once)
        or "full" (all directed edges with full lists; each found 6×).
      widths: ascending degree-class bucket widths; wider edges land in a
        final next-pow2 bucket.
      policy: the ``ShapePolicy`` rounding per-bucket extents (ignored for
        a ``DeviceGraph``).
      device: where a host ``Graph`` is uploaded; required for one.

    Returns:
      A list of ``DeviceBucket``; empty degree classes are dropped.
    """
    _check_variant(variant)
    if isinstance(g, DeviceGraph):
        dg = g
    else:
        if device is None:
            raise ValueError("a host Graph needs device= to be uploaded to")
        dg = DeviceGraph.from_graph(g, policy or DEFAULT_SHAPE_POLICY,
                                    device=device)
    if dg.m == 0:
        return []
    if variant == "filtered":
        fwd = dg.forward()
        src, dst, valid, deg = fwd.src, fwd.dst, fwd.kvalid, fwd.degrees
    else:
        src, dst, valid = dg.edge_sources(), dg.csr.col_idx, dg.edge_valid()
        deg = dg.csr.degrees
    return _gather_buckets(
        dg, src, dst, valid, deg, widths,
        lambda w: dg.padded_neighbors(w, oriented=(variant == "filtered")))


def prepare_bfs_buckets_device(dg: DeviceGraph, *,
                               widths: Sequence[int] = DEFAULT_WIDTHS
                               ) -> Tuple[List[DeviceBucket], torch.Tensor, int]:
    """The bfs lane's prep on the device: BFS levels, the (level, id)
    orientation, and the degree-class buckets of the oriented edges in CSR
    order, with the intersection lane's layout and sentinels.

    Returns:
      (buckets, (n,) int32 levels, BFS rounds run). An edgeless graph
      gives no buckets and zero rounds.
    """
    if dg.m == 0:
        return [], torch.zeros(dg.n, dtype=torch.int32, device=dg.device), 0
    lvl, rounds = _bfs_levels_dev(dg.edge_sources(), dg.csr.col_idx,
                                  dg.edge_valid(), n=dg.n)
    fwd = dg.level_oriented(lvl)
    buckets = _gather_buckets(
        dg, fwd.src, fwd.dst, fwd.kvalid, fwd.degrees, widths,
        lambda w: _padded_neighbors_dev(fwd.src, fwd.dst, fwd.kvalid,
                                        fwd.row_ptr, n=dg.n, width=w))
    return buckets, lvl, rounds


def _gather_buckets(dg: DeviceGraph, src: torch.Tensor, dst: torch.Tensor,
                    valid: torch.Tensor, deg: torch.Tensor,
                    widths: Sequence[int], neighbors) -> List[DeviceBucket]:
    """Sort oriented edge slots into degree-class buckets (by the larger
    endpoint degree, CSR order kept within a bucket) and gather each
    bucket's padded (u, v) rows from ``neighbors(width)``, the (n, width)
    neighbour matrix of the same orientation."""
    n = dg.n
    dmax = int(deg.max())  # one scalar sync picks the top-bucket width
    bounds = [int(w) for w in widths]
    if dmax > bounds[-1]:
        bounds.append(next_pow2(dmax))
    ssrc, sdst, counts, starts = _bucket_sort_dev(
        src, dst, valid, deg,
        torch.tensor(bounds, dtype=torch.int32, device=dg.device),
        n=n, num_bounds=len(bounds),
    )
    counts_h = counts.tolist()  # one small sync for the static extents
    starts_h = starts.tolist()
    # the (n, W) neighbour matrix only as wide as the widest non-empty
    # bucket: at n = 12M and W = 512 it would be 25 GB for buckets of width 8
    top = max((w for w, c in zip(bounds, counts_h) if c), default=bounds[0])
    nbrs = neighbors(top)

    out = []
    for i, w in enumerate(bounds):
        c = int(counts_h[i])
        if c == 0:
            continue
        e_pad = dg.policy.round_edges(c)
        u, v, sb, db = _gather_bucket_dev(
            ssrc, sdst, int(starts_h[i]), c, nbrs, n=n, e_pad=e_pad, width=w,
        )
        out.append(DeviceBucket(width=w, edges=c, u_lists=u, v_lists=v,
                                src=sb, dst=db))
    return out


def prepare_intersection_buckets_host(
    g: Graph,
    variant: str = "filtered",
    widths: Sequence[int] = DEFAULT_WIDTHS,
) -> list:
    """The numpy intersection prep, kept as the parity reference.

    Returns:
      A list of dicts ``{u_lists, v_lists, src, dst, width}``, one per
      non-empty degree-class bucket, with (E_b, W_b) int32 neighbour lists
      (u rows pad with ``n``, v rows with ``n + 1``) and (E_b,) endpoints.
    """
    _check_variant(variant)
    if variant == "filtered":
        base = orient_forward(g)
    else:
        base = g
    src, dst = base.edge_endpoints()
    buckets = bucket_edges_by_degree(src, dst, base.degrees, widths=widths)
    out = []
    for b in buckets:
        w = b["width"]
        nbrs = csr_to_padded_neighbors(base, pad_to=max(w, 1), fill=g.n)
        u_lists = nbrs[b["src"]]
        v_lists = nbrs[b["dst"]].copy()
        v_lists[v_lists == g.n] = g.n + 1  # disjoint sentinel
        out.append(dict(u_lists=u_lists, v_lists=v_lists,
                        src=b["src"], dst=b["dst"], width=w))
    return out


# ---------------------------------------------------------------------------
# Subgraph lane: FILTER (2-core peel) + RECONSTRUCT
# ---------------------------------------------------------------------------

def peel_to_two_core_device(dg: DeviceGraph) -> Tuple[torch.Tensor, int]:
    """Device 2-core peel (the subgraph lane's FILTER taken to its fixed
    point).

    Returns:
      ((n,) bool alive mask on the graph's device, peel rounds run).
    """
    if dg.m == 0:
        return torch.zeros(dg.n, dtype=torch.bool, device=dg.device), 0
    return _two_core_peel_dev(
        dg.edge_sources(), dg.csr.col_idx, dg.edge_valid(),
        torch.ones(dg.n, dtype=torch.bool, device=dg.device), n=dg.n,
    )


def induced_device_graph(dg: DeviceGraph, alive: torch.Tensor) -> DeviceGraph:
    """RECONSTRUCT on the device: keep the edges with both endpoints alive.

    Vertex ids are preserved (dead vertices keep their ids but lose their
    rows), so per-vertex scatters downstream stay in original-id space. One
    scalar sync (the survivor edge count) picks the policy-rounded extent of
    the compacted arrays.
    """
    if dg.m == 0:
        csr = DeviceCSR(
            n=dg.n, m=0,
            row_ptr=torch.zeros(dg.n + 1, dtype=torch.int32, device=dg.device),
            col_idx=torch.full((dg.policy.round_edges(0),), dg.n,
                               dtype=torch.int32, device=dg.device))
        return DeviceGraph(csr, policy=dg.policy, name=dg.name + "+sub")
    row_ptr_sub, col, kept_dev = _induced_compact_dev(
        dg.csr.row_ptr, dg.csr.col_idx, alive, dg.m,
        n=dg.n, m_pad=dg.csr.m_pad,
    )
    kept = int(kept_dev)
    csr = DeviceCSR(n=dg.n, m=kept, row_ptr=row_ptr_sub,
                    col_idx=col[:dg.policy.round_edges(kept)])
    return DeviceGraph(csr, policy=dg.policy, name=dg.name + "+sub")


def peel_to_two_core(g: Graph, labels: Optional[np.ndarray] = None,
                     query_label: Optional[int] = None) -> np.ndarray:
    """Candidate filter + iterated degree filter, to its fixed point (host
    API).

    Args:
      g: undirected simple ``Graph``.
      labels: optional (n,) vertex labels for labeled subgraph queries.
      query_label: with ``labels``, prune vertices whose label cannot match
        before the degree peel.

    Returns:
      (n,) bool numpy mask of the vertices surviving the 2-core peel (every
      triangle vertex has ≥ 2 alive neighbours, so counting on the induced
      subgraph is exact).
    """
    init = np.ones(g.n, dtype=bool)
    if labels is not None and query_label is not None:
        init &= np.asarray(labels) == query_label
    if g.m_directed == 0:
        return np.zeros(g.n, dtype=bool)
    src, dst = g.edge_endpoints()
    return _two_core_peel(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(init), n=g.n).numpy()


def _two_core_peel(src: torch.Tensor, dst: torch.Tensor,
                   init_alive: torch.Tensor, *, n: int) -> torch.Tensor:
    """Unmasked fixed-point peel over a concrete edge list (host callers)."""
    valid = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    return _two_core_peel_dev(src, dst, valid, init_alive, n=n)[0]


# ---------------------------------------------------------------------------
# Matrix lane: the host tile schedule
# ---------------------------------------------------------------------------

def choose_block(g: Graph) -> int:
    """Adaptive tile size: degree-permuted scale-free graphs fill the
    bottom-right tiles, so they get 128; mesh-like graphs (low, uniform
    degree) never fill tiles and get 32."""
    avg_deg = 2.0 * g.m_undirected / max(g.n, 1)
    return 128 if avg_deg >= 8.0 else 32


@dataclasses.dataclass
class TileSchedule:
    """The matrix lane's triple schedule: unique tiles and triple indices.

    ``l_blocks`` / ``u_blocks`` are the unique nonzero (·, B, B) float32
    tiles of the strict lower and strict upper parts (the A mask tiles are
    the strict-upper tiles, so ``u_blocks`` serves both). Triple t, in
    heavy-first order, is ``(l_blocks[l_index[t]], u_blocks[u_index[t]],
    u_blocks[a_index[t]])``.
    """

    l_blocks: np.ndarray
    u_blocks: np.ndarray
    l_index: np.ndarray  # (T,) int64
    u_index: np.ndarray  # (T,) int64
    a_index: np.ndarray  # (T,) int64
    stats: dict

    @property
    def num_triples(self) -> int:
        return int(self.l_index.shape[0])

    def gather(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The three (T, B, B) float32 stacks, gathered on the host (the
        reference's form; the matrix lane holds ``to_device``'s instead)."""
        return (self.l_blocks[self.l_index], self.u_blocks[self.u_index],
                self.u_blocks[self.a_index])

    def to_device(self, device: Union[str, torch.device]
                  ) -> Tuple[torch.Tensor, ...]:
        """The gathered form on ``device``: ``(l_blocks, u_blocks, l_index,
        u_index, a_index)``, the unique tiles and the three (T,) int32
        triple indices (the A tiles are ``u_blocks``).

        The tiles are bf16 when B is in ``WGMMA_BLOCKS`` (K4's tensor-core
        route; 0 and 1 are exact there) and float32 otherwise: the float32
        host tiles are uploaded and converted once on the card. Every index
        is checked here, once, against its tile array, because the kernels
        read through the indices unchecked.

        Raises:
          ValueError: an index outside its tile array.
        """
        dtype = (torch.bfloat16 if self.stats["block"] in WGMMA_BLOCKS
                 else torch.float32)
        index = []
        for name, idx, n in (("l_index", self.l_index, len(self.l_blocks)),
                             ("u_index", self.u_index, len(self.u_blocks)),
                             ("a_index", self.a_index, len(self.u_blocks))):
            if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
                raise ValueError(f"{name} outside [0, {n}): "
                                 f"[{int(idx.min())}, {int(idx.max())}]")
            index.append(torch.from_numpy(idx.astype(np.int32)).to(device))

        def tiles(a):
            return torch.from_numpy(a).to(device).to(dtype)

        return (tiles(self.l_blocks), tiles(self.u_blocks), *index)


def tile_schedule(g: Graph, block: int = 128,
                  permute: bool = True) -> TileSchedule:
    """The matrix lane's host stage: degree permutation, BSR tiling and
    the heavy-first (L, U, A) tile-triple schedule.

    For every strict-upper tile A[I, J] and every K present in both block
    row I of L and block column J of U, one triple (A[I, J], L[I, K],
    U[K, J]). The triple loop is the reference's, unchanged: it walks the
    A tiles in order and takes ``lk.keys() & uk.keys()``, whose set order
    fixes the triples' order before the stable heavy-first sort, so the
    stacks come out bit-equal to the reference's. The sort key is
    ``nnz(L)·nnz(U)`` in float32, as the reference computes it (products
    pass 2²⁴, so float32 rounding decides ties).
    """
    if permute:
        g = apply_permutation(g, degree_order_permutation(g))
    l_bsr = to_block_sparse(g, block=block, part="lower")
    u_bsr = to_block_sparse(g, block=block, part="upper")
    a_bsr = u_bsr  # the mask: the strict upper part

    l_rows: dict = {}
    for t in range(l_bsr.num_blocks):
        l_rows.setdefault(int(l_bsr.block_row[t]), []).append(
            (int(l_bsr.block_col[t]), t))
    u_cols: dict = {}
    for t in range(u_bsr.num_blocks):
        u_cols.setdefault(int(u_bsr.block_col[t]), []).append(
            (int(u_bsr.block_row[t]), t))

    trip_l, trip_u, trip_a = [], [], []
    for t in range(a_bsr.num_blocks):
        bi, bj = int(a_bsr.block_row[t]), int(a_bsr.block_col[t])
        lk = dict(l_rows.get(bi, ()))
        uk = dict(u_cols.get(bj, ()))
        for k in lk.keys() & uk.keys():
            trip_a.append(t)
            trip_l.append(lk[k])
            trip_u.append(uk[k])

    n_trip = len(trip_a)
    stats = dict(
        num_triples=n_trip,
        a_tiles=a_bsr.num_blocks,
        l_tiles=l_bsr.num_blocks,
        u_tiles=u_bsr.num_blocks,
        grid=a_bsr.grid,
        block=block,
        tile_flops=2 * n_trip * block**3,
    )
    trip_l = np.asarray(trip_l, dtype=np.int64)
    trip_u = np.asarray(trip_u, dtype=np.int64)
    trip_a = np.asarray(trip_a, dtype=np.int64)
    if n_trip:
        nnz_l = l_bsr.blocks.sum(axis=(1, 2))  # float32, exact (≤ B²)
        nnz_u = u_bsr.blocks.sum(axis=(1, 2))
        work = nnz_l[trip_l] * nnz_u[trip_u]
        order = np.argsort(-work, kind="stable")
        trip_l, trip_u, trip_a = trip_l[order], trip_u[order], trip_a[order]
    return TileSchedule(l_blocks=l_bsr.blocks, u_blocks=u_bsr.blocks,
                        l_index=trip_l, u_index=trip_u, a_index=trip_a,
                        stats=stats)


def build_tile_schedule(
    g: Graph, block: int = 128, permute: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """The reference's host API: ``tile_schedule`` gathered on the host.

    Returns:
      (l_tiles, u_tiles, a_tiles, stats): three (T, B, B) float32 stacks
      in heavy-first order, bit-equal to the reference's, plus the stats
      dict (num_triples, tile counts, grid, block, tile_flops).
    """
    sched = tile_schedule(g, block=block, permute=permute)
    return (*sched.gather(), sched.stats)
