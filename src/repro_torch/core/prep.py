"""Prep stages of the counting lanes: device-resident (torch) with numpy
twins.

The port of ``repro.core.prep``:

* ``prepare_intersection_buckets_device`` — orientation + bucket layout +
  padded gathers on a torch device, returning ``DeviceBucket``s;
* ``prepare_intersection_buckets_host`` — the numpy path, kept as the
  parity reference and for ``prep_backend="host"``;
* ``bucket_is_tiled`` / ``_bucket_nbytes`` / ``_tile_chunk_rows`` — the
  ``max_device_bytes`` budget rule: a bucket over it is gathered in chunks
  into host memory (pinned on a CUDA device) and streamed at count time;
* ``prepare_bfs_buckets_device`` — the bfs lane's BFS levels, (level, id)
  orientation and buckets, on the device;
* ``peel_to_two_core_device`` / ``induced_device_graph`` — the subgraph
  lane's FILTER (2-core peel) and RECONSTRUCT on the device, keeping the
  original vertex ids; ``peel_to_two_core`` is the host API;
* ``choose_block`` / ``tile_schedule`` / ``build_tile_schedule`` — the
  matrix lane's host stage: degree permutation, BSR tiling and the
  heavy-first (L, U, A) tile-triple schedule;
* ``check_edge_key_range`` / ``forward_edge_keys_device`` /
  ``forward_edge_keys_host`` — the edge lane's undirected-edge addressing:
  each forward slot's packed key, sorted, and the permutation back to
  slots;
* ``delta_update_buckets`` — the dynamic lane's re-bucketing of one update
  batch's anchor edges, with no host sync.

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
    _sorted_edge_keys_dev,
    _bfs_levels_dev,
    _bucket_sort_dev,
    _gather_bucket_dev,
    _gather_bucket_rows_dev,
    _induced_compact_dev,
    _padded_neighbors_dev,
    _two_core_peel_dev,
    edge_key_dtype,
    edge_key_sentinel,
    next_pow2,
    resolve_edge_key_mode,
)
from repro_torch.core.options import DEFAULT_WIDTHS
from repro_torch.kernels.masked_spgemm.masked_spgemm import (
    WGMMA_BLOCKS,
    launch_order,
)
from repro_torch.spans import span

__all__ = [
    "DeviceBucket",
    "TileSchedule",
    "bucket_is_tiled",
    "build_tile_schedule",
    "check_edge_key_range",
    "choose_block",
    "delta_update_buckets",
    "forward_edge_keys_device",
    "forward_edge_keys_host",
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
    edge endpoints of each row (padding rows carry 0). A bucket over a
    ``max_device_bytes`` budget (``bucket_is_tiled``) holds its four arrays
    in host memory instead, pinned when the prep ran on a CUDA device.
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


def _bucket_nbytes(e_pad: int, width: int) -> int:
    """Device bytes one resident intersection bucket costs: the (e, w)
    int32 u/v neighbour-list pair plus the (e,) int32 src/dst endpoints
    (the reference's rule; ``count()`` streams only u and v)."""
    return int(e_pad) * (8 * int(width) + 8)


def _tile_chunk_rows(rows: int, row_bytes: int, max_device_bytes: int) -> int:
    """Largest pow2 chunk row count whose device footprint fits the budget
    (floored at 1: a budget below one row's cost streams row by row)."""
    c = 1
    while c * 2 <= rows and (c * 2) * row_bytes <= max_device_bytes:
        c *= 2
    return c


def bucket_is_tiled(e_pad: int, width: int,
                    max_device_bytes: Optional[int]) -> bool:
    """Whether an (e_pad, width) bucket streams under the budget rather
    than staying resident (the budget is per bucket, as in the reference)."""
    return max_device_bytes is not None \
        and _bucket_nbytes(e_pad, width) > max_device_bytes


def _host_array(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """An empty int32 host tensor that feeds ``device``: pinned when
    ``device`` is a CUDA device (a failure to pin raises), plain CPU memory
    otherwise."""
    return torch.empty(shape, dtype=torch.int32,
                       pin_memory=device.type == "cuda")


def prepare_intersection_buckets_device(
    g: Union[Graph, DeviceGraph],
    *,
    variant: str = "filtered",
    widths: Sequence[int] = DEFAULT_WIDTHS,
    policy: Optional[ShapePolicy] = None,
    device: Union[None, str, torch.device] = None,
    max_device_bytes: Optional[int] = None,
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
      max_device_bytes: optional per-bucket budget. A bucket over it
        (``bucket_is_tiled``) is gathered in row ranges of the stage's chunk
        size straight into host arrays (pinned on a CUDA device), so the
        device never holds it whole; its arrays equal the resident ones.

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
    buckets = _gather_buckets(
        dg, src, dst, valid, deg, widths,
        lambda w: dg.padded_neighbors(w, oriented=(variant == "filtered")),
        max_device_bytes=max_device_bytes)
    if max_device_bytes is not None:
        dg._nbrs.clear()  # a budgeted plan keeps no (n, top) neighbour matrix
    return buckets


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
                    widths: Sequence[int], neighbors,
                    max_device_bytes: Optional[int] = None
                    ) -> List[DeviceBucket]:
    """Sort oriented edge slots into degree-class buckets (by the larger
    endpoint degree, CSR order kept within a bucket) and gather each
    bucket's padded (u, v) rows from ``neighbors(width)``, the (n, width)
    neighbour matrix of the same orientation. A bucket over
    ``max_device_bytes`` is gathered chunk by chunk into host arrays
    (``_gather_bucket_host``)."""
    n = dg.n
    with span("tc.prep.bucket_sort"):
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
        args = (ssrc, sdst, int(starts_h[i]), c, nbrs)
        with span("tc.prep.gather"):
            if bucket_is_tiled(e_pad, w, max_device_bytes):
                u, v, sb, db = _gather_bucket_host(
                    *args, n=n, e_pad=e_pad, width=w,
                    max_device_bytes=max_device_bytes)
            else:
                u, v, sb, db = _gather_bucket_dev(*args, n=n, e_pad=e_pad,
                                                  width=w)
        out.append(DeviceBucket(width=w, edges=c, u_lists=u, v_lists=v,
                                src=sb, dst=db))
    return out


def _gather_bucket_host(sorted_src: torch.Tensor, sorted_dst: torch.Tensor,
                        start: int, count: int, nbrs: torch.Tensor, *, n: int,
                        e_pad: int, width: int, max_device_bytes: int):
    """``_gather_bucket_dev``'s arrays, built in host memory (pinned when
    the prep runs on a CUDA device): each range of ``_tile_chunk_rows``
    real rows is gathered on the device and copied down; the padding rows
    past ``count`` are filled on the host (u = -1, v = -2, src = dst = 0)."""
    dev = sorted_src.device
    chunk = _tile_chunk_rows(e_pad, _bucket_nbytes(1, width), max_device_bytes)
    u = _host_array((e_pad, width), dev)
    v = _host_array((e_pad, width), dev)
    sb = _host_array((e_pad,), dev)
    db = _host_array((e_pad,), dev)
    for lo in range(0, count, chunk):
        hi = min(lo + chunk, count)
        parts = _gather_bucket_rows_dev(sorted_src, sorted_dst, start, count,
                                        nbrs, n=n, lo=lo, hi=hi, width=width)
        for host, part in zip((u, v, sb, db), parts):
            host[lo:hi].copy_(part)  # a blocking copy: the host reads it next
    for host, fill in zip((u, v, sb, db), (-1, -2, 0, 0)):
        host[count:] = fill
    return u, v, sb, db


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
# Edge and dynamic lanes: packed edge keys, anchor re-bucketing
# ---------------------------------------------------------------------------

def check_edge_key_range(n: int, key_mode: str = "auto", *,
                         lane: str = "edge-support") -> str:
    """Resolve the edge lane's packed-key mode for a graph ("int32" or
    "wide"), through ``graphs.device.resolve_edge_key_mode``.

    Raises:
      GraphTooLargeError: the requested mode cannot represent the graph.
    """
    return resolve_edge_key_mode(n, key_mode, lane=lane)


def forward_edge_keys_device(
    g: Union[Graph, DeviceGraph],
    *,
    policy: Optional[ShapePolicy] = None,
    key_mode: str = "auto",
    device: Union[None, str, torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The edge lane's undirected-edge addressing, on the device.

    The forward orientation keeps one directed copy of every undirected
    edge, so a forward CSR slot is an undirected edge id. The edge lane
    adds support in slot order; this gives each slot's packed
    ``min·(n+1)+max`` key, sorted (``edge_list_unique`` order), and the
    permutation from sorted positions back to slots. Padding slots carry
    the sentinel and sort to the end.

    Args:
      g: a host ``Graph`` (uploaded to ``device``) or a ``DeviceGraph``
        (which carries its own device and policy; its cached forward
        orientation is shared with the bucket prep).
      policy: the ``ShapePolicy`` for a host graph.
      key_mode: "auto" | "int32" | "wide".
      device: where a host ``Graph`` is uploaded; required for one.

    Returns:
      (keys, perm, row_ptr, m): the (mk,) sorted keys (int32, or int64 in
      the wide mode), the (mk,) int32 slot permutation, the forward (n+1,)
      int32 row_ptr and the undirected edge count.
    """
    if isinstance(g, DeviceGraph):
        dg = g
    else:
        if device is None:
            raise ValueError("a host Graph needs device= to be uploaded to")
        dg = DeviceGraph.from_graph(g, policy or DEFAULT_SHAPE_POLICY,
                                    device=device)
    mode = check_edge_key_range(dg.n, key_mode)
    if dg.m == 0:
        mk = dg.policy.round_edges(0)
        return (torch.full((mk,), edge_key_sentinel(mode),
                           dtype=edge_key_dtype(mode), device=dg.device),
                torch.arange(mk, dtype=torch.int32, device=dg.device),
                torch.zeros(dg.n + 1, dtype=torch.int32, device=dg.device), 0)
    fwd = dg.forward()
    keys, perm = _sorted_edge_keys_dev(fwd.src, fwd.dst, fwd.kvalid,
                                       n1=dg.n + 1, wide=(mode == "wide"))
    return keys, perm, fwd.row_ptr, dg.m // 2


def forward_edge_keys_host(
    g: Graph, key_mode: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The numpy twin of ``forward_edge_keys_device``: host slots are the
    oriented DAG's CSR positions (``orient_forward``).

    Returns:
      (keys, perm, row_ptr, m): the unpadded (m,) sorted keys (int32, or
      int64 in the wide mode), the (m,) int32 slot permutation, the
      oriented (n+1,) int32 row_ptr, and m.
    """
    mode = check_edge_key_range(g.n, key_mode)
    dag = orient_forward(g)
    src, dst = dag.edge_endpoints()
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    key = (lo * (g.n + 1) + hi).astype(
        np.int64 if mode == "wide" else np.int32)
    perm = np.argsort(key, kind="stable").astype(np.int32)
    return key[perm], perm, dag.row_ptr.astype(np.int32), int(key.shape[0])


def delta_update_buckets(lo_rows: torch.Tensor, hi_rows: torch.Tensor,
                         lo_deg: torch.Tensor, hi_deg: torch.Tensor,
                         lo: torch.Tensor, hi: torch.Tensor,
                         valid: torch.Tensor, *, n: int,
                         bounds: Sequence[int]) -> list:
    """Re-bucket one update batch's anchor edges by degree class, on the
    device and with no host sync.

    Each valid anchor edge goes to the first bound ≥ max(deg(lo),
    deg(hi)) (stable: batch order kept within a class); every class is
    gathered to a fixed (ub, width) layout, ub the batch's row extent, and
    an empty class is all padding rows (u = -1, v = -2), so the layout
    never depends on the data. The rows come from the step's anchor-row
    blocks, so the pass touches O(batch · width) data.

    Args:
      lo_rows, hi_rows: (ub, bounds[-1]) ascending anchor rows (in-row
        sentinel ``n``) of each anchor edge's endpoints.
      lo_deg, hi_deg: (ub,) their degrees.
      lo, hi: (ub,) anchor edge endpoints.
      valid: (ub,) mask of live anchor rows.
      n: vertex count.
      bounds: ascending class bounds; ``bounds[-1]`` ≥ the max degree.

    Returns:
      One ``(width, u_lists, v_lists, src, dst)`` per bound, each
      (ub, width) / (ub,) int32 with the repo-wide sentinels.
    """
    dev = lo.device
    ub = int(lo.shape[0])
    num_bounds = len(bounds)
    barr = torch.tensor([int(w) for w in bounds], dtype=torch.int32,
                        device=dev)
    w = torch.maximum(lo_deg, hi_deg).to(torch.int32)
    b = torch.searchsorted(barr, w)
    b = torch.where(valid, b, num_bounds)
    order = torch.sort(b, stable=True).indices
    counts = torch.bincount(b, minlength=num_bounds + 1)[:num_bounds]
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    rows = torch.arange(ub, device=dev)
    out = []
    for i, width in enumerate(bounds):
        width = int(width)
        bvalid = rows < counts[i]
        slot = order[(starts[i] + rows).clamp_(0, max(ub - 1, 0))]
        sb = torch.where(bvalid, lo[slot], 0).to(torch.int32)
        db = torch.where(bvalid, hi[slot], 0).to(torch.int32)
        u = torch.where(bvalid[:, None], lo_rows[slot, :width],
                        -1).to(torch.int32)
        vfull = hi_rows[slot, :width]
        v = torch.where(bvalid[:, None],
                        torch.where(vfull == n, n + 1, vfull),
                        -2).to(torch.int32)
        out.append((width, u, v, sb, db))
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
        dtype = self.tile_dtype
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

    @property
    def tile_dtype(self) -> torch.dtype:
        """bf16 at a B of K4's tensor-core route, else float32."""
        return (torch.bfloat16 if self.stats["block"] in WGMMA_BLOCKS
                else torch.float32)

    def host_chunks(self, rows: int, device: Union[str, torch.device]
                    ) -> List[Tuple[torch.Tensor, ...]]:
        """The gathered form cut into chunks of ``rows`` consecutive
        triples, on the host, for a stage that streams them to ``device``.

        Each chunk is ``(l_tiles, u_tiles, l_index, u_index, a_index,
        order)``: its own distinct L tiles and its distinct U-or-A tiles (in
        ``tile_dtype``), its triples' indices re-based onto them as (rows,)
        int32 vectors (the last chunk may be shorter), and its
        ``launch_order``. A chunk names at most ``3 × rows`` tiles. Pinned
        when ``device`` is a CUDA device.
        """
        dev = torch.device(device)
        pin = dev.type == "cuda"
        dtype = self.tile_dtype
        l_all = torch.from_numpy(self.l_blocks).to(dtype)
        u_all = torch.from_numpy(self.u_blocks).to(dtype)
        out = []
        for s in range(0, self.num_triples, rows):
            l_keep, u_keep, index = self._rebase(slice(s, s + rows))
            index = [torch.from_numpy(x) for x in index]
            chunk = (l_all.index_select(0, torch.from_numpy(l_keep)),
                     u_all.index_select(0, torch.from_numpy(u_keep)),
                     *index, launch_order(index[0], index[2]))
            out.append(tuple(x.pin_memory() for x in chunk) if pin else chunk)
        return out

    def shard(self, shard: int, num_shards: int,
              device: Union[str, torch.device]) -> Tuple[torch.Tensor, ...]:
        """Shard ``shard``'s triples of the round-robin deal (triples
        ``shard``, ``shard + P``, ... of the heavy-first order) in the
        gathered form on ``device``: ``(l_tiles, u_tiles, l_index, u_index,
        a_index, order)``, the distinct tiles its triples name (float32 on
        the host, converted to ``tile_dtype`` on the device) and its indices
        re-based onto them, as ``host_chunks`` cuts a chunk."""
        dev = torch.device(device)
        l_keep, u_keep, index = self._rebase(
            slice(int(shard), None, int(num_shards)))
        index = [torch.from_numpy(x).to(dev) for x in index]
        tiles = [torch.from_numpy(a[keep]).to(dev).to(self.tile_dtype)
                 for a, keep in ((self.l_blocks, l_keep),
                                 (self.u_blocks, u_keep))]
        return (*tiles, *index, launch_order(index[0], index[2]))

    def _rebase(self, sel: slice) -> tuple:
        """The distinct L tiles and U-or-A tiles that the triples ``sel``
        name, and their indices re-based onto them as int32 vectors:
        ``(l_keep, u_keep, [l_index, u_index, a_index])``."""
        li, ui, ai = (x[sel] for x in (self.l_index, self.u_index,
                                        self.a_index))
        l_keep, l_re = np.unique(li, return_inverse=True)
        u_keep, ua_re = np.unique(np.concatenate([ui, ai]),
                                  return_inverse=True)
        index = [x.reshape(-1).astype(np.int32) for x in
                 (l_re, ua_re[:len(ui)], ua_re[len(ui):])]
        return l_keep, u_keep, index


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
