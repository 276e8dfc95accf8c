"""Intersection-lane prep: device-resident (torch) with its numpy twin.

The port of the intersection half of ``repro.core.prep``:

* ``prepare_intersection_buckets_device`` — orientation + bucket layout +
  padded gathers on a torch device, returning ``DeviceBucket``s;
* ``prepare_intersection_buckets_host`` — the numpy path, kept as the
  parity reference and for ``prep_backend="host"``.

The only device→host traffic during prep is a handful of scalars (the max
degree and the per-bucket counts) needed to pick static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.graphs.formats import (
    Graph,
    bucket_edges_by_degree,
    csr_to_padded_neighbors,
    orient_forward,
)
from repro_torch.graphs.device import (
    DEFAULT_SHAPE_POLICY,
    DeviceGraph,
    ShapePolicy,
    _bucket_sort_dev,
    _gather_bucket_dev,
    next_pow2,
)
from repro_torch.core.options import DEFAULT_WIDTHS

__all__ = [
    "DeviceBucket",
    "prepare_intersection_buckets_device",
    "prepare_intersection_buckets_host",
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
    n = dg.n
    if dg.m == 0:
        return []

    if variant == "filtered":
        fwd = dg.forward()
        src, dst, valid, deg = fwd.src, fwd.dst, fwd.kvalid, fwd.degrees
    else:
        src, dst, valid = dg.edge_sources(), dg.csr.col_idx, dg.edge_valid()
        deg = dg.csr.degrees

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
    nbrs = dg.padded_neighbors(bounds[-1], oriented=(variant == "filtered"))

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
