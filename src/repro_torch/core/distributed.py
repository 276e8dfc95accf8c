"""Sharded triangle counting over a ``torch.distributed`` ``DeviceMesh``.

The port of ``repro.core.distributed``: it registers the planners of the
two sharded lanes and keeps the deprecated one-shot shims. The lanes are
ordinary ``TrianglePlan``s (``core.engine.plan_triangle_count(g,
"<lane>_distributed", mesh=mesh)``), run SPMD: one process a rank, every
rank planning the same graph in the same order.

  * ``"intersection_distributed"``: every rank preps the whole graph, deals
    each degree bucket round-robin over the mesh's ranks (shard ``s`` gets
    rows ``s``, ``s + P``, ...; ``graphs.device.ShardedDeviceCSR``) and
    keeps its own shard's rows, which its stages launch K1/K2/K3 on;
  * ``"matrix_distributed"``: the heavy-first tile triples are dealt the
    same way, and each rank holds the distinct tiles its triples name and
    launches K4 on its triples;
  * each rank adds its stages' partials on its device in int64, and ONE
    ``all_reduce(SUM)`` over the mesh's ranks gives the count (the
    reference's one scalar ``psum`` a bucket). A rank whose shard is empty
    launches nothing and joins the all-reduce.

The edge lane shards the same way under ``plan_edge_support(g, mesh=)``.
The sessions carry a mesh (``TriangleCounter(g, mesh=mesh)``) and both
choosers promote their pick to these lanes under a mesh of more than one
rank.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.core.engine import plan_triangle_count
from repro_torch.core.options import DEFAULT_WIDTHS
from repro_torch.core.registry import register_algorithm
from repro_torch.graphs.formats import Graph

__all__ = [
    "triangle_count_intersection_distributed",
    "triangle_count_matrix_distributed",
]


def _planner_matrix(g: Graph, options, *, device, mesh=None):
    """Registry planner for ``"matrix_distributed"``: the dealt tile
    triples, one K4 stage a rank, one all-reduce a count."""
    return plan_triangle_count(g, "matrix_distributed", device=device,
                               mesh=mesh,
                               **options.plan_kwargs("matrix_distributed"))


def _planner_intersection(g: Graph, options, *, device, mesh=None):
    """Registry planner for ``"intersection_distributed"``."""
    return plan_triangle_count(
        g, "intersection_distributed", device=device, mesh=mesh,
        **options.plan_kwargs("intersection_distributed"))


register_algorithm("matrix_distributed", _planner_matrix)
register_algorithm("intersection_distributed", _planner_intersection)


def triangle_count_matrix_distributed(
    g: Graph,
    mesh=None,
    *,
    block: int = 128,
    device: Union[None, str, torch.device] = None,
) -> int:
    """Deprecated shim: use ``TriangleCounter(g,
    CountOptions(algorithm="matrix_distributed", block=...), mesh=mesh)``.
    Returns the exact count as a Python int."""
    from repro_torch.core.api import TriangleCounter, warn_deprecated
    from repro_torch.core.options import CountOptions

    warn_deprecated(
        "triangle_count_matrix_distributed(g, mesh, ...)",
        'TriangleCounter(g, CountOptions(algorithm="matrix_distributed", '
        "...), mesh=mesh).count()",
    )
    opts = CountOptions(algorithm="matrix_distributed", block=block)
    return int(TriangleCounter(g, opts, mesh=mesh, device=device).count())


def triangle_count_intersection_distributed(
    g: Graph,
    mesh=None,
    *,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    strategy: str = "auto",
    device: Union[None, str, torch.device] = None,
) -> int:
    """Deprecated shim: use ``TriangleCounter(g,
    CountOptions(algorithm="intersection_distributed", ...), mesh=mesh)``.
    Returns the exact count as a Python int."""
    from repro_torch.core.api import TriangleCounter, warn_deprecated
    from repro_torch.core.options import CountOptions

    warn_deprecated(
        "triangle_count_intersection_distributed(g, mesh, ...)",
        'TriangleCounter(g, CountOptions(algorithm="intersection_distributed"'
        ", ...), mesh=mesh).count()",
    )
    opts = CountOptions(algorithm="intersection_distributed",
                        widths=tuple(widths), strategy=strategy)
    return int(TriangleCounter(g, opts, mesh=mesh, device=device).count())
