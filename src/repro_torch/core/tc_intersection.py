"""Set-intersection (forward-algorithm) triangle counting: the paper's
best method (§3.2/§4.2).

The lane itself lives in ``core.engine`` (``plan_triangle_count(g,
"intersection")``), which registers it; the front door is
``TriangleCounter(g, CountOptions(algorithm="intersection", ...))``. This
module keeps the reference's import surface: the deprecated one-shot
``triangle_count_intersection`` and the numpy prep
``prepare_intersection_buckets``.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.graphs.formats import Graph
from repro_torch.core.engine import (
    DEFAULT_WIDTHS,
    prepare_intersection_buckets,
)

__all__ = ["prepare_intersection_buckets", "triangle_count_intersection"]


def triangle_count_intersection(
    g: Graph,
    *,
    variant: str = "filtered",
    backend: str = "kernel",
    widths=DEFAULT_WIDTHS,
    strategy: str = "auto",
    device: Union[None, str, torch.device] = None,
) -> int:
    """Deprecated shim: the exact count by batched set intersection.

    Use ``TriangleCounter(g, CountOptions(algorithm="intersection", ...))``;
    the keyword arguments map one to one onto ``CountOptions`` fields.
    Returns the count as a Python int.
    """
    from repro_torch.core.api import TriangleCounter, warn_deprecated
    from repro_torch.core.options import CountOptions

    warn_deprecated(
        "triangle_count_intersection(g, ...)",
        'TriangleCounter(g, CountOptions(algorithm="intersection", ...)).count()',
    )
    opts = CountOptions(
        algorithm="intersection", variant=variant, backend=backend,
        widths=tuple(widths), strategy=strategy,
    )
    return int(TriangleCounter(g, opts, device=device).count())
