"""Matrix-multiplication triangle counting as a fused masked block-SpGEMM.

Algorithm 3 of the paper (Azad/Buluç/Gilbert): permute A by increasing
degree, split A = L + U (strict lower/upper), count = Σ A ∘ (L·U) over the
strict upper part. The host builds a tile schedule instead of a sparse
product (``repro_torch.core.prep.tile_schedule``):

* the permuted A is tiled into dense B×B blocks; only nonzero tiles exist;
* for every strict-upper tile A[I, J] and every K present in both block
  row I of L and block column J of U, one triple (A[I, J], L[I, K],
  U[K, J]) — the paper's "avoid multiplications where A is known to be
  zero", lifted to tiles;
* the fused kernel (K4, ``repro_torch.kernels.masked_spgemm``) computes
  ``sum(A_IJ ∘ (L_IK @ U_KJ))`` per triple and never writes L·U out. The
  card holds only the unique tiles and the triple indices; K4 reads the
  tiles through the indices (bf16 on the tensor cores at B = 128, float32
  on the CUDA cores otherwise).

This module registers the ``"matrix"`` lane; the front door is
``TriangleCounter(g, CountOptions(algorithm="matrix", ...))``.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.graphs.formats import Graph
from repro_torch.core.engine import plan_triangle_count
from repro_torch.core.prep import build_tile_schedule, choose_block
from repro_torch.core.registry import register_algorithm

__all__ = ["build_tile_schedule", "choose_block", "triangle_count_matrix"]


def _planner(g: Graph, options, *, device, mesh=None):
    """Registry planner: CountOptions → matrix-lane TrianglePlan (a mesh
    is ignored)."""
    return plan_triangle_count(g, "matrix", device=device,
                               **options.plan_kwargs("matrix"))


register_algorithm("matrix", _planner)


def triangle_count_matrix(
    g: Graph,
    *,
    block=128,  # int or "auto" (see choose_block)
    permute: bool = True,
    backend: str = "kernel",
    device: Union[None, str, torch.device] = None,
) -> int:
    """Deprecated shim: the exact count by the fused masked block-SpGEMM.

    Use ``TriangleCounter(g, CountOptions(algorithm="matrix", ...))``.
    Returns the count as a Python int.
    """
    from repro_torch.core.api import TriangleCounter, warn_deprecated
    from repro_torch.core.options import CountOptions

    warn_deprecated(
        "triangle_count_matrix(g, ...)",
        'TriangleCounter(g, CountOptions(algorithm="matrix", ...)).count()',
    )
    opts = CountOptions(algorithm="matrix", block=block, permute=permute,
                        backend=backend)
    return int(TriangleCounter(g, opts, device=device).count())
