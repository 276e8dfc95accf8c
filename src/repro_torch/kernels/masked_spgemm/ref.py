"""One-shot einsum oracle for the fused masked block-SpGEMM kernel.

Inputs are stacked B×B dense tiles gathered by the matrix lane's schedule
(``repro_torch.core.prep.tile_schedule``): for triple t, ``l_tiles[t]`` is
the L tile at (I, K), ``u_tiles[t]`` the U tile at (K, J) and
``a_tiles[t]`` the mask tile A at (I, J). The output is the (T,) float32
per-triple masked partial wedge count ``sum(A ∘ (L @ U))``; their sum is
the triangle count when A covers the strict upper triangle.
"""

from __future__ import annotations

import torch

__all__ = ["masked_spgemm_ref"]


def masked_spgemm_ref(l_tiles: torch.Tensor, u_tiles: torch.Tensor,
                      a_tiles: torch.Tensor) -> torch.Tensor:
    """(T,) float32 ``sum(A_IJ ∘ (L_IK @ U_KJ))`` per triple, in one
    einsum over the whole (T, B, B) stacks."""
    prod = torch.einsum("tik,tkj->tij", l_tiles, u_tiles)
    return (prod * a_tiles).sum(dim=(1, 2)).to(torch.float32)
