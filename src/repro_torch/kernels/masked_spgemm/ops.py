"""Dispatch for the masked block-SpGEMM triangle core.

``backend``:

* ``"kernel"`` (default) — K4 (``csrc/masked_spgemm.cu``) on CUDA tensors;
  on CPU tensors its plain torch version, the chunked product
  ``masked_spgemm_gathered_chunked`` (the counterpart of the reference's
  ``_masked_spgemm_chunked``). A CUDA tensor never falls back: a build or
  launch failure raises.
* ``"ref"`` — the one-shot einsum oracle ``masked_spgemm_ref`` (on the
  gathered form: over float32 stacks gathered from the tiles for it).

``masked_spgemm_counts`` takes (T, B, B) stacks;
``masked_spgemm_gathered_counts`` takes the unique tiles and the (T,) triple
indices, as the matrix lane holds them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.masked_spgemm.masked_spgemm import (
    masked_spgemm_gathered,
    masked_spgemm_kernel,
)
from repro_torch.kernels.masked_spgemm.ref import masked_spgemm_ref

__all__ = ["BACKENDS", "masked_spgemm_counts", "masked_spgemm_gathered_counts"]

BACKENDS = ("kernel", "ref")


def masked_spgemm_counts(l_tiles: torch.Tensor, u_tiles: torch.Tensor,
                         a_tiles: torch.Tensor, *,
                         backend: str = "kernel") -> torch.Tensor:
    """Per-triple masked wedge counts ``sum(A ∘ (L @ U))``.

    Args:
      l_tiles, u_tiles, a_tiles: (T, B, B) float32 0/1 tiles of the L, U
        and strict-upper mask parts; zero tiles contribute exactly 0.
      backend: "kernel" | "ref" (see the module docstring).

    Returns:
      (T,) float32 per-triple partial counts, each an exact integer ≤ B³.

    Raises:
      ValueError: unknown backend, or bad tiles (``"kernel"``).
      RuntimeError: the kernel did not build or launch.
    """
    if backend == "kernel":
        return masked_spgemm_kernel(l_tiles, u_tiles, a_tiles)
    if backend == "ref":
        return masked_spgemm_ref(l_tiles, u_tiles, a_tiles)
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def masked_spgemm_gathered_counts(l_blocks: torch.Tensor,
                                  u_blocks: torch.Tensor,
                                  a_blocks: torch.Tensor,
                                  l_index: torch.Tensor,
                                  u_index: torch.Tensor,
                                  a_index: torch.Tensor, *,
                                  order: Optional[torch.Tensor] = None,
                                  backend: str = "kernel") -> torch.Tensor:
    """Per-triple ``sum(A[a_index] ∘ (L[l_index] @ U[u_index]))`` over the
    unique (n, B, B) tiles (float32 or bf16) and (T,) int32 indices.

    Args:
      l_blocks, u_blocks, a_blocks, l_index, u_index, a_index, order: as
        ``masked_spgemm_gathered`` takes them.
      backend: "kernel" | "ref" (see the module docstring).

    Returns:
      (T,) float32 per-triple partial counts, each an exact integer ≤ B³.

    Raises:
      ValueError: unknown backend, or bad arguments (``"kernel"``).
      RuntimeError: the kernel did not build or launch.
    """
    if backend == "kernel":
        return masked_spgemm_gathered(l_blocks, u_blocks, a_blocks, l_index,
                                      u_index, a_index, order=order)
    if backend == "ref":
        return masked_spgemm_ref(
            l_blocks.index_select(0, l_index).float(),
            u_blocks.index_select(0, u_index).float(),
            a_blocks.index_select(0, a_index).float())
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
