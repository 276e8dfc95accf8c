"""Dispatch for the masked block-SpGEMM triangle core.

``backend``:

* ``"kernel"`` (default) — K4 (``csrc/masked_spgemm.cu``) on CUDA tensors;
  on CPU tensors its plain torch version, the chunked einsum
  ``masked_spgemm_chunked`` (the counterpart of the reference's
  ``_masked_spgemm_chunked``). A CUDA tensor never falls back: a build or
  launch failure raises.
* ``"ref"`` — the one-shot einsum oracle ``masked_spgemm_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.masked_spgemm.masked_spgemm import masked_spgemm_kernel
from repro_torch.kernels.masked_spgemm.ref import masked_spgemm_ref

__all__ = ["BACKENDS", "masked_spgemm_counts"]

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
