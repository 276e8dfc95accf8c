"""Dispatch for attention: the flash kernel or the materialised oracle.

The port of ``repro.kernels.flash_attention.ops``:

    backend    core                        notes
    --------   -------------------------   ---------------------------------
    "kernel"   ``flash_attention_kernel``  K6 on CUDA tensors; its plain
                                           version (``flash_attention_ref``)
                                           on CPU ones
    "ref"      ``flash_attention_ref``     materialised oracle

A CUDA tensor never falls back: a failed build or launch raises. The
reference's ``"pallas"`` backend is ``"kernel"`` here. Its ``"jnp"``
backend, the chunked online softmax, is ``repro_torch.models.layers.attention``
with ``backend="chunked"``, which this module does not import.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["BACKENDS", "flash_attention"]

BACKENDS = ("kernel", "ref")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None, prefix_len: int = 0,
                    backend: str = "kernel") -> torch.Tensor:
    """Attention of q (B, S, Hq, hd) over k, v (B, T, Hkv, hd) at positions
    ``arange(S)`` and ``arange(T)``, keys below ``prefix_len`` valid for
    every query; see the module docstring for the backends.

    Raises:
      ValueError: unknown backend, or bad inputs (``"kernel"``).
      RuntimeError: the kernel did not build or launch.
    """
    if backend == "kernel":
        return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      cap=cap, prefix_len=prefix_len)
    if backend == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap, prefix_len=prefix_len)
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
