"""Fused masked block-SpGEMM (K4 of the port) and its plain torch version.

``masked_spgemm_kernel`` launches the CUDA kernel ``masked_spgemm_kernel``
(``csrc/masked_spgemm.cu``), which replaces the TPU kernel
``_masked_spgemm_kernel`` / ``masked_spgemm_pallas`` of
``repro/kernels/masked_spgemm/masked_spgemm.py``: per tile triple,
``sum(A ∘ (L @ U))`` with the B×B product kept on chip.
``masked_spgemm_chunked`` is its plain torch version: the same einsum in
chunks of triples that bound the (chunk, B, B) product.

The wrapper checks its inputs, allocates the (T,) float32 output with
``torch.empty``, launches on PyTorch's current stream, raises if the launch
reported a CUDA error, and adds one to ``LAUNCHES["masked_spgemm"]``.
Launches happen nowhere else, so the counter shows whether a run went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

__all__ = [
    "LAUNCHES",
    "MAX_BLOCK",
    "check_tiles",
    "masked_spgemm_chunked",
    "masked_spgemm_kernel",
    "reset_launch_counts",
]

#: Largest tile edge B the kernel takes.
MAX_BLOCK = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"tc_masked_spgemm": (_P, _P, _P, _P, _I, _I, _P)}

#: Kernel launches since the last ``reset_launch_counts()``.
LAUNCHES: Dict[str, int] = {"masked_spgemm": 0}

# triples per chunk of the plain version
_CHUNK = 64


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_tiles(l_tiles: torch.Tensor, u_tiles: torch.Tensor,
                a_tiles: torch.Tensor) -> Tuple[int, int]:
    """Validate an (L, U, A) stack triple and return (T, B).

    Raises:
      ValueError: not three contiguous (T, B, B) float32 tensors of one
        shape on one device, or T past int32.
    """
    tiles = (l_tiles, u_tiles, a_tiles)
    if not all(isinstance(x, torch.Tensor) for x in tiles):
        raise ValueError("l_tiles, u_tiles and a_tiles must be torch tensors")
    shape = tuple(l_tiles.shape)
    if len(shape) != 3 or shape[1] != shape[2] \
            or any(tuple(x.shape) != shape for x in tiles):
        raise ValueError(f"tiles must be (T, B, B) stacks of one shape, got "
                         f"{[tuple(x.shape) for x in tiles]}")
    if any(x.dtype != torch.float32 for x in tiles):
        raise ValueError(f"tiles must be float32, got "
                         f"{[x.dtype for x in tiles]}")
    if any(x.device != l_tiles.device for x in tiles):
        raise ValueError(f"tiles on different devices: "
                         f"{[str(x.device) for x in tiles]}")
    if not all(x.is_contiguous() for x in tiles):
        raise ValueError("tiles must be contiguous")
    t, b = shape[0], shape[1]
    if t > 2 ** 31 - 1:
        raise ValueError(f"T = {t} triples exceeds the kernel's int32 extent")
    return t, b


def masked_spgemm_chunked(l_tiles: torch.Tensor, u_tiles: torch.Tensor,
                          a_tiles: torch.Tensor) -> torch.Tensor:
    """Plain torch version: (T,) float32 ``sum(A ∘ (L @ U))`` per triple,
    ``_CHUNK`` triples at a time."""
    t = int(l_tiles.shape[0])
    out = torch.empty(t, dtype=torch.float32, device=l_tiles.device)
    for s in range(0, t, _CHUNK):
        prod = torch.bmm(l_tiles[s:s + _CHUNK], u_tiles[s:s + _CHUNK])
        out[s:s + _CHUNK] = (prod * a_tiles[s:s + _CHUNK]).sum(dim=(1, 2))
    return out


def masked_spgemm_kernel(l_tiles: torch.Tensor, u_tiles: torch.Tensor,
                         a_tiles: torch.Tensor) -> torch.Tensor:
    """Per-triple ``sum(A ∘ (L @ U))``: K4 on CUDA tensors, the plain
    version on CPU tensors.

    Args:
      l_tiles, u_tiles, a_tiles: (T, B, B) float32 0/1 tiles, contiguous,
        any T ≥ 0; the kernel takes 1 ≤ B ≤ ``MAX_BLOCK``.

    Returns:
      (T,) float32 partial counts; with 0/1 inputs each is an exact integer
      ≤ B³ ≤ 2²⁴, whatever the summation order.

    Raises:
      ValueError: bad inputs (see ``check_tiles``), B past ``MAX_BLOCK`` on
        a CUDA tensor, or a device that is neither CPU nor CUDA.
      RuntimeError: the kernel did not build or launch.
    """
    t, b = check_tiles(l_tiles, u_tiles, a_tiles)
    dev = l_tiles.device
    if dev.type == "cpu":
        return masked_spgemm_chunked(l_tiles, u_tiles, a_tiles)
    if dev.type != "cuda":
        raise ValueError(f"the masked_spgemm kernel takes CUDA tensors, got {dev}")
    if b > MAX_BLOCK:
        raise ValueError(f"tile edge B = {b} exceeds the kernel's "
                         f"MAX_BLOCK = {MAX_BLOCK}")
    out = torch.empty(t, dtype=torch.float32, device=dev)
    if t == 0:
        return out
    lib = _build.load_library("masked_spgemm", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tc_masked_spgemm(l_tiles.data_ptr(), u_tiles.data_ptr(),
                                   a_tiles.data_ptr(), out.data_ptr(), t, b,
                                   stream)
    if err != 0:
        raise RuntimeError(f"tc_masked_spgemm launch failed with CUDA error "
                           f"{err} at (T, B) = ({t}, {b})")
    LAUNCHES["masked_spgemm"] += 1
    return out
