"""Fused masked block-SpGEMM (K4 of the port) and its plain torch version.

``masked_spgemm_gathered`` launches K4 (``csrc/masked_spgemm.cu``), which
replaces the TPU kernel ``_masked_spgemm_kernel`` / ``masked_spgemm_pallas``
of ``repro/kernels/masked_spgemm/masked_spgemm.py``: per tile triple t,
``sum(A[a_index[t]] ∘ (L[l_index[t]] @ U[u_index[t]]))`` with the B×B
product kept on chip. It reads the schedule's unique tiles through the
triple indices, so the (T, B, B) stacks the TPU kernel read are never
gathered. Two routes, chosen by the tiles' type with no fallback between
them:

* bf16 tiles with B in ``WGMMA_BLOCKS``: ``masked_spgemm_wgmma_kernel`` on
  the tensor cores (TMA, ``wgmma``), counted in
  ``LAUNCHES["masked_spgemm_wgmma"]``;
* float32 tiles, any B up to ``MAX_BLOCK``: ``masked_spgemm_kernel`` on the
  CUDA cores, counted in ``LAUNCHES["masked_spgemm"]``.

0 and 1 are exact in bf16 and every partial is an integer ≤ B³ ≤ 2²⁴, so
both routes give the plain version's bits. ``masked_spgemm_gathered_chunked``
is the plain version: it gathers ``_CHUNK`` triples at a time, converts them
to float32 and runs the batched product there. ``masked_spgemm_kernel``
keeps the stacked form: float32 (T, B, B) stacks, read through identity
indices.

On ``meta`` tensors (the dry run's ``lower_tc``) ``masked_spgemm_gathered``
is shape-only: it returns a (T,) float32 ``meta`` tensor and records the
kernel's work on those inputs in the active tally
(``launch.op_cost.record_kernel``: 2·T·B³ FLOPs in the tiles' type; the
tiles, the indices and the order read once, the partials written), and
builds and launches nothing.

The wrappers check their inputs, allocate the (T,) float32 output with
``torch.empty``, launch on PyTorch's current stream, raise if the launch
reported a CUDA error, and add one to the route's counter. Launches happen
nowhere else, so the counters show which kernel a run went through.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.spans import span

__all__ = [
    "LAUNCHES",
    "MAX_BLOCK",
    "WGMMA_BLOCKS",
    "check_gathered",
    "check_tiles",
    "launch_order",
    "masked_spgemm_chunked",
    "masked_spgemm_gathered",
    "masked_spgemm_gathered_chunked",
    "masked_spgemm_kernel",
    "reset_launch_counts",
]

#: Largest tile edge B the float32 kernel takes.
MAX_BLOCK = 256

#: Tile edges the bf16 tensor-core kernel is built for (the cases of
#: ``tc_masked_spgemm_wgmma`` in the source); bf16 tiles of any other edge
#: are refused.
WGMMA_BLOCKS = (128,)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tc_masked_spgemm": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "tc_masked_spgemm_wgmma": (_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P,
                               _I, _I, _P),
}

#: Kernel launches since the last ``reset_launch_counts()``, by route.
LAUNCHES: Dict[str, int] = {"masked_spgemm": 0, "masked_spgemm_wgmma": 0}

# triples per chunk of the plain versions
_CHUNK = 64
_INT32_MAX = 2 ** 31 - 1


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
    if t > _INT32_MAX:
        raise ValueError(f"T = {t} triples exceeds the kernel's int32 extent")
    return t, b


def check_gathered(l_blocks: torch.Tensor, u_blocks: torch.Tensor,
                   a_blocks: torch.Tensor, l_index: torch.Tensor,
                   u_index: torch.Tensor, a_index: torch.Tensor,
                   order: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """Validate the gathered form's arguments and return (T, B).

    Index values are not checked here (that would cost a device sync a
    launch): the schedule checks them once on the host where it makes them.

    Raises:
      ValueError: the tile arrays are not contiguous (n, B, B) float32 or
        bf16 tensors of one type and one B; the index vectors (and
        ``order``) are not contiguous (T,) int32 tensors of one T; the
        tensors are not on one device; or T or a tile count past int32.
    """
    blocks = (l_blocks, u_blocks, a_blocks)
    index = (l_index, u_index, a_index) + (() if order is None else (order,))
    if not all(isinstance(x, torch.Tensor) for x in blocks + index):
        raise ValueError("tiles, indices and order must be torch tensors")
    if any(x.dim() != 3 or x.shape[1] != x.shape[2] for x in blocks) \
            or len({x.shape[1] for x in blocks}) != 1:
        raise ValueError(f"tiles must be (n, B, B) arrays of one B, got "
                         f"{[tuple(x.shape) for x in blocks]}")
    dtypes = {x.dtype for x in blocks}
    if len(dtypes) != 1 or l_blocks.dtype not in (torch.float32,
                                                  torch.bfloat16):
        raise ValueError(f"tiles must be all float32 or all bfloat16, got "
                         f"{[x.dtype for x in blocks]}")
    if any(x.dim() != 1 or x.dtype != torch.int32 for x in index) \
            or len({x.shape[0] for x in index}) != 1:
        raise ValueError(f"indices and order must be (T,) int32 vectors of "
                         f"one T, got {[(tuple(x.shape), x.dtype) for x in index]}")
    if any(x.device != l_blocks.device for x in blocks + index):
        raise ValueError(f"tensors on different devices: "
                         f"{[str(x.device) for x in blocks + index]}")
    if not all(x.is_contiguous() for x in blocks + index):
        raise ValueError("tiles, indices and order must be contiguous")
    t, b = int(l_index.shape[0]), int(l_blocks.shape[1])
    if t > _INT32_MAX or any(x.shape[0] > _INT32_MAX for x in blocks):
        raise ValueError(f"T = {t} or a tile count exceeds the kernel's "
                         f"int32 extent")
    return t, b


def launch_order(l_index: torch.Tensor, a_index: torch.Tensor) -> torch.Tensor:
    """(T,) int32 launch order: the triples stably sorted by (a_index,
    l_index), so the blocks that run together read the same A and L tiles.
    Made once per plan, on the indices' device."""
    by_l = torch.sort(l_index, stable=True).indices
    by_a = torch.sort(a_index.index_select(0, by_l), stable=True).indices
    return by_l.index_select(0, by_a).to(torch.int32)


def masked_spgemm_chunked(l_tiles: torch.Tensor, u_tiles: torch.Tensor,
                          a_tiles: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the stacked form: (T,) float32
    ``sum(A ∘ (L @ U))`` per triple, ``_CHUNK`` triples at a time (the
    gathered form's plain version with identity indices)."""
    idx = torch.arange(int(l_tiles.shape[0]), dtype=torch.int32,
                       device=l_tiles.device)
    return masked_spgemm_gathered_chunked(l_tiles, u_tiles, a_tiles, idx, idx,
                                          idx)


def masked_spgemm_gathered_chunked(l_blocks: torch.Tensor,
                                   u_blocks: torch.Tensor,
                                   a_blocks: torch.Tensor,
                                   l_index: torch.Tensor,
                                   u_index: torch.Tensor,
                                   a_index: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the gathered form: (T,) float32 partials.
    Each chunk of ``_CHUNK`` triples is gathered and converted to float32
    before the product, so bf16 tiles give the same bits as float32 ones."""
    t = int(l_index.shape[0])
    out = torch.empty(t, dtype=torch.float32, device=l_blocks.device)
    for s in range(0, t, _CHUNK):
        sl = slice(s, s + _CHUNK)
        l = l_blocks.index_select(0, l_index[sl]).float()
        u = u_blocks.index_select(0, u_index[sl]).float()
        a = a_blocks.index_select(0, a_index[sl]).float()
        out[sl] = (torch.bmm(l, u) * a).sum(dim=(1, 2))
    return out


def masked_spgemm_gathered(l_blocks: torch.Tensor, u_blocks: torch.Tensor,
                           a_blocks: torch.Tensor, l_index: torch.Tensor,
                           u_index: torch.Tensor, a_index: torch.Tensor, *,
                           order: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Per-triple ``sum(a_blocks[a_index[t]] ∘ (l_blocks[l_index[t]] @
    u_blocks[u_index[t]]))``: K4 on CUDA tensors, the plain version on CPU
    tensors, shape-only on ``meta`` tensors (the work recorded in the
    active ``launch.op_cost`` tally).

    Args:
      l_blocks, u_blocks, a_blocks: (n, B, B) 0/1 tile arrays, all float32
        or all bf16, contiguous; they may be one tensor (the matrix lane
        passes ``u_blocks`` as ``a_blocks``).
      l_index, u_index, a_index: (T,) int32 tile indices, any T ≥ 0. They
        are not range-checked here: the matrix lane's schedule checks them
        on the host where it makes them. On the card an index past its
        array reads a zero tile without an error.
      order: optional (T,) int32 permutation, the order in which the
        tensor-core kernel walks the triples (``launch_order``); each
        partial still lands at its own position t. The float32 kernel and
        the plain version ignore it.

    Returns:
      (T,) float32 partial counts; each an exact integer ≤ B³.

    Raises:
      ValueError: bad inputs (see ``check_gathered``); on a CUDA tensor,
        bf16 tiles whose B is not in ``WGMMA_BLOCKS``, float32 tiles past
        ``MAX_BLOCK``, or tiles not 16-byte aligned; a device that is
        neither CPU nor CUDA.
      RuntimeError: the kernel did not build or launch.
    """
    t, b = check_gathered(l_blocks, u_blocks, a_blocks, l_index, u_index,
                          a_index, order)
    dev = l_blocks.device
    if dev.type == "cpu":
        return masked_spgemm_gathered_chunked(l_blocks, u_blocks, a_blocks,
                                              l_index, u_index, a_index)
    if dev.type == "meta":
        from repro_torch.launch.op_cost import record_kernel

        out = torch.empty(t, dtype=torch.float32, device=dev)
        tiles = {id(x): x for x in (l_blocks, u_blocks, a_blocks)}
        read = sum(x.numel() * x.element_size() for x in tiles.values()) \
            + 4 * t * (3 + int(order is not None))
        record_kernel("masked_spgemm_wgmma" if l_blocks.dtype == torch.bfloat16
                      else "masked_spgemm", flops=2.0 * t * b ** 3,
                      dtype=l_blocks.dtype, bytes_read=read,
                      bytes_written=4 * t)
        return out
    if dev.type != "cuda":
        raise ValueError(f"the masked_spgemm kernels take CUDA tensors, got {dev}")
    wgmma = l_blocks.dtype == torch.bfloat16
    if wgmma and b not in WGMMA_BLOCKS:
        raise ValueError(f"bf16 tiles of edge B = {b}: the tensor-core "
                         f"kernel takes B in WGMMA_BLOCKS = {WGMMA_BLOCKS}")
    if not wgmma and b > MAX_BLOCK:
        raise ValueError(f"tile edge B = {b} exceeds the kernel's "
                         f"MAX_BLOCK = {MAX_BLOCK}")
    if wgmma and any(x.data_ptr() % 16 for x in (l_blocks, u_blocks,
                                                  a_blocks)):
        raise ValueError("bf16 tiles must start 16-byte aligned (TMA)")
    with span("tc.launch"):
        out = torch.empty(t, dtype=torch.float32, device=dev)
        if t == 0:
            return out
        lib = _build.load_library("masked_spgemm", _SIGNATURES)
        ptrs = [x.data_ptr() for x in (l_index, u_index, a_index)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if wgmma:
                name = "masked_spgemm_wgmma"
                err = lib.tc_masked_spgemm_wgmma(
                    l_blocks.data_ptr(), l_blocks.shape[0],
                    u_blocks.data_ptr(), u_blocks.shape[0],
                    a_blocks.data_ptr(), a_blocks.shape[0], *ptrs,
                    None if order is None else order.data_ptr(),
                    out.data_ptr(), t, b, stream)
            else:
                name = "masked_spgemm"
                err = lib.tc_masked_spgemm(
                    l_blocks.data_ptr(), u_blocks.data_ptr(),
                    a_blocks.data_ptr(), *ptrs, out.data_ptr(), t, b, stream)
    if err != 0:
        raise RuntimeError(f"tc_{name} launch failed with CUDA error {err} at "
                           f"(T, B) = ({t}, {b})")
    LAUNCHES[name] += 1
    return out


def masked_spgemm_kernel(l_tiles: torch.Tensor, u_tiles: torch.Tensor,
                         a_tiles: torch.Tensor) -> torch.Tensor:
    """Per-triple ``sum(A ∘ (L @ U))`` over (T, B, B) stacks: the gathered
    form with identity indices (K4's float32 route on CUDA tensors, the
    plain version on CPU tensors).

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
    t, _ = check_tiles(l_tiles, u_tiles, a_tiles)
    idx = torch.arange(t, dtype=torch.int32, device=l_tiles.device)
    return masked_spgemm_gathered(l_tiles, u_tiles, a_tiles, idx, idx, idx)
