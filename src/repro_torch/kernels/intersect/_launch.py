"""ctypes binding of ``csrc/intersect.cu`` and the launch counters.

Each kernel wrapper (``intersect.py``, ``probe.py``, ``bitmap.py``) checks
its inputs here, allocates the ``(E,)`` int32 output with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch reported a CUDA
error, and adds one to its entry of ``LAUNCHES``. Launches happen nowhere
else, so the counters show which kernels a run went through.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.spans import span

__all__ = ["LAUNCHES", "check_csr_rows", "check_lists", "launch_counts",
           "launch_csr_counts", "reset_launch_counts"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tc_broadcast_counts": (_P, _P, _P, _I, _I, _P),
    "tc_probe_counts": (_P, _P, _P, _I, _I, _P),
    "tc_bitmap_counts": (_P, _P, _P, _I, _I, _I, _P),
    "tc_probe_csr_counts": (_P, _P, _P, _P, _P, _I, _I, _P),
}
# "probe_csr" is K2 reading its rows from the forward CSR
_FUNCTIONS = {"broadcast": "tc_broadcast_counts", "probe": "tc_probe_counts",
              "bitmap": "tc_bitmap_counts", "probe_csr": "tc_probe_csr_counts"}

#: Kernel launches per strategy since the last ``reset_launch_counts()``.
LAUNCHES: Dict[str, int] = {k: 0 for k in _FUNCTIONS}

_INT_MAX = 2 ** 31 - 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_lists(u: torch.Tensor, v: torch.Tensor) -> Tuple[int, int]:
    """Validate a (u, v) pair for the kernels and return (E, W).

    Raises:
      ValueError: not 2-D int32 tensors of one shape on one device, not
        contiguous, or an extent past int32.
    """
    if not (isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor)):
        raise ValueError("u_lists and v_lists must be torch tensors")
    if u.dim() != 2 or u.shape != v.shape:
        raise ValueError(f"u_lists and v_lists must be (E, W) of one shape, "
                         f"got {tuple(u.shape)} and {tuple(v.shape)}")
    if u.dtype != torch.int32 or v.dtype != torch.int32:
        raise ValueError(f"u_lists and v_lists must be int32, "
                         f"got {u.dtype} and {v.dtype}")
    if u.device != v.device:
        raise ValueError(f"u_lists on {u.device} but v_lists on {v.device}")
    if not (u.is_contiguous() and v.is_contiguous()):
        raise ValueError("u_lists and v_lists must be contiguous")
    e, w = int(u.shape[0]), int(u.shape[1])
    if e > _INT_MAX or w > _INT_MAX:
        raise ValueError(f"(E, W) = ({e}, {w}) exceeds the kernels' int32 extents")
    return e, w


def _run(kernel: str, inputs, e: int, w: int, *extra: int) -> torch.Tensor:
    """Launch ``kernel`` (a key of ``_FUNCTIONS``) on the CUDA tensors
    ``inputs``, passed as pointers before the output, then E, W, ``extra``
    and the stream; (E,) int32 counts. An empty input launches nothing."""
    device = inputs[0].device
    if device.type != "cuda":
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, "
                         f"got {device}")
    out = torch.empty(e, dtype=torch.int32, device=device)
    if e == 0 or w == 0:
        return out.zero_()
    lib = _build.load_library("intersect", _SIGNATURES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FUNCTIONS[kernel])(
            *(t.data_ptr() for t in inputs), out.data_ptr(), e, w, *extra,
            stream)
    if err != 0:
        raise RuntimeError(f"{_FUNCTIONS[kernel]} launch failed with CUDA "
                           f"error {err} at (E, W) = ({e}, {w})")
    LAUNCHES[kernel] += 1
    return out


def launch_counts(strategy: str, u: torch.Tensor, v: torch.Tensor,
                  *extra: int) -> torch.Tensor:
    """Launch the ``strategy`` kernel on CUDA tensors; (E,) int32 counts.

    ``extra`` holds the kernel's int arguments after W (``num_bits`` for
    the bitmap kernel). An empty input launches nothing and counts nothing.

    Raises:
      ValueError: see ``check_lists``, or tensors not on a CUDA device.
      RuntimeError: the build failed or the launch reported a CUDA error.
    """
    with span("tc.launch"):
        e, w = check_lists(u, v)
        return _run(strategy, (u, v), e, w, *extra)


def check_csr_rows(row_ptr: torch.Tensor, col: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor, width: int) -> int:
    """Validate the CSR route's inputs and return E.

    Raises:
      ValueError: not 1-D contiguous int32 tensors on one device, ``src``
        and ``dst`` of different lengths, an empty ``row_ptr``, a width
        below 1, or an extent past int32.
    """
    named = dict(row_ptr=row_ptr, col=col, src=src, dst=dst)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D torch tensor")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != row_ptr.device:
            raise ValueError(f"row_ptr on {row_ptr.device} but {name} on "
                             f"{t.device}")
        if t.numel() > _INT_MAX:
            raise ValueError(f"{name} has {t.numel()} elements, past the "
                             f"kernels' int32 extents")
    if src.shape != dst.shape:
        raise ValueError(f"src and dst must have one length, got "
                         f"{tuple(src.shape)} and {tuple(dst.shape)}")
    if row_ptr.numel() == 0:
        raise ValueError("row_ptr needs n + 1 >= 1 offsets")
    if not 1 <= int(width) <= _INT_MAX:
        raise ValueError(f"width must be in [1, 2**31), got {width}")
    return int(src.shape[0])


def launch_csr_counts(row_ptr: torch.Tensor, col: torch.Tensor,
                      src: torch.Tensor, dst: torch.Tensor,
                      width: int) -> torch.Tensor:
    """Launch K2 on the forward CSR (CUDA tensors); (E,) int32 counts. An
    empty edge list launches nothing.

    Raises:
      ValueError: see ``check_csr_rows``, or tensors not on a CUDA device.
      RuntimeError: the build failed or the launch reported a CUDA error.
    """
    with span("tc.launch"):
        e = check_csr_rows(row_ptr, col, src, dst, width)
        return _run("probe_csr", (row_ptr, col, src, dst), e, int(width))
