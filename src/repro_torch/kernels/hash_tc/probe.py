"""Hash probe for the TRUST-style hash lane (K5 of the port) and its plain
torch version.

The port of ``repro.kernels.hash_tc.probe``. Per forward edge (u, v) the
lane counts ``|N⁺(v) ∩ N⁺(u)|`` by probing each candidate of the row
(``N⁺(v)``, the bucket's ``v_lists``) against the anchor's hash row
``table[u]``: a probe ``w`` reads bucket ``w & (B - 1)`` and compares
against its D chain slots.

* ``hash_probe_kernel`` launches the CUDA kernel ``hash_probe_kernel``
  (``csrc/hash_probe.cu``), which replaces the TPU kernel
  ``_hash_probe_kernel`` / ``hash_probe_counts_pallas``.
* ``hash_probe_counts_chunked`` is its plain torch version, the
  counterpart of ``hash_probe_counts_jnp`` / ``_probe_block``. Where the
  reference gathers each chunk's (C, B, D) table rows and then the (C, W, D)
  candidate slots, it gathers the (C, W, D) slots directly: the same
  result, and 64× fewer bytes at B = 512.

Probe-validity rule: only values in [0, n) probe; the candidate rows'
in-row sentinel (n + 1) and whole-row padding (-2) are masked out, and
empty table slots hold -1, which no valid probe can equal. A candidate
counts once if any of its D slots equals it. An anchor outside [0, n) is
clamped into it, as the reference's gather does.

The wrapper checks its inputs, allocates the (E,) int32 output with
``torch.empty``, launches on PyTorch's current stream, raises if the launch
reported a CUDA error, and adds one to ``LAUNCHES["hash_probe"]``. Launches
happen nowhere else, so the counter shows whether a run went through the
kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

__all__ = [
    "LAUNCHES",
    "check_probe_inputs",
    "hash_probe_counts_chunked",
    "hash_probe_kernel",
    "reset_launch_counts",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"tc_hash_probe_counts": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)}

#: Kernel launches since the last ``reset_launch_counts()``.
LAUNCHES: Dict[str, int] = {"hash_probe": 0}

_INT_MAX = 2 ** 31 - 1

# elements of one chunk's (C, W, D) slot gather in the plain version
_PROBE_CHUNK_ELEMS = 1 << 24


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_probe_inputs(w_lists: torch.Tensor, src: torch.Tensor,
                       table: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """Validate a (w_lists, src, table) triple and return (E, W, n, B, D).

    Raises:
      ValueError: ``w_lists`` is not (E, W) int32, ``src`` not (E,) int32,
        ``table`` not (n, B, D) int32; not all contiguous on one device; B
        not a power of two; or an extent past int32.
    """
    if not all(isinstance(x, torch.Tensor) for x in (w_lists, src, table)):
        raise ValueError("w_lists, src and table must be torch tensors")
    if w_lists.dim() != 2 or src.dim() != 1 or table.dim() != 3 \
            or src.shape[0] != w_lists.shape[0]:
        raise ValueError(f"need w_lists (E, W), src (E,) and table (n, B, D), "
                         f"got {tuple(w_lists.shape)}, {tuple(src.shape)} and "
                         f"{tuple(table.shape)}")
    if any(x.dtype != torch.int32 for x in (w_lists, src, table)):
        raise ValueError(f"w_lists, src and table must be int32, got "
                         f"{w_lists.dtype}, {src.dtype} and {table.dtype}")
    if src.device != w_lists.device or table.device != w_lists.device:
        raise ValueError(f"w_lists on {w_lists.device}, src on {src.device}, "
                         f"table on {table.device}: need one device")
    if not all(x.is_contiguous() for x in (w_lists, src, table)):
        raise ValueError("w_lists, src and table must be contiguous")
    e, w = int(w_lists.shape[0]), int(w_lists.shape[1])
    n, b, d = (int(x) for x in table.shape)
    if b < 1 or b & (b - 1):
        raise ValueError(f"the table's bucket count B = {b} must be a power "
                         f"of two")
    if max(e, w, n, b, d) > _INT_MAX:
        raise ValueError(f"(E, W) = ({e}, {w}), (n, B, D) = ({n}, {b}, {d}) "
                         f"exceed the kernel's int32 extents")
    return e, w, n, b, d


def hash_probe_counts_chunked(w_lists: torch.Tensor, src: torch.Tensor,
                              table: torch.Tensor) -> torch.Tensor:
    """Plain torch hash probe: (E,) int32 per-row count of candidates found
    in ``table[src]``, in chunks of rows that bound the (C, W, D) gather."""
    e, w = int(w_lists.shape[0]), int(w_lists.shape[1])
    n, num_buckets, depth = (int(x) for x in table.shape)
    out = torch.zeros(e, dtype=torch.int32, device=w_lists.device)
    if e == 0 or w == 0 or n == 0 or depth == 0:
        return out
    slots = table.reshape(n * num_buckets, depth)
    step = max(1, _PROBE_CHUNK_ELEMS // (w * depth))
    for s in range(0, e, step):
        cand = w_lists[s:s + step]
        anchor = src[s:s + step].long().clamp_(0, n - 1)
        valid = (cand >= 0) & (cand < n)
        bkt = torch.where(valid, cand & (num_buckets - 1), 0).long()
        got = slots[anchor[:, None] * num_buckets + bkt]  # (C, W, D)
        hit = (got == cand[:, :, None]).any(dim=-1) & valid
        out[s:s + step] = hit.sum(dim=1, dtype=torch.int32)
    return out


def hash_probe_kernel(w_lists: torch.Tensor, src: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """Per-row hash-probe counts: K5 on CUDA tensors, the plain version on
    CPU tensors.

    Args:
      w_lists: (E, W) int32 candidate rows, contiguous (in-row sentinel
        n + 1, whole padding rows -2); any E and W.
      src: (E,) int32 anchor vertex per row (padding rows carry 0).
      table: (n, B, D) int32 table from ``build_hash_table``, B a power of
        two, empty slots -1.

    Returns:
      (E,) int32 counts.

    Raises:
      ValueError: bad inputs (see ``check_probe_inputs``) or a device that
        is neither CPU nor CUDA.
      RuntimeError: the kernel did not build or launch.
    """
    e, w, n, b, d = check_probe_inputs(w_lists, src, table)
    dev = w_lists.device
    if dev.type == "cpu":
        return hash_probe_counts_chunked(w_lists, src, table)
    if dev.type != "cuda":
        raise ValueError(f"the hash_probe kernel takes CUDA tensors, got {dev}")
    out = torch.empty(e, dtype=torch.int32, device=dev)
    if e == 0 or n == 0:
        return out.zero_()
    lib = _build.load_library("hash_probe", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tc_hash_probe_counts(w_lists.data_ptr(), src.data_ptr(),
                                       table.data_ptr(), out.data_ptr(),
                                       e, w, n, b, d, stream)
    if err != 0:
        raise RuntimeError(f"tc_hash_probe_counts launch failed with CUDA "
                           f"error {err} at (E, W) = ({e}, {w}), (n, B, D) = "
                           f"({n}, {b}, {d})")
    LAUNCHES["hash_probe"] += 1
    return out
