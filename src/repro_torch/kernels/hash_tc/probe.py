"""Hash probe for the TRUST-style hash lane (K5 of the port) and its plain
torch versions.

The port of ``repro.kernels.hash_tc.probe``. Per forward edge (u, v) the
lane counts ``|N⁺(v) ∩ N⁺(u)|`` by probing each candidate of the row
(``N⁺(v)``, the bucket's ``v_lists``) against the anchor's hash row: a
probe ``w`` reads bucket ``w & (B - 1)`` and compares against its chain.

The lane holds the table compactly (``build.CompactHashTable``: each chain
at its real length behind (n·B + 1,) int32 offsets) and each bucket's row
ends (``probe_row_ends``):

* ``hash_probe_compact_kernel`` launches the CUDA kernel
  ``hash_probe_compact_kernel`` (``csrc/hash_probe.cu``), which replaces
  the TPU kernel ``_hash_probe_kernel`` / ``hash_probe_counts_pallas``.
  It reads each row's candidates only up to its row end and each chain
  only up to its first match.
* ``hash_probe_compact_chunked`` is its plain torch version.
* ``hash_probe_kernel`` keeps the reference's dense contract, (E, W)
  candidates against an (n, B, D) table: on CUDA tensors it compacts the
  table, finds the row ends and launches the same kernel; on CPU tensors
  it runs the dense plain version ``hash_probe_counts_chunked``, the
  counterpart of ``hash_probe_counts_jnp`` / ``_probe_block``. Where the
  reference gathers each chunk's (C, B, D) table rows and then the
  (C, W, D) candidate slots, it gathers the (C, W, D) slots directly: the
  same result, and 64× fewer bytes at B = 512.

Probe-validity rule: only values in [0, n) probe; the candidate rows'
in-row sentinel (n + 1) and whole-row padding (-2) are masked out, and
empty dense slots hold -1, which no valid probe can equal. A candidate
counts once if any slot of its chain equals it. An anchor outside [0, n)
is clamped into it, as the reference's gather does.

The kernel wrapper checks its inputs, allocates the (E,) int32 output
with ``torch.empty``, launches on PyTorch's current stream, raises if the
launch reported a CUDA error, and adds one to ``LAUNCHES["hash_probe"]``.
Launches happen nowhere else, so the counter shows whether a run went
through the kernel; the dense entry point counts through it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hash_tc.build import CompactHashTable, compact_hash_table
from repro_torch.spans import span

__all__ = [
    "LAUNCHES",
    "check_compact_inputs",
    "check_probe_inputs",
    "hash_probe_compact_chunked",
    "hash_probe_compact_kernel",
    "hash_probe_counts_chunked",
    "hash_probe_kernel",
    "probe_row_ends",
    "reset_launch_counts",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tc_hash_probe_compact": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}

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


def probe_row_ends(w_lists: torch.Tensor, n: int) -> torch.Tensor:
    """(E,) int32 row ends: 1 + the last index j with 0 ≤ w_lists[e, j] < n,
    and 0 for a row with none. Exact for any row, sorted or not, with
    sentinels anywhere; a probe kernel that reads each row only up to its
    end reads every candidate that can count. Torch ops, in chunks of rows.
    """
    if w_lists.dim() != 2:
        raise ValueError(f"need (E, W) candidate rows, got "
                         f"{tuple(w_lists.shape)}")
    e, w = int(w_lists.shape[0]), int(w_lists.shape[1])
    out = torch.zeros(e, dtype=torch.int32, device=w_lists.device)
    if e == 0 or w == 0:
        return out
    pos = torch.arange(1, w + 1, dtype=torch.int32, device=w_lists.device)
    step = max(1, _PROBE_CHUNK_ELEMS // w)
    for s in range(0, e, step):
        cand = w_lists[s:s + step]
        valid = (cand >= 0) & (cand < n)
        out[s:s + step] = torch.where(valid, pos, 0).amax(dim=1)
    return out


def check_compact_inputs(w_lists: torch.Tensor, src: torch.Tensor,
                         row_end: torch.Tensor, compact: CompactHashTable
                         ) -> Tuple[int, int, int, int]:
    """Validate a (w_lists, src, row_end, compact) call and return
    (E, W, n, B).

    Raises:
      ValueError: ``w_lists`` is not (E, W) int32, ``src`` or ``row_end``
        not (E,) int32, ``chain_ptr`` not (n·B + 1,) int32 or
        ``chain_vals`` not 1-d int32; not all contiguous on one device; B
        not a power of two; or an extent past int32.
    """
    ptr, vals, b = compact
    b = int(b)
    tensors = (w_lists, src, row_end, ptr, vals)
    if not all(isinstance(x, torch.Tensor) for x in tensors):
        raise ValueError("w_lists, src, row_end, chain_ptr and chain_vals "
                         "must be torch tensors")
    if w_lists.dim() != 2 or src.dim() != 1 or row_end.dim() != 1 \
            or src.shape[0] != w_lists.shape[0] \
            or row_end.shape[0] != w_lists.shape[0]:
        raise ValueError(f"need w_lists (E, W), src (E,) and row_end (E,), "
                         f"got {tuple(w_lists.shape)}, {tuple(src.shape)} "
                         f"and {tuple(row_end.shape)}")
    if any(x.dtype != torch.int32 for x in tensors):
        raise ValueError(f"w_lists, src, row_end, chain_ptr and chain_vals "
                         f"must be int32, got "
                         f"{[str(x.dtype) for x in tensors]}")
    if any(x.device != w_lists.device for x in tensors):
        raise ValueError(f"inputs on {[str(x.device) for x in tensors]}: "
                         f"need one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("w_lists, src, row_end, chain_ptr and chain_vals "
                         "must be contiguous")
    if b < 1 or b & (b - 1):
        raise ValueError(f"the table's bucket count B = {b} must be a power "
                         f"of two")
    if ptr.dim() != 1 or vals.dim() != 1 or (ptr.numel() - 1) % b \
            or ptr.numel() < 1:
        raise ValueError(f"need chain_ptr (n·B + 1,) and chain_vals (nnz,) "
                         f"at B = {b}, got {tuple(ptr.shape)} and "
                         f"{tuple(vals.shape)}")
    e, w = int(w_lists.shape[0]), int(w_lists.shape[1])
    n = (int(ptr.numel()) - 1) // b
    if max(e, w, n, b, int(vals.numel())) > _INT_MAX:
        raise ValueError(f"(E, W) = ({e}, {w}), (n, B) = ({n}, {b}), nnz = "
                         f"{vals.numel()} exceed the kernel's int32 extents")
    return e, w, n, b


def hash_probe_compact_chunked(w_lists: torch.Tensor, src: torch.Tensor,
                               row_end: torch.Tensor,
                               compact: CompactHashTable) -> torch.Tensor:
    """Plain torch compact hash probe: (E,) int32 per-row count of the
    candidates before the row end found in their chain of the anchor's
    row, in chunks of rows; chain position k is compared in step k."""
    ptr, vals, num_buckets = compact
    e, w = int(w_lists.shape[0]), int(w_lists.shape[1])
    n = compact.n
    out = torch.zeros(e, dtype=torch.int32, device=w_lists.device)
    if e == 0 or w == 0 or n == 0 or vals.numel() == 0:
        return out
    pos = torch.arange(w, dtype=torch.int32, device=w_lists.device)
    step = max(1, _PROBE_CHUNK_ELEMS // w)
    for s in range(0, e, step):
        cand = w_lists[s:s + step]
        anchor = src[s:s + step].long().clamp_(0, n - 1)
        valid = (cand >= 0) & (cand < n) & (pos < row_end[s:s + step, None])
        chain = anchor[:, None] * num_buckets \
            + torch.where(valid, cand & (num_buckets - 1), 0).long()
        lo = ptr[chain].long()
        length = torch.where(valid, ptr[chain + 1].long() - lo, 0)
        hit = torch.zeros_like(valid)
        for k in range(int(length.max())):  # one sync a chunk
            at = torch.where(k < length, lo + k, 0)
            hit |= (k < length) & (vals[at] == cand)
        out[s:s + step] = hit.sum(dim=1, dtype=torch.int32)
    return out


def hash_probe_compact_kernel(w_lists: torch.Tensor, src: torch.Tensor,
                              row_end: torch.Tensor,
                              compact: CompactHashTable) -> torch.Tensor:
    """Per-row compact hash-probe counts: K5 on CUDA tensors, the plain
    version on CPU tensors.

    Args:
      w_lists: (E, W) int32 candidate rows, contiguous (in-row sentinel
        n + 1, whole padding rows -2); any E and W; any alignment.
      src: (E,) int32 anchor vertex per row (padding rows carry 0).
      row_end: (E,) int32; only candidates before it are read
        (``probe_row_ends`` gives ends that drop nothing).
      compact: the ``CompactHashTable`` of the anchors' rows.

    Returns:
      (E,) int32 counts.

    Raises:
      ValueError: bad inputs (see ``check_compact_inputs``) or a device
        that is neither CPU nor CUDA.
      RuntimeError: the kernel did not build or launch.
    """
    e, w, n, b = check_compact_inputs(w_lists, src, row_end, compact)
    dev = w_lists.device
    if dev.type == "cpu":
        return hash_probe_compact_chunked(w_lists, src, row_end, compact)
    if dev.type != "cuda":
        raise ValueError(f"the hash_probe kernel takes CUDA tensors, got {dev}")
    with span("tc.launch"):
        out = torch.empty(e, dtype=torch.int32, device=dev)
        if e == 0 or n == 0:
            return out.zero_()
        lib = _build.load_library("hash_probe", _SIGNATURES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.tc_hash_probe_compact(
                w_lists.data_ptr(), src.data_ptr(), row_end.data_ptr(),
                compact.chain_ptr.data_ptr(), compact.chain_vals.data_ptr(),
                out.data_ptr(), e, w, n, b, stream)
    if err != 0:
        raise RuntimeError(f"tc_hash_probe_compact launch failed with CUDA "
                           f"error {err} at (E, W) = ({e}, {w}), (n, B) = "
                           f"({n}, {b})")
    LAUNCHES["hash_probe"] += 1
    return out


def hash_probe_kernel(w_lists: torch.Tensor, src: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """Per-row hash-probe counts against a dense table: on CUDA tensors the
    table is compacted (``compact_hash_table``), the row ends found
    (``probe_row_ends``) and K5 launched once; on CPU tensors the dense
    plain version runs.

    Args:
      w_lists: (E, W) int32 candidate rows, contiguous (in-row sentinel
        n + 1, whole padding rows -2); any E and W.
      src: (E,) int32 anchor vertex per row (padding rows carry 0).
      table: (n, B, D) int32 table, B a power of two, empty slots -1; any
        slot values (holes, repeats, out-of-range values).

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
    if e == 0 or n == 0:
        return torch.zeros(e, dtype=torch.int32, device=dev)
    return hash_probe_compact_kernel(w_lists, src, probe_row_ends(w_lists, n),
                                     compact_hash_table(table))
