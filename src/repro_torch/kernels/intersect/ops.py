"""Strategy dispatch and cost model for the batched set-intersection core.

The counting hot loop is one function — per-row |N(u) ∩ N(v)| over padded
(E, W) sorted neighbour lists — with three interchangeable strategies:

  strategy    work/row      picked by "auto" when
  ---------   -----------   ------------------------------------------------
  broadcast   O(W²)         narrow buckets (W < 64)
  probe       O(W·log W)    wide buckets (W ≥ 64)
  bitmap      O(W + B/32)   the bucket's id range fits B = packed_bits(W)

and two backends: ``"kernel"`` (the default: the Hopper kernels on a CUDA
tensor, their plain torch versions on a CPU tensor) and ``"ref"`` (the
O(E·W²) broadcast-compare oracle, strategy-independent).

The cost-model constants are the reference's (``repro.kernels.intersect
.ops``), so the port resolves every bucket to the reference's strategy.

Sentinel-padding rules (repo-wide): within a row, u pads with ``n`` and v
with ``n + 1``; whole padding rows use ``-1`` (u) and ``-2`` (v). Disjoint
sentinels mean padding contributes zero matches without masks, except in
the bitmap core, which masks ids outside [0, num_bits) explicitly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.intersect.bitmap import (
    BITMAP_MAX_BITS,
    intersect_counts_bitmap_kernel,
    intersect_matches_bitmap,
)
from repro_torch.kernels.intersect.intersect import intersect_counts_kernel
from repro_torch.kernels.intersect.probe import (
    intersect_counts_probe_csr_kernel,
    intersect_counts_probe_kernel,
    probe_csr_rows,
    probe_matches,
)
from repro_torch.kernels.intersect.ref import intersect_counts_ref

__all__ = [
    "BACKENDS",
    "BITMAP_MAX_BITS",
    "STRATEGIES",
    "available_strategies",
    "choose_mask_strategy",
    "choose_strategy",
    "intersect_counts",
    "intersect_counts_csr",
    "intersect_matches",
    "intersect_matches_both",
    "packed_bits",
    "resolve_mask_strategy",
    "resolve_strategy",
]

STRATEGIES = ("broadcast", "probe", "bitmap")
BACKENDS = ("kernel", "ref")

# O(W²) broadcast vs O(W log W) probe crossover, kept from the reference
_PROBE_MIN_WIDTH = 64

# compare elements the broadcast mask materializes per row chunk
_MASK_CHUNK_ELEMS = 1 << 24


def available_strategies() -> tuple:
    """The valid set-intersection strategy names, sorted. Every
    ``strategy=`` argument accepts these plus ``"auto"``."""
    return tuple(sorted(STRATEGIES))


def _ceil32(x: int) -> int:
    return max(32, ((int(x) + 31) // 32) * 32)


def packed_bits(width: int) -> int:
    """Bitmap capacity paired with a width-W bucket: W bits (min one word)."""
    return _ceil32(width)


def _unknown(strategy) -> ValueError:
    return ValueError(
        f"unknown strategy {strategy!r}; expected 'auto' or one of {STRATEGIES}"
    )


def _bitmap_cap_error(bits: int, id_range) -> ValueError:
    return ValueError(
        f"strategy='bitmap' would need a {bits}-bit bitmap for id "
        f"range {int(id_range)} (cap: BITMAP_MAX_BITS={BITMAP_MAX_BITS}); "
        f"use strategy='probe' (or 'auto') for this bucket"
    )


def choose_strategy(width: int, id_range=None) -> str:
    """The ``strategy="auto"`` cost model.

    Args:
      width: the bucket's padded list width W.
      id_range: number of distinct ids the lists may contain (the engine
        passes ``n + 2``); None disqualifies bitmap.

    Returns:
      "bitmap" when ``id_range`` fits ``packed_bits(width)`` (itself under
      ``BITMAP_MAX_BITS``), else "probe" for W ≥ 64, else "broadcast".
    """
    pw = packed_bits(width)
    if id_range is not None and int(id_range) <= pw and pw <= BITMAP_MAX_BITS:
        return "bitmap"
    if width >= _PROBE_MIN_WIDTH:
        return "probe"
    return "broadcast"


def resolve_strategy(width: int, id_range=None, strategy: str = "auto"):
    """Resolve ("auto" or explicit) strategy to (strategy, bitmap_bits).

    ``bitmap_bits`` is None except for bitmap, where it is
    ``packed_bits(width)`` when the id range fits and the id range rounded
    up to a word multiple when bitmap is forced beyond it.

    Raises:
      ValueError: bitmap forced with no ``id_range``, past
        ``BITMAP_MAX_BITS``, or an unknown strategy name.
    """
    if strategy == "auto":
        strategy = choose_strategy(width, id_range)
    if strategy not in STRATEGIES:
        raise _unknown(strategy)
    bits = None
    if strategy == "bitmap":
        if id_range is None:
            raise ValueError("strategy='bitmap' needs id_range to size the bitmap")
        pw = packed_bits(width)
        bits = pw if int(id_range) <= pw else _ceil32(id_range)
        if bits > BITMAP_MAX_BITS:
            raise _bitmap_cap_error(bits, id_range)
    return strategy, bits


def choose_mask_strategy(width: int, id_range=None) -> str:
    """The ``strategy="auto"`` cost model for mask consumers
    (``intersect_matches``): bitmap out to 4·W packed bits, since a probe
    mask pays a search per element; else the width rule."""
    if id_range is not None:
        bits = _ceil32(id_range)
        if bits <= BITMAP_MAX_BITS and bits <= 4 * packed_bits(width):
            return "bitmap"
    if width >= _PROBE_MIN_WIDTH:
        return "probe"
    return "broadcast"


def resolve_mask_strategy(width: int, id_range=None, strategy: str = "auto"):
    """Resolve an ("auto" or explicit) mask strategy to (strategy,
    bitmap_bits); an explicit bitmap sizes its capacity from the id range.

    Raises:
      ValueError: bitmap forced with no ``id_range``, past
        ``BITMAP_MAX_BITS``, or an unknown strategy name.
    """
    if strategy == "auto":
        strategy = choose_mask_strategy(width, id_range)
    if strategy not in STRATEGIES:
        raise _unknown(strategy)
    bits = None
    if strategy == "bitmap":
        if id_range is None:
            raise ValueError("strategy='bitmap' needs id_range to size the bitmap")
        bits = _ceil32(id_range)
        if bits > BITMAP_MAX_BITS:
            raise _bitmap_cap_error(bits, id_range)
    return strategy, bits


def _auto_id_range(u_lists: torch.Tensor, v_lists: torch.Tensor) -> int:
    """Id range of concrete inputs: rows are sorted, so each row's max is
    its last column."""
    if u_lists.shape[0] == 0 or u_lists.shape[1] == 0:
        return 0
    return max(int(u_lists[:, -1].max()), int(v_lists[:, -1].max()), -1) + 1


def _resolve_args(u_lists, v_lists, strategy, bitmap_bits, resolver):
    """"auto" resolves from the data's id range; a forced bitmap without
    ``bitmap_bits`` sizes it from the same range."""
    if strategy == "auto":
        strategy, bits = resolver(u_lists.shape[1], _auto_id_range(u_lists, v_lists))
        if strategy == "bitmap":
            bitmap_bits = bits
    elif strategy == "bitmap" and bitmap_bits is None:
        _, bitmap_bits = resolver(u_lists.shape[1],
                                  _auto_id_range(u_lists, v_lists),
                                  strategy="bitmap")
    elif strategy not in STRATEGIES:
        raise _unknown(strategy)
    return strategy, bitmap_bits


def intersect_counts(
    u_lists: torch.Tensor,
    v_lists: torch.Tensor,
    *,
    strategy: str = "auto",
    backend: str = "kernel",
    bitmap_bits=None,
) -> torch.Tensor:
    """Per-row intersection counts. Shapes (E, W) ×2 → (E,) int32.

    Args:
      u_lists: (E, W) int32; each row a sorted neighbour list, padded with
        a sentinel disjoint from v's (sorted ascending, sentinels included:
        the probe kernel merges the two rows).
      v_lists: (E, W) int32, same layout, disjoint padding sentinel.
      strategy: "broadcast" | "probe" | "bitmap" | "auto" (``choose_strategy``
        on the data's id range).
      backend: "kernel" (the strategy's CUDA kernel on a CUDA tensor, its
        plain torch version on a CPU tensor) or "ref" (the oracle).
      bitmap_bits: bitmap capacity for strategy="bitmap" (multiple of 32);
        None sizes it from the data's id range. Ids ≥ bitmap_bits never
        match.

    Returns:
      (E,) int32 per-row |N(u) ∩ N(v)|.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "ref":
        return intersect_counts_ref(u_lists, v_lists)
    strategy, bitmap_bits = _resolve_args(u_lists, v_lists, strategy,
                                          bitmap_bits, resolve_strategy)
    if strategy == "broadcast":
        return intersect_counts_kernel(u_lists, v_lists)
    if strategy == "probe":
        return intersect_counts_probe_kernel(u_lists, v_lists)
    return intersect_counts_bitmap_kernel(u_lists, v_lists,
                                          num_bits=int(bitmap_bits))


def intersect_counts_csr(row_ptr: torch.Tensor, col: torch.Tensor,
                         src: torch.Tensor, dst: torch.Tensor, *, width: int,
                         backend: str = "kernel") -> torch.Tensor:
    """Per-edge |N⁺(src) ∩ N⁺(dst)| with both rows read from a forward CSR
    at their real lengths (each cut to its first ``width`` ids): the probe
    strategy's form for rows that live in the CSR.

    Args:
      row_ptr, col: the forward CSR, int32; rows sorted ascending, each
        id once.
      src, dst: (E,) int32 endpoints of real rows.
      width: the bucket width.
      backend: "kernel" (K2's CSR form on a CUDA tensor, its plain version
        on a CPU tensor) or "ref" (the oracle on the gathered rows).

    Returns:
      (E,) int32 counts.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "ref":
        return intersect_counts_ref(*probe_csr_rows(row_ptr, col, src, dst,
                                                    width))
    return intersect_counts_probe_csr_kernel(row_ptr, col, src, dst, width)


def _broadcast_mask(u_lists: torch.Tensor, v_lists: torch.Tensor) -> torch.Tensor:
    e, w = u_lists.shape
    out = torch.zeros(e, w, dtype=torch.bool, device=u_lists.device)
    step = max(1, _MASK_CHUNK_ELEMS // max(w * w, 1))
    for s in range(0, e, step):
        out[s:s + step] = (u_lists[s:s + step, :, None]
                           == v_lists[s:s + step, None, :]).any(dim=2)
    return out


def _broadcast_mask_both(u_lists: torch.Tensor, v_lists: torch.Tensor):
    """Both broadcast masks from one compare tensor a row chunk."""
    e, w = u_lists.shape
    out_u = torch.zeros(e, w, dtype=torch.bool, device=u_lists.device)
    out_v = torch.zeros_like(out_u)
    step = max(1, _MASK_CHUNK_ELEMS // max(w * w, 1))
    for s in range(0, e, step):
        eq = u_lists[s:s + step, :, None] == v_lists[s:s + step, None, :]
        out_u[s:s + step] = eq.any(dim=2)
        out_v[s:s + step] = eq.any(dim=1)
    return out_u, out_v


def _probe_mask(u_lists: torch.Tensor, v_lists: torch.Tensor) -> torch.Tensor:
    e, w = u_lists.shape
    out = torch.zeros(e, w, dtype=torch.bool, device=u_lists.device)
    step = max(1, _MASK_CHUNK_ELEMS // max(w, 1))
    for s in range(0, e if w else 0, step):
        out[s:s + step] = probe_matches(u_lists[s:s + step], v_lists[s:s + step])
    return out


def intersect_matches(
    u_lists: torch.Tensor,
    v_lists: torch.Tensor,
    *,
    strategy: str = "auto",
    bitmap_bits=None,
) -> torch.Tensor:
    """Per-position membership mask: which u-list entries appear in v.

    The mask form of ``intersect_counts`` (row sums give the counts), as
    plain torch ops: the per-vertex stage needs to know WHICH common
    neighbour matched, to credit its triangle to three vertices. The
    reference computes it with jnp alone, so it has no kernel here either.

    Args:
      u_lists, v_lists: (E, W) int32 sorted rows, disjoint sentinels.
      strategy: "auto" (``choose_mask_strategy`` on the data's id range) or
        "broadcast" | "probe" | "bitmap".
      bitmap_bits: bitmap capacity for strategy="bitmap".

    Returns:
      (E, W) bool; padding positions are never True.
    """
    strategy, bitmap_bits = _resolve_args(u_lists, v_lists, strategy,
                                          bitmap_bits, resolve_mask_strategy)
    if strategy == "broadcast":
        return _broadcast_mask(u_lists, v_lists)
    if strategy == "bitmap":
        return intersect_matches_bitmap(u_lists, v_lists,
                                        num_bits=int(bitmap_bits))
    return _probe_mask(u_lists, v_lists)


def intersect_matches_both(
    u_lists: torch.Tensor,
    v_lists: torch.Tensor,
    *,
    strategy: str = "auto",
    bitmap_bits=None,
) -> tuple:
    """Both directions of ``intersect_matches`` in one call.

    Returns ``(matched_u, matched_v)``: (E, W) bool masks of the u-row
    positions found in v and the v-row positions found in u. Rows are
    deduplicated neighbour lists, so each common element is one True in
    each mask and both masks row-sum to the per-row intersection sizes.
    The broadcast strategy reduces one compare tensor both ways a row
    chunk; probe and bitmap run twice with the roles swapped. The edge
    lane credits its side edges from the two masks.
    """
    strategy, bitmap_bits = _resolve_args(u_lists, v_lists, strategy,
                                          bitmap_bits, resolve_mask_strategy)
    if strategy == "broadcast":
        return _broadcast_mask_both(u_lists, v_lists)
    if strategy == "bitmap":
        bits = int(bitmap_bits)
        return (intersect_matches_bitmap(u_lists, v_lists, num_bits=bits),
                intersect_matches_bitmap(v_lists, u_lists, num_bits=bits))
    return _probe_mask(u_lists, v_lists), _probe_mask(v_lists, u_lists)
