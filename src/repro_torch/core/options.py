"""Typed options for the triangle-counting front door.

``CountOptions`` is the port of ``repro.core.options.CountOptions`` with the
fields the intersection, subgraph, matrix, hash, bfs, edge and dynamic lanes
read: one frozen,
validated, hashable dataclass. Equal options give equal ``key()``s, and the
engine's launch-configuration cache keys derive from the fields.

Backends: ``"kernel"`` (default) runs each stage's Hopper kernel on a CUDA
device and its plain torch version on a CPU device; ``"ref"`` runs the
lane's oracle (the broadcast compare, the one-shot einsum of the matrix
lane, or the hash lane's structure-blind compare). Pallas' interpret mode
has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.graphs.device import (
    DEFAULT_SHAPE_POLICY,
    EDGE_KEY_MODES,
    ShapePolicy,
)
from repro_torch.kernels.intersect.ops import (
    BACKENDS,
    BITMAP_MAX_BITS,
    STRATEGIES,
)

__all__ = ["BACKENDS", "CHOOSERS", "CountOptions", "DEFAULT_WIDTHS",
           "PREP_BACKENDS", "VARIANTS"]

DEFAULT_WIDTHS: Tuple[int, ...] = (8, 32, 128, 512)

CHOOSERS = ("heuristic", "measured")

VARIANTS = ("filtered", "full")
PREP_BACKENDS = ("device", "host")


@dataclasses.dataclass(frozen=True)
class CountOptions:
    """Every knob of a triangle count, validated at construction.

    Attributes:
      algorithm: "auto" (``repro_torch.core.registry.choose_algorithm``) or
        a registered lane name ("intersection" | "matrix" | "subgraph" |
        "hash" | "bfs" | "edge" | "dynamic").
      chooser: how ``algorithm="auto"`` resolves: "heuristic" (default:
        the shape rules of ``registry._default_chooser``, or whatever
        ``registry.set_auto_chooser`` installed) or "measured" (the
        per-device calibration table of ``repro_torch.core.calibrate``,
        falling back to the heuristic without a table). Ignored when
        ``algorithm`` names a lane.
      variant: "filtered" (forward algorithm, each triangle once) or "full"
        (every directed edge, found 6×).
      backend: "kernel" | "ref" per-bucket execution path.
      strategy: per-bucket set-intersection core: "auto" (the documented
        cost model) or forced "broadcast" | "probe" | "bitmap".
      widths: ascending degree-class bucket widths.
      block: matrix lane tile edge B, or "auto" (``prep.choose_block``).
      permute: matrix lane degree-order permutation toggle.
      bitmap_bits: optional forced bitmap capacity (multiple of 32) for
        bitmap buckets; None sizes it from the id range.
      prep_backend: "device" (default: torch prep on the session's device)
        or "host" (the numpy parity path, uploaded afterwards); the bfs
        lane always preps on the device.
      shape_policy: the ``ShapePolicy`` rounding prep extents; None means
        ``DEFAULT_SHAPE_POLICY``.
      max_device_bytes: per-bucket device-bytes budget for streamed
        (tiled) execution on the intersection, subgraph and matrix lanes:
        a bucket (or the matrix lane's triples) over it stays in host
        memory and streams through the kernels chunk by chunk; None keeps
        everything resident.
      max_peel_iters: edge lane — the k-truss peel's round bound.
      peel_early_exit: edge lane — stop the peel at its fixed point (True)
        or run exactly ``max_peel_iters`` rounds (same result).
      update_batch_size: dynamic lane — updates per device step.
      recount_interval: dynamic lane — full recount every this many
        batches (0 disables it).
      key_mode: edge and dynamic lanes — packed-key mode, "auto" (int32
        while ``(n + 1)²`` fits, else int64) | "int32" | "wide".
    """

    algorithm: str = "auto"
    chooser: str = "heuristic"
    variant: str = "filtered"
    backend: str = "kernel"
    strategy: str = "auto"
    widths: Tuple[int, ...] = DEFAULT_WIDTHS
    block: Union[int, str] = "auto"
    permute: bool = True
    bitmap_bits: Optional[int] = None
    prep_backend: str = "device"
    shape_policy: Optional[ShapePolicy] = None
    max_peel_iters: int = 1000
    peel_early_exit: bool = True
    update_batch_size: int = 256
    recount_interval: int = 64
    key_mode: str = "auto"
    max_device_bytes: Optional[int] = None

    def __post_init__(self):
        try:
            widths = tuple(int(w) for w in self.widths)
        except TypeError:
            raise ValueError(f"widths must be an iterable of ints, "
                             f"got {self.widths!r}") from None
        object.__setattr__(self, "widths", widths)

        if self.algorithm != "auto":
            from repro_torch.core.registry import available_algorithms
            names = available_algorithms()
            if self.algorithm not in names:
                raise ValueError(
                    f"unknown algorithm {self.algorithm!r}; expected 'auto' "
                    f"or one of {names}"
                )
        if self.chooser not in CHOOSERS:
            raise ValueError(
                f"unknown chooser {self.chooser!r}; expected one of {CHOOSERS}"
            )
        if self.variant not in VARIANTS:
            raise ValueError(
                f"unknown variant {self.variant!r}; expected one of {VARIANTS}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}"
            )
        if self.strategy != "auto" and self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; expected 'auto' or one "
                f"of {STRATEGIES}"
            )
        if not widths or any(w <= 0 for w in widths) or \
                any(a >= b for a, b in zip(widths, widths[1:])):
            raise ValueError(
                f"widths must be non-empty, positive, strictly ascending; "
                f"got {widths}"
            )
        if self.block != "auto":
            if not isinstance(self.block, int) or isinstance(self.block, bool) \
                    or self.block <= 0:
                raise ValueError(
                    f"block must be a positive int or 'auto', got {self.block!r}"
                )
        if not isinstance(self.permute, bool):
            raise ValueError(f"permute must be a bool, got {self.permute!r}")
        if self.bitmap_bits is not None:
            b = self.bitmap_bits
            if not isinstance(b, int) or isinstance(b, bool) or b <= 0 \
                    or b % 32 or b > BITMAP_MAX_BITS:
                raise ValueError(
                    f"bitmap_bits must be a positive multiple of 32 ≤ "
                    f"{BITMAP_MAX_BITS}, got {b!r}"
                )
        if self.prep_backend not in PREP_BACKENDS:
            raise ValueError(
                f"unknown prep_backend {self.prep_backend!r}; expected one "
                f"of {PREP_BACKENDS}"
            )
        if self.shape_policy is not None and \
                not isinstance(self.shape_policy, ShapePolicy):
            raise ValueError(
                f"shape_policy must be None or a ShapePolicy, "
                f"got {self.shape_policy!r}"
            )
        if not isinstance(self.max_peel_iters, int) \
                or isinstance(self.max_peel_iters, bool) \
                or self.max_peel_iters < 1:
            raise ValueError(
                f"max_peel_iters must be a positive int, "
                f"got {self.max_peel_iters!r}"
            )
        if not isinstance(self.peel_early_exit, bool):
            raise ValueError(
                f"peel_early_exit must be a bool, got {self.peel_early_exit!r}"
            )
        if not isinstance(self.update_batch_size, int) \
                or isinstance(self.update_batch_size, bool) \
                or self.update_batch_size < 1:
            raise ValueError(
                f"update_batch_size must be a positive int, "
                f"got {self.update_batch_size!r}"
            )
        if not isinstance(self.recount_interval, int) \
                or isinstance(self.recount_interval, bool) \
                or self.recount_interval < 0:
            raise ValueError(
                f"recount_interval must be a non-negative int (0 disables "
                f"the periodic oracle), got {self.recount_interval!r}"
            )
        if self.key_mode not in EDGE_KEY_MODES:
            raise ValueError(
                f"unknown key_mode {self.key_mode!r}; expected one of "
                f"{EDGE_KEY_MODES}"
            )
        if self.max_device_bytes is not None:
            b = self.max_device_bytes
            if not isinstance(b, int) or isinstance(b, bool) or b < 1:
                raise ValueError(
                    f"max_device_bytes must be None or a positive int, "
                    f"got {b!r}"
                )

    @property
    def resolved_shape_policy(self) -> ShapePolicy:
        """The concrete ``ShapePolicy`` (``None`` ⇒ ``DEFAULT_SHAPE_POLICY``)."""
        return self.shape_policy if self.shape_policy is not None \
            else DEFAULT_SHAPE_POLICY

    def key(self) -> tuple:
        """Normalized hashable identity, with ``shape_policy=None``
        resolved, so options differing only in explicit-vs-default values
        hash alike."""
        return (
            self.algorithm, self.variant, self.backend, self.strategy,
            self.widths, self.block, self.permute, self.bitmap_bits,
            self.prep_backend, self.resolved_shape_policy.key(),
            self.max_peel_iters, self.peel_early_exit,
            self.update_batch_size, self.recount_interval, self.chooser,
            self.key_mode, self.max_device_bytes,
        )

    def replace(self, **changes) -> "CountOptions":
        """A copy with ``changes`` applied (re-validated)."""
        return dataclasses.replace(self, **changes)

    def plan_kwargs(self, lane: str) -> dict:
        """The ``plan_triangle_count`` kwargs this lane consumes.

        Lanes ignore knobs that do not apply to them (the matrix lane has
        no ``widths``, the intersection lane no ``block``, the hash and bfs
        lanes no ``max_device_bytes``, the edge lane no ``backend``: its
        masks are torch ops, as in the reference), so one options object
        can drive ``algorithm="auto"`` across all lanes.

        Raises:
          ValueError: a lane the port does not have.
        """
        if lane == "intersection":
            return dict(variant=self.variant, backend=self.backend,
                        widths=self.widths, strategy=self.strategy,
                        bitmap_bits=self.bitmap_bits,
                        prep_backend=self.prep_backend,
                        shape_policy=self.shape_policy,
                        max_device_bytes=self.max_device_bytes)
        if lane == "subgraph":
            return dict(backend=self.backend, widths=self.widths,
                        strategy=self.strategy, bitmap_bits=self.bitmap_bits,
                        prep_backend=self.prep_backend,
                        shape_policy=self.shape_policy,
                        max_device_bytes=self.max_device_bytes)
        if lane == "matrix":
            return dict(backend=self.backend, block=self.block,
                        permute=self.permute,
                        max_device_bytes=self.max_device_bytes)
        if lane == "edge":
            return dict(widths=self.widths, strategy=self.strategy,
                        bitmap_bits=self.bitmap_bits,
                        prep_backend=self.prep_backend,
                        shape_policy=self.shape_policy,
                        max_peel_iters=self.max_peel_iters,
                        peel_early_exit=self.peel_early_exit,
                        key_mode=self.key_mode)
        if lane == "dynamic":
            return dict(backend=self.backend, widths=self.widths,
                        strategy=self.strategy, bitmap_bits=self.bitmap_bits,
                        shape_policy=self.shape_policy,
                        update_batch_size=self.update_batch_size,
                        recount_interval=self.recount_interval,
                        key_mode=self.key_mode)
        if lane == "hash":
            return dict(backend=self.backend, widths=self.widths,
                        prep_backend=self.prep_backend,
                        shape_policy=self.shape_policy)
        if lane == "bfs":
            return dict(backend=self.backend, widths=self.widths,
                        strategy=self.strategy, bitmap_bits=self.bitmap_bits,
                        shape_policy=self.shape_policy)
        if lane == "intersection_distributed":
            return dict(variant=self.variant, backend=self.backend,
                        widths=self.widths, strategy=self.strategy,
                        bitmap_bits=self.bitmap_bits,
                        prep_backend=self.prep_backend,
                        shape_policy=self.shape_policy)
        if lane == "matrix_distributed":
            return dict(backend=self.backend, block=self.block,
                        permute=self.permute)
        lanes = ("bfs", "dynamic", "edge", "hash", "intersection",
                 "intersection_distributed", "matrix", "matrix_distributed",
                 "subgraph")
        raise ValueError(
            f"unknown engine lane {lane!r}; expected one of {lanes}"
        )
