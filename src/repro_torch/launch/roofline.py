"""Analytic prices of a plan's count stages on the H100.

The counterpart of ``repro.launch.roofline``, which prices XLA HLO against
TPU v5e constants. The port has no HLO: a stage is priced from what the
plan already knows about it, its ``shape_key``, its resolved ``strategy``
and the dtypes and sizes of its resident arguments, with the bound model
``PERF.md`` §6 states for each kernel:

    seconds = max(bytes / HBM rate, operations / rate of their type)

* K1–K3 (an intersection stage, (E, W)): u and v read once, (E,) int32
  counts written; 2·W compares a row at the 32-bit ALU rate.
* K4 (a matrix stage, (T, B, B)): the unique L and U tiles held, the
  three (T,) int32 indices and the launch order read once, (T,) float32
  partials written; 2·T·B³ operations at the tensor-core bf16 rate for
  bf16 tiles, the fp32 rate for float32 ones.
* K5 (a hash stage, (E, W, B, D)): the candidates, anchors and row ends,
  the compact table's offsets and ids read once, (E,) int32 counts
  written; the chain compares, taken as one probe a candidate slot times
  the table's mean chain length (ids over chains), at the 32-bit rate.
  Where the rows end early or a probe hits, fewer compares run: the price
  needs no device read.
* A ``_TiledStage`` is its chunk launch priced as above times
  ``num_chunks``: device work only. The host-to-device copies that feed
  the chunks are not in the price.

The bound leaves out launch latency, the int64 reductions and the host
sync that ends a ``count()``, so a price is a lower bound on a stage's
time. It is monotone in the work a lane gives the card, which is what
ranking lanes needs (``core.calibrate.analytic_seed``). Nothing here
launches a kernel or reads device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import torch

__all__ = ["HW", "StageCost", "plan_seconds", "price_stage", "stage_cost"]

# NVIDIA H100 SXM5 80GB (the card the port runs on, "NVIDIA H100 80GB
# HBM3"): NVIDIA's data sheet, dense rates at the 700 W limit
HW = dict(
    name="NVIDIA H100 80GB HBM3 (SXM)",
    hbm_bw=3.35e12,        # bytes/s
    alu_ops=67e12,         # 32-bit operations/s outside the tensor cores
    bf16_flops=989e12,     # tensor-core bf16 FLOP/s
    fp32_flops=67e12,      # fp32 FLOP/s outside the tensor cores
)


@dataclasses.dataclass(frozen=True)
class StageCost:
    """One stage's bound: the bytes it must move and the operations it must
    do, and the seconds each takes at the card's rates."""

    kernel: str            # "K1-K3" | "K4" | "K5"
    bytes: int
    operations: int
    t_memory: float
    t_compute: float
    launches: int = 1

    @property
    def seconds(self) -> float:
        return max(self.t_memory, self.t_compute)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.t_memory >= self.t_compute else "operations"


def _nbytes(xs: Iterable[torch.Tensor]) -> int:
    return int(sum(x.numel() * x.element_size() for x in xs))


def stage_cost(kind: str, shape_key: Sequence[int], *,
               dtype: torch.dtype = torch.int32,
               resident_bytes: Optional[int] = None,
               table_ids: int = 0, table_chains: int = 0,
               launches: int = 1) -> StageCost:
    """The bound of ``launches`` launches of one stage shape.

    Args:
      kind: "intersection" (K1–K3, ``shape_key`` (E, W)), "matrix" (K4,
        (T, B, B)) or "hash" (K5, (E, W, B, D)).
      dtype: the matrix tiles' dtype (bf16 goes to the tensor cores).
      resident_bytes: the matrix lane's tiles, indices and order, or the
        hash lane's compact table (offsets and ids): what the launch reads
        besides its rows. Required for those two kinds.
      table_ids / table_chains: the compact table's ids and chains (hash).
      launches: how many times the launch runs (a tiled stage's chunks).

    Raises:
      ValueError: an unknown kind, or a missing ``resident_bytes``.
    """
    alu = HW["alu_ops"]
    if kind == "intersection":
        e, w = (int(x) for x in shape_key[:2])
        nbytes = 2 * e * w * 4 + 4 * e
        ops, rate, kernel = 2 * e * w, alu, "K1-K3"
    elif kind == "matrix":
        if resident_bytes is None:
            raise ValueError("a matrix stage needs resident_bytes")
        t, b = int(shape_key[0]), int(shape_key[1])
        nbytes = int(resident_bytes) + 4 * t
        ops = 2 * t * b ** 3
        rate = HW["bf16_flops"] if dtype == torch.bfloat16 \
            else HW["fp32_flops"]
        kernel = "K4"
    elif kind == "hash":
        if resident_bytes is None:
            raise ValueError("a hash stage needs resident_bytes")
        e, w = int(shape_key[0]), int(shape_key[1])
        nbytes = e * w * 4 + 8 * e + int(resident_bytes) + 4 * e
        mean_chain = table_ids / table_chains if table_chains else 0.0
        ops, rate, kernel = int(round(e * w * mean_chain)), alu, "K5"
    else:
        raise ValueError(f"unknown stage kind {kind!r}; expected "
                         f"'intersection', 'matrix' or 'hash'")
    n = int(launches)
    return StageCost(kernel=kernel, bytes=n * nbytes, operations=n * ops,
                     t_memory=n * nbytes / HW["hbm_bw"],
                     t_compute=n * ops / rate, launches=n)


def price_stage(stage) -> StageCost:
    """The bound of one ``TrianglePlan`` stage (a ``_Stage`` or a
    ``_TiledStage``), from its shape key, its launch's kind and its
    arguments' sizes and dtypes."""
    from repro_torch.core.engine import (HashLaunch, IntersectLaunch,
                                         MatrixLaunch, _TiledStage)

    fn = stage.executable
    tiled = isinstance(stage, _TiledStage)
    launches = stage.num_chunks if tiled else 1
    shape = stage.chunk_shape_key if tiled else stage.shape_key
    if isinstance(fn, IntersectLaunch):
        return stage_cost("intersection", shape, launches=launches)
    if isinstance(fn, MatrixLaunch):
        # resident: (l, u, u, li, ui, ai, order); a chunk: (l, u, li, ui,
        # ai, order), its U tiles serving as A's
        args = stage.chunks[0] if tiled else stage.args[:2] + stage.args[3:]
        return stage_cost("matrix", shape, dtype=args[0].dtype,
                          resident_bytes=_nbytes(args), launches=launches)
    if isinstance(fn, HashLaunch):
        chain_ptr, chain_vals = stage.args[3], stage.args[4]
        return stage_cost("hash", shape,
                          resident_bytes=_nbytes((chain_ptr, chain_vals)),
                          table_ids=int(chain_vals.numel()),
                          table_chains=int(chain_ptr.numel()) - 1,
                          launches=launches)
    raise ValueError(f"no price for a stage of {type(fn).__name__}")


def plan_seconds(plan) -> float:
    """The sum of the stage bounds of a ``TrianglePlan``'s ``count()``."""
    return float(sum(price_stage(st).seconds for st in plan.stages))
