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

``roofline_terms`` is the counterpart of the reference's function of that
name for a dry-run cell (``launch.dryrun``): the three terms of one rank's
traced step (``launch.op_cost.OpCost``) at the card's rates,

  compute    = Σ FLOPs of each dtype / its rate (bf16 and fp16 products
               on the tensor cores, fp32 outside them: TF32 is off)
  memory     = HBM bytes (the aten ops' and the kernels') / HBM rate
  collective = Σ wire bytes of each collective / the rate of the slowest
               link its group crosses

with the reference's ring factors (``RING_FACTORS``). Ranks sit
``RANKS_PER_NODE`` to a node in mesh order (rank // 8 is the node): a
group within one node is priced at NVLink's rate, one that spans nodes
at one InfiniBand link's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence

import torch

__all__ = ["HW", "RANKS_PER_NODE", "RING_FACTORS", "RooflineResult",
           "StageCost", "link_rate", "plan_seconds", "price_stage",
           "roofline_terms", "stage_cost"]

# NVIDIA H100 SXM5 80GB (the card the port runs on, "NVIDIA H100 80GB
# HBM3"): NVIDIA's data sheet, dense rates at the 700 W limit
HW = dict(
    name="NVIDIA H100 80GB HBM3 (SXM)",
    hbm_bw=3.35e12,        # bytes/s
    alu_ops=67e12,         # 32-bit operations/s outside the tensor cores
    bf16_flops=989e12,     # tensor-core bf16 FLOP/s
    fp32_flops=67e12,      # fp32 FLOP/s outside the tensor cores
    # NVLink 4 within an 8-card HGX H100 node: 900 GB/s a card both ways,
    # 450 GB/s a direction (NVIDIA H100 data sheet)
    nvlink_bw=450e9,       # bytes/s a direction, a card
    # across nodes: one 400 Gb/s NDR InfiniBand link a card (ConnectX-7,
    # the DGX H100 reference design), 50 GB/s a direction
    ib_bw=50e9,            # bytes/s a direction, a card
)

#: Cards a node (an HGX H100 board); ranks fill nodes in mesh order.
RANKS_PER_NODE = 8

#: Wire bytes of one rank a payload byte, by collective kind, for a group
#: of n ranks: the ring algorithms' factors (the reference's
#: ``collective_bytes``).
RING_FACTORS = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}

# FLOP rates by dtype name: the tensor cores for 16-bit products, the
# CUDA cores for fp32 (TF32 off) and anything else
_FLOP_RATES = {"bfloat16": HW["bf16_flops"], "float16": HW["bf16_flops"]}


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
    from repro_torch.core.engine import (CsrProbeLaunch, HashLaunch,
                                         IntersectLaunch, MatrixLaunch,
                                         _TiledStage)

    fn = stage.executable
    tiled = isinstance(stage, _TiledStage)
    launches = stage.num_chunks if tiled else 1
    shape = stage.chunk_shape_key if tiled else stage.shape_key
    if isinstance(fn, (IntersectLaunch, CsrProbeLaunch)):
        # a probe bucket read from the forward CSR is priced as the padded
        # rows it reads in place of: a bound above its real rows' bytes
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


def link_rate(ranks) -> float:
    """The rate (bytes/s a direction) of the slowest link a collective
    over global ``ranks`` crosses: NVLink within one node, InfiniBand
    across nodes."""
    nodes = {int(r) // RANKS_PER_NODE for r in ranks}
    return HW["nvlink_bw"] if len(nodes) <= 1 else HW["ib_bw"]


@dataclasses.dataclass
class RooflineResult:
    """One rank's three roofline terms (seconds) and what they price; the
    reference's record, with the collectives also by link."""

    flops: float
    flops_by_dtype: Dict[str, float]
    hbm_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, float]
    coll_by_link: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float
    useful_ratio: float

    @property
    def bound(self) -> float:
        """The step's least time: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return dict(dataclasses.asdict(self), bound=self.bound)


def roofline_terms(tally, *, model_flops_per_chip: float) -> RooflineResult:
    """The terms of one rank's traced step ``tally`` (an ``OpCost``): the
    aten ops' and the kernels' FLOPs by dtype and HBM bytes, and the
    collectives' wire bytes, each at its rate."""
    flops: Dict[str, float] = dict(tally.flops)
    hbm = float(tally.bytes_read + tally.bytes_written)
    for k in tally.kernels:
        flops[k["dtype"]] = flops.get(k["dtype"], 0.0) + k["flops"]
        hbm += k["bytes_read"] + k["bytes_written"]
    t_c = sum(f / _FLOP_RATES.get(d, HW["fp32_flops"])
              for d, f in flops.items())
    by_kind: Dict[str, float] = {}
    by_link = {"nvlink": 0.0, "infiniband": 0.0}
    t_n = 0.0
    for c in tally.collectives:
        by_kind[c["kind"]] = by_kind.get(c["kind"], 0.0) + c["wire"]
        rate = link_rate(c["ranks"])
        by_link["nvlink" if rate == HW["nvlink_bw"] else "infiniband"] += \
            c["wire"]
        t_n += c["wire"] / rate
    t_m = hbm / HW["hbm_bw"]
    total = float(sum(flops.values()))
    dominant = max((("compute", t_c), ("memory", t_m), ("collective", t_n)),
                   key=lambda kv: kv[1])[0]
    return RooflineResult(
        flops=total, flops_by_dtype=flops, hbm_bytes=hbm,
        coll_bytes=float(sum(by_kind.values())), coll_by_kind=by_kind,
        coll_by_link=by_link, t_compute=t_c, t_memory=t_m, t_collective=t_n,
        dominant=dominant, model_flops=float(model_flops_per_chip),
        useful_ratio=(model_flops_per_chip / total) if total else 0.0)
