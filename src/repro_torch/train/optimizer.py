"""AdamW with a warmup-stable-decay (WSD) schedule.

The port of ``repro.train.optimizer``. WSD (the MiniCPM schedule,
arXiv:2404.06395): linear warmup → constant plateau → a short exponential
tail to 1 % of the peak; ``schedule="cosine"`` and ``"constant"`` too.

``OptState`` holds ``step`` (a 0-d int32 tensor) and the moments ``mu`` and
``nu``, dicts keyed by the model's parameter names (``named_parameters``),
in ``AdamWConfig.moment_dtype`` (bf16 moments halve the optimizer's
memory; small runs use fp32). ``adamw_update`` keeps the reference's
arithmetic and order: the global norm in fp32 over every gradient, the
clip scale, ``step + 1`` before the learning rate, the bias corrections,
weight decay on every leaf, the update in fp32 cast back to the
parameter's and the moments' dtypes. Where the reference returns new
trees, it writes the parameters and moments in place (under
``torch.no_grad()``), leaf by leaf, so the fp32 temporaries are one
leaf's.

Sharded parameters (``DTensor``s, ``train.sharding.shard_model_``) get
moments of their placements, and the update runs on each rank's shards
(it is elementwise); the global norm sums each leaf's shard over the mesh
dims that split it (one all-reduce per split axis for the leaves that
share it), so every rank clips by the whole gradient's norm.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple

import torch

from repro_torch.train.sharding import local, placed_like

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "wsd_schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    stable_steps: int = 1000
    decay_steps: int = 100
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "wsd"  # wsd | cosine | constant
    moment_dtype: torch.dtype = torch.bfloat16


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def wsd_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), fp32."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    peak = torch.full_like(step, cfg.peak_lr)
    if cfg.schedule == "constant":
        return torch.where(step < cfg.warmup_steps, warm, peak)
    if cfg.schedule == "cosine":
        total = cfg.stable_steps + cfg.decay_steps
        frac = torch.clamp((step - cfg.warmup_steps) / max(total, 1), 0.0, 1.0)
        return torch.where(
            step < cfg.warmup_steps, warm,
            0.5 * cfg.peak_lr * (1 + torch.cos(math.pi * frac)))
    # wsd: plateau then an exponential tail to ~1 % of the peak
    decay_start = cfg.warmup_steps + cfg.stable_steps
    tail = torch.clamp((step - decay_start) / max(cfg.decay_steps, 1),
                       0.0, 1.0)
    return torch.where(
        step < cfg.warmup_steps, warm,
        torch.where(step < decay_start, peak,
                    cfg.peak_lr * torch.pow(0.01, tail)))


def adamw_init(params: Mapping[str, torch.Tensor],
               cfg: AdamWConfig) -> OptState:
    """Zero moments of each parameter's shape, on its device (a sharded
    parameter's: zero shards of its placements)."""
    def zeros():
        return {name: placed_like(torch.zeros(local(p).shape,
                                              dtype=cfg.moment_dtype,
                                              device=p.device), p)
                for name, p in params.items()}

    dev = next(iter(params.values())).device if params else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros(), nu=zeros())


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over the leaves (in order) of each leaf's fp32 sum
    of squares. Sharded leaves: each shard's sum, grouped by the mesh dims
    that split the leaf, each group summed over those dims (so a leaf
    replicated over a dim is counted once)."""
    from torch.distributed.tensor import DTensor, Shard

    grads = list(grads)
    if not any(isinstance(g, DTensor) for g in grads):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
    groups: Dict[tuple, torch.Tensor] = {}
    for g in grads:
        split = () if not isinstance(g, DTensor) else tuple(
            m for m, p in enumerate(g.placements) if isinstance(p, Shard))
        sq = torch.sum(torch.square(local(g).float()))
        groups[split] = groups[split] + sq if split in groups else sq
    mesh = next(g.device_mesh for g in grads if isinstance(g, DTensor))
    total = None
    for split, sq in groups.items():
        for m in split:
            torch.distributed.all_reduce(sq, group=mesh.get_group(m))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: OptState,
                 params: Mapping[str, torch.Tensor],
                 cfg: AdamWConfig):
    """One AdamW step: writes ``params`` and the moments of ``state`` in
    place and returns (the new ``OptState``, whose ``step`` is a new
    tensor, and the metrics {``grad_norm``, ``lr``}, 0-d fp32 tensors).
    ``grads``, ``state.mu``, ``state.nu`` and ``params`` share their
    keys."""
    gnorm = _global_norm(grads.values())
    one = torch.ones_like(gnorm)
    # the clip over a tensor divisor: a Python number over a tensor
    # multiplies by the reciprocal in PyTorch
    scale = torch.minimum(one, (one * cfg.grad_clip)
                          / torch.clamp(gnorm, min=1e-9))
    step = state.step + 1
    lr = wsd_schedule(step, cfg)
    c1 = 1.0 - cfg.b1 ** step.float()
    c2 = 1.0 - cfg.b2 ** step.float()
    for name, g in grads.items():
        p, m, v = (local(params[name]), local(state.mu[name]),
                   local(state.nu[name]))
        g = local(g).float() * scale
        m_new = cfg.b1 * m.float()
        m_new += (1 - cfg.b1) * g
        v_new = cfg.b2 * v.float()
        g2 = (1 - cfg.b2) * g
        g2 *= g
        v_new += g2
        del g, g2
        m.copy_(m_new)
        v.copy_(v_new)
        # mhat / (sqrt(vhat) + eps), each in its fp32 moment's buffer
        delta = m_new.div_(c1)
        delta /= v_new.div_(c2).sqrt_().add_(cfg.eps)
        del v_new
        delta += cfg.weight_decay * p.float()
        delta *= lr
        p.copy_(p.float() - delta)
    return (OptState(step=step, mu=state.mu, nu=state.nu),
            {"grad_norm": gnorm, "lr": lr})
