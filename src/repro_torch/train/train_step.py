"""Training step: loss, gradient accumulation (microbatching), optimizer.

The port of ``repro.train.train_step``. The model holds its weights, so
the loss and step functions take no ``params``: ``make_train_step`` binds
the model, and its step updates the parameters and the optimizer state in
place. Gradient accumulation is a Python loop over microbatches (the
reference's ``lax.scan``): each microbatch's gradients, from
``torch.autograd.grad`` over the model's parameters in
``named_parameters`` order, are cast to ``cfg.grad_accum_dtype`` and
divided by the microbatch count before they are added to the
accumulators, so the activations held are one microbatch's whatever the
global batch (with each block rematerialised under ``cfg.remat``).

The split is STRIDED (b-major), as the reference's: microbatch m takes
the rows k·n + m of the global batch.

Under an active mesh (``models.meshctx.activation_mesh``, the model's
parameters sharded by ``sharding.shard_model_``) the step is SPMD: every
rank is given the same global batch and keeps its rows of the data axes'
split (``sharding.local_rows``), which it splits strided as above, so
microbatch m holds the same rows as on one process. The cross-entropy's
denominator ``ntok`` counts the whole microbatch over the data ranks, the
MoE aux loss takes its means over the whole batch (``layers.moe``), and
each parameter's gradient arrives summed over the data ranks in its
parameter's placement (``meshctx.gather_param``), where the accumulators
(local shards in ``cfg.grad_accum_dtype``) take it. The gradients are
returned as ``DTensor``s of those placements, and ``adamw_update`` reads
every shard for the global norm. The same step on every mesh: loss,
``grad_norm``, parameters and moments are the one-process step's up to
the order of the sums.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import meshctx
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_init,
                                         adamw_update)
from repro_torch.train.sharding import local, local_rows, placed_like

__all__ = ["make_grad_fn", "make_loss_fn", "make_train_step",
           "init_train_state"]

_MOE_AUX_WEIGHT = 0.01


def make_loss_fn(model, cfg: ModelConfig) -> Callable:
    """Returns ``loss_fn(batch) -> (loss, {"xent", "aux", "ntok"})``: the
    token cross-entropy as logsumexp minus the label logit in fp32 over the
    positions with ``labels >= 0``, divided by max(their count, 1), plus
    0.01 × the model's aux loss."""
    def loss_fn(batch: Dict[str, torch.Tensor]):
        # under a mesh: the parameters outside the blocks gathered here,
        # each block's by layers.remat
        with meshctx.gathered([model], skip=(nn.ModuleList,)):
            logits, aux = model.apply_train(batch)
        labels = batch["labels"]
        valid = (labels >= 0).float()
        safe = torch.clamp(labels, min=0).long()
        # xent = logsumexp − label logit: no log_softmax over the full
        # (tokens, vocab) plane
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[..., None])[..., 0] - lse
        # under a mesh: the whole microbatch's tokens, and this rank's
        # share of the cross-entropy (the shares sum to it)
        ntok = torch.clamp(meshctx.batch_sum(valid.sum()), min=1.0)
        xent = -(ll * valid).sum() / ntok
        loss = xent + _MOE_AUX_WEIGHT * aux
        return loss, {"xent": meshctx.batch_sum(xent), "aux": aux,
                      "ntok": ntok}

    return loss_fn


def init_train_state(model, cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator) -> OptState:
    """Draw the model's weights from ``generator`` in place (its dtype is
    the one it was built with: bf16 by default, as the reference's
    ``init_train_state``), turn their gradients on, and return zero AdamW
    moments."""
    model.init(generator)
    L.trainable_(model)
    return adamw_init(dict(model.named_parameters()), opt_cfg)


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    """The strided split: microbatch m takes rows k·n + m."""
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch[{key!r}] has {x.shape[0]} rows, not a "
                             f"multiple of {n} microbatches")
    return [{k: x[m::n] for k, x in batch.items()} for m in range(n)]


def make_grad_fn(model, cfg: ModelConfig, *,
                 microbatches: Optional[int] = None) -> Callable:
    """Returns ``grad_fn(batch) -> (grads, metrics)``: the gradients of the
    loss at the model's current weights, keyed by parameter name, over the
    global batch (one pass, or the strided microbatches accumulated in
    ``cfg.grad_accum_dtype``, each divided by their count before it is
    added), and the loss metrics (averaged over the microbatches), detached.
    Turns the model's gradients on. Under an active mesh, ``batch`` is the
    global batch and each gradient a ``DTensor`` in its parameter's
    placement, summed over the data ranks."""
    n_micro = microbatches if microbatches is not None else cfg.microbatches
    acc_dtype = (torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16"
                 else torch.float32)
    loss_fn = make_loss_fn(model, cfg)

    def one(batch):
        names, params = zip(*model.named_parameters())
        loss, metrics = loss_fn(batch)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        return grads, {k: v.detach() for k, v in metrics.items()}

    def grad_fn(batch: Dict[str, torch.Tensor]):
        L.trainable_(model)
        mesh = meshctx.active_mesh()
        if mesh is not None:
            batch = local_rows(batch, mesh)
        if n_micro <= 1:
            return one(batch)
        params = dict(model.named_parameters())
        acc = {n: torch.zeros(local(p).shape, dtype=acc_dtype,
                              device=local(p).device)
               for n, p in params.items()}
        ms = []
        for mb in _microbatches(batch, n_micro):
            g, m = one(mb)
            for n, x in g.items():
                acc[n] += local(x).to(acc_dtype) / n_micro
            del g
            ms.append(m)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return {n: placed_like(a, params[n]) for n, a in acc.items()}, metrics

    return grad_fn


def make_train_step(model, cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: Optional[int] = None) -> Callable:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.

    ``batch`` holds tensors on the model's device with the GLOBAL batch
    leading; with microbatching it is split strided inside the step. The
    step updates the model's parameters and the moments in place
    (``adamw_update``); metrics: ``xent``, ``aux``, ``ntok`` (averaged over
    the microbatches), ``grad_norm``, ``lr`` and ``loss`` = xent + 0.01 ×
    aux, 0-d tensors on the device (reading one syncs the host).
    """
    grad_fn = make_grad_fn(model, cfg, microbatches=microbatches)

    def train_step(opt_state: OptState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[OptState, Dict[str, torch.Tensor]]:
        grads, metrics = grad_fn(batch)
        new_opt, opt_metrics = adamw_update(
            grads, opt_state, dict(model.named_parameters()), opt_cfg)
        del grads
        metrics = {**metrics, **opt_metrics,
                   "loss": metrics["xent"] + _MOE_AUX_WEIGHT * metrics["aux"]}
        return new_opt, metrics

    return train_step
