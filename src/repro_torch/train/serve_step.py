"""Serving steps: batched prefill, single-token decode, and a greedy
generation loop.

The port of ``repro.train.serve_step``. The model holds its weights, so
these take no ``params``. The reference's ``lax.scan`` over decode steps is
a Python loop here; the cache's position is a host int and each step's
token stays on the device, so the loop never syncs the host.

Under an active mesh (``models.meshctx.activation_mesh``) each rank
prefills and decodes its rows of the batch against its shard of the
cache, and ``greedy_generate`` gathers every row's tokens over the data
axes at the end, so each rank returns the whole batch's.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import meshctx
from repro_torch.models.config import ModelConfig

__all__ = ["make_serve_fns", "greedy_generate"]


def make_serve_fns(model, cfg: ModelConfig):
    def prefill(batch: Dict[str, torch.Tensor], max_len: int):
        return model.prefill(batch, max_len)

    def decode_step(cache, tokens: torch.Tensor):
        """tokens (B, 1) — returns (logits (B, 1, V), the cache, updated in
        place)."""
        return model.decode_step(cache, tokens)

    return prefill, decode_step


@torch.no_grad()
def greedy_generate(model, cfg: ModelConfig, prompt_batch: Dict[str, torch.Tensor],
                    *, steps: int, max_len: int) -> torch.Tensor:
    """Prefill the prompt then greedy-decode ``steps`` tokens.

    ``prompt_batch`` goes to ``model.prefill`` whole: ``{"tokens": (B, S)}``
    and, for the vlm family, ``"patches"`` (B, P, vision_dim), for the
    encdec family ``"frames"`` (B, encoder_seq, d_model). ``max_len``
    must hold the P + S prefilled positions and the ``steps`` decoded ones
    (P + S + steps, or more): past the cache a ``decode_step`` raises
    ``ValueError``, where the reference's clamped write would overwrite the
    last slot (ROADMAP R12). The ssm family's state does not grow and the
    hybrid's ring holds min(window, ``max_len``) slots.

    Returns the (B, steps) tokens fed at each step, as the reference's scan
    emits them: the first is the argmax of the prefill's last position, and
    the argmax of the last decode step is dropped. Under an active mesh
    ``prompt_batch`` is the global batch; each rank runs its rows and
    returns every row's tokens.
    """
    rows = prompt_batch["tokens"].shape[0]
    logits, cache = model.prefill(prompt_batch, max_len)
    tok = torch.argmax(logits[:, -1:], dim=-1)  # (B, 1)
    del logits
    out = []
    for _ in range(steps):
        lg, cache = model.decode_step(cache, tok)
        out.append(tok[:, 0])
        tok = torch.argmax(lg[:, -1:], dim=-1)
    if not out:
        out = torch.empty((tok.shape[0], 0), dtype=tok.dtype,
                          device=tok.device)
    else:
        out = torch.stack(out, dim=1)  # (this rank's rows, steps)
    return meshctx.gather_rows(out, rows)
