"""Plain torch version of the flash-attention kernel (K6).

The port of ``repro.kernels.flash_attention.ref``: materialised attention
over the whole (S, T) logit plane in fp32, the ground truth the tiled
kernel must match. Supports causal masking, a window and GQA via q-head
grouping (q head h reads kv head h // G, contiguous groups).

The mask rule is the kernel's: ``(q_pos - k_pos) < window``, applied also
when ``causal=False``. ``repro_torch.models.layers`` uses
``|q_pos - k_pos| < window`` when not causal; the two differ only for a
non-causal finite window (ROADMAP R10).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["flash_attention_ref"]


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, Hq, hd)
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,  # (B, T, Hkv, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    cap: Optional[float] = None,
) -> torch.Tensor:
    """(B, S, Hq, hd) attention output in q's dtype, fp32 arithmetic:
    logits = (q·k) / √hd, then ``tanh(·/cap)·cap``, the mask (-1e30), a
    softmax over the keys and ``·v``."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, hd).float()
    logits = torch.einsum("bshgd,bthd->bshgt", qg, k.float())
    logits = logits / math.sqrt(hd)
    if cap is not None:
        logits = torch.tanh(logits / cap) * cap
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    valid = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        valid &= qp >= kp
    if window is not None:
        valid &= (qp - kp) < window
    logits = torch.where(valid[None, :, None, None, :], logits,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bshgt,bthd->bshgd", p, v.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)
