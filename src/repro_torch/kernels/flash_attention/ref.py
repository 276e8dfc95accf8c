"""Plain torch version of the flash-attention kernel (K6).

The port of ``repro.kernels.flash_attention.ref``: materialised attention
over the whole (S, T) logit plane in fp32, the ground truth the tiled
kernel must match. Supports causal masking, a window, a bidirectional
prefix and GQA via q-head grouping (q head h reads kv head h // G,
contiguous groups).

The mask rule is the kernel's: key k is valid for query q when
``((not causal or q - k >= 0) and q - k < window) or k < prefix_len``,
the window applied also when ``causal=False``. For a causal mask this is
``repro_torch.models.layers._mask``'s rule; when not causal, ``layers``
uses ``|q_pos - k_pos| < window``, and the two differ only for a
non-causal finite window (ROADMAP R10).

``flash_within_tolerance`` is K6's numeric contract against this oracle,
the one definition that the tests and ``chip_smoke.py`` hold the kernel
(and the library call it is timed against) to. ``flash_row_rms`` with
``ROW_RMS_BOUND`` is its per-row companion for 16-bit outputs, tight where
a row's keys are many and its values small.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["ROW_RMS_BOUND", "flash_attention_ref", "flash_row_rms",
           "flash_within_tolerance"]

# one rounding step of the output type, relative: two half steps, one on
# each side of the comparison
_OUTPUT_STEP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
                torch.float16: 2.0 ** -10}
# the softmax weights p <= 1 rounded to the input type before p·v
_WEIGHT_STEP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
                torch.float16: 2.0 ** -11}
#: The largest ``flash_row_rms`` a 16-bit output may have: the weights'
#: rounding (each p off by at most 2⁻⁸ / 2⁻¹¹ of itself, so a row's error
#: is at most that share of its RMS when its values do not cancel) plus
#: the output's own rounding (the same share of each element).
ROW_RMS_BOUND = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, Hq, hd)
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,  # (B, T, Hkv, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    cap: Optional[float] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """(B, S, Hq, hd) attention output in q's dtype, fp32 arithmetic:
    logits = (q·k) / √hd, then ``tanh(·/cap)·cap``, the mask (-1e30), a
    softmax over the keys and ``·v``. Keys below ``prefix_len`` are valid
    for every query (the VLM's bidirectional prefix)."""
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
    if prefix_len:
        valid |= kp < prefix_len
    logits = torch.where(valid[None, :, None, None, :], logits,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bshgt,bthd->bshgd", p, v.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)


def flash_within_tolerance(
    out: torch.Tensor,
    want: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    cap: Optional[float] = None,
    prefix_len: int = 0,
) -> Tuple[bool, float]:
    """Whether ``out`` (attention of q, k, v) agrees with ``want`` within
    K6's numeric contract, and the largest |out − want|.

    fp32 inputs: 1e-4 (fp32 sums in another order, values of order 1).
    bf16 / fp16 inputs, elementwise: one rounding step of the output type
    (2⁻⁷ / 2⁻¹⁰ of the larger magnitude), plus 2⁻⁸ / 2⁻¹¹ of the p-weighted
    mean of |v| (``flash_attention_ref`` over |v|), plus 1e-4. The middle
    term bounds the one rounding beyond fp32 arithmetic that the 16-bit
    kernel makes: the softmax weights p ≤ 1 rounded to the input type
    before p·v, which is what the TPU kernel's default-precision dot does
    too (and what a library call on 16-bit inputs does).
    """
    o32, w32 = out.float(), want.float()
    diff = (o32 - w32).abs()
    bound = _OUTPUT_STEP[q.dtype] * torch.maximum(o32.abs(), w32.abs()) + 1e-4
    if _WEIGHT_STEP[q.dtype]:
        bound = bound + _WEIGHT_STEP[q.dtype] * flash_attention_ref(
            q, k, v.abs(), causal=causal, window=window, cap=cap,
            prefix_len=prefix_len).float()
    return bool((diff <= bound).all()), float(diff.max())


def flash_row_rms(
    out: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    cap: Optional[float] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """(B, S, Hq) relative RMS error of each output row against the oracle
    in fp32: ``RMS(out − want) / RMS(want)`` over hd.

    The elementwise slack of ``flash_within_tolerance`` scales with the
    mean |v|, which is far above a row's values where many keys share its
    weight; this measure scales with the row itself. For 16-bit outputs
    it is held to ``ROW_RMS_BOUND``.
    """
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               causal=causal, window=window, cap=cap,
                               prefix_len=prefix_len)
    err = (out.float() - want).pow(2).mean(-1).sqrt()
    return err / want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
