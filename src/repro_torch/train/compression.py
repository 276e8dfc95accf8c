"""Error-feedback int8 gradient compression for the data-parallel
all-reduce.

The port of ``repro.train.compression``, a library as in the reference
(the train driver has no flag that turns it on). At 1000+ nodes the
inter-pod all-reduce of bf16 gradients is the bandwidth tail; 1-byte
quantization with error feedback (the residual carried to the next step)
cuts the cross-pod bytes 2× against bf16 and 4× against fp32.

Mechanics: per-leaf symmetric int8 quantization (scale = max|g+e|/127,
values ``round((g+e) / scale)``, half to even as ``jnp.round``, clipped to
±127), an all-reduce in int32 (overflow-safe to 2^23 summands),
dequantized by the shared scale. The residual e ← (g+e) − Q⁻¹(Q(g+e)) is
optimizer state, kept per rank. Gradients are dicts keyed by parameter
name (any mapping of tensors); the residuals are fp32. There is no
kernel: the reference has none.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

__all__ = ["ef_init", "compress_decompress", "ef_psum"]


def ef_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero fp32 residuals shaped as ``params``, on their devices."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``round(g / scale)`` clipped to ±127 (a division by a tensor,
    never a product with its reciprocal)."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)


def compress_decompress(grads: Mapping[str, torch.Tensor],
                        ef_state: Mapping[str, torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """Single-process path: quantize and dequantize each leaf and update
    its residual. Models exactly what the wire sees; the all-reduce itself
    is exact in int32. Returns (dequantized gradients in each one's dtype,
    new residuals)."""
    out, res = {}, {}
    for k, g in grads.items():
        gf = g.float() + ef_state[k]
        scale = _scale(gf.abs().amax())
        deq = _quantize(gf, scale).float() * scale
        out[k], res[k] = deq.to(g.dtype), gf - deq
    return out, res


def ef_psum(grads: Mapping[str, torch.Tensor],
            ef_state: Mapping[str, torch.Tensor], group=None
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The compressed all-reduce over ``group`` (None: the default group).
    The ranks first agree on a SHARED scale (an all-reduce MAX of the local
    maxima, one scalar a leaf), then int8-quantize, sum in int32, and
    dequantize by the shared scale: mixing per-rank scales inside an
    integer reduction would be unrecoverable. Returns (the summed
    gradients in each one's dtype, this rank's new residuals)."""
    out, res = {}, {}
    for k, g in grads.items():
        gf = g.float() + ef_state[k]
        local_max = torch.clamp(gf.abs().amax(), min=1e-12)
        dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
        scale = local_max / torch.full_like(local_max, 127.0)
        q = _quantize(gf, scale)
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        out[k] = (total.float() * scale).to(g.dtype)
        res[k] = gf - q.float() * scale
    return out, res
