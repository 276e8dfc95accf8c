"""Layer primitives of the dense transformer.

The port of ``repro.models.layers`` for the dense family. Parameters are
``nn.ParameterDict`` / ``nn.ModuleDict`` trees with the reference's names
and its ``(d_in, d_out)`` weight layout, so ``dense`` is ``x @ w`` as
there; each ``*_init`` draws from a ``torch.Generator`` with the
reference's distributions (He normal over ``d_in``, norm scales of zero).

Attention has two paths. The plain one is the reference's chunked-KV
online-softmax scan (``backend="chunked"``), which CPU tensors always take.
On a CUDA tensor, ``attention`` runs the prefill case — no prefix, query
and key positions ``arange(S)`` — through the flash kernel K6
(``repro_torch.kernels.flash_attention.ops``), the counterpart of the Pallas
kernel that the reference names as its drop-in MXU version. Any other case
on a CUDA tensor (a bidirectional prefix, padded key positions, a
non-causal finite window) raises ``NotImplementedError``; it never quietly
takes the plain path. ``decode_attention`` is plain torch on every device.

``constrain`` (``repro.models.meshctx``) is a no-op without a mesh and is
left out; ``moe``, ``quantize_kv`` and ``dequantize_kv`` are not ported yet
and raise.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = [
    "ATTENTION_BACKENDS",
    "NO_WINDOW",
    "attention",
    "decode_attention",
    "dense",
    "dense_init",
    "dequantize_kv",
    "init_attention_block",
    "init_mlp",
    "init_moe",
    "mask_padded_vocab",
    "mlp",
    "moe",
    "quantize_kv",
    "rmsnorm",
    "rmsnorm_init",
    "rope",
    "softcap",
]

#: Window of a global-attention layer (the reference's NO_WINDOW).
NO_WINDOW = 1 << 30

#: ``attention`` backends: K6 on CUDA tensors, or the chunked plain path.
ATTENTION_BACKENDS = ("kernel", "chunked")

_LATER = "not ported yet (ROADMAP Queue 1, item 15)"


def _he(gen: Optional[torch.Generator], shape, dtype,
        fan_in: Optional[int] = None, device=None):
    """He normal over ``fan_in`` (default ``shape[0]``), drawn in fp32 on
    the generator's device and cast; with ``gen=None`` an uninitialised
    tensor on ``device`` (structure to load weights into)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan = fan_in if fan_in is not None else shape[0]
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) / math.sqrt(fan)
    return x.to(dtype)


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.bfloat16,
               device=None) -> nn.ParameterDict:
    """``{"w": (d_in, d_out)[, "b": (d_out,) zeros]}``, drawn from ``gen``
    (``gen=None``: uninitialised on ``device``)."""
    p = nn.ParameterDict(
        {"w": _param(_he(gen, (d_in, d_out), dtype, device=device))})
    if bias:
        p["b"] = _param(torch.zeros(
            (d_out,), dtype=dtype,
            device=gen.device if gen is not None else device))
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.bfloat16,
                 device: Union[str, torch.device] = "cpu") -> nn.ParameterDict:
    # gemma-style (1 + scale)
    return nn.ParameterDict(
        {"scale": _param(torch.zeros((d,), dtype=dtype, device=device))})


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def quantize_kv(x):
    """The int8 KV cache is not ported yet."""
    raise NotImplementedError(f"quantize_kv: the int8 KV cache is {_LATER}")


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    """The int8 KV cache is not ported yet."""
    raise NotImplementedError(f"dequantize_kv: the int8 KV cache is {_LATER}")


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Kill padded-vocab logits (embed tables are padded so the vocab dim
    shards evenly; see ModelConfig.padded_vocab). In place."""
    if logits.shape[-1] != vocab:
        logits[..., vocab:] = -1e30
    return logits


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding, half-split (the first half against the second).
    x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq  # (..., S, half)
    ang = ang[..., :, None, :]  # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
#
# ``window`` is a Python int everywhere (NO_WINDOW for global attention).
# Padded key slots use k_pos = -1, which every mask rejects via k_pos >= 0.


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
          causal: bool, prefix_len: int) -> torch.Tensor:
    """(S, C) boolean validity mask from absolute positions."""
    qk = q_pos[:, None] - k_pos[None, :]
    if causal:
        valid = (qk >= 0) & (qk < window)
    else:
        valid = qk.abs() < window
    if prefix_len:
        valid = valid | (k_pos[None, :] < prefix_len)
    return valid & (k_pos[None, :] >= 0)


def _is_arange(pos: torch.Tensor, n: int) -> bool:
    """``pos`` is ``arange(n)`` (one device-to-host read on a card)."""
    return pos.dim() == 1 and pos.shape[0] == n and bool(
        torch.equal(pos, torch.arange(n, dtype=pos.dtype, device=pos.device)))


def _attention_chunked(q, k, v, *, q_pos, k_pos, window: int, causal: bool,
                       prefix_len: int, cap: Optional[float], chunk: int):
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, hd).float()
    scale = 1.0 / math.sqrt(hd)

    chunk = min(chunk, t)
    nchunks = -(-t // chunk)
    pad = nchunks * chunk - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
    masked = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
    m_run = torch.full((b, s, hkv, g), -1e30, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, s, hkv, g), dtype=torch.float32, device=q.device)
    o_run = torch.zeros((b, s, hkv, g, hd), dtype=torch.float32,
                        device=q.device)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kci, vci, pci = k[:, sl].float(), v[:, sl].float(), k_pos[sl]
        logits = torch.einsum("bshgd,bchd->bshgc", qg, kci)
        logits = logits * scale
        if cap is not None:
            logits = softcap(logits, cap)
        valid = _mask(q_pos, pci, window, causal, prefix_len)  # (S, C)
        logits = torch.where(valid[None, :, None, None, :], logits, masked)
        m_new = torch.maximum(m_run, logits.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(logits - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        o_run = o_run * alpha[..., None] + torch.einsum(
            "bshgc,bchd->bshgd", p, vci)
        m_run = m_new
    out = o_run / torch.clamp(l_run[..., None], min=1e-30)
    return out.reshape(b, s, hq, hd).to(q.dtype)


def attention(
    q: torch.Tensor,  # (B, S, Hq, hd)
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,  # (B, T, Hkv, hd)
    *,
    q_pos: Optional[torch.Tensor] = None,  # (S,); None: arange(S)
    k_pos: Optional[torch.Tensor] = None,  # (T,); None: arange(T)
    window: int = NO_WINDOW,
    causal: bool = True,
    prefix_len: int = 0,
    cap: Optional[float] = None,
    chunk: int = 1024,
    backend: str = "kernel",
) -> torch.Tensor:
    """GQA attention. Returns (B, S, Hq, hd) in q's dtype.

    ``backend="chunked"``, and every CPU tensor, takes the chunked-KV
    online-softmax scan: the KV axis in ``chunk``-sized tiles with a
    running (max, sumexp, out) accumulator, never the S×T logit matrix.
    ``backend="kernel"`` on a CUDA tensor runs K6; it needs
    ``prefix_len == 0``, ``S == T``, positions ``arange(S)`` and, when not
    causal, no finite window (the kernel keeps ``q_pos - k_pos < window``,
    this function ``|q_pos - k_pos| < window``). Positions left as ``None``
    are ``arange`` by contract, which costs no device read; given ones are
    checked with one device-to-host read each.

    Raises:
      NotImplementedError: ``backend="kernel"`` on a CUDA tensor in any
        other case (a prefix, padded or shifted positions, a non-causal
        window).
      ValueError: an unknown backend.
    """
    window = int(window)
    if backend not in ATTENTION_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected "
                         f"one of {ATTENTION_BACKENDS}")
    s, t = q.shape[1], k.shape[1]
    if backend == "chunked" or q.device.type == "cpu":
        if q_pos is None:
            q_pos = torch.arange(s, device=q.device)
        if k_pos is None:
            k_pos = torch.arange(t, device=q.device)
        return _attention_chunked(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                  window=window, causal=causal,
                                  prefix_len=prefix_len, cap=cap, chunk=chunk)
    if prefix_len or (not causal and window < NO_WINDOW) or s != t \
            or (q_pos is not None and not _is_arange(q_pos, s)) \
            or (k_pos is not None and not _is_arange(k_pos, t)):
        raise NotImplementedError(
            f"attention on {q.device} runs the flash kernel only for a "
            f"prefill: prefix_len == 0 (got {prefix_len}), q_pos == k_pos == "
            f"arange(S), and a causal mask or no window (causal={causal}, "
            f"window={window}); bidirectional prefixes and padded keys are "
            f"{_LATER}")
    return flash_attention(
        q, k, v, causal=causal, window=None if window >= NO_WINDOW else window,
        cap=cap, backend="kernel")


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, hd)
    k_cache: torch.Tensor,  # (B, T, Hkv, hd)
    v_cache: torch.Tensor,
    *,
    cur_pos: int,  # index of the new token
    window: int = NO_WINDOW,
    cap: Optional[float] = None,
) -> torch.Tensor:
    """Single-step attention against the KV cache (plain torch).

    The reference masks the whole cache to ``cur_pos - window < pos <=
    cur_pos``; here the cache is sliced to those keys first, which is the
    same softmax (the masked entries are exactly 0 there) without reading
    the rest. ``cur_pos`` is a host int, so no step syncs the host.
    """
    b, _, hq, hd = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    pos = int(cur_pos)
    if not 0 <= pos < t:
        raise ValueError(f"cur_pos {pos} outside the cache's {t} slots")
    lo = max(0, pos + 1 - int(window))
    qg = q.reshape(b, hkv, g, hd).float()
    logits = torch.einsum("bhgd,bthd->bhgt", qg,
                          k_cache[:, lo:pos + 1].float())
    logits = logits / math.sqrt(hd)
    if cap is not None:
        logits = softcap(logits, cap)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v_cache[:, lo:pos + 1].float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def init_attention_block(gen: Optional[torch.Generator], cfg,
                         dtype=torch.bfloat16, device=None) -> nn.ModuleDict:
    hd = cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return nn.ModuleDict({
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd,
                         bias=cfg.qkv_bias, **kw),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_heads * hd,
                         bias=cfg.qkv_bias, **kw),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_heads * hd,
                         bias=cfg.qkv_bias, **kw),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, **kw),
    })


# ---------------------------------------------------------------- MLP / MoE


def init_mlp(gen: Optional[torch.Generator], d: int, ff: int, *,
             gated: bool = True, dtype=torch.bfloat16,
             device=None) -> nn.ModuleDict:
    kw = dict(dtype=dtype, device=device)
    p = nn.ModuleDict({"wi": dense_init(gen, d, ff, **kw),
                       "wo": dense_init(gen, ff, d, **kw)})
    if gated:
        p["wg"] = dense_init(gen, d, ff, **kw)
    return p


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = dense(p["wi"], x)
    if "wg" in p:
        gate = dense(p["wg"], x)
        h = (F.silu(gate.float()) * h.float()).to(x.dtype)
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(p["wo"], h)


def init_moe(gen, cfg, dtype=torch.bfloat16):
    """MoE (arctic, dbrx) is not ported yet."""
    raise NotImplementedError(f"init_moe: the MoE family is {_LATER}")


def moe(p, x, cfg):
    """MoE (arctic, dbrx) is not ported yet."""
    raise NotImplementedError(f"moe: the MoE family is {_LATER}")
