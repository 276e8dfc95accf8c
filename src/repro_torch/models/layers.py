"""Layer primitives of the port's language models (every family).

The port of ``repro.models.layers``. Parameters are ``nn.ParameterDict`` /
``nn.ModuleDict`` trees (``ParamTree`` where a node holds arrays and
sub-trees together, as the MoE block does) with the reference's names and
its ``(d_in, d_out)`` weight layout, so ``dense`` is ``x @ w`` as there.
Each parameter records the fan of its He-normal draw (``he_fan``; none for
the zero-initialised norm scales and biases), or, made by ``leaf``, a
normal's standard deviation (``init_std``) or a constant (``init_fill``),
so ``draw_`` can fill it in place with the reference's distribution; each
``*_init`` given a ``torch.Generator`` draws at once.

Parameters are frozen (``requires_grad=False``) as built: serving never
records a graph. ``trainable_`` turns gradients on for every parameter of
a model (the train step does), and ``remat`` runs a block under
activation checkpointing (``torch.utils.checkpoint``, non-reentrant: the
reference's ``jax.checkpoint``) when grad mode is on.

Attention has two paths. The plain one is the reference's chunked-KV
online-softmax scan (``backend="chunked"``), which CPU tensors always take.
On a CUDA tensor, ``attention`` runs through the flash kernel K6
(``repro_torch.kernels.flash_attention.ops``), the counterpart of the
Pallas kernel that the reference names as its drop-in MXU version, in two
cases: the prefill case — query and key positions ``arange(S)``, with or
without the VLM's bidirectional prefix — and a non-causal call without a
window for any S and T (whisper's encoder and cross-attention), where
positions do not enter the mask. Any other case on a CUDA tensor (padded
or shifted key positions, a non-causal finite window) raises
``NotImplementedError``; it never quietly takes the plain path. When grad
mode is on and q, k or v requires grad, the kernel runs through the
autograd Function ``FlashAttention``, whose backward differentiates the
chunked scan on the same inputs (the reference differentiates its jnp
path; it has no backward kernel).
``decode_attention`` and the hybrid's ring-buffer decode
(``repro_torch.models.rglru.ring_decode_attention``) are plain torch on
every device. On ``meta`` tensors (the dry run) ``attention`` takes the
kernel path, where K6's wrapper is shape-only, never the chunked scan.

``moe`` is the reference's grouped capacity-based top-k dispatch in plain
torch (the reference has no Pallas kernel for it): the one-hot (B, S, E, C)
dispatch and combine, and the three expert products as ``torch.bmm`` over
the expert axis on the (E, d, ff) / (E, ff, d) weights in place.
``quantize_kv`` / ``dequantize_kv`` are the int8 KV cache's symmetric
per-head quantisation.

Under an active mesh (``repro_torch.models.meshctx``, the sharded train
step) three places meet the other ranks, at the reference's ``constrain``
points: ``attention`` lays q, k and v out by heads over ``"model"``
(``meshctx.local_heads``) and runs K6 or the chunked scan, unchanged, on
this rank's heads, then gathers the heads; ``moe`` runs this rank's
experts (the expert input cut over ``"model"``, the expert stacks held
split) and takes its load-balance means over the whole batch; ``remat``
gathers a block's sharded parameters inside the block, so a recomputed
block gathers them again. Serving under a mesh reads its KV cache as this
rank's shard (``train.sharding.local_cache``; ``cache_write`` writes a
prompt's or a token's k and v into it, ``cache_decode_attention`` and
``cache_cross_attention`` attend over it): a cache split over the kv
heads attends on this rank's heads and gathers them; a cache split over
the sequence (flash-decode style) attends over the live keys this rank
holds (``decode_attention_partial``) and the ranks merge by their
log-sum-exp (``meshctx.lse_merge``). Without a mesh each is the one-card
code.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels.flash_attention.flash_attention import FlashAttention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import meshctx

__all__ = [
    "ATTENTION_BACKENDS",
    "NO_WINDOW",
    "ParamTree",
    "attention",
    "cache_cross_attention",
    "cache_decode_attention",
    "cache_write",
    "decode_attention",
    "decode_attention_partial",
    "dense",
    "dense_init",
    "dequantize_kv",
    "draw_",
    "init_attention_block",
    "init_mlp",
    "init_moe",
    "leaf",
    "mask_padded_vocab",
    "mlp",
    "moe",
    "moe_route",
    "quantize_kv",
    "remat",
    "rmsnorm",
    "rmsnorm_init",
    "rope",
    "softcap",
    "trainable_",
    "unembed",
]

#: Window of a global-attention layer (the reference's NO_WINDOW).
NO_WINDOW = 1 << 30

#: ``attention`` backends: K6 on CUDA tensors, or the chunked plain path.
ATTENTION_BACKENDS = ("kernel", "chunked")

#: The most fp32 elements one draw of ``draw_`` holds (1 GiB): a larger
#: leaf (an MoE expert stack) is drawn in slices of its leading axis.
DRAW_ELEMS = 1 << 28


def _param(x: torch.Tensor, fan: Optional[int] = None) -> nn.Parameter:
    """A frozen parameter (``trainable_`` turns its gradient on); ``fan``
    is the fan of its He-normal draw (None: it is initialised to zeros),
    which ``draw_`` reads."""
    p = nn.Parameter(x, requires_grad=False)
    p.he_fan = fan
    return p


def _he(gen: Optional[torch.Generator], shape, dtype,
        fan_in: Optional[int] = None, device=None) -> nn.Parameter:
    """He normal over ``fan_in`` (default ``shape[0]``), drawn in fp32 on
    the generator's device and cast; with ``gen=None`` uninitialised on
    ``device`` (structure to load weights into, or to ``draw_``)."""
    fan = fan_in if fan_in is not None else shape[0]
    if gen is None:
        return _param(torch.empty(shape, dtype=dtype, device=device), fan)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) / math.sqrt(fan)
    return _param(x.to(dtype), fan)


def _zeros(shape, dtype, device) -> nn.Parameter:
    return _param(torch.zeros(shape, dtype=dtype, device=device))


def leaf(shape, dtype, device=None, *, std: Optional[float] = None,
         fill: Optional[float] = None) -> nn.Parameter:
    """An uninitialised parameter that ``draw_`` fills with N(0, std²)
    (drawn in fp32 and cast) or with the constant ``fill`` (neither:
    zeros): the reference's embeddings, conv weights, gates and decay
    parameters."""
    p = _param(torch.empty(shape, dtype=dtype, device=device))
    p.init_std, p.init_fill = std, fill
    return p


@torch.no_grad()
def draw_(p: torch.Tensor, gen: torch.Generator) -> None:
    """Fill parameter ``p`` in place with its initial distribution: He
    normal over its ``he_fan`` (drawn in fp32 on the generator's device and
    cast, as ``_he`` draws), N(0, ``init_std``²) or the constant
    ``init_fill`` (``leaf``), zeros without any. A leaf of up to
    ``DRAW_ELEMS`` elements is drawn whole, which gives the values ``_he``
    would; a larger one in slices of its leading axis, so the fp32
    temporary stays one slice (an expert stack of 16.6 GiB in fp32 at
    arctic-480b's width is drawn 7 experts at a time)."""
    fan = getattr(p, "he_fan", None)
    std = getattr(p, "init_std", None)
    if fan is None and std is None:
        p.fill_(getattr(p, "init_fill", None) or 0)
        return
    step = p.shape[0] if p.numel() <= DRAW_ELEMS else max(
        1, DRAW_ELEMS // p[0].numel())
    for i in range(0, p.shape[0], step):
        part = p[i:i + step]
        x = torch.randn(part.shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        part.copy_(x / math.sqrt(fan) if std is None else x * std)


def trainable_(module: nn.Module) -> nn.Module:
    """Turn gradients on for every parameter of ``module``, in place;
    returns it."""
    for p in module.parameters():
        p.requires_grad_(True)
    return module


def remat(fn: Callable, on: bool, *args):
    """``fn(*args)``, under non-reentrant activation checkpointing when
    ``on`` and grad mode is on (the block's activations are recomputed in
    the backward, as the reference's ``jax.checkpoint``). Under an active
    mesh, the parameters of the modules among ``args`` are gathered inside
    ``fn`` (``meshctx.gathered``), so a recomputed block gathers them
    again."""
    if meshctx.active_mesh() is not None:
        fn = functools.partial(meshctx.run_gathered, fn,
                               [a for a in args if isinstance(a, nn.Module)])
    if on and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


class ParamTree(nn.Module):
    """A node of the reference's parameter tree that holds arrays and
    sub-trees together (the MoE block: ``router``, ``wi``, ``wg``, ``wo``
    and arctic's ``dense`` MLP), indexed by name as the dict it ports."""

    def __init__(self, params: Mapping[str, nn.Parameter],
                 children: Optional[Mapping[str, nn.Module]] = None):
        super().__init__()
        for name, p in params.items():
            self.register_parameter(name, p)
        for name, m in (children or {}).items():
            self.add_module(name, m)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.bfloat16,
               device=None) -> nn.ParameterDict:
    """``{"w": (d_in, d_out)[, "b": (d_out,) zeros]}``, drawn from ``gen``
    (``gen=None``: uninitialised on ``device``)."""
    p = nn.ParameterDict({"w": _he(gen, (d_in, d_out), dtype, device=device)})
    if bias:
        p["b"] = _zeros((d_out,), dtype,
                        gen.device if gen is not None else device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.bfloat16,
                 device: Union[str, torch.device] = "cpu") -> nn.ParameterDict:
    # gemma-style (1 + scale)
    return nn.ParameterDict({"scale": _zeros((d,), dtype, device)})


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 over the head_dim axis. x: (..., hd) → (int8
    (..., hd), scale (...,) bf16).

    The scale is the fp32 abs-max over hd, floored at 1e-6, over 127; the
    values are ``round(x / scale)`` (half to even, as ``jnp.round``; a
    division, never a product with the reciprocal) clipped to ±127. The
    scale is rounded to bf16 for storage only, after the division. Both
    divisors are tensors: PyTorch's CUDA division by a Python number
    multiplies by its reciprocal, which can differ in the last bit, so a
    card would not give the CPU's (and the reference's) scales."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1), min=1e-6)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """``q·scale`` in fp32, cast to ``dtype``."""
    return (q.float() * scale[..., None].float()).to(dtype)


def unembed(x: torch.Tensor, embed: torch.Tensor, vocab: int,
            final_softcap: Optional[float] = None) -> torch.Tensor:
    """fp32 logits of x against the tied embedding ``embed.T`` (TF32 off
    by PyTorch's default), the final softcap and the padded-vocab mask
    applied (in place unless the logits carry a graph)."""
    logits = x.float() @ embed.float().T
    if final_softcap is not None:
        if logits.requires_grad:
            logits = torch.tanh(logits / final_softcap) * final_softcap
        else:
            logits.div_(final_softcap).tanh_().mul_(final_softcap)
    return mask_padded_vocab(logits, vocab)


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

    Under an active mesh each rank runs the heads ``meshctx.local_heads``
    gives it and the output's heads are gathered (the rest of this
    docstring holds per rank).

    ``backend="chunked"``, and every CPU tensor, takes the chunked-KV
    online-softmax scan: the KV axis in ``chunk``-sized tiles with a
    running (max, sumexp, out) accumulator, never the S×T logit matrix.
    ``backend="kernel"`` on a CUDA tensor runs K6 (through
    ``FlashAttention`` when grad mode is on and an input requires grad,
    its backward the chunked scan's gradient with this ``chunk``) in two
    cases:

    - causal (a window and a bidirectional ``prefix_len`` allowed): it
      needs ``S == T`` and positions ``arange(S)``. Positions left as
      ``None`` are ``arange`` by contract, which costs no device read;
      given ones are checked with one device-to-host read each.
    - not causal and no finite window, for any S and T: the reference's
      mask then keeps every key of ``k_pos >= 0``, whatever the query
      positions, so ``q_pos`` is not read; a given ``k_pos`` is checked
      to hold no padded key (one device-to-host read).

    Raises:
      NotImplementedError: ``backend="kernel"`` on a CUDA tensor in any
        other case: padded or shifted positions, S != T with a causal
        mask, or a non-causal finite window (the kernel keeps ``q_pos -
        k_pos < window``, this function ``|q_pos - k_pos| < window``;
        ROADMAP R10).
      ValueError: an unknown backend.
    """
    window = int(window)
    if backend not in ATTENTION_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected "
                         f"one of {ATTENTION_BACKENDS}")
    # the reference's constrain(q|k|v, "batch", None, "model", None): under
    # a mesh, this rank's heads (and the kv heads they read)
    q, k, v, join = meshctx.local_heads(q, k, v)
    return join(_attend(q, k, v, q_pos=q_pos, k_pos=k_pos, window=window,
                        causal=causal, prefix_len=prefix_len, cap=cap,
                        chunk=chunk, backend=backend))


def _attend(q, k, v, *, q_pos, k_pos, window: int, causal: bool,
            prefix_len: int, cap: Optional[float], chunk: int, backend: str):
    """``attention`` on the heads it is given."""
    s, t = q.shape[1], k.shape[1]
    if backend == "chunked" or q.device.type == "cpu":
        if q_pos is None:
            q_pos = torch.arange(s, device=q.device)
        if k_pos is None:
            k_pos = torch.arange(t, device=q.device)
        return _attention_chunked(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                  window=window, causal=causal,
                                  prefix_len=prefix_len, cap=cap, chunk=chunk)
    if not causal and window >= NO_WINDOW:
        if k_pos is not None and not bool((k_pos >= 0).all()):
            raise NotImplementedError(
                f"attention on {q.device}: padded keys (k_pos < 0) have no "
                f"kernel path")
        return _kernel_attention(q, k, v, causal=False, window=None, cap=cap,
                                 prefix_len=0, chunk=chunk)
    if not causal or s != t \
            or (q_pos is not None and not _is_arange(q_pos, s)) \
            or (k_pos is not None and not _is_arange(k_pos, t)):
        raise NotImplementedError(
            f"attention on {q.device} runs the flash kernel only for a "
            f"causal prefill (q_pos == k_pos == arange(S)) or a non-causal "
            f"call without a window (causal={causal}, window={window}, "
            f"S={s}, T={t}); padded or shifted keys and a non-causal finite "
            f"window (ROADMAP R10) have no kernel path")
    return _kernel_attention(
        q, k, v, causal=causal, window=None if window >= NO_WINDOW else window,
        cap=cap, prefix_len=prefix_len, chunk=chunk)


def _kernel_attention(q, k, v, *, causal: bool, window: Optional[int],
                      cap: Optional[float], prefix_len: int, chunk: int):
    """K6 at positions ``arange(S)`` / ``arange(T)``: the bare kernel
    without a graph to record, else ``FlashAttention`` with the chunked
    scan's gradient."""
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, k, v))):
        return flash_attention(q, k, v, causal=causal, window=window,
                               cap=cap, prefix_len=prefix_len,
                               backend="kernel")
    dev = q.device
    plain = functools.partial(
        _attention_chunked, q_pos=torch.arange(q.shape[1], device=dev),
        k_pos=torch.arange(k.shape[1], device=dev),
        window=NO_WINDOW if window is None else window, causal=causal,
        prefix_len=prefix_len, cap=cap, chunk=chunk)
    return FlashAttention.apply(q, k, v, plain, causal, window, cap,
                                prefix_len)


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


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, cap: Optional[float] = None):
    """One query's attention over keys ``k``, ``v`` (B, T, Hkv, hd), every
    one of them live, in the partial form a merge needs: (out (B, Hkv, G,
    hd) = Σ exp(x − m)·v in fp32, m (B, Hkv, G) the largest logit x, l =
    Σ exp(x − m)), with m = −inf, l = 0 and out = 0 for T = 0."""
    b, _, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd).float()
    if t == 0:
        return (torch.zeros((b, hkv, g, hd), dtype=torch.float32,
                            device=q.device),
                torch.full((b, hkv, g), -math.inf, dtype=torch.float32,
                           device=q.device),
                torch.zeros((b, hkv, g), dtype=torch.float32,
                            device=q.device))
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k.float())
    logits = logits / math.sqrt(hd)
    if cap is not None:
        logits = softcap(logits, cap)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    return torch.einsum("bhgt,bthd->bhgd", p, v.float()), m, p.sum(dim=-1)


def cache_write(c: torch.Tensor, x: torch.Tensor, start: int,
                shard=None) -> None:
    """Write ``x`` (B, S, ...) at positions [start, start + S) of dim 1 of
    the cache slice ``c`` (B, T, ...), in place. With ``shard`` (a
    ``train.sharding.CacheShard`` of ``c``'s layer) ``c`` is this rank's
    block: only the positions it holds are written, and only its block of
    the later dims (its kv heads)."""
    s = x.shape[1]
    if shard is None:
        c[:, start:start + s] = x
        return
    t0, t1 = shard.ranges[1]
    a, e = max(start, t0), min(start + s, t1)
    if a >= e:
        return
    rest = tuple(slice(lo, hi) for lo, hi in shard.ranges[2:x.dim()])
    c[:, a - t0:e - t0] = x[(slice(None), slice(a - start, e - start))
                            + rest]


def cache_decode_attention(q: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, *, cur_pos: int,
                           window: int = NO_WINDOW,
                           cap: Optional[float] = None, scales=None,
                           shard=None) -> torch.Tensor:
    """One token's attention (q (B, 1, Hq, hd)) over a layer's KV cache
    ``ck``, ``cv`` (B, T, Hkv, hd), as ``decode_attention``; with
    ``scales`` = (k_scale, v_scale) (B, T, Hkv) the cache is int8 and only
    the live keys are dequantized. ``shard`` (the k leaf's
    ``CacheShard`` of this layer) says which block of a cache split under
    the active mesh this rank holds: its kv heads (q's heads that read
    them run here, and the output's heads are gathered over ``"model"``),
    or its positions (its live keys attend in partial form and the ranks
    merge, ``meshctx.lse_merge``); ``scales`` stay whole over heads and
    positions, as ``cache_specs`` splits 4-D leaves over the batch only."""
    pos = int(cur_pos)
    lo = max(0, pos + 1 - int(window))
    if shard is None or not shard.split:
        if scales is None:
            return decode_attention(q, ck, cv, cur_pos=pos, window=window,
                                    cap=cap)
        ks, vs = scales
        kd = dequantize_kv(ck[:, lo:pos + 1], ks[:, lo:pos + 1], q.dtype)
        vd = dequantize_kv(cv[:, lo:pos + 1], vs[:, lo:pos + 1], q.dtype)
        return decode_attention(q, kd, vd, cur_pos=pos - lo, window=window,
                                cap=cap)
    b, _, hq, hd = q.shape
    (t0, t1), (h0, h1) = shard.ranges[1], shard.ranges[2]
    if (h0, h1) != (0, shard.shape[2]):  # this rank's kv heads
        g = hq // shard.shape[2]
        if scales is not None:
            scales = tuple(x[..., h0:h1] for x in scales)
        out = cache_decode_attention(q[:, :, h0 * g:h1 * g], ck, cv,
                                     cur_pos=pos, window=window, cap=cap,
                                     scales=scales)
        return meshctx.whole(out, 2, "model")
    # this rank's positions [t0, t1): its live keys, merged over "model"
    a, e = max(lo, t0), min(pos + 1, t1)
    e = max(a, e)
    if scales is None:
        kl, vl = ck[:, a - t0:e - t0], cv[:, a - t0:e - t0]
    else:
        ks, vs = scales
        kl = dequantize_kv(ck[:, a - t0:e - t0], ks[:, a:e], q.dtype)
        vl = dequantize_kv(cv[:, a - t0:e - t0], vs[:, a:e], q.dtype)
    out = meshctx.lse_merge(*decode_attention_partial(q, kl, vl, cap=cap))
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def cache_cross_attention(q: torch.Tensor, xk: torch.Tensor,
                          xv: torch.Tensor, *, shard=None,
                          backend: str = "kernel") -> torch.Tensor:
    """Non-causal attention of one token's q (B, 1, Hq, hd) over every key
    of a cached ``xk``, ``xv`` (B, T, Hkv, hd) (whisper's decode
    cross-attention): ``attention`` when the cache is whole; on a cache
    split by kv heads (``shard``), this rank's heads through
    ``attention``'s path (K6 on a card) and the heads gathered; split by
    positions, ``cache_decode_attention`` with every key live."""
    if shard is None or not shard.split:
        return attention(q, xk, xv, causal=False, backend=backend)
    (h0, h1), hkv = shard.ranges[2], shard.shape[2]
    if (h0, h1) == (0, hkv):
        return cache_decode_attention(q, xk, xv, cur_pos=shard.shape[1] - 1,
                                      shard=shard)
    g = q.shape[2] // hkv
    out = _attend(q[:, :, h0 * g:h1 * g], xk, xv, q_pos=None, k_pos=None,
                  window=NO_WINDOW, causal=False, prefix_len=0, cap=None,
                  chunk=1024, backend=backend)
    return meshctx.whole(out, 2, "model")


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


def init_moe(gen: Optional[torch.Generator], cfg, dtype=torch.bfloat16,
             device=None) -> ParamTree:
    """The MoE block: ``router`` (d, E) fp32 whatever ``dtype``, the expert
    stacks ``wi`` / ``wg`` (E, d, ff) and ``wo`` (E, ff, d), and with
    ``cfg.dense_residual`` arctic's parallel ``dense`` MLP. The reference's
    fans: ``router``, ``wi`` and ``wg`` over their leading axis (d, E, E),
    ``wo`` over ff."""
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    kw = dict(device=device)
    params = {"router": _he(gen, (d, e), torch.float32, **kw),
              "wi": _he(gen, (e, d, ff), dtype, **kw),
              "wg": _he(gen, (e, d, ff), dtype, **kw),
              "wo": _he(gen, (e, ff, d), dtype, fan_in=ff, **kw)}
    children = {}
    if cfg.dense_residual:
        children["dense"] = init_mlp(gen, d, cfg.dense_residual_ff,
                                     dtype=dtype, device=device)
    return ParamTree(params, children)


def moe_route(p, x: torch.Tensor, cfg) -> Dict[str, object]:
    """The router of ``moe`` for x (B, S, d): each token's top-k experts
    and its rank in each one's queue, grouped per sequence.

    Returns a dict: ``cap`` (int) = max(1, int(S·k/E·cf)); ``probs``
    (B, S, E) fp32 softmax of ``x @ router``; ``gates`` (B, S, k), the top-k
    probabilities renormalised; ``idx`` (B, S, k) their experts; ``flat``
    (B, S·k, E) the one-hot slots, s-major then k-minor; ``pos`` (B, S, k)
    the slot's rank among the earlier slots of its expert (an exclusive
    cumsum over ``flat``); ``keep`` (B, S, k) = pos < cap (a slot past its
    expert's capacity is dropped)."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = max(1, int(s * k / e * cfg.moe_capacity_factor))
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(idx, e).reshape(b, s * k, e)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = (pos * flat).sum(-1).reshape(b, s, k)
    return dict(cap=cap, probs=probs, gates=gates, idx=idx, flat=flat,
                pos=pos, keep=pos < cap)


def moe(p, x: torch.Tensor, cfg):
    """Grouped capacity-based top-k MoE (Mesh-TF/Switch dispatch). x:
    (B, S, d). Returns (out (B, S, d), aux) with aux = E·Σ density·P, the
    Switch load-balance loss.

    Capacity is enforced within each sequence (``moe_route``); the
    dispatch and combine one-hots (B, S, E, C) are in the activation dtype,
    the combine carrying each kept slot's gate. The experts run as three
    ``torch.bmm`` over the expert axis: (E, B·C, d) @ wi / wg (E, d, ff),
    the gated SiLU in fp32, then @ wo (E, ff, d), the weights read where
    they lie (never copied)."""
    b, s, d = x.shape
    e = cfg.num_experts
    r = moe_route(p, x, cfg)
    cap = r["cap"]
    oh_e = F.one_hot(r["idx"], e).float()  # (B, S, k, E)
    oh_c = F.one_hot(torch.where(r["keep"], r["pos"], cap),
                     cap + 1).float()[..., :cap]  # (B, S, k, C)
    disp = torch.einsum("bske,bskc->bsec", oh_e, oh_c).to(x.dtype)
    comb = torch.einsum("bske,bskc,bsk->bsec", oh_e, oh_c,
                        r["gates"]).to(x.dtype)
    # (B, E·C, S) @ (B, S, d): slot (e, c) takes its token's row, or zeros
    ex_in = torch.bmm(disp.reshape(b, s, e * cap).transpose(1, 2), x)
    ex_in = ex_in.view(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    # the reference's constrain(ex_in, "batch", "model", None, None): under
    # a mesh, this rank's experts, whose stacks it holds split
    ex_loc = meshctx.constrain(ex_in, "model", None, None)
    h = torch.bmm(ex_loc, p["wi"])
    gth = torch.bmm(ex_loc, p["wg"])
    h = (F.silu(gth.float()) * h.float()).to(x.dtype)
    del gth
    ex_out = torch.bmm(h, p["wo"])  # (E, B·C, d)
    if ex_loc is not ex_in:
        ex_out = meshctx.whole(ex_out, 0)
    ex_out = ex_out.view(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    out = torch.bmm(comb.reshape(b, s, e * cap), ex_out)
    if "dense" in p:
        out = out + mlp(p["dense"], x)
    # over the whole batch: the means over every data rank's rows
    density = meshctx.batch_mean(r["flat"].float().mean(dim=(0, 1)))
    router_prob = meshctx.batch_mean(r["probs"].mean(dim=(0, 1)))
    aux = e * torch.sum(density * router_prob)
    return out, aux
