"""Mamba-2 (SSD, state-space duality) language model [arXiv:2405.21060].

The port of ``repro.models.ssm``. The reference has no Pallas kernel for
this family, so it ports to torch ops. Within chunks of length Q the dual
quadratic form runs as batched products; across chunks a Python loop over
the S / Q chunks passes the (H, P, N) state, where the reference scans.
Decode is the pure SSM recurrence, O(1) a token. The SSD arithmetic is in
fp32 where the reference's is.

Each block (ngroups = 1, no bias, as the reference):
  u → in_proj → [z | xBC | dt]
  conv1d (width 4) + silu over xBC = [x, B, C]
  y = SSD(x·dt, exp(dt·A), B, C) + D·x
  out = out_proj(rmsnorm(y · silu(z)))

``MambaLM`` is an ``nn.Module`` holding its weights: ``embed`` (tied to the
unembedding), ``layers`` (a ``ModuleList``, one ``ParamTree`` a layer, named
as the reference's per-layer tree; ``A_log``, ``D`` and ``dt_bias`` fp32
whatever the weights' dtype) and ``final_norm``. The cache holds ``ssm``
(L, B, H, P, N) fp32, ``conv`` (L, B, width − 1, conv_dim) and ``pos``, a
host int; ``decode_step`` updates it in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.graphs.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import meshctx
from repro_torch.models.config import ModelConfig
from repro_torch.train.sharding import layer_shards, new_cache, serve_rows

__all__ = ["MambaLM", "causal_conv", "ssd_chunked", "ssd_decode_step"]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays → (..., Q, Q) lower-triangular cumulative
    sums: out[i, j] = sum_{j < t <= i} a[t] (i >= j), -inf above the
    diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    lower = torch.ones(q, q, dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~lower, float("-inf"))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan. x: (b, s, h, p), already multiplied by dt; a: (b, s, h)
    log decays; Bm, Cm: (b, s, n). Returns (y (b, s, h, p), the final state
    (b, h, p, n)).

    A tail chunk is padded with a = 0 and x = 0 (and B = C = 0), so the pads
    never reach a real output or the final state. The reference's
    three-operand einsums are split in two, each product in its order."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    c = (s + pad) // q
    xr = x.reshape(b, c, q, h, p)
    ar = a.reshape(b, c, q, h)
    Br = Bm.reshape(b, c, q, n)
    Cr = Cm.reshape(b, c, q, n)

    a_cs = torch.cumsum(ar, dim=2)  # (b, c, q, h)
    # intra-chunk: the dual quadratic form
    lmat = torch.exp(_segsum(ar.permute(0, 1, 3, 2)))  # (b, c, h, q, q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)  # (b, c, q, q)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores[:, :, None] * lmat, xr)
    del lmat
    # each chunk's end state
    decay_states = torch.exp(a_cs[:, :, -1:, :] - a_cs)  # (b, c, q, h)
    states = torch.einsum("bcqn,bcqhp->bchpn", Br, decay_states[..., None] * xr)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])  # (b, c, h)
    # across chunks: the state entering chunk ci, then the next one
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    entering = []
    for ci in range(c):
        entering.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_prev = torch.stack(entering, dim=1)  # (b, c, h, p, n)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cr, h_prev) \
        * torch.exp(a_cs)[..., None]
    y = (y_diag + y_off).reshape(b, s + pad, h, p)[:, :s]
    return y, state


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor, a_t: torch.Tensor,
                    B_t: torch.Tensor, C_t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step. state: (b, h, p, n); x_t: (b, h, p) (already
    × dt); a_t: (b, h) log decay; B_t, C_t: (b, n). Returns (the new state,
    y (b, h, p))."""
    dec = torch.exp(a_t)[..., None, None]
    state = state * dec + x_t[..., None] * B_t[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, C_t)
    return state, y


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-channel causal conv. x: (b, s, ch); w: (width, ch). Without a
    cache: returns (y (b, s, ch), the last width − 1 inputs, zero-padded
    on the left: a view of the padded input). With ``cache`` (b, width − 1,
    ch), the single-step path (s = 1): returns (y (b, 1, ch), the new
    cache). The reference's ``_causal_conv``, products and sums in x's
    dtype in its order."""
    width = w.shape[0]
    if cache is not None:
        window = torch.cat([cache, x], dim=1)  # (b, width, ch)
        y = (window * w[None]).sum(dim=1, keepdim=True)
        return y, window[:, 1:]
    pad = F.pad(x, (0, 0, width - 1, 0))
    y = sum(pad[:, i:i + x.shape[1]] * w[i][None, None] for i in range(width))
    return y, pad[:, -(width - 1):] if width > 1 else None


class MambaLM(nn.Module):
    """A Mamba-2 LM at ``cfg``'s shapes (the ssm family).

    Args:
      cfg: a ``ModelConfig`` of the ssm family.
      device: where the weights live; None is the card (``RuntimeError``
        without one), ``"cpu"`` the CPU.
      dtype: the weights' and activations' dtype (``A_log``, ``D`` and
        ``dt_bias`` stay fp32, as in the reference).

    The weights are allocated uninitialised; ``init(generator)`` draws them
    in place, or ``load_state_dict`` fills them (``convert.params_from_jax``).
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: MambaLM serves the ssm family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        d = cfg.d_model
        self.d_in = cfg.expand * d
        self.h = cfg.ssm_heads or (self.d_in // (cfg.ssm_head_dim or 64))
        self.p = self.d_in // self.h
        self.n = cfg.ssm_state
        self.conv_dim = self.d_in + 2 * self.n
        dev = resolve_device(device)
        self.embed = L.leaf((cfg.padded_vocab, d), dtype, dev, std=0.02)
        self.layers = nn.ModuleList(
            [self._new_layer(dtype, dev) for _ in range(cfg.num_layers)])
        self.final_norm = L.rmsnorm_init(d, dtype, dev)

    def _new_layer(self, dtype, device) -> L.ParamTree:
        """One layer's weights, uninitialised, named as the reference's
        ``_init_layer``."""
        cfg, d, h = self.cfg, self.cfg.d_model, self.h
        f32 = torch.float32
        return L.ParamTree(
            {"conv_w": L.leaf((cfg.conv_width, self.conv_dim), dtype, device,
                              std=0.1),
             "A_log": L.leaf((h,), f32, device),
             "D": L.leaf((h,), f32, device, fill=1.0),
             "dt_bias": L.leaf((h,), f32, device)},
            {"ln": L.rmsnorm_init(d, dtype, device),
             "in_proj": L.dense_init(None, d, 2 * self.d_in + 2 * self.n + h,
                                     dtype=dtype, device=device),
             "gate_ln": L.rmsnorm_init(self.d_in, dtype, device),
             "out_proj": L.dense_init(None, self.d_in, d, dtype=dtype,
                                      device=device)})

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MambaLM":
        """Draw every weight from ``generator`` with the reference's
        distributions (embed N(0, 0.02²), the projections He normal,
        ``conv_w`` N(0, 0.1²), ``A_log`` and ``dt_bias`` 0, ``D`` 1, norm
        scales 0), each parameter in place in order (``L.draw_``). Returns
        ``self``."""
        for p in self.parameters():
            L.draw_(p, generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- blocks

    def _layer_fwd(self, p, x: torch.Tensor, *, cache=None, shard=None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One block. Without ``cache``: the chunked SSD over the sequence,
        returning (x, (final state, conv tail)). With ``cache = (ssm
        (b, h, p, n), conv (b, width − 1, conv_dim))``, one token: the
        recurrence, the cache written in place; returns (x, cache). Under a
        mesh ``shard`` (the state's layer ``CacheShard``) says which block
        of the head dim p this rank's state holds (``cache_specs`` splits
        the 5-D state's dim 3 over ``"model"``): the recurrence runs on that
        block, each p being independent, and y is gathered over
        ``"model"``."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, n = self.d_in, self.n
        h_in = L.rmsnorm(p["ln"], x, cfg.norm_eps)
        zxbcdt = L.dense(p["in_proj"], h_in)
        # [z | xBC | dt]
        z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], \
            zxbcdt[..., 2 * di + 2 * n:]
        if cache is None:
            xbc, conv_tail = causal_conv(xbc, p["conv_w"])
        else:
            ssm_state, conv_state = cache
            xbc, conv_tail = causal_conv(xbc, p["conv_w"], conv_state)
        xbc = F.silu(xbc.float()).to(x.dtype)
        xc = xbc[..., :di].reshape(b, s, self.h, self.p)
        Bm = xbc[..., di:di + n].float()
        Cm = xbc[..., di + n:].float()
        dt = F.softplus(dt.float() + p["dt_bias"])  # (b, s, h)
        A = -torch.exp(p["A_log"])  # (h,)
        xdt = xc.float() * dt[..., None]
        a = dt * A  # log decay
        if cache is None:
            y, state = ssd_chunked(xdt, a, Bm, Cm, cfg.ssm_chunk)
        else:
            p0, p1 = shard.ranges[2] if shard is not None else (0, self.p)
            state, y = ssd_decode_step(ssm_state, xdt[:, 0, :, p0:p1],
                                       a[:, 0], Bm[:, 0], Cm[:, 0])
            if (p0, p1) != (0, self.p):
                y = meshctx.whole(y, 2)
            y = y[:, None]
            ssm_state.copy_(state)
            conv_state.copy_(conv_tail)
            state, conv_tail = ssm_state, conv_state
        y = y + xc.float() * p["D"][None, None, :, None]
        y = y.reshape(b, s, di) * F.silu(z.float())
        y = L.rmsnorm(p["gate_ln"], y.to(x.dtype), cfg.norm_eps)
        return x + L.dense(p["out_proj"], y), (state, conv_tail)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return L.unembed(x, self.embed, self.cfg.vocab)

    # ----------------------------------------------------------- forwards

    def _train_layer(self, p, x: torch.Tensor) -> torch.Tensor:
        return self._layer_fwd(p, x)[0]

    def apply_train(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: {tokens (B, S)} → (logits (B, S, padded vocab) fp32, aux
        0). Differentiable (the chunked SSD is torch ops); each layer under
        activation checkpointing with ``cfg.remat`` when grad mode is on."""
        x = self.embed[batch["tokens"]]
        for p in self.layers:
            x = L.remat(self._train_layer, self.cfg.remat, p, x)
        return self._logits(x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
        """Zero ``ssm`` (L, B, H, P, N) fp32 and ``conv`` (L, B, width − 1,
        conv_dim) states (the weights' dtype unless given) and ``pos = 0``
        (a host int). ``max_len`` is not used (the state does not grow), as
        in the reference. Under an active mesh ``batch`` is the global
        batch and only this rank's shard is allocated
        (``sharding.new_cache``: its rows, and its block of the state's
        head dim p where ``"model"`` divides it, as ``cache_specs`` splits
        a 5-D leaf)."""
        cfg = self.cfg
        dtype = self.embed.dtype if dtype is None else dtype

        def build(dev):
            return {
                "ssm": torch.zeros((cfg.num_layers, batch, self.h, self.p,
                                    self.n), dtype=torch.float32, device=dev),
                "conv": torch.zeros((cfg.num_layers, batch,
                                     cfg.conv_width - 1, self.conv_dim),
                                    dtype=dtype, device=dev),
                "pos": 0,
            }
        return new_cache(build, batch, self.device)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """The chunked-SSD forward over the prompt, emitting each layer's
        final state and conv tail: returns (logits (B, S, padded vocab)
        fp32, cache with ``pos = S``). ``max_len`` is not used. Under an
        active mesh ``batch`` is the global batch; the logits and the cache
        are this rank's rows."""
        rows = batch["tokens"].shape[0]
        mesh = meshctx.active_mesh()
        if mesh is not None:
            batch = serve_rows(batch, mesh)
        with meshctx.gathered([self], skip=(nn.ModuleList,)):
            x = self.embed[batch["tokens"]]
            cache = self.init_cache(rows, max_len, dtype=x.dtype)
            shards = layer_shards(cache, ("ssm", "conv"))
            for i, p in enumerate(self.layers):
                with meshctx.gathered([p]):
                    x, (state, conv_tail) = self._layer_fwd(p, x)
                for j, (name, val) in enumerate((("ssm", state),
                                                 ("conv", conv_tail))):
                    L.cache_write(cache[name][i], val, 0,
                                  shards and shards[j])
            cache["pos"] = x.shape[1]
            return self._logits(x), cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, object], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """tokens (B, 1): one token through the recurrence; returns (logits
        (B, 1, padded vocab) fp32, cache), the cache updated in place and
        its ``pos`` advanced by one. Under an active mesh, ``tokens`` and
        the logits are this rank's rows."""
        shards = layer_shards(cache, ("ssm",))
        with meshctx.gathered([self], skip=(nn.ModuleList,)):
            x = self.embed[tokens]
            for i, p in enumerate(self.layers):
                with meshctx.gathered([p]):
                    x, _ = self._layer_fwd(p, x, cache=(cache["ssm"][i],
                                                        cache["conv"][i]),
                                           shard=shards and shards[0])
            cache["pos"] = int(cache["pos"]) + 1
            return self._logits(x), cache
