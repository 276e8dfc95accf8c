"""Decoder-only transformer for the dense family (gemma2, qwen1.5, minicpm).

The port of ``repro.models.transformer``. ``TransformerLM`` is an
``nn.Module`` holding its weights: ``embed`` (padded vocab × d_model, tied
to the unembedding), a ``ModuleList`` of blocks (one ``ModuleDict`` a
layer, named as the reference's per-layer tree) and ``final_norm``. Where
the reference scans over stacked layers with the per-layer window as data,
each block here runs in a Python loop with its window a Python int
(``_layer_windows``: gemma2 alternates local and global layers).

Entry points: ``apply_train`` (the full causal forward, a forward only),
``prefill`` (forward plus KV-cache emission) and ``decode_step`` (one token
against the cache). The cache is updated in place, which the port may do
where the reference returns a new one, and its ``pos`` is a host int, so a
decode loop never syncs the host. Prefill attention runs through the flash
kernel K6 on a card (``attn_backend="kernel"``) or through the chunked
plain path (``attn_backend="chunked"``, and always on the CPU).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.graphs.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

__all__ = ["TransformerLM"]

_NO_WINDOW = L.NO_WINDOW


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window sizes; _NO_WINDOW = global attention."""
    if cfg.local_global_pattern and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else _NO_WINDOW
                for i in range(cfg.num_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.num_layers
    return [_NO_WINDOW] * cfg.num_layers


class TransformerLM(nn.Module):
    """A dense decoder-only LM at ``cfg``'s shapes.

    Args:
      cfg: a dense-family ``ModelConfig``.
      device: where the weights live; None is the card (``RuntimeError``
        without one), ``"cpu"`` runs the plain paths.
      dtype: the weights' (and activations') dtype.
      attn_backend: ``"kernel"`` (K6 for prefill attention on a card) or
        ``"chunked"`` (the plain path everywhere).

    The weights are allocated uninitialised; ``init(generator)`` draws them,
    or ``load_state_dict`` fills them (``convert.params_from_jax``).
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_backend: str = "kernel"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                f"(ROADMAP Queue 1, item 15)")
        if cfg.kv_cache_dtype != "bfloat16":
            raise NotImplementedError(
                f"{cfg.name}: kv_cache_dtype={cfg.kv_cache_dtype!r}; the int8 "
                f"KV cache is not ported yet (ROADMAP Queue 1, item 15)")
        if attn_backend not in L.ATTENTION_BACKENDS:
            raise ValueError(f"unknown attn_backend {attn_backend!r}; expected "
                             f"one of {L.ATTENTION_BACKENDS}")
        self.cfg = cfg
        self.attn_backend = attn_backend
        self.windows = _layer_windows(cfg)
        dev = resolve_device(device)
        self.embed = nn.Parameter(
            torch.empty((cfg.padded_vocab, cfg.d_model), dtype=dtype,
                        device=dev), requires_grad=False)
        self.blocks = nn.ModuleList(
            [self._new_layer(None, dtype, dev) for _ in range(cfg.num_layers)])
        self.final_norm = L.rmsnorm_init(cfg.d_model, dtype, dev)

    # ------------------------------------------------------------- params

    def _new_layer(self, gen: Optional[torch.Generator], dtype,
                   device) -> nn.ModuleDict:
        """One layer's weights, drawn from ``gen`` in the reference's order
        (``gen=None``: uninitialised on ``device``)."""
        cfg = self.cfg
        dev = gen.device if gen is not None else device
        p = nn.ModuleDict({
            "ln1": L.rmsnorm_init(cfg.d_model, dtype, dev),
            "attn": L.init_attention_block(gen, cfg, dtype, device=dev),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, dev),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                              gated=(cfg.act == "silu"), dtype=dtype,
                              device=dev),
        })
        if cfg.post_norms:
            p["ln1_post"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
            p["ln2_post"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
        return p

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Draw every weight from ``generator`` with the reference's
        distributions: embed N(0, 0.02²), dense weights He normal over
        d_in (``L.dense_init``), biases and norm scales zero. The draws run
        on the generator's device, embed first, then layer by layer; each
        layer is drawn whole and copied in, so the peak is one extra layer.
        Returns ``self``."""
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator,
                                     device=generator.device,
                                     dtype=torch.float32) * 0.02)
        for block in self.blocks:
            new = self._new_layer(generator, self.embed.dtype, None)
            for (name, p), (name2, q) in zip(block.named_parameters(),
                                             new.named_parameters()):
                assert name == name2, (name, name2)
                p.copy_(q)
            del new
        self.final_norm["scale"].zero_()
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ helpers

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed[tokens]
        if cfg.scale_embedding:
            x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
        return x

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits against ``embed.T``; the final softcap and the
        padded-vocab mask are applied in place."""
        cfg = self.cfg
        logits = x.float() @ self.embed.float().T
        if cfg.final_softcap is not None:
            logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
        return L.mask_padded_vocab(logits, cfg.vocab)

    def _layer_fwd(self, p, x: torch.Tensor, window: int, *,
                   q_pos: torch.Tensor, cache=None, cur_pos: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        """One block. Returns (x, aux, (k, v)): k/v for cache emission. With
        ``cache = (ck, cv)`` the new token's k/v are written at ``cur_pos``
        in place and attention reads the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.kv_heads
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        q = L.dense(p["attn"]["wq"], h).reshape(b, s, hq, hd)
        k = L.dense(p["attn"]["wk"], h).reshape(b, s, hkv, hd)
        v = L.dense(p["attn"]["wv"], h).reshape(b, s, hkv, hd)
        q = L.rope(q, q_pos[None, :], cfg.rope_theta)
        k = L.rope(k, q_pos[None, :], cfg.rope_theta)
        if cache is not None:
            ck, cv = cache
            ck[:, cur_pos:cur_pos + s] = k
            cv[:, cur_pos:cur_pos + s] = v
            att = L.decode_attention(q, ck, cv, cur_pos=cur_pos, window=window,
                                     cap=cfg.logit_softcap)
        else:
            # q_pos is arange(S) here (prefill, apply_train): left as None,
            # the kernel path needs no device read to know it
            att = L.attention(q, k, v, window=window, cap=cfg.logit_softcap,
                              backend=self.attn_backend)
        att = L.dense(p["attn"]["wo"], att.reshape(b, s, hq * hd))
        if cfg.post_norms:
            att = L.rmsnorm(p["ln1_post"], att, cfg.norm_eps)
        x = x + att * cfg.residual_scale
        h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        f = L.mlp(p["mlp"], h2, cfg.act)
        if cfg.post_norms:
            f = L.rmsnorm(p["ln2_post"], f, cfg.norm_eps)
        x = x + f * cfg.residual_scale
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux, (k, v)

    # ----------------------------------------------------------- forwards

    @torch.no_grad()
    def apply_train(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: {tokens (B, S)} → (logits (B, S, padded vocab) fp32, aux).
        A forward only: there is no backward and no remat."""
        cfg = self.cfg
        x = self._embed(batch["tokens"])
        q_pos = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, w in zip(self.blocks, self.windows):
            x, a, _ = self._layer_fwd(p, x, w, q_pos=q_pos)
            aux = aux + a
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        return self._unembed(x), aux

    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
        """Zero (L, B, max_len, Hkv, hd) k and v caches (the weights' dtype
        unless given) and ``pos = 0`` (a host int)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        dtype = self.embed.dtype if dtype is None else dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "pos": 0}

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, object], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """tokens (B, 1); cache from init_cache/prefill. One new token:
        returns (logits (B, 1, padded vocab) fp32, cache), the cache
        updated in place and its ``pos`` advanced by one."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = self._embed(tokens)
        q_pos = torch.arange(pos, pos + 1, device=x.device)
        for i, (p, w) in enumerate(zip(self.blocks, self.windows)):
            x, _, _ = self._layer_fwd(p, x, w, q_pos=q_pos,
                                      cache=(cache["k"][i], cache["v"][i]),
                                      cur_pos=pos)
        cache["pos"] = pos + 1
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        return self._unembed(x), cache

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """Full forward over the prompt, emitting the KV cache: returns
        (logits (B, S, padded vocab) fp32, cache with ``pos = S``)."""
        cfg = self.cfg
        x = self._embed(batch["tokens"])
        b, s, _ = x.shape
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
        q_pos = torch.arange(s, device=x.device)
        cache = self.init_cache(b, max_len, dtype=x.dtype)
        for i, (p, w) in enumerate(zip(self.blocks, self.windows)):
            x, _, (k, v) = self._layer_fwd(p, x, w, q_pos=q_pos)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        cache["pos"] = s
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        return self._unembed(x), cache
