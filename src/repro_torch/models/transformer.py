"""Decoder-only transformer covering the dense, MoE and VLM families
(gemma2, qwen1.5, minicpm, arctic, dbrx, paligemma).

The port of ``repro.models.transformer``. ``TransformerLM`` is an
``nn.Module`` holding its weights: ``embed`` (padded vocab × d_model, tied
to the unembedding), a ``ModuleList`` of blocks (one ``ModuleDict`` a
layer, named as the reference's per-layer tree: ``mlp``, or ``moe`` for the
MoE family), ``final_norm`` and, for the VLM, ``vision_proj``. Where the
reference scans over stacked layers with the per-layer window as data,
each block here runs in a Python loop with its window a Python int
(``_layer_windows``: gemma2 alternates local and global layers).

Entry points: ``apply_train`` (the full forward, differentiable, each
block under activation checkpointing with ``cfg.remat``, with the MoE
load-balance aux summed over the layers), ``prefill`` (forward plus
KV-cache emission) and ``decode_step`` (one token against the cache). The
cache is updated in place, which the port may do where the reference
returns a new one, and its ``pos`` is a host int, so a decode loop never
syncs the host. With ``kv_cache_dtype="int8"`` (qwen1.5-32b) the cache
holds int8 k and v with a bf16 scale per (layer, batch, position, kv
head): ``prefill`` quantizes each layer's k and v after its attention,
which reads them unquantized; ``decode_step`` quantizes the new token's
before attending, so the token reads its own k and v back quantized, and
dequantizes only the live slice that ``decode_attention`` reads. PaliGemma
prepends ``vision_proj(patches)`` to the token embeddings as a prefix that
every position attends to (prefix-bidirectional masking). Prefill
attention runs through the flash kernel K6 on a card
(``attn_backend="kernel"``, the prefix included) or through the chunked
plain path (``attn_backend="chunked"``, and always on the CPU).

A ``decode_step`` past the cache's last slot raises ``ValueError``, where
the reference's ``dynamic_update_slice`` clamps the index and overwrites
the last slot (ROADMAP R12); so does a ``prefill`` whose prefix and prompt
exceed ``max_len``.

Under an active mesh (``models.meshctx.activation_mesh``, the weights
sharded by ``train.sharding.shard_model_``) serving is SPMD: ``prefill``
takes the global batch and runs this rank's rows of it
(``sharding.serve_rows``), ``decode_step`` this rank's rows' tokens; each
block's parameters are gathered inside the block and the others around
the step (``meshctx.gathered``), K6 runs on this rank's heads
(``layers.attention``), the MoE on its experts, and ``init_cache``
allocates only this rank's shard of the cache (``sharding.local_cache``:
split over the kv heads where ``"model"`` divides them, else over the
sequence). The logits returned are this rank's rows'.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.graphs.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import meshctx
from repro_torch.models.config import ModelConfig
from repro_torch.train.sharding import layer_shards, new_cache, serve_rows

__all__ = ["TransformerLM"]

_NO_WINDOW = L.NO_WINDOW

#: The families this model serves; the others have models of their own.
FAMILIES = ("dense", "moe", "vlm")
_OTHER_MODELS = {"ssm": "repro_torch.models.ssm.MambaLM",
                 "hybrid": "repro_torch.models.rglru.GriffinLM",
                 "encdec": "repro_torch.models.encdec.WhisperModel"}
KV_CACHE_DTYPES = ("bfloat16", "int8")


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window sizes; _NO_WINDOW = global attention."""
    if cfg.local_global_pattern and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else _NO_WINDOW
                for i in range(cfg.num_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.num_layers
    return [_NO_WINDOW] * cfg.num_layers


class TransformerLM(nn.Module):
    """A decoder-only LM at ``cfg``'s shapes (dense, moe or vlm family).

    Args:
      cfg: a ``ModelConfig`` of the dense, moe or vlm family.
      device: where the weights live; None is the card (``RuntimeError``
        without one), ``"cpu"`` runs the plain paths.
      dtype: the weights' (and activations') dtype; the MoE router stays
        fp32, as in the reference.
      attn_backend: ``"kernel"`` (K6 for prefill attention on a card) or
        ``"chunked"`` (the plain path everywhere).

    The weights are allocated uninitialised; ``init(generator)`` draws them
    in place, or ``load_state_dict`` fills them (``convert.params_from_jax``).

    Raises:
      NotImplementedError: the ssm, hybrid or encdec family, which
        ``MambaLM``, ``GriffinLM`` and ``WhisperModel`` serve.
      ValueError: an unknown family, KV-cache dtype or attention backend.
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_backend: str = "kernel"):
        super().__init__()
        if cfg.family in _OTHER_MODELS:
            raise NotImplementedError(
                f"{cfg.name}: TransformerLM does not serve the {cfg.family!r} "
                f"family; {_OTHER_MODELS[cfg.family]} does (registry."
                f"get_model builds it)")
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"{cfg.name}: kv_cache_dtype="
                             f"{cfg.kv_cache_dtype!r}; expected one of "
                             f"{KV_CACHE_DTYPES}")
        if attn_backend not in L.ATTENTION_BACKENDS:
            raise ValueError(f"unknown attn_backend {attn_backend!r}; expected "
                             f"one of {L.ATTENTION_BACKENDS}")
        self.cfg = cfg
        self.attn_backend = attn_backend
        self.windows = _layer_windows(cfg)
        self.quant = cfg.kv_cache_dtype == "int8"
        dev = resolve_device(device)
        self.embed = nn.Parameter(
            torch.empty((cfg.padded_vocab, cfg.d_model), dtype=dtype,
                        device=dev), requires_grad=False)
        self.blocks = nn.ModuleList(
            [self._new_layer(dtype, dev) for _ in range(cfg.num_layers)])
        self.final_norm = L.rmsnorm_init(cfg.d_model, dtype, dev)
        if cfg.family == "vlm":
            self.vision_proj = L.dense_init(None, cfg.vision_dim, cfg.d_model,
                                            dtype=dtype, device=dev)

    # ------------------------------------------------------------- params

    def _new_layer(self, dtype, device) -> nn.ModuleDict:
        """One layer's weights, uninitialised on ``device``, named as the
        reference's per-layer tree."""
        cfg = self.cfg
        p = nn.ModuleDict({
            "ln1": L.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": L.init_attention_block(None, cfg, dtype, device=device),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device),
        })
        if cfg.family == "moe":
            p["moe"] = L.init_moe(None, cfg, dtype, device=device)
        else:
            p["mlp"] = L.init_mlp(None, cfg.d_model, cfg.d_ff,
                                  gated=(cfg.act == "silu"), dtype=dtype,
                                  device=device)
        if cfg.post_norms:
            p["ln1_post"] = L.rmsnorm_init(cfg.d_model, dtype, device)
            p["ln2_post"] = L.rmsnorm_init(cfg.d_model, dtype, device)
        return p

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Draw every weight from ``generator`` with the reference's
        distributions: embed N(0, 0.02²), the other weights He normal over
        their fans (``L.dense_init``, ``L.init_moe``), biases and norm
        scales zero. The draws run on the generator's device, embed first,
        then each parameter in place in order (``L.draw_``); an expert
        stack is drawn a few experts at a time, so the peak is one
        ``L.DRAW_ELEMS`` slice in fp32 beyond the weights. Returns
        ``self``."""
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator,
                                     device=generator.device,
                                     dtype=torch.float32) * 0.02)
        for name, p in self.named_parameters():
            if name != "embed":
                L.draw_(p, generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ helpers

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed[tokens]
        if cfg.scale_embedding:
            x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
        return x

    def _embed(self, tokens: torch.Tensor,
               patches: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, int]:
        """Token embeddings, with the VLM's projected patches prepended:
        (x (B, P + S, d), prefix length P)."""
        cfg = self.cfg
        x = self._embed_tokens(tokens)
        if cfg.family != "vlm":
            return x, 0
        if patches is None:
            raise ValueError(f"{cfg.name}: the vlm family needs batch["
                             f"'patches'] (B, P, {cfg.vision_dim})")
        vis = L.dense(self.vision_proj, patches.to(x.dtype))
        return torch.cat([vis, x], dim=1), int(patches.shape[1])

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        return L.unembed(x, self.embed, self.cfg.vocab, self.cfg.final_softcap)

    def _write_cache(self, cache: tuple, shards, k: torch.Tensor,
                     v: torch.Tensor, start: int) -> None:
        """Write k and v (B, S, Hkv, hd) at positions [start, start + S) of
        a layer's cache (``_layer_cache``), quantized first for the int8
        cache; ``shards``, the layer's ``CacheShard``s under a mesh, say
        which block of it this rank holds."""
        vals = (*L.quantize_kv(k), *L.quantize_kv(v)) if self.quant \
            else (k, v)
        order = (0, 2, 1, 3) if self.quant else (0, 1)  # k, k_scale, v, ...
        for j, (c, i) in enumerate(zip(cache, order)):
            L.cache_write(c, vals[i], start, shards[j] if shards else None)

    def _layer_fwd(self, p, x: torch.Tensor, window: int, *,
                   q_pos: torch.Tensor, prefix_len: int = 0, cache=None,
                   shards=None, cur_pos: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        """One block. Returns (x, aux, (k, v)): k/v for cache emission.
        With ``cache = (ck, cv)``, or ``(ck, cv, k_scale, v_scale)`` for
        the int8 cache, the new token's k/v are written at ``cur_pos`` in
        place (quantized first) and attention reads the cache; ``shards``
        are the layer's ``CacheShard``s of those leaves under a mesh."""
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
            self._write_cache(cache, shards, k, v, cur_pos)
            # with the int8 cache only the keys decode_attention reads are
            # dequantized: the masked ones weigh exactly 0 in the
            # reference's full-cache softmax
            att = L.cache_decode_attention(
                q, cache[0], cache[1], cur_pos=cur_pos, window=window,
                cap=cfg.logit_softcap, scales=cache[2:] or None,
                shard=shards[0] if shards else None)
        else:
            # q_pos is arange(S) here (prefill, apply_train): left as None,
            # the kernel path needs no device read to know it
            att = L.attention(q, k, v, window=window, cap=cfg.logit_softcap,
                              prefix_len=prefix_len, backend=self.attn_backend)
        att = L.dense(p["attn"]["wo"], att.reshape(b, s, hq * hd))
        if cfg.post_norms:
            att = L.rmsnorm(p["ln1_post"], att, cfg.norm_eps)
        x = x + att * cfg.residual_scale
        h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if cfg.family == "moe":
            f, aux = L.moe(p["moe"], h2, cfg)
        else:
            f = L.mlp(p["mlp"], h2, cfg.act)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.post_norms:
            f = L.rmsnorm(p["ln2_post"], f, cfg.norm_eps)
        x = x + f * cfg.residual_scale
        return x, aux, (k, v)

    # ----------------------------------------------------------- forwards

    def _train_block(self, p, x: torch.Tensor, window: int,
                     q_pos: torch.Tensor, prefix_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, aux, _ = self._layer_fwd(p, x, window, q_pos=q_pos,
                                    prefix_len=prefix_len)
        return x, aux

    def apply_train(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: {tokens (B, S)[, patches (B, P, vision_dim)]} → (logits
        (B, S, padded vocab) fp32, aux): the text positions only, as the
        reference slices off the prefix; aux is the MoE load-balance loss
        summed over the layers (0 for the other families).

        Differentiable: with trainable parameters (``L.trainable_``) and
        grad mode on, each block runs under activation checkpointing when
        ``cfg.remat`` (the reference's ``jax.checkpoint(body)``), and on a
        card its attention through ``FlashAttention``. Without grad it is
        the serving forward."""
        cfg = self.cfg
        x, prefix_len = self._embed(batch["tokens"], batch.get("patches"))
        q_pos = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, w in zip(self.blocks, self.windows):
            x, a = L.remat(self._train_block, cfg.remat, p, x, w, q_pos,
                           prefix_len)
            aux = aux + a
        x = L.rmsnorm(self.final_norm, x[:, prefix_len:], cfg.norm_eps)
        return self._unembed(x), aux

    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
        """Zero (L, B, max_len, Hkv, hd) k and v caches (the weights' dtype
        unless given; int8 with (L, B, max_len, Hkv) bf16 ``k_scale`` and
        ``v_scale`` for ``kv_cache_dtype="int8"``) and ``pos = 0`` (a host
        int). Under an active mesh ``batch`` is the global batch and only
        this rank's shard is allocated (``sharding.new_cache``), with its
        ``"layout"``."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        dtype = self.embed.dtype if dtype is None else dtype

        def build(dev):
            if self.quant:
                return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                        "k_scale": torch.zeros(shape[:-1],
                                               dtype=torch.bfloat16,
                                               device=dev),
                        "v_scale": torch.zeros(shape[:-1],
                                               dtype=torch.bfloat16,
                                               device=dev),
                        "pos": 0}
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev),
                    "pos": 0}
        return new_cache(build, batch, self.device)

    def _names(self) -> Tuple[str, ...]:
        return ("k", "v", "k_scale", "v_scale") if self.quant else ("k", "v")

    def _layer_cache(self, cache: Dict[str, object], i: int) -> tuple:
        return tuple(cache[n][i] for n in self._names())

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, object], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """tokens (B, 1); cache from init_cache/prefill. One new token:
        returns (logits (B, 1, padded vocab) fp32, cache), the cache
        updated in place and its ``pos`` advanced by one. Under an active
        mesh, ``tokens`` and the logits are this rank's rows (those of its
        cache shard).

        Raises:
          ValueError: the cache is full (``pos`` = max_len), where the
            reference would overwrite its last slot (ROADMAP R12); under a
            mesh every rank raises, the slot past the last being none's.
        """
        cfg = self.cfg
        pos = int(cache["pos"])
        shards = layer_shards(cache, self._names())
        max_len = shards[0].shape[1] if shards else cache["k"].shape[2]
        if pos >= max_len:
            raise ValueError(f"decode at position {pos}: the cache holds "
                             f"{max_len} slots (max_len must cover the "
                             f"prefix, the prompt and every decoded token)")
        with meshctx.gathered([self], skip=(nn.ModuleList,)):
            x = self._embed_tokens(tokens)
            q_pos = torch.arange(pos, pos + 1, device=x.device)
            for i, (p, w) in enumerate(zip(self.blocks, self.windows)):
                with meshctx.gathered([p]):
                    x, _, _ = self._layer_fwd(
                        p, x, w, q_pos=q_pos,
                        cache=self._layer_cache(cache, i), shards=shards,
                        cur_pos=pos)
            cache["pos"] = pos + 1
            x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
            return self._unembed(x), cache

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """Full forward over the prompt (after the VLM's prefix), emitting
        the KV cache: returns (logits (B, P + S, padded vocab) fp32, every
        position as in the reference, cache with ``pos = P + S``). Under an
        active mesh ``batch`` is the global batch; the logits are this
        rank's rows and the cache its shard.

        Raises:
          ValueError: P + S > max_len.
        """
        cfg = self.cfg
        rows = batch["tokens"].shape[0]
        mesh = meshctx.active_mesh()
        if mesh is not None:
            batch = serve_rows(batch, mesh)
        with meshctx.gathered([self], skip=(nn.ModuleList,)):
            x, prefix_len = self._embed(batch["tokens"], batch.get("patches"))
            s = x.shape[1]
            if s > max_len:
                raise ValueError(f"prefix and prompt of {s} positions exceed "
                                 f"max_len {max_len}")
            q_pos = torch.arange(s, device=x.device)
            cache = self.init_cache(rows, max_len, dtype=x.dtype)
            shards = layer_shards(cache, self._names())
            for i, (p, w) in enumerate(zip(self.blocks, self.windows)):
                with meshctx.gathered([p]):
                    x, _, (k, v) = self._layer_fwd(p, x, w, q_pos=q_pos,
                                                   prefix_len=prefix_len)
                # per layer: never a stacked unquantized cache
                self._write_cache(self._layer_cache(cache, i), shards, k, v,
                                  0)
                del k, v
            cache["pos"] = s
            x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
            return self._unembed(x), cache
