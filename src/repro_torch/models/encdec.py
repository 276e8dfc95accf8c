"""Whisper-style encoder-decoder [arXiv:2212.04356].

The port of ``repro.models.encdec``. The audio frontend (log-mel and two
convolutions) is a stub, as in the reference: ``batch["frames"]`` holds
frame embeddings (B, encoder_seq, d_model) that go straight into the
encoder. Encoder layers are non-causal self-attention with sinusoidal
positions; decoder layers are causal self-attention, cross-attention into
the encoder memory and a non-gated tanh-GeLU MLP, with learned decoder
positions (``dec_pos``, 65,536 rows) and no rope.

``WhisperModel`` is an ``nn.Module`` holding its weights: ``embed`` (tied to
the unembedding), ``dec_pos``, ``enc_layers`` and ``dec_layers`` (a
``ModuleList`` each, one ``ModuleDict`` a layer, named as the reference's
per-layer trees), ``enc_norm`` and ``final_norm``. On a card every
prefill attention runs through the flash kernel K6
(``attn_backend="kernel"``): the encoder's (S = T = encoder_seq, not
causal), the decoder's causal self-attention and its cross-attention
(S = prompt, T = encoder_seq, not causal); so does a decode step's
one-query cross-attention. The decode step's self-attention is the plain
``decode_attention``. ``attn_backend="chunked"`` (and every CPU tensor)
takes the chunked plain path.

Training: ``apply_train`` is differentiable, each encoder and decoder
layer under activation checkpointing with ``cfg.remat`` (the reference's
``jax.checkpoint(body)`` over each stack), its K6 calls through
``FlashAttention`` on a card.

Serving: ``prefill`` encodes once and computes each layer's cross K/V
once (the standard whisper serving optimization); ``decode_step`` reads
the encoder memory only through them. The cache holds ``k`` / ``v``
(L, B, max_len, kv, hd), ``xk`` / ``xv`` (L, B, encoder_seq, kv, hd) and
``pos``, a host int; ``decode_step`` updates it in place. A decode past the
cache, or past the position table, raises ``ValueError``, where the
reference's ``dynamic_update_slice`` / ``dynamic_slice`` clamp the index
(ROADMAP R12); so does a prompt longer than either.

Under an active mesh serving is SPMD as ``TransformerLM``'s: ``prefill``
takes the global batch and runs this rank's rows, ``decode_step`` this
rank's rows' tokens, the parameters gathered block by block, and the
caches are this rank's shards (``train.sharding.local_cache``): split
over the kv heads where ``"model"`` divides them, else over the sequence
(``layers.cache_decode_attention``, ``layers.cache_cross_attention``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.graphs.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import meshctx
from repro_torch.models.config import ModelConfig
from repro_torch.train.sharding import layer_shards, new_cache, serve_rows

__all__ = ["MAX_DECODE_POS", "WhisperModel", "sinusoid"]

#: Rows of the learned decoder position table.
MAX_DECODE_POS = 65536

# the cache's per-layer leaves, in the order a layer writes them
_CACHE_LEAVES = ("k", "v", "xk", "xv")


def sinusoid(t: int, d: int, device=None) -> torch.Tensor:
    """(t, d) fp32 encoder positions: sin then cos of pos / 10000^(2i/d)."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class WhisperModel(nn.Module):
    """A whisper encoder-decoder at ``cfg``'s shapes (the encdec family).

    Args:
      cfg: a ``ModelConfig`` of the encdec family.
      device: where the weights live; None is the card (``RuntimeError``
        without one), ``"cpu"`` runs the plain paths.
      dtype: the weights' and activations' dtype (frames are cast to it).
      attn_backend: ``"kernel"`` (K6 for the prefill's attention and the
        decode's cross-attention on a card) or ``"chunked"`` (the plain path
        everywhere).

    The weights are allocated uninitialised; ``init(generator)`` draws them
    in place, or ``load_state_dict`` fills them (``convert.params_from_jax``).
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_backend: str = "kernel"):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: WhisperModel serves the encdec "
                             f"family, not {cfg.family!r}")
        if attn_backend not in L.ATTENTION_BACKENDS:
            raise ValueError(f"unknown attn_backend {attn_backend!r}; expected "
                             f"one of {L.ATTENTION_BACKENDS}")
        self.cfg = cfg
        self.attn_backend = attn_backend
        d = cfg.d_model
        dev = resolve_device(device)
        self.embed = L.leaf((cfg.padded_vocab, d), dtype, dev, std=0.02)
        self.dec_pos = L.leaf((MAX_DECODE_POS, d), dtype, dev, std=0.01)
        self.enc_layers = nn.ModuleList(
            [self._new_layer(False, dtype, dev)
             for _ in range(cfg.encoder_layers)])
        self.dec_layers = nn.ModuleList(
            [self._new_layer(True, dtype, dev) for _ in range(cfg.num_layers)])
        self.enc_norm = L.rmsnorm_init(d, dtype, dev)
        self.final_norm = L.rmsnorm_init(d, dtype, dev)

    def _new_layer(self, decoder: bool, dtype, device) -> nn.ModuleDict:
        """One layer's weights, uninitialised, named as the reference's
        ``_init_enc_layer`` / ``_init_dec_layer``."""
        cfg, d = self.cfg, self.cfg.d_model
        p = nn.ModuleDict({
            "ln1": L.rmsnorm_init(d, dtype, device),
            "attn": L.init_attention_block(None, cfg, dtype, device=device)})
        if decoder:
            p["ln_x"] = L.rmsnorm_init(d, dtype, device)
            p["xattn"] = L.init_attention_block(None, cfg, dtype,
                                                device=device)
        p["ln2"] = L.rmsnorm_init(d, dtype, device)
        p["mlp"] = L.init_mlp(None, d, cfg.d_ff, gated=False, dtype=dtype,
                              device=device)
        return p

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "WhisperModel":
        """Draw every weight from ``generator`` with the reference's
        distributions (embed N(0, 0.02²), ``dec_pos`` N(0, 0.01²), the
        projections He normal, norm scales 0), each parameter in place in
        order (``L.draw_``). Returns ``self``."""
        for p in self.parameters():
            L.draw_(p, generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ encoder

    def _qkv(self, p, x: torch.Tensor, names=("wq", "wk", "wv")):
        """The projections ``names`` of x (B, S, d), as (B, S, heads, hd)."""
        cfg = self.cfg
        b, s, _ = x.shape
        heads = {"wq": cfg.num_heads, "wk": cfg.kv_heads, "wv": cfg.kv_heads}
        return [L.dense(p[n], x).reshape(b, s, heads[n], cfg.head_dim)
                for n in names]

    def _out(self, p, att: torch.Tensor) -> torch.Tensor:
        b, s = att.shape[:2]
        return L.dense(p["wo"], att.reshape(b, s, -1))

    def _enc_layer(self, p, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = self._qkv(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps))
        att = L.attention(q, k, v, causal=False, backend=self.attn_backend)
        x = x + self._out(p["attn"], att)
        return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                         "gelu")

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, d_model), the frontend stub's embeddings → the
        encoder memory (B, T, d_model) in the weights' dtype; each layer
        rematerialised with ``cfg.remat`` when grad mode is on."""
        cfg = self.cfg
        frames = frames.to(self.embed.dtype)
        x = frames + sinusoid(frames.shape[1], cfg.d_model,
                              frames.device).to(frames.dtype)[None]
        for p in self.enc_layers:
            x = L.remat(self._enc_layer, cfg.remat, p, x)
        return L.rmsnorm(self.enc_norm, x, cfg.norm_eps)

    # ------------------------------------------------------------ decoder

    def _cross_kv(self, p, memory: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decoder layer's cross-attention k and v (B, T, kv, hd) of
        the encoder memory."""
        return tuple(self._qkv(p["xattn"], memory, ("wk", "wv")))

    def _dec_layer(self, p, x: torch.Tensor, cross: Tuple[torch.Tensor, ...],
                   *, cache=None, cur_pos: Optional[int] = None,
                   shards=None):
        """One decoder layer over x (B, S, d) with ``cross = (xk, xv)``.
        Without ``cache``: causal self-attention over the positions
        ``arange(S)``; returns (x, (k, v)) for cache emission. With
        ``cache = (ck, cv)``, one token: its k and v written at ``cur_pos``
        in place, attention over the cache (``shards``: the layer's
        ``CacheShard``s of k, v and xk under a mesh)."""
        cfg = self.cfg
        q, k, v = self._qkv(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps))
        if cache is None:
            att = L.attention(q, k, v, backend=self.attn_backend)
        else:
            ck, cv = cache
            L.cache_write(ck, k, cur_pos, shards and shards[0])
            L.cache_write(cv, v, cur_pos, shards and shards[1])
            att = L.cache_decode_attention(q, ck, cv, cur_pos=cur_pos,
                                           shard=shards and shards[0])
        x = x + self._out(p["attn"], att)
        h = L.rmsnorm(p["ln_x"], x, cfg.norm_eps)
        qx = self._qkv(p["xattn"], h, ("wq",))[0]
        if cache is None:
            attx = L.attention(qx, *cross, causal=False,
                               backend=self.attn_backend)
        else:
            attx = L.cache_cross_attention(qx, *cross,
                                           shard=shards and shards[2],
                                           backend=self.attn_backend)
        x = x + self._out(p["xattn"], attx)
        x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), "gelu")
        return x, (k, v)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return L.unembed(x, self.embed, self.cfg.vocab)

    def _embed_prompt(self, tokens: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        if s > MAX_DECODE_POS:
            raise ValueError(f"a prompt of {s} tokens exceeds the "
                             f"{MAX_DECODE_POS}-row decoder position table")
        return self.embed[tokens] + self.dec_pos[:s][None]

    def _decode(self, batch: Dict[str, torch.Tensor], cache):
        """Encode, then the decoder over the prompt, returning the logits:
        each layer's k and v go straight into ``cache["k"][i, :, :S]`` (and
        ``v``) and its cross K/V into ``xk`` / ``xv`` (this rank's blocks
        of them under a mesh)."""
        x = self._embed_prompt(batch["tokens"])
        memory = self.encode(batch["frames"])
        shards = layer_shards(cache, _CACHE_LEAVES)
        for i, p in enumerate(self.dec_layers):
            with meshctx.gathered([p]):
                cross = self._cross_kv(p, memory)
                x, (k, v) = self._dec_layer(p, x, cross)
            for j, val in enumerate((k, v) + cross):
                L.cache_write(cache[_CACHE_LEAVES[j]][i], val, 0,
                              shards and shards[j])
            del k, v, cross
        return self._logits(x)

    # ----------------------------------------------------------- forwards

    def _train_dec_layer(self, p, x: torch.Tensor,
                         memory: torch.Tensor) -> torch.Tensor:
        """One decoder layer of the training forward, its cross K/V
        computed inside it (inside the checkpoint), as the reference's
        ``_dec_layer`` does."""
        return self._dec_layer(p, x, self._cross_kv(p, memory))[0]

    def apply_train(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: {frames (B, T, d_model), tokens (B, S)} → (logits
        (B, S, padded vocab) fp32, aux 0). Differentiable; each encoder and
        decoder layer under activation checkpointing with ``cfg.remat``
        when grad mode is on."""
        cfg = self.cfg
        x = self._embed_prompt(batch["tokens"])
        memory = self.encode(batch["frames"])
        for p in self.dec_layers:
            x = L.remat(self._train_dec_layer, cfg.remat, p, x, memory)
        logits = self._logits(x)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
        """Zero self caches ``k`` / ``v`` (L, B, max_len, kv, hd) and cross
        caches ``xk`` / ``xv`` (L, B, encoder_seq, kv, hd) (the weights'
        dtype unless given) and ``pos = 0`` (a host int). Under an active
        mesh ``batch`` is the global batch and only this rank's shard is
        allocated (``sharding.new_cache``)."""
        cfg = self.cfg
        dtype = self.embed.dtype if dtype is None else dtype
        kv = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        xkv = (cfg.num_layers, batch, cfg.encoder_seq, cfg.kv_heads,
               cfg.head_dim)

        def build(dev):
            return {"k": torch.zeros(kv, dtype=dtype, device=dev),
                    "v": torch.zeros(kv, dtype=dtype, device=dev),
                    "xk": torch.zeros(xkv, dtype=dtype, device=dev),
                    "xv": torch.zeros(xkv, dtype=dtype, device=dev),
                    "pos": 0}
        return new_cache(build, batch, self.device)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """Encode, then the teacher-forced decoder over the prompt, emitting
        the caches: returns (logits (B, S, padded vocab) fp32, cache with
        ``pos = S``). Each layer's self k and v are computed once. Under
        an active mesh ``batch`` is the global batch; the logits are this
        rank's rows and the cache its shard.

        Raises:
          ValueError: S > max_len, or the frames are not (B, encoder_seq,
            d_model).
        """
        cfg = self.cfg
        b, s = batch["tokens"].shape
        frames = batch["frames"]
        if tuple(frames.shape) != (b, cfg.encoder_seq, cfg.d_model):
            raise ValueError(f"frames {tuple(frames.shape)}: the cache holds "
                             f"(B, encoder_seq, d_model) = "
                             f"({b}, {cfg.encoder_seq}, {cfg.d_model})")
        if s > max_len:
            raise ValueError(f"a prompt of {s} tokens exceeds max_len "
                             f"{max_len}")
        mesh = meshctx.active_mesh()
        if mesh is not None:
            batch = serve_rows(batch, mesh)
        with meshctx.gathered([self], skip=(nn.ModuleList,)):
            cache = self.init_cache(b, max_len)
            logits = self._decode(batch, cache)
        cache["pos"] = s
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, object], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """tokens (B, 1): one token against the self cache and the cross
        K/V; returns (logits (B, 1, padded vocab) fp32, cache), the cache
        updated in place and its ``pos`` advanced by one. Under an active
        mesh, ``tokens`` and the logits are this rank's rows.

        Raises:
          ValueError: ``pos`` past the cache's last slot or the position
            table, where the reference would clamp it (ROADMAP R12); under
            a mesh on every rank.
        """
        pos = int(cache["pos"])
        shards = layer_shards(cache, _CACHE_LEAVES)
        max_len = shards[0].shape[1] if shards else cache["k"].shape[2]
        if pos >= min(max_len, MAX_DECODE_POS):
            raise ValueError(f"decode at position {pos}: the cache holds "
                             f"{max_len} slots and the position table "
                             f"{MAX_DECODE_POS} rows (max_len must cover the "
                             f"prompt and every decoded token)")
        with meshctx.gathered([self], skip=(nn.ModuleList,)):
            x = self.embed[tokens] + self.dec_pos[pos][None, None]
            for i, p in enumerate(self.dec_layers):
                with meshctx.gathered([p]):
                    x, _ = self._dec_layer(
                        p, x, (cache["xk"][i], cache["xv"][i]),
                        cache=(cache["k"][i], cache["v"][i]), cur_pos=pos,
                        shards=shards)
            cache["pos"] = pos + 1
            return self._logits(x), cache
