"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
attention in the repeating pattern (rec, rec, attn) [arXiv:2402.19427].

The port of ``repro.models.rglru``. ``GriffinLM`` is an ``nn.Module``
holding its weights: ``embed`` (tied to the unembedding), ``blocks`` (one
flat ``ModuleList`` in the reference's ``_layer_list`` order: group gi's
block j is block ``len(pattern)·gi + j``, then the remainder ``rem{j}``),
and ``final_norm``. A recurrent block is a ``ParamTree`` (its RG-LRU gates
and ``lam`` fp32 whatever the weights' dtype), an attention block a
``ModuleDict``, each named as the reference's.

The RG-LRU recurrence h_t = a_t·h_{t−1} + sqrt(1 − a_t²)·(i_t ⊙ x_t) runs as
a log-depth doubling scan in fp32 torch ops over the prompt (the
reference's ``lax.associative_scan``, with its combine) and as a one-step
update in decode. Prefill's local attention is causal with the config's
window through the flash kernel K6 on a card (``attn_backend="kernel"``),
or the chunked plain path (``"chunked"``, and always on the CPU). Decode
reads a ring buffer of W = min(window, max_len) slots with a position a
slot (−1 empty), ``ring_decode_attention``, plain torch as in the
reference. With W < window (max_len below the window) a decode that would
overwrite a key inside its window raises ``ValueError`` (ROADMAP R13).

The cache holds ``blocks``, one tuple a block (recurrent: the RG-LRU state
(B, w) fp32 and the conv tail (B, width − 1, w); attention: k and v rings
(B, W, kv, hd) and their slot positions (W,) int32), and ``pos``, a host
int; ``decode_step`` updates it in place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.graphs.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import meshctx
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import causal_conv
from repro_torch.train.sharding import new_cache, serve_rows

__all__ = ["GriffinLM", "block_kinds", "ring_decode_attention", "rglru_scan",
           "rglru_step"]

_C = 8.0  # RG-LRU recurrence sharpness constant


def _gates(r: torch.Tensor, i: torch.Tensor, x: torch.Tensor,
           lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decay a = exp(−C·softplus(lam)·r) and the gated input
    sqrt(max(1 − a², 1e-9))·(i·x)."""
    a = torch.exp(-_C * F.softplus(lam) * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * x)


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor) -> torch.Tensor:
    """x, r, i: (b, s, w); lam: (w,). Every step's state h (b, s, w) from
    h_0 = 0, by a doubling scan over s in ⌈log2 s⌉ rounds with the
    reference's combine ``(a1·a2, a2·b1 + b2)`` (earlier element first)."""
    a, h = _gates(r, i, x, lam[None, None, :])
    s, shift = x.shape[1], 1
    while shift < s:
        h = torch.cat([h[:, :shift], a[:, shift:] * h[:, :-shift]
                       + h[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return h


def rglru_step(hprev: torch.Tensor, x_t: torch.Tensor, r_t: torch.Tensor,
               i_t: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """One step. hprev, x_t, r_t, i_t: (b, w)."""
    a, gated = _gates(r_t, i_t, x_t, lam[None, :])
    return a * hprev + gated


def ring_decode_attention(q: torch.Tensor, k_ring: torch.Tensor,
                          v_ring: torch.Tensor, kpos: torch.Tensor, *,
                          cur_pos: int, window: int) -> torch.Tensor:
    """One query against a ring buffer of keys (plain torch, logits in
    fp32, no softcap). q: (B, 1, Hq, hd); k_ring, v_ring: (B, W, Hkv, hd);
    kpos: (W,) int32, each slot's position (−1: empty). A slot is valid
    where ``kpos >= 0``, ``kpos > cur_pos − window`` and ``kpos <=
    cur_pos``; the mask is computed on the device from the host int
    ``cur_pos``, so no step syncs the host."""
    b, _, hq, hd = q.shape
    hkv = k_ring.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k_ring.float()) / math.sqrt(hd)
    valid = (kpos >= 0) & (kpos > cur_pos - window) & (kpos <= cur_pos)
    logits = logits.masked_fill(~valid, -1e30)
    p = torch.softmax(logits, dim=-1)
    att = torch.einsum("bhgt,bthd->bhgd", p, v_ring.float())
    return att.reshape(b, 1, hq, hd).to(q.dtype)


def block_kinds(cfg: ModelConfig) -> List[str]:
    """Each block's kind ("rec" or "attn") in layer order: the pattern
    (default (rec, rec, attn)) repeated num_layers // len(pattern) times,
    then the remainder's first kinds (the reference's ``_layer_list``)."""
    pat = list(cfg.block_pattern or ("rec", "rec", "attn"))
    groups = cfg.num_layers // len(pat)
    return pat * groups + pat[:cfg.num_layers - groups * len(pat)]


class GriffinLM(nn.Module):
    """A Griffin hybrid LM at ``cfg``'s shapes (the hybrid family).

    Args:
      cfg: a ``ModelConfig`` of the hybrid family.
      device: where the weights live; None is the card (``RuntimeError``
        without one), ``"cpu"`` runs the plain paths.
      dtype: the weights' and activations' dtype (the RG-LRU gates and
        ``lam`` stay fp32, as in the reference).
      attn_backend: ``"kernel"`` (K6 for prefill's local attention on a
        card) or ``"chunked"`` (the plain path everywhere).

    The weights are allocated uninitialised; ``init(generator)`` draws them
    in place, or ``load_state_dict`` fills them (``convert.params_from_jax``).
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_backend: str = "kernel"):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: GriffinLM serves the hybrid family, "
                             f"not {cfg.family!r}")
        if attn_backend not in L.ATTENTION_BACKENDS:
            raise ValueError(f"unknown attn_backend {attn_backend!r}; expected "
                             f"one of {L.ATTENTION_BACKENDS}")
        self.cfg = cfg
        self.attn_backend = attn_backend
        self.w = cfg.lru_width or cfg.d_model
        #: each block's kind, in ``blocks`` order
        self.kinds = block_kinds(cfg)
        self.window = cfg.sliding_window or L.NO_WINDOW
        dev = resolve_device(device)
        self.embed = L.leaf((cfg.padded_vocab, cfg.d_model), dtype, dev,
                            std=0.02)
        self.blocks = nn.ModuleList(
            [self._new_block(kind, dtype, dev) for kind in self.kinds])
        self.final_norm = L.rmsnorm_init(cfg.d_model, dtype, dev)

    # ------------------------------------------------------------- params

    def _new_block(self, kind: str, dtype, device) -> nn.Module:
        """One block's weights, uninitialised, named as the reference's
        ``_init_rec_block`` / ``_init_attn_block`` with its ``mlp``."""
        cfg, d, w = self.cfg, self.cfg.d_model, self.w
        kw = dict(dtype=dtype, device=device)
        mlp = L.init_mlp(None, d, cfg.d_ff, **kw)
        if kind == "attn":
            return nn.ModuleDict({
                "ln": L.rmsnorm_init(d, dtype, device),
                "attn": L.init_attention_block(None, cfg, **kw),
                "ln2": L.rmsnorm_init(d, dtype, device),
                "mlp": mlp})
        f32 = torch.float32
        return L.ParamTree(
            {"conv_w": L.leaf((cfg.conv_width, w), dtype, device, std=0.1),
             "gate_r_w": L.leaf((w,), f32, device, std=0.1),
             "gate_r_b": L.leaf((w,), f32, device),
             "gate_i_w": L.leaf((w,), f32, device, std=0.1),
             "gate_i_b": L.leaf((w,), f32, device),
             "lam": L.leaf((w,), f32, device, fill=1.0)},
            {"ln": L.rmsnorm_init(d, dtype, device),
             "in_x": L.dense_init(None, d, w, **kw),
             "in_gate": L.dense_init(None, d, w, **kw),
             "out": L.dense_init(None, w, d, **kw),
             "ln2": L.rmsnorm_init(d, dtype, device),
             "mlp": mlp})

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "GriffinLM":
        """Draw every weight from ``generator`` with the reference's
        distributions (embed N(0, 0.02²), the projections He normal,
        ``conv_w`` and the gate weights N(0, 0.1²), gate biases 0, ``lam``
        1, norm scales 0), each parameter in place in order (``L.draw_``;
        the embedding in slices). Returns ``self``."""
        for p in self.parameters():
            L.draw_(p, generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- blocks

    def _rec_fwd(self, p, x: torch.Tensor, *, cache=None):
        """A recurrent block. Without ``cache``: returns (x, (the last
        state (b, w), the conv tail)). With ``cache = (h (b, w), conv
        (b, width − 1, w))``, one token, the cache written in place."""
        cfg = self.cfg
        h_in = L.rmsnorm(p["ln"], x, cfg.norm_eps)
        xb = L.dense(p["in_x"], h_in)
        gb = F.gelu(L.dense(p["in_gate"], h_in).float(), approximate="tanh")
        if cache is None:
            xb, conv_tail = causal_conv(xb, p["conv_w"])
        else:
            h_state, conv_state = cache
            xb, conv_tail = causal_conv(xb, p["conv_w"], conv_state)
        xf = xb.float()
        r = torch.sigmoid(xf * p["gate_r_w"] + p["gate_r_b"])
        i = torch.sigmoid(xf * p["gate_i_w"] + p["gate_i_b"])
        if cache is None:
            h = rglru_scan(xf, r, i, p["lam"])
            # copies: views would keep the whole (B, S, w) scan and conv
            # input alive as long as the cache
            new = (h[:, -1].clone(), conv_tail.to(x.dtype, copy=True))
        else:
            h = rglru_step(h_state, xf[:, 0], r[:, 0], i[:, 0], p["lam"])
            h_state.copy_(h)
            conv_state.copy_(conv_tail)
            h, new = h[:, None], cache
        y = (h * gb).to(x.dtype)
        x = x + L.dense(p["out"], y)
        x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
        return x, new

    def _attn_fwd(self, p, x: torch.Tensor, q_pos: torch.Tensor, *,
                  ring: Optional[int] = None, cache=None,
                  cur_pos: Optional[int] = None):
        """A local-attention block. Without ``cache``: the prefill over
        positions ``q_pos = arange(S)``; with ``ring = W``, also returns
        the ring buffer of the last W positions (slot ``pos % W``). With
        ``cache = (k_ring, v_ring, kpos)``, one token at ``cur_pos``,
        written at slot ``cur_pos % W`` in place."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.kv_heads
        h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
        q = L.dense(p["attn"]["wq"], h).reshape(b, s, hq, hd)
        k = L.dense(p["attn"]["wk"], h).reshape(b, s, hkv, hd)
        v = L.dense(p["attn"]["wv"], h).reshape(b, s, hkv, hd)
        q = L.rope(q, q_pos[None, :], cfg.rope_theta)
        k = L.rope(k, q_pos[None, :], cfg.rope_theta)
        new = None
        if cache is None:
            # q_pos is arange(S): left as None, the kernel path needs no
            # device read to know it
            att = L.attention(q, k, v, window=self.window,
                              backend=self.attn_backend)
            if ring is not None:
                ps = torch.arange(max(s - ring, 0), s, device=x.device)
                ck = torch.zeros((b, ring, hkv, hd), dtype=x.dtype,
                                 device=x.device)
                cv = torch.zeros_like(ck)
                kpos = torch.full((ring,), -1, dtype=torch.int32,
                                  device=x.device)
                ck[:, ps % ring] = k[:, ps]
                cv[:, ps % ring] = v[:, ps]
                kpos[ps % ring] = ps.to(torch.int32)
                new = (ck, cv, kpos)
        else:
            ck, cv, kpos = cache
            slot = cur_pos % ck.shape[1]
            ck[:, slot] = k[:, 0]
            cv[:, slot] = v[:, 0]
            kpos[slot] = cur_pos
            att = ring_decode_attention(q, ck, cv, kpos, cur_pos=cur_pos,
                                        window=self.window)
            new = cache
        x = x + L.dense(p["attn"]["wo"], att.reshape(b, s, hq * hd))
        x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
        return x, new

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.scale_embedding:
            x = (x.float() * math.sqrt(self.cfg.d_model)).to(x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        return L.unembed(x, self.embed, cfg.vocab, cfg.final_softcap)

    def _forward(self, tokens: torch.Tensor, ring: int):
        x = self._embed_tokens(tokens)
        q_pos = torch.arange(x.shape[1], device=x.device)
        blocks = []
        for kind, p in zip(self.kinds, self.blocks):
            with meshctx.gathered([p]):
                if kind == "rec":
                    x, c = self._rec_fwd(p, x)
                else:
                    x, c = self._attn_fwd(p, x, q_pos, ring=ring)
            blocks.append(c)
        return self._logits(x), blocks

    # ----------------------------------------------------------- forwards

    def _train_group(self, blocks, x: torch.Tensor,
                     q_pos: torch.Tensor) -> torch.Tensor:
        """Blocks ``blocks`` (index, kind) of the training forward, their
        sharded parameters gathered here under a mesh (``L.remat`` sees
        indices, not modules)."""
        with meshctx.gathered([self.blocks[i] for i, _ in blocks]):
            for i, kind in blocks:
                p = self.blocks[i]
                x = (self._rec_fwd(p, x) if kind == "rec"
                     else self._attn_fwd(p, x, q_pos))[0]
        return x

    def apply_train(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: {tokens (B, S)} → (logits (B, S, padded vocab) fp32, aux
        0). Differentiable: with ``cfg.remat`` and grad mode on, each group
        of ``len(block_pattern)`` blocks runs under one activation
        checkpoint (the reference's ``jax.checkpoint(group_fwd)``) and the
        remainder blocks without one, as the reference's."""
        cfg = self.cfg
        x = self._embed_tokens(batch["tokens"])
        q_pos = torch.arange(x.shape[1], device=x.device)
        n = len(cfg.block_pattern or ("rec", "rec", "attn"))
        order = list(enumerate(self.kinds))
        groups = len(order) // n
        for g in range(groups):
            x = L.remat(self._train_group, cfg.remat, order[g * n:(g + 1) * n],
                        x, q_pos)
        x = self._train_group(order[groups * n:], x, q_pos)
        logits = self._logits(x)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def _ring_slots(self, max_len: int) -> int:
        return min(self.cfg.sliding_window or max_len, max_len)

    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
        """Empty block caches (recurrent: zero state (B, w) fp32 and conv
        tail; attention: zero rings of W = min(window, max_len) slots in
        the weights' dtype unless given, every slot position −1) and
        ``pos = 0`` (a host int). Under an active mesh ``batch`` is the
        global batch and only this rank's rows are allocated
        (``sharding.new_cache``)."""
        cfg = self.cfg
        dtype = self.embed.dtype if dtype is None else dtype
        win = self._ring_slots(max_len)

        def build(dev):
            blocks = []
            for kind in self.kinds:
                if kind == "rec":
                    blocks.append((
                        torch.zeros((batch, self.w), dtype=torch.float32,
                                    device=dev),
                        torch.zeros((batch, cfg.conv_width - 1, self.w),
                                    dtype=dtype, device=dev)))
                else:
                    ring = (batch, win, cfg.kv_heads, cfg.head_dim)
                    blocks.append((
                        torch.zeros(ring, dtype=dtype, device=dev),
                        torch.zeros(ring, dtype=dtype, device=dev),
                        torch.full((win,), -1, dtype=torch.int32,
                                   device=dev)))
            return {"blocks": blocks, "pos": 0}
        cache = new_cache(build, batch, self.device)
        if "layout" in cache:  # a shard is zeros: its slots are empty too
            for kind, c in zip(self.kinds, cache["blocks"]):
                if kind == "attn":
                    c[2].fill_(-1)
        return cache

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """The forward over the prompt, emitting the decode caches: each
        recurrent block's last RG-LRU state and conv tail, each attention
        block's ring of the last W = min(window, max_len) positions.
        Returns (logits (B, S, padded vocab) fp32, cache with ``pos = S``).
        Under an active mesh ``batch`` is the global batch; the logits and
        the cache are this rank's rows."""
        mesh = meshctx.active_mesh()
        if mesh is not None:
            batch = serve_rows(batch, mesh)
        tokens = batch["tokens"]
        with meshctx.gathered([self], skip=(nn.ModuleList,)):
            logits, blocks = self._forward(tokens,
                                           ring=self._ring_slots(max_len))
        return logits, {"blocks": blocks, "pos": int(tokens.shape[1])}

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, object], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """tokens (B, 1): one token; returns (logits (B, 1, padded vocab)
        fp32, cache), the cache updated in place and its ``pos`` advanced
        by one. Under an active mesh, ``tokens`` and the logits are this
        rank's rows.

        Raises:
          ValueError: the ring holds fewer slots than the window (max_len
            < window) and is full: the token would overwrite a key inside
            its window, which the reference does silently (ROADMAP R13).
        """
        pos = int(cache["pos"])
        rings = [c[0].shape[1] for kind, c in zip(self.kinds, cache["blocks"])
                 if kind == "attn"]
        if rings and rings[0] < self.window and pos >= rings[0]:
            raise ValueError(f"decode at position {pos}: the ring holds "
                             f"{rings[0]} slots, fewer than the window "
                             f"{self.window}, and writing slot {pos % rings[0]} "
                             f"would drop a key inside the window (max_len "
                             f"must cover the prompt and every decoded token, "
                             f"or the window)")
        with meshctx.gathered([self], skip=(nn.ModuleList,)):
            x = self._embed_tokens(tokens)
            q_pos = torch.arange(pos, pos + 1, device=x.device)
            for kind, p, c in zip(self.kinds, self.blocks, cache["blocks"]):
                with meshctx.gathered([p]):
                    if kind == "rec":
                        x, _ = self._rec_fwd(p, x, cache=c)
                    else:
                        x, _ = self._attn_fwd(p, x, q_pos, cache=c,
                                              cur_pos=pos)
            cache["pos"] = pos + 1
            return self._logits(x), cache
