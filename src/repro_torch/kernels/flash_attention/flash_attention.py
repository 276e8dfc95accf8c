"""Flash attention (K6 of the port): the forward kernel, and its gradient.

The port of ``repro.kernels.flash_attention.flash_attention``.
``flash_attention_kernel`` launches a CUDA kernel of
``csrc/flash_attention.cu``, which replaces the TPU kernel
``_flash_kernel`` / ``flash_attention_pallas``: q (B, S, Hq, hd) against
k, v (B, T, Hkv, hd), grouped-query heads (q head h reads kv head h // G),
a causal and/or window mask with the kernel's rule
``(q_pos - k_pos) < window``, keys below ``prefix_len`` valid for every
query (the VLM's bidirectional prefix, which the Pallas kernel lacks and
the reference's chunked path has), an optional tanh softcap, output in
q's dtype. Its plain version is ``flash_attention_ref`` (``ref.py``), which a
CPU tensor takes. The input type picks the kernel, with no fallback:

- bf16 and fp16: ``flash_fwd_wgmma_kernel`` on Hopper's tensor cores
  (``wgmma`` on 16-bit tiles that TMA loads, the softmax in fp32
  registers). The softmax weights are rounded to the input type before
  they meet v, as the TPU kernel's default-precision dot rounds them, so
  the output is held to ``flash_within_tolerance``'s 16-bit bound. Each
  head dim has a compile-time plan (``WGMMA_PLANS``: consumer warpgroups
  of 64 rows and keys a tile); ``flash_plan`` picks, from the shape and
  the card's SM count, the rows a block and the parts each block's key
  range is cut into. A split call (parts > 1) writes each part's
  unnormalised fp32 output, max and sum to a workspace that the wrapper
  allocates with ``torch.empty``, and a second kernel of the same source
  merges them; it is still one K6 call and one count in ``LAUNCHES``.
- fp32: ``flash_fwd_kernel`` on the CUDA cores, fp32 arithmetic
  throughout.

Where the Pallas kernel asserts that S and T divide its tiles, the CUDA
kernels take any S and T. Head dims 64, 128 and 256 (the dense configs'
widths) are compiled; any other raises ``ValueError`` on either device.

On ``meta`` tensors (the dry run, ``repro_torch.launch.dryrun``) the
wrapper is shape-only: it returns ``torch.empty_like(q)`` on ``meta``,
records the work the kernel would do on those inputs in the active tally
(``launch.op_cost.record_kernel``: 4·hd FLOPs a valid (query, key) pair a
q head, ``flash_pairs``, and q, k, v read and the output written once),
allocates the split workspace that the card would (so the tally's
live-bytes peak counts it), and builds and launches nothing. The chunked
plain path is never modelled there: its chunk tensors are not what the
card allocates.

The wrapper checks its inputs, allocates the output with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch reported a CUDA
error, and adds one to ``LAUNCHES["flash_attention"]``. Launches happen
nowhere else, so the counter shows whether a run went through the kernel.
It is forward only: its output has no autograd graph, so it raises
``RuntimeError`` on inputs that require grad while grad mode is on.

``FlashAttention`` is the differentiable call. Its forward is the same
wrapper (the same kernel and tolerance as serving); its backward
recomputes a plain attention function that the caller passes
(``repro_torch.models.layers`` passes its chunked online-softmax scan, the
expression the CPU path runs and the reference differentiates with
``jax.grad``) on the saved inputs and returns its autograd gradients. The
reference has no backward kernel, so this ports none; the backward's
memory is the plain function's chunk tensors, about 4·B·S·T·Hq·4 bytes
for 1024-key chunks.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = [
    "FlashAttention",
    "FlashPlan",
    "HEAD_DIMS",
    "LAUNCHES",
    "WGMMA_PLANS",
    "check_flash_inputs",
    "flash_attention_kernel",
    "flash_pairs",
    "flash_plan",
    "reset_launch_counts",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _I, _I, _I, _F, _I, _F,
                                       _I, _I, _P)}

#: Kernel launches since the last ``reset_launch_counts()``.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

#: Head dims the CUDA kernel is compiled for.
HEAD_DIMS = (64, 128, 256)

#: The 16-bit kernel's compile-time plan of each head dim, as
#: ``csrc/flash_attention.cu`` ``struct Plan<HD>`` states it: consumer
#: warpgroups of 64 rows at most, and keys a K/V tile. Head dim 256 keeps
#: PR 16's plan: 128 rows a block, one part.
WGMMA_PLANS = {64: dict(consumers=3, keys=128),
               128: dict(consumers=3, keys=64),
               256: dict(consumers=2, keys=64)}
#: SM count assumed where there is no card (the dry run's ``meta``): H100.
META_SMS = 132

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NO_WINDOW = 1 << 30
_INT_MAX = 2 ** 31 - 1
_SMS: Dict[int, int] = {}
_FWD = None


class FlashPlan(NamedTuple):
    """A 16-bit K6 launch: ``rows`` (query, head) rows a block (64 per
    consumer warpgroup), ``keys`` a K/V tile, and ``parts``, the pieces
    each block's key range is cut into (1: one pass, no workspace)."""
    rows: int
    keys: int
    parts: int


@functools.lru_cache(maxsize=4096)
def flash_plan(b: int, s: int, t: int, hq: int, hkv: int, hd: int, *,
               causal: bool, window: Optional[int], prefix_len: int = 0,
               sm_count: int = META_SMS) -> FlashPlan:
    """The launch plan of the 16-bit kernel for one call, a pure function of
    the shape and the card's SM count (no option or environment variable
    reaches it).

    Rows: 64 × c consumer warpgroups, c at most the plan's and at most what
    S·G fills (S·G ≤ 64: one), the c with the least rounds of blocks over
    the SMs × √c (one block an SM; a block of more warpgroups takes longer,
    not c times longer; ties to the larger c). On an H100 that picks 3 at
    whisper-medium's encoder and the qwen1.5-32b and dbrx-132b layers, and
    2 at arctic-480b's, whose 3-warpgroup blocks ran two rounds. Parts:
    where the blocks would leave three quarters of the SMs idle (blocks × 4
    ≤ SMs) and the longest key range a block walks holds at least 4 tiles,
    the range is cut into about one block an SM, each part of at least 2
    tiles. On an H100 the split did not pay at 64 blocks (whisper-medium's
    cross-attention at batch 4) and did at 16 (its decode step at batch
    1); ``tools/k6_plans.py`` times both. Head dim 256 keeps PR 16's plan:
    128 rows, one part.
    """
    plan = WGMMA_PLANS[hd]
    keys = plan["keys"]
    if hd == 256:
        return FlashPlan(128, keys, 1)
    n_rows = s * (hq // hkv)

    def cost(c):
        return -(-(-(-n_rows // (64 * c)) * b * hkv) // sm_count) * c ** 0.5

    wgs = min(range(min(plan["consumers"], -(-n_rows // 64)), 0, -1),
              key=cost)
    rows = 64 * wgs
    blocks = -(-n_rows // rows) * b * hkv
    # the longest key range a block walks, about: a causal or window
    # block's; all T when a row lies past T + window (it has no valid key)
    span = min(t, s) if causal else t
    if window is not None and s < t + int(window):
        span = min(span, int(window) + -(-rows // (hq // hkv)))
    span = max(span, min(int(prefix_len), t))
    tiles = -(-span // keys)
    parts = 1
    if 4 * blocks <= sm_count and tiles >= 4:
        parts = max(1, min(tiles // 2, sm_count // blocks))
    return FlashPlan(rows, keys, parts)


def _sm_count(index: int) -> int:
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def _fwd():
    """The C entry ``flash_attention_fwd``, built and loaded at first use."""
    global _FWD
    if _FWD is None:
        _FWD = _build.load_library("flash_attention",
                                   _SIGNATURES).flash_attention_fwd
    return _FWD


def _workspace_floats(b: int, s: int, hq: int, hd: int, parts: int) -> int:
    """Floats of a split call's workspace: each part's fp32 output, max and
    sum for every (batch, query, q head) row."""
    return parts * b * s * hq * (hd + 2)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_flash_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: Optional[int], prefix_len: int = 0) -> None:
    """Validate a (q, k, v, window, prefix_len) set for the kernel and its
    plain version.

    Raises:
      ValueError: q not (B, S, Hq, hd) or k, v not (B, T, Hkv, hd) with
        Hkv dividing Hq; T = 0; dtypes that differ or are not fp32, bf16 or
        fp16; tensors on different devices; hd not in ``HEAD_DIMS``; a
        window below 1; a negative prefix_len; S, T or S·G past int32, or
        B·Hkv past 65535.
    """
    if not (isinstance(q, torch.Tensor) and isinstance(k, torch.Tensor)
            and isinstance(v, torch.Tensor)):
        raise ValueError("q, k and v must be torch tensors")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape or ks[0] != qs[0] \
            or ks[3] != qs[3]:
        raise ValueError(f"need q (B, S, Hq, hd) and k, v (B, T, Hkv, hd), got "
                         f"{tuple(qs)}, {tuple(ks)} and {tuple(v.shape)}")
    b, s, hq, hd = qs
    t, hkv = ks[1], ks[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hkv = {hkv} must divide Hq = {hq}")
    if t < 1:
        raise ValueError("need at least one key (T >= 1)")
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"q, k and v must share one of {list(_DTYPES)}, got "
                         f"{dtype}, {k.dtype} and {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"q on {dev}, k on {k.device}, v on {v.device}: "
                         f"need one device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not compiled; the kernel takes "
                         f"{HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if max(s, t, s * (hq // hkv)) > _INT_MAX or b * hkv > 65535:
        raise ValueError(f"q {tuple(qs)}, k {tuple(ks)}: S, T and "
                         f"S·G must fit int32 and B·Hkv the grid (65535)")


def flash_pairs(s: int, t: int, *, causal: bool, window: Optional[int],
                prefix_len: int = 0) -> int:
    """The (query, key) pairs K6's mask keeps for one head of one row: query
    i at position i, key j at j, kept when ``j <= i`` (causal) and ``i - j
    < window``, or when ``j < prefix_len``. Counted on the host in numpy
    (no torch op: a dry run's tally sees none)."""
    import numpy as np

    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full_like(i, t - 1)
    lo = np.zeros_like(i) if window is None else np.maximum(
        i - int(window) + 1, 0)
    kept = np.maximum(hi - lo + 1, 0)
    pre = min(int(prefix_len), t)
    if pre:
        both = np.maximum(np.minimum(hi, pre - 1) - lo + 1, 0)
        kept = kept + pre - both
    return int(kept.sum())


def _shape_only(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: Optional[int],
                prefix_len: int) -> torch.Tensor:
    """K6 on ``meta`` tensors: its output's shape and dtype, and its work
    recorded in the active tally."""
    from repro_torch.launch.op_cost import record_kernel

    b, s, hq, hd = (int(x) for x in q.shape)
    t, hkv = int(k.shape[1]), int(k.shape[2])
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.dtype != torch.float32:  # a split call's workspace, beside out
        parts = flash_plan(b, s, t, hq, hkv, hd, causal=causal, window=window,
                           prefix_len=min(int(prefix_len), t)).parts
        if parts > 1:
            torch.empty(_workspace_floats(b, s, hq, hd, parts),
                        dtype=torch.float32, device=q.device)
    pairs = flash_pairs(s, t, causal=causal, window=window,
                        prefix_len=prefix_len)
    size = q.element_size()
    record_kernel("flash_attention", flops=4.0 * hd * pairs * b * hq,
                  dtype=q.dtype, bytes_read=size * (q.numel() + 2 * k.numel()),
                  bytes_written=size * out.numel())
    return out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels' vector loads). With hd
    in ``HEAD_DIMS`` (all >= 64), every stride of a contiguous 16-bit k or
    v is then a multiple of 128 bytes, past the 16 bytes that TMA needs."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: Optional[int] = None,
                           cap: Optional[float] = None,
                           prefix_len: int = 0) -> torch.Tensor:
    """Forward attention: K6 on CUDA tensors, the plain version
    (``flash_attention_ref``) on CPU tensors, shape-only on ``meta``
    tensors (the output's shape and dtype, the work recorded in the active
    ``launch.op_cost`` tally).

    Args:
      q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd), one dtype (fp32, bf16 or
        fp16), hd in ``HEAD_DIMS``, any S and T >= 1.
      causal: mask keys after the query.
      window: keep keys with ``q_pos - k_pos < window`` (None: all).
      cap: tanh softcap of the scaled logits (None: none).
      prefix_len: keys below it are valid for every query, whatever the
        causal and window mask says (0: no prefix).

    Returns:
      (B, S, Hq, hd) in q's dtype.

    Raises:
      ValueError: bad inputs (see ``check_flash_inputs``) or a device that is
        neither CPU nor CUDA.
      RuntimeError: an input requires grad while grad mode is on (the
        output would have no graph: use ``FlashAttention``), or the kernel
        did not build or launch.
    """
    check_flash_inputs(q, k, v, window, prefix_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_kernel is forward only and its output has no "
            "autograd graph; inputs that require grad go through "
            "FlashAttention.apply (layers.attention routes them there)")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap, prefix_len=prefix_len)
    if dev.type == "meta":
        return _shape_only(q, k, v, causal=causal, window=window,
                           prefix_len=prefix_len)
    if dev.type != "cuda":
        raise ValueError(f"the flash_attention kernel takes CUDA tensors, got "
                         f"{dev}")
    # the host's share of a call is most of a small one's time: plain ints
    # from the shapes, the plan from a cache, the stream as a raw handle
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    win = _NO_WINDOW if window is None else min(int(window), _NO_WINDOW)
    pre = min(int(prefix_len), t)  # a prefix past T holds every key
    index = dev.index
    rows, parts, ws = 0, 1, None
    if q.dtype != torch.float32:
        rows, _, parts = flash_plan(b, s, t, hq, hkv, hd, causal=bool(causal),
                                    window=window, prefix_len=pre,
                                    sm_count=_sm_count(index))
        if parts > 1:
            ws = torch.empty(_workspace_floats(b, s, hq, hd, parts),
                             dtype=torch.float32, device=dev)
    fwd = _fwd()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), _DTYPES[q.dtype], b, s, t,
            hq, hkv, hd, int(bool(causal)), win, pre, 1.0 / math.sqrt(hd),
            int(cap is not None), 0.0 if cap is None else float(cap), rows,
            parts, torch._C._cuda_getCurrentRawStream(index))
    if torch._C._cuda_getDevice() == index:
        err = fwd(*args)
    else:  # launch on q's card
        with torch.cuda.device(index):
            err = fwd(*args)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA error "
                           f"{err} at q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype}")
    LAUNCHES["flash_attention"] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """K6 forward with the gradient of a plain attention function.

    ``FlashAttention.apply(q, k, v, plain, causal, window, cap,
    prefix_len)``: the forward is ``flash_attention_kernel`` with those
    arguments (one launch on CUDA tensors, the plain version on CPU ones);
    ``plain(q, k, v)`` must compute the same function differentiably (the
    layers' chunked scan at positions ``arange(S)`` and ``arange(T)``).
    The backward detaches the saved q, k and v, runs ``plain`` on them
    under ``torch.enable_grad()`` and returns ``torch.autograd.grad`` of
    its output against the incoming gradient; no kernel runs there. Under
    activation checkpointing the forward runs again in the recompute, so a
    checkpointed layer launches K6 twice a step.
    """

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                plain: Callable, causal: bool = True,
                window: Optional[int] = None, cap: Optional[float] = None,
                prefix_len: int = 0) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      cap=cap, prefix_len=prefix_len)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        need = ctx.needs_input_grad[:3]
        inputs = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.plain(*inputs)
            wanted = [x for x, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, dout))
        return (*(next(grads) if n else None for n in need),
                None, None, None, None, None)
