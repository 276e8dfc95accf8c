"""The port's attention equals the reference's.

K6's plain version (``flash_attention_ref``) against the reference's
``flash_attention_ref`` at ``tests/test_kernels.py``'s five shapes and
further ones (G ∈ {1, 2, 4, 8}, windows, softcaps, non-causal, ragged S
and T ≠ S) in fp32, and one bf16 case; against the Pallas kernel in
interpret mode (under the ``pl.load`` shim, divisible shapes only); the
chunked ``layers.attention`` against the reference's with a prefix, padded
key positions and non-causal windows; and the dispatch: a CPU tensor takes
the plain version and launches nothing, other devices raise.

Tolerances: fp32 paths agree to 2e-5 (the same fp32 arithmetic, summed in
another order); against the Pallas kernel 2e-3, as the reference's own
test; bf16 outputs to one bf16 rounding step (2⁻⁷ relative).

K6's numeric contract for 16-bit inputs (``flash_within_tolerance``): a
torch emulation of the tensor-core kernel's arithmetic (the launch plan of
``flash_plan``: rows a block and keys a tile of each head dim's
``struct Plan`` in the source, the key split and its log-sum-exp merge;
the online softmax from the -1e30 sentinel, P rounded to the input type
before P·V, the exact tile-skip rule) against the reference's oracle, the
Pallas kernel in interpret mode and the port's plain version, within one
output rounding plus the bf16 (fp16) weights' slack; and the same bound
rejecting an emulation that skips the alpha rescale. With the VLM's
bidirectional prefix, the emulation (every block from key 0) against the
port's plain version and the reference's ``layers.attention``. Splits
where a part holds only masked keys or none, and rows with no valid key,
against the oracle, and in fp32 against one pass. The plan function on
whisper-medium's, the head-dim-128 layers' and head-dim-256 shapes.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as port_layers

TOL = dict(rtol=2e-5, atol=2e-5)

# tests/test_kernels.py's five shapes: (b, s, hq, hkv, hd, causal, window, cap)
KERNEL_TEST_SHAPES = [
    (2, 64, 4, 2, 16, True, None, None),
    (1, 128, 8, 1, 32, True, 32, 50.0),
    (2, 64, 4, 4, 16, False, None, None),
    (1, 256, 2, 1, 64, True, None, None),
    (1, 64, 4, 2, 16, True, 16, None),
]
MORE_SHAPES = [
    (1, 48, 2, 2, 16, True, None, None),     # G = 1
    (2, 48, 4, 2, 16, True, 8, 50.0),        # G = 2, window and cap
    (1, 48, 8, 2, 32, True, None, 30.0),     # G = 4
    (1, 48, 8, 1, 16, True, 5, None),        # G = 8
    (2, 40, 4, 2, 16, False, 12, None),      # non-causal window (kernel rule)
    (1, 40, 4, 1, 64, True, 16, 50.0),       # ragged S = 40
    (2, 100, 8, 4, 16, True, 33, 50.0),      # ragged S = 100
    (1, 100, 2, 1, 32, False, None, 20.0),   # ragged, non-causal
]


def _qkv(b, s, hq, hkv, hd, seed, t=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    q = rng.standard_normal((b, s, hq, hd)).astype(dtype)
    k = rng.standard_normal((b, t, hkv, hd)).astype(dtype)
    v = rng.standard_normal((b, t, hkv, hd)).astype(dtype)
    return q, k, v


def _jnp(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,cap",
                         KERNEL_TEST_SHAPES + MORE_SHAPES)
def test_plain_matches_reference_oracle(lmref, b, s, hq, hkv, hd, causal,
                                        window, cap):
    q, k, v = _qkv(b, s, hq, hkv, hd, seed=s + hq + hd)
    want = lmref.flashref.flash_attention_ref(
        _jnp(q), _jnp(k), _jnp(v), causal=causal, window=window, cap=cap)
    got = fa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window, cap=cap)
    assert got.dtype == torch.float32 and got.shape == (b, s, hq, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,t,causal,window", [
    (40, 100, True, None), (100, 40, True, 16), (100, 40, False, 8),
    (33, 64, False, None),
])
def test_plain_matches_reference_oracle_t_ne_s(lmref, s, t, causal, window):
    q, k, v = _qkv(1, s, 4, 2, 16, seed=s * t, t=t)
    want = lmref.flashref.flash_attention_ref(
        _jnp(q), _jnp(k), _jnp(v), causal=causal, window=window, cap=50.0)
    got = fa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window, cap=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,cap", KERNEL_TEST_SHAPES
                         + [(1, 64, 4, 2, 64, True, 16, 50.0),
                            (1, 64, 2, 1, 128, False, None, None)])
def test_plain_matches_pallas_interpret(lmref, b, s, hq, hkv, hd, causal,
                                        window, cap):
    q, k, v = _qkv(b, s, hq, hkv, hd, seed=7 * s + hd)
    pal = lmref.flash.flash_attention_pallas(
        _jnp(q), _jnp(k), _jnp(v), causal=causal, window=window, cap=cap,
        block_q=32, block_k=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = fa.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=2e-3,
                               atol=2e-3)
    if hd in fa.HEAD_DIMS:  # the kernel's wrapper, on CPU tensors
        wrapped = fa.flash_attention_kernel(tq, tk, tv, causal=causal,
                                            window=window, cap=cap)
        np.testing.assert_allclose(wrapped.numpy(), np.asarray(pal),
                                   rtol=2e-3, atol=2e-3)


def test_plain_bf16_matches_reference(lmref):
    import jax.numpy as jnp

    q, k, v = _qkv(1, 64, 4, 2, 32, seed=9)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(lmref.flashref.flash_attention_ref(
        jq, jk, jv, window=24, cap=50.0), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                  for x in (jq, jk, jv))
    got = fa.flash_attention_ref(tq, tk, tv, window=24, cap=50.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("s,t,causal,window,prefix,pad,chunk,cap", [
    (40, 40, True, 16, 0, 0, 16, 50.0),      # sliding window, chunk padding
    (40, 40, True, 1 << 30, 0, 0, 1024, None),
    (32, 32, False, 1 << 30, 0, 0, 8, None),
    (40, 40, False, 6, 0, 0, 16, 50.0),      # |q - k| < window
    (36, 36, True, 1 << 30, 10, 0, 16, None),  # bidirectional prefix
    (36, 36, True, 8, 12, 0, 16, 50.0),      # prefix and window
    (24, 40, True, 1 << 30, 0, 7, 16, None),  # padded key slots (k_pos -1)
    (24, 40, False, 5, 4, 9, 16, 30.0),
])
def test_chunked_attention_matches_reference(lmref, s, t, causal, window,
                                             prefix, pad, chunk, cap):
    import jax.numpy as jnp

    q, k, v = _qkv(2, s, 4, 2, 16, seed=s + t + pad, t=t)
    q_pos = np.arange(s, dtype=np.int32) + (t - pad - s if t > s else 0)
    k_pos = np.arange(t, dtype=np.int32)
    if pad:
        k_pos[t - pad:] = -1
    want = lmref.layers.attention(
        _jnp(q), _jnp(k), _jnp(v), q_pos=jnp.asarray(q_pos),
        k_pos=jnp.asarray(k_pos), window=window, causal=causal,
        prefix_len=prefix, cap=cap, chunk=chunk)
    got = port_layers.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
        window=window, causal=causal, prefix_len=prefix, cap=cap, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_backends_agree_on_cpu(lmref):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 48, 4, 2, 64, seed=3))
    kw = dict(causal=True, window=20, cap=50.0)
    ref = fa.flash_attention(q, k, v, backend="ref", **kw)
    assert fa.BACKENDS == ("kernel", "ref")
    np.testing.assert_allclose(
        fa.flash_attention(q, k, v, backend="kernel", **kw).numpy(),
        ref.numpy(), **TOL)
    # the reference's "jnp" backend is the chunked layers.attention here;
    # positions left as None are arange
    for pos in (None, torch.arange(48)):
        np.testing.assert_allclose(
            port_layers.attention(q, k, v, q_pos=pos, k_pos=pos,
                                  backend="chunked", **kw).numpy(),
            ref.numpy(), **TOL)
    want = lmref.flashops.flash_attention(
        _jnp(q.numpy()), _jnp(k.numpy()), _jnp(v.numpy()), backend="jnp",
        **kw)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="unknown backend"):
        fa.flash_attention(q, k, v, backend="pallas")


def test_cpu_tensor_takes_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 40, 4, 2, 64, seed=4))
    fa.reset_launch_counts()
    got = fa.flash_attention_kernel(q, k, v, window=16, cap=50.0)
    assert fa.LAUNCHES == {"flash_attention": 0}
    assert torch.equal(got, fa.flash_attention_ref(q, k, v, window=16,
                                                   cap=50.0))
    out = port_layers.attention(q, k, v, q_pos=torch.arange(40),
                                k_pos=torch.arange(40), window=16, cap=50.0)
    assert out.shape == q.shape and fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("bad,match", [
    (dict(hd=48), "head dim 48"),
    (dict(kdtype=torch.float64), "share one of"),
    (dict(hkv=3), "must divide"),
    (dict(t=0), "at least one key"),
    (dict(window=0), "window must be"),
])
def test_kernel_wrapper_rejects_bad_inputs(bad, match):
    hd, hkv, t = bad.get("hd", 64), bad.get("hkv", 2), bad.get("t", 8)
    q = torch.zeros(1, 8, 4, hd)
    k = torch.zeros(1, t, hkv, hd, dtype=bad.get("kdtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_kernel(q, k, k.clone(), window=bad.get("window"))


class _Elsewhere(torch.Tensor):
    """A tensor that claims a device that is neither CPU, CUDA nor meta and
    holds no data: any op on it fails."""

    @staticmethod
    def __new__(cls, *shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} ran on a tensor without data")


def test_non_cpu_requests_raise_without_a_card():
    q, k = _Elsewhere(1, 8, 4, 64), _Elsewhere(1, 8, 2, 64)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa.flash_attention_kernel(q, k, k)
    # a bidirectional prefix is the kernel's case: it reaches the wrapper
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        port_layers.attention(q, k, k, prefix_len=2)
    # meta tensors are the dry run's: shape-only, nothing launched
    q = torch.empty(1, 8, 4, 64, device="meta")
    k = torch.empty(1, 8, 2, 64, device="meta")
    fa.reset_launch_counts()
    out = port_layers.attention(q, k, k, prefix_len=2)
    assert out.device.type == "meta" and out.shape == q.shape
    assert fa.LAUNCHES["flash_attention"] == 0
    pos = torch.arange(8, device="meta")
    # cases the kernel does not take raise before any device work
    with pytest.raises(NotImplementedError, match="causal=False"):
        port_layers.attention(q, k, k, q_pos=pos, k_pos=pos, causal=False,
                              window=4)
    with pytest.raises(ValueError, match="unknown attention backend"):
        port_layers.attention(q, k, k, q_pos=pos, k_pos=pos, backend="jnp")
    try:  # the kernel is built from source at first use, or the call raises
        _build.find_nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load_library("flash_attention", {})


# -- K6's numeric contract for 16-bit inputs ---------------------------------

def _wgmma_plans():
    """{head dim: (consumer warpgroups, keys a tile)} of
    ``flash_fwd_wgmma_kernel``, read from each ``struct Plan<HD>`` of its
    source, so that the emulation below follows the kernel's tiling."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "csrc" / "flash_attention.cu").read_text()
    plans = {}
    for hd, body in re.findall(r"struct Plan<(\d+)> \{(.*?)\n\};", src,
                               flags=re.S):
        def const(name):
            return int(re.search(rf"constexpr int {name} = (\d+);", body)[1])

        plans[int(hd)] = (const("kConsumers"), const("kKeys"))
    return plans


WGMMA_PLANS = _wgmma_plans()


def _round_bits(p, bits):
    mant, ex = torch.frexp(p)
    return torch.ldexp(torch.round(mant * 2 ** bits) / 2 ** bits, ex)


def _emulate_wgmma_kernel(q, k, v, *, causal=True, window=None, cap=None,
                          prefix_len=0, rescale=True, p_bits=None,
                          parts=None):
    """The 16-bit kernel's arithmetic (``flash_fwd_wgmma_kernel``) in torch,
    on the launch plan the wrapper would pick (``fa.flash_plan``; head dims
    below 64 take the head-dim-64 plan's tiles): blocks of ``rows`` (query,
    head) rows of one kv head, each visiting the ``keys``-key tiles of its
    key range (the kernel's skip rule; with a prefix, from key 0 to at least
    its end), cut on tile boundaries into ``parts`` (``parts`` overrides the
    plan's), each part an online softmax from the -1e30 sentinel (-inf past
    T) with P rounded to the input type before P·V, the parts merged by
    log-sum-exp, acc / max(l, 1e-30) rounded once. Known faults:
    ``rescale=False`` drops the alpha rescale of the accumulator;
    ``p_bits`` rounds P to that many significant bits instead of the input
    type."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    win = 1 << 30 if window is None else window
    pre = min(prefix_len, t)
    plan = fa.flash_plan(b, s, t, hq, hkv, max(hd, 64), causal=causal,
                         window=window, prefix_len=pre)
    rows_all, keys = plan.rows, plan.keys
    n_parts = plan.parts if parts is None else parts
    n_rows = s * g
    out = torch.empty(b, s, hq, hd, dtype=q.dtype)
    for bi in range(b):
        for h in range(hkv):
            qr = q[bi, :, h * g:(h + 1) * g].reshape(n_rows, hd).float()
            kf, vh = k[bi, :, h].float(), v[bi, :, h]
            flat = torch.empty(n_rows, hd, dtype=q.dtype)
            for r0 in range(0, n_rows, rows_all):
                rows = qr[r0:r0 + rows_all]
                spos = torch.arange(r0, r0 + rows.shape[0]) // g
                s_lo, s_hi = r0 // g, min(n_rows - 1, r0 + rows_all - 1) // g
                k_begin = max(0, s_lo - win + 1)
                k_end = min(t, s_hi + 1) if causal else t
                if s_hi - win + 1 > t - 1:  # a row with no valid key
                    k_begin, k_end = 0, t
                if pre > 0:  # every row sees the prefix
                    k_begin, k_end = 0, max(k_end, pre)
                k_begin = k_begin // keys * keys
                n_all = -(-(k_end - k_begin) // keys)
                done = []
                for z in range(n_parts):
                    m = torch.full((rows.shape[0],), -1e30)
                    l = torch.zeros(rows.shape[0])
                    acc = torch.zeros(rows.shape[0], hd)
                    for tile in range(n_all * z // n_parts,
                                      n_all * (z + 1) // n_parts):
                        kt = k_begin + tile * keys
                        kpos = torch.arange(kt, kt + keys)
                        n = min(keys, t - kt)  # keys past T: zero rows
                        kt_rows = torch.zeros(keys, hd)
                        vt_rows = torch.zeros(keys, hd)
                        kt_rows[:n] = kf[kt:kt + n]
                        vt_rows[:n] = vh[kt:kt + n].float()
                        x = rows @ kt_rows.T * (1.0 / math.sqrt(hd))
                        if cap is not None:
                            x = torch.tanh(x / cap) * cap
                        qk = spos[:, None] - kpos[None, :]
                        valid = (qk < win) & ((qk >= 0) if causal else True)
                        valid = valid | (kpos[None, :] < pre)
                        x = torch.where(valid, x, torch.tensor(-1e30))
                        x = torch.where(kpos[None, :] >= t, -math.inf, x)
                        m_new = torch.maximum(m, x.amax(1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(x - m_new[:, None])
                        l = l * alpha + p.sum(1)
                        pr = p.to(q.dtype).float() if p_bits is None \
                            else _round_bits(p, p_bits)
                        pv = pr @ vt_rows
                        acc = (acc * alpha[:, None] if rescale else acc) + pv
                        m = m_new
                    done.append((m, l, acc))
                # the merge: w = exp(m_p - max m), parts with no tile carry
                # (m, l, acc) = (-1e30, 0, 0) and so add nothing
                top = torch.stack([m for m, _, _ in done]).amax(0)
                w = [torch.exp(m - top) for m, _, _ in done]
                l = sum(wi * li for wi, (_, li, _) in zip(w, done))
                acc = sum(wi[:, None] * ai for wi, (_, _, ai) in zip(w, done))
                flat[r0:r0 + rows.shape[0]] = acc / l.clamp_min(1e-30)[:, None]
            out[bi, :, h * g:(h + 1) * g] = flat.reshape(s, g, hd)
    return out


def _torch16(arrays, dtype):
    return [torch.from_numpy(x).to(dtype) for x in arrays]


# (b, s, t, hq, hkv, hd, causal, window, cap)
EMULATION_SHAPES = [
    (2, 100, 100, 8, 4, 16, True, 33, 50.0),   # ragged S, G = 2
    (1, 48, 48, 8, 2, 32, True, None, 30.0),   # G = 4
    (1, 48, 48, 8, 1, 16, True, 5, None),      # G = 8, three row blocks
    (2, 40, 40, 4, 2, 16, False, 12, None),    # non-causal window
    (1, 200, 50, 4, 2, 64, True, 20, None),    # S > T + window: rows with no key
    (1, 200, 50, 4, 2, 64, False, 10, 50.0),
    (1, 70, 130, 10, 2, 64, True, None, 50.0),  # G = 5 (qwen1.5-32b), S < T
    (1, 300, 300, 2, 1, 32, True, 64, 50.0),   # many tiles, skipped by the window
]


@pytest.mark.parametrize("b,s,t,hq,hkv,hd,causal,window,cap",
                         EMULATION_SHAPES)
def test_wgmma_arithmetic_within_contract_bf16(lmref, b, s, t, hq, hkv, hd,
                                               causal, window, cap):
    import jax.numpy as jnp

    arrays = _qkv(b, s, hq, hkv, hd, seed=s + t + hq, t=t)
    q, k, v = _torch16(arrays, torch.bfloat16)
    kw = dict(causal=causal, window=window, cap=cap)
    got = _emulate_wgmma_kernel(q, k, v, **kw)
    assert bool(torch.isfinite(got.float()).all())
    plain = fa.flash_attention_ref(q, k, v, **kw)
    ok, err = fa.flash_within_tolerance(got, plain, q, k, v, **kw)
    assert ok, err
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))
    want = torch.from_numpy(np.asarray(lmref.flashref.flash_attention_ref(
        jq, jk, jv, **kw), np.float32)).bfloat16()
    ok, err = fa.flash_within_tolerance(got, want, q, k, v, **kw)
    assert ok, err


@pytest.mark.parametrize("b,s,t,hq,hkv,hd,causal,window,cap",
                         [EMULATION_SHAPES[i] for i in (0, 4, 6)])
def test_wgmma_arithmetic_within_contract_fp16(b, s, t, hq, hkv, hd, causal,
                                               window, cap):
    q, k, v = _torch16(_qkv(b, s, hq, hkv, hd, seed=s * hd, t=t), torch.float16)
    kw = dict(causal=causal, window=window, cap=cap)
    got = _emulate_wgmma_kernel(q, k, v, **kw)
    ok, err = fa.flash_within_tolerance(got, fa.flash_attention_ref(
        q, k, v, **kw), q, k, v, **kw)
    assert ok, err


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,cap", [
    (1, 128, 8, 1, 32, True, 32, 50.0),
    (2, 64, 4, 2, 16, True, None, None),
    (1, 256, 2, 1, 64, True, None, None),
])
def test_wgmma_arithmetic_matches_pallas_interpret(lmref, b, s, hq, hkv, hd,
                                                   causal, window, cap):
    import jax.numpy as jnp

    arrays = _qkv(b, s, hq, hkv, hd, seed=11 * s + hd)
    q, k, v = _torch16(arrays, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))
    pal = lmref.flash.flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, cap=cap, block_q=32,
        block_k=32, interpret=True)
    want = torch.from_numpy(np.asarray(pal, np.float32)).bfloat16()
    kw = dict(causal=causal, window=window, cap=cap)
    ok, err = fa.flash_within_tolerance(_emulate_wgmma_kernel(q, k, v, **kw),
                                        want, q, k, v, **kw)
    assert ok, err


# shapes whose blocks walk several key tiles (with one tile a block there
# is no rescale to skip)
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, EMULATION_SHAPES[7]),
    (torch.float16, (2, 300, 300, 8, 4, 16, True, 200, 50.0)),
])
def test_contract_rejects_a_skipped_rescale(dtype, shape):
    b, s, t, hq, hkv, hd, causal, window, cap = shape
    q, k, v = _torch16(_qkv(b, s, hq, hkv, hd, seed=5, t=t), dtype)
    kw = dict(causal=causal, window=window, cap=cap)
    plain = fa.flash_attention_ref(q, k, v, **kw)
    assert fa.flash_within_tolerance(_emulate_wgmma_kernel(q, k, v, **kw),
                                     plain, q, k, v, **kw)[0]
    ok, err = fa.flash_within_tolerance(
        _emulate_wgmma_kernel(q, k, v, rescale=False, **kw), plain, q, k, v,
        **kw)
    assert not ok and err > 0.05, err


@pytest.mark.parametrize("dtype,step", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -7)])
def test_contract_bound_per_type(dtype, step):
    q, k, v = _torch16(_qkv(1, 40, 4, 2, 64, seed=6), dtype)
    kw = dict(window=16, cap=50.0)
    want = fa.flash_attention_ref(q, k, v, **kw)
    w32 = want.float()
    slack = 0.0 if dtype == torch.float32 else 2.0 ** -8 * \
        fa.flash_attention_ref(q, k, v.abs(), **kw).float()
    bound = step * w32.abs() + slack + 1e-4
    assert fa.flash_within_tolerance(want, want, q, k, v, **kw) == (True, 0.0)
    assert fa.flash_within_tolerance(w32 + 0.25 * bound, want, q, k, v,
                                     **kw)[0]
    assert not fa.flash_within_tolerance(w32 + 2 * bound, want, q, k, v,
                                         **kw)[0]


# (b, s, t, hq, hkv, hd, causal, window, cap): hd >= 64, so that a row's
# RMS is taken over enough values for its error share to settle
ROW_SHAPES = [
    (1, 300, 300, 4, 2, 64, True, None, 50.0),
    (1, 257, 300, 10, 2, 64, True, 100, None),   # G = 5, S < T
    (1, 200, 200, 2, 1, 128, True, 64, 50.0),
    (1, 200, 50, 4, 2, 64, False, 10, 50.0),     # rows with no key
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,t,hq,hkv,hd,causal,window,cap", ROW_SHAPES)
def test_wgmma_arithmetic_within_row_rms_bound(b, s, t, hq, hkv, hd, causal,
                                               window, cap, dtype):
    q, k, v = _torch16(_qkv(b, s, hq, hkv, hd, seed=s + hd, t=t), dtype)
    kw = dict(causal=causal, window=window, cap=cap)
    rows = fa.flash_row_rms(_emulate_wgmma_kernel(q, k, v, **kw), q, k, v,
                            **kw)
    assert rows.shape == (b, s, hq)
    assert float(rows.max()) <= fa.ROW_RMS_BOUND[dtype], float(rows.max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_row_rms_rejects_coarse_weights(dtype):
    b, s, t, hq, hkv, hd, causal, window, cap = ROW_SHAPES[0]
    q, k, v = _torch16(_qkv(b, s, hq, hkv, hd, seed=9, t=t), dtype)
    kw = dict(causal=causal, window=window, cap=cap)
    rows = fa.flash_row_rms(_emulate_wgmma_kernel(q, k, v, p_bits=4, **kw),
                            q, k, v, **kw)
    # P rounded to 2⁻⁴ of itself: most rows, the late ones too, fail
    assert float(rows[:, s // 2:].median()) > fa.ROW_RMS_BOUND[dtype]


# (b, s, hq, hkv, hd, window, prefix): causal, as the VLM's prefill
PREFIX_SHAPES = [
    (2, 100, 8, 1, 16, None, 40),     # G = 8 (paligemma's MQA), ragged
    (1, 200, 4, 2, 32, None, 70),     # P not a multiple of the 64-key tile
    (1, 160, 4, 1, 16, 24, 50),       # window and prefix: two intervals
    (1, 300, 2, 1, 16, 16, 129),      # P past two tiles, a narrow window
    (1, 60, 4, 2, 16, None, 60),      # P = S: every key visible
    (1, 60, 4, 2, 16, 8, 500),        # P > S: every key visible
]


@pytest.mark.parametrize("b,s,hq,hkv,hd,window,prefix", PREFIX_SHAPES)
def test_wgmma_arithmetic_with_prefix_within_contract(lmref, b, s, hq, hkv,
                                                      hd, window, prefix):
    """The 16-bit kernel's arithmetic with a bidirectional prefix against
    the port's plain version and the reference's ``layers.attention``
    (whose causal mask with ``prefix_len`` is the kernel's rule), within
    K6's contract and row bound."""
    import jax.numpy as jnp

    q, k, v = _torch16(_qkv(b, s, hq, hkv, hd, seed=s + prefix), torch.bfloat16)
    kw = dict(causal=True, window=window, cap=50.0, prefix_len=prefix)
    got = _emulate_wgmma_kernel(q, k, v, **kw)
    plain = fa.flash_attention_ref(q, k, v, **kw)
    ok, err = fa.flash_within_tolerance(got, plain, q, k, v, **kw)
    assert ok, err
    rows = fa.flash_row_rms(got, q, k, v, **kw)
    assert float(rows.max()) <= fa.ROW_RMS_BOUND[torch.bfloat16]
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))
    pos = jnp.arange(s)
    want = lmref.layers.attention(
        jq, jk, jv, q_pos=pos, k_pos=pos, causal=True, cap=50.0,
        window=(1 << 30) if window is None else window, prefix_len=prefix)
    want = torch.from_numpy(np.asarray(want, np.float32)).bfloat16()
    ok, err = fa.flash_within_tolerance(got, want, q, k, v, **kw)
    assert ok, err
    # without the prefix the early rows differ: the prefix is not a no-op
    if prefix < s or window is not None:
        bare = fa.flash_attention_ref(q, k, v, causal=True, window=window,
                                      cap=50.0)
        assert float((bare.float() - plain.float()).abs().max()) > 0.05


def test_emulation_tiles_fit_wgmma():
    # the source's plans are the wrapper's; up to three consumer
    # warpgroups of wgmma's M = 64 rows; keys a tile are a wgmma N that
    # the kernel issues (64 or 128) and a multiple of its K = 16; head dim
    # 256 keeps PR 16's two warpgroups of 64-key tiles
    assert set(WGMMA_PLANS) == set(fa.HEAD_DIMS)
    for hd, (consumers, keys) in WGMMA_PLANS.items():
        assert fa.WGMMA_PLANS[hd] == dict(consumers=consumers, keys=keys)
        assert 1 <= consumers <= 3 and keys in (64, 128) and keys % 16 == 0
    assert WGMMA_PLANS[256] == (2, 64)


# -- the launch plan and the key split ---------------------------------------

# (label, (b, s, t, hq, hkv, hd, causal, window, prefix), (rows, keys, parts))
PLAN_CASES = [
    # whisper-medium at batch 4, prompt 64 (16/16 heads of 64): the encoder
    # takes 192-row blocks; the decoder's self-attention, its cross-
    # attention and a decode step's one-query cross-attention have S·G <=
    # 64 (one warpgroup); 64 blocks fill half the card, so no split
    ("whisper encoder", (4, 1500, 1500, 16, 16, 64, False, None, 0),
     (192, 128, 1)),
    ("whisper self", (4, 64, 64, 16, 16, 64, True, None, 0), (64, 128, 1)),
    ("whisper cross", (4, 64, 1500, 16, 16, 64, False, None, 0),
     (64, 128, 1)),
    ("whisper decode cross", (4, 1, 1500, 16, 16, 64, False, None, 0),
     (64, 128, 1)),
    # at batch 1 its 16 blocks leave most SMs idle: 6 parts of 2 tiles
    ("whisper decode cross, batch 1", (1, 1, 1500, 16, 16, 64, False, None,
                                       0), (64, 128, 6)),
    ("whisper cross, batch 1", (1, 64, 1500, 16, 16, 64, False, None, 0),
     (64, 128, 6)),
    # head dim 128: the served qwen1.5-32b, arctic-480b, dbrx-132b layers
    ("qwen1.5-32b", (2, 512, 512, 40, 40, 128, True, None, 0), (192, 64, 1)),
    # arctic-480b: 3-warpgroup blocks would run two rounds of 160 on 132 SMs
    ("arctic-480b", (2, 256, 256, 56, 8, 128, True, None, 0), (128, 64, 1)),
    ("dbrx-132b", (2, 256, 256, 48, 8, 128, True, None, 0), (192, 64, 1)),
    # head dim 256 keeps PR 16's plan, even where few blocks walk a long
    # key range or S·G is below 64
    ("gemma2-2b global", (2, 6144, 6144, 8, 4, 256, True, None, 0),
     (128, 64, 1)),
    ("hd 256, one query", (1, 1, 4096, 8, 8, 256, False, None, 0),
     (128, 64, 1)),
    ("paligemma-3b", (2, 512, 512, 8, 1, 256, True, None, 256), (128, 64, 1)),
    # short key ranges are never cut: a part keeps at least 2 tiles
    ("short keys", (1, 1, 384, 4, 4, 64, False, None, 0), (64, 128, 1)),
    # the card's split cases (tests/test_torch_cuda.py FLASH_CASES) do split
    # (few blocks: one warpgroup each, so that more SMs share them)
    ("causal, few rows", (1, 1024, 1024, 1, 1, 64, True, None, 0),
     (64, 128, 4)),
    ("causal window", (1, 1024, 1024, 2, 1, 128, True, 600, 0),
     (64, 64, 4)),
    ("rows with no key", (1, 1000, 600, 2, 1, 64, True, 50, 0),
     (64, 128, 2)),
    ("S·G <= 64, long T", (2, 40, 3000, 8, 8, 128, False, None, 0),
     (64, 64, 8)),
]


@pytest.mark.parametrize("label,shape,want",
                         PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_flash_plan_on_the_path_shapes(label, shape, want):
    b, s, t, hq, hkv, hd, causal, window, prefix = shape
    got = fa.flash_plan(b, s, t, hq, hkv, hd, causal=causal, window=window,
                        prefix_len=prefix, sm_count=132)
    assert tuple(got) == want, (label, got)
    # the meta default is the H100's 132 SMs; a card with more SMs takes
    # blocks of no more rows, and never cuts a part below 2 tiles
    assert fa.flash_plan(b, s, t, hq, hkv, hd, causal=causal, window=window,
                         prefix_len=prefix) == got
    more = fa.flash_plan(b, s, t, hq, hkv, hd, causal=causal, window=window,
                         prefix_len=prefix, sm_count=1000)
    assert more.rows <= got.rows and more.keys == got.keys
    assert more.parts == 1 or more.parts * 2 <= -(-t // more.keys)


# (b, s, t, hq, hkv, hd, causal, window, cap, parts): the key split where a
# part holds only masked keys or nothing, and where rows have no valid key
SPLIT_SHAPES = [
    (1, 200, 200, 2, 1, 64, True, None, None, 4),    # parts past the diagonal; an empty part
    (2, 300, 300, 4, 2, 64, True, 40, 50.0, 3),      # a window: parts wholly before it
    (1, 200, 50, 4, 2, 64, True, 20, None, 2),       # rows with no key; one tile, 2 parts
    (1, 200, 50, 4, 2, 64, False, 10, 50.0, 3),      # the same, not causal
    (1, 150, 600, 4, 2, 128, False, None, None, 3),  # 128-key tiles
    (1, 400, 400, 2, 1, 128, True, 100, 30.0, 4),    # causal window, 128-key tiles
    (2, 3, 700, 10, 2, 64, False, None, None, 5),    # S·G = 15: one warpgroup
]


@pytest.mark.parametrize("b,s,t,hq,hkv,hd,causal,window,cap,parts",
                         SPLIT_SHAPES)
def test_wgmma_split_within_contract_bf16(lmref, b, s, t, hq, hkv, hd, causal,
                                          window, cap, parts):
    """A split launch's arithmetic (each part from the -1e30 sentinel, the
    parts merged by log-sum-exp) against the reference's oracle and the
    port's plain version, within K6's contract and row bound."""
    import jax.numpy as jnp

    arrays = _qkv(b, s, hq, hkv, hd, seed=3 * s + t + parts, t=t)
    q, k, v = _torch16(arrays, torch.bfloat16)
    kw = dict(causal=causal, window=window, cap=cap)
    got = _emulate_wgmma_kernel(q, k, v, parts=parts, **kw)
    assert bool(torch.isfinite(got.float()).all())
    ok, err = fa.flash_within_tolerance(got, fa.flash_attention_ref(
        q, k, v, **kw), q, k, v, **kw)
    assert ok, err
    rows = fa.flash_row_rms(got, q, k, v, **kw)
    assert float(rows.max()) <= fa.ROW_RMS_BOUND[torch.bfloat16]
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))
    want = torch.from_numpy(np.asarray(lmref.flashref.flash_attention_ref(
        jq, jk, jv, **kw), np.float32)).bfloat16()
    ok, err = fa.flash_within_tolerance(got, want, q, k, v, **kw)
    assert ok, err


@pytest.mark.parametrize("b,s,t,hq,hkv,hd,causal,window,cap,parts",
                         SPLIT_SHAPES)
def test_wgmma_split_equals_one_pass(b, s, t, hq, hkv, hd, causal, window,
                                     cap, parts):
    """In fp32 (no rounding of P or of the output) a split visits the same
    keys as one pass and differs only in the order of its sums: masked
    parts are wiped and rows with no valid key keep their uniform average."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, s, hq, hkv, hd, seed=parts,
                                                  t=t))
    kw = dict(causal=causal, window=window, cap=cap)
    one = _emulate_wgmma_kernel(q, k, v, parts=1, **kw)
    split = _emulate_wgmma_kernel(q, k, v, parts=parts, **kw)
    np.testing.assert_allclose(split.numpy(), one.numpy(), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(one.numpy(), fa.flash_attention_ref(
        q, k, v, **kw).numpy(), rtol=2e-5, atol=2e-5)


def test_wgmma_split_with_prefix_within_contract():
    """A split with the bidirectional prefix and a window (two intervals of
    valid keys a row, parts between them wholly masked) against the plain
    version."""
    q, k, v = _torch16(_qkv(1, 300, 4, 2, 64, seed=17), torch.bfloat16)
    kw = dict(causal=True, window=16, cap=50.0, prefix_len=129)
    got = _emulate_wgmma_kernel(q, k, v, parts=4, **kw)
    ok, err = fa.flash_within_tolerance(got, fa.flash_attention_ref(
        q, k, v, **kw), q, k, v, **kw)
    assert ok, err
    assert float(fa.flash_row_rms(got, q, k, v, **kw).max()) \
        <= fa.ROW_RMS_BOUND[torch.bfloat16]
