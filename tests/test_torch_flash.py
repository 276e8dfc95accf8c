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
"""

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


def test_non_cpu_requests_raise_without_a_card():
    q = torch.empty(1, 8, 4, 64, device="meta")
    k = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa.flash_attention_kernel(q, k, k)
    pos = torch.arange(8, device="meta")
    # cases the kernel does not take raise before any device work
    with pytest.raises(NotImplementedError, match="prefix_len"):
        port_layers.attention(q, k, k, q_pos=pos, k_pos=pos, prefix_len=2)
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
