"""The port's int8 KV cache equals the reference's.

``quantize_kv`` / ``dequantize_kv`` against ``repro.models.layers``' on
random rows, zero rows (the 1e-6 floor), exact .5 ties (half to even) and
values at ±127: the int8 values and the bf16 scales bit for bit, the
dequantized values exactly. The reduced qwen1.5-32b (``kv_cache_dtype=
"int8"``) in fp32, loaded with the reference's own weights: prefill logits
and every decode step's logits within 2e-4, the greedy tokens exactly, and
the int8 caches equal up to the rounding of a quantisation step: where the
port's fp32 k or v differs from the reference's in its last bits, an int8
value may land one step over (at most 1 of 1,000 elements may, and none by
more than one) and its bf16 scale one bf16 step over (at most 1 of 1,000).
A decode past the cache raises, where the reference clamps (R12).

Tolerances: logits 2e-4 (four fp32 layers, sums in another order, as
``tests/test_torch_lm.py``); the quantiser itself exactly.
"""

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.transformer import TransformerLM
from repro_torch.train.serve_step import greedy_generate

ARCH = "qwen1.5-32b"
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
# the share of int8 cache elements (and of bf16 scales) that may sit one
# step from the reference's where the fp32 k and v differ in their last bits
STEP_SHARE = 1e-3


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _bf16_bits(x) -> np.ndarray:
    """The 16 bits of a bf16 array (torch or ml_dtypes)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _cases():
    rng = np.random.default_rng(0)
    normal = rng.standard_normal((3, 7, 4, 16)).astype(np.float32)
    wide = (rng.standard_normal((2, 5, 2, 64)) * 10.0 ** rng.integers(
        -8, 8, size=(2, 5, 2, 1))).astype(np.float32)
    zeros = normal.copy()
    zeros[0, :3] = 0.0                      # whole zero rows: the 1e-6 floor
    zeros[1, 2, 1] = 1e-9                   # a row below the floor
    ties = np.zeros((2, 8), np.float32)
    ties[0] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5, -126.5]  # scale 1
    ties[1] = [-254.0, 5.0, -7.0, 1.0, 3.0, -1.0, 253.0, -253.0]  # scale 2
    extremes = rng.standard_normal((4, 32)).astype(np.float32)
    extremes[:, 3] = 50.0                   # +127 at the abs-max
    extremes[:, 9] = -50.0                  # and -127 beside it
    extremes[1, 5] = -50.0000038            # the max is the negative one
    return {"normal": normal, "wide": wide, "zeros": zeros, "ties": ties,
            "extremes": extremes}


@pytest.mark.parametrize("case", sorted(_cases()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(lmref, case, dtype):
    import jax.numpy as jnp

    x = _cases()[case]
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = lmref.layers.quantize_kv(jx)
    q, scale = L.quantize_kv(tx)
    assert q.dtype == torch.int8 and scale.dtype == torch.bfloat16
    assert tuple(q.shape) == jq.shape and tuple(scale.shape) == js.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bf16_bits(scale), _bf16_bits(js))
    for out in ("float32", "bfloat16"):
        want = lmref.layers.dequantize_kv(jq, js, getattr(jnp, out))
        got = L.dequantize_kv(q, scale, getattr(torch, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    if case == "ties":  # half to even, and the ends of the range
        assert q.numpy().tolist() == [[127, 2, -4, 0, 2, 0, 126, -126],
                                      [-127, 2, -4, 0, 2, 0, 126, -126]]
    if case == "extremes":
        assert int(q.max()) == 127 and int(q.min()) == -127
    if case == "zeros":
        assert not q.numpy()[0, :3].any()


def test_quantize_kv_divides_by_the_scale(lmref):
    """round(x / scale), not round(x * (1 / scale)): on this row the two
    give 51 and 50 at element 13."""
    import jax.numpy as jnp

    row = [-1.0273442268371582, 0.28761720657348633, 5.752987384796143,
           0.11865702271461487, -3.489469289779663, -3.76672625541687,
           -0.7159720659255981, 1.126173496246338, -2.898249387741089,
           -1.381134271621704, 5.216073036193848, -3.47200608253479,
           -2.735201358795166, 2.2876052856445312, -2.7429757118225098,
           -0.16181626915931702]
    x = torch.tensor([row], dtype=torch.float32)
    q, _ = L.quantize_kv(x)
    scale = x.abs().amax() / 127.0
    assert int(q[0, 13]) == 51 == int(torch.round(x[0, 13] / scale))
    assert int(torch.round(x[0, 13] * (1.0 / scale))) == 50
    jq, _ = lmref.layers.quantize_kv(jnp.asarray(x.numpy()))
    assert int(jq[0, 13]) == 51


def _models(lmref, seed=1):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(ARCH)
    assert cfg.kv_cache_dtype == "int8"
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(ARCH))
    jparams = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    model = TransformerLM(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.params_from_jax(_np_tree(jparams), cfg))
    return jmodel, jparams, model


def _assert_caches_close(cache, jcache):
    """int8 values: at most one step apart, at most STEP_SHARE of them;
    bf16 scales: at most one bf16 step apart, at most STEP_SHARE of them."""
    for key in ("k", "v"):
        got = cache[key].numpy().astype(np.int32)
        want = np.asarray(jcache[key]).astype(np.int32)
        assert got.shape == want.shape and cache[key].dtype == torch.int8
        off = np.abs(got - want)
        assert off.max() <= 1, key
        assert (off > 0).mean() <= STEP_SHARE, (key, (off > 0).mean())
        sc = cache[key + "_scale"]
        assert sc.dtype == torch.bfloat16
        bits = _bf16_bits(sc).astype(np.int32)
        jbits = _bf16_bits(jcache[key + "_scale"]).astype(np.int32)
        assert np.abs(bits - jbits).max() <= 1, key
        assert (bits != jbits).mean() <= STEP_SHARE, key


def test_int8_serving_matches_reference(lmref):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref)
    cfg = model.cfg
    b, s, steps = 2, 40, 6
    max_len = s + steps + 1
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, max_len))(jparams, jnp.asarray(tokens))
    tt = torch.from_numpy(tokens).long()
    logits, cache = model.prefill({"tokens": tt}, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    assert cache["pos"] == int(jcache["pos"]) == s
    assert sorted(cache) == sorted(jcache)
    _assert_caches_close(cache, jcache)
    jstep = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    for i in range(steps):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(feed[i]))
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
        assert cache["pos"] == int(jcache["pos"]) == s + i + 1
    _assert_caches_close(cache, jcache)
    want = jax.jit(lambda p, t: lmref.serve_step.greedy_generate(
        jmodel, cfg, p, {"tokens": t}, steps=steps, max_len=max_len))(
            jparams, jnp.asarray(tokens))
    got = greedy_generate(model, cfg, {"tokens": tt}, steps=steps,
                          max_len=max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_cache_layout_matches_reference(lmref):
    jmodel, _, model = _models(lmref)
    want = jmodel.init_cache(3, 11)
    got = model.init_cache(3, 11)
    assert sorted(got) == sorted(want)
    for key in ("k", "v", "k_scale", "v_scale"):
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).replace("torch.", "") == str(
            want[key].dtype), key
        assert not got[key].float().abs().max()
    assert got["pos"] == int(want["pos"]) == 0


def test_decode_reads_its_own_quantized_kv():
    """The new token's k and v are written quantized before it attends, and
    the stored values lie within one quantisation step of the bf16 ones."""
    cfg = registry.get_reduced_config(ARCH)
    model = TransformerLM(cfg, device="cpu", dtype=torch.bfloat16)
    model.init(torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(4))
    _, cache = model.prefill({"tokens": tokens}, 12)
    x = model._embed_tokens(tokens)
    p = model.blocks[0]
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    k = L.dense(p["attn"]["wk"], h).reshape(2, 9, cfg.kv_heads, cfg.head_dim)
    k = L.rope(k, torch.arange(9)[None, :], cfg.rope_theta)
    q, scale = L.quantize_kv(k)
    assert torch.equal(cache["k"][0, :, :9], q)
    assert torch.equal(cache["k_scale"][0, :, :9], scale)
    back = L.dequantize_kv(q, scale, torch.float32)
    assert bool(((back - k.float()).abs()
                 <= scale.float()[..., None]).all())
    model.decode_step(cache, tokens[:, :1])
    assert cache["pos"] == 10 and bool(cache["k_scale"][:, :, 9].abs().min() > 0)


def test_decode_past_the_cache_raises_where_the_reference_clamps(lmref):
    """R12: the reference's dynamic_update_slice clamps a position past the
    cache and overwrites the last slot; the port raises."""
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=2)
    tokens = np.arange(16, dtype=np.int32).reshape(2, 8) % model.cfg.vocab
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, 8)
    jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tokens[:, :1]))
    assert int(jcache["pos"]) == 9 and bool(jnp.isfinite(jl).all())
    _, cache = model.prefill({"tokens": torch.from_numpy(tokens).long()}, 8)
    with pytest.raises(ValueError, match="cache holds 8 slots"):
        model.decode_step(cache, torch.from_numpy(tokens[:, :1]).long())
    with pytest.raises(ValueError, match="max_len"):
        model.prefill({"tokens": torch.from_numpy(tokens).long()}, 7)
    with pytest.raises(ValueError, match="cache holds"):
        greedy_generate(model, model.cfg,
                        {"tokens": torch.from_numpy(tokens).long()}, steps=2,
                        max_len=9)
