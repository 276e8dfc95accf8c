"""The port's VLM family (paligemma) and prefix attention equal the
reference's.

Prefix attention: the port's K6 plain version ``flash_attention_ref(
prefix_len=)`` (through the dispatch on a CPU tensor too) and the chunked
``layers.attention(prefix_len=)`` against the reference's
``layers.attention(prefix_len=)``, causal, with and without a window, with
a prefix inside one tile, across tiles and past the sequence. The reduced
paligemma-3b in fp32 with the reference's own weights: ``apply_train``
(text logits only), ``prefill`` over all P + S positions and its cache,
every ``decode_step``'s logits and ``greedy_generate``'s tokens;
``params_from_jax`` round-trips the tree with ``vision_proj``. R12: where
the cache is too small, the reference's decode overwrites its last slot
and its logits drift from those of a larger cache; the port raises.

Tolerances: attention 2e-5 (fp32, sums in another order, as
``tests/test_torch_flash.py``); model logits and caches 2e-4 (as
``tests/test_torch_lm.py``); tokens exactly.
"""

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve_lm
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.transformer import TransformerLM
from repro_torch.train.serve_step import greedy_generate

ARCH = "paligemma-3b"
TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


# (b, s, hq, hkv, hd, window, prefix, cap)
PREFIX_CASES = [
    (2, 40, 4, 1, 64, None, 8, None),      # paligemma's MQA, a short prefix
    (1, 150, 8, 1, 64, None, 70, 50.0),    # P across tiles and chunks
    (2, 48, 4, 2, 64, 6, 20, None),        # a window beside the prefix
    (1, 36, 4, 2, 128, 12, 36, 30.0),      # P = S
    (1, 36, 4, 4, 64, None, 100, None),    # P > S
]


@pytest.mark.parametrize("b,s,hq,hkv,hd,window,prefix,cap", PREFIX_CASES)
def test_prefix_attention_matches_reference(lmref, b, s, hq, hkv, hd, window,
                                            prefix, cap):
    import jax.numpy as jnp

    rng = np.random.default_rng(s + prefix)
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
            for _ in range(2))
    win = L.NO_WINDOW if window is None else window
    pos = jnp.arange(s)
    want = np.array(lmref.layers.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=pos, k_pos=pos,
        window=win, causal=True, prefix_len=prefix, cap=cap, chunk=32))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(causal=True, window=window, cap=cap, prefix_len=prefix)
    np.testing.assert_allclose(fa.flash_attention_ref(tq, tk, tv, **kw).numpy(),
                               want, **TOL)
    fa.reset_launch_counts()
    for backend in fa.BACKENDS:  # a CPU tensor takes the plain version
        np.testing.assert_allclose(
            fa.flash_attention(tq, tk, tv, backend=backend, **kw).numpy(),
            want, **TOL)
    assert fa.LAUNCHES["flash_attention"] == 0
    for chunk in (16, 1024):
        got = L.attention(tq, tk, tv, window=win, prefix_len=prefix, cap=cap,
                          chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    ok, err = fa.flash_within_tolerance(torch.from_numpy(want),
                                        fa.flash_attention_ref(tq, tk, tv, **kw),
                                        tq, tk, tv, **kw)
    assert ok, err


def test_prefix_len_is_checked():
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError, match="prefix_len must be >= 0"):
        fa.flash_attention_kernel(q, q[:, :, :2], q[:, :, :2], prefix_len=-1)


def _models(lmref, seed):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(ARCH)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(ARCH))
    jparams = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    model = TransformerLM(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.params_from_jax(_np_tree(jparams), cfg))
    return jmodel, jparams, model


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    patches = rng.standard_normal(
        (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return tokens, patches


def test_vlm_apply_train_matches_reference(lmref):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=4)
    tokens, patches = _batch(model.cfg, 2, 20, seed=8)
    want, want_aux = jax.jit(jmodel.apply_train)(
        jparams, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)})
    got, aux = model.apply_train({"tokens": torch.from_numpy(tokens).long(),
                                  "patches": torch.from_numpy(patches)})
    assert got.shape == (2, 20, model.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert float(aux) == float(want_aux) == 0.0
    with pytest.raises(ValueError, match="patches"):
        model.apply_train({"tokens": torch.from_numpy(tokens).long()})


def test_vlm_serving_matches_reference(lmref):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=1)
    cfg = model.cfg
    b, s, steps = 2, 24, 6
    p = cfg.vision_tokens
    max_len = p + s + steps + 1
    tokens, patches = _batch(cfg, b, s, seed=5)
    jbatch = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "patches": torch.from_numpy(patches)}
    jlogits, jcache = jax.jit(lambda pr, bt: jmodel.prefill(
        pr, bt, max_len))(jparams, jbatch)
    logits, cache = model.prefill(batch, max_len)
    assert logits.shape == (b, p + s, cfg.padded_vocab) == jlogits.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    assert cache["pos"] == int(jcache["pos"]) == p + s
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **MODEL_TOL)
    jstep = jax.jit(jmodel.decode_step)
    feed = np.random.default_rng(6).integers(
        0, cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    for i in range(steps):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(feed[i]))
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
        assert cache["pos"] == int(jcache["pos"]) == p + s + i + 1
    want = jax.jit(lambda pr, bt: lmref.serve_step.greedy_generate(
        jmodel, cfg, pr, bt, steps=steps, max_len=max_len))(jparams, jbatch)
    got = greedy_generate(model, cfg, batch, steps=steps, max_len=max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the prefix's own logits are the reference's too, and the text ones
    # are apply_train's
    train, _ = model.apply_train(batch)
    np.testing.assert_allclose(logits[:, p:].numpy(), train.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_vlm_cache_past_max_len_raises_where_the_reference_clamps(lmref):
    """R12: with a cache of P + S + 2 slots the reference's decode steps 3
    and 4 overwrite the last slot, so their logits drift from those of a
    large cache; the port raises at step 3."""
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=2)
    cfg = model.cfg
    b, s = 2, 12
    tokens, patches = _batch(cfg, b, s, seed=3)
    jbatch = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}
    full = cfg.vision_tokens + s
    feed = np.arange(4 * b, dtype=np.int32).reshape(4, b, 1) % cfg.vocab
    runs = []
    for max_len in (full + 2, full + 10):
        _, jcache = jmodel.prefill(jparams, jbatch, max_len)
        rows = []
        for i in range(4):
            jl, jcache = jmodel.decode_step(jparams, jcache,
                                            jnp.asarray(feed[i]))
            rows.append(np.asarray(jl))
        runs.append(rows)
    np.testing.assert_allclose(runs[0][1], runs[1][1], **MODEL_TOL)
    assert np.abs(runs[0][3] - runs[1][3]).max() > 1e-3  # the clamped write
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "patches": torch.from_numpy(patches)}
    _, cache = model.prefill(batch, full + 2)
    for i in range(2):
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
    np.testing.assert_allclose(lg.numpy(), runs[1][1], **MODEL_TOL)
    with pytest.raises(ValueError, match="cache holds"):
        model.decode_step(cache, torch.from_numpy(feed[2]).long())
    with pytest.raises(ValueError, match="exceed max_len"):
        model.prefill(batch, full - 1)


def test_vlm_params_round_trip(lmref):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(ARCH)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(ARCH))
    tree = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.float32))
    sd = convert.params_from_jax(tree, cfg)
    assert tuple(sd["vision_proj.w"].shape) == (cfg.vision_dim, cfg.d_model)
    model = TransformerLM(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(sd)
    back = convert.params_to_jax(model.state_dict(), cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b), path
    dense_cfg = registry.get_reduced_config("gemma2-2b")
    with pytest.raises(ValueError, match="vision_proj"):
        convert.params_from_jax(dict(tree, layers={}), dense_cfg)


def test_vlm_init_draws_vision_proj():
    cfg = registry.get_reduced_config(ARCH).replace(vision_dim=400)
    model = TransformerLM(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    w = model.vision_proj["w"]
    assert tuple(w.shape) == (400, cfg.d_model)
    assert abs(float(w.std()) * 400 ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("arch", ["paligemma-3b", "arctic-480b", "dbrx-132b",
                                  "qwen1.5-32b"])
def test_serve_lm_serves_the_new_families_on_cpu(capsys, arch):
    assert serve_lm.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "10",
                          "--tokens", "5"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced batch=2 prompt=10 generated=5/seq" in out
    assert ("image prefix: 8 patch tokens of width 24" in out) == (
        arch == "paligemma-3b")
