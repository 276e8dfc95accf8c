"""The port's encdec family (whisper) equals the reference's.

The encoder's sinusoid and ``WhisperModel.encode``; the cross-attention
(non-causal, S != T) through the port's ``layers.attention`` (the chunked
path a CPU tensor takes) and K6's plain version against the reference's
``layers.attention``; the reduced whisper-medium in fp32 with the
reference's own weights (``params_from_jax``): ``prefill`` logits and every
cache leaf (self and cross K/V), several ``decode_step``s,
``greedy_generate``'s tokens and ``apply_train``; the parameter round trips;
R12: where the cache is too small, the reference's decode clamps its write
and its logits drift, where the port raises, as it does past the
65,536-row decoder position table; ``launch.serve_lm`` on the CPU.

Tolerances: the sinusoid one fp32 ulp of its largest angle (t·2⁻²³);
attention 2e-5 (fp32, sums in another order, as
``tests/test_torch_flash.py``); model logits and caches 2e-4 (as
``MODEL_TOL`` of ``tests/test_torch_lm.py``); tokens exactly.
"""

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve_lm
from repro_torch.models import convert
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.train.serve_step import greedy_generate

ARCH = "whisper-medium"
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _models(lmref, seed):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(ARCH)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(ARCH))
    jparams = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.params_from_jax(_np_tree(jparams), cfg))
    return jmodel, jparams, model


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    frames = rng.standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return tokens, frames


def test_sinusoid_and_encode_match_reference(lmref):
    import jax
    import jax.numpy as jnp

    # the angles reach t radians: one fp32 ulp of t (t·2⁻²³) in an angle
    # (a pow rounded the other way) moves its sine by as much
    for t, d in ((16, 64), (1500, 1024)):
        np.testing.assert_allclose(encdec.sinusoid(t, d).numpy(),
                                   np.asarray(lmref.encdec._sinusoid(t, d)),
                                   rtol=0, atol=t * 2.0 ** -23)
    jmodel, jparams, model = _models(lmref, seed=3)
    _, frames = _batch(model.cfg, 2, 4, seed=1)
    want = jax.jit(jmodel.encode)(jparams, jnp.asarray(frames))
    got = model.encode(torch.from_numpy(frames))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


# (b, s, t, hq, hkv, hd): the decoder's prefill and decode cross-attention
CROSS_CASES = [(2, 24, 16, 4, 4, 64), (2, 1, 16, 4, 4, 64),
               (1, 7, 1500, 4, 2, 64), (1, 1, 1500, 16, 16, 64)]


@pytest.mark.parametrize("b,s,t,hq,hkv,hd", CROSS_CASES)
def test_cross_attention_matches_reference(lmref, b, s, t, hq, hkv, hd):
    import jax.numpy as jnp

    rng = np.random.default_rng(s + t)
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
            for _ in range(2))
    want = np.array(lmref.layers.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.arange(s),
        k_pos=jnp.arange(t), causal=False))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(L.attention(tq, tk, tv, causal=False).numpy(),
                               want, **ATTN_TOL)
    # K6's plain version, which the dispatch's kernel holds to, and the
    # kernel backend on a CPU tensor (its plain version, no launch)
    fa.reset_launch_counts()
    for backend in fa.BACKENDS:
        got = fa.flash_attention(tq, tk, tv, causal=False, backend=backend)
        np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    assert fa.LAUNCHES["flash_attention"] == 0
    ok, err = fa.flash_within_tolerance(
        torch.from_numpy(want), fa.flash_attention_ref(tq, tk, tv,
                                                       causal=False),
        tq, tk, tv, causal=False)
    assert ok, err


def test_whisper_serving_matches_reference(lmref):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=1)
    assert isinstance(model, encdec.WhisperModel)
    cfg = model.cfg
    b, s, steps = 2, 40, 6
    max_len = s + steps + 1
    tokens, frames = _batch(cfg, b, s, seed=5)
    jbatch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "frames": torch.from_numpy(frames)}
    jlogits, jcache = jax.jit(lambda p, bt: jmodel.prefill(
        p, bt, max_len))(jparams, jbatch)
    logits, cache = model.prefill(batch, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    assert cache["pos"] == int(jcache["pos"]) == s
    for key in ("k", "v", "xk", "xv"):
        assert tuple(cache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **MODEL_TOL)
    jstep = jax.jit(jmodel.decode_step)
    feed = np.random.default_rng(6).integers(
        0, cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    for i in range(steps):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(feed[i]))
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
        assert cache["pos"] == int(jcache["pos"]) == s + i + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **MODEL_TOL)
    want = jax.jit(lambda p, bt: lmref.serve_step.greedy_generate(
        jmodel, cfg, p, bt, steps=steps, max_len=max_len))(jparams, jbatch)
    got = greedy_generate(model, cfg, batch, steps=steps, max_len=max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_whisper_apply_train_matches_reference_and_decode(lmref):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=4)
    tokens, frames = _batch(model.cfg, 2, 20, seed=8)
    want, _ = jax.jit(jmodel.apply_train)(
        jparams, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    tt, tf = torch.from_numpy(tokens).long(), torch.from_numpy(frames)
    got, aux = model.apply_train({"tokens": tt, "frames": tf})
    assert got.shape == (2, 20, model.cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    # decode after prefill(S - 1) reproduces the forward's last logits
    _, cache = model.prefill({"tokens": tt[:, :-1], "frames": tf}, 24)
    dl, _ = model.decode_step(cache, tt[:, -1:])
    np.testing.assert_allclose(dl[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=5e-5, atol=5e-5)


def test_whisper_cache_past_max_len_raises_where_the_reference_clamps(lmref):
    """R12 in the self cache: with S + 2 slots the reference's decode steps
    3 and 4 overwrite the last slot and read the position table where it
    clamps nothing, so their logits drift from those of a large cache; the
    port raises at step 3, and past the position table."""
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=2)
    cfg = model.cfg
    b, s = 2, 12
    tokens, frames = _batch(cfg, b, s, seed=3)
    jbatch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    feed = np.arange(4 * b, dtype=np.int32).reshape(4, b, 1) % cfg.vocab
    runs = []
    for max_len in (s + 2, s + 10):
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
             "frames": torch.from_numpy(frames)}
    _, cache = model.prefill(batch, s + 2)
    for i in range(2):
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
    np.testing.assert_allclose(lg.numpy(), runs[1][1], **MODEL_TOL)
    with pytest.raises(ValueError, match="cache holds"):
        model.decode_step(cache, torch.from_numpy(feed[2]).long())
    with pytest.raises(ValueError, match="exceeds max_len"):
        model.prefill(batch, s - 1)
    with pytest.raises(ValueError, match="encoder_seq"):
        model.prefill(dict(batch, frames=batch["frames"][:, 1:]), s)
    # the 65,536-row position table: its last row decodes, the next raises
    assert encdec.MAX_DECODE_POS == lmref.encdec._MAX_DECODE_POS == 65536
    cache = model.init_cache(1, encdec.MAX_DECODE_POS + 1)
    cache["pos"] = encdec.MAX_DECODE_POS - 1
    tok = torch.zeros(1, 1, dtype=torch.long)
    lg, cache = model.decode_step(cache, tok)
    assert lg.shape == (1, 1, cfg.padded_vocab)
    with pytest.raises(ValueError, match="position table"):
        model.decode_step(cache, tok)
    with pytest.raises(ValueError, match="position table"):
        model.apply_train({"tokens": torch.zeros(
            1, encdec.MAX_DECODE_POS + 1, dtype=torch.long),
            "frames": batch["frames"][:1]})


def test_whisper_params_round_trip_and_keep_dtypes(lmref):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(ARCH)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(ARCH))
    tree = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.float32))
    sd = convert.params_from_jax(tree, cfg)
    assert tuple(sd["dec_pos"].shape) == (65536, cfg.d_model)
    assert "dec_layers.2.xattn.wq.w" in sd and "enc_layers.1.mlp.wi.w" in sd
    model = encdec.WhisperModel(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(sd)
    back = convert.params_to_jax(model.state_dict(), cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b), path
    tree16 = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.bfloat16))
    sd16 = convert.params_from_jax(tree16, cfg)
    assert all(t.dtype == torch.bfloat16 for t in sd16.values())
    model16 = encdec.WhisperModel(cfg, device="cpu", dtype=torch.bfloat16)
    model16.load_state_dict(sd16)
    np.testing.assert_array_equal(model16.dec_pos.float().numpy(),
                                  np.asarray(tree16["dec_pos"], np.float32))
    with pytest.raises(ValueError, match="encoder_layers"):
        convert.params_from_jax(tree, cfg.replace(encoder_layers=3))
    with pytest.raises(ValueError, match="num_layers"):
        convert.params_from_jax(tree, cfg.replace(num_layers=2))
    with pytest.raises(ValueError, match="not the encdec model's"):
        convert.params_from_jax(dict(tree, layers={}, groups={"x": tree[
            "embed"]}), cfg)


def test_whisper_init_draws_the_reference_distributions():
    cfg = registry.get_reduced_config(ARCH).replace(vocab=4096)
    model = encdec.WhisperModel(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    assert abs(float(model.embed.std()) - 0.02) < 0.001
    assert abs(float(model.dec_pos.std()) - 0.01) < 0.0005
    assert "wg" not in model.dec_layers[0]["mlp"]
    wk = model.dec_layers[1]["xattn"]["wk"]["w"]
    assert abs(float(wk.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    assert float(model.enc_layers[0]["ln1"]["scale"].abs().max()) == 0.0


def test_serve_lm_serves_whisper_on_cpu(capsys):
    assert serve_lm.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "20",
                          "--tokens", "5"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced batch=2 prompt=20 generated=5/seq" in out
    assert "audio frames: 16 of width 64" in out
