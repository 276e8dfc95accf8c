"""The port's ssm family (mamba2) equals the reference's.

``ssd_chunked`` (S a multiple of the chunk, S off it, S below it, and the
final state), ``ssd_decode_step`` and both ``causal_conv`` paths against
``repro.models.ssm`` on seeded inputs; the reduced mamba2-780m in fp32 with
the reference's own weights (``params_from_jax``): ``prefill`` logits and
every cache leaf, several ``decode_step``s, ``greedy_generate``'s tokens
and ``apply_train``; the parameter round trips; ``launch.serve_lm`` on the
CPU.

Tolerances: single functions 1e-5 (the same fp32 arithmetic, the
three-operand einsums split in two); model logits and caches 2e-4 (as
``MODEL_TOL`` of ``tests/test_torch_lm.py``); tokens exactly.
"""

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.launch import serve_lm
from repro_torch.models import convert
from repro_torch.models import registry
from repro_torch.models import ssm
from repro_torch.train.serve_step import greedy_generate

ARCH = "mamba2-780m"
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = -rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    return x, a, bm, cm


@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16), (10, 16), (37, 8)])
def test_ssd_chunked_matches_reference(lmref, s, chunk):
    import jax.numpy as jnp

    x, a, bm, cm = _ssd_inputs(2, s, 3, 8, 5, seed=s + chunk)
    y_want, h_want = lmref.ssm.ssd_chunked(*map(jnp.asarray, (x, a, bm, cm)),
                                           chunk)
    y, h = ssm.ssd_chunked(*map(torch.from_numpy, (x, a, bm, cm)), chunk)
    assert y.shape == (2, s, 3, 8) and h.shape == (2, 3, 8, 5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)


def test_ssd_decode_step_matches_reference_and_the_scan(lmref):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    state = rng.standard_normal((2, 3, 8, 5)).astype(np.float32)
    x, a, bm, cm = _ssd_inputs(2, 1, 3, 8, 5, seed=4)
    want_s, want_y = lmref.ssm.ssd_decode_step(
        jnp.asarray(state), jnp.asarray(x[:, 0]), jnp.asarray(a[:, 0]),
        jnp.asarray(bm[:, 0]), jnp.asarray(cm[:, 0]))
    got_s, got_y = ssm.ssd_decode_step(
        torch.from_numpy(state), torch.from_numpy(x[:, 0]),
        torch.from_numpy(a[:, 0]), torch.from_numpy(bm[:, 0]),
        torch.from_numpy(cm[:, 0]))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    # steps from a zero state give the chunked scan's outputs and state
    x, a, bm, cm = map(torch.from_numpy, _ssd_inputs(2, 21, 3, 8, 5, seed=5))
    y_scan, h_scan = ssm.ssd_chunked(x, a, bm, cm, 8)
    st = torch.zeros(2, 3, 8, 5)
    for t in range(21):
        st, y_t = ssm.ssd_decode_step(st, x[:, t], a[:, t], bm[:, t], cm[:, t])
        np.testing.assert_allclose(y_t.numpy(), y_scan[:, t].numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), h_scan.numpy(), **TOL)


@pytest.mark.parametrize("path", ["sequence", "step"])
def test_causal_conv_matches_reference(lmref, path):
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    if path == "sequence":
        for s in (1, 2, 9):
            x = rng.standard_normal((2, s, 12)).astype(np.float32)
            y_want, tail_want = lmref.ssm._causal_conv(jnp.asarray(x),
                                                       jnp.asarray(w))
            y, tail = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w))
            np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
            np.testing.assert_array_equal(tail.numpy(), np.asarray(tail_want))
        return
    x = rng.standard_normal((2, 1, 12)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 12)).astype(np.float32)
    y_want, c_want = lmref.ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(cache))
    y, c = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(cache))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_want))


def _models(lmref, seed):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(ARCH)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(ARCH))
    jparams = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.params_from_jax(_np_tree(jparams), cfg))
    return jmodel, jparams, model


def test_mamba_serving_matches_reference(lmref):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=1)
    assert isinstance(model, ssm.MambaLM)
    cfg = model.cfg
    b, s, steps = 2, 40, 6  # chunk 16: the last of three chunks is padded
    max_len = s + steps + 1
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, max_len))(jparams, jnp.asarray(tokens))
    tt = torch.from_numpy(tokens).long()
    logits, cache = model.prefill({"tokens": tt}, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    assert cache["pos"] == int(jcache["pos"]) == s
    for key in ("ssm", "conv"):
        assert tuple(cache[key].shape) == jcache[key].shape
        assert cache[key].dtype == torch.float32
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **MODEL_TOL)
    jstep = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    for i in range(steps):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(feed[i]))
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
        assert cache["pos"] == int(jcache["pos"]) == s + i + 1
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **MODEL_TOL)
    want = jax.jit(lambda p, t: lmref.serve_step.greedy_generate(
        jmodel, cfg, p, {"tokens": t}, steps=steps, max_len=max_len))(
            jparams, jnp.asarray(tokens))
    got = greedy_generate(model, cfg, {"tokens": tt}, steps=steps,
                          max_len=max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mamba_apply_train_matches_reference_and_decode(lmref):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=4)
    tokens = np.random.default_rng(8).integers(
        0, model.cfg.vocab, size=(2, 36)).astype(np.int32)
    want, _ = jax.jit(jmodel.apply_train)(jparams,
                                          {"tokens": jnp.asarray(tokens)})
    tt = torch.from_numpy(tokens).long()
    got, aux = model.apply_train({"tokens": tt})
    assert got.shape == (2, 36, model.cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    # decode after prefill(S - 1) reproduces the forward's last logits
    _, cache = model.prefill({"tokens": tt[:, :-1]}, 40)
    dl, _ = model.decode_step(cache, tt[:, -1:])
    np.testing.assert_allclose(dl[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=5e-5, atol=5e-5)


def test_mamba_params_round_trip_and_keep_dtypes(lmref):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(ARCH)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(ARCH))
    tree = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.float32))
    sd = convert.params_from_jax(tree, cfg)
    model = ssm.MambaLM(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(sd)
    back = convert.params_to_jax(model.state_dict(), cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b), path
    # a bf16 tree: A_log, D and dt_bias stay fp32, the rest bf16, bit for bit
    tree16 = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.bfloat16))
    sd16 = convert.params_from_jax(tree16, cfg)
    model16 = ssm.MambaLM(cfg, device="cpu", dtype=torch.bfloat16)
    for name, p in model16.state_dict().items():
        assert sd16[name].dtype == p.dtype, name
    model16.load_state_dict(sd16)
    for name in ("A_log", "D", "dt_bias"):
        assert sd16[f"layers.0.{name}"].dtype == torch.float32
    back16 = convert.params_to_jax(model16.state_dict(), cfg)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree16)[0],
            jax.tree_util.tree_flatten_with_path(back16)[0]):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    with pytest.raises(ValueError, match="num_layers"):
        convert.params_from_jax(tree, cfg.replace(num_layers=3))
    with pytest.raises(ValueError, match="not the ssm model's"):
        convert.params_from_jax(dict(tree, dec_pos=tree["embed"]), cfg)


def test_mamba_init_draws_the_reference_distributions():
    cfg = registry.get_reduced_config(ARCH).replace(vocab=4096)
    model = ssm.MambaLM(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    p = model.layers[0]
    assert abs(float(model.embed.std()) - 0.02) < 0.001
    assert abs(float(p["conv_w"].std()) - 0.1) < 0.01
    assert abs(float(p["in_proj"]["w"].std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert float(p["A_log"].abs().max()) == 0.0
    assert torch.equal(p["D"], torch.ones(model.h))
    assert float(p["dt_bias"].abs().max()) == 0.0


def test_serve_lm_serves_mamba_on_cpu(capsys):
    assert serve_lm.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "20",
                          "--tokens", "5"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced batch=2 prompt=20 generated=5/seq" in out
