"""The port's training pieces against the reference's, piece by piece.

``make_batch`` and ``SyntheticDataset`` (every family's batch bit-equal,
frames and patches included); ``wsd_schedule`` at every phase of the wsd,
cosine and constant schedules (1e-7 relative); ``adamw_update`` on the
same parameter, gradient and moment trees (params, mu and nu within 2 fp32
ulp with fp32 moments, the clip binding or not; bf16 moments bit-equal
where the clip does not bind, so the fp32 values agree before rounding);
``opt_state_from_jax`` / ``opt_state_to_jax`` round trips; the remat
switch (``cfg.remat`` on and off give equal gradients, every family); and
K6's autograd Function ``FlashAttention`` on the CPU (its forward is the
kernel wrapper's plain version, its backward the chunked scan's gradient):
its gradients equal autograd through ``attention(backend="chunked")`` in
each mask mode, and the bare kernel wrapper raises on inputs that require
grad.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import convert, layers as L, registry
from repro_torch.train import data, optimizer, train_step


def _np(tree):
    import jax
    return jax.tree.map(np.array, tree)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_make_batch_bit_equal_to_reference(lmref, arch):
    cfg = registry.get_reduced_config(arch)
    for step in (0, 7):
        dc = (3, 17, 5)
        want = lmref.data.make_batch(
            cfg, lmref.data.SyntheticDataConfig(*dc), step)
        got = data.make_batch(cfg, data.SyntheticDataConfig(*dc), step)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    if cfg.family == "encdec":
        assert got["frames"].shape == (3, cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        assert got["patches"].shape == (3, cfg.vision_tokens, cfg.vision_dim)


def test_synthetic_dataset_seek_and_state(lmref):
    cfg = registry.get_reduced_config("gemma2-2b")
    dc = data.SyntheticDataConfig(2, 9, seed=3)
    ds = data.SyntheticDataset(cfg, dc, start_step=4)
    first = next(ds)
    assert ds.state == 5
    ds.seek(4)
    again = next(ds)
    assert np.array_equal(first["tokens"], again["tokens"])
    ref_ds = lmref.data.SyntheticDataset(
        cfg, lmref.data.SyntheticDataConfig(2, 9, seed=3), start_step=5)
    assert np.array_equal(next(ds)["labels"], next(ref_ds)["labels"])


SCHEDULES = [
    dict(schedule="wsd", warmup_steps=10, stable_steps=20, decay_steps=8),
    dict(schedule="cosine", warmup_steps=10, stable_steps=20, decay_steps=8),
    dict(schedule="constant", warmup_steps=10),
    dict(schedule="wsd", warmup_steps=0, stable_steps=5, decay_steps=0),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_wsd_schedule_matches_reference(lmref, kw):
    """Steps through the warmup, the plateau, the tail and past it."""
    import jax.numpy as jnp

    steps = np.arange(0, 50, dtype=np.int32)
    want = lmref.optimizer.wsd_schedule(
        jnp.asarray(steps), lmref.optimizer.AdamWConfig(peak_lr=3e-4, **kw))
    got = optimizer.wsd_schedule(torch.from_numpy(steps),
                                 optimizer.AdamWConfig(peak_lr=3e-4, **kw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                               atol=0)


def _trees(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 6)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
    mu = {k: (0.01 * rng.standard_normal(s)).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: (1e-4 * rng.random(s)).astype(np.float32)
          for k, s in shapes.items()}
    return params, grads, mu, nu


def _within_ulps(got, want, *terms, ulps=2, rel=0.0):
    """|got − want| ≤ ``ulps`` fp32 ulp of the largest term of the sum that
    made it (a sum of terms of opposite signs keeps its terms' absolute
    error), plus ``rel`` × that term: what a clip scale that differs in its
    last bits carries into the update."""
    big = np.max(np.abs(np.stack(terms)), axis=0).astype(np.float32)
    return bool((np.abs(np.asarray(got, np.float64) - np.asarray(want))
                 <= ulps * np.spacing(big) + rel * big).all())


@pytest.mark.parametrize("grad_scale,step", [(0.01, 0), (1.0, 0), (0.05, 41)],
                         ids=["unclipped", "clipped", "later-step"])
def test_adamw_update_matches_reference_fp32(lmref, grad_scale, step):
    """Params, mu and nu within 2 fp32 ulp of the largest term of each
    update where the clip does not bind (scale 1). The global norm's sum
    runs in another order, so where the clip binds, its scale differs by
    the norms' relative difference r (held to 1e-6) and is rounded again
    in each of g·scale, (1 − b2)·g and ·g: there the bound is 4 ulp plus
    r for mu and 2r for nu (g²)."""
    import jax.numpy as jnp

    params, grads, mu, nu = _trees(step + 1, grad_scale)
    kw = dict(peak_lr=1e-3, warmup_steps=4, stable_steps=30, decay_steps=10)
    jcfg = lmref.optimizer.AdamWConfig(**kw, moment_dtype=jnp.float32)
    jstate = lmref.optimizer.OptState(
        step=jnp.asarray(step, jnp.int32),
        mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()})
    jp, js, jm = lmref.optimizer.adamw_update(
        {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg)
    cfg = optimizer.AdamWConfig(**kw, moment_dtype=torch.float32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = optimizer.OptState(
        step=torch.tensor(step, dtype=torch.int32),
        mu={k: torch.from_numpy(v.copy()) for k, v in mu.items()},
        nu={k: torch.from_numpy(v.copy()) for k, v in nu.items()})
    new, m = optimizer.adamw_update(
        {k: torch.from_numpy(v) for k, v in grads.items()}, state, tp, cfg)
    assert int(new.step) == int(js.step) == step + 1
    assert new.step.dtype == torch.int32
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert float(m["lr"]) == float(jm["lr"])
    sc = min(1.0, 1.0 / float(jm["grad_norm"]))
    r = (abs(float(m["grad_norm"]) - float(jm["grad_norm"]))
         / float(jm["grad_norm"]) if sc < 1 else 0.0)
    lr = float(jm["lr"])
    ulps = 2 if sc == 1.0 else 4
    for k in params:
        g = grads[k].astype(np.float64) * sc
        mhat = np.asarray(js.mu[k], np.float64) / (1 - 0.9 ** (step + 1))
        vhat = np.asarray(js.nu[k], np.float64) / (1 - 0.95 ** (step + 1))
        step_size = lr * (np.abs(mhat) / (np.sqrt(vhat) + 1e-8)
                          + 0.1 * np.abs(params[k]))
        assert _within_ulps(tp[k].numpy(), jp[k], params[k], step_size,
                            ulps=ulps), k
        assert _within_ulps(new.mu[k].numpy(), js.mu[k], 0.9 * mu[k],
                            0.1 * g, ulps=ulps, rel=r), k
        assert _within_ulps(new.nu[k].numpy(), js.nu[k], 0.95 * nu[k],
                            0.05 * g * g, ulps=ulps, rel=2 * r), k
        assert new.mu[k] is state.mu[k]  # written in place


def test_adamw_update_bf16_moments_bit_equal(lmref):
    import jax.numpy as jnp

    params, grads, mu, nu = _trees(5, 0.01)
    jcfg = lmref.optimizer.AdamWConfig(moment_dtype=jnp.bfloat16)
    cfg = optimizer.AdamWConfig(moment_dtype=torch.bfloat16)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = lmref.optimizer.adamw_init(jparams, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = optimizer.adamw_init(tp, cfg)
    assert all(v.dtype == torch.bfloat16 for v in state.mu.values())
    for _ in range(3):
        jparams, jstate, _ = lmref.optimizer.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams,
            jcfg)
        state, _ = optimizer.adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, state, tp,
            cfg)
    for k in params:
        for got, want in ((state.mu[k], jstate.mu[k]),
                          (state.nu[k], jstate.nu[k])):
            assert np.array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32))), k
        assert np.array_equal(tp[k].numpy(), np.asarray(jparams[k])), k


@pytest.mark.parametrize("arch", ["dbrx-132b", "whisper-medium",
                                  "recurrentgemma-9b"])
def test_opt_state_round_trips_through_the_reference_layout(lmref, arch):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(arch)
    jmodel = lmref.registry.get_model(cfg)
    jparams = jmodel.init(jax.random.key(1), dtype=jnp.float32)
    jcfg = lmref.optimizer.AdamWConfig(moment_dtype=jnp.float32)
    jopt = lmref.optimizer.adamw_init(jparams, jcfg)
    jopt = jopt._replace(
        step=jnp.asarray(9, jnp.int32),
        mu=jax.tree.map(lambda p: p * 0.5, jparams),
        nu=jax.tree.map(lambda p: p * p, jparams))
    state = convert.opt_state_from_jax(_np(jopt), cfg)
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    names = [n for n, _ in model.named_parameters()]
    assert set(state.mu) == set(state.nu) == set(names)
    assert state.step.dtype == torch.int32 and int(state.step) == 9
    back = convert.opt_state_to_jax(state, cfg)
    assert int(back["step"]) == 9
    for name, tree in (("mu", jopt.mu), ("nu", jopt.nu)):
        flat_want = jax.tree_util.tree_leaves_with_path(_np(tree))
        flat_got = dict(jax.tree_util.tree_leaves_with_path(back[name]))
        assert len(flat_got) == len(flat_want)
        for path, want in flat_want:
            assert np.array_equal(flat_got[path], want), (name, path)


@pytest.mark.parametrize("arch", ["gemma2-2b", "dbrx-132b", "paligemma-3b",
                                  "whisper-medium", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_remat_on_and_off_give_equal_gradients(arch):
    """Activation checkpointing recomputes the same forward, so the
    gradients are equal bit for bit on the CPU."""
    cfg = registry.get_reduced_config(arch)
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(v) for k, v in data.make_batch(
        cfg, data.SyntheticDataConfig(2, 17), 0).items()}
    assert cfg.remat
    grads = {}
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        grads[remat], metrics = train_step.make_grad_fn(
            model, model.cfg, microbatches=1)(batch)
        assert np.isfinite(float(metrics["xent"]))
    model.cfg = cfg
    for name in grads[True]:
        assert torch.equal(grads[True][name], grads[False][name]), name
    assert all(float(g.abs().max()) > 0 for g in grads[True].values())


def test_serving_stays_frozen_and_graph_free():
    cfg = registry.get_reduced_config("gemma2-2b")
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    toks = torch.zeros((1, 5), dtype=torch.long)
    logits, _ = model.apply_train({"tokens": toks})
    assert not logits.requires_grad
    L.trainable_(model)
    logits, cache = model.prefill({"tokens": toks}, 8)
    assert not logits.requires_grad
    assert not model.decode_step(cache, toks[:, :1])[0].requires_grad
    logits, _ = model.apply_train({"tokens": toks})
    assert logits.requires_grad


# K6's autograd Function on CPU tensors: the forward is the wrapper's plain
# version, the backward the chunked scan's gradient
FLASH_MODES = [
    # (b, s, t, hq, hkv, causal, window, cap, prefix)
    (1, 40, 40, 4, 2, True, 16, 50.0, 0),   # gemma2: window, softcap, GQA
    (2, 33, 33, 4, 1, True, None, None, 9),  # paligemma: the prefix
    (1, 24, 57, 4, 4, False, None, None, 0),  # whisper: cross, S != T
    (1, 30, 30, 8, 1, True, 8, None, 0),     # the hybrid: window, MQA
]


@pytest.mark.parametrize("mode", FLASH_MODES,
                         ids=["window-cap-gqa", "prefix", "noncausal-cross",
                              "window-mqa"])
def test_flash_attention_function_gradients_equal_chunked(mode):
    b, s, t, hq, hkv, causal, window, cap, prefix = mode
    gen = torch.Generator().manual_seed(s + t)
    q0 = torch.randn(b, s, hq, 64, generator=gen)
    k0, v0 = (torch.randn(b, t, hkv, 64, generator=gen) for _ in range(2))
    dout = torch.randn(b, s, hq, 64, generator=gen)
    kw = dict(window=L.NO_WINDOW if window is None else window,
              causal=causal, prefix_len=prefix, cap=cap, chunk=16)
    plain_in = [x.clone().requires_grad_() for x in (q0, k0, v0)]
    out = L.attention(*plain_in, backend="chunked", **kw)
    want = torch.autograd.grad(out, plain_in, dout)

    import functools
    fn_in = [x.clone().requires_grad_() for x in (q0, k0, v0)]
    plain = functools.partial(
        L._attention_chunked, q_pos=torch.arange(s), k_pos=torch.arange(t),
        **kw)
    got_out = fa.FlashAttention.apply(*fn_in, plain, causal, window, cap,
                                      prefix)
    np.testing.assert_allclose(got_out.detach().numpy(),
                               out.detach().numpy(), rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(got_out, fn_in, dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # only the inputs that require grad get one
    q1 = q0.clone().requires_grad_()
    o1 = fa.FlashAttention.apply(q1, k0, v0, plain, causal, window, cap,
                                 prefix)
    assert torch.equal(torch.autograd.grad(o1, q1, dout)[0], want[0])


def test_bare_kernel_wrapper_raises_on_inputs_that_require_grad():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 64, generator=gen) for _ in range(3))
    with pytest.raises(RuntimeError, match="forward only"):
        fa.flash_attention_kernel(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert fa.flash_attention_kernel(q, k, v).shape == (1, 8, 2, 64)
    assert fa.flash_attention_kernel(q.detach(), k, v).shape == q.shape
