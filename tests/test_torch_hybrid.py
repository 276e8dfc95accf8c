"""The port's hybrid family (recurrentgemma's Griffin) equals the
reference's.

``rglru_scan`` (S = 1, odd S, strong decay) and ``rglru_step`` against
``repro.models.rglru``; a local-attention block's ring-buffer decode
against the reference's ``_attn_fwd`` with a cache, before and after the
ring wraps; the reduced recurrentgemma-9b (window 16, prompt 40: the window
cuts in prefill and the ring wraps in decode) in fp32 with the reference's
own weights: ``prefill`` logits and every cache leaf (states, conv tails,
rings and slot positions), several ``decode_step``s, ``greedy_generate``'s
tokens and ``apply_train``; the parameter round trips (the groups split
into blocks, the remainder unstacked); R13: with fewer ring slots than the
window, the reference's decode overwrites a key inside the window and its
logits drift, where the port raises; ``launch.serve_lm`` on the CPU.

Tolerances: single functions 1e-5 (the same fp32 arithmetic; the doubling
scan combines in another tree than ``lax.associative_scan``); model logits
and caches 2e-4 (as ``MODEL_TOL`` of ``tests/test_torch_lm.py``); tokens
exactly.
"""

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.launch import serve_lm
from repro_torch.models import convert
from repro_torch.models import registry
from repro_torch.models import rglru
from repro_torch.train.serve_step import greedy_generate

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _lru_inputs(b, s, w, seed, lam_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    r, i = (rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32)
            for _ in range(2))
    lam = (lam_scale * rng.uniform(0.5, 2.0, w)).astype(np.float32)
    return x, r, i, lam


@pytest.mark.parametrize("s,lam_scale", [(1, 1.0), (37, 1.0), (64, 1.0),
                                         (33, 8.0)])
def test_rglru_scan_matches_reference(lmref, s, lam_scale):
    """lam_scale 8: a = exp(-8·softplus(lam)·r) far below 1, a strong
    decay whose long products underflow."""
    import jax.numpy as jnp

    x, r, i, lam = _lru_inputs(2, s, 24, seed=s, lam_scale=lam_scale)
    want = lmref.rglru.rglru_scan(*map(jnp.asarray, (x, r, i, lam)))
    got = rglru.rglru_scan(*map(torch.from_numpy, (x, r, i, lam)))
    assert got.shape == (2, s, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rglru_step_matches_reference_and_the_scan(lmref):
    import jax.numpy as jnp

    x, r, i, lam = _lru_inputs(2, 19, 24, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 24)).astype(np.float32)
    want = lmref.rglru.rglru_step(jnp.asarray(h0), jnp.asarray(x[:, 0]),
                                  jnp.asarray(r[:, 0]), jnp.asarray(i[:, 0]),
                                  jnp.asarray(lam))
    got = rglru.rglru_step(torch.from_numpy(h0), torch.from_numpy(x[:, 0]),
                           torch.from_numpy(r[:, 0]), torch.from_numpy(i[:, 0]),
                           torch.from_numpy(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tx, tr, ti, tl = map(torch.from_numpy, (x, r, i, lam))
    scan = rglru.rglru_scan(tx, tr, ti, tl)
    h = torch.zeros(2, 24)
    for t in range(19):
        h = rglru.rglru_step(h, tx[:, t], tr[:, t], ti[:, t], tl)
        np.testing.assert_allclose(h.numpy(), scan[:, t].numpy(), **TOL)


def _models(lmref, seed, cfg=None):
    import jax
    import jax.numpy as jnp

    cfg = cfg or registry.get_reduced_config(ARCH)
    jmodel = lmref.registry.get_model(cfg)
    jparams = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.params_from_jax(_np_tree(jparams), cfg))
    return jmodel, jparams, model


@pytest.mark.parametrize("cur_pos", [10, 37])
def test_ring_decode_attention_matches_reference(lmref, cur_pos):
    """Block 2 (the first attention block) at one decode step: before the
    ring wraps (positions 0..9 in slots 0..9, the rest empty) and after it
    (slot j holds the last position of p % 16 == j below cur_pos)."""
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=2)
    cfg = model.cfg
    w, b = cfg.sliding_window, 2
    assert model.kinds[2] == "attn"
    rng = np.random.default_rng(cur_pos)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, w, cfg.kv_heads, cfg.head_dim)
                                  ).astype(np.float32) for _ in range(2))
    kpos = np.full((w,), -1, np.int32)
    for p in range(max(0, cur_pos - w), cur_pos):
        kpos[p % w] = p
    jp = jax.tree.map(lambda a: a[0], jparams["groups"])["b2"]
    want_x, (jk, jv, jkpos) = jmodel._attn_fwd(
        jp, jnp.asarray(x), jnp.asarray([cur_pos]),
        cache=(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kpos)),
        cur_pos=jnp.asarray(cur_pos, jnp.int32))
    cache = tuple(torch.from_numpy(a.copy()) for a in (ck, cv, kpos))
    got_x, new = model._attn_fwd(model.blocks[2], torch.from_numpy(x),
                                 torch.tensor([cur_pos]), cache=cache,
                                 cur_pos=cur_pos)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(new[0].numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(new[1].numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(new[2].numpy(), np.asarray(jkpos))
    assert int(new[2][cur_pos % w]) == cur_pos


def _assert_caches_close(cache, jcache):
    assert cache["pos"] == int(jcache["pos"])
    assert len(cache["blocks"]) == len(jcache["blocks"])
    for got, want in zip(cache["blocks"], jcache["blocks"]):
        assert len(got) == len(want)
        for g, wnt in zip(got, want):
            assert tuple(g.shape) == wnt.shape
            if g.dtype == torch.int32:
                np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(wnt),
                                           **MODEL_TOL)


def test_hybrid_serving_matches_reference(lmref):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=1)
    assert isinstance(model, rglru.GriffinLM)
    assert model.kinds == ["rec", "rec", "attn", "rec", "rec", "attn"]
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
    _assert_caches_close(cache, jcache)
    jstep = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    for i in range(steps):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(feed[i]))
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_caches_close(cache, jcache)
    want = jax.jit(lambda p, t: lmref.serve_step.greedy_generate(
        jmodel, cfg, p, {"tokens": t}, steps=steps, max_len=max_len))(
            jparams, jnp.asarray(tokens))
    got = greedy_generate(model, cfg, {"tokens": tt}, steps=steps,
                          max_len=max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hybrid_apply_train_matches_reference_and_decode(lmref):
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
    # decode after prefill(S - 1), past the window, reproduces the
    # forward's last logits
    _, cache = model.prefill({"tokens": tt[:, :-1]}, 40)
    dl, _ = model.decode_step(cache, tt[:, -1:])
    np.testing.assert_allclose(dl[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=5e-5, atol=5e-5)


def test_hybrid_short_ring_raises_where_the_reference_drops_keys(lmref):
    """R13: with max_len 12 < window 16 the reference's ring has 12 slots;
    its decode at position 12 overwrites position 0, still inside the
    window, and its logits drift from those of a ring of 16. The port
    raises there."""
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, seed=6)
    cfg = model.cfg
    tokens = np.random.default_rng(9).integers(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    feed = np.arange(10, dtype=np.int32).reshape(5, 2, 1) % cfg.vocab
    runs = []
    for max_len in (12, 40):
        _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                   max_len)
        rows = []
        for i in range(5):
            jl, jcache = jmodel.decode_step(jparams, jcache,
                                            jnp.asarray(feed[i]))
            rows.append(np.asarray(jl))
        runs.append(rows)
    np.testing.assert_allclose(runs[0][3], runs[1][3], **MODEL_TOL)
    assert np.abs(runs[0][4] - runs[1][4]).max() > 1e-3  # the lost key
    _, cache = model.prefill({"tokens": torch.from_numpy(tokens).long()}, 12)
    for i in range(4):
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
    np.testing.assert_allclose(lg.numpy(), runs[1][3], **MODEL_TOL)
    with pytest.raises(ValueError, match="fewer than the window"):
        model.decode_step(cache, torch.from_numpy(feed[4]).long())


def test_hybrid_params_round_trip_and_keep_dtypes(lmref):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(ARCH).replace(num_layers=8)  # rem 2
    jmodel = lmref.registry.get_model(cfg)
    tree = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.float32))
    assert sorted(tree) == ["embed", "final_norm", "groups", "rem0", "rem1"]
    sd = convert.params_from_jax(tree, cfg)
    model = rglru.GriffinLM(cfg, device="cpu", dtype=torch.float32)
    assert model.kinds == ["rec", "rec", "attn"] * 2 + ["rec", "rec"]
    model.load_state_dict(sd)
    # group 1's block b2 is block 5; rem1 is block 7
    np.testing.assert_array_equal(
        model.blocks[5]["attn"]["wq"]["w"].numpy(),
        tree["groups"]["b2"]["attn"]["wq"]["w"][1])
    np.testing.assert_array_equal(model.blocks[7]["lam"].numpy(),
                                  tree["rem1"]["lam"])
    back = convert.params_to_jax(model.state_dict(), cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b), path
    # a bf16 tree: the gates and lam stay fp32, the rest bf16, bit for bit
    tree16 = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.bfloat16))
    sd16 = convert.params_from_jax(tree16, cfg)
    model16 = rglru.GriffinLM(cfg, device="cpu", dtype=torch.bfloat16)
    for name, p in model16.state_dict().items():
        assert sd16[name].dtype == p.dtype, name
    model16.load_state_dict(sd16)
    assert sd16["blocks.0.gate_r_w"].dtype == torch.float32
    assert sd16["blocks.0.conv_w"].dtype == torch.bfloat16
    back16 = convert.params_to_jax(model16.state_dict(), cfg)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree16)[0],
            jax.tree_util.tree_flatten_with_path(back16)[0]):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    with pytest.raises(ValueError, match="block_pattern"):
        convert.params_from_jax(tree, cfg.replace(num_layers=11))
    with pytest.raises(ValueError, match="not the hybrid model's"):
        convert.params_from_jax(dict(tree, layers={"x": tree["embed"]}), cfg)


def test_hybrid_init_draws_the_reference_distributions():
    cfg = registry.get_reduced_config(ARCH).replace(vocab=4096, lru_width=512)
    model = rglru.GriffinLM(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    rec = model.blocks[0]
    assert abs(float(model.embed.std()) - 0.02) < 0.001
    assert abs(float(rec["gate_r_w"].std()) - 0.1) < 0.01
    assert float(rec["gate_i_b"].abs().max()) == 0.0
    assert torch.equal(rec["lam"], torch.ones(512))
    wq = model.blocks[2]["attn"]["wq"]["w"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


def test_serve_lm_serves_recurrentgemma_on_cpu(capsys):
    assert serve_lm.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "20",
                          "--tokens", "5"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced batch=2 prompt=20 generated=5/seq" in out
