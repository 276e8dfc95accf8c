"""The port's MoE family equals the reference's.

``layers.moe`` against ``repro.models.layers.moe`` for the reduced
arctic-480b (top-2 of 4 experts with the dense residual MLP) and
dbrx-132b, with the reference's own weights: a prefill-sized batch, a
capacity factor that drops tokens (each dropped slot checked to be one the
router ranked past its expert's capacity), and the decode case (S = 1,
capacity 1). The reduced models in fp32: ``apply_train`` (logits and the
summed aux loss), prefill logits and KV cache, every ``decode_step``'s
logits and ``greedy_generate``'s tokens. ``params_from_jax`` round-trips
the moe trees, the router kept fp32 in a bf16 tree; ``init`` draws the
reference's distributions, expert stacks in slices along the expert axis.

Tolerances: ``moe`` out 1e-5 and aux 1e-6 (one fp32 layer, the same
products summed in another order); model logits and caches 2e-4 (as
``tests/test_torch_lm.py``); tokens exactly.
"""

import math

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.transformer import TransformerLM
from repro_torch.train.serve_step import greedy_generate

MOE = ["arctic-480b", "dbrx-132b"]
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _moe_pair(lmref, cfg, seed):
    """(the reference's moe params, the port's ParamTree holding them)."""
    import jax
    import jax.numpy as jnp

    jp = lmref.layers.init_moe(jax.random.key(seed), cfg, jnp.float32)
    tree = L.init_moe(None, cfg, torch.float32, device="cpu")
    tree.load_state_dict({n: torch.from_numpy(np.asarray(a).copy())
                          for n, a in convert._flatten(_np_tree(jp))})
    return jp, tree


# (label, batch, seq, capacity factor)
LAYER_CASES = [("prefill", 2, 24, None), ("drops", 2, 24, 0.5),
               ("decode", 3, 1, None)]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("label,b,s,cf", LAYER_CASES)
def test_moe_matches_reference(lmref, arch, label, b, s, cf):
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(arch)
    if cf is not None:
        cfg = cfg.replace(moe_capacity_factor=cf)
    jp, tree = _moe_pair(lmref, cfg, seed=len(label) + s)
    assert ("dense" in tree) == cfg.dense_residual
    assert tree["router"].dtype == torch.float32
    x = np.random.default_rng(s + b).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    want, want_aux = lmref.layers.moe(jp, jnp.asarray(x), cfg)
    got, aux = L.moe(tree, torch.from_numpy(x), cfg)
    assert got.shape == (b, s, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)
    r = L.moe_route(tree, torch.from_numpy(x), cfg)
    cap = max(1, int(s * cfg.top_k / cfg.num_experts * cfg.moe_capacity_factor))
    assert r["cap"] == cap
    if label == "decode":
        assert cap == 1 and bool(r["keep"].all())
    if label == "drops":
        dropped = ~r["keep"]
        assert bool(dropped.any()), "the case must drop tokens"
        assert bool((r["pos"][dropped] >= cap).all())
        # a dropped slot leaves its token's row without that expert's term
        solo = L.moe(tree, torch.from_numpy(x), cfg.replace(
            moe_capacity_factor=4.0))[0]
        rows = dropped.any(-1)
        assert not torch.allclose(solo[rows], got[rows])


def _models(lmref, arch, seed):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(arch)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(arch))
    jparams = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    model = TransformerLM(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.params_from_jax(_np_tree(jparams), cfg))
    return jmodel, jparams, model


@pytest.mark.parametrize("arch", MOE)
def test_moe_serving_matches_reference(lmref, arch):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, arch, seed=1)
    cfg = model.cfg
    b, s, steps = 2, 20, 5
    max_len = s + steps + 1
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, max_len))(jparams, jnp.asarray(tokens))
    tt = torch.from_numpy(tokens).long()
    logits, cache = model.prefill({"tokens": tt}, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **MODEL_TOL)
    jstep = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    for i in range(steps):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(feed[i]))
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
    want = jax.jit(lambda p, t: lmref.serve_step.greedy_generate(
        jmodel, cfg, p, {"tokens": t}, steps=steps, max_len=max_len))(
            jparams, jnp.asarray(tokens))
    got = greedy_generate(model, cfg, {"tokens": tt}, steps=steps,
                          max_len=max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_train_matches_reference(lmref, arch):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _models(lmref, arch, seed=4)
    tokens = np.random.default_rng(8).integers(
        0, model.cfg.vocab, size=(2, 28)).astype(np.int32)
    want, want_aux = jax.jit(jmodel.apply_train)(
        jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = model.apply_train({"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_params_round_trip(lmref, arch):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(arch)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(arch))
    tree = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.float32))
    sd = convert.params_from_jax(tree, cfg)
    assert tuple(sd["blocks.1.moe.wi"].shape) == (
        cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert ("blocks.0.moe.dense.wg.w" in sd) == cfg.dense_residual
    model = TransformerLM(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(sd)
    back = convert.params_to_jax(model.state_dict(), cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b), path
    # a bf16 tree keeps its fp32 router, in the tree and in the model
    tree16 = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.bfloat16))
    assert tree16["layers"]["moe"]["router"].dtype == np.float32
    sd16 = convert.params_from_jax(tree16, cfg)
    assert sd16["blocks.0.moe.router"].dtype == torch.float32
    assert sd16["blocks.0.moe.wo"].dtype == torch.bfloat16
    model16 = TransformerLM(cfg, device="cpu", dtype=torch.bfloat16)
    model16.load_state_dict(sd16)
    assert model16.blocks[0]["moe"]["router"].dtype == torch.float32
    assert torch.equal(model16.blocks[0]["moe"]["router"],
                       sd16["blocks.0.moe.router"])
    back16 = convert.params_to_jax(model16.state_dict(), cfg)
    assert back16["layers"]["moe"]["router"].dtype == np.float32
    np.testing.assert_array_equal(back16["layers"]["moe"]["router"],
                                  tree16["layers"]["moe"]["router"])


def test_moe_init_draws_the_reference_distributions(monkeypatch):
    cfg = registry.get_reduced_config("arctic-480b").replace(
        num_experts=16, d_model=96, d_ff=160)
    model = TransformerLM(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    p = model.blocks[0]["moe"]
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    # the reference's fans: router over d, wi and wg over E, wo over ff
    for name, fan in (("router", d), ("wi", e), ("wg", e), ("wo", ff)):
        assert abs(float(p[name].std()) * fan ** 0.5 - 1.0) < 0.05, name
    assert p["router"].dtype == torch.float32
    assert abs(float(p["dense"]["wi"]["w"].std()) * d ** 0.5 - 1.0) < 0.05
    assert float(model.blocks[1]["ln2"]["scale"].abs().max()) == 0.0
    # expert stacks past DRAW_ELEMS are drawn a slice of experts at a time:
    # the same distribution, reproducible, one slice's fp32 at a time
    monkeypatch.setattr(L, "DRAW_ELEMS", 3 * d * ff)
    shapes = []
    randn = torch.randn

    def counting(shape, *args, **kw):
        shapes.append(tuple(shape))
        return randn(shape, *args, **kw)

    monkeypatch.setattr(torch, "randn", counting)
    sliced = TransformerLM(cfg, device="cpu", dtype=torch.float32)
    sliced.init(torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch, "randn", randn)
    assert max(math.prod(x) for x in shapes[1:]) <= L.DRAW_ELEMS  # embed first
    assert shapes.count((3, d, ff)) == 2 * cfg.num_layers * (e // 3)
    assert (e % 3, d, ff) in shapes and (3, ff, d) in shapes
    q = sliced.blocks[0]["moe"]
    for name, fan in (("wi", e), ("wo", ff)):
        assert abs(float(q[name].std()) * fan ** 0.5 - 1.0) < 0.05, name
    # leaves within the limit draw the values a whole draw gives
    assert torch.equal(q["router"], p["router"])
    assert torch.equal(sliced.blocks[0]["attn"]["wq"]["w"],
                       model.blocks[0]["attn"]["wq"]["w"])
    again = TransformerLM(cfg, device="cpu", dtype=torch.float32)
    again.init(torch.Generator().manual_seed(0))
    for (n, a), (_, b) in zip(sliced.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n


def test_draw_matches_a_whole_draw():
    """``draw_`` on a leaf within ``DRAW_ELEMS`` gives the values that
    ``_he`` draws from the same generator state (dense init unchanged)."""
    whole = L.dense_init(torch.Generator().manual_seed(5), 48, 80,
                         dtype=torch.bfloat16)["w"]
    empty = L.dense_init(None, 48, 80, dtype=torch.bfloat16, device="cpu")["w"]
    L.draw_(empty, torch.Generator().manual_seed(5))
    assert torch.equal(whole, empty) and empty.he_fan == 48
    bias = L.dense_init(None, 4, 6, bias=True, dtype=torch.float32,
                        device="cpu")["b"]
    bias.fill_(3.0)
    L.draw_(bias, torch.Generator())
    assert bias.he_fan is None and not bias.abs().max()
