"""The port's dense LM serving path equals the reference's.

Configs and the registry against ``repro.models``; ``params_from_jax``
round trips; ``rope``, ``rmsnorm`` and ``mlp`` against the reference's
layers; and the reduced gemma2-2b (prompt 40, past its window of 16),
qwen1.5-4b (QKV bias) and minicpm-2b (residual scale) in fp32, loaded with
the reference's own initial weights: prefill logits and KV cache, every
``decode_step``'s logits and ``greedy_generate``'s tokens against the
reference's. Prefill plus decode agrees with ``apply_train``'s forward, as
``tests/test_models_smoke.py`` checks it in JAX. A missing card raises;
every family builds and serves through the registry: the moe and vlm
families and the int8 KV cache in ``TransformerLM``, the ssm, hybrid and
encdec families in models of their own (their parity is in
``tests/test_torch_moe.py``, ``test_torch_vlm.py``,
``test_torch_kvint8.py``, ``test_torch_ssm.py``, ``test_torch_hybrid.py``
and ``test_torch_encdec.py``).

Tolerances: layers 1e-5 (the same fp32 arithmetic); model logits and
caches 2e-4 after four fp32 layers (reductions summed in another order,
softcapped logits of order 1); greedy tokens exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.launch import serve_lm
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerLM, _layer_windows
from repro_torch.train.serve_step import greedy_generate, make_serve_fns

DENSE = ["gemma2-2b", "qwen1.5-4b", "qwen1.5-32b", "minicpm-2b"]
# the archs of the families TransformerLM serves, and those of the families
# with models of their own
TRANSFORMER = DENSE + ["arctic-480b", "dbrx-132b", "paligemma-3b"]
OWN_MODEL = {"mamba2-780m": ("ssm", "MambaLM"),
             "whisper-medium": ("encdec", "WhisperModel"),
             "recurrentgemma-9b": ("hybrid", "GriffinLM")}
PORTED = TRANSFORMER + list(OWN_MODEL)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
CPU = "cpu"


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _port_model(lmref, arch, seed=0):
    """(reference model, its numpy params, the port's model loaded with
    them), reduced config, fp32, on the CPU."""
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(arch)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(arch))
    jparams = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    model = TransformerLM(cfg, device=CPU, dtype=torch.float32)
    model.load_state_dict(convert.params_from_jax(_np_tree(jparams), cfg))
    return jmodel, jparams, model


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("which", ["get_config", "get_reduced_config"])
def test_configs_equal_reference(lmref, arch, which):
    port = getattr(registry, which)(arch)
    ref = getattr(lmref.registry, which)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.padded_vocab == ref.padded_vocab
    assert port.replace(vocab=1000).padded_vocab == \
        ref.replace(vocab=1000).padded_vocab
    assert _layer_windows(port) == np.asarray(
        lmref.transformer._layer_windows(ref)).tolist()


def test_registry_names_and_non_dense_families(lmref):
    assert registry.ARCHS == lmref.registry.ARCHS
    assert registry.list_archs() == lmref.registry.list_archs()
    assert sorted(PORTED) == sorted(registry.ARCHS)
    # the ssm, encdec and hybrid families build in models of their own and
    # serve; TransformerLM refuses them, naming the class that serves each
    for arch, (family, cls) in OWN_MODEL.items():
        assert lmref.registry.get_config(arch).family == family
        cfg = registry.get_reduced_config(arch)
        assert registry.get_config(arch).family == cfg.family == family
        model = registry.get_model(cfg, device=CPU, dtype=torch.float32)
        assert type(model).__name__ == cls
        assert type(lmref.registry.get_model(cfg)).__name__ == cls
        model.init(torch.Generator().manual_seed(0))
        batch = {"tokens": torch.arange(12).reshape(2, 6) % cfg.vocab}
        if family == "encdec":
            batch["frames"] = torch.ones(2, cfg.encoder_seq, cfg.d_model)
        toks = greedy_generate(model, cfg, batch, steps=3, max_len=10)
        assert toks.shape == (2, 3) and int(toks.max()) < cfg.vocab
        with pytest.raises(NotImplementedError, match=cls):
            TransformerLM(cfg, device=CPU)
    with pytest.raises(ValueError, match="unknown arch"):
        registry.get_config("gpt-2")
    with pytest.raises(ValueError, match="unknown family"):
        registry.get_model(registry.get_reduced_config("gemma2-2b").replace(
            family="rnn"), device=CPU)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        TransformerLM(registry.get_reduced_config("gemma2-2b").replace(
            kv_cache_dtype="fp8"), device=CPU)
    # the moe and vlm families and the int8 cache build where they raised
    for arch in ("arctic-480b", "dbrx-132b", "paligemma-3b", "qwen1.5-32b"):
        cfg = registry.get_reduced_config(arch)
        model = registry.get_model(cfg, device=CPU, dtype=torch.float32)
        assert isinstance(model, TransformerLM)
        assert model.cfg.family == lmref.registry.get_config(arch).family
        assert ("moe" in model.blocks[0]) == (cfg.family == "moe")
        assert hasattr(model, "vision_proj") == (cfg.family == "vlm")
    int8 = TransformerLM(registry.get_config("qwen1.5-32b").replace(
        num_layers=1, d_model=64, num_heads=4, kv_heads=4, d_ff=64,
        vocab=256), device=CPU)
    cache = int8.init_cache(2, 5)
    assert cache["k"].dtype == torch.int8
    assert tuple(cache["k_scale"].shape) == (1, 2, 5, 4)
    q, scale = L.quantize_kv(torch.tensor([[0.0, 2.0, -1.0]]))
    assert q.tolist() == [[0, 127, -64]] and scale.dtype == torch.bfloat16
    assert torch.allclose(L.dequantize_kv(q, scale, torch.float32),
                          torch.tensor([[0.0, 2.0, -1.0]]), atol=2e-2)
    moe_cfg = registry.get_reduced_config("dbrx-132b")
    tree = L.init_moe(torch.Generator().manual_seed(0), moe_cfg,
                      torch.float32)
    out, aux = L.moe(tree, torch.ones(1, 3, moe_cfg.d_model), moe_cfg)
    assert out.shape == (1, 3, moe_cfg.d_model) and float(aux) > 0


def test_entry_points_default_to_the_card():
    cfg = registry.get_reduced_config("gemma2-2b")
    if torch.cuda.is_available():
        assert TransformerLM(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main(["--reduced"])


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen1.5-4b", "minicpm-2b"])
def test_params_from_jax_round_trips(lmref, arch):
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(arch)
    jmodel = lmref.registry.get_model(lmref.registry.get_reduced_config(arch))
    tree = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.float32))
    sd = convert.params_from_jax(tree, cfg)
    model = TransformerLM(cfg, device=CPU, dtype=torch.float32)
    model.load_state_dict(sd)  # strict: the names and shapes are the port's
    back = convert.params_to_jax(model.state_dict(), cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b), path
    # bf16 arrays keep their bits
    tree16 = _np_tree(jmodel.init(jax.random.key(3), dtype=jnp.bfloat16))
    sd16 = convert.params_from_jax(tree16, cfg)
    assert sd16["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd16["embed"].float().numpy(),
                                  np.asarray(tree16["embed"], np.float32))
    with pytest.raises(ValueError, match="num_layers"):
        convert.params_from_jax(tree, cfg.replace(num_layers=3))


def test_init_draws_the_reference_distributions():
    cfg = registry.get_reduced_config("qwen1.5-4b").replace(vocab=4096)
    model = TransformerLM(cfg, device=CPU, dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    assert abs(float(model.embed.std()) - 0.02) < 0.001
    wq = model.blocks[0]["attn"]["wq"]["w"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert float(model.blocks[0]["attn"]["wq"]["b"].abs().max()) == 0.0
    assert float(model.blocks[1]["ln1"]["scale"].abs().max()) == 0.0
    again = TransformerLM(cfg, device=CPU, dtype=torch.float32)
    again.init(torch.Generator().manual_seed(0))
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(lmref, theta):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(100, 112)]).astype(np.int32)
    want = lmref.layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rmsnorm_and_mlp_match_reference(lmref):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = lmref.layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                                1e-6)
    p = L.rmsnorm_init(64, torch.float32)
    p["scale"].copy_(torch.from_numpy(scale))
    got = L.rmsnorm(p, torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for gated, act in ((True, "silu"), (False, "gelu")):
        w = {n: (rng.standard_normal(shape) / 8).astype(np.float32)
             for n, shape in (("wi", (64, 96)), ("wo", (96, 64)),
                              ("wg", (64, 96)))}
        if not gated:
            del w["wg"]
        want = lmref.layers.mlp({n: {"w": jnp.asarray(a)} for n, a in w.items()},
                                jnp.asarray(x), act)
        pm = L.init_mlp(torch.Generator(), 64, 96, gated=gated,
                        dtype=torch.float32)
        for n, a in w.items():
            pm[n]["w"].copy_(torch.from_numpy(a))
        got = L.mlp(pm, torch.from_numpy(x), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen1.5-4b", "minicpm-2b"])
def test_serving_matches_reference(lmref, arch):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _port_model(lmref, arch, seed=1)
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
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **MODEL_TOL)
    # decode: feed the same tokens to both, step by step
    jstep = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    for i in range(steps):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(feed[i]))
        lg, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
        assert cache["pos"] == int(jcache["pos"]) == s + i + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **MODEL_TOL)
    # greedy generation: the same tokens
    want = jax.jit(lambda p, t: lmref.serve_step.greedy_generate(
        jmodel, cfg, p, {"tokens": t}, steps=steps, max_len=max_len))(
            jparams, jnp.asarray(tokens))
    got = greedy_generate(model, cfg, {"tokens": tt}, steps=steps,
                          max_len=max_len)
    assert got.shape == (b, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_serve_fns_are_the_model_steps(lmref):
    _, _, model = _port_model(lmref, "qwen1.5-4b")
    prefill, decode_step = make_serve_fns(model, model.cfg)
    tokens = torch.arange(24).reshape(2, 12) % model.cfg.vocab
    a, ca = prefill({"tokens": tokens}, 16)
    b, cb = model.prefill({"tokens": tokens}, 16)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])
    la, _ = decode_step(ca, tokens[:, :1])
    lb, _ = model.decode_step(cb, tokens[:, :1])
    assert torch.equal(la, lb)
    assert greedy_generate(model, model.cfg, {"tokens": tokens}, steps=0,
                           max_len=16).shape == (2, 0)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen1.5-4b", "minicpm-2b"])
def test_decode_agrees_with_train_forward(lmref, arch):
    """Prefill+decode reproduces the teacher-forced forward logits."""
    _, _, model = _port_model(lmref, arch, seed=2)
    cfg = model.cfg
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 24))).long()
    full, aux = model.apply_train({"tokens": tokens})
    assert full.shape == (2, 24, cfg.padded_vocab) and float(aux) == 0.0
    logits, cache = model.prefill({"tokens": tokens}, 32)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
    nxt = tokens[:, :1] * 0 + 5
    dl, _ = model.decode_step(cache, nxt)
    full2, _ = model.apply_train({"tokens": torch.cat([tokens, nxt], dim=1)})
    np.testing.assert_allclose(dl[:, 0].numpy(), full2[:, -1].numpy(),
                               rtol=5e-5, atol=5e-5)


def test_apply_train_matches_reference(lmref):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, model = _port_model(lmref, "gemma2-2b", seed=4)
    tokens = np.random.default_rng(8).integers(
        0, model.cfg.vocab, size=(2, 36)).astype(np.int32)
    want, _ = jax.jit(jmodel.apply_train)(jparams,
                                          {"tokens": jnp.asarray(tokens)})
    got, _ = model.apply_train({"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_serve_lm_runs_on_cpu(capsys):
    assert serve_lm.main(["--arch", "minicpm-2b", "--reduced", "--device",
                          "cpu", "--batch", "2", "--prompt-len", "20",
                          "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "arch=minicpm-2b-reduced batch=2 prompt=20 generated=4/seq" in out
    assert "tok/s (CPU" in out


def test_model_config_is_a_copy():
    import repro_torch.models.config as port_config

    assert ModelConfig is port_config.ModelConfig
    assert ModelConfig.__module__ == "repro_torch.models.config"


def test_lm_modules_import_and_serve_without_jax():
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.models.registry, repro_torch.models.convert, "
            "repro_torch.models.encdec, repro_torch.models.ssm, "
            "repro_torch.models.rglru, "
            "repro_torch.kernels.flash_attention, repro_torch.train.serve_step; "
            "from repro_torch.launch import serve_lm; "
            "[serve_lm.main(['--arch', a, '--reduced', '--device', 'cpu', "
            "'--batch', '1', '--prompt-len', '20', '--tokens', '3']) for a in "
            "('gemma2-2b', 'qwen1.5-32b', 'arctic-480b', 'dbrx-132b', "
            "'paligemma-3b', 'whisper-medium', 'mamba2-780m', "
            "'recurrentgemma-9b')]")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("generated=3/seq") == 8
