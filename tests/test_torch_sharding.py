"""The port's sharding rules against the reference's, on the CPU, no ranks.

``repro_torch.train.sharding`` against ``repro.train.sharding``: for all
ten architectures, reduced and full, with fsdp off and on, on the (16, 16),
(2, 16, 16), (2, 2) and (1, 4) mesh shapes, the sanitised spec of every
port parameter equals the reference's ``param_specs`` of its tree leaf,
sanitised on the same shape, with the stacked layer axis dropped (the port
on the meta device, the reference through ``jax.eval_shape`` and a fake
mesh, as ``tests/test_sharding_rules.py`` does); ``cache_specs`` of the
dense, moe, hybrid, ssm and encdec caches; the reference's
``sanitize_spec`` cases; ``constrain`` without a mesh; five error-feedback
steps of ``compress_decompress`` equal to the reference's bit for bit in
fp32; and the mesh helpers' errors on a world-1 gloo group.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_reference import _reference

from repro_torch.launch import mesh as tmesh
from repro_torch.models import meshctx, registry
from repro_torch.models.convert import reference_path
from repro_torch.train import compression, sharding

ARCHS = registry.list_archs()
SIZES = ("reduced", "full")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}}


class _FakeMesh:
    """The reference's test mesh: axis sizes and names, no devices."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.fixture(scope="module")
def sref():
    with _reference({"registry": "repro.models.registry",
                     "sharding": "repro.train.sharding",
                     "compression": "repro.train.compression"}) as ns:
        yield ns


@pytest.fixture(scope="module")
def trees(sref):
    """(arch, size) -> (the reference's abstract parameter tree, the port's
    model on the meta device), built once each."""
    import jax
    import jax.numpy as jnp

    cache = {}

    def get(arch, size):
        if (arch, size) not in cache:
            cfg = (registry.get_reduced_config if size == "reduced"
                   else registry.get_config)(arch)
            jm = sref.registry.get_model(cfg)
            tree = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                                  dtype=jnp.float32))
            cache[arch, size] = (tree, registry.get_model(
                cfg, device="meta", dtype=torch.float32))
        return cache[arch, size]

    return get


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(sref, trees, arch, size, fsdp, mesh):
    tree, model = trees(arch, size)
    ref_specs = sref.sharding.param_specs(tree, fsdp=fsdp)
    fake = _FakeMesh(MESHES[mesh])
    port = sharding.param_specs(model, fsdp=fsdp)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(set(names)) and names
    for name, p in model.named_parameters():
        path, stacked = reference_path(name, model.cfg)
        leaf = _leaf(tree, path)
        want = tuple(sref.sharding.sanitize_spec(_leaf(ref_specs, path),
                                                 leaf.shape, fake))
        if stacked and want:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert tuple(leaf.shape)[int(stacked):] == tuple(p.shape), name
        got = sharding.sanitize_spec(port[name], p.shape, MESHES[mesh])
        assert got == want, (name, path, got, want)


def test_every_rule_shards_something(trees):
    """Each model axis rule is reached by some full config (the table is
    not dead), and 'pod' never shards a parameter."""
    seen = set()
    for arch in ARCHS:
        _, model = trees(arch, "full")
        for name, spec in sharding.param_specs(model, fsdp=True).items():
            assert "pod" not in spec
            path, _ = reference_path(name, model.cfg)
            for pat, _ in sharding._RULES:
                if re.search(pat, path):
                    seen.add(pat)
                    break
    assert seen == {pat for pat, _ in sharding._RULES}


CACHE_ARCHS = ("gemma2-2b", "qwen1.5-32b", "arctic-480b",
               "recurrentgemma-9b", "mamba2-780m", "whisper-medium")


def _spec_leaves(cache, specs, prefix=""):
    """(path, spec) at each array leaf of ``cache``, walking ``specs`` (the
    same structure, specs at the leaves) beside it."""
    if isinstance(cache, dict):
        for k in cache:
            yield from _spec_leaves(cache[k], specs[k], f"{prefix}/{k}")
    elif isinstance(cache, (list, tuple)):
        for i, v in enumerate(cache):
            yield from _spec_leaves(v, specs[i], f"{prefix}/{i}")
    elif hasattr(cache, "shape"):
        yield prefix, specs


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_reference(sref, arch, batch, mesh):
    import jax

    cfg = registry.get_config(arch)
    fake = _FakeMesh(MESHES[mesh])
    jm = sref.registry.get_model(cfg)
    max_len = 4096
    jcache = jax.eval_shape(lambda: jm.init_cache(batch, max_len))
    orig = sref.sharding.NamedSharding
    sref.sharding.NamedSharding = lambda m, s: tuple(s)  # specs, no devices
    try:
        want = dict(_spec_leaves(jcache, sref.sharding.cache_specs(
            jcache, fake, batch)))
    finally:
        sref.sharding.NamedSharding = orig
    model = registry.get_model(cfg, device="meta", dtype=torch.bfloat16)
    cache = model.init_cache(batch, max_len)
    got = dict(_spec_leaves(cache, sharding.cache_specs(cache, fake, batch)))
    # the port's position is a host int, the reference's a 0-d array
    assert "/pos" not in got and want.pop("/pos") == ()
    assert sorted(got) == sorted(want)
    for key, spec in got.items():
        assert spec == want[key], (key, spec, want[key])


def test_sanitize_spec_drops_nondivisible(sref):
    mesh = _FakeMesh({"data": 16, "model": 16})
    cases = [(("model", None), (50280, 64)), (("model", None), (256000, 64)),
             ((("data", "model"), None), (1, 5))]
    want = [(None, None), ("model", None), (None, None)]
    from jax.sharding import PartitionSpec as P
    for (spec, shape), w in zip(cases, want):
        assert sharding.sanitize_spec(spec, shape, mesh) == w
        assert tuple(sref.sharding.sanitize_spec(P(*spec), shape, mesh)) == w


def test_constrain_is_a_noop_without_mesh():
    x = torch.ones(4, 4)
    assert meshctx.active_mesh() is None
    assert meshctx.constrain(x, "batch", None) is x
    q, k, v = torch.ones(1, 2, 4, 8), torch.ones(1, 2, 2, 8), torch.ones(1, 2, 2, 8)
    lq, lk, lv, join = meshctx.local_heads(q, k, v)
    assert lq is q and lk is k and lv is v and join(q) is q
    assert meshctx.batch_sum(x) is x and meshctx.batch_mean(x) is x
    assert meshctx.whole(x, 0) is x


def test_compress_decompress_matches_reference_over_five_steps(sref):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    shapes = {"a": (16, 33), "b": (257,), "c": (3, 4, 5)}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 2))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    grads[2]["b"][:] = 0.0  # an all-zero leaf: the 1e-12 floor
    e_port = compression.ef_init({k: torch.zeros(s) for k, s in
                                  shapes.items()})
    e_ref = sref.compression.ef_init({k: jnp.zeros(s) for k, s in
                                      shapes.items()})
    for g in grads:
        d_port, e_port = compression.compress_decompress(
            {k: torch.from_numpy(v) for k, v in g.items()}, e_port)
        d_ref, e_ref = sref.compression.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, e_ref)
        for k in shapes:
            np.testing.assert_array_equal(d_port[k].numpy(),
                                          np.asarray(d_ref[k]))
            np.testing.assert_array_equal(e_port[k].numpy(),
                                          np.asarray(e_ref[k]))
            assert e_port[k].dtype == torch.float32


def test_mesh_helpers_need_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    for fn in (tmesh.make_production_mesh, tmesh.make_local_mesh):
        with pytest.raises(tmesh.ProcessGroupNotInitializedError):
            fn()


@pytest.fixture
def world1(tmp_path):
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_helpers_on_a_world_of_one(world1):
    with pytest.raises(ValueError, match="256"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    for mp in (0, 2):
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.make_local_mesh(mp, device_type="cpu")
    mesh = tmesh.make_local_mesh(device_type="cpu")
    assert tmesh.mesh_axes(mesh) == ("data", "model")
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert tmesh.data_axes(mesh) == ("data",)
    assert sharding.data_axis(mesh) == ("data",)
    assert tmesh.PRODUCTION_SHAPES[True][1] == ("pod", "data", "model")
    assert sharding.data_axis(_FakeMesh(MESHES["2x16x16"])) == ("pod", "data")
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.placements((None, "model"), mesh) == (Replicate(),
                                                          Shard(1))
    assert sharding.batch_sharding(mesh, (8, 3)).placements == (Shard(0),
                                                                Replicate())


def _reduced_step(cfg, mesh):
    """One step of ``cfg`` (fp32, seed 0, two microbatches) sharded on
    ``mesh`` (None: one process); returns the metrics and parameters."""
    from repro_torch.models import layers as L
    from repro_torch.train import data, optimizer, train_step

    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    L.trainable_(model)
    if mesh is not None:
        sharding.shard_model_(model, mesh, fsdp=cfg.fsdp)
    opt_cfg = optimizer.AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                    moment_dtype=torch.float32)
    opt = optimizer.adamw_init(dict(model.named_parameters()), opt_cfg)
    batch = {k: torch.from_numpy(v) for k, v in data.make_batch(
        cfg, data.SyntheticDataConfig(4, 17), 0).items()}
    with meshctx.activation_mesh(mesh):
        _, m = train_step.make_train_step(model, cfg, opt_cfg,
                                          microbatches=2)(opt, batch)
    return m, {n: meshctx.full_value(p.detach())
               for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["gemma2-2b", "arctic-480b"])
def test_world1_mesh_step_is_the_one_process_step(world1, arch):
    """On a (1, 1) mesh every gather and reduction is skipped: the loss
    metrics equal the one-process step's bit for bit; the global norm sums
    its leaves grouped by their placements, another order, so it and the
    clipped update hold to 1e-6 (fsdp on, as the full arctic-480b)."""
    cfg = registry.get_reduced_config(arch).replace(fsdp=True)
    want_m, want_p = _reduced_step(cfg, None)
    got_m, got_p = _reduced_step(cfg, tmesh.make_local_mesh(
        device_type="cpu"))
    for k in ("loss", "xent", "aux", "ntok", "lr"):
        assert float(got_m[k]) == float(want_m[k]), k
    torch.testing.assert_close(got_m["grad_norm"], want_m["grad_norm"],
                               rtol=1e-6, atol=0)
    for n in want_p:
        torch.testing.assert_close(got_p[n], want_p[n], rtol=1e-6,
                                   atol=1e-8)


def test_sharded_parameters_outside_a_mesh_raise(world1):
    """A sharded model read without an active mesh raises (PyTorch refuses
    to mix DTensor and Tensor arguments): nothing falls back to a silent
    replicate."""
    from repro_torch.train import data

    cfg = registry.get_reduced_config("gemma2-2b")
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    sharding.shard_model_(model, tmesh.make_local_mesh(device_type="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in data.make_batch(
        cfg, data.SyntheticDataConfig(2, 9), 0).items()}
    with pytest.raises(RuntimeError, match="DTensor"):
        model.apply_train(batch)
