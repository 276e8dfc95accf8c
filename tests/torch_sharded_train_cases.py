"""The sharded train step's cases, run by each side in processes of their
own (``tests/test_torch_train_sharded.py``).

* ``reference_main(out_dir)`` runs the JAX package on 4 forced host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set by the
  caller), with the shim ``jax.experimental.enable_x64 = jax.enable_x64``
  in its own process: its sharded train step (``param_shardings``,
  ``batch_sharding``, ``activation_mesh``, jit) of ``REF_CASES`` on the
  (2, 2) mesh, and ``ef_psum`` under ``shard_map`` on a (4,) mesh. It
  writes each case's initial and stepped parameters (``.npz``, tree paths
  joined by "/") and metrics, and the ``ef_psum`` outputs.
* ``port_rank(rank, world, store, spec)`` is one of ``world`` spawned gloo
  ranks of the port on the CPU (joined through a ``FileStore``), running
  every case on the mesh ``spec["mesh"]``: one sharded step of each of
  ``CASES`` from the weights of seed 0, one of ``REF_CASES`` from the
  reference's weights, ``ef_psum`` on the reference's inputs, the resume
  cases and, on (2, 2), ``launch/train.py`` run twice. Rank 0 writes the
  gathered parameters and moments; every rank writes ``rank<r>.json``
  (metrics, its resident bytes against the reckoning from the specs, the
  placements it checked).

Only numpy is imported at module level, so the reference's process imports
no torch.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import numpy as np

ARCHS = ("gemma2-2b", "qwen1.5-4b", "qwen1.5-32b", "minicpm-2b",
         "mamba2-780m", "arctic-480b", "dbrx-132b", "whisper-medium",
         "paligemma-3b", "recurrentgemma-9b")
# (arch, fsdp): every reduced config as it is, and two with FSDP on
CASES = [(a, False) for a in ARCHS] + [("arctic-480b", True),
                                      ("qwen1.5-32b", True)]
# the reference's own sharded step, on (2, 2) only: (arch, fsdp,
# microbatches). arctic-480b keeps bf16 gradient accumulators, and two
# implementations may round a microbatch sum to neighbouring bf16 values,
# which moves a weight whose gradient is near 0 by up to the learning rate
# in Adam's first step (tests/torch_train_cases.py); with one microbatch
# its gradient stays fp32, where the reference's own tolerances apply
REF_CASES = [("gemma2-2b", False, 2), ("arctic-480b", True, 1)]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
WORLD = 4
BATCH, SEQ, MICRO = 8, 16, 2
OPT = dict(peak_lr=1e-3, warmup_steps=1)
# ef_psum: EF_STEPS steps on leaves of EF_SHAPES, rank r's inputs drawn
# from numpy seed 1000·r + step
EF_SHAPES = {"w": (8, 33), "b": (17,)}
EF_STEPS = 3
# the resume case: RESUME_ARCH trains RESUME_STEPS steps on (2, 2) with
# MICRO microbatches and saves after step RESUME_SAVE; the other meshes
# and one process restore that checkpoint and run the steps after it
RESUME_ARCH = "gemma2-2b"
RESUME_STEPS, RESUME_SAVE = 3, 1
# launch/train.py on (2, 2) (--model-parallel 2): LAUNCH_ARGS, first to
# LAUNCH_FIRST steps, then resumed to LAUNCH_STEPS
LAUNCH_ARGS = ["--arch", "gemma2-2b", "--reduced", "--batch", "4", "--seq",
               "16", "--save-every", "1", "--device", "cpu"]
LAUNCH_FIRST, LAUNCH_STEPS = 2, 4


def case_name(arch: str, fsdp: bool) -> str:
    return f"{arch}{'-fsdp' if fsdp else ''}"


def ef_inputs(rank: int, step: int) -> dict:
    rng = np.random.default_rng(1000 * rank + step)
    return {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
            for k, s in EF_SHAPES.items()}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def nest(flat) -> dict:
    """The nested tree of "/"-joined keys."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = np.asarray(val)
    return tree


# ---------------------------------------------------------------- reference


def reference_main(out_dir: str) -> None:
    import jax
    import jax.experimental
    import jax.numpy as jnp

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # older jax ships it under experimental
        from jax.experimental.shard_map import shard_map

    from repro.launch.mesh import make_mesh
    from repro.models.meshctx import activation_mesh
    from repro.models.registry import get_model, get_reduced_config
    from repro.train.compression import ef_psum
    from repro.train.data import SyntheticDataConfig, make_batch
    from repro.train.optimizer import AdamWConfig
    from repro.train.sharding import batch_sharding, param_shardings
    from repro.train.train_step import init_train_state, make_train_step

    mesh = make_mesh(MESHES["2x2"], ("data", "model"))
    out = {}
    for arch, fsdp, micro in REF_CASES:
        cfg = get_reduced_config(arch).replace(fsdp=fsdp)
        model = get_model(cfg)
        opt_cfg = AdamWConfig(**OPT, moment_dtype=jnp.float32)
        params, opt = init_train_state(model, cfg, opt_cfg,
                                       jax.random.key(0), dtype=jnp.float32)
        name = case_name(arch, fsdp)
        np.savez(os.path.join(out_dir, f"ref_init_{name}.npz"),
                 **dict(_flat(params)))
        batch = {k: jnp.asarray(v) for k, v in make_batch(
            cfg, SyntheticDataConfig(BATCH, SEQ + 1), 0).items()}
        step = make_train_step(model, cfg, opt_cfg, microbatches=micro)
        p_sh = param_shardings(params, mesh, fsdp=fsdp)
        b_sh = {k: batch_sharding(mesh, v) for k, v in batch.items()}
        with activation_mesh(mesh):
            fn = jax.jit(step, in_shardings=(p_sh, None, b_sh)).lower(
                params, opt, batch).compile()
        p, o, m = fn(jax.device_put(params, p_sh), opt,
                     jax.tree.map(jax.device_put, batch, b_sh))
        np.savez(os.path.join(out_dir, f"ref_step_{name}.npz"),
                 **dict(_flat(jax.tree.map(np.asarray, p))))
        out[name] = {k: float(v) for k, v in m.items()}

    mesh1 = make_mesh((WORLD,), ("data",))

    def worker(g, e):
        d, e = ef_psum({"x": g[0]}, {"x": e[0]}, "data")
        return d["x"][None], e["x"][None]

    ef = {}
    for key in EF_SHAPES:
        e = jnp.zeros((WORLD,) + EF_SHAPES[key], jnp.float32)
        outs = []
        fn = jax.jit(shard_map(worker, mesh=mesh1,
                               in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data"))))
        for s in range(EF_STEPS):
            g = jnp.stack([ef_inputs(r, s)[key] for r in range(WORLD)])
            d, e = fn(g, e)
            outs.append((np.asarray(d), np.asarray(e)))
        ef[key] = outs
    np.savez(os.path.join(out_dir, "ref_ef.npz"),
             **{f"{k}/{s}/{w}": v[s][i] for k, v in ef.items()
                for s in range(EF_STEPS) for i, w in enumerate(("deq",
                                                                "res"))})
    with open(os.path.join(out_dir, "ref_metrics.json"), "w") as f:
        json.dump(out, f)


# --------------------------------------------------------------------- port


def _setup_port():
    import torch

    torch.set_num_threads(1)  # four ranks share the host's cores
    return torch


def port_model(torch, arch: str, fsdp: bool, init_npz=None):
    """The reduced model of ``arch`` in fp32 on the CPU: drawn from seed 0,
    or the reference's weights from ``init_npz``."""
    from repro_torch.models import convert, registry

    cfg = registry.get_reduced_config(arch).replace(fsdp=fsdp)
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    if init_npz is None:
        model.init(torch.Generator().manual_seed(0))
    else:
        with np.load(init_npz) as z:
            model.load_state_dict(convert.params_from_jax(
                nest({k: z[k] for k in z.files}), cfg))
    return cfg, model


def port_batch(torch, cfg, step: int = 0):
    from repro_torch.train import data
    return {k: torch.from_numpy(v) for k, v in data.make_batch(
        cfg, data.SyntheticDataConfig(BATCH, SEQ + 1), step).items()}


def port_opt_cfg(torch):
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(**OPT, moment_dtype=torch.float32)


def reckoned_bytes(model, mesh, moment_bytes: int, fsdp: bool) -> int:
    """Σ over the parameters of numel / (product of the sizes of the mesh
    axes its sanitised spec names) × (its element size + two moments')."""
    from repro_torch.train import sharding

    sizes = sharding.axis_sizes(mesh)
    specs = sharding.param_specs(model, fsdp=fsdp)
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        for entry in sharding.sanitize_spec(specs[name], p.shape, mesh):
            if entry is not None:
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    n //= sizes.get(a, 1)
        total += n * (p.element_size() + 2 * moment_bytes)
    return total


def _sharded_step(torch, mesh, cfg, model, batch, micro=MICRO):
    """Shard ``model``, run one step under the mesh; returns (metrics, the
    full parameters and moments gathered, resident bytes, reckoned bytes,
    whether every leaf has its spec's placements)."""
    from repro_torch.models import meshctx
    from repro_torch.train import optimizer, sharding, train_step

    placed = sharding.shard_model_(model, mesh, fsdp=cfg.fsdp)
    opt_cfg = port_opt_cfg(torch)
    opt = optimizer.adamw_init(dict(model.named_parameters()), opt_cfg)
    # reckoned from the unsanitised specs before the step: the DTensors'
    # global shapes are the parameters'
    reckoned = reckoned_bytes(model, mesh, 4, cfg.fsdp)
    resident = sharding.resident_bytes(
        list(model.parameters()) + list(opt.mu.values())
        + list(opt.nu.values()))
    placements_ok = all(
        tuple(p.placements) == tuple(placed[n].placements)
        == tuple(opt.mu[n].placements) == tuple(opt.nu[n].placements)
        for n, p in model.named_parameters())
    step = train_step.make_train_step(model, cfg, opt_cfg, microbatches=micro)
    with meshctx.activation_mesh(mesh):
        opt, m = step(opt, batch)
    full = {n: meshctx.full_value(p.detach()).numpy().copy()
            for n, p in model.named_parameters()}
    mu = {n: meshctx.full_value(t).numpy().copy() for n, t in opt.mu.items()}
    nu = {n: meshctx.full_value(t).numpy().copy() for n, t in opt.nu.items()}
    return ({k: float(v) for k, v in m.items()}, full, mu, nu, resident,
            reckoned, placements_ok)


def _save(path: str, **trees) -> None:
    np.savez(path, **{f"{t}|{k}": v for t, tree in trees.items()
                      for k, v in tree.items()})


def load_saved(path: str) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            t, k = key.split("|", 1)
            out.setdefault(t, {})[k] = z[key]
    return out


def _resume_run(torch, mesh, cfg, ckpt_dir, micro, out_path=None):
    """Restore ``ckpt_dir``'s newest checkpoint into a fresh state (sharded
    on ``mesh`` when given) and run the steps after it; returns the losses
    and the full parameters."""
    from repro_torch.models import layers as L
    from repro_torch.models import meshctx
    from repro_torch.train import optimizer, sharding, train_step
    from repro_torch.train.elastic import ElasticTrainer

    model = port_model(torch, RESUME_ARCH, False)[1]
    opt_cfg = port_opt_cfg(torch)

    def fresh():
        L.trainable_(model)
        if mesh is not None:
            sharding.shard_model_(model, mesh, fsdp=cfg.fsdp)
        return {"params": model.state_dict(),
                "opt": optimizer.adamw_init(dict(model.named_parameters()),
                                            opt_cfg)}

    state, start = ElasticTrainer(ckpt_dir).resume_or_init(fresh)
    step = train_step.make_train_step(model, cfg, opt_cfg, microbatches=micro)
    losses = []
    with meshctx.activation_mesh(mesh):
        for i in range(start, RESUME_STEPS):
            opt, m = step(state["opt"], port_batch(torch, cfg, i))
            state = {"params": model.state_dict(), "opt": opt}
            losses.append(float(m["loss"]))
    full = {n: meshctx.full_value(p.detach()).numpy().copy()
            for n, p in model.named_parameters()}
    return start, losses, full


def port_rank(rank: int, world: int, store: str, spec: dict) -> None:
    torch = _setup_port()
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import compression
    from repro_torch.train.elastic import rescale_microbatches

    out_dir, mesh_name = spec["out"], spec["mesh"]
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    record = {"rank": rank, "cases": {}}
    try:
        mesh = make_mesh(MESHES[mesh_name], ("data", "model"),
                         device_type="cpu")
        runs = [(a, f, None, MICRO) for a, f in CASES]
        if mesh_name == "2x2":
            runs += [(a, f, os.path.join(spec["ref"],
                                         f"ref_init_{case_name(a, f)}.npz"),
                      micro) for a, f, micro in REF_CASES]
        for arch, fsdp, init, micro in runs:
            cfg, model = port_model(torch, arch, fsdp, init)
            m, full, mu, nu, resident, reckoned, ok = _sharded_step(
                torch, mesh, cfg, model, port_batch(torch, cfg), micro)
            name = ("ref_" if init else "") + case_name(arch, fsdp)
            record["cases"][name] = dict(metrics=m, resident=resident,
                                         reckoned=reckoned, placements=ok)
            if rank == 0:
                _save(os.path.join(out_dir, f"{mesh_name}_{name}.npz"),
                      params=full, mu=mu, nu=nu)
        # ef_psum over the world, on the reference's inputs
        ef = {}
        state = compression.ef_init({k: torch.zeros(s) for k, s in
                                     EF_SHAPES.items()})
        for s in range(EF_STEPS):
            g = {k: torch.from_numpy(v) for k, v in ef_inputs(rank, s).items()}
            d, state = compression.ef_psum(g, state)
            for k in EF_SHAPES:
                ef[f"{k}/{s}/deq"] = d[k].numpy().copy()
                ef[f"{k}/{s}/res"] = state[k].numpy().copy()
        np.savez(os.path.join(out_dir, f"{mesh_name}_ef_rank{rank}.npz"), **ef)
        # the resume cases
        cfg = port_model(torch, RESUME_ARCH, False)[0]
        if mesh_name == "2x2":
            _uninterrupted(torch, mesh, cfg, spec, record)
        else:
            for other in ("1x4", "4x1"):
                shape = (1, 4) if other == "1x4" else (4, 1)
                m2 = make_mesh(shape, ("data", "model"), device_type="cpu")
                micro = rescale_microbatches(MICRO, 2, shape[0])
                start, losses, full = _resume_run(
                    torch, m2, cfg, spec["ckpt"], micro)
                record[f"resume_{other}"] = dict(start=start, losses=losses,
                                                 micro=micro)
                if rank == 0:
                    _save(os.path.join(out_dir, f"resume_{other}.npz"),
                          params=full)
                record[f"placed_{other}"] = _restore_placed(
                    torch, m2, spec["ckpt"])
    finally:
        dist.destroy_process_group()
    if mesh_name == "2x2":
        record["launch"] = _launch_twice(rank, world, spec)
    with open(os.path.join(out_dir, f"{mesh_name}_rank{rank}.json"), "w") as f:
        json.dump(record, f)


def _restore_placed(torch, mesh, ckpt_dir) -> dict:
    """``restore_checkpoint`` of a plain ``like`` with ``shardings``: each
    leaf comes back a ``DTensor`` of its sharding's placements whose full
    value is the stored one; the step stays plain."""
    from repro_torch.models.meshctx import full_value
    from repro_torch.train import checkpoint, optimizer, sharding
    from repro_torch.train.optimizer import OptState

    cfg, model = port_model(torch, RESUME_ARCH, False)
    like = {"params": model.state_dict(),
            "opt": optimizer.adamw_init(dict(model.named_parameters()),
                                        port_opt_cfg(torch))}
    where = sharding.param_shardings(model, mesh)
    step = checkpoint.latest_step(ckpt_dir)
    got, extra = checkpoint.restore_checkpoint(
        ckpt_dir, step, like, {"params": where,
                               "opt": {"mu": where, "nu": where}})
    stored, _ = checkpoint.restore_checkpoint(ckpt_dir, step, like)
    ok = isinstance(got["opt"], OptState) and not hasattr(
        got["opt"].step, "placements")
    for part in ("params", "mu", "nu"):
        tree = got["params"] if part == "params" else getattr(got["opt"],
                                                              part)
        want = stored["params"] if part == "params" else getattr(
            stored["opt"], part)
        for name, t in tree.items():
            ok &= tuple(t.placements) == tuple(where[name].placements)
            ok &= bool(torch.equal(full_value(t), want[name]))
    return dict(ok=bool(ok), next_step=extra["next_step"])


def _uninterrupted(torch, mesh, cfg, spec, record) -> None:
    """RESUME_STEPS steps on (2, 2), a checkpoint after RESUME_SAVE."""
    from repro_torch.models import layers as L
    from repro_torch.models import meshctx
    from repro_torch.train import optimizer, sharding, train_step
    from repro_torch.train.checkpoint import save_checkpoint

    model = port_model(torch, RESUME_ARCH, False)[1]
    L.trainable_(model)
    sharding.shard_model_(model, mesh, fsdp=False)
    opt_cfg = port_opt_cfg(torch)
    opt = optimizer.adamw_init(dict(model.named_parameters()), opt_cfg)
    step = train_step.make_train_step(model, cfg, opt_cfg, microbatches=MICRO)
    losses = []
    with meshctx.activation_mesh(mesh):
        for i in range(RESUME_STEPS):
            opt, m = step(opt, port_batch(torch, cfg, i))
            losses.append(float(m["loss"]))
            if i == RESUME_SAVE:
                save_checkpoint(spec["ckpt"], i, {"params": model.state_dict(),
                                                  "opt": opt},
                                extra={"next_step": i + 1})
    full = {n: meshctx.full_value(p.detach()).numpy().copy()
            for n, p in model.named_parameters()}
    record["uninterrupted"] = dict(losses=losses)
    if torch.distributed.get_rank() == 0:
        _save(os.path.join(spec["out"], "uninterrupted.npz"), params=full)


def _launch_twice(rank: int, world: int, spec: dict) -> dict:
    """``launch/train.py`` on (2, 2) under torchrun's environment, to
    LAUNCH_FIRST steps and again to LAUNCH_STEPS (the second run resumes);
    returns rank 0's printed lines of each run."""
    from repro_torch.launch import train

    os.environ.update(MASTER_ADDR="127.0.0.1", WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    runs = []
    # a port a run, as a restarted job gets: a rank that starts the second
    # run early must not meet the first run's store, and its stale keys
    for steps, port in zip((LAUNCH_FIRST, LAUNCH_STEPS), spec["ports"]):
        os.environ["MASTER_PORT"] = str(port)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(LAUNCH_ARGS + [
                "--steps", str(steps), "--model-parallel", "2",
                "--ckpt-dir", spec["launch_dir"]])
        runs.append(dict(rc=rc, out=buf.getvalue()))
    return dict(runs=runs)


if __name__ == "__main__":
    reference_main(sys.argv[1])
