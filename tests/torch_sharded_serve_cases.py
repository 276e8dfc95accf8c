"""Sharded serving's cases, run by each side in processes of their own
(``tests/test_torch_serve_sharded.py`` and ``tests/test_torch_dryrun.py``).

* ``reference_main(out_dir)`` runs the JAX package on 4 forced host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set by the
  caller), with the R1 shim ``jax.experimental.enable_x64 =
  jax.enable_x64`` in its own process: each reduced config's weights
  (seed 0, fp32) are written (``.npz``, tree paths joined by "/"), then its
  ``jax.jit(model.prefill, in_shardings=(param_shardings,
  batch_sharding))`` under ``activation_mesh`` on each mesh of ``MESHES``;
  the logits and every cache leaf are written.
* ``port_rank(rank, world, store, spec)`` is one of ``world`` spawned gloo
  ranks of the port on the CPU (joined through a ``FileStore``). With
  ``spec["what"] == "serve"`` it serves every case on the mesh
  ``spec["mesh"]`` from the reference's weights: the sharded prefill (this
  rank's logits and cache shard, with its ``layout``), ``greedy_generate``
  (every row's tokens) and a decode past the cache (R12). With
  ``"tally"`` it counts the prefill and one decode step of every case
  with ``launch.op_cost.OpCost`` and ``FlopCounterMode``, the attention
  that K6 would run hidden from both (the dry run counts it as K6's).
* ``fake_main(out_dir)`` traces the same prefill and decode of every case
  on the ``meta`` device on a fake 4-rank group, rank 0, each mesh
  (``launch.dryrun.trace_step``'s machinery), for the tally test.

Only numpy is imported at module level, so the reference's process imports
no torch.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ARCHS = ("gemma2-2b", "qwen1.5-4b", "qwen1.5-32b", "minicpm-2b",
         "mamba2-780m", "arctic-480b", "dbrx-132b", "whisper-medium",
         "paligemma-3b", "recurrentgemma-9b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
WORLD = 4
# 8 rows (no config has 8 layers, so cache_specs finds the batch dim), a
# 20-token prompt and 4 decoded tokens: max_len 24 (32 with the VLM's 8
# patches) splits over 4 model ranks, and gemma2's 16-token window leaves
# model rank 0 of (1, 4) without a live key in the last decode steps
BATCH, PROMPT, STEPS = 8, 20, 4
# families without a cache that grows (no R12 to show)
NO_R12 = ("mamba2-780m", "recurrentgemma-9b")


def tally_config(arch: str):
    """The reduced config of ``arch`` for the tally test, its head dim
    widened to K6's smallest (64) where it is narrower: the dry run
    models the card, where K6 takes head dims 64, 128 and 256 only."""
    from repro_torch.models.registry import get_reduced_config

    cfg = get_reduced_config(arch)
    return cfg.replace(head_dim=64) if cfg.head_dim < 64 else cfg


def max_len(cfg) -> int:
    return PROMPT + STEPS + (cfg.vision_tokens if cfg.family == "vlm" else 0)


def inputs(cfg) -> dict:
    """The prompt batch of a case, from numpy seed 7."""
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (BATCH, PROMPT),
                                  dtype=np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def flat(tree, prefix=""):
    """(path, leaf) of a tree: dict keys, list and tuple indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def nest(flat_tree) -> dict:
    """The nested tree of "/"-joined keys."""
    tree: dict = {}
    for key, val in flat_tree.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = np.asarray(val)
    return tree


def spawn(spec: dict, mesh: str, timeout: float = 600) -> list:
    """``WORLD`` spawned gloo ranks of ``port_rank`` on ``mesh``, joined
    through a ``FileStore`` under ``spec["out"]``; their records."""
    import time

    import torch.multiprocessing as mp

    out = spec["out"]
    ctx = mp.start_processes(
        port_rank, args=(WORLD, os.path.join(
            out, f"store_{spec['what']}_{mesh}"), dict(spec, mesh=mesh)),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"the {mesh} ranks did not finish")
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(out, f"{spec['what']}_{mesh}_rank{r}.json")
                  ) as f:
            ranks.append(json.load(f))
    return ranks


# ---------------------------------------------------------------- reference


def reference_main(out_dir: str) -> None:
    import jax
    import jax.experimental
    import jax.numpy as jnp

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.launch.mesh import make_mesh
    from repro.models.meshctx import activation_mesh
    from repro.models.registry import get_model, get_reduced_config
    from repro.train.sharding import batch_sharding, param_shardings

    for arch in ARCHS:
        cfg = get_reduced_config(arch)
        model = get_model(cfg)
        params = model.init(jax.random.key(0), dtype=jnp.float32)
        np.savez(os.path.join(out_dir, f"init_{arch}.npz"),
                 **{k: np.asarray(v) for k, v in flat(params)})
        batch = {k: jnp.asarray(v) for k, v in inputs(cfg).items()}
        n = max_len(cfg)
        for name, shape in MESHES.items():
            mesh = make_mesh(shape, ("data", "model"))
            p_sh = param_shardings(params, mesh)
            b_sh = {k: batch_sharding(mesh, v) for k, v in batch.items()}
            with activation_mesh(mesh):
                fn = jax.jit(lambda p, b: model.prefill(p, b, n),
                             in_shardings=(p_sh, b_sh))
                logits, cache = fn(params, batch)
            np.savez(os.path.join(out_dir, f"prefill_{name}_{arch}.npz"),
                     logits=np.asarray(logits),
                     **{f"cache/{k}": np.asarray(v, dtype=np.float32)
                        if v.dtype == jnp.bfloat16 else np.asarray(v)
                        for k, v in flat(cache)})


# --------------------------------------------------------------------- port


def port_model(torch, arch: str, ref_dir: str):
    """The reduced model of ``arch`` in fp32 on the CPU, the reference's
    weights loaded."""
    from repro_torch.models import convert, registry

    cfg = registry.get_reduced_config(arch)
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    with np.load(os.path.join(ref_dir, f"init_{arch}.npz")) as z:
        model.load_state_dict(convert.params_from_jax(
            nest({k: z[k] for k in z.files}), cfg))
    return cfg, model


def port_inputs(torch, cfg) -> dict:
    return {k: torch.from_numpy(v) for k, v in inputs(cfg).items()}


def to_numpy(t) -> np.ndarray:
    """A tensor's values as numpy (bf16 as fp32: numpy has no bf16)."""
    import torch

    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def cache_arrays(cache) -> dict:
    """{path: numpy values} of a cache's tensor leaves (its layout left
    out)."""
    return {k: to_numpy(v) for k, v in flat(
        {k: v for k, v in cache.items() if k != "layout"})
        if hasattr(v, "numpy")}


def _serve(torch, mesh, arch, spec, rec) -> None:
    from repro_torch.models import meshctx
    from repro_torch.train import sharding
    from repro_torch.train.serve_step import greedy_generate

    cfg, model = port_model(torch, arch, spec["ref"])
    sharding.shard_model_(model, mesh)
    batch = port_inputs(torch, cfg)
    n = max_len(cfg)
    with meshctx.activation_mesh(mesh):
        logits, cache = model.prefill(batch, n)
        layout = {k: [list(map(list, v.ranges)), list(v.shape)]
                  for k, v in cache.get("layout", {}).items()}
        resident = sharding.resident_bytes(
            [x for _, x in flat({k: v for k, v in cache.items()
                                 if k != "layout"}) if hasattr(x, "numel")])
        np.savez(os.path.join(spec["out"], f"{spec['mesh']}_{arch}_r"
                              f"{torch.distributed.get_rank()}.npz"),
                 logits=logits.numpy(), **{f"cache/{k}": v for k, v in
                                           cache_arrays(cache).items()})
        del logits, cache
        toks = greedy_generate(model, cfg, batch, steps=STEPS, max_len=n)
        r12 = None
        if arch not in NO_R12:
            _, cache = model.prefill(batch, n)
            rows = sharding.serve_rows(batch, mesh)["tokens"][:, :1]
            for _ in range(n - cache["pos"]):
                model.decode_step(cache, rows)
            try:
                model.decode_step(cache, rows)
                r12 = "no error"
            except ValueError as e:
                r12 = str(e)
    rec[arch] = dict(tokens=toks.tolist(), layout=layout, resident=resident,
                     r12=r12)


def _tally(torch, mesh, arch, spec, rec) -> None:
    """The prefill and one decode step of ``arch`` counted on this rank:
    ``OpCost`` (arguments, collectives) and ``FlopCounterMode`` (FLOPs),
    the attention K6 would run hidden from both."""
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.op_cost import OpCost, tally_bytes
    from repro_torch.models import layers as L
    from repro_torch.models import meshctx
    from repro_torch.train import sharding

    from repro_torch.models.registry import get_model

    cfg = tally_config(arch)
    model = get_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    sharding.shard_model_(model, mesh)
    params = [sharding.local(p) for p in model.parameters()]
    batch = port_inputs(torch, cfg)
    attend = L._attend
    calls = [0]

    def hidden(*a, **k):
        calls[0] += 1
        with _disable_current_modes():
            return attend(*a, **k)
    L._attend = hidden
    try:
        with meshctx.activation_mesh(mesh):
            rows = sharding.serve_rows(batch, mesh)
            out = {}
            args = params + list(rows.values())
            with FlopCounterMode(display=False) as fc, \
                    OpCost(tally_bytes(args)) as t:
                _, cache = model.prefill(batch, max_len(cfg))
            out["prefill"] = _tally_record(t, fc, args, tally_bytes, calls)
            cache = model.init_cache(BATCH, max_len(cfg), torch.float32)
            tok = rows["tokens"][:, :1]
            args = params + [x for _, x in flat(
                {k: v for k, v in cache.items() if k != "layout"})
                if hasattr(x, "numel")] + [tok]
            with FlopCounterMode(display=False) as fc, \
                    OpCost(tally_bytes(args)) as t:
                model.decode_step(cache, tok)
            out["decode"] = _tally_record(t, fc, args, tally_bytes, calls)
    finally:
        L._attend = attend
    rec[arch] = out


def _tally_record(t, fc, args, tally_bytes, calls) -> dict:
    """One counted step's record; ``calls`` (the hidden attention calls,
    which K6 runs on a card) is read and reset."""
    rec = dict(args=tally_bytes(args), flops=float(fc.get_total_flops()),
               tally_flops=t.flops_total(), coll=t.collective_bytes(),
               k6_calls=calls[0])
    calls[0] = 0
    return rec


def port_rank(rank: int, world: int, store: str, spec: dict) -> None:
    import torch

    torch.set_num_threads(1)  # four ranks share the host's cores
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    rec: dict = {}
    try:
        mesh = make_mesh(MESHES[spec["mesh"]], ("data", "model"),
                         device_type="cpu")
        run = _serve if spec["what"] == "serve" else _tally
        for arch in spec.get("archs", ARCHS):
            run(torch, mesh, arch, spec, rec)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(spec["out"], f"{spec['what']}_{spec['mesh']}_"
                           f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def fake_main(out_dir: str) -> None:
    """Rank 0's prefill and decode of every case traced on ``meta`` on a
    fake 4-rank group, each mesh; writes ``fake.json``."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    dryrun.fake_world(WORLD)
    out: dict = {}
    for name, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        for arch in ARCHS:
            cfg = tally_config(arch)
            batch = {k: torch.empty(v.shape, dtype=getattr(torch, str(
                v.dtype)), device="meta") for k, v in inputs(cfg).items()}
            rec = {}
            for kind, b in (("prefill", batch),
                            ("decode", {"tokens": batch["tokens"][:, :1]})):
                r = dryrun.trace_step(cfg, kind, b, mesh,
                                      max_len=max_len(cfg),
                                      dtype=torch.float32)
                rec[kind] = r
            out[f"{name}/{arch}"] = rec
    with open(os.path.join(out_dir, "fake.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "fake":
        fake_main(sys.argv[2])
    else:
        reference_main(sys.argv[1])
