"""Training driver: mesh-aware, sharded, auto-resuming, checkpointed.

The port of ``repro.launch.train``. Run alone it trains on one device, on
the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --steps 50 --reduced --batch 8 --seq 128 --device cpu

Under ``torchrun`` (``WORLD_SIZE`` set) every rank runs it: it initialises
the process group (NCCL with the card of ``LOCAL_RANK``, or gloo with
``--device cpu``), builds ``make_local_mesh(--model-parallel)``, or
``make_production_mesh()`` with ``--production-mesh`` (256 ranks), shards
the parameters and moments by ``sharding.param_shardings(fsdp=cfg.fsdp)``
and runs each step under ``activation_mesh``; rank 0 prints:

    PYTHONPATH=src torchrun --nproc-per-node=4 -m repro_torch.launch.train \\
        --arch gemma2-2b --steps 50 --batch 8 --seq 128 --model-parallel 2

It builds the model with fp32 weights drawn from seed 0 (the reference's
``fresh()``), AdamW with a WSD schedule (warmup and decay a tenth of
``--steps``, moments in the config's ``adam_dtype``), and the microbatched
train step with ``min(cfg.microbatches, --batch / data ranks)``
microbatches (each data rank splits its own rows). It resumes from the
newest checkpoint in ``<ckpt-dir>_<arch>`` (printing the step it resumes
at; the checkpoint may come from another mesh), saves every
``--save-every`` steps and once more after the last, beats
``<ckpt-dir>_<arch>.hb`` (``.r<rank>.hb`` on rank r > 0), and prints the
reference's step lines (every tenth step and the last). A mesh flag
without ``torchrun`` raises ``ProcessGroupNotInitializedError``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.graphs.device import resolve_device
from repro_torch.launch.mesh import (data_axes, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import layers as L
from repro_torch.models.meshctx import activation_mesh
from repro_torch.models.registry import get_config, get_model, get_reduced_config
from repro_torch.train.data import SyntheticDataConfig, SyntheticDataset
from repro_torch.train.elastic import ElasticTrainer, Heartbeat
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.sharding import axis_sizes, shard_model_
from repro_torch.train.train_step import make_train_step


def _mesh(args):
    """(mesh or None, device): the process group and mesh under torchrun,
    else none and the one device."""
    if "WORLD_SIZE" not in os.environ:
        if args.production_mesh:
            return make_production_mesh(), None
        if args.model_parallel != 1:
            return make_local_mesh(args.model_parallel), None
        return None, resolve_device(args.device)
    cpu = args.device == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl")
    kind = "cpu" if cpu else "cuda"
    mesh = (make_production_mesh(device_type=kind) if args.production_mesh
            else make_local_mesh(args.model_parallel, device_type=kind))
    return mesh, dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="the same-family scale-down (CPU-runnable)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 pod mesh (256 ranks under torchrun)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt",
                    help="checkpoints go to <ckpt-dir>_<arch>")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain paths "
                         "(gloo under torchrun)")
    args = ap.parse_args(argv)

    mesh, dev = _mesh(args)
    try:
        return _train(args, mesh, dev)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, mesh, dev) -> int:
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    model = get_model(cfg, device=dev, dtype=torch.float32)
    opt_cfg = AdamWConfig(
        peak_lr=3e-4, warmup_steps=max(args.steps // 10, 1),
        stable_steps=args.steps, decay_steps=max(args.steps // 10, 1),
        moment_dtype=torch.bfloat16 if cfg.adam_dtype == "bfloat16"
        else torch.float32)
    dp = 1
    if mesh is not None:
        sizes = axis_sizes(mesh)
        for a in data_axes(mesh):
            dp *= sizes[a]
    where = (f"mesh={axis_sizes(mesh)} device={dev}" if mesh is not None
             else f"device={dev}")
    say(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M {where}",
        flush=True)

    base = f"{args.ckpt_dir}_{cfg.name}"
    trainer = ElasticTrainer(
        ckpt_dir=base, save_every=args.save_every,
        heartbeat=Heartbeat(f"{base}.hb" if rank == 0
                            else f"{base}.r{rank}.hb"))

    def fresh():
        model.init(torch.Generator(device=dev).manual_seed(0))
        L.trainable_(model)
        if mesh is not None:
            shard_model_(model, mesh, fsdp=cfg.fsdp)
        opt = adamw_init(dict(model.named_parameters()), opt_cfg)
        return {"params": model.state_dict(), "opt": opt}

    state, start = trainer.resume_or_init(fresh)
    if start:
        say(f"resumed from {base} at step {start}", flush=True)
    step_fn = make_train_step(
        model, cfg, opt_cfg,
        microbatches=max(1, min(cfg.microbatches, args.batch // dp)))
    ds = SyntheticDataset(cfg, SyntheticDataConfig(args.batch, args.seq + 1),
                          start)
    t0 = time.time()
    with activation_mesh(mesh):
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(ds).items()}
            opt, m = step_fn(state["opt"], batch)
            state = {"params": model.state_dict(), "opt": opt}
            trainer.maybe_save(step, state)
            if step % 10 == 0 or step == args.steps - 1:
                say(f"step {step:4d}  loss {float(m['loss']):.4f}  "
                    f"gnorm {float(m['grad_norm']):.3f}  "
                    f"{time.time() - t0:6.1f}s", flush=True)
        trainer.maybe_save(args.steps - 1, state, force=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
