"""Multi-pod dry run: trace every (arch × shape × mesh) cell shape-only and
show that it shards coherently and what it needs of each card, with no
hardware.

The port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell on 512 placeholder devices; the port has no compiler to ask, so it
runs rank 0's program of the cell on the ``meta`` device inside a fake
``torch.distributed`` group of the mesh's size (the ``"fake"`` backend of
``torch.testing._internal.distributed.fake_pg``: every collective returns
at once, nothing moves). Parameters are ``shard_model_``'s ``DTensor``
shards, the step runs under ``activation_mesh(mesh)``, and K6 and K4 are
shape-only on ``meta`` (their wrappers record the work the card would
do). ``launch.op_cost.OpCost`` counts the step as it runs: FLOPs by dtype,
HBM bytes, collective bytes by kind and group, the kernels' launches and
work, and the live bytes' peak, from which ``launch.roofline`` prices the
three roofline terms at the H100's data-sheet rates. Nothing is allocated
and no kernel is built or launched.

A fake group holds one world size, so each mesh runs in a process of its
own: ``--mesh both`` runs itself once a mesh as a subprocess.

Usage (no GPU needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --tc    # paper-core cell

Each cell prints one JSON line: the reference's keys where they mean the
same (``arch``, ``shape``, ``mesh`` "16x16", ``kind``, ``chips``,
``status``, ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``
/ ``temp_size_in_bytes``, ``roofline.*``, ``params_b``,
``active_params_b``), with ``memory.peak_bytes``, ``fits`` (the peak
against the card's 80 GB) and ``trace_s`` in place of ``lower_s`` /
``compile_s``. A cell that raises is a ``status: "error"`` record and
the exit code is 1; the documented skip stays ``status: "skipped"``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_mesh
from repro_torch.launch.op_cost import OpCost, tally_bytes
from repro_torch.launch.roofline import roofline_terms
from repro_torch.launch.specs import (SHAPES, cell_spec, input_specs,
                                      skip_reason)
from repro_torch.models import layers as L
from repro_torch.models.meshctx import activation_mesh
from repro_torch.models.registry import ARCHS, get_config, get_model
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.sharding import (local, serve_rows, shard_model_)
from repro_torch.train.train_step import make_train_step

__all__ = ["CARD_BYTES", "fake_world", "lower_cell", "lower_tc", "main",
           "production_mesh", "trace_step"]

#: The card's memory: an H100 SXM5 holds 80 GB of HBM3 (data sheet).
CARD_BYTES = 80 * 10 ** 9

def fake_world(world: int, rank: int = 0) -> None:
    """Make the default process group a fake one of ``world`` ranks, this
    process being ``rank``: once a process (a ``DeviceMesh`` keeps its
    groups by name, so another world needs another process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def production_mesh(multi_pod: bool):
    """The reference's production mesh over a fake group of its size, on
    the ``"cpu"`` device type (the dry run's tensors are ``meta``)."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    world = 1
    for s in shape:
        world *= s
    if not dist.is_initialized():
        fake_world(world)
    return make_mesh(shape, axes, device_type="cpu")


def mesh_name(mesh) -> str:
    return "x".join(str(int(n)) for n in mesh.mesh.shape)


def _model_flops_per_chip(cfg, cell, chips: int) -> float:
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens / chips
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens / chips
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch / chips


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k != "layout":
                yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _opt_config(cfg) -> AdamWConfig:
    return AdamWConfig(moment_dtype=torch.bfloat16
                       if cfg.adam_dtype == "bfloat16" else torch.float32)


def trace_step(cfg, kind: str, batch: Dict[str, torch.Tensor], mesh, *,
               max_len: Optional[int] = None, dtype=torch.bfloat16,
               model_flops: float = 0.0) -> dict:
    """Trace one step of ``cfg``'s model, on ``meta``, as this process's
    rank of ``mesh`` runs it, and return its record: ``memory`` (the
    step's arguments, outputs, temporaries and peak live bytes), ``fits``,
    ``roofline``, ``kernels`` ({name: launches}) and ``trace_s``.

    Args:
      cfg: the model's config.
      kind: "train" (``make_train_step``: weights, AdamW moments and the
        batch), "prefill" (``model.prefill(batch, max_len)``) or "decode"
        (``model.decode_step`` of one token against ``init_cache`` of the
        batch's rows and ``max_len`` positions, in ``dtype``).
      batch: the global batch, ``meta`` tensors (``input_specs``); for
        decode, ``{"tokens": (B, 1)}``.
      mesh: the ``DeviceMesh`` (device type "cpu") over the fake group.
      max_len: the cache's positions (prefill and decode).
      dtype: the weights' dtype.
      model_flops: the cell's model FLOPs a chip (the roofline's useful
        ratio).
    """
    t0 = time.perf_counter()
    with activation_mesh(mesh):
        model = get_model(cfg, device="meta", dtype=dtype)
        shard_model_(model, mesh, fsdp=cfg.fsdp)
        params = [local(p) for p in model.parameters()]
        rows = serve_rows(batch, mesh)
        if kind == "train":
            L.trainable_(model)
            opt_cfg = _opt_config(cfg)
            opt = adamw_init(dict(model.named_parameters()), opt_cfg)
            state = [local(x) for x in list(opt.mu.values())
                     + list(opt.nu.values())] + [opt.step]
            step = make_train_step(model, cfg, opt_cfg)
            args = params + state + list(rows.values())
            tally = OpCost(tally_bytes(args))
            with tally:
                opt, metrics = step(opt, batch)
            outputs = list(metrics.values())
        elif kind == "prefill":
            args = params + list(rows.values())
            tally = OpCost(tally_bytes(args))
            with tally:
                logits, cache = model.prefill(batch, max_len)
            outputs = [logits] + list(_leaves(cache))
            del logits, cache
        elif kind == "decode":
            b = batch["tokens"].shape[0]
            cache = model.init_cache(b, max_len, dtype)
            tokens = rows["tokens"]
            args = params + list(_leaves(cache)) + [tokens]
            tally = OpCost(tally_bytes(args))
            with tally:
                logits, cache = model.decode_step(cache, tokens)
            outputs = [logits]
            del logits
        else:
            raise ValueError(f"unknown step kind {kind!r}")
    arg_b = tally_bytes(args)
    out_b = tally_bytes([o for o in outputs
                         if not any(o.untyped_storage() is a.untyped_storage()
                                    for a in args)])
    rl = roofline_terms(tally, model_flops_per_chip=model_flops)
    mem = dict(argument_size_in_bytes=arg_b, output_size_in_bytes=out_b,
               temp_size_in_bytes=max(0, tally.peak_bytes - arg_b - out_b),
               peak_bytes=tally.peak_bytes)
    return dict(memory=mem, fits=tally.peak_bytes <= CARD_BYTES,
                roofline=rl.as_dict(), kernels=tally.kernel_launches(),
                aten_flops=tally.flops_total(),
                collectives=len(tally.collectives), ops=tally.ops,
                trace_s=round(time.perf_counter() - t0, 3))


def lower_cell(arch: str, shape: str, mesh) -> dict:
    """Trace one production cell; returns the dry-run record."""
    cfg = get_config(arch)
    cell = cell_spec(arch, shape)
    chips = int(mesh.size())
    rec = dict(arch=arch, shape=shape, mesh=mesh_name(mesh), kind=cell.kind,
               chips=chips)
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    specs = input_specs(arch, shape)
    if cell.kind == "decode":
        batch, max_len = {"tokens": specs["tokens"]}, cell.seq_len
    else:
        batch = specs
        # VLM caches cover vision prefix + text
        max_len = cell.seq_len + (cfg.vision_tokens if cfg.family == "vlm"
                                  else 0)
    out = trace_step(cfg, cell.kind, batch, mesh, max_len=max_len,
                     model_flops=_model_flops_per_chip(cfg, cell, chips))
    rec.update(status="ok", **out, params_b=cfg.param_count(),
               active_params_b=cfg.active_param_count())
    return rec


def lower_tc(mesh, *, tiles: int = 8192, block: int = 128) -> dict:
    """Trace the paper core: one rank's stage of the ``"matrix_distributed"``
    lane on the mesh, through the same bound launch ``plan_triangle_count(
    g, "matrix_distributed", mesh=mesh)`` takes from ``engine.
    get_executable``, over a synthetic dealt schedule of ``ceil(tiles /
    chips)`` triples of ``block``-edge tiles (the lane's bf16 tiles at
    block 128, each triple its own L and U tiles), then ``count()``'s one
    scalar all-reduce over the mesh's ranks."""
    from repro_torch.core import engine
    from repro_torch.kernels.masked_spgemm import WGMMA_BLOCKS

    chips = int(mesh.size())
    t_per = -(-tiles // chips)
    dt = torch.bfloat16 if block in WGMMA_BLOCKS else torch.float32
    t0 = time.perf_counter()
    fn = engine.get_executable("matrix_distributed", "kernel",
                               (t_per, block, block), mesh=mesh)
    l_blocks = torch.empty((t_per, block, block), dtype=dt, device="meta")
    u_blocks = torch.empty((t_per, block, block), dtype=dt, device="meta")
    index = [torch.empty((t_per,), dtype=torch.int32, device="meta")
             for _ in range(4)]  # l, u, a indices and the launch order
    args = [l_blocks, u_blocks] + index
    tally = OpCost(tally_bytes(args))
    with tally:
        total = fn(l_blocks, u_blocks, u_blocks, *index)
        dist.all_reduce(total, group=engine.mesh_group(mesh))
    rl = roofline_terms(tally, model_flops_per_chip=2 * t_per * block ** 3)
    arg_b = tally_bytes(args)
    return dict(arch="tc-masked-spgemm", shape=f"tiles{tiles}",
                mesh=mesh_name(mesh), kind="count", chips=chips,
                status="ok", trace_s=round(time.perf_counter() - t0, 3),
                tiles_per_shard=t_per, block=block,
                memory=dict(argument_size_in_bytes=arg_b,
                            output_size_in_bytes=tally_bytes([total]),
                            temp_size_in_bytes=max(
                                0, tally.peak_bytes - arg_b),
                            peak_bytes=tally.peak_bytes),
                fits=tally.peak_bytes <= CARD_BYTES,
                roofline=rl.as_dict(), kernels=tally.kernel_launches())


def _cells(args):
    if args.tc:
        return [("tc", None)]
    if args.all:
        return [(a, s) for a in ARCHS for s in SHAPES]
    if not args.arch:
        raise SystemExit("--arch, --all, or --tc required")
    shapes = [args.shape] if args.shape else list(SHAPES)
    return [(args.arch, s) for s in shapes]


def _emit(rec: dict, out: Optional[str]) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tc", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)
    cells = _cells(args)
    if args.mesh == "both":  # one process a mesh: a fake group, one size
        argv = list(sys.argv[1:] if argv is None else argv)
        rc = 0
        for name in ("single", "multi"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"] + [
                a for a in argv if not a.startswith("--mesh")
                and a not in ("single", "multi", "both")] + ["--mesh", name]
            rc |= subprocess.run(cmd, env=dict(os.environ)).returncode
        return 1 if rc else 0
    mesh = production_mesh(args.mesh == "multi")
    failures = 0
    for arch, shape in cells:
        try:
            rec = lower_tc(mesh) if arch == "tc" else \
                lower_cell(arch, shape, mesh)
        except Exception as e:  # a dry-run failure is a bug: report it
            failures += 1
            rec = dict(arch=arch, shape=shape, mesh=mesh_name(mesh),
                       status="error", error=repr(e),
                       trace=traceback.format_exc()[-2000:])
        _emit(rec, args.out)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
