"""One-card training driver: auto-resuming, checkpointed.

The port of ``repro.launch.train`` for one device (no production mesh, no
model parallelism), on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --steps 50 --reduced --batch 8 --seq 128 --device cpu

It builds the model with fp32 weights drawn from seed 0 (the reference's
``fresh()``), AdamW with a WSD schedule (warmup and decay a tenth of
``--steps``, moments in the config's ``adam_dtype``), and the microbatched
train step with ``min(cfg.microbatches, --batch)`` microbatches. It
resumes from the newest checkpoint in ``<ckpt-dir>_<arch>`` (printing
the step it resumes at), saves every ``--save-every`` steps and once more
after the last, beats ``<ckpt-dir>_<arch>.hb``, and prints the reference's
step lines (every tenth step and the last).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.graphs.device import resolve_device
from repro_torch.models.registry import get_config, get_model, get_reduced_config
from repro_torch.train.data import SyntheticDataConfig, SyntheticDataset
from repro_torch.train.elastic import ElasticTrainer, Heartbeat
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="the same-family scale-down (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default="build/train_ckpt",
                    help="checkpoints go to <ckpt-dir>_<arch>")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain paths")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    model = get_model(cfg, device=dev, dtype=torch.float32)
    opt_cfg = AdamWConfig(
        peak_lr=3e-4, warmup_steps=max(args.steps // 10, 1),
        stable_steps=args.steps, decay_steps=max(args.steps // 10, 1),
        moment_dtype=torch.bfloat16 if cfg.adam_dtype == "bfloat16"
        else torch.float32)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={dev}", flush=True)

    base = f"{args.ckpt_dir}_{cfg.name}"
    trainer = ElasticTrainer(ckpt_dir=base, save_every=args.save_every,
                             heartbeat=Heartbeat(f"{base}.hb"))

    def fresh():
        opt = init_train_state(model, cfg, opt_cfg,
                               torch.Generator(device=dev).manual_seed(0))
        return {"params": model.state_dict(), "opt": opt}

    state, start = trainer.resume_or_init(fresh)
    if start:
        print(f"resumed from {base} at step {start}", flush=True)
    step_fn = make_train_step(model, cfg, opt_cfg,
                              microbatches=min(cfg.microbatches, args.batch))
    ds = SyntheticDataset(cfg, SyntheticDataConfig(args.batch, args.seq + 1),
                          start)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(ds).items()}
        opt, m = step_fn(state["opt"], batch)
        state = {"params": model.state_dict(), "opt": opt}
        trainer.maybe_save(step, state)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"{time.time() - t0:6.1f}s", flush=True)
    trainer.maybe_save(args.steps - 1, state, force=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
