"""Checkpoints, auto-resume and the one-card train driver of the port.

``save_checkpoint`` / ``restore_checkpoint``: a state of fp32, bf16 and
int32 leaves (an ``OptState`` among them) round-trips bit for bit, bf16
through its raw bits; ``keep`` GCs the oldest; ``latest_step`` reads the
directory as the reference's does (a ``tmp.<step>`` left by a crash is no
checkpoint); a crash between the write and the rename leaves the last
checkpoint intact and restorable; a restore into the wrong structure
raises. ``ElasticTrainer``, ``Heartbeat`` and ``rescale_microbatches``;
a run resumed from a checkpoint equals an uninterrupted run bit for bit on
the CPU (losses, weights and moments); and ``python -m
repro_torch.launch.train --device cpu`` run twice, the second run resuming
where the first stopped and ending on the uninterrupted run's numbers.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_reference import lmref  # noqa: F401

from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data, elastic, optimizer, train_step

ROOT = Path(__file__).resolve().parents[1]


def _state(seed: int):
    gen = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn(5, 3, generator=gen).bfloat16(),
              "blocks.0.w": torch.randn(3, 4, generator=gen),
              "blocks.0.b": torch.randn(4, generator=gen).half()}
    opt = optimizer.OptState(
        step=torch.tensor(seed, dtype=torch.int32),
        mu={k: torch.randn(v.shape, generator=gen).bfloat16()
            for k, v in params.items()},
        nu={k: torch.rand(v.shape, generator=gen) for k, v in params.items()})
    return {"params": params, "opt": opt}


def _zeros_like(state):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in state["params"].items()},
            "opt": optimizer.OptState(
                step=torch.zeros((), dtype=torch.int32),
                mu={k: torch.zeros_like(v)
                    for k, v in state["opt"].mu.items()},
                nu={k: torch.zeros_like(v)
                    for k, v in state["opt"].nu.items()})}


def _bits_equal(a, b):
    fa, fb = ckpt.flatten_state(a), ckpt.flatten_state(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k].view(torch.uint8) if fa[k].dim() else fa[k],
                           fb[k].view(torch.uint8) if fb[k].dim() else fb[k]), k


def test_round_trip_is_bit_exact(tmp_path):
    state = _state(7)
    path = ckpt.save_checkpoint(str(tmp_path), 7, state,
                                extra={"next_step": 8, "note": "x"})
    assert Path(path).name == "step_7"
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "x"
    assert manifest["dtypes"]["params/embed"] == "bfloat16"
    assert manifest["dtypes"]["opt/step"] == "int32"
    assert "opt/mu/blocks.0.w" in manifest["keys"]
    embed = np.load(Path(path) / manifest["files"]["params/embed"])
    assert embed.dtype == np.uint16 and embed.shape == (5, 3)  # raw bits
    like = _zeros_like(state)
    got, extra = ckpt.restore_checkpoint(str(tmp_path), 7, like)
    assert got is like and extra == {"next_step": 8, "note": "x"}
    _bits_equal(got, state)


def test_restore_into_the_wrong_structure_raises(tmp_path):
    state = _state(1)
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    like = _zeros_like(state)
    like["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(str(tmp_path), 1, like)
    like = _zeros_like(state)
    like["params"]["embed"] = torch.zeros(5, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="params/embed"):
        ckpt.restore_checkpoint(str(tmp_path), 1, like)


def test_gc_keeps_the_newest_and_latest_step_reads_like_reference(
        lmref, tmp_path):
    d = str(tmp_path / "run")
    assert ckpt.latest_step(d) is None
    for s in (1, 2, 3, 10, 11):
        ckpt.save_checkpoint(d, s, _state(s), keep=3)
    assert sorted(os.listdir(d)) == ["step_10", "step_11", "step_3"]
    os.makedirs(os.path.join(d, "tmp.12"))  # a crash's leftovers
    (tmp_path / "run" / "step_x").mkdir()
    assert ckpt.latest_step(d) == lmref.checkpoint.latest_step(d) == 11
    ckpt.save_checkpoint(d, 12, _state(12), keep=0)  # keep 0: no GC
    assert ckpt.latest_step(d) == 12
    assert sorted(os.listdir(d)) == ["step_10", "step_11", "step_12",
                                     "step_3", "step_x"]


def test_crash_between_write_and_rename_keeps_the_last(tmp_path,
                                                       monkeypatch):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 4, _state(4))

    def crash(src, dst):
        raise OSError("killed before the commit")

    monkeypatch.setattr(ckpt.os, "rename", crash)
    with pytest.raises(OSError, match="commit"):
        ckpt.save_checkpoint(d, 6, _state(6))
    monkeypatch.undo()
    assert (tmp_path / "tmp.6" / "manifest.json").exists()
    assert ckpt.latest_step(d) == 4
    got, _ = ckpt.restore_checkpoint(d, 4, _zeros_like(_state(4)))
    _bits_equal(got, _state(4))
    ckpt.save_checkpoint(d, 6, _state(6))  # a later save replaces the tmp
    assert sorted(os.listdir(d)) == ["step_4", "step_6"]


def test_heartbeat_and_rescale(tmp_path):
    hb = elastic.Heartbeat(str(tmp_path / "hb.json"), interval_s=3600)
    hb.beat(5)
    beat = json.loads((tmp_path / "hb.json").read_text())
    assert beat["step"] == 5 and beat["process"] == 0
    hb.beat(6)  # inside the interval: not rewritten
    assert json.loads((tmp_path / "hb.json").read_text())["step"] == 5
    assert elastic.rescale_microbatches(8, 4, 2) == 16
    assert elastic.rescale_microbatches(8, 4, 16) == 2
    with pytest.raises(ValueError):
        elastic.rescale_microbatches(3, 3, 2)


def test_trainer_save_cadence(tmp_path):
    tr = elastic.ElasticTrainer(str(tmp_path), save_every=2, keep=10)
    calls = []
    state, start = tr.resume_or_init(lambda: calls.append(1) or _state(0))
    assert start == 0 and calls == [1]
    for step in range(5):
        tr.maybe_save(step, state)
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_4"]
    tr.maybe_save(5, state, force=True)
    like = _zeros_like(state)
    got, start = tr.resume_or_init(lambda: _state(0), like=like)
    assert got is like and start == 6


ARCH = "gemma2-2b"


def _run(ckpt_dir, steps: int, *, stop: int = None):
    """Train the reduced ARCH (fp32 weights from seed 0, bf16 moments, 2
    microbatches) through ``ElasticTrainer`` (save every 2 steps) up to
    ``stop`` (default ``steps``) of a run of ``steps``; returns the losses
    of the steps it ran, the model and the optimizer state."""
    cfg = registry.get_reduced_config(ARCH)
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    opt_cfg = optimizer.AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                    stable_steps=steps, decay_steps=2)
    trainer = elastic.ElasticTrainer(str(ckpt_dir), save_every=2)

    def fresh():
        opt = train_step.init_train_state(model, cfg, opt_cfg,
                                          torch.Generator().manual_seed(0))
        return {"params": model.state_dict(), "opt": opt}

    state, start = trainer.resume_or_init(fresh)
    step_fn = train_step.make_train_step(model, cfg, opt_cfg, microbatches=2)
    ds = data.SyntheticDataset(cfg, data.SyntheticDataConfig(4, 17), start)
    losses = {}
    for step in range(start, steps if stop is None else stop):
        batch = {k: torch.from_numpy(v) for k, v in next(ds).items()}
        opt, m = step_fn(state["opt"], batch)
        state = {"params": model.state_dict(), "opt": opt}
        trainer.maybe_save(step, state)
        losses[step] = float(m["loss"])
    return losses, model, state["opt"], start


def test_resume_equals_an_uninterrupted_run_bit_for_bit(tmp_path):
    full, model, opt, _ = _run(tmp_path / "a", 6)
    first, _, _, start = _run(tmp_path / "b", 6, stop=4)  # saves at 2
    assert start == 0 and sorted(first) == [0, 1, 2, 3]
    # a crash after step 3: the newest checkpoint is step 2
    assert ckpt.latest_step(str(tmp_path / "b")) == 2
    rest, model2, opt2, start = _run(tmp_path / "b", 6)
    assert start == 3 and sorted(rest) == [3, 4, 5]
    for step in range(6):
        assert (first if step < 3 else rest)[step] == full[step], step
    for (n, p), (_, p2) in zip(model.state_dict().items(),
                               model2.state_dict().items()):
        assert torch.equal(p, p2), n
    assert int(opt.step) == int(opt2.step) == 6
    for name in opt.mu:
        assert opt2.mu[name].dtype == torch.bfloat16
        assert torch.equal(opt.mu[name], opt2.mu[name]), name
        assert torch.equal(opt.nu[name], opt2.nu[name]), name


def _driver(ckpt_dir, steps: int) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", str(steps), "--batch",
         "2", "--seq", "16", "--save-every", "2", "--ckpt-dir",
         str(ckpt_dir)], capture_output=True, text=True, env=env,
        timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_driver_resumes_where_it_stopped(tmp_path):
    first = _driver(tmp_path / "run", 3)
    name = registry.get_reduced_config(ARCH).name
    assert f"arch={name}" in first and "device=cpu" in first
    assert "resumed" not in first
    assert [ln.split()[1] for ln in first.splitlines()
            if ln.startswith("step")] == ["0", "2"]
    ckdir = tmp_path / f"run_{name}"
    assert sorted(os.listdir(ckdir)) == ["step_2"]  # the last, forced
    assert (tmp_path / f"run_{name}.hb").exists()
    second = _driver(tmp_path / "run", 5)
    assert f"resumed from {ckdir} at step 3" in second
    lines = [ln for ln in second.splitlines() if ln.startswith("step")]
    assert [ln.split()[1] for ln in lines] == ["4"]
    assert sorted(os.listdir(ckdir)) == ["step_2", "step_4"]
    whole = _driver(tmp_path / "whole", 5)
    want = [ln for ln in whole.splitlines() if ln.startswith("step")][-1]
    # the same loss and grad norm at step 4 as the uninterrupted run
    assert lines[-1].split()[:6] == want.split()[:6]


def test_train_modules_import_and_train_without_jax(tmp_path):
    """The training modules and the driver import neither JAX nor the
    reference (the AST audit of ``tests/test_torch_api.py`` reads their
    imports; this runs them with both blocked)."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.train.data, repro_torch.train.optimizer, "
            "repro_torch.train.train_step, repro_torch.train.checkpoint, "
            "repro_torch.train.elastic; "
            "from repro_torch.launch import train; "
            f"train.main(['--arch', 'mamba2-780m', '--reduced', '--device', "
            f"'cpu', '--steps', '2', '--batch', '2', '--seq', '8', "
            f"'--ckpt-dir', {str(tmp_path / 'ck')!r}])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "step    1  loss" in out.stdout
