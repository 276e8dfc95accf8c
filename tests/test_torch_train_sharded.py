"""The sharded train step on 4 gloo ranks on the CPU, against the port's
one-process step and the reference's own sharded step.

One spawn of 4 gloo ranks per mesh, (2, 2) and (1, 4) ``("data",
"model")``, runs every case (``tests/torch_sharded_train_cases.py``):

- one step of each of the ten reduced configs, and arctic-480b and
  qwen1.5-32b with ``fsdp=True``, from the weights of seed 0, against the
  same step in this process on one device: the loss metrics (rtol
  ``METRIC_RTOL``), the parameters (the reference's own sharded-step
  tolerances, rtol 5e-4 / atol 5e-5) and the moments leaf by leaf (as in
  ``tests/torch_train_cases.py``: 1e-4 of a leaf's largest value, 2⁻⁶
  with bf16 gradient accumulators; ``nu`` twice that);
- every rank's resident bytes (parameters and both moments) equal to the
  reckoning from the sanitised specs, and every leaf in its spec's
  placements;
- on (2, 2), gemma2-2b (two microbatches) and arctic-480b (``fsdp=True``,
  one microbatch: ``REF_CASES`` says why) from the reference's weights
  against the reference's sharded step on 4 forced host devices (one
  subprocess): loss and grad norm rtol 1e-4, parameters rtol 5e-4 / atol
  5e-5, the reference's own tolerances;
- ``ef_psum`` over the 4 ranks, three error-feedback steps, equal to the
  reference's under ``shard_map`` on the same inputs (to bounds far below
  one quantization step: the same int8 values and int32 sums);
- a run saved on (2, 2) resumes on (1, 4), on (4, 1) (in the (1, 4)
  spawn's process group) and in this process, the microbatches rescaled
  by ``rescale_microbatches``, and equals the uninterrupted (2, 2) run;
  restored into plain leaves with ``shardings``, each comes back a
  ``DTensor`` of its sharding whose full value is the stored one;
- ``launch/train.py`` under torchrun's environment on (2, 2), run twice
  (the second run resumes), equal to the one-process driver.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sharded_train_cases as cases

from repro_torch.models import convert, registry
from repro_torch.train import optimizer, train_step

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
RUN_TIMEOUT_S = 600
METRIC_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-5  # the reference's sharded-step check
REF_LOSS_RTOL = 1e-4
MOMENT_TOL, BF16_ACC_TOL = 1e-4, 2.0 ** -6
EF_DEQ_TOL, EF_RES_TOL = 1e-6, 1e-3  # of a leaf's largest |value|
CASE_NAMES = [cases.case_name(a, f) for a, f in cases.CASES]


@pytest.fixture(scope="module")
def work():
    with tempfile.TemporaryDirectory() as tmp:
        yield Path(tmp)


@pytest.fixture(scope="module")
def reference_run(work):
    """The reference's results on 4 forced host devices (one subprocess)."""
    out = work / "ref"
    out.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(TESTS)]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, str(TESTS / "torch_sharded_train_cases.py"),
         str(out)], env=env, cwd=str(out), capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "ref_metrics.json") as f:
        return dict(dir=out, metrics=json.load(f))


def _free_ports(n: int) -> list:
    """``n`` distinct ports free on localhost now."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _spawn(spec: dict, mesh: str) -> list:
    import torch.multiprocessing as mp

    out = Path(spec["out"])
    ctx = mp.start_processes(
        cases.port_rank, args=(cases.WORLD, str(out / f"store_{mesh}"),
                               dict(spec, mesh=mesh)),
        nprocs=cases.WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + RUN_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"the {mesh} ranks did not finish")
    ranks = []
    for r in range(cases.WORLD):
        with open(out / f"{mesh}_rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks


@pytest.fixture(scope="module")
def port_runs(work, reference_run):
    """Each mesh's rank records: (2, 2) first (it writes the checkpoint the
    (1, 4) spawn resumes from)."""
    out = work / "port"
    out.mkdir()
    spec = dict(out=str(out), ref=str(reference_run["dir"]),
                ckpt=str(work / "ckpt"), launch_dir=str(work / "launch"),
                ports=_free_ports(2))
    return dict(out=out, spec=spec,
                ranks={m: _spawn(spec, m) for m in ("2x2", "1x4")})


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process step of each case, in this process."""
    runs = {}

    def get(arch, fsdp, init=None):
        key = (arch, fsdp, init)
        if key not in runs:
            cfg, model = cases.port_model(torch, arch, fsdp, init)
            opt_cfg = cases.port_opt_cfg(torch)
            opt = optimizer.adamw_init(dict(model.named_parameters()),
                                       opt_cfg)
            step = train_step.make_train_step(model, cfg, opt_cfg,
                                              microbatches=cases.MICRO)
            opt, m = step(opt, cases.port_batch(torch, cfg))
            runs[key] = dict(
                cfg=cfg, metrics={k: float(v) for k, v in m.items()},
                params={n: p.detach().numpy().copy()
                        for n, p in model.named_parameters()},
                mu={n: t.numpy().copy() for n, t in opt.mu.items()},
                nu={n: t.numpy().copy() for n, t in opt.nu.items()})
        return runs[key]

    return get


def _moment_tol(cfg) -> float:
    return BF16_ACC_TOL if (cases.MICRO > 1 and cfg.grad_accum_dtype
                            == "bfloat16") else MOMENT_TOL


def _check_leafwise(got: dict, want: dict, tol: float, what: str) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        scale = float(np.abs(want[key]).max())
        err = float(np.abs(got[key].astype(np.float64) - want[key]).max())
        assert err <= tol * scale, (what, key, err, scale)


@pytest.mark.parametrize("case", list(cases.CASES),
                         ids=[cases.case_name(a, f) for a, f in cases.CASES])
@pytest.mark.parametrize("mesh", sorted(cases.MESHES))
def test_sharded_step_equals_one_process_step(port_runs, one_process, mesh,
                                             case):
    arch, fsdp = case
    name = cases.case_name(arch, fsdp)
    want = one_process(arch, fsdp)
    got = cases.load_saved(str(port_runs["out"] / f"{mesh}_{name}.npz"))
    for r in port_runs["ranks"][mesh]:
        m = r["cases"][name]["metrics"]
        for k in ("loss", "xent", "aux", "ntok", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], want["metrics"][k],
                                       rtol=METRIC_RTOL, atol=0, err_msg=k)
    assert sorted(got["params"]) == sorted(want["params"])
    for n, w in want["params"].items():
        np.testing.assert_allclose(got["params"][n], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=n)
    tol = _moment_tol(want["cfg"])
    _check_leafwise(got["mu"], want["mu"], tol, "mu")
    _check_leafwise(got["nu"], want["nu"], 2 * tol, "nu")


@pytest.mark.parametrize("case", CASE_NAMES)
@pytest.mark.parametrize("mesh", sorted(cases.MESHES))
def test_resident_bytes_equal_the_reckoning(port_runs, mesh, case):
    recs = [r["cases"][case] for r in port_runs["ranks"][mesh]]
    assert all(r["placements"] for r in recs)
    assert all(r["resident"] == r["reckoned"] for r in recs), recs
    # every rank holds the same share; a model split no way holds it all
    assert len({r["resident"] for r in recs}) == 1


@pytest.mark.parametrize("case", cases.REF_CASES,
                         ids=[cases.case_name(a, f) for a, f, _ in
                              cases.REF_CASES])
def test_sharded_step_equals_reference_sharded_step(reference_run, port_runs,
                                                    case):
    arch, fsdp, _ = case
    name = cases.case_name(arch, fsdp)
    ref = reference_run["metrics"][name]
    for r in port_runs["ranks"]["2x2"]:
        m = r["cases"]["ref_" + name]["metrics"]
        np.testing.assert_allclose(m["loss"], ref["loss"], rtol=REF_LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"],
                                   rtol=REF_LOSS_RTOL)
    cfg = registry.get_reduced_config(arch)
    got = cases.load_saved(str(port_runs["out"] / f"2x2_ref_{name}.npz"))
    got = dict(cases._flat(convert.params_to_jax(
        {k: torch.from_numpy(v) for k, v in got["params"].items()}, cfg)))
    with np.load(reference_run["dir"] / f"ref_step_{name}.npz") as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("mesh", sorted(cases.MESHES))
def test_ef_psum_equals_reference(reference_run, port_runs, mesh):
    with np.load(reference_run["dir"] / "ref_ef.npz") as z:
        want = {k: z[k] for k in z.files}
    # The reference's jit may scale by the reciprocal of 127 and fuse
    # gf − q·scale, so its values can differ from the port's divisions in
    # their last bits. Both bounds are far below one quantum (a flipped
    # int8 value moves a sum by ≥ 1/508 of the leaf's largest and a
    # residual by twice its largest), so the int8 values and their int32
    # sums are the same.
    for r in range(cases.WORLD):
        with np.load(port_runs["out"] / f"{mesh}_ef_rank{r}.npz") as z:
            for k in z.files:
                w = want[k][r]
                tol = (EF_DEQ_TOL if k.endswith("deq") else EF_RES_TOL)
                np.testing.assert_allclose(z[k], w, rtol=0,
                                           atol=tol * np.abs(w).max(),
                                           err_msg=k)
    # the dequantized sum is the same on every rank, and near the true sum
    for k in cases.EF_SHAPES:
        total = sum(cases.ef_inputs(r, 0)[k] for r in range(cases.WORLD))
        deq = want[f"{k}/0/deq"]
        assert all(np.array_equal(deq[0], d) for d in deq)
        scale = max(np.abs(cases.ef_inputs(r, 0)[k]).max()
                    for r in range(cases.WORLD)) / 127
        assert np.abs(deq[0] - total).max() <= cases.WORLD * scale / 2 + 1e-7


def _resume_want(port_runs):
    rec = port_runs["ranks"]["2x2"][0]["uninterrupted"]
    full = cases.load_saved(str(port_runs["out"] / "uninterrupted.npz"))
    return rec["losses"][cases.RESUME_SAVE + 1:], full["params"]


@pytest.mark.parametrize("target", ["1x4", "4x1", "one_process"])
def test_resume_on_another_mesh_equals_uninterrupted_run(port_runs, target):
    from repro_torch.train.elastic import rescale_microbatches

    losses_want, params_want = _resume_want(port_runs)
    if target == "one_process":
        cfg = cases.port_model(torch, cases.RESUME_ARCH, False)[0]
        micro = rescale_microbatches(cases.MICRO, 2, 1)
        start, losses, params = cases._resume_run(
            torch, None, cfg, port_runs["spec"]["ckpt"], micro)
    else:
        recs = [r[f"resume_{target}"] for r in port_runs["ranks"]["1x4"]]
        assert all(r == recs[0] for r in recs)
        start, losses = recs[0]["start"], recs[0]["losses"]
        assert recs[0]["micro"] == rescale_microbatches(
            cases.MICRO, 2, 1 if target == "1x4" else 4)
        params = cases.load_saved(str(port_runs["out"]
                                      / f"resume_{target}.npz"))["params"]
    assert start == cases.RESUME_SAVE + 1
    if target != "one_process":  # and restored into plain leaves, placed
        assert all(r[f"placed_{target}"] == dict(
            ok=True, next_step=start) for r in port_runs["ranks"]["1x4"])
    np.testing.assert_allclose(losses, losses_want, rtol=METRIC_RTOL)
    for n, w in params_want.items():
        np.testing.assert_allclose(params[n], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=n)


def test_launch_train_resumes_under_gloo_ranks(port_runs, tmp_path):
    from repro_torch.launch import train
    from repro_torch.train import checkpoint

    runs = [r["launch"]["runs"] for r in port_runs["ranks"]["2x2"]]
    first, second = runs[0]
    assert first["rc"] == second["rc"] == 0
    assert "mesh={'data': 2, 'model': 2}" in first["out"]
    assert "resumed from" not in first["out"]
    assert f"at step {cases.LAUNCH_FIRST}" in second["out"]
    assert f"step    {cases.LAUNCH_STEPS - 1}" in second["out"]
    assert all(r[0]["out"] == "" and r[1]["out"] == "" for r in runs[1:])
    # the one-process driver over the same steps, in this process
    one = str(tmp_path / "one")
    assert train.main(cases.LAUNCH_ARGS + ["--steps", str(cases.LAUNCH_STEPS),
                                           "--ckpt-dir", one]) == 0
    cfg = registry.get_reduced_config("gemma2-2b")
    sharded = Path(f"{port_runs['spec']['launch_dir']}_{cfg.name}")
    plain = Path(f"{one}_{cfg.name}")
    last = cases.LAUNCH_STEPS - 1
    assert checkpoint.latest_step(str(sharded)) == last
    with open(sharded / f"step_{last}" / "manifest.json") as f:
        ms = json.load(f)
    with open(plain / f"step_{last}" / "manifest.json") as f:
        mp_ = json.load(f)
    assert ms["keys"] == mp_["keys"] and ms["dtypes"] == mp_["dtypes"]
    assert ms["extra"] == mp_["extra"] == {"next_step": cases.LAUNCH_STEPS}

    def value(d, man, key):
        a = np.load(d / f"step_{last}" / man["files"][key])
        if man["dtypes"][key] == "bfloat16":  # raw bits
            a = torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).float().numpy()
        return a

    for key in ms["keys"]:
        a, b = value(sharded, ms, key), value(plain, mp_, key)
        assert a.shape == b.shape, key
        if key.startswith("params/"):
            np.testing.assert_allclose(a, b, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=key)
        elif key != "opt/step":  # the config's bf16 moments: two ulp
            _check_leafwise({key: a}, {key: b}, BF16_ACC_TOL, "moment")
        else:
            assert a == b == cases.LAUNCH_STEPS
