"""Shared runs of the train-step parity tests (``tests/test_torch_train_*``).

``train_case(lmref, arch, micro)`` trains the reduced config of ``arch`` in
fp32 for ``STEPS`` steps twice, with the reference's jitted
``make_train_step`` on its own parameters (``init`` with key 0) and with
the port's ``make_train_step`` on the same weights (``convert.
params_from_jax``), each fed its own package's ``make_batch`` (batch 4 ×
32 tokens, the batches bit-equal: ``test_torch_train_opt.py``). It
returns each side's metrics for every step, the parameters and moments
after the first step, the port's gradients at the initial weights
(``make_grad_fn``, mapped back through ``convert.params_to_jax``) and the
reference's, read off its first step: with fp32 moments,
``mu₁ = (1 − b1)·scale·g`` exactly up to one rounding, where ``scale =
min(1, clip / grad_norm)``.
"""

import numpy as np
import torch

from repro_torch.models import convert, registry
from repro_torch.train import data, optimizer, train_step

STEPS = 5
BATCH, SEQ = 4, 32
# peak 1e-3 after 2 warmup steps: the parameters move far enough in 5
# steps for the losses to change in their third digit
OPT = dict(peak_lr=1e-3, warmup_steps=2, stable_steps=10, decay_steps=2)


def _np(tree):
    """A copy of ``tree`` as numpy arrays (never a view of a tensor that a
    later step updates in place)."""
    import jax
    return jax.tree.map(np.array, tree)


def train_case(lmref, arch: str, micro: int) -> dict:
    import jax
    import jax.numpy as jnp

    cfg = registry.get_reduced_config(arch)
    jmodel = lmref.registry.get_model(cfg)
    jparams = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    jopt_cfg = lmref.optimizer.AdamWConfig(**OPT, moment_dtype=jnp.float32)
    jopt = lmref.optimizer.adamw_init(jparams, jopt_cfg)
    jstep = jax.jit(lmref.train_step.make_train_step(
        jmodel, cfg, jopt_cfg, microbatches=micro))

    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.params_from_jax(_np(jparams), cfg))
    opt_cfg = optimizer.AdamWConfig(**OPT, moment_dtype=torch.float32)
    opt = optimizer.adamw_init(dict(model.named_parameters()), opt_cfg)
    step = train_step.make_train_step(model, cfg, opt_cfg, microbatches=micro)

    out = dict(cfg=cfg, opt_cfg=opt_cfg, ref_metrics=[], metrics=[])
    for i in range(STEPS):
        jb = lmref.data.make_batch(
            cfg, lmref.data.SyntheticDataConfig(BATCH, SEQ + 1), i)
        b = {k: torch.from_numpy(v) for k, v in data.make_batch(
            cfg, data.SyntheticDataConfig(BATCH, SEQ + 1), i).items()}
        if i == 0:
            grads, _ = train_step.make_grad_fn(
                model, cfg, microbatches=micro)(b)
            out["grads"] = _np(convert.params_to_jax(grads, cfg))
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in jb.items()})
        opt, m = step(opt, b)
        out["ref_metrics"].append({k: float(v) for k, v in jm.items()})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["ref_params"] = _np(jparams)
            out["ref_mu"], out["ref_nu"] = _np(jopt.mu), _np(jopt.nu)
            out["params"] = _np(convert.params_to_jax(model.state_dict(),
                                                      cfg))
            port = _np(convert.opt_state_to_jax(opt, cfg))
            out["mu"], out["nu"] = port["mu"], port["nu"]
            out["ref_step"], out["step"] = int(jopt.step), int(port["step"])
            gnorm = out["ref_metrics"][0]["grad_norm"]
            scale = min(1.0, opt_cfg.grad_clip / max(gnorm, 1e-9))
            out["ref_grads"] = jax.tree.map(
                lambda m: m / ((1 - opt_cfg.b1) * scale), out["ref_mu"])
    return out


def leaves(tree, prefix=""):
    """(path, array) of a nested dict of arrays, in sorted order."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(val)


# Tolerances, stated once for the three test files. Loss metrics: 1e-5
# relative (the same fp32 arithmetic, sums in another order). A gradient
# leaf: 1e-4 of its largest |g|. With bf16 accumulators (the reduced
# qwen1.5-32b, arctic-480b and dbrx-132b keep their configs'
# grad_accum_dtype) and more than one microbatch, each microbatch's fp32
# gradient is rounded to bf16 and so is each sum: two fp32 values that
# differ in their last bits can round to neighbouring bf16 values, so a
# leaf is held to two bf16 ulp, 2⁻⁶ of its largest |g|. The moments follow
# the gradients. Parameters after one step: within the step's learning
# rate, since an element whose gradient is near 0 moves by lr·g/(|g| + eps)
# and that ratio reads the gradient's last bits. Losses over STEPS steps:
# 1e-4 relative.
METRIC_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_ACC_TOL = 2.0 ** -6
LOSS_RTOL = 1e-4


def grad_tol(r: dict, micro: int) -> float:
    return BF16_ACC_TOL if (micro > 1 and r["cfg"].grad_accum_dtype
                            == "bfloat16") else GRAD_TOL


def cached(runs: dict, lmref, arch: str, micro: int) -> dict:
    key = (arch, micro)
    if key not in runs:
        runs[key] = train_case(lmref, arch, micro)
    return runs[key]


def check_step_metrics(r: dict) -> None:
    got, want = r["metrics"][0], r["ref_metrics"][0]
    assert sorted(got) == sorted(want)
    for k in ("loss", "xent", "aux", "grad_norm", "lr", "ntok"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                   atol=0, err_msg=k)
    assert np.isfinite(got["loss"]) and got["grad_norm"] > 0
    if r["cfg"].family == "moe":
        assert got["aux"] > 0


def _leafwise(got_tree, want_tree, tol: float, what: str) -> None:
    got, want = list(leaves(got_tree)), list(leaves(want_tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, (what, key)
        scale = float(np.abs(w).max())
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= tol * scale, (what, key, err, scale)


def check_gradients(r: dict, micro: int) -> None:
    _leafwise(r["grads"], r["ref_grads"], grad_tol(r, micro), "grad")
    # every leaf gets a gradient
    assert all(float(np.abs(g).max()) > 0 for _, g in leaves(r["grads"]))


def check_params_and_moments(r: dict, micro: int) -> None:
    assert r["step"] == r["ref_step"] == 1
    tol = grad_tol(r, micro)
    _leafwise(r["mu"], r["ref_mu"], tol, "mu")
    _leafwise(r["nu"], r["ref_nu"], 2 * tol, "nu")  # g²
    lr = r["ref_metrics"][0]["lr"]
    got, want = list(leaves(r["params"])), list(leaves(r["ref_params"]))
    for (key, g), (_, w) in zip(got, want):
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= lr, (key, err, lr)


def check_losses(r: dict) -> None:
    got = [m["loss"] for m in r["metrics"]]
    want = [m["loss"] for m in r["ref_metrics"]]
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert len(set(got)) == STEPS  # the weights move
