"""One train step, and five, of the port against the reference's
``make_train_step``: the moe and vlm families (arctic-480b, dbrx-132b, paligemma-3b).

Reduced configs in fp32, converted weights, identical ``make_batch``
inputs, fp32 moments, microbatches 1 and 2 (the strided split and the
accumulation): the loss, xent, aux, ntok, grad_norm and lr of the first
step; every gradient leaf (mapped back through ``convert.params_to_jax``);
the parameters and moments after the step; the losses of five steps.
Covers the MoE dispatch and its load-balance aux (arctic with its dense residual), both with bf16 gradient accumulators, and the VLM's bidirectional image prefix through vision_proj. Tolerances: ``tests/torch_train_cases.py``.
"""

import pytest

from torch_reference import lmref  # noqa: F401

import torch_train_cases as cases

ARCHS = ["arctic-480b", "dbrx-132b", "paligemma-3b"]
CASES = [(a, m) for a in ARCHS for m in (1, 2)]


@pytest.fixture(scope="module")
def runs(lmref):
    return {}


@pytest.mark.parametrize("arch,micro", CASES)
def test_first_step_metrics_match_reference(lmref, runs, arch, micro):
    cases.check_step_metrics(cases.cached(runs, lmref, arch, micro))


@pytest.mark.parametrize("arch,micro", CASES)
def test_gradients_match_reference_leaf_by_leaf(lmref, runs, arch, micro):
    cases.check_gradients(cases.cached(runs, lmref, arch, micro), micro)


@pytest.mark.parametrize("arch,micro", CASES)
def test_params_and_moments_after_a_step(lmref, runs, arch, micro):
    cases.check_params_and_moments(cases.cached(runs, lmref, arch, micro),
                                   micro)


@pytest.mark.parametrize("arch,micro", CASES)
def test_losses_over_five_steps(lmref, runs, arch, micro):
    cases.check_losses(cases.cached(runs, lmref, arch, micro))
