"""Sharded serving on 4 gloo ranks on the CPU, against the port's
one-process serving and the reference's own sharded prefill.

One spawn of 4 gloo ranks per mesh, (2, 2) and (1, 4) ``("data",
"model")``, serves every reduced config (``tests/torch_sharded_serve_cases
.py``) from the reference's weights in fp32: the reduced gemma2-2b,
arctic-480b and dbrx-132b (kv 2) and paligemma-3b (kv 1) split their KV
caches by sequence on (1, 4), where the decode attention merges the ranks'
partial softmaxes; paligemma-3b also on (2, 2); the others split by kv
heads; the ssm and hybrid families' caches split over the batch only.
Each case is held:

- against one-process serving in this process: each rank's prefill logits
  (its rows), each leaf of its cache shard (the block its ``layout``
  names, or its rows) and every row's greedy tokens (tolerances of
  ``tests/test_torch_train_sharded.py``: rtol 5e-4 / atol 5e-5; int8
  cache values within one quantization step);
- against the reference's ``jax.jit(model.prefill, in_shardings=...)`` on
  4 forced host devices, the same mesh (one subprocess, the R1 shim
  only): the logits and the cache leaves, block by block;
- a decode past the cache raises ``ValueError`` on every rank (R12);

and, with no ranks, the partial form of the decode attention, two halves
of the keys merged by their log-sum-exp, equal to ``decode_attention``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sharded_serve_cases as cases

from repro_torch.models import layers as L
from repro_torch.train.serve_step import greedy_generate

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
RUN_TIMEOUT_S = 600
RTOL, ATOL = 5e-4, 5e-5
MESH_NAMES = list(cases.MESHES)


@pytest.fixture(scope="module")
def work():
    with tempfile.TemporaryDirectory() as tmp:
        yield Path(tmp)


def run_reference(out: Path) -> None:
    """The reference's weights and sharded prefills, in a subprocess on 4
    forced host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(TESTS)]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, str(TESTS / "torch_sharded_serve_cases.py"),
         str(out)], env=env, cwd=str(out), capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(work):
    ref = work / "ref"
    ref.mkdir()
    run_reference(ref)
    out = work / "port"
    out.mkdir()
    spec = dict(out=str(out), ref=str(ref), what="serve")
    ranks = {m: cases.spawn(spec, m, RUN_TIMEOUT_S) for m in MESH_NAMES}
    one = {}
    for arch in cases.ARCHS:  # one-process serving in this process
        cfg, model = cases.port_model(torch, arch, str(ref))
        batch = cases.port_inputs(torch, cfg)
        logits, cache = model.prefill(batch, cases.max_len(cfg))
        toks = greedy_generate(model, cfg, batch, steps=cases.STEPS,
                               max_len=cases.max_len(cfg))
        one[arch] = dict(logits=logits.numpy(),
                         cache=cases.cache_arrays(cache),
                         elsize={k: v.element_size() for k, v in
                                 cases.flat(cache)
                                 if isinstance(v, torch.Tensor)},
                         tokens=toks.tolist())
    return dict(ref=ref, out=out, ranks=ranks, one=one)


def _rows(mesh: str, rank: int) -> slice:
    d, m = cases.MESHES[mesh]
    n = cases.BATCH // d
    return slice((rank // m) * n, (rank // m + 1) * n)


def _block(full: np.ndarray, path: str, layout: dict, mesh: str,
           rank: int) -> np.ndarray:
    """The block of cache leaf ``full`` that ``rank`` holds: the ranges of
    its layout, else its rows (the batch dim found as ``cache_specs``
    finds it)."""
    if path in layout:
        ranges, shape = layout[path]
        assert list(full.shape) == shape, path
        return full[tuple(slice(lo, hi) for lo, hi in ranges)]
    for dim, size in enumerate(full.shape[:2]):
        if size == cases.BATCH:
            idx = [slice(None)] * full.ndim
            idx[dim] = _rows(mesh, rank)
            return full[tuple(idx)]
    return full


def _close(got, want, what, int8=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max(initial=0) <= 1, what
    else:
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


def _reckoned(one: dict, mesh: str) -> int:
    """A rank's cache bytes reckoned from ``cache_specs``' rule: each leaf's
    elements over the sizes of the mesh axes its spec names."""
    from repro_torch.train import sharding

    d, m = cases.MESHES[mesh]
    sizes = {"data": d, "model": m}
    total = 0
    for path, full in one["cache"].items():
        n = full.size
        for entry in sharding.cache_leaf_spec(full.shape, sizes,
                                              cases.BATCH):
            for a in (() if entry is None else entry
                      if isinstance(entry, tuple) else (entry,)):
                n //= sizes[a]
        total += n * one["elsize"][path]
    return total


def _shard(runs, mesh, arch, rank):
    with np.load(runs["out"] / f"{mesh}_{arch}_r{rank}.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_prefill_logits_match_one_process(runs, mesh, arch):
    for r in range(cases.WORLD):
        got = _shard(runs, mesh, arch, r)["logits"]
        _close(got, runs["one"][arch]["logits"][_rows(mesh, r)],
               f"{mesh} rank {r}")


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_cache_shards_match_one_process(runs, mesh, arch):
    one = runs["one"][arch]["cache"]
    for r in range(cases.WORLD):
        layout = runs["ranks"][mesh][r][arch]["layout"]
        shard = _shard(runs, mesh, arch, r)
        for path, full in one.items():
            got = shard[f"cache/{path}"]
            _close(got, _block(full, path, layout, mesh, r),
                   f"{mesh} rank {r} {path}", int8=full.dtype == np.int8)
        # only the shard is resident: the reckoning from the specs
        assert runs["ranks"][mesh][r][arch]["resident"] == _reckoned(
            runs["one"][arch], mesh)
    if arch in ("gemma2-2b", "paligemma-3b") and mesh == "1x4":
        # kv heads the model axis does not divide: split by sequence
        for r in range(cases.WORLD):
            ranges, shape = runs["ranks"][mesh][r][arch]["layout"]["k"]
            t = shape[2] // 4
            assert ranges[2] == [r * t, (r + 1) * t]
            assert ranges[3] == [0, shape[3]]


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_greedy_tokens_match_one_process(runs, mesh, arch):
    want = runs["one"][arch]["tokens"]
    for r in range(cases.WORLD):
        assert runs["ranks"][mesh][r][arch]["tokens"] == want, r


@pytest.mark.parametrize("arch", [a for a in cases.ARCHS
                                  if a not in cases.NO_R12])
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_decode_past_the_cache_raises(runs, mesh, arch):
    for r in range(cases.WORLD):
        assert "decode at position" in runs["ranks"][mesh][r][arch]["r12"]


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_sharded_prefill_matches_reference(runs, mesh, arch):
    with np.load(runs["ref"] / f"prefill_{mesh}_{arch}.npz") as z:
        ref = {k: z[k] for k in z.files}
    for r in range(cases.WORLD):
        layout = runs["ranks"][mesh][r][arch]["layout"]
        shard = _shard(runs, mesh, arch, r)
        _close(shard["logits"], ref["logits"][_rows(mesh, r)],
               f"{mesh} rank {r} logits")
        for key, full in ref.items():
            if key == "logits" or key.endswith("pos"):
                continue
            path = key[len("cache/"):]
            _close(shard[key], _block(full, path, layout, mesh, r),
                   f"{mesh} rank {r} {path}", int8=full.dtype == np.int8)


@pytest.mark.parametrize("cap", [None, 50.0])
def test_partial_decode_attention_merges_to_the_whole(cap):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(2, 1, 8, 16, generator=gen)
    k, v = (torch.randn(2, 11, 2, 16, generator=gen) for _ in range(2))
    want = L.decode_attention(q, k, v, cur_pos=10, cap=cap)
    parts = [L.decode_attention_partial(q, k[:, a:e], v[:, a:e], cap=cap)
             for a, e in ((0, 6), (6, 11), (11, 11))]  # the last rank empty
    top = torch.stack([m for _, m, _ in parts]).amax(0)
    out = sum(o * torch.exp(m - top)[..., None] for o, m, _ in parts)
    den = sum(l * torch.exp(m - top) for _, m, l in parts)
    got = (out / den[..., None]).reshape(2, 1, 8, 16)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    alone = L.cache_decode_attention(q, k, v, cur_pos=10, cap=cap)
    assert torch.equal(alone, want)  # no shard: the one-card code
