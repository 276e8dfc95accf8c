"""The port's dry-run specs against the reference's, on the CPU.

``repro_torch.launch.specs`` and ``launch.dryrun`` against
``repro.launch.specs`` and ``repro.launch.dryrun`` (the cases of
``tests/test_launch.py``, for every architecture): ``SHAPES``,
``cell_spec`` and ``skip_reason`` equal; ``input_specs`` of every arch ×
shape of the reference's shapes and dtypes, as ``meta`` tensors (no byte
allocated), each decode cache leaf against ``jax.eval_shape`` of the
reference's ``init_cache`` (qwen1.5-32b's int8 leaves too); the model
FLOPs a chip of every arch × shape × {256, 512} chips equal; and a
``launch.report`` round trip.
"""

from __future__ import annotations

import contextlib
import json
import os

import pytest
import torch

from torch_reference import _reference

from repro_torch.launch import dryrun, report, specs
from repro_torch.models import registry

ARCHS = registry.list_archs()
SHAPES = list(specs.SHAPES)


@contextlib.contextmanager
def _kept_xla_flags():
    """``repro.launch.dryrun`` sets XLA_FLAGS (512 placeholder devices) when
    it is imported; the test process keeps its own."""
    before = os.environ.get("XLA_FLAGS")
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.fixture(scope="module")
def lref():
    with _kept_xla_flags(), _reference({
            "specs": "repro.launch.specs", "dryrun": "repro.launch.dryrun",
            "registry": "repro.models.registry"}) as ns:
        yield ns


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _flat(tree, prefix=""):
    """(path, leaf) of a cache tree: dict keys, list and tuple indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def test_shapes_and_cells_match_reference(lref):
    assert specs.SHAPES == lref.specs.SHAPES
    for arch in ARCHS:
        for shape in SHAPES:
            got = specs.cell_spec(arch, shape)
            want = lref.specs.cell_spec(arch, shape)
            assert (got.kind, got.seq_len, got.global_batch) == (
                want.kind, want.seq_len, want.global_batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reason_matches_reference(lref, arch):
    cfg, jcfg = registry.get_config(arch), lref.registry.get_config(arch)
    for shape in SHAPES:
        assert specs.skip_reason(cfg, shape) == lref.specs.skip_reason(
            jcfg, shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(lref, arch, shape):
    got = specs.input_specs(arch, shape)
    want = lref.specs.input_specs(arch, shape)
    assert set(got) == set(want)
    for key in want:
        g, w = dict(_flat(got[key])), dict(_flat(want[key]))
        assert set(g) == set(w), key
        for path, leaf in w.items():
            if path.endswith("pos"):  # the port's pos is a host int
                assert g[path] == 0
                continue
            assert isinstance(g[path], torch.Tensor) and g[path].is_meta, \
                (key, path)
            assert tuple(g[path].shape) == tuple(leaf.shape), (key, path)
            assert _dtype_name(g[path].dtype) == str(leaf.dtype), (key, path)
    if arch == "qwen1.5-32b" and shape.startswith("decode"):
        assert {_dtype_name(x.dtype) for _, x in _flat(got["cache"])
                if isinstance(x, torch.Tensor)} == {"int8", "bfloat16"}


def test_abstract_params_allocate_nothing():
    model = specs.abstract_params("arctic-480b")
    assert all(p.is_meta and p.dtype in (torch.bfloat16, torch.float32)
               for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) \
        == registry.get_config("arctic-480b").param_count()


@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_per_chip_match_reference(lref, arch, chips):
    cfg, jcfg = registry.get_config(arch), lref.registry.get_config(arch)
    for shape in SHAPES:
        got = dryrun._model_flops_per_chip(
            cfg, specs.cell_spec(arch, shape), chips)
        want = lref.dryrun._model_flops_per_chip(
            jcfg, lref.specs.cell_spec(arch, shape), chips)
        assert got == want, (shape, got, want)


def test_report_roundtrip(tmp_path):
    rl = dict(t_compute=1.0, t_memory=2.0, t_collective=0.5,
              dominant="memory", useful_ratio=0.5, flops=1, hbm_bytes=1,
              coll_bytes=1, coll_by_kind={}, model_flops=1)
    recs = [dict(arch="a", shape="s", mesh="16x16", status="ok",
                 memory={"temp_size_in_bytes": 1, "peak_bytes": 9e10},
                 fits=False, kind="train", chips=256, roofline=rl),
            dict(arch="a", shape="s", mesh="2x16x16", status="skipped",
                 reason="r"),
            dict(arch="b", shape="s", mesh="16x16", status="error",
                 error="e")]
    p = tmp_path / "d.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in recs))
    got = report.load(str(p))
    assert got == recs
    assert report.summary(got) == ("1 ok / 1 documented skips / 1 errors "
                                   "(1 ok but not fitting)")
    table = report.roofline_table(got)
    assert "| a | s | ok | 1.000 | 2.000 | 0.500 | memory | 0.50 | 90.00 " \
           "| no |" in table
    assert "| b | s | ERROR |" in table
    assert "| a | s | skip |" in report.roofline_table(got, "2x16x16")
    both = report.both_meshes_table(
        got + [dict(arch="c", shape="s", mesh=m, status="skipped")
               for m in report.MESHES]).splitlines()
    assert len(both) == 4 and both[0].count("|") == 15  # no row for c
    assert both[2] == ("| a | s | 1 | 2 | 0.5 | memo | 90.00 | **no** | "
                       "skip | — | — | — | — | — |")
    assert both[3].startswith("| b | s | ERROR |")
