"""The dry run's tally against real runs, and production cells traced
shape-only, on the CPU.

- The tally against a real run: every reduced config (head dims widened
  to K6's smallest, 64) traced on ``meta`` on a fake 4-rank group, rank 0
  (``launch.dryrun.trace_step``, one subprocess), against the same prefill
  and decode step on 4 real gloo ranks, on (2, 2) and (1, 4): rank 0's
  argument bytes, collective bytes by kind and FLOPs are exactly equal,
  the real rank's FLOPs from ``FlopCounterMode``; the attention that K6
  runs is hidden from both counters on the real ranks, and the tally's K6
  launches are its calls (``tests/torch_sharded_serve_cases.py``).
- Three cells at production size, each in its own subprocess under a 120 s
  timeout: gemma2-2b ``decode_32k`` on 16x16, mamba2-780m ``long_500k`` on
  16x16 and ``--tc`` on 2x16x16. Each gives ``status: "ok"`` with memory,
  ``fits`` and the three roofline terms, makes no tensor off ``meta``
  larger than 1 MiB and builds no extension.
- A forced error (an unknown architecture) is a ``status: "error"`` record
  and exit code 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

import torch_sharded_serve_cases as cases

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
CELL_TIMEOUT_S = 120
RUN_TIMEOUT_S = 600

# a cell run under guards: any build of a kernel raises, and every op's
# outputs off the meta device are at most 1 MiB
_GUARDED = r"""
import json
import sys
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.kernels import _build
from repro_torch.launch import dryrun

def refuse(*a, **k):
    raise RuntimeError("the dry run built an extension")
_build.build = _build.load_library = refuse
big = []

class Guard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and not t.is_meta \
                    and t.numel() * t.element_size() > (1 << 20):
                big.append((str(func), tuple(t.shape), str(t.device)))
        return out

with Guard():
    rc = dryrun.main(sys.argv[1:])
print(json.dumps({"guard_big": big}))
sys.exit(rc)
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))


def _cell(*args):
    proc = subprocess.run([sys.executable, "-c", _GUARDED, *args],
                          env=_env(), capture_output=True, text=True,
                          timeout=CELL_TIMEOUT_S)
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    return proc, lines


@pytest.mark.parametrize("args", [
    ("--arch", "gemma2-2b", "--shape", "decode_32k", "--mesh", "single"),
    ("--arch", "mamba2-780m", "--shape", "long_500k", "--mesh", "single"),
    ("--tc", "--mesh", "multi"),
], ids=["gemma2-2b-decode_32k-16x16", "mamba2-780m-long_500k-16x16",
        "tc-2x16x16"])
def test_production_cell_traces_shape_only(args):
    proc, lines = _cell(*args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec, guard = lines[0], lines[-1]
    assert guard == {"guard_big": []}
    assert rec["status"] == "ok", rec
    assert rec["chips"] == (512 if "multi" in args else 256)
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert rec["fits"] == (mem["peak_bytes"] <= 80 * 10 ** 9)
    rl = rec["roofline"]
    assert all(rl[k] > 0 for k in ("t_compute", "t_memory",
                                   "t_collective"))
    assert rl["bound"] == max(rl["t_compute"], rl["t_memory"],
                              rl["t_collective"])
    if "--tc" in args:  # one rank's K4 launch and the count's all-reduce
        assert rec["kernels"] == {"masked_spgemm_wgmma": 1}
        assert rec["tiles_per_shard"] == 16
        assert set(rl["coll_by_kind"]) == {"all-reduce"}
    elif "gemma2-2b" in args:
        # gemma2-2b's 4 kv heads on 16 model ranks: the cache splits by
        # sequence, and each layer's partial attentions merge (all-reduce)
        assert rl["coll_by_kind"]["all-reduce"] > 0
        assert rl["coll_by_link"]["infiniband"] > 0
    else:
        assert rec["kind"] == "decode" and rec["shape"] == "long_500k"


def test_forced_error_is_a_record_and_exit_1():
    proc, lines = _cell("--arch", "no-such-arch", "--shape", "decode_32k",
                        "--mesh", "single")
    assert proc.returncode == 1
    assert lines[0]["status"] == "error"
    assert "no-such-arch" in lines[0]["error"]


@pytest.fixture(scope="module")
def tallies():
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        env = dict(_env(), PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), str(TESTS)]))
        proc = subprocess.run(
            [sys.executable, str(TESTS / "torch_sharded_serve_cases.py"),
             "fake", str(work)], env=env, capture_output=True, text=True,
            timeout=RUN_TIMEOUT_S)
        assert proc.returncode == 0, proc.stderr[-4000:]
        fake = json.loads((work / "fake.json").read_text())
        spec = dict(out=str(work), what="tally")
        real = {m: cases.spawn(spec, m, RUN_TIMEOUT_S)
                for m in cases.MESHES}
        yield fake, real


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mesh", list(cases.MESHES))
def test_tally_equals_real_rank(tallies, mesh, arch, kind):
    fake, real = tallies
    got = fake[f"{mesh}/{arch}"][kind]
    want = real[mesh][0][arch][kind]
    assert got["memory"]["argument_size_in_bytes"] == want["args"]
    assert got["roofline"]["coll_by_kind"] == want["coll"]
    assert got["aten_flops"] == want["flops"] == want["tally_flops"]
    assert got["kernels"].get("flash_attention", 0) == want["k6_calls"]
