#!/usr/bin/env python
"""Time K6's 16-bit plans against each other on the card.

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it stands and one
copy a variant, each copy with one ``struct Plan<HD>`` rewritten (consumer
warpgroups, keys a tile, ring stages, consumer registers, ping-pong), all
with ``nvcc`` at once, and optionally the source of another commit
(``--baseline``, e.g. ``git show <rev>:src/repro_torch/csrc/flash_attention.cu``
saved under ``build/``). Then, at the serving paths' K6 shapes (bf16, no
window or softcap), it holds every build against the plain version
(``flash_within_tolerance``) and times each call's device work by CUDA
events while a spin kernel (``torch.cuda._sleep``) holds the device, so
the host's work (ctypes, the tensor maps) is hidden and the time is the
tensor-core kernel plus the merge of a split call (``torch.profiler``
dropped kernel events in long runs), every call after a 64 MiB write that
flushes the L2, builds in turns (a, b, ..., b, a), beside
``scaled_dot_product_attention`` on the same inputs.
This tree runs with the rows ``flash_plan`` picks, a variant (or the
baseline) with rows = 64 × its consumers (fewer when S·G is smaller);
at the cross-attention shapes each runs 1, 2, 4 and 8 parts.

Usage (on a machine with the card and nvcc)::

    PYTHONPATH=src python tools/k6_plans.py [--baseline build/parent.cu]
        [--json build/k6_plans.json]

Prints the card's name and power limit, one line a build, and one line a
shape with each build's µs.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "k6_plans"

# name: {head dim: (consumers, keys, stages, consumer registers, ping-pong)}
VARIANTS = {
    "hd64 3x128 3 stages, no ping-pong": {64: (3, 128, 3, 160, False)},
    "hd64 3x64 4 stages": {64: (3, 64, 4, 160, True)},
    "hd64 2x128 3 stages": {64: (2, 128, 3, 240, True)},
    "hd128 3x64 4 stages, no ping-pong": {128: (3, 64, 4, 160, False)},
    "hd128 2x128 3 stages": {128: (2, 128, 3, 240, True)},
    "hd128 2x64 4 stages": {128: (2, 64, 4, 240, True)},
}

# label, (b, s, t, hq, hkv, hd, causal)
SHAPES = [
    ("whisper encoder", (4, 1500, 1500, 16, 16, 64, False)),
    ("whisper self", (4, 64, 64, 16, 16, 64, True)),
    ("whisper cross", (4, 64, 1500, 16, 16, 64, False)),
    ("whisper decode cross", (4, 1, 1500, 16, 16, 64, False)),
    ("whisper cross, batch 1", (1, 64, 1500, 16, 16, 64, False)),
    ("whisper decode cross, batch 1", (1, 1, 1500, 16, 16, 64, False)),
    ("qwen1.5-32b layer", (2, 512, 512, 40, 40, 128, True)),
    ("arctic-480b layer", (2, 256, 256, 56, 8, 128, True)),
    ("dbrx-132b layer", (2, 256, 256, 48, 8, 128, True)),
    ("hd 256, causal (2, 6144, 8/4)", (2, 6144, 6144, 8, 4, 256, True)),
]


def plan_source(plans: dict) -> str:
    src = SRC.read_text()
    for hd, (consumers, keys, stages, regs, pingpong) in plans.items():
        body = (f"template <>\nstruct Plan<{hd}> {{\n"
                f"  static constexpr int kConsumers = {consumers};\n"
                f"  static constexpr int kKeys = {keys};\n"
                f"  static constexpr int kStages = {stages};\n"
                f"  static constexpr uint32_t kProducerRegs = 24, "
                f"kConsumerRegs = {regs};\n"
                f"  static constexpr int kMinBlocks = 1;\n"
                f"  static constexpr bool kOverlap = true;\n"
                f"  static constexpr bool kPingPong = "
                f"{str(pingpong).lower()};\n}};")
        src, n = re.subn(rf"template <>\nstruct Plan<{hd}> \{{.*?\n\}};", body,
                         src, flags=re.S)
        assert n == 1, f"no struct Plan<{hd}> in {SRC}"
    return src


def build(name: str, text: str):
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W+", "_", name)
    src, lib = OUT / f"{stem}.cu", OUT / f"lib{stem}.so"
    src.write_text(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    spills = re.findall(r"(\d+) bytes spill stores", log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
    return name, lib, any(int(n) for n in spills), "Potential Performance Loss" in log


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="flash_attention.cu of "
                    "another commit, built as 'baseline'")
    ap.add_argument("--json", type=Path, help="write the µs table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fam = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    jobs = {"this tree": SRC.read_text(),
            **{n: plan_source(p) for n, p in VARIANTS.items()}}
    if args.baseline:
        jobs["baseline"] = args.baseline.read_text()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda kv: build(*kv), jobs.items()))
    libs, new_entry = {}, {}
    for name, lib, spilled, serialised in built:
        print(f"build {name}: spills {spilled}, serialised wgmma "
              f"{serialised}", flush=True)
        cdll = ctypes.CDLL(str(lib))
        # the entry took no workspace, rows or parts before this plan
        new_entry[name] = "int rows, int parts" in jobs[name]
        fn = cdll.flash_attention_fwd
        fn.restype = ctypes.c_int
        sig = list(fam._SIGNATURES["flash_attention_fwd"])
        fn.argtypes = sig if new_entry[name] else sig[:4] + sig[5:-3] + sig[-1:]
        libs[name] = fn

    dev = torch.device("cuda")
    flush = torch.empty(16 << 20, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def device_us(call, reps=20):
        for _ in range(2):
            call()
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(2_000_000)  # ~1 ms: longer than the host's work
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
        return statistics.median(times)

    table = {}
    for label, (b, s, t, hq, hkv, hd, causal) in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(s + t + hd)
        q, k, v = (torch.randn(b, n, h, hd, generator=gen, device=dev)
                   .bfloat16() for n, h in ((s, hq), (t, hkv), (t, hkv)))
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        calls = {}
        for name, fn in libs.items():
            plans = VARIANTS.get(name, {})
            if plans and hd not in plans:
                continue
            if name == "this tree":  # the rows the wrapper launches
                rows = fam.flash_plan(b, s, t, hq, hkv, hd, causal=causal,
                                      window=None, sm_count=torch.cuda
                                      .get_device_properties(dev)
                                      .multi_processor_count).rows
            else:
                consumers = plans[hd][0] if plans else \
                    fam.WGMMA_PLANS[hd]["consumers"]
                rows = 128 if hd == 256 else \
                    64 * min(consumers, -(-s * (hq // hkv) // 64))
            cross = "cross" in label and new_entry[name] and hd != 256
            for parts in ((1, 2, 4, 8) if cross else (1,)):
                out = torch.empty_like(q)
                ws = torch.empty(parts * b * s * hq * (hd + 2), device=dev) \
                    if parts > 1 else None
                head = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
                tail = (b, s, t, hq, hkv, hd, int(causal), 1 << 30, 0,
                        1 / math.sqrt(hd), 0, 0.0)
                argv = ((*head, None if ws is None else ws.data_ptr(), 1,
                         *tail, rows, parts, stream) if new_entry[name]
                        else (*head, 1, *tail, stream))

                def call(fn=fn, argv=argv, keep=(out, ws)):
                    err = fn(*argv)
                    assert err == 0, f"CUDA error {err}"

                call()
                torch.cuda.synchronize()
                ok, _ = fa.flash_within_tolerance(out, want, q, k, v,
                                                  causal=causal)
                assert ok, f"{name} at {label}, {parts} parts"
                calls[f"{name} / {parts}"] = call
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)
        us = {key: [] for key in calls}
        for key in list(calls) + list(calls)[::-1]:
            us[key].append(device_us(calls[key]))
        table[label] = {key: sum(v) / len(v) for key, v in us.items()}
        print(f"{label}: " + "; ".join(f"{key} {val:.2f}"
                                       for key, val in table[label].items()),
              flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
