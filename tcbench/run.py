"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its result.

    python tcbench/run.py --workload graph500-s19.warm --seed 7 \
        --seconds 10 --trace 0

Run from the root of a checkout that holds ``src/repro_torch``. The last
line of standard output is the result: one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, the numbers compared with the plain
reference beside their limits. Those numbers are also the last lines of
standard error.

``--config NAME --traffic NAME`` in place of ``--workload`` runs a pairing
that no cell lists yet (a rehearsal of a new mix) and reports every metric
whose reader finds something.

It exits with a code other than 0, and prints no result, where there is
no card (or fewer than the cell asks for), where ``src/repro_torch`` is
missing, or where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _say(*parts) -> None:
    print("tcbench:", *parts, file=sys.stderr, flush=True)


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi printed nothing"
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", help="a cell of BENCHMARK.json")
    p.add_argument("--config", help="with --traffic: a pairing no cell lists")
    p.add_argument("--traffic")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if (args.workload is None) == (args.config is None or args.traffic is None):
        p.error("give --workload, or --config and --traffic")
    return args


def main(argv=None) -> int:
    args = _parse(argv)
    if not (ROOT / "src" / "repro_torch" / "core" / "api.py").is_file():
        _say(f"{ROOT / 'src' / 'repro_torch'} not found: run from the root "
             f"of a checkout of the repository")
        return 2
    # every build and kernel cache of the program stays in the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(build / "torch_kernels")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from tcbench import spec

    bench = spec.bench_spec(ROOT)
    if args.workload is not None:
        cell = spec.cell(bench, args.workload)
        metrics = spec.metrics_for(bench, cell.name, per_layer=bool(args.trace))
    else:
        cell = spec.Cell(name=f"{args.config}.{args.traffic}",
                         config=args.config, traffic=args.traffic, chips=1)
        metrics = _all_metrics(bench)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _say(f"needs {cell.chips} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3

    from tcbench import harness

    marks = {"imports": time.perf_counter()}
    config = spec.load_config(cell.config)
    mix = spec.load_mix(cell.traffic)
    device = torch.device("cuda", 0)
    run = harness.run_cell(cell.name, cell.config, config, cell.traffic, mix,
                           args.seed, args.seconds, bool(args.trace), device,
                           T_START, marks)
    card = _card_line()
    expect = config.get("expect_lane")
    _say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _say(f"graph: n={run.n} m={run.m_undirected}; lane(s) count() reported: "
         f"{run.lanes} (predicted {expect}"
         f"{'' if run.lanes == [expect] else '; differs, recorded'})")
    _say(f"setup stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_phases.items()))
    _say(f"setup {run.setup_s:.3f} s; window {run.window_s:.3f} s, "
         f"{len(run.counts)} calls; prep {run.prep_s[:3]} s; launches "
         f"{ {k: v for k, v in run.launches.items() if v} }; reference "
         f"{run.reference} in {run.reference_s:.3f} s")
    if run.latencies_s:
        lat = sorted(run.latencies_s)
        half = len(run.latencies_s) // 2
        _say(f"call ms: min {lat[0] * 1e3:.4f}, median "
             f"{lat[len(lat) // 2] * 1e3:.4f}, max {lat[-1] * 1e3:.4f}; "
             f"mean of the first / second half "
             f"{sum(run.latencies_s[:half]) / max(half, 1) * 1e3:.4f} / "
             f"{sum(run.latencies_s[half:]) / max(len(lat) - half, 1) * 1e3:.4f}")
    compared = harness.checks(run)
    correct = harness.is_correct(run, compared)
    values = harness.read_metrics(run, metrics)
    leaked = harness.forbidden_modules()
    if leaked:
        _say(f"modules of JAX or of the JAX package were loaded: {leaked}")
        return 4
    dev = harness.device_record(run, cell.chips)
    dev["power_limit"] = card
    breakdown = None
    if run.trace is not None:
        breakdown = {"device_ops": run.trace.device_ops,
                     "idle_gaps": run.trace.idle_gaps}
        _say(f"trace ({run.trace.timer}): busy {run.trace.busy_s:.6f} s of "
             f"{run.trace.window_s:.6f} s; launch to start (min us, median "
             f"us, share negative) "
             f"{run.trace.launch_lag_us}; device ops "
             f"{run.trace.device_ops[:4]}; idle {run.trace.idle_gaps[:4]}")
    for name, c in compared.items():
        _say(f"check {name} = {c['value']} (limit {c['limit']})")
    print(harness.result_line(correct, len(run.counts) + run.failed,
                              run.failed + compared["wrong_counts"]["value"],
                              values, dev, compared, breakdown), flush=True)
    return 0


def _all_metrics(bench):
    """Every metric of ``BENCHMARK.json``, and every other reader in
    ``metrics/`` (unit from its ``UNIT``), for a rehearsal."""
    from tcbench import spec
    out = {}
    for key in ("end_to_end", "per_layer"):
        for m in bench[key]:
            out[m["name"]] = spec.Metric(
                name=m["name"], unit=m["unit"], better=m["better"],
                source=m["source"], end_to_end=key == "end_to_end")
    for path in sorted((spec.BENCH_DIR / "metrics").glob("*.py")):
        if path.stem.startswith("_") or path.stem in out:
            continue
        reader = spec.load_named("metrics", path.stem)
        out[path.stem] = spec.Metric(
            name=path.stem, unit=getattr(reader, "UNIT", ""), better="",
            source="", end_to_end=False)
    return list(out.values())


if __name__ == "__main__":
    sys.exit(main())
