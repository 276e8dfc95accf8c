"""The readings a cell's limits are set from, on the card at the cell's size.

    python tcbench/control.py --workload graph500-s19.warm --seeds 1,2,3

For each seed it makes the cell's input as a run does, and reads:

* the program: the counts of a session (``TriangleCounter(g).count()``,
  as the cell's mix calls it) against the plain reference, as a run's
  ``checks`` compare them;
* the control: the plain reference in the program's place, its total
  accumulated in float32, the precision below the configuration's int64
  (``references/<name>.py`` ``count_float32``), against the reference.

A limit holds only if the program reads under it on every seed and the
control reads over it. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, e.g. 1,2,3")
    p.add_argument("--counts", type=int, default=3,
                   help="program counts a seed")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from tcbench import spec
    from tcbench.harness import host_csr

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    from repro_torch.core.api import TriangleCounter
    from repro_torch.graphs import graph_from_arrays

    cell = spec.cell(spec.bench_spec(ROOT), args.workload)
    config = spec.load_config(cell.config)
    gen = spec.load_named("generators", config["generator"])
    ref = spec.load_named("references", config["reference"])
    device = torch.device("cuda", 0)
    worst_program, least_control = 0, None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        n, row_ptr, col_idx = host_csr(gen, config["params"], seed, device, 0)
        session = TriangleCounter(graph_from_arrays(n, row_ptr, col_idx),
                                  device=device, **config.get("options", {}))
        got = [session.count().count for _ in range(args.counts)]
        del session
        gc.collect()
        torch.cuda.empty_cache()
        exact = ref.count(row_ptr, col_idx, device)
        control = ref.count_float32(row_ptr, col_idx, device)
        prog_err = max(abs(c - exact) for c in got)
        ctrl_err = abs(control - exact)
        worst_program = max(worst_program, prog_err)
        least_control = ctrl_err if least_control is None \
            else min(least_control, ctrl_err)
        print(f"seed {seed}: m={len(col_idx) // 2} reference {exact}; "
              f"program {got} max_abs_err {prog_err}; control (float32) "
              f"{control} max_abs_err {ctrl_err}; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"max_abs_err: program at most {worst_program} (lower reading), "
          f"control at least {least_control} (upper reading); the limit is 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
