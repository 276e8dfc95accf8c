"""Render the dry run's tables from its JSONL records (``launch.dryrun
--out``).

The port of ``repro.launch.report``, with a ``fits`` column (each rank's
traced peak against the card's 80 GB) and the peak in place of XLA's
temporaries; ``--both`` renders the two meshes side by side, one row a
cell (``both_meshes_table``)::

    PYTHONPATH=src python -m repro_torch.launch.report dryrun.jsonl [--both]

The terms are analytic bounds at the H100's data-sheet rates
(``launch.roofline``), not measurements.
"""

from __future__ import annotations

import json
import sys
from collections import OrderedDict

__all__ = ["both_meshes_table", "load", "roofline_table", "summary"]

MESHES = ("16x16", "2x16x16")


def _fmt_bytes(b):
    if b is None:
        return "—"
    return f"{b/1e9:.2f}"


def load(path: str):
    """The records of a JSONL file, the last one of each (arch, shape,
    mesh) kept."""
    recs = OrderedDict()
    with open(path) as f:
        for line in f:
            if line.strip():
                r = json.loads(line)
                recs[(r["arch"], r.get("shape"), r["mesh"])] = r
    return list(recs.values())


def roofline_table(recs, mesh="16x16"):
    """A markdown table of the records of ``mesh``: status, the three terms
    (seconds a step), the dominant one, model over traced FLOPs, and each
    rank's peak GB with whether it fits."""
    rows = [("| arch | shape | status | t_compute (s) | t_memory (s) | "
             "t_collective (s) | dominant | MODEL/traced flops | "
             "peak GB/chip | fits |"), "|" + "---|" * 10]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | skip | — | — | — | — "
                        f"| — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | "
                        f"| |")
            continue
        rl = r["roofline"]
        mem = r.get("memory", {})
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {rl['t_compute']:.3f} | {rl['t_memory']:.3f} "
            f"| {rl['t_collective']:.3f} | {rl['dominant']} "
            f"| {rl['useful_ratio']:.2f} "
            f"| {_fmt_bytes(mem.get('peak_bytes'))} "
            f"| {'yes' if r.get('fits') else 'no'} |")
    return "\n".join(rows)


def _terms(r) -> str:
    if r is None:
        return "— | — | — | — | — | —"
    if r["status"] == "skipped":
        return "skip | — | — | — | — | —"
    if r["status"] != "ok":
        return "ERROR | | | | |"
    rl = r["roofline"]
    return (f"{rl['t_compute']:.3g} | {rl['t_memory']:.3g} | "
            f"{rl['t_collective']:.3g} | {rl['dominant'][:4]} | "
            f"{_fmt_bytes(r['memory'].get('peak_bytes'))} | "
            f"{'yes' if r.get('fits') else '**no**'}")


def _skipped_everywhere(by, arch, shape) -> bool:
    got = [by.get((arch, shape, m)) for m in MESHES]
    return all(r is not None and r["status"] == "skipped" for r in got)


def both_meshes_table(recs):
    """A markdown table, one row a (arch, shape): for each of ``MESHES``
    the three terms (seconds), the dominant one, the peak GB a chip and
    whether it fits. A cell skipped on every mesh has no row
    (``summary`` counts it)."""
    by = {(r["arch"], r.get("shape"), r["mesh"]): r for r in recs}
    cells = [c for c in OrderedDict.fromkeys((r["arch"], r.get("shape"))
                                             for r in recs)
             if not _skipped_everywhere(by, *c)]
    cols = ("t_comp", "t_mem", "t_coll", "dom", "peak GB", "fits")
    head = " | ".join(f"{m} {c}" for m in MESHES for c in cols)
    rows = [f"| arch | shape | {head} |",
            "|" + "---|" * (2 + len(cols) * len(MESHES))]
    for arch, shape in cells:
        rows.append(f"| {arch} | {shape} | " + " | ".join(
            _terms(by.get((arch, shape, m))) for m in MESHES) + " |")
    return "\n".join(rows)


def summary(recs):
    ok = sum(r["status"] == "ok" for r in recs)
    skip = sum(r["status"] == "skipped" for r in recs)
    err = sum(r["status"] not in ("ok", "skipped") for r in recs)
    unfit = sum(r["status"] == "ok" and not r.get("fits") for r in recs)
    return (f"{ok} ok / {skip} documented skips / {err} errors "
            f"({unfit} ok but not fitting)")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    both = "--both" in argv
    paths = [a for a in argv if a != "--both"]
    recs = load(paths[0] if paths else "dryrun.jsonl")
    print("## Dry-run summary:", summary(recs))
    if both:
        skipped = sorted({f"{r['arch']} {r['shape']}" for r in recs
                          if r["status"] == "skipped"})
        print(f"\nSkipped on every mesh (no row): {', '.join(skipped)}\n")
        print(both_meshes_table(recs))
        return 0
    for mesh in MESHES:
        print(f"\n### Mesh {mesh}\n")
        print(roofline_table(recs, mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
