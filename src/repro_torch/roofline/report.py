"""Aggregate the port's dry-run JSONs into the roofline and dry-run
markdown tables, the twin of ``repro.roofline.report``.

  PYTHONPATH=src python -m repro_torch.roofline.report experiments/dryrun_torch

The roofline fraction is the ideal time (the model's FLOPs per device at
the H100's dense bf16 peak, ``launch.mesh.PEAK_FLOPS_BF16``) over the
dominant term; every figure in the tables is a dry-run count, none a
measurement.
"""
from __future__ import annotations

import json
import os
import sys

from ..launch.mesh import PEAK_FLOPS_BF16


def load(dirpath: str):
    out = []
    for f in sorted(os.listdir(dirpath)):
        if f.endswith(".json"):
            with open(os.path.join(dirpath, f)) as fh:
                out.append(json.load(fh))
    return out


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def roofline_table(results):
    rows = ["| arch | shape | mesh | compute (s) | memory (s) | collective (s) "
            "| bottleneck | MODEL/HLO flops | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(results, key=lambda x: (x["arch"], x["shape"])):
        if "roofline" not in r:
            continue
        rl = r["roofline"]
        dom = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        # fraction of roofline: ideal time (compute term with 100% useful
        # flops) over the dominant achievable term
        ideal = rl["model_flops_per_device"] / PEAK_FLOPS_BF16
        frac = ideal / dom if dom > 0 else 0.0
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {rl['compute_s']:.2e} | {rl['memory_s']:.2e} "
            f"| {rl['collective_s']:.2e} | **{rl['bottleneck']}** "
            f"| {rl['useful_ratio']:.2f} | {frac:.3f} |")
    return "\n".join(rows)


def dryrun_table(results):
    rows = ["| arch | shape | mesh | compile (s) | peak mem/device "
            "| args/device | collectives (AG/AR/RS/A2A/CP) |",
            "|---|---|---|---|---|---|---|"]
    for r in sorted(results, key=lambda x: (x["arch"], x["shape"],
                                            x["mesh"])):
        m = r["memory_analysis"]
        c = r.get("collectives", {}).get("bytes", {})
        cstr = "/".join(fmt_bytes(c.get(k)) if c else "-" for k in
                        ("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute")) if c else "n/a"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compile_s']} | {fmt_bytes(m['peak_bytes'])} "
            f"| {fmt_bytes(m['argument_bytes'])} | {cstr} |")
    return "\n".join(rows)


def _meshes(results, default: str) -> str:
    return ", ".join(sorted({r["mesh"] for r in results})) or default


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    results = load(d)
    single = [r for r in results if not r["multi_pod"]]
    multi = [r for r in results if r["multi_pod"]]
    print(f"## Roofline per member on one H100 SXM5's peaks (single-pod "
          f"{_meshes(single, '16x16')}; dry-run counts)\n")
    print(roofline_table(single))
    print(f"\n## Dry run: single-pod {_meshes(single, '16x16')} "
          f"({len(single)} cells; 'compile (s)' is the seconds the counted "
          f"step took)\n")
    print(dryrun_table(single))
    print(f"\n## Dry run: multi-pod {_meshes(multi, '2x16x16')} "
          f"({len(multi)} cells)\n")
    print(dryrun_table(multi))


if __name__ == "__main__":
    main()
