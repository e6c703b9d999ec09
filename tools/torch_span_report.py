#!/usr/bin/env python3
"""The program's spans and counters over one traced run of a benchmark
cell, by span name.

    python3 tools/torch_span_report.py --workload ocean512.frame --seed 7 [--seconds 10]

Runs the cell as ``portbench/run.py --trace 1`` does (pinned to one core,
``portbench.harness.run``) and prints the card's name and power limit, the
result line's metrics, then one JSON line for each group of the units of
the run's largest window (``utils/profiling.largest_window``): every unit,
and for frames those that ran the giant pass and those that did not. A
group holds its unit count, each span's mean host ms and mean device ms a
unit (CUDA events; a span that is absent in a unit counts 0) and each
counter's mean a unit. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def group(units) -> dict:
    """Unit count, span means and counter means of ``units``."""
    names = list(dict.fromkeys(s.name for u in units for s in u.spans))
    keys = sorted({k for u in units for k in u.counters})
    spans = {}
    for name in names:
        device = [u.device_ms(name) for u in units]
        spans[name] = {
            "host_ms": statistics.fmean(u.host_ms(name) for u in units),
            "device_ms": (statistics.fmean(d or 0.0 for d in device)
                          if any(d is not None for d in device) else None)}
    return {"units": len(units), "spans": spans,
            "counters": {k: statistics.fmean(u.counters.get(k, 0) for u in units)
                         for k in keys}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    from portbench import run as bench_run

    bench_run.pin_to_one_core()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from gfx_ocean_tpu_torch.utils import profiling
    from portbench import harness

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    line = harness.run(args.workload, args.seed, args.seconds, True)
    print(json.dumps({"correct": line["correct"], "metrics": line["metrics"],
                      "device": line["device"]}), flush=True)
    name = "frame" if args.workload.endswith(".frame") else "rollout"
    units = profiling.largest_window(name) or []
    groups = {"all": units}
    if name == "frame":
        groups["giant"] = [u for u in units if u.counters.get("giant.groups", 0) > 0]
        groups["no_giant"] = [u for u in units if not u.counters.get("giant.groups", 0)]
    for label, members in groups.items():
        if members:
            print(json.dumps({"group": label, **group(members)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
