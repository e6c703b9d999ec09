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
counter's mean a unit. Where the program has the device timeline
(``Unit.timeline``), a group also holds its anchored units' count, their
mean idle ms a unit, and each span's mean idle ms charged to it and its
mean busy ms (leaves) a unit.

The last line (``timeline``, where a unit is anchored: frames) sets the
timeline beside the trace over the
whole window: the stretches between units, charged to "outside" (the
caller's time), and their share of all the idle time the recorder saw; the
trace's idle seconds (``window_s`` less ``busy_s``) beside the recorder's
(the idle inside the anchored units plus the outside stretches), less the
device time of the copies to the host (which lie outside the units), and
their ratio; the leaves' busy ms a unit beside ``frame_device_ms``, where
the line has it. Exits non-zero without a card.
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
    out = {"units": len(units), "spans": spans,
           "counters": {k: statistics.fmean(u.counters.get(k, 0) for u in units)
                        for k in keys}}
    lines = [line for line in (u.timeline() for u in units if hasattr(u, "timeline"))
             if line is not None]
    if lines:
        out["anchored"] = len(lines)
        out["idle_ms"] = statistics.fmean(t.idle_total_ms for t in lines)
        for name in names:
            spans[name]["idle_ms"] = statistics.fmean(t.idle_ms.get(name, 0.0) for t in lines)
            if any(name in t.busy_ms for t in lines):
                spans[name]["busy_ms"] = statistics.fmean(t.busy_ms.get(name, 0.0)
                                                          for t in lines)
    return out


def against_trace(units, line: dict) -> dict:
    """The window's idle time by the timeline beside the trace's (see the
    module's docstring)."""
    from gfx_ocean_tpu_torch.utils import profiling

    lines = [t for t in (u.timeline() for u in units) if t is not None]
    outside = profiling.outside_ms(units)
    inside_s = sum(t.idle_total_ms for t in lines) * 1e-3
    outside_s = sum(outside) * 1e-3
    dev = line["device"]
    trace_s = dev["window_s"] - dev["busy_s"] if "busy_s" in dev else None
    copies_s = sum(s for name, s in line.get("breakdown", {}).get("device_ops", [])
                   if "DtoH" in name)
    out = {"units": len(units), "anchored": len(lines), "inside_idle_s": inside_s,
           "outside_s": outside_s, "outside_share": outside_s / (inside_s + outside_s or 1.0),
           "outside_ms_mean": statistics.fmean(outside) if outside else None,
           "recorder_idle_s": inside_s + outside_s, "copies_to_host_s": copies_s,
           "recorder_idle_less_copies_s": inside_s + outside_s - copies_s,
           "trace_idle_s": trace_s,
           "leaves_busy_ms": statistics.fmean(sum(t.busy_ms.values()) for t in lines)
           if lines else None}
    if trace_s:
        out["recorder_over_trace"] = out["recorder_idle_less_copies_s"] / trace_s
    device_ms = line["metrics"].get("frame_device_ms", {}).get("value")
    if device_ms and lines:
        out["frame_device_ms"] = device_ms
        out["leaves_over_frame_device_ms"] = out["leaves_busy_ms"] / device_ms
    return out


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
                      "device": line["device"], "breakdown": line.get("breakdown")}),
          flush=True)
    name = "frame" if args.workload.endswith(".frame") else "rollout"
    units = profiling.largest_window(name) or []
    groups = {"all": units}
    if name == "frame":
        groups["giant"] = [u for u in units if u.counters.get("giant.groups", 0) > 0]
        groups["no_giant"] = [u for u in units if not u.counters.get("giant.groups", 0)]
    for label, members in groups.items():
        if members:
            print(json.dumps({"group": label, **group(members)}), flush=True)
    if any(getattr(u, "anchored", False) for u in units):
        print(json.dumps({"timeline": against_trace(units, line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
