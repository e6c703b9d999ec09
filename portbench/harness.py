"""The benchmark's harness: finds a cell's pieces by name and runs it.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the names in ``BENCHMARK.json``:

- the configuration: the file its ``configs`` entry names (OceanConfig
  fields under ``ocean``, the state's ``spectrum``, the rollout's or
  frame's settings, the ``control`` that lowers its precision);
- the spectrum: ``portbench/spectra/<model>.py``, the ``model`` of the
  configuration's ``spectrum``, whose ``state(...)`` draws the state;
- the traffic mix: ``portbench/traffic/<traffic>.json``, whose ``drive``
  names the loop the window drives and whose other keys are its
  parameters;
- the drive: ``portbench/drives/<drive>.py``, whose ``Drive(cell)`` sets
  up the program, runs the window (or the traced window), frees the
  program's state and compares what the window produced with the plain
  reference it brings;
- the limits of the comparison that decides ``correct``:
  ``portbench/limits/<cell>.json``;
- a metric: ``portbench/metrics/<metric>.py``, whose ``read(record)``
  returns the value or None where the run has nothing to read.

A run with ``trace`` false reports the cell's end-to-end metrics, one with
``trace`` true its per-layer metrics and the ``breakdown``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from portbench import trace

ROOT = Path(__file__).resolve().parent.parent
_IMPORTED = time.monotonic()


class Cell(NamedTuple):
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: torch.device
    root: Path


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time of the
    process), or since this module was imported where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, extra: Optional[dict]) -> dict:
    """``base`` with ``extra``'s keys in it, groups merged key by key."""
    out = dict(base)
    for key, value in (extra or {}).items():
        out[key] = merge(out.get(key, {}), value) if isinstance(value, dict) else value
    return out


def bench(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def load_cell(name: str, seed: int, device, root: Path = ROOT,
              override: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and limits;
    ``override`` ({"config": {...}, "traffic": {...}}) is merged into them
    (the CPU tests' small sizes, a precision control)."""
    root = Path(root)
    spec = bench(root)
    work = next(w for w in spec["workloads"] if w["name"] == name)
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    override = override or {}
    return Cell(
        name=name, chips=work["chips"],
        config=merge(_json(root / conf["file"]), override.get("config")),
        traffic=merge(_json(root / "portbench" / "traffic" / f"{work['traffic']}.json"),
                       override.get("traffic")),
        limits=_json(root / "portbench" / "limits" / f"{name}.json"),
        seed=int(seed), device=torch.device(device), root=root)


def metrics_of(name: str, per_layer: bool, root: Path = ROOT) -> list:
    """The cell's metric entries: its end-to-end ones, or its per-layer ones."""
    spec = bench(root)
    return [m for m in spec["per_layer" if per_layer else "end_to_end"]
            if name in m.get("workloads", [name])]


def load(kind: str, name: str, root: Path = ROOT):
    """The module ``portbench/<kind>/<name>.py`` of the checkout at ``root``."""
    path = Path(root) / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    return load("metrics", metric, root).read


def drive(cell: Cell):
    """The cell's drive, named by its traffic's ``drive``."""
    return load("drives", cell.traffic["drive"], cell.root).Drive(cell)


def device_block(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(name: str, seed: int, seconds: float, traced: bool, device="cuda",
        root: Path = ROOT, override: Optional[dict] = None) -> dict:
    """One run of the cell: set-up, the window (traced or not), the
    program's state freed, the comparison with the reference, the metrics.
    Returns the result line; its ``check`` (last) holds each number
    compared beside its limit."""
    cell = load_cell(name, seed, device, root, override)
    loop = drive(cell)
    loop.setup()
    record = {"config": cell.config, "setup_s": process_age_s()}
    record.update(loop.traced(seconds) if traced else loop.window(seconds))
    dev = device_block(cell.device, cell.chips)
    loop.release()
    checked = loop.check()
    metrics = {}
    for m in metrics_of(name, traced, root):
        value = reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": checked["failed"] == 0 and bool(checked["compared"]),
            "attempted": checked["compared"], "failed": checked["failed"],
            "metrics": metrics, "device": dev}
    summary = record.get("trace")
    if summary:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        line["breakdown"] = trace.breakdown(summary)
    line["check"] = {k: {"value": checked["numbers"].get(k), "limit": v["limit"]}
                     for k, v in cell.limits.items()}
    return line
