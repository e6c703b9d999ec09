"""The traced window: ``torch.profiler`` over whole units of work (rollout
calls or frames), reduced to what the per-layer readers and the result's
``breakdown`` need.

A traced run makes two sessions one after the other (:func:`traced`):

- the device session records the device's activity alone, so the host
  runs at nearly its untraced pace (recording ~300 host operations a
  frame would about double the frame's time). Every per-layer number and
  the ``device_ops`` of the breakdown come from it;
- the host session, shorter, records the host's operations too; it only
  names what the host was doing in the device's idle gaps (``idle_gaps``).

Each session runs one warm-up step before its window (without it the
tracer loses the first launches of the window), and a session that
records no device operation is profiled again, up to three sessions: on
an H100 machine a session now and then records none. Its Chrome trace is
written to a temporary directory, read and deleted.

From a session's trace:

- ``busy_s``: the union of the device operations' intervals (kernels,
  copies, fills) inside the window; ``window_s`` the window's length: the
  profiler's step around it where the host is recorded, else the host's
  clock around the window's units (every unit is ended by a synchronize);
- ``kernel_s``: the kernels' own durations summed; ``device_op_s``: every
  device operation's summed;
- ``device_ops``: seconds by device operation name, largest first;
- ``idle_gaps``: the device's idle time inside the window by what the host
  was doing then: each gap between device operations is charged to the
  innermost host operation (an ATen op or a CUDA runtime call) that
  contains its midpoint, or to "python" where none does.
"""

from __future__ import annotations

import heapq
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Callable, Optional

import torch

ATTEMPTS = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120


def run_for(unit: Callable[[], int], seconds: float, whole: int = 1) -> dict:
    """Whole units of work until ``seconds`` have passed and the frames
    computed are a multiple of ``whole``: the frames and the wall time they
    took."""
    frames = 0
    t0 = time.perf_counter()
    while True:
        frames += unit()
        if frames % whole == 0 and time.perf_counter() - t0 >= seconds:
            break
    return {"frames": frames, "window_s": time.perf_counter() - t0}


def traced(unit: Callable[[], int], seconds: float, whole: int,
           gap_seconds: float) -> Optional[dict]:
    """The device session's summary over ``run_for(unit, seconds, whole)``
    with the ``idle_gaps`` of a host session of ``gap_seconds`` after it;
    None where the device session recorded no device operation."""
    summary = profile(unit, seconds, whole, host=False)
    if summary is None:
        return None
    host = profile(unit, gap_seconds, 1, host=True)
    summary["idle_gaps"] = host["idle_gaps"] if host else []
    return summary


def profile(unit: Callable[[], int], seconds: float, whole: int = 1,
            host: bool = True) -> Optional[dict]:
    """Run ``unit()`` (one whole unit of work, ended by a synchronize; it
    returns the frames it computed) under the profiler as
    ``run_for(unit, seconds, whole)`` does, recording the device's activity
    and, with ``host``, the host's operations. Returns the summary with
    ``frames``, or None when no session recorded a device operation."""
    from torch.profiler import ProfilerActivity, schedule  # noqa: PLC0415

    if not torch.cuda.is_available():        # nothing to trace; the window still runs
        run_for(unit, seconds, whole)
        return None
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for attempt in range(ATTEMPTS):
        with torch.profiler.profile(activities=activities,
                                    schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            unit()
            prof.step()
            window = run_for(unit, seconds, whole)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        summary = summarize(events, window["window_s"])
        if summary["device_op_s"] > 0:
            summary["frames"] = window["frames"]
            return summary
        print(f"torch.profiler recorded no device operation (session {attempt + 1} of "
              f"{ATTEMPTS})", file=sys.stderr, flush=True)
    return None


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list, window_s: float) -> dict:
    """The summary of one session's Chrome trace events (times in us)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in spans if str(e.get("name", "")).startswith("ProfilerStep")]
    lo = min((e["ts"] for e in steps), default=float("-inf"))
    hi = max((e["ts"] + e["dur"] for e in steps), default=float("inf"))
    device, host = [], []
    for e in spans:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS and b > lo and a < hi:
            device.append((max(a, lo), min(b, hi), e["cat"], str(e["name"])))
        elif e.get("cat") in HOST_CATS and not str(e.get("name", "")).startswith("ProfilerStep"):
            host.append((a, b, str(e["name"])))
    by_op = defaultdict(float)
    for a, b, _, name in device:
        by_op[name[:NAME_CHARS]] += (b - a) * 1e-6
    busy = _merge([(a, b) for a, b, _, _ in device])
    gaps = []
    if busy:
        start = lo if steps else busy[0][0]
        end = hi if steps else busy[-1][1]
        edges = [start] + [x for iv in busy for x in iv] + [end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    return {
        "window_s": (hi - lo) * 1e-6 if steps else window_s,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernel_s": sum(b - a for a, b, cat, _ in device if cat == "kernel") * 1e-6,
        "device_op_s": sum(b - a for a, b, _, _ in device) * 1e-6,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1]),
        "idle_gaps": _charge_gaps(gaps, host),
    }


def _charge_gaps(gaps, host) -> list:
    """Seconds of idle device time by the innermost host operation that
    contains each gap's midpoint, largest first."""
    by_name = defaultdict(float)
    host = sorted(host)
    active = []                       # heap of (end, duration, name) begun before mid
    i = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (host[i][1], host[i][1] - host[i][0], host[i][2]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = min(active, key=lambda x: x[1])[2] if active else "python"
        by_name[name[:NAME_CHARS]] += (b - a) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations and the
    ten host activities of idle gaps that took most time, in seconds."""
    return {"device_ops": [[k, v] for k, v in summary["device_ops"][:TOP]],
            "idle_gaps": [[k, v] for k, v in summary["idle_gaps"][:TOP]]}


def idle_share(record: dict) -> Optional[float]:
    """The traced window's share of time in which no device operation ran,
    in %."""
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
