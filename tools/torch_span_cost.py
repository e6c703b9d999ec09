#!/usr/bin/env python3
"""What the port's recorder (``gfx_ocean_tpu_torch/utils/profiling.py``)
costs on the host, and whether it records in a profiler session that traces
the device alone.

    python3 tools/torch_span_cost.py [--root DIR]

``--root`` imports the port from the checkout at DIR (a ``git archive`` of
another commit, to set two trees side by side in one call). Prints the
card's name and power limit, then one JSON line:

- ``profiler_enabled``: ``torch.autograd._profiler_enabled()`` outside a
  session, in the warm-up step and in the active step of a
  ``torch.profiler`` session with CUDA activity alone (the benchmark's
  device session), and whether a frame-shaped unit recorded there;
- ``ns_per_span``: the host's ns for one span entered and left, the mean of
  ``REPS``: off (no unit recorded: the shared object); a span inside a
  recorded unit (``recording()``), without and with a pair of CUDA events;
  a whole unit (its counter marks included); ``cuda_unit``, a unit with
  CUDA events and three children with them, each unit opened on a drained
  stream as a frame is (per span: the anchor's query and the events; their
  times are read only by a reader, after the window); and the
  same in the active step of a CUDA-only profiler session (each span also
  enters ``record_function``);
- ``ns_per_count``: ``count()`` off and inside a recorded unit;
- ``ns_per_mark``: ``mark()`` off, and on in a leaf of an anchored unit
  (one event recorded), where the port has it;
- ``ns_per_call``: the CUDA calls a span with events makes, outside a
  profiler session and in the active step of a CUDA-only one:
  ``current_stream``, a new ``Event``, its first ``record`` (which creates
  the CUDA event), a ``record`` of an event recorded before, a stream's and
  an event's ``query``, ``elapsed_time``.

Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REPS = 20000


def ns_each(fn, reps: int = REPS) -> float:
    fn()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    return (time.perf_counter_ns() - t0) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose port to import")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from gfx_ocean_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.ones(1, device=dev).sum().item()
    span, count = profiling.span, profiling.count

    def off():
        with span("x"):
            pass

    def child():
        with span("x"):
            pass

    def child_events():
        with span("x", device=dev):
            pass

    def unit():
        with span("unit", t=0.0, band=0):
            pass

    def cuda_unit(reps: int) -> float:
        """ns a span of a unit of four spans with CUDA events, each unit
        opened on a drained stream (the wait for it not counted)."""
        total = 0
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter_ns()
            with span("unit", device=dev, t=0.0, band=0):
                for _ in range(3):
                    with span("x", device=dev):
                        pass
            total += time.perf_counter_ns() - t0
        return total / reps / 4

    def calls(reps: int = REPS // 10) -> dict:
        """ns a CUDA call of those a span with events makes."""
        stream = torch.cuda.current_stream(dev)
        out = {"current_stream": ns_each(lambda: torch.cuda.current_stream(dev), reps),
               "stream_query": ns_each(stream.query, reps),
               "event_new": ns_each(lambda: torch.cuda.Event(enable_timing=True), reps)}
        fresh = iter([torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)])
        out["record_first"] = ns_each(lambda: next(fresh).record(stream), reps)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(stream)
        out["record_again"] = ns_each(lambda: b.record(stream), reps)
        torch.cuda.synchronize()
        out["event_query"] = ns_each(b.query, reps)
        out["elapsed_time"] = ns_each(lambda: a.elapsed_time(b), reps)
        return out

    def inside(fn, reps=REPS):
        """``fn`` run ``reps`` times inside one recorded unit."""
        with span("outer"):
            return ns_each(fn, reps)

    out = {"ns_per_span": {}, "ns_per_count": {}, "profiler_enabled": {},
           "ns_per_call": {"outside": calls()}}
    out["profiler_enabled"]["outside"] = torch.autograd._profiler_enabled()
    out["ns_per_span"]["off"] = ns_each(off)
    out["ns_per_count"]["off"] = ns_each(lambda: count("n"))
    with profiling.recording():
        out["ns_per_span"]["child"] = inside(child)
        out["ns_per_span"]["child_cuda_events"] = inside(child_events, REPS // 10)
        out["ns_per_span"]["unit"] = ns_each(unit, REPS // 10)
        out["ns_per_span"]["cuda_unit"] = cuda_unit(REPS // 10)
        out["ns_per_count"]["on"] = inside(lambda: count("n"))
    torch.cuda.synchronize()
    if hasattr(profiling, "mark"):
        out["ns_per_mark"] = {"off": ns_each(profiling.mark)}
        with profiling.recording():
            with span("unit", device=dev):
                with span("x", device=dev):
                    out["ns_per_mark"]["on"] = ns_each(profiling.mark, REPS // 10)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        out["profiler_enabled"]["cuda_session_warmup"] = torch.autograd._profiler_enabled()
        prof.step()
        out["profiler_enabled"]["cuda_session_active"] = torch.autograd._profiler_enabled()
        with span("frame", t=0.0, band=0):
            with span("frame.step", device=dev):
                torch.ones(8, device=dev).sum()
        last = profiling.windows()[-1].units[-1]
        out["profiler_enabled"]["unit_recorded"] = (
            last.traced and [s.name for s in last.spans] == ["frame", "frame.step"])
        reps = REPS // 10
        with span("outer"):
            out["ns_per_span"]["cuda_session_child"] = ns_each(child, reps)
            out["ns_per_span"]["cuda_session_child_cuda_events"] = ns_each(child_events, reps)
        out["ns_per_span"]["cuda_session_unit"] = ns_each(unit, reps)
        out["ns_per_span"]["cuda_session_cuda_unit"] = cuda_unit(reps)
        out["ns_per_call"]["cuda_session"] = calls()
    torch.cuda.synchronize()
    out["device"] = torch.cuda.get_device_name(0)
    out["torch"] = torch.__version__
    out["root"] = str(Path(profiling.__file__).resolve().parents[2])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
