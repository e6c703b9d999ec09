"""Profiling and timing (counterpart of ``gfx_ocean_tpu/utils/profiling.py``).

- ``trace()``: context manager around ``torch.profiler`` (CPU and CUDA
  activity) that writes a Chrome trace into a directory.
- ``time_rollout()``: steps/s of a checksum rollout, each timed call ended
  by a synchronize and a host copy of the checksums.
- ``profile_kernels()``: the CUDA kernels of a few calls in one
  ``torch.profiler`` window, by kernel, with the window's wall clock.
- ``traced_device_ms()``: a call's device time, the sum of the CUDA
  kernels' own durations in that window.
- ``frame_bench_main()``: the 1200x700 frame record, one JSON line.
- ``Ema``: the reference's title-bar smoothing (avg = avg*0.9 + dt*0.1).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU and, where there is a
    card, CUDA activity) and write its Chrome trace to
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _finish(out: torch.Tensor) -> np.ndarray:
    """Wait for the device and copy the checksums to the host."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out.cpu().numpy()


def time_rollout(rollout: Callable, state, ts, repeats: int = 3) -> dict:
    """Median steps/s of a checksum-mode rollout (``make_rollout(...,
    keep_fields=False)``): one warmup call (kernel build, allocator
    warmup), then ``repeats`` timed calls, each ended by a synchronize and
    a host copy of the per-frame checksums."""
    last = _finish(rollout(state, ts))
    times: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        last = _finish(rollout(state, ts))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    steps = int(np.shape(last)[0])
    return {
        "steps": steps,
        "repeats_sec": times,
        "median_sec": dt,
        "steps_per_sec": steps / dt,
        "ms_per_step": dt / steps * 1e3,
        "checksums": last,
    }


# Profiler sessions ``profile_kernels`` may take: on an H100 machine a
# session now and then records no kernel at all, after a dozen sessions in
# the process that recorded every launch.
PROFILER_ATTEMPTS = 3


def profile_kernels(fn: Callable[[], object], calls: int = 1, names: Sequence[str] = (),
                    cpu: bool = False) -> Optional[Tuple[Dict[str, Tuple[float, int]], float]]:
    """The CUDA kernels of ``calls`` calls of ``fn()`` in one
    ``torch.profiler`` window: ``({kernel: (device ms summed, launches)},
    wall ms of the calls)``.

    One call warms up first, and one more runs as the profiler's warm-up
    step before the window (without it the tracer loses the first launches
    of the window). A session that records no kernel, or not one whose name
    holds each of ``names``, is profiled again, up to ``PROFILER_ATTEMPTS``
    sessions, with a line on stderr; None after the last. ``cpu`` traces
    host activity too.
    """
    from torch.profiler import ProfilerActivity, profile, schedule  # noqa: PLC0415

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.count
                   and not e.key.startswith("ProfilerStep")}
        if kernels and all(any(n in k for k in kernels) for n in names):
            return kernels, wall_ms
        print(f"torch.profiler saw {len(kernels)} kernels, wanted {list(names)} "
              f"(session {attempt + 1} of {PROFILER_ATTEMPTS})", file=sys.stderr, flush=True)
    return None


def traced_device_ms(fn: Callable, args: tuple, frames: int = 10) -> float:
    """Per-call device time (ms) of ``fn(*args)``: the CUDA kernels' own
    durations in a :func:`profile_kernels` window of ``frames`` calls,
    summed and divided by ``frames``. NaN ("not measured") where there is
    no card or no session recorded a kernel.
    """
    if not torch.cuda.is_available():
        return float("nan")
    seen = profile_kernels(lambda: fn(*args), frames)
    if seen is None:
        return float("nan")
    return sum(ms for ms, _ in seen[0].values()) / frames


def card_name_and_power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    import subprocess  # noqa: PLC0415

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def frame_bench_main() -> None:
    """The fused-frame record on the card: step -> rasterize -> sRGB at the
    reference's 1200x700 window (``GFX_OCEAN_FRAME_W`` / ``_H`` override
    it), ``OceanConfig(fft_impl="pallas")``, the default camera, t = 11.25.

    Prints ONE JSON line: ``pipelined_wall_ms`` (25 frames back to back,
    one download at the end), ``device_ms`` (``traced_device_ms``),
    ``strip_batch`` / ``strip_wall_ms_per_frame`` (the batch renderer,
    ``GFX_OCEAN_FRAME_BATCH`` frames a call, as ``/session/strip.jpg``
    renders them), ``frame_download_ms`` / ``download_mb_per_s`` (the uint8
    frame's device-to-host copy), the state's source and the card's name and
    power limit. The state is the shipped bins where they are, else a
    Phillips state from ``torch.Generator`` seed 0. Raises without a card.
    """
    import json  # noqa: PLC0415

    import gfx_ocean_tpu_torch as ot  # noqa: PLC0415
    from gfx_ocean_tpu_torch.assets.bincode import reference_data_dir  # noqa: PLC0415
    from gfx_ocean_tpu_torch.render.camera import Camera, perspective  # noqa: PLC0415
    from gfx_ocean_tpu_torch.render.raster import (make_batch_renderer,  # noqa: PLC0415
                                                   make_frame_renderer)

    if not torch.cuda.is_available():
        raise RuntimeError("frame_bench_main measures the card: no CUDA device")
    dev = torch.device("cuda")
    w = int(os.environ.get("GFX_OCEAN_FRAME_W", "1200"))
    h = int(os.environ.get("GFX_OCEAN_FRAME_H", "700"))
    batch = int(os.environ.get("GFX_OCEAN_FRAME_BATCH", "6"))
    config = ot.OceanConfig(fft_impl="pallas")
    data = reference_data_dir()
    if all(os.path.exists(os.path.join(data, f)) for f in ("spectrum.bin", "omega.bin")):
        state, source = ot.ocean_state_from_assets(device=dev), f"bincode files in {data}"
    else:
        state = ot.ocean_state_from_phillips(
            config, generator=torch.Generator().manual_seed(0), device=dev)
        source = "phillips synthesize, torch.Generator seed 0"
    cam = Camera()
    vp = torch.tensor((perspective(w / h) @ cam.view()).astype(np.float32), device=dev)
    cp = torch.tensor(cam.position.astype(np.float32), device=dev)
    fr = make_frame_renderer(config, width=w, height=h)
    args = (state, 11.25, vp, cp)
    fr(*args).cpu()  # warm: kernel build, allocator
    depth = 25
    t0 = time.perf_counter()
    for _ in range(depth):
        out = fr(*args)
    out.cpu()
    wall_ms = (time.perf_counter() - t0) / depth * 1e3
    dev_ms = traced_device_ms(fr, args, frames=10)

    bfr = make_batch_renderer(config, width=w, height=h)
    bargs = (state, torch.arange(batch, dtype=torch.float32, device=dev) / 60.0,
             vp.expand(batch, 4, 4), cp.expand(batch, 3))
    bfr(*bargs).cpu()
    strips = 4
    t0 = time.perf_counter()
    for _ in range(strips):
        out = bfr(*bargs)
    out.cpu()
    strip_wall_ms = (time.perf_counter() - t0) / (strips * batch) * 1e3

    # The uint8 frame's device-to-host copy, on distinct frames computed
    # before the clock starts.
    reps = 4
    outs = [fr(state, 11.25 + 0.01 * i, vp, cp) for i in range(reps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for o in outs:
        o.cpu()
    xfer_ms = (time.perf_counter() - t0) / reps * 1e3

    print(json.dumps({
        "viewport": f"{w}x{h}",
        "pipelined_wall_ms": wall_ms,
        "device_ms": None if np.isnan(dev_ms) else dev_ms,
        "strip_batch": batch,
        "strip_wall_ms_per_frame": strip_wall_ms,
        "frame_download_ms": xfer_ms,
        "download_mb_per_s": w * h * 3 / 1e6 / xfer_ms * 1e3,
        "state": source,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": card_name_and_power_limit(),
    }), flush=True)


class Ema:
    """Title-bar EMA of the reference (``src/lib.rs:146-148``)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.value = 0.0

    def update(self, dt: float) -> float:
        self.value = self.value * (1.0 - self.alpha) + dt * self.alpha
        return self.value
