"""The interactive frame: a closed loop of
``make_frame_renderer(config, width, height, giants)`` at the default
camera, each frame's uint8 image copied to the host before the next one
starts.

The frames are an animation at ``frame_rate_hz`` of one state (the
configuration's ``frame.state_seed``), played in order from a start frame
drawn from the run's seed and wrapping at ``cycle_frames``. Whether a
frame's slot demand overflows the pool, and so runs the giant pass,
depends on the state and the time, so the window runs whole cycles (until
``--seconds`` have passed and the cycle is complete) and the traced window
one cycle: every run renders the same set of frames. The warm-up renders
``warmup_calls`` frames spread over the cycle.

The check compares one frame in ``check_every`` (from an offset drawn from
the seed) with the reference frame drawn from the float64 fields
(:mod:`portbench.reference.render`), by :func:`frame_gaps`, each number
the worst over the frames.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import inputs, program, trace
from portbench.reference import camera, golden, render


class Drive:
    """See the module's docstring; the harness calls ``setup``, ``window``
    or ``traced``, ``release`` and ``check`` in that order."""

    def __init__(self, cell):
        self.cell = cell
        self.rate = cell.traffic["frame_rate_hz"]
        self.cycle = cell.traffic["cycle_frames"]
        self.frame = cell.config["frame"]
        self.stride = cell.traffic["check_every"]
        rng = np.random.default_rng(cell.seed)
        self.start = int(rng.integers(self.cycle))
        self.offset = int(rng.integers(self.stride))
        self.kept: Dict[int, np.ndarray] = {}
        self.latencies: List[float] = []
        self.next_frame = 0

    def setup(self) -> None:
        from gfx_ocean_tpu_torch.models.ocean import OceanState  # noqa: PLC0415
        from gfx_ocean_tpu_torch.render.raster import make_frame_renderer  # noqa: PLC0415

        w, h = self.frame["width"], self.frame["height"]
        self.state = OceanState(*program.state(self.cell, self.frame["state_seed"]))
        self.fn = make_frame_renderer(program.ocean_config(self.cell), w, h,
                                      self.frame["giants"])
        vp, pos = camera.default_view(w, h)
        self.view_proj = torch.from_numpy(vp).to(self.cell.device)
        self.eye = torch.from_numpy(pos).to(self.cell.device)
        warmup = self.cell.traffic["warmup_calls"]
        for i in range(warmup):
            self._draw(self._pose_time(i * self.cycle // warmup))

    def _pose_time(self, pose: int) -> float:
        return float(inputs.frame_times(pose, 1, self.rate)[0])

    def _time(self, f: int) -> float:
        """The time of the window's ``f``-th frame."""
        return self._pose_time((self.start + f) % self.cycle)

    def _draw(self, t: float) -> torch.Tensor:
        return self.fn(self.state, t, self.view_proj, self.eye).cpu()

    def _render(self, f: int) -> int:
        t0 = time.perf_counter()
        img = self._draw(self._time(f))
        self.latencies.append(time.perf_counter() - t0)
        if (f + self.offset) % self.stride == 0:
            self.kept[f] = img.numpy()
        return 1

    def _next(self) -> int:
        self.next_frame += 1
        return self._render(self.next_frame - 1)

    def window(self, seconds: float) -> dict:
        return {**trace.run_for(self._next, seconds, self.cycle),
                "latencies_s": list(self.latencies)}

    def traced(self, seconds: float) -> dict:
        """One cycle traced on the device, then ``gap_seconds`` more with
        the host's operations."""
        return {"trace": trace.traced(self._next, 0.0, self.cycle,
                                      self.cell.traffic["gap_seconds"])}

    def replay(self, frames: int) -> None:
        """The frames ``check`` keeps out of a window of ``frames`` frames,
        in place of the window."""
        for f in range(frames):
            if (f + self.offset) % self.stride == 0:
                self._render(f)

    def release(self) -> None:
        del self.fn, self.state

    def check(self) -> dict:
        h0, omega = program.state(self.cell, self.frame["state_seed"])
        ocean = self.cell.config["ocean"]
        limits = {k: v["limit"] for k, v in self.cell.limits.items()}
        worst: Dict[str, float] = {}
        failed = 0
        for f, got in sorted(self.kept.items()):
            disp = golden.fields(h0, omega, self._time(f), ocean["domain_size"],
                                 ocean.get("compat", {})).to(torch.float32)
            want = render.frame(disp, self.view_proj, self.eye, self.frame["width"],
                                self.frame["height"], ocean["mesh_resolution"],
                                ocean["num_patches"], self.frame["reference_samples"],
                                self.frame["giants"]).cpu().numpy()
            numbers = frame_gaps(got, want)
            for name, value in numbers.items():
                worst[name] = max(worst.get(name, 0.0), value)
            failed += any(not numbers[name] <= limits[name] for name in limits)
        return {"numbers": worst, "compared": len(self.kept), "failed": failed}


def frame_gaps(got: np.ndarray, want: np.ndarray) -> dict:
    """``off_by_1``: the share of uint8 values that differ at all;
    ``mean_gap``: the largest difference of a colour channel's mean."""
    means = np.abs(got.reshape(-1, 3).astype(np.float64).mean(0)
                   - want.reshape(-1, 3).astype(np.float64).mean(0))
    return {"off_by_1": float((got != want).mean()), "mean_gap": float(means.max())}
