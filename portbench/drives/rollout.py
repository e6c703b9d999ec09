"""The checksum rollout: a closed loop of
``make_rollout(config, keep_fields=False, time_batch)`` calls, each on
``chunk_frames`` frames whose times advance call after call at
``frame_rate_hz``, ended by a host copy of its per-frame checksums.

The check compares the first and last frame of the window and
``check_frames`` more drawn from the seed: each frame's checksum against
the float64 reference's (:func:`portbench.reference.golden.checksum_terms`),
the gap over the root sum of squares of the reference's summands, the worst
over the sample (``checksum_gap``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import inputs, program, trace
from portbench.reference import golden


class Drive:
    """See the module's docstring; the harness calls ``setup``, ``window``
    or ``traced``, ``release`` and ``check`` in that order."""

    def __init__(self, cell):
        self.cell = cell
        self.rate = cell.traffic["frame_rate_hz"]
        self.chunk = cell.config["rollout"]["chunk_frames"]
        self.sums: Dict[int, np.ndarray] = {}      # call index -> its checksums
        self.next_chunk = 0
        self.total = 0                             # frames of the window

    def setup(self) -> None:
        from gfx_ocean_tpu_torch.models.ocean import OceanState, make_rollout  # noqa: PLC0415

        self.state = OceanState(*program.state(self.cell, self.cell.seed))
        self.fn = make_rollout(program.ocean_config(self.cell), keep_fields=False,
                               time_batch=self.cell.config["rollout"]["time_batch"])
        for _ in range(self.cell.traffic["warmup_calls"]):
            self._call(0)
        self.sums.clear()

    def _call(self, index: int) -> int:
        ts = torch.from_numpy(inputs.frame_times(index * self.chunk, self.chunk, self.rate))
        self.sums[index] = self.fn(self.state, ts).cpu().numpy()
        return self.chunk

    def _next(self) -> int:
        self.next_chunk += 1
        self.total = self.next_chunk * self.chunk
        return self._call(self.next_chunk - 1)

    def window(self, seconds: float) -> dict:
        return trace.run_for(self._next, seconds)

    def traced(self, seconds: float) -> dict:
        """Whole calls for ``trace_seconds`` (at most ``seconds``) traced on
        the device, then ``gap_seconds`` more with the host's operations."""
        return {"trace": trace.traced(self._next, min(seconds, self.cell.traffic["trace_seconds"]),
                                      1, self.cell.traffic["gap_seconds"])}

    def replay(self, frames: int) -> None:
        """The calls that hold the frames ``check`` samples out of a window
        of ``frames`` frames, in place of the window."""
        self.total = frames
        for index in sorted({f // self.chunk for f in self._sample(frames)}):
            self._call(index)

    def release(self) -> None:
        del self.fn, self.state

    def _sample(self, frames: int) -> List[int]:
        rng = np.random.default_rng(self.cell.seed)
        k = min(self.cell.traffic["check_frames"], frames)
        picked = rng.choice(frames, size=k, replace=False).tolist()
        return sorted({0, frames - 1, *picked})

    def check(self) -> dict:
        h0, omega = program.state(self.cell, self.cell.seed)
        worst, failed, limit = 0.0, 0, self.cell.limits["checksum_gap"]["limit"]
        sample = self._sample(self.total)
        for f in sample:
            got = float(self.sums[f // self.chunk][f % self.chunk])
            t = float(inputs.frame_times(f, 1, self.rate)[0])
            want, scale = golden.checksum_terms(h0, omega, t, self.cell.config["ocean"])
            gap = abs(got - want) / scale if np.isfinite(got) else float("inf")
            worst = max(worst, gap)
            failed += not gap <= limit
        return {"numbers": {"checksum_gap": worst}, "compared": len(sample),
                "failed": failed}
