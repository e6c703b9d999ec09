"""The checksum rollout of a grid whose float64 reference must run in
bands: the ``rollout`` drive's closed loop of
``make_rollout(config, keep_fields=False, time_batch)`` calls, each on
``chunk_frames`` frames whose times advance call after call at
``frame_rate_hz``, ended by a host copy of its per-frame checksums.

The check compares the first and last frame of the window and
``check_frames`` more drawn from the seed: each frame's checksum against
the banded float64 reference's
(:func:`portbench.reference.banded.checksum_terms`, ``golden``'s arithmetic
with at most one complex128 N^2 plane alive), the gap over the root sum of
squares of the reference's summands, the worst over the sample
(``checksum_gap``).
"""

from __future__ import annotations

import numpy as np

from portbench import inputs, program
from portbench.drives import rollout
from portbench.reference import banded


class Drive(rollout.Drive):
    """The ``rollout`` drive with the banded reference; ``setup``,
    ``window``, ``traced``, ``replay`` and ``release`` are its."""

    def check(self) -> dict:
        h0, omega = program.state(self.cell, self.cell.seed)
        worst, failed, limit = 0.0, 0, self.cell.limits["checksum_gap"]["limit"]
        sample = self._sample(self.total)
        for f in sample:
            got = float(self.sums[f // self.chunk][f % self.chunk])
            t = float(inputs.frame_times(f, 1, self.rate)[0])
            want, scale = banded.checksum_terms(h0, omega, t, self.cell.config["ocean"])
            gap = abs(got - want) / scale if np.isfinite(got) else float("inf")
            worst = max(worst, gap)
            failed += not gap <= limit
        return {"numbers": {"checksum_gap": worst}, "compared": len(sample),
                "failed": failed}
