"""The cascade rollout: the ``rollout`` drive's closed loop of
``make_rollout(config, keep_fields=False, time_batch)`` calls on a state
of ``num_cascades`` cascades, each drawn at its own domain, with normals
and the Jacobian foam in every frame's checksum.

Cascade c is the configuration's spectrum at ``domains[c]`` drawn from the
seed ``seed + c * 2**32``: cascade 0 is the one-cascade state of the same
seed, and no two (seed, cascade) pairs share a draw while seeds stay below
2**32.

The check compares the first and last frame of the window and
``check_frames`` more drawn from the seed: each frame's checksum against
the float64 reference's (:func:`portbench.reference.cascades.checksum_terms`),
the gap over the root sum of squares of the reference's summands, the worst
over the sample (``checksum_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs, program
from portbench.drives import rollout
from portbench.reference import cascades

SEED_STRIDE = 2 ** 32


def state(cell, seed: int):
    """(h0 (C, 2, N, N), omega (C, N, N)) float32 on the cell's device."""
    ocean = cell.config["ocean"]
    draws = [inputs.state(cell.config["spectrum"], ocean["resolution"], dom,
                          seed + c * SEED_STRIDE, cell.device, cell.root)
             for c, dom in enumerate(cascades.domains(ocean))]
    return torch.stack([h for h, _ in draws]), torch.stack([o for _, o in draws])


class Drive(rollout.Drive):
    """The ``rollout`` drive with the cascade state and the cascades'
    reference; ``window``, ``traced``, ``replay`` and ``release`` are its."""

    def setup(self) -> None:
        from gfx_ocean_tpu_torch.models.ocean import OceanState, make_rollout  # noqa: PLC0415

        self.state = OceanState(*state(self.cell, self.cell.seed))
        self.fn = make_rollout(program.ocean_config(self.cell), keep_fields=False,
                               time_batch=self.cell.config["rollout"]["time_batch"])
        for _ in range(self.cell.traffic["warmup_calls"]):
            self._call(0)
        self.sums.clear()

    def check(self) -> dict:
        h0, omega = state(self.cell, self.cell.seed)
        worst, failed, limit = 0.0, 0, self.cell.limits["checksum_gap"]["limit"]
        sample = self._sample(self.total)
        for f in sample:
            got = float(self.sums[f // self.chunk][f % self.chunk])
            t = float(inputs.frame_times(f, 1, self.rate)[0])
            want, scale, _ = cascades.checksum_terms(h0, omega, t, self.cell.config["ocean"])
            gap = abs(got - want) / scale if np.isfinite(got) else float("inf")
            worst = max(worst, gap)
            failed += not gap <= limit
        return {"numbers": {"checksum_gap": worst}, "compared": len(sample),
                "failed": failed}
