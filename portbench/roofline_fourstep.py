"""The least time one H100 could take for the row half of a four-step
frame (K2: the propagate and the transforms along the rows), counted from
the shapes alone, over the peaks of ``portbench/roofline.py`` (3.35 TB/s of
HBM, 67 TFLOP/s in float32).

The row half's bound is the larger of two figures a frame:

- bytes: the state (h0 as two float32 planes, omega as one, 12 N^2 bytes)
  read once a call of ``time_batch`` frames;
- operations: half of ``roofline.step_bound``'s, the transforms along one
  axis of the three real fields, 7.5 N^2 log2 N.

Neither figure depends on the tier, the body, or whether K2's stage 2 runs
in its stage-1 kernel or from a scratch, so a K2 of any design reads the
same work and cannot pass 100%.
"""

from __future__ import annotations

import math

from portbench.roofline import FP32_FLOPS, HBM_BYTES_PER_S


def rows_bound(config: dict) -> dict:
    """The bound a frame of ``config``'s row half: ``{"seconds", "bytes",
    "flops", "by"}``, from ``ocean.resolution``, ``ocean.num_cascades`` and
    ``rollout.time_batch``."""
    ocean = config["ocean"]
    n = ocean["resolution"]
    cascades = ocean.get("num_cascades", 1)
    frames = config.get("rollout", {}).get("time_batch", 1)
    n_bytes = cascades * 12 * n * n / frames
    flops = cascades * 7.5 * n * n * math.log2(n)
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_flops = flops / FP32_FLOPS
    return {"seconds": max(by_bytes, by_flops), "bytes": n_bytes, "flops": flops,
            "by": "bytes" if by_bytes >= by_flops else "operations"}
