"""The least time one H100 could take for a frame of the ocean step,
counted from the shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor
cores.

The step's bound is the larger of two figures a frame:

- bytes: the state (h0 as two float32 planes, omega as one) read once a
  call and what the call returns written once (a float32 checksum a frame
  in checksum mode; the displacement and normal maps otherwise), over the
  HBM rate;
- operations: the 2-D inverse transforms that turn the spectra into the
  three real fields (disp_x, height, disp_z). A real-output 2-D transform
  of N x N is half a complex one, 2N transforms of N points at
  5 N log2 N, so 5 N^2 log2 N each and 15 N^2 log2 N a frame, over the
  float32 rate.

Neither figure depends on the precision tier, the route (packed,
unpacked, four-step) or how many passes a tier's products take, so an
implementation that computes the same fields with fewer or cheaper
operations cannot read above 100%.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def step_bound(config: dict) -> dict:
    """The bound a frame of ``config``'s step: ``{"seconds", "bytes",
    "flops", "by"}``, from ``ocean.resolution``, ``ocean.num_cascades``,
    ``ocean.compute_normals`` and ``rollout.time_batch`` /
    ``rollout.keep_fields``."""
    ocean = config["ocean"]
    n = ocean["resolution"]
    cascades = ocean.get("num_cascades", 1)
    rollout = config.get("rollout", {})
    frames = rollout.get("time_batch", 1)
    if rollout.get("keep_fields", False):
        maps = 6 if ocean.get("compute_normals", True) else 3
        out_bytes = 4 * maps * n * n * cascades
    else:
        out_bytes = 4
    n_bytes = cascades * 12 * n * n / frames + out_bytes
    flops = cascades * 15.0 * n * n * math.log2(n)
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_flops = flops / FP32_FLOPS
    return {"seconds": max(by_bytes, by_flops), "bytes": n_bytes, "flops": flops,
            "by": "bytes" if by_bytes >= by_flops else "operations"}
