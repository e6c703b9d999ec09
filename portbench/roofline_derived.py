"""The least time one H100 could take for a frame of the derived stage of
a rollout whose checksums are the fields' sums (foam, or a route without
the fused checksum pass): the normals, the Jacobian foam and the sums,
counted from the shapes alone.

The stage's bound is the larger of two figures a frame, over the peaks of
``portbench/roofline.py`` (3.35 TB/s of HBM, 67 TFLOP/s in float32):

- bytes: the three displacement planes of every cascade read once
  (float32, 12 N^2 bytes a cascade) and the frame's float32 checksum
  written once;
- operations: per texel of every cascade, 15 for the normal (two central
  differences over the height scale, two products, the length's three
  squares, two sums and root, three quotients), 18 for the Jacobian and
  its mask (four central differences and their spacing, four products by
  lambda, two sums with 1, two products and a difference, the compare)
  and 7 sums into the checksum (3 displacement, 3 normal, 1 mask), 40 in
  all where the configuration computes normals and foam.

Neither figure depends on how the stage is split into kernels, so a fused
kernel that forms the same normals, mask and sums cannot read above 100%.
"""

from __future__ import annotations

from portbench.roofline import FP32_FLOPS, HBM_BYTES_PER_S

NORMAL_OPS = 15
FOAM_OPS = 18


def derived_bound(config: dict) -> dict:
    """The bound a frame of ``config``'s derived stage: ``{"seconds",
    "bytes", "flops", "by"}``, from ``ocean.resolution``,
    ``ocean.num_cascades``, ``ocean.compute_normals`` and
    ``ocean.compute_foam``."""
    ocean = config["ocean"]
    n = ocean["resolution"]
    cascades = ocean.get("num_cascades", 1)
    normals = ocean.get("compute_normals", True)
    foam = ocean.get("compute_foam", False)
    per_texel = (3 + (NORMAL_OPS + 3 if normals else 0) + (FOAM_OPS + 1 if foam else 0))
    n_bytes = cascades * 12 * n * n + 4
    flops = float(cascades * per_texel * n * n)
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_flops = flops / FP32_FLOPS
    return {"seconds": max(by_bytes, by_flops), "bytes": n_bytes, "flops": flops,
            "by": "bytes" if by_bytes >= by_flops else "operations"}
