"""Finite-difference normals (``shader/ocean.frag:50-67``) in PyTorch.

Counterpart of ``gfx_ocean_tpu/ops/derived.py:54-101``. Foam
(``jacobian_foam``) is not ported yet (ROADMAP.md queue 1, "ops/derived.py").
"""

from __future__ import annotations

from typing import Optional

import torch

from gfx_ocean_tpu_torch.config import OceanConfig


def finite_difference_normals_planes(
        height: torch.Tensor, height_scale: float = 180.0) -> torch.Tensor:
    """Central-difference normal map in plane-major (..., 3, N, N) layout.

    The reference samples +-1 texel with repeat wrap: texture x = axis -1,
    texture y = axis -2. na = normalize(-dx, (x1-x0)/hs, 0), nb =
    normalize(0, (z1-z0)/hs, dy), N = normalize(cross(na, nb)); the two
    inner normalizations scale the cross product uniformly per texel, so
    only the final one is taken.
    """
    n0, n1 = height.shape[-2], height.shape[-1]
    diff_x = 2.0 / n1
    diff_y = 2.0 / n0
    x0 = torch.roll(height, 1, dims=-1)
    x1 = torch.roll(height, -1, dims=-1)
    z0 = torch.roll(height, 1, dims=-2)
    z1 = torch.roll(height, -1, dims=-2)

    gx = (x1 - x0) / height_scale
    gz = (z1 - z0) / height_scale

    cx = gx * diff_y
    cy = torch.full_like(height, diff_x * diff_y)
    cz = -diff_x * gz
    length = torch.sqrt(cx * cx + cy * cy + cz * cz)
    return torch.stack([cx / length, cy / length, cz / length], dim=-3)


def finite_difference_normals(height: torch.Tensor,
                              height_scale: float = 180.0) -> torch.Tensor:
    """Central-difference normal map, channel-last (..., N, N, 3)."""
    return torch.movedim(
        finite_difference_normals_planes(height, height_scale), -3, -1)


def normals_scale(config: OceanConfig) -> Optional[float]:
    """The normals' height scale when the config computes normals, else None."""
    return float(config.normal_height_scale) if config.compute_normals else None


def checksums_of_planes(planes: torch.Tensor, config: OceanConfig) -> torch.Tensor:
    """Per-frame sum(planes) [+ sum(normal terms)] of (tb, 3, N, N) planes."""
    sums = planes.sum(dim=(-3, -2, -1))
    scale = normals_scale(config)
    if scale is not None:
        normals = finite_difference_normals_planes(planes[:, 1], scale)
        sums = sums + normals.sum(dim=(-3, -2, -1))
    return sums
