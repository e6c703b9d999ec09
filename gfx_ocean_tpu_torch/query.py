"""Point queries of the displaced ocean surface (buoy sampling), in PyTorch.

Counterpart of ``gfx_ocean_tpu/query.py``. The renderer's surface exists
only as pixels; this module answers "how high is the water at (x, z)?"
against the same displacement texture with the same sampler (bilinear,
repeat wrap, GL texel centers: ``render/shade._sample_bilinear_wrap``) and
the same world mapping the renderer uses (mesh grid step 1 world unit,
uv = world / (h - 1), the ``ocean.vert:22-23`` visual scales).

A grid point (x0, z0) renders at

    (x0 + dx(x0, z0) / horiz_div,  dy(x0, z0) / height_div,
     z0 + dz(x0, z0) / horiz_div)

so the height above a world point (x, z) inverts the horizontal map by the
fixed point x0 <- x - dx(x0, z0) / horiz_div (likewise z0), a fixed number
of bilinear samples. Plain torch on the displacement's device: no kernel.
Divisions by a scale go through ``shade._div`` (one IEEE division on every
device), so the card and the CPU round alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gfx_ocean_tpu_torch.render import shade as sh


class SurfaceSample(NamedTuple):
    """Result of a surface point query (all leading-shape = points)."""

    height: torch.Tensor     # water height (world y) above (x, z)
    base_xz: torch.Tensor    # (..., 2) converged undisplaced grid point
    residual: torch.Tensor   # horizontal fixed-point residual (world units)
    normal: torch.Tensor     # (..., 3) unit surface normal at the sample


def _composite_sample(displacement: torch.Tensor, tiles, u, v) -> torch.Tensor:
    """Bilinear displacement at (u, v), summed over cascades, as the
    renderer's vertex stage composites them: cascade c samples at
    uv * tiles[c] (repeat wrap makes the factor a tiling)."""
    if displacement.ndim == 4:
        return sum(sh.sample_displacement(displacement[c], u * tiles[c], v * tiles[c])
                   for c in range(displacement.shape[0]))
    return sh.sample_displacement(displacement, u, v)


def sample_surface(displacement, x, z, *, mesh_resolution: int = 128,
                   height_div: float = 3.0, horiz_div: float = 3.5,
                   iterations: int = 4, tiles=None, eps: float = 0.05) -> SurfaceSample:
    """Water height (and normal) of the displaced surface above (x, z).

    ``displacement``: an (N, N, 3) field from ``make_step`` (disp_x, height,
    disp_z), or a (C, N, N, 3) cascade stack with ``tiles`` its per-cascade
    uv factors (domains[0] / domains[c]; 1 for each when None). ``x`` /
    ``z``: world coordinates of any (broadcastable) shape; one patch spans
    ``mesh_resolution - 1`` units. ``iterations``: fixed-point steps of the
    choppy inversion (0 samples directly above (x, z)). ``eps``: the
    finite-difference step (world units) of the normal. The arguments are
    those of ``gfx_ocean_tpu.query.sample_surface``; the result lies on the
    displacement's device.
    """
    displacement = torch.as_tensor(displacement, dtype=torch.float32)
    dev = displacement.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    if tiles is None:
        tiles = (1.0,) * (displacement.shape[0] if displacement.ndim == 4 else 1)
    inv_uv = 1.0 / float(mesh_resolution - 1)
    inv_h = 1.0 / float(horiz_div)

    def horiz(x0, z0):
        d = _composite_sample(displacement, tiles, x0 * inv_uv, z0 * inv_uv)
        return d[..., 0] * inv_h, d[..., 2] * inv_h, d[..., 1]

    def invert(xq, zq):
        x0, z0 = xq, zq
        for _ in range(iterations):
            dx, dz, _ = horiz(x0, z0)
            x0, z0 = xq - dx, zq - dz
        return x0, z0

    def height_at(xq, zq):
        # The probes invert too: the normal is the derivative of the
        # displaced surface's height field, horizontal stretch included.
        return sh._div(horiz(*invert(xq, zq))[2], float(height_div))

    x0, z0 = invert(x, z)
    dx, dz, dy = horiz(x0, z0)
    height = sh._div(dy, float(height_div))
    residual = torch.hypot(x0 + dx - x, z0 + dz - z)
    hx = sh._div(height_at(x + eps, z) - height_at(x - eps, z), 2.0 * eps)
    hz = sh._div(height_at(x, z + eps) - height_at(x, z - eps), 2.0 * eps)
    n = torch.stack([-hx, torch.ones_like(hx), -hz], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return SurfaceSample(height=height, base_xz=torch.stack([x0, z0], dim=-1),
                         residual=residual, normal=n)
