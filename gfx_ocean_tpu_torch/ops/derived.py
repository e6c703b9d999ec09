"""Correction (``shader/correction.comp``), finite-difference normals
(``shader/ocean.frag:50-67``) and the Jacobian whitecap mask in PyTorch.

Counterpart of ``gfx_ocean_tpu/ops/derived.py``. The step folds the
correction sign into its DFT tables (or its kernels); ``correction`` is
the explicit pass, for callers of the plain transforms and the "xla" route.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from gfx_ocean_tpu_torch.config import OceanConfig
from gfx_ocean_tpu_torch.utils import profiling
from gfx_ocean_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=None)
def _sign_np(n: int, ref_sign: bool) -> np.ndarray:
    x = np.arange(n)[None, :]
    y = np.arange(n)[:, None]
    even = (x + y) % 2 == 0
    if ref_sign:  # Q2: the reference flips the canonical convention
        return np.where(even, np.float32(-1.0), np.float32(1.0))
    return np.where(even, np.float32(1.0), np.float32(-1.0))


def correction_sign(n: int, ref_sign: bool = True,
                    device: torch.device | str | None = None) -> torch.Tensor:
    """(N, N) float32 sign grid of ``shader/correction.comp:29`` on ``device``
    (the card when None; raises when there is none)."""
    return sign_grid(n, ref_sign, resolve_device(device)).clone()


def sign_grid(n: int, ref_sign: bool, device: torch.device | str) -> torch.Tensor:
    """:func:`correction_sign` on ``device``, made once per (n, ref_sign,
    device). Read only: every caller shares the one tensor."""
    return _sign_grid(n, bool(ref_sign), torch.device(device))


@profiling.counted_cache(maxsize=None)
def _sign_grid(n: int, ref_sign: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_sign_np(n, ref_sign)).to(device)


def correction(f_height: torch.Tensor, f_dx: torch.Tensor, f_dz: torch.Tensor,
               ref_sign: bool = True) -> torch.Tensor:
    """Take real parts, apply the centering sign, pack (dx, h, dz):
    ``shader/correction.comp:31-34``'s channel order (disp_x, height,
    disp_z), on the fields' device. Returns (..., N, N, 3) float32."""
    sign = sign_grid(f_height.shape[-1], ref_sign, f_height.device)
    return torch.stack([torch.real(f).to(torch.float32) * sign
                        for f in (f_dx, f_height, f_dz)], dim=-1)


def _rows_around(f: torch.Tensor, halo: bool):
    """(f at row y - 1, f, f at row y + 1) over axis -2: periodic, or with
    ``halo`` from a row band of a row-sharded grid that carries one
    neighbour row on each side (``parallel/collectives.halo_rows``), whose
    own rows are returned."""
    if halo:
        return f[..., :-2, :], f[..., 1:-1, :], f[..., 2:, :]
    return torch.roll(f, 1, dims=-2), f, torch.roll(f, -1, dims=-2)


def finite_difference_normals_planes(
        height: torch.Tensor, height_scale: float = 180.0, halo: bool = False) -> torch.Tensor:
    """Central-difference normal map in plane-major (..., 3, N, N) layout.

    The reference samples +-1 texel with repeat wrap: texture x = axis -1,
    texture y = axis -2. na = normalize(-dx, (x1-x0)/hs, 0), nb =
    normalize(0, (z1-z0)/hs, dy), N = normalize(cross(na, nb)); the two
    inner normalizations scale the cross product uniformly per texel, so
    only the final one is taken. With ``halo`` the height is a row band of
    a square grid with one neighbour row on each side; the band's own rows
    come back, equal to those rows of the whole grid's map.
    """
    z0, height, z1 = _rows_around(height, halo)
    n1 = height.shape[-1]
    n0 = n1 if halo else height.shape[-2]
    diff_x = 2.0 / n1
    diff_y = 2.0 / n0
    x0 = torch.roll(height, 1, dims=-1)
    x1 = torch.roll(height, -1, dims=-1)

    gx = (x1 - x0) / height_scale
    gz = (z1 - z0) / height_scale

    cx = gx * diff_y
    cy = torch.full_like(height, diff_x * diff_y)
    cz = -diff_x * gz
    length = torch.sqrt(cx * cx + cy * cy + cz * cz)
    return torch.stack([cx / length, cy / length, cz / length], dim=-3)


def finite_difference_normals(height: torch.Tensor, height_scale: float = 180.0,
                              halo: bool = False) -> torch.Tensor:
    """Central-difference normal map, channel-last (..., N, N, 3)."""
    return torch.movedim(
        finite_difference_normals_planes(height, height_scale, halo), -3, -1)


def normals_scale(config: OceanConfig) -> Optional[float]:
    """The normals' height scale when the config computes normals, else None."""
    return float(config.normal_height_scale) if config.compute_normals else None


def checksums_of_planes(planes: torch.Tensor, config: OceanConfig) -> torch.Tensor:
    """Per-frame sum(planes) [+ sum(normal terms)] of (tb, 3, N, N) planes;
    of (tb, C, 3, N, N) cascade planes summed over the cascades too."""
    sums = planes.sum(dim=(-3, -2, -1))
    scale = normals_scale(config)
    if scale is not None:
        normals = finite_difference_normals_planes(planes[..., 1, :, :], scale)
        sums = sums + normals.sum(dim=(-3, -2, -1))
    return sums.sum(dim=-1) if sums.ndim > 1 else sums


def jacobian_foam(displacement: torch.Tensor, config: OceanConfig,
                  domain_size: Optional[float] = None, halo: bool = False) -> torch.Tensor:
    """Whitecap mask from the Jacobian of the horizontal displacement map.

    J = (1 + l dDx/dx)(1 + l dDz/dz) - (l dDx/dz)(l dDz/dx); foam = J < thr,
    as float32. Central differences with wrap; grid spacing L / N (pass
    ``domain_size`` for a cascade's own patch size). Every product and sum
    is rounded separately (XLA on the CPU may contract them, so texels
    within ~1e-6 of the threshold can differ from the JAX package). With
    ``halo`` the map is a row band with one neighbour row on each side
    (see :func:`finite_difference_normals_planes`).
    """
    n = displacement.shape[-2]
    spacing = (domain_size if domain_size is not None else config.domain_size) / n
    lam = float(np.float32(config.foam_lambda))
    inv2h = float(np.float32(1.0 / (2.0 * spacing)))
    up_x, fx, down_x = _rows_around(displacement[..., 0], halo)
    up_z, fz, down_z = _rows_around(displacement[..., 2], halo)

    def ddx(f):  # texture x = axis -1
        return (torch.roll(f, -1, dims=-1) - torch.roll(f, 1, dims=-1)) * inv2h

    def ddz(up, down):  # texture y = axis -2
        return (down - up) * inv2h

    jxx = 1.0 + lam * ddx(fx)
    jzz = 1.0 + lam * ddz(up_z, down_z)
    jxz = lam * ddz(up_x, down_x)
    jzx = lam * ddx(fz)
    jac = jxx * jzz - jxz * jzx
    return (jac < float(np.float32(config.foam_threshold))).to(torch.float32)
