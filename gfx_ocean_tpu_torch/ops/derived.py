"""Correction (``shader/correction.comp``), finite-difference normals
(``shader/ocean.frag:50-67``) and the Jacobian whitecap mask in PyTorch,
and the derived stage of a rollout's checksums: kernel K10.

Counterpart of ``gfx_ocean_tpu/ops/derived.py``. The step folds the
correction sign into its DFT tables (or its kernels); ``correction`` is
the explicit pass, for callers of the plain transforms and the "xla" route.

K10 (``csrc/derived.cu``, the port's own kernel: the JAX package computes
the stage as jnp ops) forms in one launch, from a chunk's plane-major
planes, each frame's checksum: the planes' sum, the normals' and the foam
mask's, over every cascade, the mask at each cascade's own domain.
``derived_checksums`` dispatches on the planes' device: CUDA tensors launch
K10 (``launch_derived_partials``) or raise, CPU tensors take the plain
version ``derived_checksums_reference``, the eager chain of normals,
``jacobian_foam`` and sums that ``models/ocean.py`` runs on its fields.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gfx_ocean_tpu_torch import kernels
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


def foam_factors(config: OceanConfig, n: int,
                 domain_size: Optional[float] = None) -> Tuple[float, float]:
    """The foam's lambda and central-difference factor 1 / (2 h), each
    rounded to float32, for an n-texel side of ``domain_size`` (the
    config's when None): what :func:`jacobian_foam` and K10 multiply by."""
    spacing = (domain_size if domain_size is not None else config.domain_size) / n
    return (float(np.float32(config.foam_lambda)),
            float(np.float32(1.0 / (2.0 * spacing))))


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
    lam, inv2h = foam_factors(config, displacement.shape[-2], domain_size)
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


def foam_of(displacement: torch.Tensor, config: OceanConfig,
            domains: Optional[Sequence[float]] = None, halo: bool = False) -> torch.Tensor:
    """:func:`jacobian_foam` of displacement maps (..., N, N, 3): with
    ``domains`` one mask a cascade (axis -4 of the maps) at its own domain,
    stacked on axis -3, else one at ``config.domain_size``."""
    if domains is None:
        return jacobian_foam(displacement, config, halo=halo)
    return torch.stack([jacobian_foam(displacement[..., c, :, :, :], config, domain_size=dom,
                                      halo=halo)
                        for c, dom in enumerate(domains)], dim=-3)


def checksums_of_fields(displacement: torch.Tensor, normals: Optional[torch.Tensor],
                        foam: Optional[torch.Tensor], count_foam: bool = False) -> torch.Tensor:
    """One checksum a frame (the leading axis) of channel-last fields: the
    sum of the displacement, the normals and the foam mask, over every
    cascade; with ``count_foam`` the texels the mask set, over every frame
    and cascade, are added to the recorded unit's counter ``foam.texels``."""
    out = displacement.sum(dim=(-3, -2, -1))
    if normals is not None:
        out = out + normals.sum(dim=(-3, -2, -1))
    if foam is not None:
        texels = foam.sum(dim=(-2, -1))
        if count_foam:
            profiling.count("foam.texels", texels.sum())
        out = out + texels
    return out.reshape(out.shape[0], -1).sum(dim=-1) if out.ndim > 1 else out


# --------------------------------------------------------------------------
# The derived stage of a rollout's checksums: K10 and its plain version.
# --------------------------------------------------------------------------

# csrc/derived.cu: threads a block, rows a thread walks, cascades a launch.
DERIVED_THREADS, DERIVED_ROWS, DERIVED_MAX_CASCADES = 128, 16, 64


def derived_tiles(n: int) -> int:
    """K10's blocks for one (frame, cascade) of n x n planes: a float4 a
    thread, ``DERIVED_ROWS`` rows deep, ``DERIVED_THREADS`` a block."""
    return -(-(n // 4) * (n // DERIVED_ROWS) // DERIVED_THREADS)


def derived_checksums_reference(planes: torch.Tensor, config: OceanConfig,
                                domains: Optional[Sequence[float]] = None,
                                count_foam: bool = False) -> torch.Tensor:
    """Plain PyTorch K10: the checksums (tb,) of planes (tb, 3, N, N) or
    (tb, C, 3, N, N), by the eager chain ``models/ocean.py`` runs on a
    rollout's fields: normals, :func:`foam_of` (at ``domains``) and
    :func:`checksums_of_fields` of the channel-last view."""
    disp = torch.movedim(planes, -3, -1)
    normals = (finite_difference_normals(disp[..., 1], config.normal_height_scale)
               if config.compute_normals else None)
    foam = foam_of(disp, config, domains) if config.compute_foam else None
    return checksums_of_fields(disp, normals, foam, count_foam)


def launch_derived_partials(planes: torch.Tensor, config: OceanConfig,
                            domains: Optional[Sequence[float]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K10 on the current stream over planes (tb, 3, N, N) or
    (tb, C, 3, N, N) float32 whose (3, N, N) blocks are contiguous, the
    frame and cascade axes in either order in memory (K1's cascade-major
    planes as ``ops/fused_step.packed_planes`` returns them, or a stack of
    frames); nothing is copied. ``domains``: each cascade's foam domain,
    ``config.domain_size`` for every one when None.

    Returns ``(partials, counts)``, each (tb, C, ``derived_tiles(N)``):
    float32 sums of the planes and normal terms, int32 foam texels. Counts
    ``launches.launch_derived_partials`` (``kernels.launch``). Raises
    ``ValueError`` on a tensor K10 does not take."""
    dev = kernels.cuda_device(planes, "launch_derived_partials")
    if planes.ndim not in (4, 5) or planes.dtype != torch.float32:
        raise ValueError(f"K10 takes float32 planes (tb, [C,] 3, N, N), got "
                         f"{str(planes.dtype).removeprefix('torch.')} {tuple(planes.shape)}")
    view = planes if planes.ndim == 5 else planes.unsqueeze(1)
    tb, cascades, three, n, n1 = view.shape
    if three != 3 or n != n1 or n < 16 or n > 16384 or n & (n - 1):
        raise ValueError(f"K10 takes (3, N, N) planes with N a power of two in [16, 16384], "
                         f"got {tuple(planes.shape)}")
    frame_stride, cascade_stride, *inner = view.stride()
    frame_stride *= tb > 1           # the stride of an axis of one is never read
    cascade_stride *= cascades > 1
    if tuple(inner) != (n * n, n, 1) or planes.data_ptr() % 16 or frame_stride % 4 \
            or cascade_stride % 4:
        raise ValueError(f"K10 takes contiguous, 16-byte aligned (3, N, N) blocks, got "
                         f"strides {tuple(planes.stride())}")
    if not 1 <= tb <= 65535 or not 1 <= cascades <= DERIVED_MAX_CASCADES:
        raise ValueError(f"K10 takes 1 to 65535 frames and 1 to {DERIVED_MAX_CASCADES} "
                         f"cascades, got {tb} and {cascades}")
    doms = tuple(domains) if domains is not None else (config.domain_size,) * cascades
    if len(doms) != cascades:
        raise ValueError(f"{len(doms)} domains for {cascades} cascades")
    lam = foam_factors(config, n)[0]
    inv2h = (ctypes.c_float * cascades)(*(foam_factors(config, n, d)[1] for d in doms))
    tiles = derived_tiles(n)
    partials = torch.empty((tb, cascades, tiles), dtype=torch.float32, device=dev)
    counts = torch.empty((tb, cascades, tiles), dtype=torch.int32, device=dev)
    kernels.launch(
        "launch_derived_partials", "derived", "derived_partials",
        kernels.ptr(planes), tb, cascades, frame_stride, cascade_stride, n, inv2h, lam,
        float(np.float32(config.foam_threshold)), float(config.normal_height_scale),
        int(config.compute_normals), int(config.compute_foam), kernels.ptr(partials),
        kernels.ptr(counts), tiles, device=dev)
    return partials, counts


def derived_checksums(planes: torch.Tensor, config: OceanConfig,
                      domains: Optional[Sequence[float]] = None,
                      count_foam: bool = False) -> torch.Tensor:
    """The checksums (tb,) of a rollout chunk's planes (tb, [C,] 3, N, N):
    each frame's sum of the planes, the normals (``compute_normals``) and
    the foam mask (``compute_foam``, at ``domains``, see
    :func:`launch_derived_partials`), over its cascades. On CUDA tensors K10,
    its partials summed in an order fixed by their shape (no float
    atomics); on CPU tensors the plain version. With ``count_foam`` the
    mask's texels are added to the recorded unit's counter ``foam.texels``."""
    if not planes.is_cuda:
        return derived_checksums_reference(planes, config, domains, count_foam)
    partials, counts = launch_derived_partials(planes, config, domains)
    texels = counts.sum(dim=(1, 2))
    if count_foam and config.compute_foam:
        profiling.count("foam.texels", texels.sum())
    return partials.sum(dim=(1, 2)) + texels
