"""Float64 numpy golden model of the reference pipeline.

A copy of ``gfx_ocean_tpu/golden/reference.py`` (propagate, unnormalized
2-D inverse DFT, correction sign, finite-difference normals), so that the
port can gate its results on the card, where jax is absent.
``tests/test_torch_config_assets.py`` proves it equals the original bit
for bit. Semantics, arrays indexed [y, x]:

1. ``h = h0[y, x] e^{iwt} + h0[N-1-y, N-1-x] e^{-iwt}`` (no conjugate on
   the flipped sample unless ``conj_neg``), ``k = pi (2i - N - 1) / L``
   per axis (uint32 wrap iff ``wrap_k``), ``d_{x,z} = -i k_hat h``.
2. Unnormalized inverse DFT: ``N^2 * numpy.fft.ifft2``.
3. Correction: -1 where (x+y) even (``ref_sign``), real part, packed as
   (disp_x, height, disp_z).
4. Normals: central differences of the height with height_scale 180.
5. ``golden_step``: the step's outputs as a dict, with the Jacobian foam
   mask of ``golden_foam`` (BASELINE config 4) when ``compute_foam``.

``golden_fields_rows`` computes the same fields on a band of rows, in
float64 torch on the tensors' device, for grids where a whole numpy golden
is too slow (16384^2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gfx_ocean_tpu_torch.config import CompatFlags, OceanConfig


def wavenumber_1d(n: int, domain_size: float, wrap: bool) -> np.ndarray:
    """Centered wavenumber coordinate pi*(2i - N - 1)/L for i in [0, N).

    ``wrap=True`` replicates Q1: ``2*i - N - 1`` in uint32 arithmetic,
    wrapped mod 2**32 and converted to float32.
    """
    i = np.arange(n, dtype=np.int64)
    signed = 2 * i - n - 1
    if wrap:
        wrapped = np.asarray(signed % (1 << 32), dtype=np.uint64)
        coord = wrapped.astype(np.float32).astype(np.float64)
    else:
        coord = signed.astype(np.float64)
    return np.pi * coord / float(domain_size)


def golden_propagate(
    h0: np.ndarray,
    omega: np.ndarray,
    t: float,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spectrum time evolution. Returns (h_spec, dx_spec, dz_spec), complex128."""
    n = h0.shape[0]
    h0 = np.asarray(h0, dtype=np.complex128)
    omega = np.asarray(omega, dtype=np.float64)

    phase = omega * float(t)
    e_pos = np.cos(phase) + 1j * np.sin(phase)
    e_neg = np.conj(e_pos)

    h0_neg = h0[::-1, ::-1]
    if compat.conj_neg:
        h0_neg = np.conj(h0_neg)
    h = h0 * e_pos + h0_neg * e_neg

    kx = wavenumber_1d(n, domain_size, compat.wrap_k)[None, :]
    ky = wavenumber_1d(n, domain_size, compat.wrap_k)[:, None]
    k_len = np.sqrt(kx * kx + ky * ky)
    safe = k_len > 1.0e-10
    with np.errstate(invalid="ignore", divide="ignore"):
        kxn = np.where(safe, kx / k_len, 0.0)
        kyn = np.where(safe, ky / k_len, 0.0)

    dx = -1j * kxn * h
    dz = -1j * kyn * h
    return h, dx, dz


def ifft2_unnorm_np(spec: np.ndarray) -> np.ndarray:
    """Unnormalized 2-D inverse DFT: N*N * ifft2 (Q3)."""
    n0, n1 = spec.shape[-2:]
    return np.fft.ifft2(spec) * (n0 * n1)


def correction_sign(n: int, ref_sign: bool) -> np.ndarray:
    """(y, x) sign grid of ``shader/correction.comp:29``."""
    x = np.arange(n)[None, :]
    y = np.arange(n)[:, None]
    even = (x + y) % 2 == 0
    if ref_sign:
        return np.where(even, -1.0, 1.0)
    return np.where(even, 1.0, -1.0)


def golden_fields(
    h0: np.ndarray,
    omega: np.ndarray,
    t: float,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
) -> np.ndarray:
    """Propagate -> iFFT2 -> correction: (N, N, 3) float64 (disp_x, height, disp_z)."""
    n = h0.shape[0]
    h, dx, dz = golden_propagate(h0, omega, t, domain_size, compat)
    sign = correction_sign(n, compat.ref_sign)
    fx = np.real(ifft2_unnorm_np(dx)) * sign
    fy = np.real(ifft2_unnorm_np(h)) * sign
    fz = np.real(ifft2_unnorm_np(dz)) * sign
    return np.stack([fx, fy, fz], axis=-1)


def golden_fields_rows(
    h0_pair: torch.Tensor,
    omega: torch.Tensor,
    t: float,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
    row_base: int = 0,
    rows: Optional[int] = None,
    col_chunk: int = 2048,
) -> torch.Tensor:
    """``golden_fields`` on the rows row_base .. row_base + rows - 1 alone:
    (rows, N, 3) float64 (disp_x, height, disp_z) on the device of
    ``h0_pair`` (2, N, N) and ``omega`` (N, N).

    ``golden_propagate`` in float64 torch, ``col_chunk`` columns at a time;
    the unnormalized inverse DFT along y is evaluated at the band's rows
    only, a (rows, N) x (N, chunk) complex product with e^{+2 pi i y m / N}
    (phases reduced mod N in integers), then along x by ``torch.fft.ifft``
    times N; then the correction sign and the real part."""
    n = omega.shape[-1]
    dev = omega.device
    rows = n - row_base if rows is None else rows
    ys = torch.arange(row_base, row_base + rows, dtype=torch.int64, device=dev)
    ms = torch.arange(n, dtype=torch.int64, device=dev)
    ang = ((ys[:, None] * ms[None, :]) % n).to(torch.float64) * (2.0 * np.pi / n)
    e_y = torch.polar(torch.ones_like(ang), ang)
    k = torch.from_numpy(wavenumber_1d(n, domain_size, compat.wrap_k)).to(dev)
    ky = k[:, None]
    spec_rows = torch.empty((3, rows, n), dtype=torch.complex128, device=dev)
    for c0 in range(0, n, col_chunk):
        c1 = min(n, c0 + col_chunk)
        h0 = torch.complex(h0_pair[0, :, c0:c1].double(), h0_pair[1, :, c0:c1].double())
        # h0[::-1, ::-1] at columns c0 .. c1 - 1: rows N-1-y, columns N-1-x
        flip = h0_pair[:, :, n - c1:n - c0].flip(-2, -1).double()
        h0_neg = torch.complex(flip[0], flip[1])
        if compat.conj_neg:
            h0_neg = h0_neg.conj()
        phase = omega[:, c0:c1].double() * float(t)
        e_pos = torch.polar(torch.ones_like(phase), phase)
        h = h0 * e_pos + h0_neg * e_pos.conj()
        kx = k[None, c0:c1]
        k_len = torch.sqrt(kx * kx + ky * ky)
        safe = k_len > 1.0e-10
        kxn = torch.where(safe, kx / k_len, torch.zeros_like(k_len))
        kyn = torch.where(safe, ky / k_len, torch.zeros_like(k_len))
        spec_rows[0, :, c0:c1] = e_y @ (-1j * kxn * h)
        spec_rows[1, :, c0:c1] = e_y @ h
        spec_rows[2, :, c0:c1] = e_y @ (-1j * kyn * h)
    fields = (torch.fft.ifft(spec_rows, dim=-1) * n).real
    x = torch.arange(n, device=dev)[None, :]
    even = (x + ys[:, None]) % 2 == 0
    sign = torch.where(even, -1.0, 1.0) if compat.ref_sign else torch.where(even, 1.0, -1.0)
    return torch.movedim(fields * sign.to(torch.float64), 0, -1)


def golden_normals(height: np.ndarray, height_scale: float = 180.0) -> np.ndarray:
    """Finite-difference normals of ``shader/ocean.frag:50-67`` (periodic)."""
    n0, n1 = height.shape
    diff_x = 2.0 / n1
    diff_y = 2.0 / n0
    x0 = np.roll(height, 1, axis=1)
    x1 = np.roll(height, -1, axis=1)
    z0 = np.roll(height, 1, axis=0)
    z1 = np.roll(height, -1, axis=0)

    def _norm(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    na = _norm(np.stack([np.full_like(height, -diff_x), (x1 - x0) / height_scale,
                         np.zeros_like(height)], axis=-1))
    nb = _norm(np.stack([np.zeros_like(height), (z1 - z0) / height_scale,
                         np.full_like(height, diff_y)], axis=-1))
    return _norm(np.cross(na, nb))


def golden_step(h0: np.ndarray, omega: np.ndarray, t: float, config: OceanConfig) -> dict:
    """Golden equivalent of ``step()``'s outputs: displacement, height, and
    normals / foam as ``config`` asks."""
    disp = golden_fields(h0, omega, t, config.domain_size, config.compat)
    out = {
        "displacement": disp,
        "height": disp[..., 1],
    }
    if config.compute_normals:
        out["normals"] = golden_normals(disp[..., 1], config.normal_height_scale)
    if config.compute_foam:
        out["foam"] = golden_foam(disp, config)
    return out


def golden_foam(disp: np.ndarray, config: OceanConfig) -> np.ndarray:
    """Jacobian-determinant whitecap mask (BASELINE config 4):
    J = (1 + lam ddx/dx)(1 + lam ddz/dz) - (lam ddx/dz)(lam ddz/dx), foam
    where J < threshold; central differences with wrap, grid spacing
    domain_size / N."""
    n = disp.shape[0]
    dx_spacing = config.domain_size / n
    lam = config.foam_lambda

    def ddx(f):  # d/dx: texture x = axis 1
        return (np.roll(f, -1, axis=1) - np.roll(f, 1, axis=1)) / (2 * dx_spacing)

    def ddz(f):  # d/dz: texture y = axis 0
        return (np.roll(f, -1, axis=0) - np.roll(f, 1, axis=0)) / (2 * dx_spacing)

    fx, fz = disp[..., 0], disp[..., 2]
    jxx = 1.0 + lam * ddx(fx)
    jzz = 1.0 + lam * ddz(fz)
    jxz = lam * ddz(fx)
    jzx = lam * ddx(fz)
    jac = jxx * jzz - jxz * jzx
    return (jac < config.foam_threshold).astype(np.float64)
