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
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gfx_ocean_tpu_torch.config import CompatFlags


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
