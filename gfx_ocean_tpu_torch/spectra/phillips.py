"""Runtime Phillips / JONSWAP spectrum synthesis of initial conditions.

Counterpart of ``gfx_ocean_tpu/spectra/phillips.py``. The spectrum
envelopes and the dispersion are the same float64 numpy code. Only the
Gaussian draw differs: ``synthesize`` takes an explicit ``torch.Generator``
(or given noise planes) instead of a ``jax.random`` key, so the two
packages give different states from the same seed. Tests hand both the
same numpy noise.

    P(k)  = A exp(-1 / (k L_w)^2) / k^4 |k_hat . w_hat|^p exp(-k^2 l^2)
    h0(k) = (xi_r + i xi_i) sqrt(P(k) / 2),   xi ~ N(0, 1)
    w(k)  = sqrt(g |k| tanh(|k| h))            (tanh = 1 in deep water)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gfx_ocean_tpu_torch.config import PhillipsConfig
from gfx_ocean_tpu_torch.golden.reference import wavenumber_1d


def _k_grids(n: int, domain_size: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    kx = wavenumber_1d(n, domain_size, wrap=False)[None, :]
    ky = wavenumber_1d(n, domain_size, wrap=False)[:, None]
    k_len = np.sqrt(kx * kx + ky * ky)
    return (
        np.broadcast_to(kx, (n, n)).astype(np.float64),
        np.broadcast_to(ky, (n, n)).astype(np.float64),
        k_len.astype(np.float64),
    )


def dispersion(n: int, domain_size: float, gravity: float = 9.81,
               depth: float = float("inf")) -> np.ndarray:
    """Dispersion w(k), (N, N) float32 numpy."""
    _, _, k_len = _k_grids(n, domain_size)
    if np.isinf(depth):
        tanh = 1.0
    else:
        tanh = np.tanh(k_len * depth)
    return np.sqrt(gravity * k_len * tanh).astype(np.float32)


def _directional(kxg: np.ndarray, kyg: np.ndarray, k_safe: np.ndarray,
                 cfg: PhillipsConfig) -> np.ndarray:
    """|k_hat . w_hat|^p, with waves against the wind damped by
    ``cfg.opposing_suppression``."""
    wd = np.asarray(cfg.wind_direction, dtype=np.float64)
    wd = wd / np.linalg.norm(wd)
    k_hat_dot_w = (kxg * wd[0] + kyg * wd[1]) / k_safe
    d = np.abs(k_hat_dot_w) ** cfg.directional_power
    if cfg.opposing_suppression != 1.0:
        d = d * np.where(k_hat_dot_w < 0.0, cfg.opposing_suppression, 1.0)
    return d


def phillips_spectrum(n: int, domain_size: float, cfg: PhillipsConfig) -> np.ndarray:
    """P(k) on the centered grid, float64 (N, N); zero at |k| ~ 0."""
    kxg, kyg, k_len = _k_grids(n, domain_size)
    g = cfg.gravity
    l_w = cfg.wind_speed ** 2 / g

    safe = k_len > 1.0e-8
    k_safe = np.where(safe, k_len, 1.0)
    directional = _directional(kxg, kyg, k_safe, cfg)

    small_l = cfg.small_wave_cutoff * domain_size / n
    p = (
        cfg.amplitude
        * np.exp(-1.0 / (k_safe * l_w) ** 2)
        / k_safe ** 4
        * directional
        * np.exp(-(k_safe ** 2) * small_l ** 2)
    )
    return np.where(safe, p, 0.0)


def jonswap_spectrum(n: int, domain_size: float, cfg: PhillipsConfig) -> np.ndarray:
    """JONSWAP (TMA at finite depth) wave-vector spectrum, float64 (N, N),
    peak-normalized to the Phillips spectrum of the same wind (see the
    JAX original for the derivation and sources)."""
    kxg, kyg, k_len = _k_grids(n, domain_size)
    g = cfg.gravity
    u, fetch, gamma = cfg.wind_speed, cfg.fetch, cfg.peak_enhancement
    h = cfg.depth

    safe = k_len > 1.0e-8
    k_safe = np.where(safe, k_len, 1.0)
    if np.isinf(h):
        w = np.sqrt(g * k_safe)
        dw_dk = g / (2.0 * w)
        phi = 1.0
    else:
        kh = k_safe * h
        tanh = np.tanh(kh)
        w = np.sqrt(g * k_safe * tanh)
        dw_dk = g * (tanh + kh * (1.0 - tanh * tanh)) / (2.0 * w)
        w_h = w * np.sqrt(h / g)
        phi = np.where(
            w_h <= 1.0, 0.5 * w_h ** 2,
            np.where(w_h < 2.0, 1.0 - 0.5 * (2.0 - w_h) ** 2, 1.0))
    wp = 22.0 * (g * g / (u * fetch)) ** (1.0 / 3.0)
    alpha = 0.076 * (u * u / (fetch * g)) ** 0.22
    sigma = np.where(w <= wp, 0.07, 0.09)
    r = np.exp(-((w - wp) ** 2) / (2.0 * sigma ** 2 * wp ** 2))
    s_w = (alpha * g * g / w ** 5
           * np.exp(-1.25 * (wp / w) ** 4)
           * gamma ** r
           * phi)

    directional = _directional(kxg, kyg, k_safe, cfg)
    small_l = cfg.small_wave_cutoff * domain_size / n
    p = np.where(
        safe,
        s_w * directional * dw_dk / k_safe
        * np.exp(-(k_safe ** 2) * small_l ** 2),
        0.0,
    )
    peak = p.max()
    if peak > 0.0:
        p = p * (phillips_spectrum(n, domain_size, cfg).max() / peak)
    return p


def spectrum(n: int, domain_size: float, cfg: PhillipsConfig) -> np.ndarray:
    """The configured model's P(k): ``cfg.model`` picks phillips/jonswap."""
    if cfg.model == "jonswap":
        return jonswap_spectrum(n, domain_size, cfg)
    return phillips_spectrum(n, domain_size, cfg)


def synthesize(
    n: int,
    domain_size: float,
    cfg: PhillipsConfig,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw h0(k) ~ CN(0, P(k)) and compute w(k), as CPU float32 tensors.

    Returns ``(h0_pair, omega)``: h0 as (2, N, N) (re, im) planes and
    omega as (N, N). ``noise``, when given, is the (2, N, N) standard
    normal draw (xi_r, xi_i); otherwise it is drawn from ``generator``
    (a CPU ``torch.Generator``; a fresh one seeded with ``cfg.seed`` when
    None). The envelope is built in float64 and rounded once.
    """
    p = torch.from_numpy(
        np.sqrt(spectrum(n, domain_size, cfg) / 2.0).astype(np.float32))
    if noise is None:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        noise = torch.randn((2, n, n), generator=generator, dtype=torch.float32)
    noise = torch.as_tensor(noise, dtype=torch.float32)
    if noise.shape != (2, n, n):
        raise ValueError(f"noise must have shape (2, {n}, {n}), got {tuple(noise.shape)}")
    h0 = noise * p
    omega = torch.from_numpy(dispersion(n, domain_size, cfg.gravity, cfg.depth))
    return h0, omega
