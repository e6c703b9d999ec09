"""The Phillips spectrum (Tessendorf, "Simulating Ocean Water", 2001), the
parameters being the configuration's ``spectrum`` group:

    P(k)  = A exp(-1 / (k L_w)^2) / k^4 |k_hat . w_hat|^p exp(-k^2 l^2)
    h0(k) = (xi_r + i xi_i) sqrt(P(k) / 2),   xi ~ N(0, 1)
    w(k)  = sqrt(g |k| tanh(|k| h))

on the centered wavenumber grid k = pi (2i - N - 1) / L. The envelope is
computed in float64 on the device and rounded once; the normal draw comes
from a ``torch.Generator`` on the device seeded with the run's seed, in one
call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import golden


def state(n: int, domain_size: float, params: dict, seed: int, device):
    """(h0 (2, N, N), omega (N, N)) float32 on ``device``."""
    k = golden.wavenumbers(n, domain_size, False, device)
    kx, ky = k[None, :], k[:, None]
    k_len = torch.sqrt(kx * kx + ky * ky)
    safe = k_len > 1.0e-8
    k_safe = torch.where(safe, k_len, torch.ones_like(k_len))
    wind = np.asarray(params["wind_direction"], dtype=np.float64)
    wind = wind / np.linalg.norm(wind)
    dot = (kx * float(wind[0]) + ky * float(wind[1])) / k_safe
    directional = dot.abs() ** params["directional_power"]
    if params["opposing_suppression"] != 1.0:
        directional = directional * torch.where(
            dot < 0.0, torch.full_like(dot, params["opposing_suppression"]),
            torch.ones_like(dot))
    gravity = params["gravity"]
    l_w = params["wind_speed"] ** 2 / gravity
    small = params["small_wave_cutoff"] * domain_size / n
    p = (params["amplitude"] * torch.exp(-1.0 / (k_safe * l_w) ** 2) / k_safe ** 4
         * directional * torch.exp(-(k_safe ** 2) * small ** 2))
    p = torch.where(safe, p, torch.zeros_like(p))
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    noise = torch.randn((2, n, n), generator=gen, dtype=torch.float32, device=device)
    h0 = noise * torch.sqrt(p / 2.0).to(torch.float32)
    depth = params.get("depth", math.inf)
    tanh = 1.0 if math.isinf(depth) else torch.tanh(k_len * depth)
    omega = torch.sqrt(gravity * k_len * tanh).to(torch.float32)
    return h0, omega
