"""The ocean step in float64 plain PyTorch: the reference of the rollout
checksums and of the fields a reference frame is drawn from.

An independent statement of the reference pipeline (gfx-rs/gfx-ocean's
``propagate.comp``, ``fft_row.comp`` / ``fft_col.comp``,
``correction.comp`` and the finite-difference normals of
``ocean.frag:50-67``), arrays indexed [y, x]:

1. ``h = h0[y, x] e^{iwt} + h0[N-1-y, N-1-x] e^{-iwt}`` (conjugated on the
   flipped sample only with ``conj_neg``), ``k = pi (2i - N - 1) / L`` per
   axis (wrapped as a uint32 with ``wrap_k``), ``d_{x,z} = -i k_hat h``;
2. the unnormalized 2-D inverse DFT, ``N^2 ifft2``, in complex128;
3. the correction: the real part times -1 where x + y is even
   (``ref_sign``), packed as (disp_x, height, disp_z);
4. normals from central differences of the height, height scale 180.

Everything runs in float64 on the device of the given state (cuFFT's
double transforms on the card), so one frame at 4096^2 takes some tens of
milliseconds. Nothing here reads the program's tables or hoisted inputs:
it starts from the state (h0, omega) the benchmark made and a frame time.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def wavenumbers(n: int, domain_size: float, wrap_k: bool, device) -> torch.Tensor:
    """pi (2i - N - 1) / L for i in [0, N), float64; with ``wrap_k`` the
    integer 2i - N - 1 is taken mod 2^32 and rounded to float32 first, as
    the reference's uint32 arithmetic does."""
    signed = 2 * np.arange(n, dtype=np.int64) - n - 1
    if wrap_k:
        coord = (signed % (1 << 32)).astype(np.uint64).astype(np.float32).astype(np.float64)
    else:
        coord = signed.astype(np.float64)
    return torch.from_numpy(math.pi * coord / float(domain_size)).to(device)


def fields(h0_pair: torch.Tensor, omega: torch.Tensor, t: float, domain_size: float,
           compat: dict) -> torch.Tensor:
    """(N, N, 3) float64 (disp_x, height, disp_z) at time ``t`` of the state
    h0 (2, N, N) (re, im) and omega (N, N)."""
    n = omega.shape[-1]
    dev = omega.device
    h0 = torch.complex(h0_pair[0].double(), h0_pair[1].double())
    h0_neg = h0.flip(-2, -1)
    if compat.get("conj_neg", False):
        h0_neg = h0_neg.conj()
    phase = omega.double() * float(t)
    e_pos = torch.polar(torch.ones_like(phase), phase)
    h = h0 * e_pos + h0_neg * e_pos.conj()
    k = wavenumbers(n, domain_size, compat.get("wrap_k", False), dev)
    kx, ky = k[None, :], k[:, None]
    k_len = torch.sqrt(kx * kx + ky * ky)
    safe = k_len > 1.0e-10
    k_safe = torch.where(safe, k_len, torch.ones_like(k_len))
    zero = torch.zeros_like(k_len)
    kxn = torch.where(safe, kx / k_safe, zero)
    kyn = torch.where(safe, ky / k_safe, zero)
    specs = torch.stack([-1j * kxn * h, h, -1j * kyn * h])
    out = torch.fft.ifft2(specs).real * float(n * n)
    x = torch.arange(n, device=dev)
    even = (x[None, :] + x[:, None]) % 2 == 0
    plus, minus = (-1.0, 1.0) if compat.get("ref_sign", True) else (1.0, -1.0)
    sign = torch.where(even, torch.full_like(k_len, plus), torch.full_like(k_len, minus))
    return torch.movedim(out * sign, 0, -1)


def normals(height: torch.Tensor, height_scale: float) -> torch.Tensor:
    """(N, N, 3) float64 normals of ``ocean.frag:50-67`` (periodic taps):
    normalize(cross(normalize(-dx, (x1 - x0) / s, 0),
    normalize(0, (z1 - z0) / s, dz))) with dx = 2 / N."""
    n0, n1 = height.shape
    gx = (torch.roll(height, -1, 1) - torch.roll(height, 1, 1)) / height_scale
    gz = (torch.roll(height, -1, 0) - torch.roll(height, 1, 0)) / height_scale

    def unit(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    zero = torch.zeros_like(height)
    na = unit(torch.stack([torch.full_like(height, -2.0 / n1), gx, zero], dim=-1))
    nb = unit(torch.stack([zero, gz, torch.full_like(height, 2.0 / n0)], dim=-1))
    return unit(torch.linalg.cross(na, nb, dim=-1))


def checksum_terms(h0_pair: torch.Tensor, omega: torch.Tensor, t: float, config: dict):
    """The checksum of one frame as the step defines it, the sum of the
    displacement planes plus the sum of the normals when the config
    computes them, in float64; and the root sum of squares of those
    summands, the scale its gap is measured against. Returns
    (checksum, scale) as Python floats."""
    if config.get("compute_foam", False) or config.get("num_cascades", 1) != 1:
        raise NotImplementedError("the reference checksum covers one cascade without foam")
    disp = fields(h0_pair, omega, t, config["domain_size"], config.get("compat", {}))
    parts = [disp]
    if config.get("compute_normals", True):
        parts.append(normals(disp[..., 1], config.get("normal_height_scale", 180.0)))
    total = sum(float(p.sum()) for p in parts)
    scale = math.sqrt(sum(float((p * p).sum()) for p in parts))
    return total, scale
