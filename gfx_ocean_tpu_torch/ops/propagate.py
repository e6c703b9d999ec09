"""Spectrum time evolution (``shader/propagate.comp``) in PyTorch.

Counterpart of ``gfx_ocean_tpu/ops/propagate.py``, op for op. Arrays are
indexed [y, x]:

    h(k,t) = h0[y, x] e^{iwt} + h0[N-1-y, N-1-x] e^{-iwt}
             (conjugate on the flipped sample only if ``compat.conj_neg``)
    k      = pi (2i - N - 1) / L per axis (uint32 wrap iff ``compat.wrap_k``)
    disp_x = -i k_hat_x h ;  disp_z = -i k_hat_y h

``t`` may be a Python float, a 0-d tensor, or a tensor that broadcasts
against the (N, N) planes, e.g. (tb, 1, 1) for a batch of frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gfx_ocean_tpu_torch.config import CompatFlags
from gfx_ocean_tpu_torch.golden.reference import wavenumber_1d
from gfx_ocean_tpu_torch.utils import profiling
from gfx_ocean_tpu_torch.utils.device import resolve_device


def _f32(x: float) -> float:
    """A Python float that is exactly a float32 value, so that torch gives
    the same result whether it applies the scalar in float32 or wider."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _khat_np(n: int, domain_size: float, wrap: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized wavenumber grids (f64 on host, stored f32)."""
    kx = wavenumber_1d(n, domain_size, wrap)[None, :]
    ky = wavenumber_1d(n, domain_size, wrap)[:, None]
    k_len = np.sqrt(kx * kx + ky * ky)
    safe = k_len > 1.0e-10
    with np.errstate(invalid="ignore", divide="ignore"):
        kxn = np.where(safe, kx / k_len, 0.0)
        kyn = np.where(safe, ky / k_len, 0.0)
    return (
        np.broadcast_to(kxn, (n, n)).astype(np.float32),
        np.broadcast_to(kyn, (n, n)).astype(np.float32),
    )


def wavenumber_grid(n: int, domain_size: float, wrap: bool = False,
                    device: torch.device | str | None = None):
    """(k_hat_x, k_hat_y) as (N, N) float32 tensors on ``device`` (the card
    when None; raises when there is none)."""
    return tuple(k.clone() for k in _khat_grid(n, domain_size, wrap, resolve_device(device)))


def _khat_grid(n: int, domain_size: float, wrap: bool, device: torch.device | str):
    """:func:`wavenumber_grid` on ``device``, made once per (n, domain_size,
    wrap, device): the eager propagate's tables are not uploaded at every
    call. Read only: every caller shares the two tensors."""
    return _khat_grid_cached(n, float(domain_size), bool(wrap), torch.device(device))


@profiling.counted_cache(maxsize=None)
def _khat_grid_cached(n: int, domain_size: float, wrap: bool, device: torch.device):
    kxn, kyn = _khat_np(n, domain_size, wrap)
    return torch.from_numpy(kxn).to(device), torch.from_numpy(kyn).to(device)


def _as_time(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


def as_times(ts, device: torch.device) -> torch.Tensor:
    """Frame times (a float, a sequence or a tensor) as a float32 (tb,) tensor."""
    return torch.as_tensor(ts, dtype=torch.float32, device=device).reshape(-1).contiguous()


def propagate(h0: torch.Tensor, omega: torch.Tensor, t, domain_size: float,
              compat: CompatFlags = CompatFlags()):
    """Evolve the complex initial spectrum h0 (..., N, N) to time ``t``:
    returns (h_spec, dx_spec, dz_spec), each complex64 (..., N, N). The
    phase is the plain float32 product omega t, as in the JAX function (the
    step's routes use the Dekker phase of :func:`_phase_mod_2pi`)."""
    n = h0.shape[-1]
    phase = omega * _as_time(t, omega)
    e_pos = torch.complex(torch.cos(phase), torch.sin(phase))
    h0_neg = torch.flip(h0, dims=(-2, -1))
    if compat.conj_neg:
        h0_neg = torch.conj(h0_neg)
    h = h0 * e_pos + h0_neg * torch.conj(e_pos)
    kxn, kyn = _khat_grid(n, domain_size, compat.wrap_k, h0.device)
    return h, -1j * kxn * h, -1j * kyn * h


def precompute_propagate(h0_pair: torch.Tensor,
                         compat: CompatFlags = CompatFlags()) -> torch.Tensor:
    """Time-invariant planes (P1, P2, P3, P4), stacked as (4, ..., N, N):
    hr = c P1 + s P2, hi = s P3 + c P4."""
    h0r = h0_pair[..., 0, :, :]
    h0i = h0_pair[..., 1, :, :]
    h0nr = torch.flip(h0r, dims=(-2, -1))
    h0ni = torch.flip(h0i, dims=(-2, -1))
    if compat.conj_neg:
        h0ni = -h0ni
    return torch.stack([h0r + h0nr, h0ni - h0i, h0r - h0nr, h0i + h0ni], dim=0)


# Cody-Waite constants: 2*pi = C1 + C2 + C3 with C1/C2 carrying <= 12
# mantissa bits, so k * C1 and k * C2 are exact for k < 2^12.
_C1 = _f32(6.28125)
_C2 = _f32(0.0019350051879882812)
_C3 = _f32(3.019916050561733e-07)
_INV_2PI = _f32(1.0 / (2.0 * np.pi))


def _split_f32_12bit(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dekker split a = hi + lo, hi carrying the top 12 mantissa bits.
    Eager PyTorch runs each op as its own kernel, so nothing fuses
    ``c - (c - a)`` into an FMA."""
    c = a * 4097.0  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _phase_mod_2pi(omega: torch.Tensor, t) -> torch.Tensor:
    """omega * t reduced mod 2*pi with Dekker two-product accuracy in f32.

    A plain f32 product loses ~|omega t| 2^-24 rad (~3e-4 rad at t ~ 1000 s).
    """
    t = _as_time(t, omega)
    p = omega * t
    o_hi, o_lo = _split_f32_12bit(omega)
    t_hi, t_lo = _split_f32_12bit(t)
    err = (((o_hi * t_hi - p) + o_hi * t_lo) + o_lo * t_hi) + o_lo * t_lo
    k = torch.round(p * _INV_2PI)  # half to even, as jnp.round
    return (((p - k * _C1) - k * _C2) - k * _C3) + err


# pi/2 = P1 + P2 + P3; q * P1 is exact for the quadrant index q in {-2..2}.
_P1 = _f32(1.5703125)
_P2 = _f32(4.8375129699707031e-4)
_P3 = _f32(7.5497899487686475e-8)
_TWO_OVER_PI = _f32(2.0 / np.pi)
# Cephes f32 minimax coefficients on [-pi/4, pi/4].
_SS1 = _f32(-1.6666654611e-1)
_SS2 = _f32(8.3321608736e-3)
_SS3 = _f32(-1.9515295891e-4)
_CC1 = _f32(4.166664568298827e-2)
_CC2 = _f32(-1.388731625493765e-3)
_CC3 = _f32(2.443315711809948e-5)


def _sincos_phase(omega: torch.Tensor, t) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of omega*t: Dekker phase, one exact pi/2 quadrant step,
    and a degree-7/8 minimax pair on [-pi/4, pi/4] (~1e-7 abs)."""
    x = _phase_mod_2pi(omega, t)
    q = torch.round(x * _TWO_OVER_PI)
    r = ((x - q * _P1) - q * _P2) - q * _P3
    r2 = r * r
    sin_r = r + r * r2 * (_SS1 + r2 * (_SS2 + r2 * _SS3))
    cos_r = 1.0 - 0.5 * r2 + r2 * r2 * (_CC1 + r2 * (_CC2 + r2 * _CC3))
    iq = q.to(torch.int32) & 3  # two's complement: -1 & 3 == 3
    swap = (iq & 1) == 1
    s_base = torch.where(swap, cos_r, sin_r)
    c_base = torch.where(swap, sin_r, cos_r)
    s_neg = iq >= 2
    c_neg = (iq == 1) | (iq == 2)
    return torch.where(c_neg, -c_base, c_base), torch.where(s_neg, -s_base, s_base)


def propagate_from_cs(pre: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
                      domain_size: float, compat: CompatFlags = CompatFlags(),
                      row_base: int = 0):
    """Unpacked propagate from (cos, sin) of the phase: returns (specs_r,
    specs_i), each (3, ..., N, N) in the order (h, dx, dz); for a row band
    (..., rows, N) of the grid from the global row ``row_base``."""
    rows, n = pre.shape[-2:]
    hr = c * pre[0] + s * pre[1]
    hi = s * pre[2] + c * pre[3]
    kxn, kyn = (k[row_base:row_base + rows]
                for k in _khat_grid(n, domain_size, compat.wrap_k, pre.device))
    specs_r = torch.stack([hr, kxn * hi, kyn * hi], dim=0)
    specs_i = torch.stack([hi, -kxn * hr, -kyn * hr], dim=0)
    return specs_r, specs_i


def propagate_planes_pre(pre: torch.Tensor, omega: torch.Tensor, t,
                         domain_size: float, compat: CompatFlags = CompatFlags(),
                         row_base: int = 0):
    """Unpacked propagate from :func:`precompute_propagate` planes (a row
    band from the global row ``row_base``: see :func:`propagate_from_cs`)."""
    phase = _phase_mod_2pi(omega, t)
    return propagate_from_cs(pre, torch.cos(phase), torch.sin(phase),
                             domain_size, compat, row_base)


def propagate_planes(h0_pair: torch.Tensor, omega: torch.Tensor, t, domain_size: float,
                     compat: CompatFlags = CompatFlags()):
    """All-real-plane :func:`propagate` from (re, im) planes h0 (..., 2, N, N):
    returns (specs_r, specs_i), each (3, ..., N, N) in the order (h, dx, dz)."""
    return propagate_planes_pre(precompute_propagate(h0_pair, compat), omega, t,
                                domain_size, compat)


def roll_flip(x: torch.Tensor) -> torch.Tensor:
    """DFT-index negation rho: y[i, j] = x[(-i) mod N, (-j) mod N] over the
    last two axes. Not the propagate pairing flip [N-1-i]."""
    return torch.roll(torch.flip(x, dims=(-2, -1)), shifts=(1, 1), dims=(-2, -1))


def precompute_propagate_packed(h0_pair: torch.Tensor, omega: torch.Tensor,
                                compat: CompatFlags = CompatFlags()):
    """Time-invariant planes of the Hermitian-symmetrized propagate:
    ``(pre, pre_rho, omega_rho)``, gathered once per rollout."""
    pre = precompute_propagate(h0_pair, compat)
    return pre, roll_flip(pre), roll_flip(omega)


class BandWindows(NamedTuple):
    """The state rows that K2's reads of a row band [b, b + R) of a
    row-sharded grid touch (``csrc/ocean_common.cuh``,
    ``ocean::StateWindows``): output row y reads rows y and y - 1 (window
    A: rows b - 1 ... b + R - 1) and rows n - 1 - y and n - y (window B:
    rows n - b - R ... n - b), each mod n, R + 1 rows a window. In K2's
    layout: A's rows then B's, each h0 row its real then its imaginary
    part."""

    h0: torch.Tensor      # (..., 2 (R + 1), 2, N)
    omega: torch.Tensor   # (..., 2 (R + 1), N)


def window_rows(n: int, row_base: int, rows: int) -> Tuple[int, int]:
    """The first global rows (mod n) of the band's windows A and B."""
    return (row_base - 1) % n, (n - row_base - rows) % n


def band_windows(h0_pair: torch.Tensor, omega: torch.Tensor, row_base: int,
                 rows: int) -> BandWindows:
    """The band's two windows cut from the whole state, contiguous."""
    n = omega.shape[-1]
    first_a, first_b = window_rows(n, row_base, rows)
    span = torch.arange(rows + 1, device=omega.device)
    idx = torch.cat([(span + first_a) % n, (span + first_b) % n])
    return windows_of_rows(h0_pair[..., idx, :], omega[..., idx, :])


def windows_of_rows(h0_rows: torch.Tensor, omega_rows: torch.Tensor) -> BandWindows:
    """:class:`BandWindows` of h0 (..., 2, 2 (R + 1), N) and omega
    (..., 2 (R + 1), N) holding window A's rows then window B's."""
    return BandWindows(torch.movedim(h0_rows, -3, -2).contiguous(), omega_rows.contiguous())


def gather_packed_planes(h0_pair: Optional[torch.Tensor], omega: Optional[torch.Tensor],
                         conj_neg: bool, rows: Optional[int] = None, row_base: int = 0,
                         windows: Optional[BandWindows] = None):
    """:func:`precompute_propagate_packed` on ``rows`` rows (default all)
    from the global row ``row_base``, read the way K1 and K2 read the state:
    per element (y, x), mod n, h0 at (y, x), at its flip (n-1-y, n-1-x), at
    rho = (-y, -x) and at the flip of rho (y-1, x-1), omega at (y, x) and at
    rho, each P one float add or subtract of those reads. Index arithmetic,
    no flip / roll; bit-equal to the band of the full planes. With
    ``windows`` (a row band's :class:`BandWindows`; ``h0_pair`` and
    ``omega`` are then not read) the same values come from the band's two
    windows, as K2's ``fourstep_row_windows`` reads them. Returns ``(pre,
    pre_rho, omega, omega_rho)``: (4, rows, n) and (rows, n), with the
    state's leading (cascade) axes after the 4: (4, C, rows, n) and
    (C, rows, n) for a (C, 2, n, n) state."""
    if windows is None:
        n = omega.shape[-1]
        lead = tuple(omega.shape[:-2])
        h = h0_pair.reshape(lead + (2, n * n))
        flat = (h[..., 0, :], h[..., 1, :], omega.reshape(lead + (n * n,)))
        src_a = src_b = flat + (0, 0)  # the whole grid, from row 0
    else:
        n = windows.omega.shape[-1]
        rows = n if rows is None else rows
        lead = tuple(windows.omega.shape[:-2])
        span = windows.omega.shape[-2] * n
        h = windows.h0.reshape(lead + (span // n, 2, n))
        flat = (h[..., 0, :].reshape(lead + (span,)), h[..., 1, :].reshape(lead + (span,)),
                windows.omega.reshape(lead + (span,)))
        first_a, first_b = window_rows(n, row_base, rows)
        src_a, src_b = flat + (first_a, 0), flat + (first_b, rows + 1)
    rows = n if rows is None else rows
    dev = flat[2].device
    y = torch.arange(row_base, row_base + rows, device=dev)[:, None]
    x = torch.arange(n, device=dev)[None, :]
    yq, xq = (n - y) % n, (n - x) % n

    def read(src, gy, gx):
        """(h0 re, h0 im, omega) of ``src`` flattened, and the flat index
        of the global elements (gy, gx): the window row ``(gy - first) mod
        n`` from the window's ``offset``-th row."""
        re, im, om, first, offset = src
        return re, im, om, (offset + (gy - first) % n) * n + gx

    def planes(e, f):
        er, ei, _, ie = e
        fr, fi, _, i_f = f
        h0r, h0i = er[..., ie], ei[..., ie]
        h0nr, h0ni = fr[..., i_f], fi[..., i_f]
        if conj_neg:
            h0ni = -h0ni
        return torch.stack([h0r + h0nr, h0ni - h0i, h0r - h0nr, h0i + h0ni], dim=0)

    at_e = read(src_a, y, x)
    at_rho = read(src_b, yq, xq)
    pre = planes(at_e, read(src_b, n - 1 - y, n - 1 - x))
    pre_rho = planes(at_rho, read(src_a, (y - 1) % n, (x - 1) % n))
    return pre, pre_rho, at_e[2][..., at_e[3]], at_rho[2][..., at_rho[3]]


def propagate_packed_planes(
    pre: torch.Tensor,
    pre_rho: torch.Tensor,
    omega: torch.Tensor,
    omega_rho: torch.Tensor,
    t,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
    row_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hermitian-symmetrized evolved spectra, packed for 2-for-1 transforms.

    With H = (S + conj(S o rho)) / 2, F(H) = Re(F(S)) exactly, and the two
    choppy spectra share one transform: Z = H_dx + i H_dz. Returns
    ``(h_r, h_i, z_r, z_i)``. Uses ``torch.cos``/``torch.sin`` of the
    Dekker phase and the host k-hat grids, as the JAX function does. For a
    row band (..., rows, N) of the grid from the global row ``row_base``
    (``pre_rho`` and ``omega_rho`` that band of the whole grid's) it reads
    the band's rows of the k-hat grids.
    """
    rows, n = pre.shape[-2:]
    phase = _phase_mod_2pi(omega, t)
    c, s = torch.cos(phase), torch.sin(phase)
    phase_rho = _phase_mod_2pi(omega_rho, t)
    cq, sq = torch.cos(phase_rho), torch.sin(phase_rho)

    sr = c * pre[0] + s * pre[1]
    si = s * pre[2] + c * pre[3]
    tr = cq * pre_rho[0] + sq * pre_rho[1]
    ti = sq * pre_rho[2] + cq * pre_rho[3]

    h_r = 0.5 * (sr + tr)
    h_i = 0.5 * (si - ti)

    kxn, kyn = _khat_grid(n, domain_size, compat.wrap_k, pre.device)
    band = slice(row_base, row_base + rows)
    kxq, kyq = roll_flip(kxn)[band], roll_flip(kyn)[band]
    kxn, kyn = kxn[band], kyn[band]
    dx_r = 0.5 * (kxn * si + kxq * ti)
    dx_i = 0.5 * (kxq * tr - kxn * sr)
    dz_r = 0.5 * (kyn * si + kyq * ti)
    dz_i = 0.5 * (kyq * tr - kyn * sr)
    return h_r, h_i, dx_r - dz_i, dx_i + dz_r


def khat_pair(n: int, domain_size: float, wrap: bool,
              device: torch.device | str = "cpu", rows: Optional[int] = None,
              row_base: int = 0):
    """(khx, khy, khx o rho, khy o rho) from indices, as the kernels compute
    them (``pallas_step._khat_pair_in_kernel``): f32 coordinates, the
    uint32 wrap as a float add of 2^32, and ``rsqrt`` with a q > 1e-20 guard
    (the XLA path's host grids use k_len > 1e-10 instead).

    The band form: ``rows`` rows (default n) starting at the global row
    ``row_base``, each (rows, n) in true x order."""
    rows = n if rows is None else rows
    ix = torch.arange(n, dtype=torch.float32, device=device)[None, :].expand(rows, n)
    iy = (torch.arange(rows, dtype=torch.float32, device=device)
          + float(row_base))[:, None].expand(rows, n)
    scale = _f32(np.pi / domain_size)

    def grids(ix, iy):
        cx = 2.0 * ix - float(n + 1)
        cy = 2.0 * iy - float(n + 1)
        if wrap:
            cx = torch.where(cx < 0, cx + 2.0 ** 32, cx)
            cy = torch.where(cy < 0, cy + 2.0 ** 32, cy)
        kx = cx * scale
        ky = cy * scale
        q = kx * kx + ky * ky
        safe = q > 1.0e-20
        inv = torch.where(safe, torch.rsqrt(torch.where(safe, q, 1.0)), 0.0)
        return kx * inv, ky * inv

    khx, khy = grids(ix, iy)
    ixq = torch.where(ix == 0, 0.0, float(n) - ix)
    iyq = torch.where(iy == 0, 0.0, float(n) - iy)
    khxq, khyq = grids(ixq, iyq)
    return khx, khy, khxq, khyq


def packed_spectra(pre: torch.Tensor, pre_rho: torch.Tensor, omega: torch.Tensor,
                   omega_rho: torch.Tensor, ts: torch.Tensor, domain_size: float,
                   wrap_k: bool, half: float, row_base: int = 0):
    """The packed propagate as the fused kernels compute it, for frames ts (tb,).

    The algebra of :func:`propagate_packed_planes`, with the kernels' own
    arithmetic: the polynomial sincos of the Dekker phase, the k-hat pairs
    of :func:`khat_pair` and the symmetrization's factor ``half`` (K1 folds
    the Q2 flip into it as -0.5; K2 keeps +0.5). The planes hold ``rows``
    rows of the grid from the global row ``row_base``: pre, pre_rho
    (4, rows, N), omega, omega_rho (rows, N), or with leading cascade axes
    (4, C, rows, N) and (C, rows, N). Returns (h_r, h_i, z_r, z_i), each
    (tb, rows, N) or (tb, C, rows, N)."""
    rows, n = omega.shape[-2:]
    ts = ts.reshape((-1,) + (1,) * omega.ndim)
    c, s = _sincos_phase(omega, ts)
    cq, sq = _sincos_phase(omega_rho, ts)
    sr = c * pre[0] + s * pre[1]
    si = s * pre[2] + c * pre[3]
    tr = cq * pre_rho[0] + sq * pre_rho[1]
    ti = sq * pre_rho[2] + cq * pre_rho[3]
    h_r = half * (sr + tr)
    h_i = half * (si - ti)
    khx, khy, khxq, khyq = khat_pair(n, domain_size, wrap_k, omega.device, rows, row_base)
    dx_r = half * (khx * si + khxq * ti)
    dx_i = half * (khxq * tr - khx * sr)
    dz_r = half * (khy * si + khyq * ti)
    dz_i = half * (khyq * tr - khy * sr)
    return h_r, h_i, dx_r - dz_i, dx_i + dz_r
