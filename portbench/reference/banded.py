"""The rollout checksum of :mod:`portbench.reference.golden` computed in
bands, so that a 16384^2 frame fits beside a card's other tenants: plain
PyTorch in float64 on the device of the given state, importing nothing of
the port.

The arithmetic and conventions are ``golden.py``'s (its wavenumbers, the
``compat`` signs, ``ref_sign``'s correction, the normals of
``ocean.frag:50-67`` with periodic taps); only the order of the work
differs:

1. one spectrum at a time (disp_x, height, disp_z): each row band of the
   spectrum formed from the state's rows and their flipped partners, and
   transformed along its rows into one complex128 N^2 buffer;
2. then each column band of the buffer transformed along its columns, its
   real part scaled by N^2 and signed, and summed; the height plane is kept
   (float64 N^2) for the normals;
3. the normals on row bands of the height, each with one periodic halo row
   on either side.

At most one complex128 and one float64 N^2 plane live at once, with the
state and one band's temporaries: ~12 GB at 16384^2 in 1024-row bands,
against ``golden.fields``' several complex128 N^2 arrays at once (~40-60
GB).

Departures from ``golden.checksum_terms``, none of which changes a value
beyond float64 rounding:

- the 2-D inverse transform is two 1-D inverse transforms (rows, then
  columns), each scaled by 1/N, where ``golden`` calls ``ifft2`` once;
- the sums and sums of squares are taken a band at a time and added up in
  Python floats (``golden`` sums each whole field), in the order: the three
  displacement planes by column band, then the normals by row band;
- a normal's vertical difference reads the band's halo rows where
  ``golden`` rolls the whole height plane.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from portbench.reference import golden

# Rows (or columns) a band holds by default: a 16384-wide complex128 band
# of 1024 rows is 268 MB.
BAND = 1024


def _spectrum_rows(h0_pair: torch.Tensor, omega: torch.Tensor, t: float, which: int,
                   k: torch.Tensor, r0: int, r1: int, compat: dict) -> torch.Tensor:
    """Rows r0 .. r1 - 1 of ``golden.fields``' spectrum ``which`` (0: disp_x,
    1: height, 2: disp_z), complex128 (r1 - r0, N)."""
    n = omega.shape[-1]
    h0 = torch.complex(h0_pair[0, r0:r1].double(), h0_pair[1, r0:r1].double())
    # row y's partner under the flip is N - 1 - y: rows N - r1 .. N - 1 - r0, reversed
    flipped = h0_pair[:, n - r1:n - r0].flip(-2, -1)
    h0_neg = torch.complex(flipped[0].double(), flipped[1].double())
    if compat.get("conj_neg", False):
        h0_neg = h0_neg.conj()
    phase = omega[r0:r1].double() * float(t)
    e_pos = torch.polar(torch.ones_like(phase), phase)
    h = h0 * e_pos + h0_neg * e_pos.conj()
    if which == 1:
        return h
    kx, ky = k[None, :], k[r0:r1, None]
    k_len = torch.sqrt(kx * kx + ky * ky)
    safe = k_len > 1.0e-10
    k_safe = torch.where(safe, k_len, torch.ones_like(k_len))
    along = kx if which == 0 else ky
    k_hat = torch.where(safe, along / k_safe, torch.zeros_like(k_len))
    return -1j * k_hat * h


def _sign(n: int, c0: int, c1: int, ref_sign: bool, device) -> torch.Tensor:
    """``golden.fields``' correction sign on the N rows of columns
    c0 .. c1 - 1: -1 (``ref_sign``; else +1) where x + y is even."""
    y = torch.arange(n, device=device)
    x = torch.arange(c0, c1, device=device)
    even = (x[None, :] + y[:, None]) % 2 == 0
    plus, minus = (-1.0, 1.0) if ref_sign else (1.0, -1.0)
    return torch.where(even, torch.tensor(plus, dtype=torch.float64, device=device),
                       torch.tensor(minus, dtype=torch.float64, device=device))


def _normals_rows(height: torch.Tensor, r0: int, r1: int, height_scale: float) -> torch.Tensor:
    """``golden.normals`` on rows r0 .. r1 - 1 of the (N, N) height, from
    the band and one periodic halo row on each side: (r1 - r0, N, 3)."""
    n0, n1 = height.shape
    rows = torch.arange(r0 - 1, r1 + 1, device=height.device) % n0
    ext = height[rows]
    mid = ext[1:-1]
    gx = (torch.roll(mid, -1, 1) - torch.roll(mid, 1, 1)) / height_scale
    gz = (ext[2:] - ext[:-2]) / height_scale

    def unit(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    zero = torch.zeros_like(mid)
    na = unit(torch.stack([torch.full_like(mid, -2.0 / n1), gx, zero], dim=-1))
    nb = unit(torch.stack([zero, gz, torch.full_like(mid, 2.0 / n0)], dim=-1))
    return unit(torch.linalg.cross(na, nb, dim=-1))


def _bands(n: int, band: int):
    return [(a, min(a + band, n)) for a in range(0, n, band)]


def checksum_terms(h0_pair: torch.Tensor, omega: torch.Tensor, t: float, config: dict,
                   rows: Optional[int] = None, cols: Optional[int] = None):
    """``golden.checksum_terms`` in bands: the frame's checksum, the sum of
    the displacement planes plus the sum of the normals when the config
    computes them, and the root sum of squares of those summands, as
    Python floats. ``rows`` / ``cols``: the bands' rows and columns
    (``BAND`` by default, at most N)."""
    if config.get("compute_foam", False) or config.get("num_cascades", 1) != 1:
        raise NotImplementedError("the reference checksum covers one cascade without foam")
    n = omega.shape[-1]
    dev = omega.device
    compat = config.get("compat", {})
    rows, cols = min(rows or BAND, n), min(cols or BAND, n)
    k = golden.wavenumbers(n, config["domain_size"], compat.get("wrap_k", False), dev)
    ref_sign = compat.get("ref_sign", True)
    normals = config.get("compute_normals", True)
    buf = torch.empty((n, n), dtype=torch.complex128, device=dev)
    height = torch.empty((n, n), dtype=torch.float64, device=dev) if normals else None
    total = squares = 0.0
    for which in range(3):
        for r0, r1 in _bands(n, rows):
            buf[r0:r1] = torch.fft.ifft(
                _spectrum_rows(h0_pair, omega, t, which, k, r0, r1, compat), dim=-1)
        for c0, c1 in _bands(n, cols):
            plane = (torch.fft.ifft(buf[:, c0:c1], dim=0).real * float(n * n)
                     * _sign(n, c0, c1, ref_sign, dev))
            total += float(plane.sum())
            squares += float((plane * plane).sum())
            if which == 1 and normals:
                height[:, c0:c1] = plane
    del buf
    if normals:
        scale = config.get("normal_height_scale", 180.0)
        for r0, r1 in _bands(n, rows):
            nrm = _normals_rows(height, r0, r1, scale)
            total += float(nrm.sum())
            squares += float((nrm * nrm).sum())
    return total, math.sqrt(squares)
