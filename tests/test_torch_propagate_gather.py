"""The state gather of K1 and K2 (``ops/propagate.gather_packed_planes``),
the reads the kernels make per element instead of hoisting 10 planes.

Per element (y, x), mod n: h0 at (y, x), at its flip (n-1-y, n-1-x), at
rho = (-y, -x) and at rho's flip (y-1, x-1); omega at (y, x) and at rho;
each P one float add or subtract. Built with index arithmetic, it must be
bit-equal to the hoisted planes of ``precompute_propagate_packed`` (flip /
roll), and the packed spectra computed from it bit-equal to those computed
from the hoisted planes, on the full grid and on bands at a row base
(rows 0, n/2 and n-1 among them). Both plain versions (K1's and K2's) use
it as their propagate, so the plain-vs-JAX tests cover it too. The kernels
compute each rho pair (e, rho e) from e's reads once; the last test holds
that derivation bit-equal to rho(e)'s own propagate.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gfx_ocean_tpu_torch.config import CompatFlags, PhillipsConfig
from gfx_ocean_tpu_torch.ops.propagate import (_sincos_phase, as_times, gather_packed_planes,
                                               khat_pair, packed_spectra,
                                               precompute_propagate_packed)
from gfx_ocean_tpu_torch.spectra.phillips import synthesize

FLAGS = {"default": CompatFlags(), "wrap_k": CompatFlags(wrap_k=True),
         "conj_neg": CompatFlags(conj_neg=True), "canonical_sign": CompatFlags(ref_sign=False)}
TIMES = [0.0, 11.25, 1000.25]


def _state(n: int):
    noise = np.random.default_rng(n).standard_normal((2, n, n)).astype(np.float32)
    return synthesize(n, 1000.0, PhillipsConfig(), noise=torch.from_numpy(noise))


def _check(n: int, flags: CompatFlags, rows: int, row_base: int) -> None:
    h0, om = _state(n)
    pre, pre_rho, omega_rho = precompute_propagate_packed(h0, om, flags)
    band = slice(row_base, row_base + rows)
    hoisted = (pre[:, band], pre_rho[:, band], om[band], omega_rho[band])
    gathered = gather_packed_planes(h0, om, flags.conj_neg, rows, row_base)
    for g, w in zip(gathered, hoisted):
        assert g.shape == w.shape and torch.equal(g, w)
    half = -0.5 if flags.ref_sign else 0.5
    ts = as_times(TIMES, h0.device)
    got = packed_spectra(*gathered, ts, 1000.0, flags.wrap_k, half, row_base)
    want = packed_spectra(*hoisted, ts, 1000.0, flags.wrap_k, half, row_base)
    for g, w in zip(got, want):
        assert g.shape == (len(TIMES), rows, n) and torch.equal(g, w)


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
@pytest.mark.parametrize("n", [16, 64, 512])
def test_gather_equals_hoisted_planes_full_grid(n, flags):
    _check(n, FLAGS[flags], n, 0)


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
@pytest.mark.parametrize("row_base", [0, 509, 1016], ids=["row-0", "row-n/2", "row-n-1"])
def test_gather_equals_hoisted_planes_1024_band(row_base, flags):
    """8-row bands of a 1024 grid, as K2 reads a band of rows: through
    row 0, row n/2 and row n-1."""
    _check(1024, FLAGS[flags], 8, row_base)


def test_gather_uses_no_flip_or_roll(monkeypatch):
    """The gather is index arithmetic: it runs with torch.flip and
    torch.roll taken away."""
    def banned(*_, **__):
        raise AssertionError("flip / roll used")

    h0, om = _state(16)
    want = gather_packed_planes(h0, om, True)
    monkeypatch.setattr(torch, "flip", banned)
    monkeypatch.setattr(torch, "roll", banned)
    for g, w in zip(gather_packed_planes(h0, om, True), want):
        assert torch.equal(g, w)


def _rho_from_element(pre, pre_rho, om, omq, ts, flags: CompatFlags, half: float):
    """The spectra of rho(e) from e's own reads and phases, as
    ``ocean::packed_propagate_pair`` forms them: H(rho e) = conj(H(e)),
    Z(rho e) = (dx_r + dz_i) + i (dz_r - dx_i) with e's intermediates."""
    n = om.shape[-1]
    ts = ts[:, None, None]
    c, s = _sincos_phase(om, ts)
    cq, sq = _sincos_phase(omq, ts)
    sr = c * pre[0] + s * pre[1]
    si = s * pre[2] + c * pre[3]
    tr = cq * pre_rho[0] + sq * pre_rho[1]
    ti = sq * pre_rho[2] + cq * pre_rho[3]
    khx, khy, khxq, khyq = khat_pair(n, 1000.0, flags.wrap_k)
    dx_r = half * (khx * si + khxq * ti)
    dx_i = half * (khxq * tr - khx * sr)
    dz_r = half * (khy * si + khyq * ti)
    dz_i = half * (khyq * tr - khy * sr)
    return half * (sr + tr), -(half * (si - ti)), dx_r + dz_i, dz_r - dx_i


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
@pytest.mark.parametrize("n", [16, 64, 512])
def test_rho_partner_from_element_equals_its_own_propagate(n, flags):
    """K1 and K2 compute each rho pair (e, rho e) from e's reads once; the
    partner's spectra so derived equal what rho(e)'s own propagate gives,
    bit for bit (values: -0 and +0 compare equal)."""
    fl = FLAGS[flags]
    h0, om = _state(n)
    half = -0.5 if fl.ref_sign else 0.5
    ts = as_times(TIMES, h0.device)
    planes = gather_packed_planes(h0, om, fl.conj_neg)
    direct = packed_spectra(*planes, ts, 1000.0, fl.wrap_k, half)
    derived = _rho_from_element(*planes, ts, fl, half)
    rho = (-torch.arange(n)) % n
    for d, w in zip(derived, direct):
        assert torch.equal(d, w[:, rho][:, :, rho])
