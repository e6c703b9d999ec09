"""The public ops / model API of the port against the JAX package's:
the "xla" route (torch.fft), the 1-D / 2-D DFT helpers, ``correction``,
``propagate`` / ``propagate_planes`` and ``make_uniform_rollout``.

The same numpy inputs, made from a seed, go through both packages on the
CPU. Both sides are float32 transforms summed in different orders (pocketfft
against torch's FFT on "xla", dense matmuls on "matmul"), so fields agree
to a few 1e-7 of their scale.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.golden import reference as golden
from gfx_ocean_tpu.models.ocean import make_uniform_rollout as j_uniform
from gfx_ocean_tpu.ops import derived as jder
from gfx_ocean_tpu.ops import fft as jfft
from gfx_ocean_tpu_torch.models.ocean import make_uniform_rollout as t_uniform
from gfx_ocean_tpu_torch.models.ocean import state_from_numpy
from gfx_ocean_tpu_torch.ops import derived as tder
from gfx_ocean_tpu_torch.ops import fft as tfft
from gfx_ocean_tpu_torch.utils.complexpair import to_pair

# The packages' ``ops/__init__`` export the function ``propagate`` under the
# module's name.
jprop = importlib.import_module("gfx_ocean_tpu.ops.propagate")
tprop = importlib.import_module("gfx_ocean_tpu_torch.ops.propagate")

# float32 transforms of up to 64 x 64 points (measured <= 5e-7 of the
# output's max between the packages); 2e-6 leaves a margin for the
# propagate's float32 products in front of them.
TOL = 2e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _state(n=64, seed=0):
    """A numpy (h0 pair, omega) of the shipped spectrum's scales."""
    rng = np.random.default_rng(seed)
    h0 = 0.3 * _complex((n, n), seed)
    omega = np.sqrt(9.81 * 0.1 * np.abs(rng.standard_normal((n, n)))).astype(np.float32)
    return to_pair(h0), omega


@pytest.mark.parametrize("shape", [(32, 32), (3, 16, 64)])
@pytest.mark.parametrize("impl", ["matmul", "xla"])
def test_ifft2_unnorm_equals_jax(shape, impl):
    x = _complex(shape, 1)
    got = tfft.ifft2_unnorm(torch.from_numpy(x), impl=impl).numpy()
    want = np.asarray(jfft.ifft2_unnorm(jnp.asarray(x), impl=impl))
    assert got.dtype == np.complex64
    assert _rel(got, want) < TOL
    assert _rel(got, golden.ifft2_unnorm_np(x.astype(np.complex128))) < TOL


@pytest.mark.parametrize("axis", [-1, 0, 1])
@pytest.mark.parametrize("impl", ["matmul", "xla"])
def test_ifft1d_unnorm_equals_jax(axis, impl):
    x = _complex((16, 32, 8), 2)
    got = tfft.ifft1d_unnorm(torch.from_numpy(x), axis=axis, impl=impl).numpy()
    want = np.asarray(jfft.ifft1d_unnorm(jnp.asarray(x), axis=axis, impl=impl))
    assert _rel(got, want) < TOL
    assert _rel(got, np.fft.ifft(x.astype(np.complex128), axis=axis) * x.shape[axis]) < TOL


def test_ifft1d_real_unnorm_and_four_step_equal_jax():
    """The plane-pair 1-D helper, in the direct regime and above
    ``direct_max`` (the four-step split), against the JAX one."""
    x = _complex((4, 256), 3)
    xr, xi = np.real(x).astype(np.float32), np.imag(x).astype(np.float32)
    for direct_max, axis in ((1024, -1), (64, -1), (64, 0)):
        a, b = (xr.T.copy(), xi.T.copy()) if axis == 0 else (xr, xi)
        got = tfft.ifft1d_real_unnorm(torch.from_numpy(a), torch.from_numpy(b), axis=axis,
                                      direct_max=direct_max).numpy()
        want = np.asarray(jfft.ifft1d_real_unnorm(jnp.asarray(a), jnp.asarray(b), axis=axis,
                                                  direct_max=direct_max))
        assert _rel(got, want) < TOL


@pytest.mark.parametrize("centered", [None, "ref", "canonical"])
def test_xla_route_equals_matmul_and_jax_xla(centered):
    """The plane transforms on "xla" (torch.fft, the correction sign after
    it) against the port's "matmul" (the sign folded into its tables) and
    the JAX package's "xla"."""
    x = _complex((3, 64, 64), 4)
    xr, xi = torch.from_numpy(np.real(x).copy()), torch.from_numpy(np.imag(x).copy())
    kw = dict(centered=centered)
    xla = tfft.ifft2_real_unnorm(xr, xi, impl="xla", **kw).numpy()
    mm = tfft.ifft2_real_unnorm(xr, xi, impl="matmul", **kw).numpy()
    jx = np.asarray(jfft.ifft2_real_unnorm(jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()),
                                           impl="xla", **kw))
    assert _rel(xla, mm) < TOL and _rel(xla, jx) < TOL
    pr, pi = tfft.ifft2_planes_unnorm(xr, xi, impl="xla", **kw)
    mr, mi = tfft.ifft2_planes_unnorm(xr, xi, impl="matmul", **kw)
    jr, ji = jfft.ifft2_planes_unnorm(jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()),
                                      impl="xla", **kw)
    for got, ref, jref in ((pr, mr, jr), (pi, mi, ji)):
        assert _rel(got.numpy(), ref.numpy()) < TOL
        assert _rel(got.numpy(), np.asarray(jref)) < TOL


def test_effective_precision_takes_the_jax_signature():
    assert tfft.effective_precision("bf16x3") == "bf16x3"
    assert tfft.effective_precision("high", 4096, 1024, "matmul") == "high"
    assert tfft.effective_precision("bf16x3", 4096, 1024, "matmul").startswith("high (")
    assert tfft.effective_precision("bf16x4", 4096, 1024, "matmul").startswith("highest (")
    assert tfft.effective_precision("bf16x4", 512, impl="pallas").startswith("bf16x3 (")
    assert tfft.effective_precision("bf16x4", 512, impl="pallas",
                                    hermitian_pack=False).startswith("bf16x3 (")
    assert "do not apply" in tfft.effective_precision("highest", 64, impl="xla")
    assert "do not apply" in tfft.effective_precision("default", 64, impl="xla")
    assert tfft.resolve_precision("default") == "default"
    wr, wi = tfft.dft_matrices(16, -1, device="cpu")
    for got, want in zip((wr, wi), jfft.dft_matrices(16, -1)):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("ref_sign", [True, False])
def test_correction_sign_equals_jax_and_golden(n, ref_sign):
    got = tder.correction_sign(n, ref_sign, device="cpu").numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, np.asarray(jder.correction_sign(n, ref_sign)))
    assert np.array_equal(got, golden.correction_sign(n, ref_sign))


def test_host_input_goes_to_the_card_or_raises(monkeypatch):
    """``correction_sign`` goes to the card unless a device is given, and
    host (numpy, list) input of the DFT helpers goes to the card; both raise
    without one. A tensor stays on its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _complex((8, 8), 9)
    for call in (lambda: tder.correction_sign(8),
                 lambda: tprop.wavenumber_grid(8, 1000.0),
                 lambda: tfft.ifft1d_unnorm(x),
                 lambda: tfft.ifft2_unnorm(x),
                 lambda: tfft.ifft2_unnorm(x.tolist(), impl="xla")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    want = golden.ifft2_unnorm_np(x.astype(np.complex128))
    for got in (tfft.ifft2_unnorm(torch.from_numpy(x)),
                tfft.ifft2_unnorm(torch.from_numpy(x), impl="xla")):
        assert got.device.type == "cpu" and got.dtype == torch.complex64
        assert _rel(got.numpy(), want) < TOL
    assert tder.correction_sign(8, device="cpu").device.type == "cpu"


def test_eager_tables_are_made_once_per_device():
    """The "xla" route's correction sign and the eager propagate's k-hat
    grids come from tensors cached a (size, device); ``correction_sign`` and
    ``wavenumber_grid`` hand out copies of them."""
    tder._sign_grid.cache_clear()
    x = torch.from_numpy(np.real(_complex((2, 16, 16), 10)).copy())
    first = tfft.ifft2_real_unnorm(x, x, impl="xla", centered="ref")
    again = tfft.ifft2_real_unnorm(x, x, impl="xla", centered="ref")
    info = tder._sign_grid.cache_info()
    assert (info.misses, info.hits) == (1, 1) and torch.equal(first, again)
    shared = tder.sign_grid(16, True, "cpu")
    mine = tder.correction_sign(16, True, device="cpu")
    mine.neg_()
    assert torch.equal(tder.sign_grid(16, True, "cpu"), shared)
    assert torch.equal(mine, -shared)

    tprop._khat_grid_cached.cache_clear()
    h0, omega = (torch.from_numpy(a) for a in _state(16, 12))
    first = tprop.propagate_planes(h0, omega, 1.5, 1000.0)
    again = tprop.propagate_planes(h0, omega, 1.5, 1000.0)
    info = tprop._khat_grid_cached.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    kx, _ = tprop.wavenumber_grid(16, 1000.0, device="cpu")
    kx.zero_()
    assert not torch.equal(tprop._khat_grid(16, 1000.0, False, "cpu")[0], kx)


@pytest.mark.parametrize("ref_sign", [True, False])
def test_correction_equals_jax(ref_sign):
    fh, fx, fz = (_complex((2, 32, 32), s) for s in (5, 6, 7))
    got = tder.correction(*(torch.from_numpy(f) for f in (fh, fx, fz)), ref_sign=ref_sign)
    want = np.asarray(jder.correction(*(jnp.asarray(f) for f in (fh, fx, fz)),
                                      ref_sign=ref_sign))
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("conj_neg", [False, True])
@pytest.mark.parametrize("t", [0.0, 11.25, 1000.25])
def test_propagate_equals_jax(conj_neg, t):
    h0_pair, omega = _state(32, 8)
    h0 = h0_pair[0] + 1j * h0_pair[1]
    jc, tc = J.CompatFlags(conj_neg=conj_neg), T.CompatFlags(conj_neg=conj_neg)
    got = tprop.propagate(torch.from_numpy(h0.astype(np.complex64)), torch.from_numpy(omega),
                          t, 1000.0, tc)
    want = jprop.propagate(jnp.asarray(h0.astype(np.complex64)), jnp.asarray(omega),
                           jnp.float32(t), 1000.0, jc)
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        assert _rel(g.numpy(), np.asarray(w)) < TOL
    # propagate_planes: the same spectra as (re, im) planes, Dekker phase
    sr, si = tprop.propagate_planes(torch.from_numpy(h0_pair), torch.from_numpy(omega), t,
                                    1000.0, tc)
    jr, ji = jprop.propagate_planes(jnp.asarray(h0_pair), jnp.asarray(omega), jnp.float32(t),
                                    1000.0, jc)
    assert sr.shape == (3, 32, 32)
    assert _rel(sr.numpy(), np.asarray(jr)) < TOL and _rel(si.numpy(), np.asarray(ji)) < TOL
    assert _rel(sr.numpy() + 1j * si.numpy(),
                np.stack([g.numpy() for g in got])) < (TOL if t < 100 else 1e-4)


@pytest.mark.parametrize("impl", ["matmul", "xla"])
def test_step_on_xla_equals_matmul_and_jax(impl):
    """``fft_impl="xla"`` through the model, packed and unpacked, against the
    port's matmul route and the JAX package's step of the same config."""
    h0, omega = _state(64, 9)
    st = state_from_numpy(h0, omega, "cpu")
    for pack in (False, True):
        kw = dict(resolution=64, hermitian_pack=pack, matmul_precision="highest")
        got = T.make_step(T.OceanConfig(fft_impl=impl, **kw))(st, 11.25)
        mm = T.make_step(T.OceanConfig(fft_impl="matmul", **kw))(st, 11.25)
        jst = J.OceanState(h0=jnp.asarray(h0), omega=jnp.asarray(omega))
        want = J.make_step(J.OceanConfig(fft_impl=impl, **kw))(jst, jnp.float32(11.25))
        assert _rel(got.displacement.numpy(), mm.displacement.numpy()) < TOL
        assert _rel(got.displacement.numpy(), np.asarray(want.displacement)) < TOL
        assert _rel(got.normals.numpy(), np.asarray(want.normals)) < 1e-5


# The JAX docstring's target: ~1e-6 of the fields' scale after a resync
# interval of float32 unit-rotation drift (measured 5e-7 at 64^2 over 40
# frames, both modes). Checksums are sums of ~25k terms: held relative to
# the sum of their magnitudes.
UNIFORM_TOL = 2e-6


@pytest.mark.parametrize("impl", ["matmul", "xla"])
@pytest.mark.parametrize("recurrence", [True, False], ids=["recurrence", "exact"])
def test_make_uniform_rollout_equals_jax(impl, recurrence):
    """40 frames at 64^2 cross the resync at frame 32."""
    h0, omega = _state(64, 10)
    kw = dict(resolution=64, fft_impl=impl, hermitian_pack=False, matmul_precision="highest")
    jst = J.OceanState(h0=jnp.asarray(h0), omega=jnp.asarray(omega))
    st = state_from_numpy(h0, omega, "cpu")
    args = (40, 1 / 60)
    got = t_uniform(T.OceanConfig(**kw), *args, keep_fields=True,
                    phase_recurrence=recurrence)(st, 100.0)
    want = j_uniform(J.OceanConfig(**kw), *args, keep_fields=True,
                     phase_recurrence=recurrence)(jst, 100.0)
    assert got.displacement.shape == (40, 64, 64, 3)
    assert _rel(got.displacement.numpy(), np.asarray(want.displacement)) < UNIFORM_TOL
    cks = t_uniform(T.OceanConfig(**kw), *args, phase_recurrence=recurrence)(st, 100.0)
    jcks = np.asarray(j_uniform(J.OceanConfig(**kw), *args,
                                phase_recurrence=recurrence)(jst, 100.0))
    scale = (np.abs(want.displacement).sum(axis=(1, 2, 3))
             + np.abs(want.normals).sum(axis=(1, 2, 3)))
    assert cks.shape == (40,)
    assert np.all(np.abs(cks.numpy() - jcks) <= UNIFORM_TOL * scale)


def test_make_uniform_rollout_resync_bounds_drift():
    """The recurrence drifts from the exact phases between resyncs and
    returns to them at each resync: frame 32 is exact again. At t0 = 10 s
    the float32 frame times t0 + i dt are within 5e-7 s of the uniform grid
    the recurrence follows (at 3000 s, 1.2e-4 s: the exact mode's own
    time rounding, 1e-4 of the fields, would dominate)."""
    h0, omega = _state(32, 11)
    st = state_from_numpy(h0, omega, "cpu")
    cfg = T.OceanConfig(resolution=32, hermitian_pack=False, matmul_precision="highest")
    rec = t_uniform(cfg, 34, 1 / 60, keep_fields=True)(st, 10.0).displacement
    exact = t_uniform(cfg, 34, 1 / 60, keep_fields=True,
                      phase_recurrence=False)(st, 10.0).displacement
    assert torch.equal(rec[0], exact[0]) and torch.equal(rec[32], exact[32])
    assert _rel(rec.numpy(), exact.numpy()) < UNIFORM_TOL


@pytest.mark.parametrize("kwargs,match", [
    (dict(fft_impl="pallas"), "pallas"),
    (dict(hermitian_pack=True), "hermitian_pack"),
])
def test_make_uniform_rollout_rejects_like_jax(kwargs, match):
    for pkg in (J, T):
        with pytest.raises(ValueError, match=match):
            (j_uniform if pkg is J else t_uniform)(pkg.OceanConfig(resolution=32, **kwargs),
                                                   4, 0.1)


class _Event:
    def __init__(self, key, ms, count, cuda=True):
        self.key, self.device_time_total, self.count = key, ms * 1e3, count
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


def test_profile_kernels_reads_one_window_and_profiles_again(monkeypatch, capsys):
    """``profile_kernels`` (the one profiler window of the port, behind
    the smoke's device times) on a stand-in
    profiler: a session missing a wanted kernel is profiled again with a
    line on stderr, host ops and the step marker are left out, and the
    calls are one warm-up, then one warm-up step and ``calls`` a session."""
    import torch.profiler as tp

    from gfx_ocean_tpu_torch.utils import profiling

    sessions = iter([
        [_Event("packed_row_pass", 0.3, 3)],
        [_Event("packed_row_pass", 0.3, 3), _Event("checksum_partials", 0.06, 3),
         _Event("ProfilerStep#1", 9.0, 1), _Event("aten::add", 5.0, 3, cuda=False)],
    ])

    class Profile:
        def __init__(self, **kw):
            self.events = next(sessions)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            pass

        def key_averages(self):
            return self.events

    monkeypatch.setattr(tp, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    kernels, wall_ms = profiling.profile_kernels(lambda: calls.append(1), 3,
                                                 ("row_pass", "checksum"))
    assert kernels == {"packed_row_pass": (0.3, 3), "checksum_partials": (0.06, 3)}
    assert wall_ms >= 0 and len(calls) == 1 + 2 * (1 + 3)
    assert "session 1 of 3" in capsys.readouterr().err

    sessions = iter([[]] * profiling.PROFILER_ATTEMPTS)
    assert profiling.profile_kernels(lambda: None) is None


def test_ema_and_trace_match_jax(tmp_path):
    """``Ema`` against the JAX one; ``trace`` writes a Chrome trace of the
    block into its directory."""
    from gfx_ocean_tpu.utils.profiling import Ema as JEma

    from gfx_ocean_tpu_torch.utils.profiling import Ema, trace

    mine, theirs = Ema(), JEma()
    for dt in (0.016, 0.020, 0.5, 0.017):
        assert mine.update(dt) == theirs.update(dt)
    with trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
