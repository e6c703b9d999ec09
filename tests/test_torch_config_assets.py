"""The port's framework-free copies against the JAX package's originals.

``gfx_ocean_tpu_torch`` cannot import ``gfx_ocean_tpu`` (its ``__init__``
imports jax, which the GPU machine lacks), so config, bincode loader,
golden model, spectrum envelopes and complex-pair helpers are copies.
These tests prove each copy equal to its original: bit for bit where the
arithmetic is the same numpy code.
"""

from __future__ import annotations

import dataclasses
import importlib
import struct

import jax
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.assets import bincode as jbin
from gfx_ocean_tpu.golden import reference as jgold
from gfx_ocean_tpu.models.ocean import downsample_state as j_downsample
from gfx_ocean_tpu.utils import complexpair as jpair
from gfx_ocean_tpu_torch.assets import bincode as tbin
from gfx_ocean_tpu_torch.golden import reference as tgold
from gfx_ocean_tpu_torch.models.ocean import downsample_state, state_from_numpy
from gfx_ocean_tpu_torch.utils import complexpair as tpair

jspec = importlib.import_module("gfx_ocean_tpu.spectra.phillips")
tspec = importlib.import_module("gfx_ocean_tpu_torch.spectra.phillips")

CONFIG_CLASSES = ["CompatFlags", "OceanConfig", "PhillipsConfig"]


def _default(f: dataclasses.Field):
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return f.default


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_and_defaults_equal(name):
    jf = dataclasses.fields(getattr(J, name))
    tf = dataclasses.fields(getattr(T, name))
    assert [(f.name, f.type) for f in tf] == [(f.name, f.type) for f in jf]
    for a, b in zip(tf, jf):
        ta, tb = _default(a), _default(b)
        if dataclasses.is_dataclass(ta):
            ta, tb = dataclasses.asdict(ta), dataclasses.asdict(tb)
        assert ta == tb or (ta != ta and tb != tb), a.name
    assert getattr(T, name).__dataclass_params__.frozen


BAD_CONFIGS = [
    ("OceanConfig", dict(resolution=100)),
    ("OceanConfig", dict(resolution=8)),
    ("OceanConfig", dict(fft_impl="cufft")),
    ("OceanConfig", dict(num_cascades=2, cascade_domains=(1.0,))),
    ("PhillipsConfig", dict(model="pm")),
    ("PhillipsConfig", dict(model="jonswap", fetch=float("inf"))),
    ("PhillipsConfig", dict(model="jonswap", peak_enhancement=0.0)),
    ("PhillipsConfig", dict(depth=0.0)),
    ("PhillipsConfig", dict(opposing_suppression=1.5)),
]


@pytest.mark.parametrize("name,kwargs", BAD_CONFIGS)
def test_config_validation_errors_equal(name, kwargs):
    with pytest.raises(ValueError) as want:
        getattr(J, name)(**kwargs)
    with pytest.raises(ValueError) as got:
        getattr(T, name)(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(fft_impl="pallas"), dict(resolution=1024),
    dict(resolution=1024, fft_impl="xla"), dict(fft_impl="pallas", hermitian_pack=False),
    dict(num_cascades=3), dict(num_cascades=2, cascade_domains=(500.0, 50.0)),
])
def test_config_derived_values_equal(kwargs):
    jc, tc = J.OceanConfig(**kwargs), T.OceanConfig(**kwargs)
    assert tc.hermitian_pack == jc.hermitian_pack
    assert tc.domains == jc.domains


def test_bincode_round_trip_equals_jax_loader(tmp_path):
    rng = np.random.default_rng(3)
    h0 = (rng.standard_normal((32, 32)) + 1j * rng.standard_normal((32, 32))).astype(np.complex64)
    om = rng.random((32, 32)).astype(np.float32)
    sp, op = str(tmp_path / "s.bin"), str(tmp_path / "o.bin")
    tbin.save_spectrum(sp, h0)
    tbin.save_omega(op, om)
    for loader in (tbin, jbin):
        assert np.array_equal(loader.load_spectrum(sp, 32), h0)
        assert np.array_equal(loader.load_omega(op, 32), om)
    jsp, jop = str(tmp_path / "js.bin"), str(tmp_path / "jo.bin")
    jbin.save_spectrum(jsp, h0)
    jbin.save_omega(jop, om)
    assert open(jsp, "rb").read() == open(sp, "rb").read()
    assert open(jop, "rb").read() == open(op, "rb").read()


@pytest.mark.parametrize("buf", [b"\x01", struct.pack("<Q", 10) + b"\x00" * 8])
def test_bincode_rejects_like_jax(buf):
    for parse in ("parse_bincode_f32", "parse_bincode_vec2f"):
        with pytest.raises(ValueError) as want:
            getattr(jbin, parse)(buf)
        with pytest.raises(ValueError) as got:
            getattr(tbin, parse)(buf)
        assert str(got.value) == str(want.value)


def test_bincode_rejects_wrong_resolution(tmp_path):
    p = str(tmp_path / "o.bin")
    tbin.save_omega(p, np.zeros((16, 16), np.float32))
    with pytest.raises(ValueError, match="resolution 16 != expected 32"):
        tbin.load_omega(p, 32)


def test_reference_data_dir_honours_override(monkeypatch, tmp_path):
    monkeypatch.setenv("GFX_OCEAN_REFERENCE_DATA", str(tmp_path))
    assert tbin.reference_data_dir() == jbin.reference_data_dir() == str(tmp_path)


def test_assets_state_equals_jax(tmp_path, monkeypatch):
    """ocean_state_from_assets reads the same bins into the same planes."""
    rng = np.random.default_rng(5)
    h0 = (rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))).astype(np.complex64)
    om = rng.random((64, 64)).astype(np.float32)
    tbin.save_spectrum(str(tmp_path / "spectrum.bin"), h0)
    tbin.save_omega(str(tmp_path / "omega.bin"), om)
    monkeypatch.setenv("GFX_OCEAN_REFERENCE_DATA", str(tmp_path))
    want = J.ocean_state_from_assets(resolution=64)
    got = T.ocean_state_from_assets(resolution=64, device="cpu")
    assert got.h0.dtype == torch.float32 and got.h0.shape == (2, 64, 64)
    assert np.array_equal(got.h0.numpy(), np.asarray(want.h0))
    assert np.array_equal(got.omega.numpy(), np.asarray(want.omega))


@pytest.mark.parametrize("n,wrap", [(16, False), (16, True), (512, False), (512, True)])
def test_wavenumber_1d_equal(n, wrap):
    assert np.array_equal(tgold.wavenumber_1d(n, 1000.0, wrap),
                          jgold.wavenumber_1d(n, 1000.0, wrap))


FLAGS = [dict(), dict(wrap_k=True), dict(ref_sign=False), dict(conj_neg=True)]


@pytest.mark.parametrize("flags", FLAGS, ids=["default", "wrap_k", "canonical", "conj_neg"])
def test_golden_model_bit_equal(flags):
    rng = np.random.default_rng(11)
    n = 32
    h0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    om = rng.random((n, n)) * 3
    for t in (0.0, 11.25, 1000.0):
        got = tgold.golden_fields(h0, om, t, 1000.0, T.CompatFlags(**flags))
        want = jgold.golden_fields(h0, om, t, 1000.0, J.CompatFlags(**flags))
        assert np.array_equal(got, want)
        for a, b in zip(tgold.golden_propagate(h0, om, t, 1000.0, T.CompatFlags(**flags)),
                        jgold.golden_propagate(h0, om, t, 1000.0, J.CompatFlags(**flags))):
            assert np.array_equal(a, b)
    assert np.array_equal(tgold.golden_normals(got[..., 1], 180.0),
                          jgold.golden_normals(want[..., 1], 180.0))
    assert np.array_equal(tgold.ifft2_unnorm_np(h0), jgold.ifft2_unnorm_np(h0))
    for ref in (True, False):
        assert np.array_equal(tgold.correction_sign(n, ref), jgold.correction_sign(n, ref))


@pytest.mark.parametrize("flags", FLAGS, ids=["default", "wrap_k", "canonical", "conj_neg"])
@pytest.mark.parametrize("row_base,rows,col_chunk", [(0, 64, 2048), (7, 16, 24), (48, 16, 64)],
                         ids=["all-rows", "band-7", "band-48"])
def test_golden_rows_equal_numpy_golden(flags, row_base, rows, col_chunk):
    """The float64 torch golden of a band of rows (used at 16384^2 on the
    card) equals the JAX package's numpy golden on those rows at 64^2,
    whatever the column chunk: the same propagate, the inverse DFT along y
    as a product at the band's rows, along x by FFT (rounding only)."""
    rng = np.random.default_rng(64)
    n = 64
    h0 = rng.standard_normal((2, n, n)).astype(np.float32)
    om = (rng.random((n, n)) * 3).astype(np.float32)
    for t in (11.25, 1000.0):
        want = jgold.golden_fields(h0[0] + 1j * h0[1], om, t, 1000.0, J.CompatFlags(**flags))
        got = tgold.golden_fields_rows(torch.from_numpy(h0), torch.from_numpy(om), t, 1000.0,
                                       T.CompatFlags(**flags), row_base, rows, col_chunk)
        assert got.shape == (rows, n, 3) and got.dtype == torch.float64
        assert (np.abs(got.numpy() - want[row_base:row_base + rows]).max()
                <= 1e-12 * np.abs(want).max())


PHILLIPS = [
    dict(),
    dict(wind_direction=(1.0, 2.0), directional_power=4.0, small_wave_cutoff=0.01),
    dict(opposing_suppression=0.25),
    dict(model="jonswap"),
    dict(model="jonswap", depth=20.0, peak_enhancement=1.0),
]


@pytest.mark.parametrize("kwargs", PHILLIPS)
@pytest.mark.parametrize("n", [32, 128])
def test_spectrum_and_dispersion_equal(kwargs, n):
    jc, tc = J.PhillipsConfig(**kwargs), T.PhillipsConfig(**kwargs)
    assert np.array_equal(tspec.spectrum(n, 1000.0, tc), jspec.spectrum(n, 1000.0, jc))
    got = tspec.dispersion(n, 1000.0, tc.gravity, tc.depth)
    want = np.asarray(jspec.dispersion(n, 1000.0, jc.gravity, jc.depth))
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_synthesize_with_given_noise():
    """h0 = xi * sqrt(P / 2) exactly; fed the JAX draw, it is the JAX state."""
    n = 64
    cfg = T.PhillipsConfig(model="jonswap")
    xi = np.random.default_rng(0).standard_normal((2, n, n)).astype(np.float32)
    h0, om = tspec.synthesize(n, 1000.0, cfg, noise=torch.from_numpy(xi))
    env = np.sqrt(tspec.spectrum(n, 1000.0, cfg) / 2.0).astype(np.float32)
    assert np.array_equal(h0.numpy(), xi * env)
    assert np.array_equal(om.numpy(), tspec.dispersion(n, 1000.0))

    key = jax.random.PRNGKey(7)
    jh0, jom = jspec.synthesize(n, 1000.0, J.PhillipsConfig(model="jonswap"), key)
    kr, ki = jax.random.split(key)
    jxi = np.stack([np.asarray(jax.random.normal(k, (n, n), dtype=np.float32))
                    for k in (kr, ki)])
    h0, om = tspec.synthesize(n, 1000.0, cfg, noise=torch.from_numpy(jxi))
    assert np.array_equal(h0.numpy(), np.asarray(jh0))
    assert np.array_equal(om.numpy(), np.asarray(jom))


def test_synthesize_generator_is_reproducible():
    cfg = T.PhillipsConfig()
    a, _ = tspec.synthesize(32, 1000.0, cfg, generator=torch.Generator().manual_seed(4))
    b, _ = tspec.synthesize(32, 1000.0, cfg, generator=torch.Generator().manual_seed(4))
    c, _ = tspec.synthesize(32, 1000.0, cfg)  # seeded with cfg.seed
    d = T.ocean_state_from_phillips(T.OceanConfig(resolution=32), device="cpu").h0
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="noise must have shape"):
        tspec.synthesize(32, 1000.0, cfg, noise=torch.zeros(2, 16, 16))


def test_complex_pairs_equal():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 8, 8)) + 1j * rng.standard_normal((3, 8, 8))).astype(np.complex64)
    p = tpair.to_pair(x)
    assert p.dtype == np.float32 and np.array_equal(p, jpair.to_pair(x))
    assert np.array_equal(tpair.from_pair_np(p), jpair.from_pair_np(p))
    t = torch.from_numpy(p)
    assert torch.equal(tpair.complex_to_pair(tpair.pair_to_complex(t)), t)


def test_state_from_numpy_and_downsample_equal_jax():
    rng = np.random.default_rng(8)
    h0 = rng.standard_normal((2, 64, 64)).astype(np.float32)
    om = rng.random((64, 64)).astype(np.float32)
    st = state_from_numpy(h0, om, device="cpu")
    assert st.h0.dtype == torch.float32 and st.omega.shape == (64, 64)
    got = downsample_state(st, 32)
    want = j_downsample(J.OceanState(h0=h0, omega=om), 32)
    assert np.array_equal(got.h0.numpy(), np.asarray(want.h0))
    assert np.array_equal(got.omega.numpy(), np.asarray(want.omega))
    assert downsample_state(st, 64) is st
    with pytest.raises(ValueError, match="cannot upsample"):
        downsample_state(st, 128)
