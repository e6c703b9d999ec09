"""The port's native bincode loader (``gfx_ocean_tpu_torch/csrc/ocean_native.cpp``
through ``gfx_ocean_tpu_torch/native/bincode_native.py``) against its numpy
parser and the JAX package's pure-Python parser, on files written from a
seeded state by the port's writer.

The library is built with g++ at first use into ``build/native/``; these
tests skip only where there is no g++.
"""

from __future__ import annotations

import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

from gfx_ocean_tpu.assets import bincode as jbin
from gfx_ocean_tpu_torch.assets import bincode as tbin

REPO = Path(__file__).resolve().parent.parent
N = 64


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native loader cannot be built here")
    from gfx_ocean_tpu_torch.native import bincode_native

    bincode_native.library()
    return bincode_native


@pytest.fixture(scope="module")
def files(tmp_path_factory, native):
    rng = np.random.default_rng(11)
    h0 = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))).astype(np.complex64)
    omega = rng.random((N, N)).astype(np.float32) * 3.0
    d = tmp_path_factory.mktemp("bins")
    spec, om = str(d / "spectrum.bin"), str(d / "omega.bin")
    tbin.save_spectrum(spec, h0)
    tbin.save_omega(om, omega)
    return spec, om, h0, omega


def test_source_is_the_jax_package_copy():
    """The port keeps its own copy of native/ocean_native.cpp; a drift shows here."""
    mine = (REPO / "gfx_ocean_tpu_torch" / "csrc" / "ocean_native.cpp").read_bytes()
    assert mine == (REPO / "native" / "ocean_native.cpp").read_bytes()


def test_native_parses_bit_equal_to_numpy_and_jax(native, files):
    spec, om, h0, omega = files
    with open(spec, "rb") as f:
        buf = f.read()
    want = jbin.parse_bincode_vec2f(buf, spec)
    got = native.parse_vec2f(spec)
    assert got.dtype == np.float32 and got.shape == (N * N, 2)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), tbin.parse_bincode_vec2f(buf, spec).view(np.uint32))
    with open(om, "rb") as f:
        buf = f.read()
    got = native.parse_f32(om)
    assert np.array_equal(got.view(np.uint32), jbin.parse_bincode_f32(buf, om).view(np.uint32))
    assert np.array_equal(got, omega.reshape(-1))
    assert native.count(spec, 2) == native.count(om, 1) == N * N


def test_loaders_take_the_native_parser(native, files):
    spec, om, h0, omega = files
    assert tbin.loader_in_use() == "native"
    got_h0 = tbin.load_spectrum(spec, N)
    assert got_h0.dtype == np.complex64 and np.array_equal(got_h0, h0)
    assert np.array_equal(got_h0, jbin.load_spectrum(spec, N))
    got_om = tbin.load_omega(om, N)
    assert got_om.dtype == np.float32 and np.array_equal(got_om, omega)
    with pytest.raises(ValueError, match="resolution"):
        tbin.load_omega(om, 2 * N)


def test_numpy_fallback_when_the_library_cannot_be_built(monkeypatch, files):
    from gfx_ocean_tpu_torch.native import bincode_native

    monkeypatch.setattr(bincode_native, "available", lambda: False)
    spec, om, h0, omega = files
    assert tbin.loader_in_use() == "numpy"
    with pytest.warns(RuntimeWarning, match="numpy"):
        assert np.array_equal(tbin.load_spectrum(spec, N), h0)


def test_failed_build_is_not_retried(monkeypatch):
    """A build that failed is remembered: later loads take the numpy parser
    without running g++ again."""
    from gfx_ocean_tpu_torch import kernels
    from gfx_ocean_tpu_torch.native import bincode_native

    calls = []

    def broken(name):
        calls.append(name)
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(kernels, "build_host", broken)
    bincode_native._load.cache_clear()
    try:
        assert [tbin.loader_in_use() for _ in range(3)] == ["numpy"] * 3
        with pytest.raises(RuntimeError, match="g[+][+] failed"):
            bincode_native.library()
        assert calls == ["ocean_native"]
    finally:
        bincode_native._load.cache_clear()


def _write(path: Path, count: int, payload_floats: int):
    path.write_bytes(struct.pack("<Q", count) + np.zeros(payload_floats, "<f4").tobytes())
    return str(path)


@pytest.mark.parametrize("case,match", [
    ("truncated_payload", "size does not match"),
    ("long_payload", "size does not match"),
    ("vec2_as_f32", "size does not match"),
    ("header_only_short", "too small"),
    ("overflowing_count", "size does not match"),
    ("missing", "cannot open"),
])
def test_error_codes(native, tmp_path, case, match):
    if case == "truncated_payload":
        path = _write(tmp_path / "a.bin", 16, 15)
    elif case == "long_payload":
        path = _write(tmp_path / "a.bin", 16, 17)
    elif case == "vec2_as_f32":
        path = _write(tmp_path / "a.bin", 8, 16)   # a Vec<[f32; 2]> of 8 read as Vec<f32>
    elif case == "header_only_short":
        (tmp_path / "a.bin").write_bytes(b"\x01\x02\x03")
        path = str(tmp_path / "a.bin")
    elif case == "overflowing_count":
        path = _write(tmp_path / "a.bin", 1 << 62, 4)
    else:
        path = str(tmp_path / "missing.bin")
    with pytest.raises(ValueError, match=match):
        native.parse_f32(path)
    if case == "vec2_as_f32":
        assert native.parse_vec2f(path).shape == (8, 2)   # the same file, rightly typed
    else:
        with pytest.raises(ValueError):
            native.parse_vec2f(path)
    if case != "missing":
        with open(path, "rb") as f:
            buf = f.read()
        with pytest.raises(ValueError):
            tbin.parse_bincode_f32(buf, path)
    assert native._ERRORS[-7] == "invalid argument"


def test_write_npy_roundtrip(native, tmp_path):
    rng = np.random.default_rng(3)
    for shape in [(3, 5, 7), (11,), (N, N, 3)]:
        arr = rng.standard_normal(shape).astype(np.float32)
        p = str(tmp_path / f"a{len(shape)}.npy")
        native.write_npy(p, arr)
        back = np.load(p)
        assert back.dtype == np.float32 and np.array_equal(back, arr)
    a, b = native.now_ns(), native.now_ns()
    assert b >= a > 0
