"""Loader and saver for the reference's bincode initial conditions.

Counterpart of ``gfx_ocean_tpu/assets/bincode.py``. The reference embeds ``data/spectrum.bin``
(``Vec<[f32; 2]>``, h0(k)) and ``data/omega.bin`` (``Vec<f32>``, omega(k))
and reads them with bincode 1.x (``src/render.rs:769-771``, ``:808-810``):
a u64 little-endian element count, then the packed little-endian payload.
Flat index ``x + N * y`` (``shader/propagate.comp:42``), so a row-major
(N, N) reshape yields ``array[y, x]``.

The loaders parse with the native C++ loader (``native/bincode_native.py``:
the file memory-mapped, the header checked, the payload copied once)
wherever its library builds, as the JAX loader prefers its native parser;
the numpy parser below is the fallback where it cannot be built (with a
warning) and the golden reference for it. ``loader_in_use()`` names the
parser the loaders take.
"""

from __future__ import annotations

import os
import struct
import warnings
from pathlib import Path

import numpy as np

# Without GFX_OCEAN_REFERENCE_DATA the port looks inside its own checkout,
# where a copy or link of the reference's ``data/`` directory can be put.
_DEFAULT_DATA_DIR = Path(__file__).resolve().parents[2] / "reference" / "data"


def reference_data_dir() -> str:
    """Directory holding the reference's shipped bins.

    GFX_OCEAN_REFERENCE_DATA overrides it and is read on every call, as in
    the JAX package; the fallback is ``reference/data`` in the checkout.
    """
    return os.environ.get("GFX_OCEAN_REFERENCE_DATA", str(_DEFAULT_DATA_DIR))


def _read_header(buf: bytes, path: str) -> int:
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a bincode header")
    (count,) = struct.unpack_from("<Q", buf, 0)
    return count


def parse_bincode_f32(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """Parse a bincode ``Vec<f32>`` into a 1-D float32 array."""
    count = _read_header(buf, path)
    expected = 8 + 4 * count
    if len(buf) != expected:
        raise ValueError(f"{path}: expected {expected} bytes for Vec<f32> of len {count}, got {len(buf)}")
    return np.frombuffer(buf, dtype="<f4", count=count, offset=8)


def parse_bincode_vec2f(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """Parse a bincode ``Vec<[f32; 2]>`` into an (n, 2) float32 array."""
    count = _read_header(buf, path)
    expected = 8 + 8 * count
    if len(buf) != expected:
        raise ValueError(f"{path}: expected {expected} bytes for Vec<[f32;2]> of len {count}, got {len(buf)}")
    return np.frombuffer(buf, dtype="<f4", count=2 * count, offset=8).reshape(count, 2)


def _square_side(n2: int, path: str, resolution: int | None) -> int:
    n = int(round(n2 ** 0.5))
    if n * n != n2:
        raise ValueError(f"{path}: element count {n2} is not a perfect square")
    if resolution is not None and n != resolution:
        raise ValueError(f"{path}: resolution {n} != expected {resolution}")
    return n


def loader_in_use() -> str:
    """The parser ``load_spectrum`` / ``load_omega`` take: "native" (the C++
    loader) or "numpy" (the fallback where it cannot be built)."""
    from gfx_ocean_tpu_torch.native import bincode_native  # noqa: PLC0415

    return "native" if bincode_native.available() else "numpy"


def _parse(path: str, components: int) -> np.ndarray:
    """The payload of a bincode vector of ``components`` f32s an element,
    through the native loader where it builds; else numpy, with a warning."""
    if loader_in_use() == "native":
        from gfx_ocean_tpu_torch.native import bincode_native  # noqa: PLC0415

        return (bincode_native.parse_vec2f(path) if components == 2
                else bincode_native.parse_f32(path))
    warnings.warn("the native bincode loader cannot be built here (no g++ or a failed "
                  "build); parsing with numpy", RuntimeWarning, stacklevel=3)
    with open(path, "rb") as f:
        buf = f.read()
    return parse_bincode_vec2f(buf, path) if components == 2 else parse_bincode_f32(buf, path)


def load_spectrum(path: str | None = None, resolution: int | None = 512) -> np.ndarray:
    """Load h0(k) as a complex64 (N, N) array indexed [y, x]."""
    path = path or os.path.join(reference_data_dir(), "spectrum.bin")
    flat = _parse(path, 2)
    n = _square_side(flat.shape[0], path, resolution)
    return (flat[:, 0] + 1j * flat[:, 1]).astype(np.complex64).reshape(n, n)


def load_omega(path: str | None = None, resolution: int | None = 512) -> np.ndarray:
    """Load omega(k) as a float32 (N, N) array indexed [y, x]."""
    path = path or os.path.join(reference_data_dir(), "omega.bin")
    flat = _parse(path, 1)
    n = _square_side(flat.shape[0], path, resolution)
    return np.asarray(flat, dtype=np.float32).reshape(n, n)


def save_spectrum(path: str, h0: np.ndarray) -> None:
    """Write h0 in the reference's bincode format."""
    h0 = np.asarray(h0)
    n2 = h0.shape[0] * h0.shape[1]
    flat = np.empty((n2, 2), dtype="<f4")
    flat[:, 0] = np.real(h0).reshape(-1)
    flat[:, 1] = np.imag(h0).reshape(-1)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n2))
        f.write(flat.tobytes())


def save_omega(path: str, omega: np.ndarray) -> None:
    """Write omega in the reference's bincode format."""
    omega = np.asarray(omega, dtype="<f4")
    n2 = omega.shape[0] * omega.shape[1]
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n2))
        f.write(omega.reshape(-1).tobytes())
