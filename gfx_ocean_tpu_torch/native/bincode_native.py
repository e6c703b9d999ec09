"""ctypes binding of the native bincode loader, ``csrc/ocean_native.cpp``.

Counterpart of ``gfx_ocean_tpu/native/bincode_native.py``, with the same
functions and error codes, over the port's own copy of
``native/ocean_native.cpp``. The library is built with g++ at first use
into ``build/native/`` (``kernels.build_host``), never at import, and
tried once a process; where it cannot be built, ``library()`` raises and
``available()`` is False, and ``assets/bincode.py`` takes its numpy
parser. The numpy parser is the golden reference for these functions
(bit-equal outputs, ``tests/test_torch_native.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_ERRORS = {
    -1: "cannot open file",
    -2: "cannot stat file",
    -3: "file too small for bincode header",
    -4: "payload size does not match length prefix",
    -5: "mmap failed",
    -6: "write failed",
    -7: "invalid argument",
}

_F32_P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "on_bincode_count": ([ctypes.c_char_p, ctypes.c_int64], ctypes.c_int64),
    "on_load_f32": ([ctypes.c_char_p, _F32_P, ctypes.c_int64], ctypes.c_int64),
    "on_load_vec2f": ([ctypes.c_char_p, _F32_P, ctypes.c_int64], ctypes.c_int64),
    "on_write_npy_f32": ([ctypes.c_char_p, _F32_P, ctypes.POINTER(ctypes.c_int64),
                          ctypes.c_int32], ctypes.c_int64),
    "on_now_ns": ([], ctypes.c_int64),
}


@functools.lru_cache(maxsize=None)
def _load():
    """(library, None) once built and loaded, else (None, the error): a
    build that failed is not tried again in this process."""
    from gfx_ocean_tpu_torch import kernels  # noqa: PLC0415 - builds on first use

    try:
        lib = ctypes.CDLL(str(kernels.build_host("ocean_native")))
    except (RuntimeError, OSError) as err:
        return None, err
    for fn, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib, None


def library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/ocean_native.cpp``, typed. Raises
    ``RuntimeError`` when it cannot be built or loaded (the first attempt's
    error, which later calls repeat without building again)."""
    lib, err = _load()
    if err is not None:
        raise RuntimeError(f"the native bincode loader is unavailable: {err}") from err
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    return _load()[1] is None


def _check(status: int, path: str) -> int:
    if status < 0:
        raise ValueError(f"{path}: {_ERRORS.get(status, f'native error {status}')}")
    return status


def count(path: str, components: int = 1) -> int:
    """Element count of a bincode vector file of ``components`` f32s an element."""
    return _check(library().on_bincode_count(path.encode(), components), path)


def parse_f32(path: str) -> np.ndarray:
    """Load a bincode Vec<f32> -> (n,) float32."""
    n = count(path, 1)
    out = np.empty(n, dtype=np.float32)
    _check(library().on_load_f32(path.encode(), out.ctypes.data_as(_F32_P), n), path)
    return out


def parse_vec2f(path: str) -> np.ndarray:
    """Load a bincode Vec<[f32; 2]> -> (n, 2) float32."""
    n = count(path, 2)
    out = np.empty((n, 2), dtype=np.float32)
    _check(library().on_load_vec2f(path.encode(), out.ctypes.data_as(_F32_P), n), path)
    return out


def write_npy(path: str, array: np.ndarray) -> None:
    """Write a float32 array as .npy v1 (numpy-compatible)."""
    arr = np.ascontiguousarray(array, dtype=np.float32)
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    _check(library().on_write_npy_f32(path.encode(), arr.ctypes.data_as(_F32_P), shape,
                                      arr.ndim), path)


def now_ns() -> int:
    """Monotonic nanoseconds (CLOCK_MONOTONIC_RAW)."""
    return int(library().on_now_ns())
