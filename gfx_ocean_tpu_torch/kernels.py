"""Build the CUDA sources of ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/kernels/lib<name>_<hash>.so`` at the repository root on first use:
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``.
The hash of the source together with every shared header ``csrc/*.cuh`` is
in the file name, so an edited source or header is rebuilt and a stale
library is never loaded. The compiler's output (``-Xptxas -v``:
registers, shared memory and spills a kernel) is kept beside the library as
``lib<name>_<hash>.log``.

The host library ``csrc/ocean_native.cpp`` (the native bincode loader,
``native/bincode_native.py``) is built the same way with g++ into
``build/native/lib<name>_<hash>.so``: ``g++ -O2 -shared -fPIC -std=c++17``.

The launch boundary. Every kernel wrapper of the port (``ops/fused_step``,
``ops/fourstep_step``, ``ops/unpacked_step``, ``ops/derived``,
``render/raster``) calls its C entry point through :func:`launch`, which
checks that the tensors' card is the current device, appends that device's
current stream, raises with the library's own error text on a nonzero code
and counts the launch in the recorder's table (``utils/profiling.tally``:
``launches.<wrapper>`` and, for a tiered body, ``tiered_launches.<wrapper>``).
A wrapper keeps only its own argument checks (:func:`cuda_device`,
:func:`check_tensor`), its outputs' allocation and its C arguments
(:func:`ptr`). A new kernel is its ``.cu`` file, its entry in ``SIGNATURES``
and its wrapper: nothing else lists it.

Nothing here runs at import: the CPU tests import every module, and this
host has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from gfx_ocean_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NATIVE_DIR = BUILD_DIR.parent / "native"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes / restype of each library's C entry points; each library has one
# ``*_error_string`` entry, the text of its error codes.
SIGNATURES = {
    "packed_step": {
        "packed_step": ([_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _F,
                         _P, _P, _P, _I, _F, _I, _I, _P, _P], _I),
        "packed_step_error_string": ([_I], ctypes.c_char_p),
    },
    "fourstep_step": {
        "fourstep_row": ([_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P,
                          _I, _P, _P, _P, _P, _P, _P], _I),
        "fourstep_row_windows": ([_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P,
                                  _I, _P, _P, _P, _P, _P, _P], _I),
        "fourstep_col": ([_P, _P, _P, _I, _I, _I, _F, _P, _P, _I, _F, _I,
                          _I, _P, _P, _P, _P, _P], _I),
        "fourstep_error_string": ([_I], ctypes.c_char_p),
    },
    "unpacked_step": {
        "unpacked_rows": ([_P, _P, _P, _P, _I, _I, _F, _I, _I, _F, _P, _P], _I),
        "unpacked_cols": ([_P, _P, _I, _I, _P, _P, _I, _F, _I, _P], _I),
        "unpacked_step": ([_P, _P, _P, _P, _I, _I, _F, _I, _I, _F, _P, _P,
                           _P, _I, _F, _I, _I, _P, _P], _I),
        "unpacked_step_grid": ([_I, _I], _I),
        "unpacked_error_string": ([_I], ctypes.c_char_p),
    },
    "derived": {
        "derived_partials": ([_P, _I, _I, _L, _L, _I, ctypes.POINTER(_F), _F, _F, _F, _I, _I,
                              _P, _P, _I, _P], _I),
        "derived_error_string": ([_I], ctypes.c_char_p),
    },
    "raster": {
        "slot_stage": ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P], _I),
        "segmin_stage": ([_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P], _I),
        "giant_pass": ([_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P], _I),
        "raster_error_string": ([_I], ctypes.c_char_p),
    },
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to, keyed by the hash of the source
    and of every ``csrc/*.cuh`` it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _compile(cmd: Sequence[str], source: Path, so: Path) -> Path:
    """Compile ``source`` with ``cmd`` into a temporary file beside ``so``
    and move it into place (atomic: concurrent builds of one source race
    harmlessly); the compiler's output goes to ``so``'s ``.log``."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, str(source)], capture_output=True, text=True,
                              timeout=600)
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed on {source.name} "
                               f"(exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path."""
    so = library_path(name)
    if so.exists():
        return so
    return _compile([nvcc(), *NVCC_FLAGS], CSRC / f"{name}.cu", so)


def host_library_path(name: str) -> Path:
    """Where ``csrc/<name>.cpp`` is built to, keyed by the hash of the source."""
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes()).hexdigest()[:12]
    return NATIVE_DIR / f"lib{name}_{digest}.so"


def build_host(name: str) -> Path:
    """Compile the host library ``csrc/<name>.cpp`` with g++ unless it
    exists; return its path. Raises when there is no g++ or it fails."""
    so = host_library_path(name)
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {name}.cpp cannot be built")
    return _compile([cxx, *CXX_FLAGS], CSRC / f"{name}.cpp", so)


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Build several libraries at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


@profiling.counted_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (first use) and load ``csrc/<name>.cu``, with its entry points typed."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def cuda_device(x: torch.Tensor, who: str) -> torch.device:
    """The device of ``x``; raises ``ValueError`` unless it is a card."""
    if x.device.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {x.device}")
    return x.device


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype, shape: Sequence[int],
                 device: torch.device) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``."""
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {str(dtype).removeprefix('torch.')} "
                         f"on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")


def ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    """The device address of ``x``, None (a null pointer) for None."""
    return None if x is None else x.data_ptr()


def launch(counter: str, library: str, entry: str, *args, device: torch.device,
           tiered: bool = False) -> None:
    """Call ``entry`` of ``csrc/<library>.cu`` with ``args`` and ``device``'s
    current stream, then count one ``launches.<counter>`` (and one
    ``tiered_launches.<counter>`` where ``tiered``) in the recorder's table
    and mark the launch on the recorder's timeline (``profiling.mark``).

    A launch through ctypes goes to the current device's context, whatever
    device its tensors lie on, so ``device`` must be the current device
    (a shard of a mesh runs under its own, ``utils/device.device_guard``):
    ``RuntimeError`` otherwise. A nonzero code raises ``RuntimeError`` with
    the library's own text of it and counts nothing."""
    current = torch.cuda.current_device()
    if device.index != current:
        raise RuntimeError(f"{counter}: tensors on {device} but the current device is "
                           f"cuda:{current}; run under torch.cuda.device({device})")
    lib = load(library)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    err = getattr(lib, entry)(*args, stream)
    if err != 0:
        text = next(f for f in SIGNATURES[library] if f.endswith("_error_string"))
        raise RuntimeError(f"{counter}: {entry}{' (tiered)' if tiered else ''} failed to launch: "
                           f"CUDA error {err} ({getattr(lib, text)(err).decode()})")
    profiling.tally("launches." + counter)
    if tiered:
        profiling.tally("tiered_launches." + counter)
    profiling.mark()
