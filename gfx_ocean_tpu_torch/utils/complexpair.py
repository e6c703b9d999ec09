"""Complex arrays as (re, im) float32 plane pairs.

Counterpart of ``gfx_ocean_tpu/utils/complexpair.py``. The port keeps the
JAX package's layout at every public function: a complex array of shape
(..., N, N) is carried as float32 (..., 2, N, N), plane 0 real, plane 1
imaginary. The kernels consume planes, and the parity tests compare planes.
"""

from __future__ import annotations

import numpy as np
import torch


def to_pair(x: np.ndarray) -> np.ndarray:
    """Host-side: complex (..., N, N) -> float32 (..., 2, N, N)."""
    x = np.asarray(x)
    return np.stack([np.real(x), np.imag(x)], axis=-3).astype(np.float32)


def from_pair_np(x: np.ndarray) -> np.ndarray:
    """Host-side inverse of ``to_pair``."""
    x = np.asarray(x)
    return x[..., 0, :, :] + 1j * x[..., 1, :, :]


def pair_to_complex(x: torch.Tensor) -> torch.Tensor:
    """float32 (..., 2, N, N) tensor -> complex64 (..., N, N)."""
    return torch.complex(x[..., 0, :, :], x[..., 1, :, :])


def complex_to_pair(x: torch.Tensor) -> torch.Tensor:
    """complex (..., N, N) tensor -> float32 (..., 2, N, N)."""
    return torch.stack([x.real, x.imag], dim=-3).to(torch.float32)
