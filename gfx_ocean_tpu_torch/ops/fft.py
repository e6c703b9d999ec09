"""Unnormalized inverse 2-D DFT on (re, im) planes, in PyTorch.

Counterpart of ``gfx_ocean_tpu/ops/fft.py:185-281, 452-526``. The reference
computes ``y[n] = sum_k x[k] e^{+2 pi i n k / N}`` with no 1/N factor
(SURVEY.md Q3). Here, as in the JAX package's "matmul" route, a transform
of N <= ``direct_max`` points is a dense matmul against a DFT table built
in float64 on the host and rounded once to float32. The (-1)^(x+y)
correction sign and the reference's global Q2 flip are folded into the
output side of the tables, so the correction pass costs nothing.

Not ported yet (ROADMAP.md queue 1, "ops/fft.py"): the four-step split for
N > ``direct_max``, ``impl="xla"``, and tensor-core precision schemes.
Every named tier runs as plain FP32 (``torch.matmul`` with TF32 off),
which is at least as exact as each of them; ``effective_precision`` says so.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

_TIERS = ("bf16x3", "bf16x4", "default", "high", "highest")


def effective_precision(precision: str) -> str:
    """The tier that actually runs on the port for a requested tier.

    The four f32-grade tiers all run as plain FP32. "default" (single-pass
    bf16 on the TPU) has no port yet and raises, as an unknown tier does.
    """
    if precision not in _TIERS:
        raise ValueError(f"unknown matmul precision {precision!r}; options: {list(_TIERS)}")
    if precision == "default":
        raise NotImplementedError(
            'matmul_precision="default" is not ported yet (ROADMAP.md queue 1, '
            '"ops/fft.py": tensor-core precision tiers)')
    return "fp32"


def pin_fp32_matmul(x: torch.Tensor) -> None:
    """Keep float32 matmuls in full FP32 on the card (no TF32)."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


# --------------------------------------------------------------------------
# Host-side constant tables (float64 -> float32), as in the JAX package.
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dft_matrix_np(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """(real, imag) of W[j, k] = exp(sign * 2 pi i j k / n), float32 from f64.

    The phase exponent is reduced mod n in integers before the f64 multiply.
    """
    jk = np.outer(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)) % n
    theta = (2.0 * np.pi * sign / n) * jk.astype(np.float64)
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """Four-step twiddle T[a, b] = exp(sign * 2 pi i a b / (n1*n2)), (n1, n2)."""
    n = n1 * n2
    ab = np.outer(np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64)) % n
    theta = (2.0 * np.pi * sign / n) * ab.astype(np.float64)
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _alt_np(n: int) -> np.ndarray:
    """(-1)^i, float32, length n."""
    a = np.ones(n, dtype=np.float32)
    a[1::2] = -1.0
    return a


@functools.lru_cache(maxsize=None)
def _dft_matrix_out_alt_np(n: int, sign: int, axis: int,
                           negate: bool) -> Tuple[np.ndarray, np.ndarray]:
    """DFT matrix with (-1)^(output index) folded in.

    axis=1 folds into columns (for Y = X @ W), axis=0 into rows (for
    Y = W @ X). ``negate`` also flips the global sign (the Q2 flip).
    """
    wr, wi = _dft_matrix_np(n, sign)
    alt = _alt_np(n) * (np.float32(-1.0) if negate else np.float32(1.0))
    if axis == 1:
        return wr * alt[None, :], wi * alt[None, :]
    return wr * alt[:, None], wi * alt[:, None]


def _table(pair: Tuple[np.ndarray, np.ndarray],
           device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(a).to(device) for a in pair)


# --------------------------------------------------------------------------
# Plane-pair transforms (direct DFT only).
# --------------------------------------------------------------------------

def _check_impl(impl: str, n: int, direct_max: int, precision: str) -> None:
    if impl == "xla":
        raise NotImplementedError(
            'impl="xla" is not ported yet (ROADMAP.md queue 1, "ops/fft.py")')
    if impl != "matmul":
        raise ValueError(f"unknown impl {impl!r}")
    if n > direct_max:
        raise NotImplementedError(
            f"N={n} > direct_max={direct_max} needs the four-step split, which is "
            'not ported yet (ROADMAP.md queue 1, "ops/fft.py")')
    effective_precision(precision)


def _fold(centered: Optional[str]) -> Tuple[bool, bool]:
    if centered not in (None, "ref", "canonical"):
        raise ValueError(f"centered must be None|'ref'|'canonical', got {centered!r}")
    return centered is not None, centered == "ref"


def _row_pass(xr: torch.Tensor, xi: torch.Tensor, fold: bool):
    """Complex DFT along the last axis, Y = X @ W, the x-half of the
    centering sign folded into the output index."""
    n = xr.shape[-1]
    pair = _dft_matrix_out_alt_np(n, 1, 1, False) if fold else _dft_matrix_np(n, 1)
    wr, wi = _table(pair, xr.device)
    return xr @ wr - xi @ wi, xr @ wi + xi @ wr


def _col_table(m: int, fold: bool, negate: bool, device: torch.device):
    pair = _dft_matrix_out_alt_np(m, 1, 0, negate) if fold else _dft_matrix_np(m, 1)
    return _table(pair, device)


def ifft2_real_unnorm(
    xr: torch.Tensor,
    xi: torch.Tensor,
    impl: str = "matmul",
    direct_max: int = 1024,
    precision: str = "highest",
    centered: Optional[str] = None,
) -> torch.Tensor:
    """Real part of the unnormalized 2-D inverse DFT over the last two axes.

    ``centered`` "ref" / "canonical" folds the (-1)^(x+y) fix-up of
    ``shader/correction.comp:29`` (reference or canonical sign) into the
    tables; None is the plain transform.
    """
    fold, negate = _fold(centered)
    _check_impl(impl, max(xr.shape[-2:]), direct_max, precision)
    pin_fp32_matmul(xr)
    ar, ai = _row_pass(xr, xi, fold)
    wr, wi = _col_table(xr.shape[-2], fold, negate, xr.device)
    return wr @ ar - wi @ ai


def ifft2_planes_unnorm(
    xr: torch.Tensor,
    xi: torch.Tensor,
    impl: str = "matmul",
    direct_max: int = 1024,
    precision: str = "highest",
    centered: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both planes of the unnormalized 2-D inverse DFT (the complex-output
    twin of :func:`ifft2_real_unnorm`, used under Hermitian field packing)."""
    fold, negate = _fold(centered)
    _check_impl(impl, max(xr.shape[-2:]), direct_max, precision)
    pin_fp32_matmul(xr)
    ar, ai = _row_pass(xr, xi, fold)
    wr, wi = _col_table(xr.shape[-2], fold, negate, xr.device)
    return wr @ ar - wi @ ai, wr @ ai + wi @ ar
