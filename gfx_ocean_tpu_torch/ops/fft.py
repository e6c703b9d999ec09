"""Unnormalized inverse 2-D DFT on (re, im) planes, in PyTorch.

Counterpart of ``gfx_ocean_tpu/ops/fft.py:185-333, 393-526``. The reference
computes ``y[n] = sum_k x[k] e^{+2 pi i n k / N}`` with no 1/N factor
(SURVEY.md Q3). Here, as in the JAX package's "matmul" route, a transform
of N <= ``direct_max`` points is a dense matmul against a DFT table built
in float64 on the host and rounded once to float32; above ``direct_max``
it is the four-step split N = N1 N2 (``_foursteps_last``): a small DFT
matmul, a twiddle, a small DFT matmul. The (-1)^(x+y) correction sign and
the reference's global Q2 flip are folded into the output side of the
tables, so the correction pass costs nothing.

``impl="xla"`` is ``torch.fft`` (cuFFT on a CUDA tensor) scaled to the
unnormalized DFT, the correction sign applied after it: the eager route of
``fft_impl="xla"`` and the speed baseline, never a stand-in for a kernel.
The complex-typed helpers ``ifft1d_unnorm`` / ``ifft2_unnorm`` and the
plane-pair ``ifft1d_real_unnorm`` are the JAX package's public helpers.

Not ported yet (ROADMAP.md queue 1, "ops/fft.py"): tensor-core precision
schemes. Every named tier runs as plain FP32 (``torch.matmul`` with TF32
off), which is at least as exact as each of them; ``effective_precision``
says so.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from gfx_ocean_tpu_torch.ops.derived import sign_grid
from gfx_ocean_tpu_torch.utils.device import resolve_device

_TIERS = ("bf16x3", "bf16x4", "default", "high", "highest")


def effective_precision(precision: str, n: Optional[int] = None, direct_max: int = 1024,
                        impl: str = "matmul") -> str:
    """The tier that actually runs on the port for a requested tier of an
    n-point transform (the JAX signature; ``n`` and ``direct_max`` do not
    change the answer here).

    On "matmul" and "pallas" the four f32-grade tiers all run as plain
    FP32. On "xla" (cuFFT) the tiers do not apply. "default" (single-pass
    bf16 on the TPU) has no port yet and raises on every route, as an
    unknown tier does.
    """
    if precision not in _TIERS:
        raise ValueError(f"unknown matmul precision {precision!r}; options: {list(_TIERS)}")
    if precision == "default":
        raise NotImplementedError(
            'matmul_precision="default" is not ported yet (ROADMAP.md queue 1, '
            '"ops/fft.py": tensor-core precision tiers)')
    if impl == "xla":
        return "n/a (torch.fft, cuFFT on the card; precision tiers do not apply)"
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


def twiddle_table(n: int, device) -> torch.Tensor:
    """(2, n/2) float32 cos, sin of 2 pi k / n (row 1 of ``_dft_matrix_np``,
    without the n x n table): the FFT kernels' twiddles, made once per n and
    device. Read only: every caller shares the one tensor."""
    return _twiddle_table(n, torch.device(device))


@functools.lru_cache(maxsize=None)
def _twiddle_table(n: int, device: torch.device) -> torch.Tensor:
    theta = (2.0 * np.pi / n) * np.arange(n // 2, dtype=np.float64)
    return torch.from_numpy(np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32)).to(device)


def _split(n: int) -> Tuple[int, int]:
    """Balanced N = N1 * N2 split with both factors powers of two."""
    log = n.bit_length() - 1
    l1 = log // 2
    return 1 << l1, 1 << (log - l1)


def _table(pair: Tuple[np.ndarray, np.ndarray],
           device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(a).to(device) for a in pair)


# --------------------------------------------------------------------------
# Plane-pair transforms.
# --------------------------------------------------------------------------

def _check_impl(impl: str, precision: str) -> None:
    if impl not in ("matmul", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    effective_precision(precision, impl=impl)


def _fold(centered: Optional[str]) -> Tuple[bool, bool]:
    if centered not in (None, "ref", "canonical"):
        raise ValueError(f"centered must be None|'ref'|'canonical', got {centered!r}")
    return centered is not None, centered == "ref"


def _direct_last(xr: torch.Tensor, xi: torch.Tensor, real_out: bool,
                 out_alt: bool = False, negate: bool = False):
    """Dense DFT along the last axis, Y = X @ W; ``out_alt`` folds
    (-1)^(output index) into W, ``negate`` flips the global sign."""
    n = xr.shape[-1]
    pair = (_dft_matrix_out_alt_np(n, 1, 1, negate) if out_alt
            else _dft_matrix_np(n, 1))
    wr, wi = _table(pair, xr.device)
    yr = xr @ wr - xi @ wi
    return yr, None if real_out else xr @ wi + xi @ wr


def _foursteps_last(xr: torch.Tensor, xi: torch.Tensor, real_out: bool,
                    out_alt: bool = False, negate: bool = False):
    """Four-step split along the last axis: O(N (N1 + N2)) as batched matmuls.

    With k = N2 k1 + k2 and n = n1 + N1 n2:
      y[n1 + N1 n2] = sum_k2 W_N[n1 k2] (sum_k1 X[k1, k2] W_N1[n1 k1]) W_N2[n2 k2].
    ``out_alt`` folds (-1)^n = (-1)^n1 (N1 even) into the rows of W1."""
    n = xr.shape[-1]
    n1, n2 = _split(n)
    batch = xr.shape[:-1]
    xr = xr.reshape(*batch, n1, n2)  # X[k1, k2]
    xi = xi.reshape(*batch, n1, n2)
    dev = xr.device
    w1r, w1i = _table(_dft_matrix_out_alt_np(n1, 1, 0, negate) if out_alt
                      else _dft_matrix_np(n1, 1), dev)
    w2r, w2i = _table(_dft_matrix_np(n2, 1), dev)
    tr, ti = _table(_twiddle_np(n1, n2, 1), dev)
    ar = w1r @ xr - w1i @ xi
    ai = w1r @ xi + w1i @ xr
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr
    # Y = B @ W2^T over k2, then y_flat[n1 + N1 n2] = Y[n1, n2].
    yr = (br @ w2r.T - bi @ w2i.T).transpose(-1, -2).reshape(*batch, n)
    if real_out:
        return yr, None
    yi = (br @ w2i.T + bi @ w2r.T).transpose(-1, -2).reshape(*batch, n)
    return yr, yi


def _ifft_last(xr: torch.Tensor, xi: torch.Tensor, direct_max: int, real_out: bool,
               out_alt: bool = False):
    """DFT along the last axis: dense up to ``direct_max`` points, else the
    four-step split."""
    last = _direct_last if xr.shape[-1] <= direct_max else _foursteps_last
    return last(xr, xi, real_out, out_alt=out_alt)


def row_pass_complex(xr: torch.Tensor, xi: torch.Tensor, direct_max: int, fold: bool):
    """Complex DFT along the last axis, the x-half of the centering sign
    optionally folded into the output table."""
    return _ifft_last(xr, xi, direct_max, real_out=False, out_alt=fold)


def _col_pass(ar: torch.Tensor, ai: torch.Tensor, direct_max: int, fold: bool,
              negate: bool, real_out: bool):
    m = ar.shape[-2]
    if m <= direct_max:
        pair = _dft_matrix_out_alt_np(m, 1, 0, negate) if fold else _dft_matrix_np(m, 1)
        wr, wi = _table(pair, ar.device)
        yr = wr @ ar - wi @ ai
        return yr, None if real_out else wr @ ai + wi @ ar
    yr, yi = _foursteps_last(ar.transpose(-1, -2), ai.transpose(-1, -2), real_out,
                             out_alt=fold, negate=negate)
    return yr.transpose(-1, -2), None if real_out else yi.transpose(-1, -2)


def col_pass_real(ar: torch.Tensor, ai: torch.Tensor, direct_max: int, fold: bool,
                  negate: bool) -> torch.Tensor:
    """Real-output DFT along axis -2; folds the y-half of the centering sign
    and the reference's global Q2 flip (``negate``)."""
    return _col_pass(ar, ai, direct_max, fold, negate, real_out=True)[0]


def col_pass_complex(ar: torch.Tensor, ai: torch.Tensor, direct_max: int, fold: bool,
                     negate: bool):
    """Complex-output DFT along axis -2, the twin of :func:`col_pass_real`."""
    return _col_pass(ar, ai, direct_max, fold, negate, real_out=False)


def _xla_ifft2(xr: torch.Tensor, xi: torch.Tensor, fold: bool, negate: bool) -> torch.Tensor:
    """The "xla" route: ``torch.fft.ifft2`` scaled by N M, then the
    correction sign (``ref_sign=negate``) when ``fold``; complex64."""
    m, n = xr.shape[-2], xr.shape[-1]
    y = torch.fft.ifft2(torch.complex(xr, xi)) * (m * n)
    if fold:
        y = y * sign_grid(n, negate, y.device)
    return y


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
    _check_impl(impl, precision)
    if impl == "xla":
        return _xla_ifft2(xr, xi, fold, negate).real
    pin_fp32_matmul(xr)
    ar, ai = row_pass_complex(xr, xi, direct_max, fold)
    return col_pass_real(ar, ai, direct_max, fold, negate)


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
    _check_impl(impl, precision)
    if impl == "xla":
        y = _xla_ifft2(xr, xi, fold, negate)
        return y.real, y.imag
    pin_fp32_matmul(xr)
    ar, ai = row_pass_complex(xr, xi, direct_max, fold)
    return col_pass_complex(ar, ai, direct_max, fold, negate)


# --------------------------------------------------------------------------
# The JAX package's public helpers: 1-D planes, complex-typed 1-D / 2-D.
# --------------------------------------------------------------------------

def ifft1d_real_unnorm(xr: torch.Tensor, xi: torch.Tensor, axis: int = -1,
                       direct_max: int = 1024, precision: str = "highest") -> torch.Tensor:
    """Re(unnormalized inverse DFT) along ``axis``, plane-pair inputs."""
    _check_impl("matmul", precision)
    pin_fp32_matmul(xr)
    xr, xi = torch.movedim(xr, axis, -1), torch.movedim(xi, axis, -1)
    return torch.movedim(_ifft_last(xr, xi, direct_max, real_out=True)[0], -1, axis)


def _as_complex(x) -> torch.Tensor:
    """A tensor stays on its device; host input (numpy, lists) goes to the
    card as complex64, and raises without one (a CPU caller passes a CPU
    tensor)."""
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(np.asarray(x, dtype=np.complex64), device=resolve_device(None))
    return x if x.is_complex() else x.to(torch.complex64)


def ifft1d_unnorm(x, axis: int = -1, impl: str = "matmul", direct_max: int = 1024,
                  precision: str = "highest") -> torch.Tensor:
    """Unnormalized inverse DFT (= N * ifft) along ``axis``; complex64, on
    the device of a tensor ``x`` and on the card for host input."""
    x = _as_complex(x)
    _check_impl(impl, precision)
    if impl == "xla":
        return torch.fft.ifft(x, dim=axis) * x.shape[axis]
    pin_fp32_matmul(x)
    x = torch.movedim(x, axis, -1)
    yr, yi = _ifft_last(x.real, x.imag, direct_max, real_out=False)
    return torch.movedim(torch.complex(yr, yi), -1, axis)


def ifft2_unnorm(x, impl: str = "matmul", direct_max: int = 1024,
                 precision: str = "highest") -> torch.Tensor:
    """Unnormalized 2-D inverse DFT over the last two axes (= N M * ifft2):
    the row pass then the column pass, as the reference composes them.
    Placed as :func:`ifft1d_unnorm` places it."""
    x = _as_complex(x)
    if impl == "xla":
        _check_impl(impl, precision)
        return torch.fft.ifft2(x) * (x.shape[-2] * x.shape[-1])
    y = ifft1d_unnorm(x, axis=-1, impl=impl, direct_max=direct_max, precision=precision)
    return ifft1d_unnorm(y, axis=-2, impl=impl, direct_max=direct_max, precision=precision)
