"""Unnormalized inverse 2-D DFT on (re, im) planes, in PyTorch.

Counterpart of ``gfx_ocean_tpu/ops/fft.py``. The reference computes
``y[n] = sum_k x[k] e^{+2 pi i n k / N}`` with no 1/N factor (SURVEY.md
Q3). Here, as in the JAX package's "matmul" route, a transform of
N <= ``direct_max`` points is a dense matmul against a DFT table built in
float64 on the host and rounded once to float32; above ``direct_max`` it is
the four-step split N = N1 N2 (``_foursteps_last``): a small DFT matmul, a
twiddle, a small DFT matmul. The (-1)^(x+y) correction sign and the
reference's global Q2 flip are folded into the output side of the tables,
so the correction pass costs nothing.

``impl="xla"`` is ``torch.fft`` (cuFFT on a CUDA tensor) scaled to the
unnormalized DFT, the correction sign applied after it: the eager route of
``fft_impl="xla"`` and the speed baseline, never a stand-in for a kernel.
The complex-typed helpers ``ifft1d_unnorm`` / ``ifft2_unnorm`` and the
plane-pair ``ifft1d_real_unnorm`` are the JAX package's public helpers.

Precision tiers of the matmul route (``gfx_ocean_tpu/ops/fft.py:54-187``,
``config.py:88-104``). On the TPU they are passes of bf16 on the MXU; on
the card each pass is a bf16 x bf16 product on the tensor cores,
accumulated and returned in FP32 (``torch.mm`` / ``torch.bmm`` with
``out_dtype=torch.float32``), so every product is exact and only the sums
round:

- "highest": ``full_matmul``: on the card the FP32 inputs multiplied and
  summed in float64 (DGEMM on the FP64 tensor cores), float32 out, at
  least as exact as FP32 (where the card's dense FP32 sums of 512 terms
  lose ~1.3e-6 of the field's scale) and independent of the process's
  TF32 setting; the JAX package's HIGHEST is FP32, and this one takes
  1.3x the FP32 time a frame at 4096^2 on an H100 (ROADMAP.md D4). FP32
  on the CPU;
- "bf16x4": the explicit split a = hi + lo (``_bf16_terms``), four passes
  hi.hi + hi.lo + lo.hi + lo.lo;
- "bf16x3": the same split without lo.lo;
- "high": the 3-pass split too (XLA's HIGH is a bf16x3-class scheme);
- "default": one bf16 pass, hi.hi.

``hi`` is ``a`` rounded to nearest-even bf16 and ``lo = a - hi`` rounded
to bf16 for its pass, as the MXU rounds it. On CPU tensors the same
bf16-rounded operands are upcast and multiplied in FP32: the products are
exact there too, so the CPU computes the card's arithmetic and differs
only in the order of the sums. Above ``direct_max`` the four-step stages
remap the explicit split as the JAX package's ``_einsum`` does: "bf16x3"
runs the "high" scheme and "bf16x4" runs "highest".
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gfx_ocean_tpu_torch.ops.derived import sign_grid
from gfx_ocean_tpu_torch.utils import profiling
from gfx_ocean_tpu_torch.utils.device import resolve_device

_TIERS = ("bf16x3", "bf16x4", "default", "high", "highest")
# The (a term, b term) products of each bf16 tier, summed in this order.
_PASSES = {
    "default": (("hi", "hi"),),
    "high": (("hi", "hi"), ("hi", "lo"), ("lo", "hi")),
    "bf16x3": (("hi", "hi"), ("hi", "lo"), ("lo", "hi")),
    "bf16x4": (("hi", "hi"), ("hi", "lo"), ("lo", "hi"), ("lo", "lo")),
}
# The four-step stages' tier for a requested tier (JAX ``_einsum``).
_STAGE_TIER = {"bf16x3": "high", "bf16x4": "highest"}


def resolve_precision(name: str) -> str:
    """The tier's name, validated (the JAX function returns the XLA
    precision object; the port's tiers are named schemes)."""
    if name not in _TIERS:
        raise ValueError(f"unknown matmul precision {name!r}; options: {sorted(_TIERS)}")
    return name


def effective_precision(precision: str, n: Optional[int] = None, direct_max: int = 1024,
                        impl: str = "matmul", hermitian_pack: bool = True) -> str:
    """The tier that actually runs for a requested tier of an n-point
    transform (the JAX signature), suffixed with the mechanism where it
    differs from the request:

    - "matmul": the tier as requested up to ``direct_max``; above it the
      four-step stages run "bf16x3" as "high" and "bf16x4" as "highest"
      (``n`` None is read as a direct-size transform);
    - "pallas": the kernels run the JAX kernels' tiers
      (``pallas_step._make_dot``): "high", "bf16x3" and "bf16x4" the
      three-pass split, "default" one bf16 pass, "highest" FP32. The
      unpacked route (``hermitian_pack`` False at N <= 512: K4, or K5 + K6
      at "highest" above 256) runs the same tiers as the packed one, so
      ``hermitian_pack`` does not change the answer;
    - "xla": torch.fft; the tiers do not apply.
    """
    resolve_precision(precision)
    if impl == "xla":
        return "n/a (torch.fft, cuFFT on the card; precision tiers do not apply)"
    if impl == "pallas":
        if precision in ("high", "bf16x4"):
            return "bf16x3 (in-kernel bf16 split on the tensor cores: hi.hi + hi.lo + lo.hi)"
        return precision
    if n is not None and n > direct_max and precision in _STAGE_TIER:
        return ("high (3-pass bf16 split; explicit split remapped above direct_max)"
                if precision == "bf16x3" else
                "highest (full_matmul, float64 on the card; explicit split remapped above "
                "direct_max)")
    return precision


def kernel_tier(precision: str) -> str:
    """The scheme the kernels K1-K4 and their plain versions run for
    a requested tier, as ``pallas_step._make_dot`` runs it: "high" and
    "bf16x4" the three-pass split "bf16x3" (the JAX kernel drops lo.lo)."""
    resolve_precision(precision)
    return "bf16x3" if precision in ("high", "bf16x4") else precision


def kernel_passes(precision: str) -> int:
    """The bf16 passes of the kernels' tiered bodies (K1t-K4t): 3 for the
    split tiers, 1 for "default", 0 for "highest" (the FP32 FFT bodies)."""
    return {"bf16x3": 3, "default": 1, "highest": 0}[kernel_tier(precision)]


def full_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (matmul broadcasting) of float32 values in full FP32 or
    better, float32 out, without reading or writing a process-wide setting:
    on the card the products and sums run in float64 (a DGEMM on the FP64
    tensor cores), which TF32 and the float32 matmul precision do not
    touch; on the CPU, which has no TF32, in FP32 as the JAX package's CPU
    computes them (under torch's default float32 matmul precision). The
    port's one full-precision product: the "highest" tier, the kernels'
    plain versions and the renderer's sampling and projection products."""
    if a.is_cuda:
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.float32)
    return a @ b


def _bf16_terms(a: torch.Tensor, tier: str) -> dict:
    """The bf16 operands a tier's passes take: hi, ``a`` rounded to
    nearest-even bf16, and where a pass uses it lo, the exact float32
    residual ``a - hi`` rounded to bf16 for its pass (hi and the residual
    bit for bit the JAX package's ``_split_bf16``)."""
    hi = a.to(torch.bfloat16)
    if tier == "default":
        return {"hi": hi}
    return {"hi": hi, "lo": (a - hi).to(torch.bfloat16)}  # the difference in float32


class Prepared(NamedTuple):
    """An operand already in a tier's form (``prepare``): the float32
    tensor for "highest", else the dict of its bf16 terms. The DFT tables
    are kept so, once per table, device and tier."""

    value: object


def prepare(a: torch.Tensor, tier: str) -> Prepared:
    """``a`` (float32) in the form ``matmul_tier`` multiplies at ``tier``."""
    return Prepared(a if tier == "highest" else _bf16_terms(a, tier))


def transposed(p: Prepared) -> Prepared:
    """The prepared form of the transpose of a prepared 2-D operand."""
    if isinstance(p.value, dict):
        return Prepared({k: v.T for k, v in p.value.items()})
    return Prepared(p.value.T)


def wgmma_table(planes, tier: str, min_k: int = 0) -> torch.Tensor:
    """The tables W (R x K float32, one or more planes of equal shape) as
    wgmma's shared-memory B operand B = W^T, K-major without swizzle, in the
    order K2t's and K3t's wgmma stages copy into shared memory
    (``csrc/tier_mma.cuh``, ``core_at``): bf16 bits as int16 of shape
    (terms, P, K / 8, R / 8, 8, 8). For term (hi, then lo for the split
    tiers), plane p and core matrix (k / 8, r / 8), row r % 8 holds
    W[r][k - k % 8 .. k - k % 8 + 7]: 8 bf16, 16 bytes. R and K must be
    multiples of 8. With K < ``min_k`` the planes are padded with zero
    columns to K = ``min_k`` (a wgmma k-step takes 16 terms)."""
    terms = ("hi",) if tier == "default" else ("hi", "lo")
    stacked = []
    for term in terms:
        per_plane = []
        for w in planes:
            if w.shape[1] < min_k:
                w = torch.nn.functional.pad(w, (0, min_k - w.shape[1]))
            r, k = w.shape
            b = _bf16_terms(w, tier)[term]
            # W[8 rg + r8][8 kc + k8] -> [kc][rg][r8][k8]
            per_plane.append(b.reshape(r // 8, 8, k // 8, 8).permute(2, 0, 1, 3))
        stacked.append(torch.stack(per_plane))
    return torch.stack(stacked).contiguous().view(torch.int16)


def wgmma_slots(planes, tier: str) -> torch.Tensor:
    """The tables W (R x K float32, two planes of equal shape) as K1t's and
    K4t's wgmma A operand, W itself (M the rows, K-major without swizzle), cut
    into the slots their producers copy (``csrc/packed_step.cu``,
    ``csrc/unpacked_step.cu``): bf16 bits as int16 of shape (G, K / 16, P,
    terms, 2, 8, 8, 8). Slot (g, ks) holds rows 64 g .. 64 g + 63 at k =
    16 ks .. 16 ks + 15, for each plane p and term (hi, then lo for the split
    tiers) the 64 x 16 operand in ``tier::core_at``'s order: core matrix
    (k / 8, r / 8), row r % 8 holding W[64 g + r][16 ks + k - k % 8 ..] (8
    bf16). One slot is contiguous, one bulk copy. R below 64 is padded with
    zero rows to 64 (G = 1); else R must be a multiple of 64, K of 16."""
    terms = ("hi",) if tier == "default" else ("hi", "lo")
    r, k = planes[0].shape
    rows = max(r, 64)
    per_plane = []
    for w in planes:
        per_term = []
        for term in terms:
            b = torch.nn.functional.pad(_bf16_terms(w, tier)[term], (0, 0, 0, rows - r))
            # W[64 g + 8 rg + r8][16 ks + 8 kc + k8] -> [g][ks][kc][rg][r8][k8]
            per_term.append(b.reshape(rows // 64, 8, 8, k // 16, 2, 8).permute(0, 3, 4, 1, 2, 5))
        per_plane.append(torch.stack(per_term, dim=2))   # (g, ks, term, kc, rg, r8, k8)
    return torch.stack(per_plane, dim=2).contiguous().view(torch.int16)


def _bf16_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y of bf16 operands (matmul broadcasting), products exact and
    sums in FP32, float32 out: on the card a tensor-core product with
    ``out_dtype=torch.float32``; on the CPU the operands upcast to FP32."""
    if not x.is_cuda:
        return x.to(torch.float32) @ y.to(torch.float32)
    f32 = torch.float32
    if y.ndim == 2:
        out = torch.mm(x.reshape(-1, x.shape[-1]), y, out_dtype=f32)
        return out.reshape(*x.shape[:-1], y.shape[-1])
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    xb = x.expand(*batch, *x.shape[-2:]).reshape(-1, *x.shape[-2:])
    yb = y.expand(*batch, *y.shape[-2:]).reshape(-1, *y.shape[-2:])
    out = torch.bmm(xb, yb, out_dtype=f32)
    return out.reshape(*batch, *out.shape[-2:])


def matmul_tier(a, b, tier: str) -> torch.Tensor:
    """a @ b (float32 tensors or ``Prepared`` operands, matmul
    broadcasting) at a precision tier, float32 out: for "highest"
    ``full_matmul`` (float64 on the card), else the tier's bf16 passes
    summed in FP32 in the JAX package's order (hi.hi, hi.lo, lo.hi, lo.lo).
    No process-wide matmul setting is read or written."""
    pa = a.value if isinstance(a, Prepared) else prepare(a, tier).value
    pb = b.value if isinstance(b, Prepared) else prepare(b, tier).value
    if tier == "highest":
        return full_matmul(pa, pb)
    out = None
    for p, q in _PASSES[tier]:
        term = _bf16_product(pa[p], pb[q])
        out = term if out is None else out + term
    return out


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


@profiling.counted_cache(maxsize=None)
def _twiddle_table(n: int, device: torch.device) -> torch.Tensor:
    theta = (2.0 * np.pi / n) * np.arange(n // 2, dtype=np.float64)
    return torch.from_numpy(np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32)).to(device)


def _split(n: int) -> Tuple[int, int]:
    """Balanced N = N1 * N2 split with both factors powers of two."""
    log = n.bit_length() - 1
    l1 = log // 2
    return 1 << l1, 1 << (log - l1)


def _cat_complex_np(wr, wi):
    """[[Wr, -Wi], [Wi, Wr]]: one stacked real matmul = a complex matmul
    (``pallas_step._cat_complex_np``). Block rows select the (re, im) output,
    block columns the (re, im) contraction operand."""
    return np.concatenate([np.concatenate([wr, -wi], axis=1),
                           np.concatenate([wi, wr], axis=1)], axis=0)


@functools.lru_cache(maxsize=None)
def _cat_dft_np(n: int) -> Tuple[np.ndarray]:
    """The stacked n-point DFT table (2n x 2n) of ``_dft_matrix_np(n, 1)``,
    one real plane."""
    return (_cat_complex_np(*_dft_matrix_np(n, 1)),)


_TABLES = {"dft": _dft_matrix_np, "alt": _dft_matrix_out_alt_np, "twiddle": _twiddle_np,
           "cat": _cat_dft_np}


@profiling.counted_cache(maxsize=64)
def _table(key: tuple, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (real, imag) float32 table ``key`` = (kind, *args) of ``_TABLES``
    on ``device``, uploaded once. Read only: every caller shares it."""
    kind, *args = key
    return tuple(torch.from_numpy(a).to(device) for a in _TABLES[kind](*args))


@profiling.counted_cache(maxsize=64)
def _tier_table(key: tuple, device: torch.device, tier: str) -> Tuple[Prepared, Prepared]:
    """``_table(key, device)`` prepared for ``tier``, once per table."""
    return tuple(prepare(a, tier) for a in _table(key, device))


@profiling.counted_cache(maxsize=64)
def table_wgmma(key: tuple, device: torch.device, tier: str, min_k: int = 0) -> torch.Tensor:
    """``wgmma_table`` of the planes of table ``key`` on ``device`` (K padded
    to ``min_k``), made once per (table, device, tier, min_k): K2t's and
    K3t's wgmma B operand."""
    return wgmma_table(_table(key, device), tier, min_k)


@profiling.counted_cache(maxsize=64)
def table_slots(key: tuple, device: torch.device, tier: str) -> torch.Tensor:
    """``wgmma_slots`` of the planes of table ``key`` on ``device``, made
    once per (table, device, tier): K1t's and K4t's A operand."""
    return wgmma_slots(_table(key, device), tier)


def _complex_mm(xr: torch.Tensor, xi: torch.Tensor, key: tuple, tier: str, left: bool,
                real_out: bool):
    """X @ W (``left`` False, over the last axis) or W @ X (over axis -2)
    for complex X = xr + i xi and the table W of ``key``, as the JAX
    package's four real products (two for ``real_out``): each keeps its
    sums at N terms, which the card's tensor cores accumulate less exactly
    than IEEE FP32 (one [Xr | Xi] product a pass, over 2N terms, moves the
    512^2 step further from golden: ``tools/torch_precision_probe.py``).
    Each operand is prepared once. Returns (yr, yi), yi None for
    ``real_out``."""
    wr, wi = _tier_table(key, xr.device, tier)
    xr, xi = prepare(xr, tier), prepare(xi, tier)

    def mm(x, w):
        return matmul_tier(w, x, tier) if left else matmul_tier(x, w, tier)

    yr = mm(xr, wr) - mm(xi, wi)
    return yr, None if real_out else mm(xr, wi) + mm(xi, wr)


def _dft_key(n: int, fold: bool, axis: int, negate: bool = False) -> tuple:
    """The table of an n-point inverse DFT, with (-1)^(output index) and
    the Q2 flip folded in when ``fold``."""
    return ("alt", n, 1, axis, negate) if fold else ("dft", n, 1)


# --------------------------------------------------------------------------
# Plane-pair transforms.
# --------------------------------------------------------------------------

def dft_matrices(n: int, sign: int = 1,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real, imag) float32 planes of W[j, k] = exp(sign 2 pi i j k / n),
    built in float64 and rounded once, on ``device`` (the card when None)."""
    device = resolve_device(device)
    return tuple(torch.tensor(a, device=device) for a in _dft_matrix_np(n, sign))


def _check_impl(impl: str, precision: str) -> None:
    if impl not in ("matmul", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    resolve_precision(precision)


def _fold(centered: Optional[str]) -> Tuple[bool, bool]:
    if centered not in (None, "ref", "canonical"):
        raise ValueError(f"centered must be None|'ref'|'canonical', got {centered!r}")
    return centered is not None, centered == "ref"


def _direct_last(xr: torch.Tensor, xi: torch.Tensor, tier: str, real_out: bool,
                 out_alt: bool = False, negate: bool = False):
    """Dense DFT along the last axis, Y = X @ W at ``tier``; ``out_alt``
    folds (-1)^(output index) into W, ``negate`` flips the global sign."""
    key = _dft_key(xr.shape[-1], out_alt, 1, negate)
    return _complex_mm(xr, xi, key, tier, left=False, real_out=real_out)


def _foursteps_last(xr: torch.Tensor, xi: torch.Tensor, tier: str, real_out: bool,
                    out_alt: bool = False, negate: bool = False):
    """Four-step split along the last axis: O(N (N1 + N2)) as batched matmuls,
    both stages at ``tier`` remapped as the JAX ``_einsum`` remaps it.

    With k = N2 k1 + k2 and n = n1 + N1 n2:
      y[n1 + N1 n2] = sum_k2 W_N[n1 k2] (sum_k1 X[k1, k2] W_N1[n1 k1]) W_N2[n2 k2].
    ``out_alt`` folds (-1)^n = (-1)^n1 (N1 even) into the rows of W1."""
    tier = _STAGE_TIER.get(tier, tier)
    n = xr.shape[-1]
    n1, n2 = _split(n)
    batch = xr.shape[:-1]
    xr = xr.reshape(*batch, n1, n2)  # X[k1, k2]
    xi = xi.reshape(*batch, n1, n2)
    tr, ti = _table(("twiddle", n1, n2, 1), xr.device)
    ar, ai = _complex_mm(xr, xi, _dft_key(n1, out_alt, 0, negate), tier, left=True,
                         real_out=False)
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr
    # Y = B @ W2^T over k2 (W2 is symmetric), then y_flat[n1 + N1 n2] = Y[n1, n2].
    yr, yi = _complex_mm(br, bi, ("dft", n2, 1), tier, left=False, real_out=real_out)
    yr = yr.transpose(-1, -2).reshape(*batch, n)
    return yr, None if real_out else yi.transpose(-1, -2).reshape(*batch, n)


def _ifft_last(xr: torch.Tensor, xi: torch.Tensor, direct_max: int, real_out: bool,
               out_alt: bool = False, tier: str = "highest"):
    """DFT along the last axis: dense up to ``direct_max`` points, else the
    four-step split."""
    last = _direct_last if xr.shape[-1] <= direct_max else _foursteps_last
    return last(xr, xi, tier, real_out, out_alt=out_alt)


def row_pass_complex(xr: torch.Tensor, xi: torch.Tensor, direct_max: int, fold: bool,
                     precision: str = "highest"):
    """Complex DFT along the last axis, the x-half of the centering sign
    optionally folded into the output table."""
    return _ifft_last(xr, xi, direct_max, real_out=False, out_alt=fold, tier=precision)


def _col_pass(ar: torch.Tensor, ai: torch.Tensor, direct_max: int, fold: bool,
              negate: bool, real_out: bool, tier: str):
    m = ar.shape[-2]
    if m <= direct_max:
        return _complex_mm(ar, ai, _dft_key(m, fold, 0, negate), tier, left=True,
                           real_out=real_out)
    yr, yi = _foursteps_last(ar.transpose(-1, -2), ai.transpose(-1, -2), tier, real_out,
                             out_alt=fold, negate=negate)
    return yr.transpose(-1, -2), None if real_out else yi.transpose(-1, -2)


def col_pass_real(ar: torch.Tensor, ai: torch.Tensor, direct_max: int, fold: bool,
                  negate: bool, precision: str = "highest") -> torch.Tensor:
    """Real-output DFT along axis -2; folds the y-half of the centering sign
    and the reference's global Q2 flip (``negate``)."""
    return _col_pass(ar, ai, direct_max, fold, negate, True, precision)[0]


def col_pass_complex(ar: torch.Tensor, ai: torch.Tensor, direct_max: int, fold: bool,
                     negate: bool, precision: str = "highest"):
    """Complex-output DFT along axis -2, the twin of :func:`col_pass_real`."""
    return _col_pass(ar, ai, direct_max, fold, negate, False, precision)


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
    ar, ai = row_pass_complex(xr, xi, direct_max, fold, precision)
    return col_pass_real(ar, ai, direct_max, fold, negate, precision)


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
    ar, ai = row_pass_complex(xr, xi, direct_max, fold, precision)
    return col_pass_complex(ar, ai, direct_max, fold, negate, precision)


# --------------------------------------------------------------------------
# The JAX package's public helpers: 1-D planes, complex-typed 1-D / 2-D.
# --------------------------------------------------------------------------

def ifft1d_real_unnorm(xr: torch.Tensor, xi: torch.Tensor, axis: int = -1,
                       direct_max: int = 1024, precision: str = "highest") -> torch.Tensor:
    """Re(unnormalized inverse DFT) along ``axis``, plane-pair inputs."""
    _check_impl("matmul", precision)
    xr, xi = torch.movedim(xr, axis, -1), torch.movedim(xi, axis, -1)
    y = _ifft_last(xr, xi, direct_max, real_out=True, tier=precision)[0]
    return torch.movedim(y, -1, axis)


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
    x = torch.movedim(x, axis, -1)
    yr, yi = _ifft_last(x.real, x.imag, direct_max, real_out=False, tier=precision)
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
