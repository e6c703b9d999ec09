"""The unpacked fused step on the card: kernels K4, K5 and K6 for N <= 512.

Counterpart of the unpacked half of ``gfx_ocean_tpu/ops/pallas_step.py``,
the route of ``OceanConfig(fft_impl="pallas", hermitian_pack=False)``.
K4 replaces ``_step_kernel`` (the single-block kernel of ``pallas_planes``),
K5 ``_row_block_kernel`` and K6 ``_col_block_kernel`` (the row- and
column-blocked pair of ``_blocked_fields``). Per frame:

1. the unpacked propagate from h0 and its flip h0n = h0[:, ::-1, ::-1]
   (the [N-1-i] pairing, not ``roll_flip``; the kernels read h0 at the
   flipped index): cos / sin of the Dekker phase,
   the imaginary part of h0n negated under ``conj_neg``, the Q2 sign g on h,
   and k-hat from indices;
2. three complex 2-D transforms with real output, ``Re(A (X A^T))`` with
   A = D_alt W (``ops/fft._dft_matrix_out_alt_np(n, 1, 0, False)``), for
   (disp_x, height, disp_z) = ``(khx hi, -khx hr)``, ``(hr, hi)``,
   ``(khy hi, -khy hr)``. K5 is the propagate and the row pass, writing
   Y (tb, 3, 2, N, N); K6 the real-output column pass ``Re(A Y)``.

The route is ``pallas_planes``'s predicate (``unpacked_route``): the single
kernel K4 unless ``matmul_precision == "highest"`` and N > 256, where
K5 + K6 run. K4 has two bodies, as K1 has: at "highest" the FFT body, at
the other tiers the tiered body K4t, ``_step_kernel``'s products as the JAX
kernel builds them (``pallas_step._make_dot``): three bf16 passes at "high",
"bf16x3" and "bf16x4", one at "default" (``ops/fft.kernel_tier``). K5 and
K6 serve only "highest" and run FP32 there. Both routes return (3, N, N)
planes and (N, N, 3) fields; the JAX blocked route's channel-last planes
(fault F2, ``ROADMAP.md`` queue 3) are not carried. ``pallas_checksums`` reduces this route's planes outside its
kernels; here the checksum runs on the card behind K4 or K6, as K1's does
(``ocean::checksum_partials``: per-block partials, summed by the caller),
and ``ops/derived.checksums_of_planes`` serves CPU tensors only.

Two implementations sit side by side:

- ``unpacked_planes_reference`` / ``unpacked_rows_reference`` /
  ``unpacked_cols_reference``: the plain PyTorch version, written as K4's
  arithmetic: each real product one ``ops/fft.matmul_tier`` against A at
  the tier (``full_matmul`` at "highest"), A prepared once per N, device
  and tier.
- ``launch_unpacked_step`` (K4 and K4t), ``launch_unpacked_rows`` (K5),
  ``launch_unpacked_cols`` (K6): the hand-written CUDA kernels of
  ``csrc/unpacked_step.cu``. K4's FFT body, K5 and K6 run register-resident
  radix-8 FFT passes (``csrc/fft_reg.cuh``, 8 rows or 8 columns a block;
  K4 is one cooperative launch of a persistent grid that runs K5's and K6's
  device functions with one grid sync between them); K4t is K1t's design
  on the three spectra: a spectra kernel that stores the propagate in
  16-row bf16 tiles, then persistent, warp-specialized row and column
  passes of ``wgmma`` products (``csrc/tier_mma.cuh``), the table
  (``ops/fft.table_slots``, K1t's) and the tiles streamed into shared memory
  by bulk copies, Y between them as the column pass's tiles.
  ``launch_unpacked_step_checksums`` and ``launch_unpacked_cols_checksums``
  launch the checksum kernel behind them.

``unpacked_planes`` / ``unpacked_checksums`` pick by where the tensors lie:
CPU tensors take the plain version, CUDA tensors launch the kernels or
raise. Nothing falls back.

What bounds the kernels on the H100 at 512^2: a frame reads 3 MB of inputs
(once a call), writes and rereads 6 MB of Y and writes 3 MB of planes,
against ~71 MFLOP of FFT, so bytes and latency, not arithmetic; K4t's 18
products of N^3 multiply-adds a frame (4.8 GFLOP at the split) are paced by
the hand-over of its rings of table slots rather than by the tensor cores
(``csrc/unpacked_step.cu``'s note; ``PERF.md`` has the measured times).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gfx_ocean_tpu_torch import kernels
from gfx_ocean_tpu_torch.config import OceanConfig
from gfx_ocean_tpu_torch.ops.derived import checksums_of_planes, normals_scale
from gfx_ocean_tpu_torch.ops.fft import (_tier_table, effective_precision, kernel_passes,
                                         kernel_tier, matmul_tier, prepare, table_slots,
                                         transposed, twiddle_table)
from gfx_ocean_tpu_torch.ops.fourstep_step import CHECKSUM_ROWS
from gfx_ocean_tpu_torch.ops.propagate import _f32, _phase_mod_2pi, as_times

MAX_N = 512


class UnpackedInputs(NamedTuple):
    """Per-rollout hoisted inputs of K4 / K5 + K6 (all float32, one device)."""

    h0: torch.Tensor       # (2, N, N) re, im
    omega: torch.Tensor    # (N, N)
    twiddle: torch.Tensor  # (2, N/2) cos, sin of 2 pi k / N: the kernels' table


def unpacked_route(config: OceanConfig, n: int) -> str:
    """"single" (K4) or "blocked" (K5 + K6): ``pallas_planes``'s
    ``single_block`` predicate."""
    single = n <= (256 if config.matmul_precision == "highest" else 512)
    return "single" if single else "blocked"


def check_supported(config: OceanConfig, n: int) -> str:
    """Raise for grids the unpacked step does not cover; return the
    effective tier, the packed route's (``ops/fft.effective_precision``)."""
    if n > MAX_N:
        raise ValueError(f"the unpacked step takes N <= {MAX_N}, got {n}")
    return effective_precision(config.matmul_precision, n, impl="pallas", hermitian_pack=False)


def hoist_unpacked(h0_pair: torch.Tensor, omega: torch.Tensor,
                   config: OceanConfig) -> UnpackedInputs:
    """Gather the time-invariant inputs once (per rollout, not per frame)."""
    n = h0_pair.shape[-1]
    check_supported(config, n)
    dev = h0_pair.device
    return UnpackedInputs(h0_pair.to(torch.float32).contiguous(),
                          omega.to(device=dev, dtype=torch.float32).contiguous(),
                          twiddle_table(n, dev))


# --------------------------------------------------------------------------
# The plain PyTorch version.
# --------------------------------------------------------------------------

def khat_grid(n: int, domain_size: float, wrap: bool, device) -> tuple:
    """(khx, khy), each (N, N), as ``pallas_step._khat_in_kernel`` computes
    them: f32 coordinates 2i - N - 1, the uint32 wrap as a float add of
    2^32, and 1 / sqrt(kx^2 + ky^2) with a k_len > 1e-10 guard."""
    c = 2.0 * torch.arange(n, dtype=torch.float32, device=device) - float(n + 1)
    if wrap:
        c = torch.where(c < 0, c + 2.0 ** 32, c)
    k = c * _f32(np.pi / domain_size)
    kx, ky = k[None, :], k[:, None]
    k_len = torch.sqrt(kx * kx + ky * ky)
    safe = k_len > 1.0e-10
    inv = torch.where(safe, 1.0 / torch.where(safe, k_len, 1.0), 0.0)
    return kx * inv, ky * inv


def _spectra(inputs: UnpackedInputs, ts, config: OceanConfig):
    """K4's propagate for frames ts (tb,): (xr, xi), each (tb, 3, N, N) in
    the order (disp_x, height, disp_z)."""
    h0, om = inputs.h0, inputs.omega
    h0n = torch.flip(h0, dims=(-2, -1))
    phase = _phase_mod_2pi(om, as_times(ts, om.device)[:, None, None])
    c, s = torch.cos(phase), torch.sin(phase)
    h0r, h0i, h0nr, h0ni = h0[0], h0[1], h0n[0], h0n[1]
    if config.compat.conj_neg:
        h0ni = -h0ni
    g = -1.0 if config.compat.ref_sign else 1.0
    hr = g * (c * (h0r + h0nr) + s * (h0ni - h0i))
    hi = g * (s * (h0r - h0nr) + c * (h0i + h0ni))
    khx, khy = khat_grid(om.shape[-1], config.domain_size, config.compat.wrap_k, om.device)
    xr = torch.stack([khx * hi, hr, khy * hi], dim=1)
    xi = torch.stack([-khx * hr, hi, -khy * hr], dim=1)
    return xr, xi


def unpacked_rows_reference(inputs: UnpackedInputs, ts, config: OceanConfig) -> torch.Tensor:
    """Plain PyTorch row pass of K4 (and K5 at "highest"): ts (tb,) ->
    Y (tb, 3, 2, N, N), Y = X A^T as ``_step_kernel``'s four real products
    (yr = xr Ar^T - xi Ai^T, yi = xr Ai^T + xi Ar^T), each one
    ``matmul_tier`` at the tier of ``config.matmul_precision``."""
    tier = kernel_tier(config.matmul_precision)
    xr, xi = (prepare(x, tier) for x in _spectra(inputs, ts, config))
    a_re, a_im = _tier_table(("alt", inputs.omega.shape[-1], 1, 0, False), inputs.omega.device,
                             tier)  # A = D_alt W, prepared once per N, device and tier
    art, ait = transposed(a_re), transposed(a_im)

    def mm(a, b):
        return matmul_tier(a, b, tier)

    return torch.stack([mm(xr, art) - mm(xi, ait), mm(xr, ait) + mm(xi, art)], dim=2)


def unpacked_cols_reference(y: torch.Tensor, inputs: UnpackedInputs,
                            precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch column pass of K4 (and K6 at "highest"): Y (tb, 3, 2,
    N, N) -> (tb, 3, N, N) = Re(A Y) = Ar yr - Ai yi, Y split again for the
    tier of ``precision``."""
    tier = kernel_tier(precision)
    a_re, a_im = _tier_table(("alt", inputs.omega.shape[-1], 1, 0, False), inputs.omega.device,
                             tier)
    yr, yi = prepare(y[:, :, 0], tier), prepare(y[:, :, 1], tier)
    return matmul_tier(a_re, yr, tier) - matmul_tier(a_im, yi, tier)


def unpacked_planes_reference(inputs: UnpackedInputs, ts,
                              config: OceanConfig) -> torch.Tensor:
    """Plain PyTorch K4: ts (tb,) -> (tb, 3, N, N) (disp_x, height, disp_z)
    at the tier of ``config.matmul_precision``."""
    return unpacked_cols_reference(unpacked_rows_reference(inputs, ts, config), inputs,
                                   config.matmul_precision)


# --------------------------------------------------------------------------
# The CUDA kernels.
# --------------------------------------------------------------------------

def _checked(inputs: UnpackedInputs, who: str) -> int:
    """Check the hoisted inputs for a launch; return N."""
    dev = kernels.cuda_device(inputs.omega, who)
    n = inputs.omega.shape[-1]
    if n < 16 or n > MAX_N or n & (n - 1):
        raise ValueError(f"{who} takes a power of two N in [16, {MAX_N}], got {n}")
    shapes = dict(h0=(2, n, n), omega=(n, n), twiddle=(2, n // 2))
    for name, x in inputs._asdict().items():
        kernels.check_tensor(name, x, torch.float32, shapes[name], dev)
    return n


def _propagate_args(inputs: UnpackedInputs, ts: torch.Tensor, config: OceanConfig) -> tuple:
    """The C entry points' leading arguments, through g."""
    n = inputs.omega.shape[-1]
    return (inputs.h0.data_ptr(), inputs.omega.data_ptr(),
            inputs.twiddle.data_ptr(), ts.data_ptr(), ts.shape[0], n,
            _f32(np.pi / config.domain_size), int(config.compat.wrap_k),
            int(config.compat.conj_neg), -1.0 if config.compat.ref_sign else 1.0)


def _fft_only(config: OceanConfig, who: str) -> None:
    """K5 and K6 run FP32 FFTs: the blocked route takes them at "highest"
    only, so another tier raises rather than computing another function
    than its plain version."""
    if kernel_tier(config.matmul_precision) != "highest":
        raise ValueError(f"{who} runs the FP32 FFT body (the blocked route's \"highest\"), "
                         f"not the {config.matmul_precision!r} tier")


def launch_unpacked_rows(inputs: UnpackedInputs, ts, config: OceanConfig) -> torch.Tensor:
    """Launch K5 on the current stream: ts (tb,) -> Y (tb, 3, 2, N, N), at
    "highest" only. Counts ``launches.launch_unpacked_rows`` per launch
    (``kernels.launch``)."""
    n = _checked(inputs, "launch_unpacked_rows")
    check_supported(config, n)
    _fft_only(config, "launch_unpacked_rows (K5)")
    dev = inputs.omega.device
    ts = as_times(ts, dev)
    y = torch.empty((ts.shape[0], 3, 2, n, n), dtype=torch.float32, device=dev)
    kernels.launch("launch_unpacked_rows", "unpacked_step", "unpacked_rows",
                   *_propagate_args(inputs, ts, config), y.data_ptr(), device=dev)
    return y


def _checksum_args(config: Optional[OceanConfig], tb: int, n: int, dev) -> tuple:
    """(partials or None, the C entry points' checksum arguments): per-block
    partials (tb, N / CHECKSUM_ROWS) when ``config`` is given, else none."""
    if config is None:
        return None, (None, CHECKSUM_ROWS, 0.0, 0)
    partials = torch.empty((tb, n // CHECKSUM_ROWS), dtype=torch.float32, device=dev)
    nscale = normals_scale(config)
    return partials, (partials.data_ptr(), CHECKSUM_ROWS,
                      nscale if nscale is not None else 0.0, int(nscale is not None))


def launch_unpacked_cols_checksums(
        y: torch.Tensor, inputs: UnpackedInputs,
        config: Optional[OceanConfig]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K6 on the current stream and, given a config, the checksum
    kernel behind it: Y (tb, 3, 2, N, N) -> ``(planes, partials)``, planes
    (tb, 3, N, N) and the per-block checksum partials
    (tb, N / CHECKSUM_ROWS), or None without a config. Counts
    ``launches.launch_unpacked_cols`` per launch (``kernels.launch``)."""
    n = _checked(inputs, "launch_unpacked_cols")
    dev = inputs.omega.device
    if y.ndim != 5:
        raise ValueError(f"y: expected shape (tb, 3, 2, N, N), got {tuple(y.shape)}")
    tb = y.shape[0]
    kernels.check_tensor("y", y, torch.float32, (tb, 3, 2, n, n), dev)
    planes = torch.empty((tb, 3, n, n), dtype=torch.float32, device=dev)
    partials, ck_args = _checksum_args(config, tb, n, dev)
    kernels.launch("launch_unpacked_cols", "unpacked_step", "unpacked_cols",
                   y.data_ptr(), inputs.twiddle.data_ptr(), tb, n, planes.data_ptr(), *ck_args,
                   device=dev)
    return planes, partials


def launch_unpacked_cols(y: torch.Tensor, inputs: UnpackedInputs) -> torch.Tensor:
    """K6 alone: Y (tb, 3, 2, N, N) -> planes (tb, 3, N, N)."""
    return launch_unpacked_cols_checksums(y, inputs, None)[0]


def launch_unpacked_step_checksums(
        inputs: UnpackedInputs, ts, config: OceanConfig,
        checksum: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K4 on the current stream and, when ``checksum``, the checksum
    kernel behind it: ts (tb,) -> ``(planes, partials)``, planes
    (tb, 3, N, N) and the per-block checksum partials (tb, N / CHECKSUM_ROWS),
    or None. At "highest" the FFT body (one cooperative launch, Y its
    scratch); at the other tiers the tiered body K4t (the spectra kernel,
    then the row and the column pass; its scratch holds the spectra's and
    Y's bf16 tiles, as large as Y for each bf16 term). Counts
    ``launches.launch_unpacked_step`` per launch of either body and
    ``tiered_launches.launch_unpacked_step`` per launch of K4t
    (``kernels.launch``)."""
    n = _checked(inputs, "launch_unpacked_step")
    check_supported(config, n)
    dev = inputs.omega.device
    ts = as_times(ts, dev)
    tb = ts.shape[0]
    tier = kernel_tier(config.matmul_precision)
    passes = kernel_passes(tier)
    # the FFT body's Y; the tiered body's tiles of the spectra, then Y's
    terms = 2 if passes == 3 else 1
    y = torch.empty((tb * terms, 3, 2, n, n), dtype=torch.float32, device=dev)
    planes = torch.empty((tb, 3, n, n), dtype=torch.float32, device=dev)
    partials, ck_args = _checksum_args(config if checksum else None, tb, n, dev)
    table = table_slots(("alt", n, 1, 0, False), dev, tier) if passes else None
    kernels.launch("launch_unpacked_step", "unpacked_step", "unpacked_step",
                   *_propagate_args(inputs, ts, config), y.data_ptr(), planes.data_ptr(),
                   *ck_args, passes, kernels.ptr(table), device=dev, tiered=passes > 0)
    return planes, partials


def launch_unpacked_step(inputs: UnpackedInputs, ts, config: OceanConfig) -> torch.Tensor:
    """K4 alone: ts (tb,) -> planes (tb, 3, N, N)."""
    return launch_unpacked_step_checksums(inputs, ts, config, checksum=False)[0]


def unpacked_planes(inputs: UnpackedInputs, ts, config: OceanConfig) -> torch.Tensor:
    """Planes (tb, 3, N, N) for ts (tb,): K4 on the single route, K5 + K6 on
    the blocked one; the kernels on CUDA, the plain version on CPU."""
    if not inputs.omega.is_cuda:
        return unpacked_planes_reference(inputs, ts, config)
    if unpacked_route(config, inputs.omega.shape[-1]) == "single":
        return launch_unpacked_step(inputs, ts, config)
    return launch_unpacked_cols(launch_unpacked_rows(inputs, ts, config), inputs)


def unpacked_checksums(inputs: UnpackedInputs, ts, config: OceanConfig) -> torch.Tensor:
    """Checksums (tb,) for ts (tb,). On CUDA the checksum kernel runs behind
    K4 (or K6 on the blocked route) and its per-block partials are summed by
    ``torch.sum``, in an order fixed by their shape; on CPU
    ``checksums_of_planes`` of the plain version's planes."""
    if not inputs.omega.is_cuda:
        return checksums_of_planes(unpacked_planes_reference(inputs, ts, config), config)
    if unpacked_route(config, inputs.omega.shape[-1]) == "single":
        partials = launch_unpacked_step_checksums(inputs, ts, config)[1]
    else:
        partials = launch_unpacked_cols_checksums(launch_unpacked_rows(inputs, ts, config),
                                                  inputs, config)[1]
    return partials.sum(dim=-1)
