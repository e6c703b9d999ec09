"""The four-step ocean step for 1024 <= N <= 16384 (kernels K2 + K3) on the card.

Counterpart of the four-step half of ``gfx_ocean_tpu/ops/pallas_step.py``
(``:568-1192``). K2 replaces ``_fourstep_row_kernel`` (launched by
``_fourstep_row_call``), K3 ``_fourstep_col_kernel`` (``_fourstep_col_call``).
Per frame:

- K2, the row pass: the packed propagate of ``ops/propagate.packed_spectra``
  with ``half = +0.5`` (unlike K1, the Q2 flip is not folded here), then the
  complex x-transform of H and Z with (-1)^x folded in. Its contract is
  Y (tb, 2, 2, rows, N) = ((Re, Im) of F_x(H), (Re, Im) of F_x(Z)) in true
  x order, on ``rows`` rows from the global row ``row_base`` (0 on one
  device; the row-sharded caller of ``parallel/distributed_fft.py`` passes
  its band's base, and the band's two windows of the state,
  ``ops/propagate.BandWindows``, in place of the whole state).
- K3, the column pass: the y-transform of Y with (-1)^y and the Q2 flip
  folded in: (tb, 3, N, C) = (disp_x, height, disp_z), height = Re F(H),
  disp_x / disp_z = Re / Im F(Z); optionally the forcing checksum.

The JAX kernels read x-permuted hoisted planes so that stage 1 is a free
view on the MXU (``_fourstep_permute_inputs``); that is a TPU layout
device. Here K2 reads the state itself (h0 and omega of the whole grid: a
row's partners under the flip and rho lie outside any band; or, for a band
of a row-sharded grid, the two windows of R + 1 rows that hold them), as K1
does, and the contract is pinned in true order.

Two implementations sit side by side:

- ``fourstep_row_reference`` / ``fourstep_col_reference``: the plain
  PyTorch version, matmuls against the same stacked tables as the JAX
  kernels (``fourstep_tables``: W1cat, the twiddle, W2cat or its block
  diagonal, W2top), FP32 with TF32 off. A dense N-point DFT table would
  cost ~2 TFLOP a frame at 4096^2; the factored tables ~0.1.
- ``launch_fourstep_row`` / ``launch_fourstep_col``: the hand-written CUDA
  kernels of ``csrc/fourstep_step.cu`` (K2 a register-resident radix-8
  FFT a row, one block a row up to 8192; at 16384, where a row's 2,048
  threads and 295 KB exchange buffer outgrow one block, a radix-2 split in
  registers, one swap between the two blocks of a thread-block cluster and
  an 8192-point FFT in each block; K3 the column transform split 128 x N/128,
  each stage register-resident passes of 32-column bands, with one
  device-memory round trip between them). At the tiers other than
  "highest" the tiered bodies K2t and K3t run the JAX kernels' bf16
  products on the tensor cores (wgmma, a warp-specialized stage 1); K2t
  runs its stage 2 in the same kernel at N <= 4096 and both go through a
  scratch otherwise.

``fourstep_planes`` / ``fourstep_checksums`` pick by where the tensors lie:
CPU tensors take the plain version, CUDA tensors launch the kernels or
raise. Nothing falls back: where K2's cluster cannot be scheduled the
launch raises. Each call is two spans of ``utils/profiling.py``, timed by
CUDA events on the state's device: ``fourstep.rows`` (K2, or its plain
version) and ``fourstep.cols`` (K3 and the partials' sum, or their plain
versions); each K2 launch whose tiered stage 2 runs from the scratch
(``row_stage2_in_block`` false) adds one to the counter
``fourstep.row_scratch``. At 16384^2 the plain version takes a band of rows
(``fourstep_row_reference``'s ``row_base`` / ``rows``) or of columns (a
column slice of Y); on the whole grid it would need tens of GB.

What bounds K2 + K3 on the H100 at 4096^2 (tb = 1): ~1.5 GB of device
memory traffic a frame (the 201 MB state, Y and the column pass's scratch
each written and read once, the planes written, the height read again by
the checksum) against ~5 GFLOP, so bandwidth; ``PERF.md`` has the measured
split.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gfx_ocean_tpu_torch import kernels
from gfx_ocean_tpu_torch.config import OceanConfig
from gfx_ocean_tpu_torch.ops.derived import checksums_of_planes, normals_scale
from gfx_ocean_tpu_torch.ops.fft import (Prepared, _cat_complex_np, _dft_matrix_np,
                                         _dft_matrix_out_alt_np, _table, _twiddle_np,
                                         effective_precision, kernel_passes, kernel_tier,
                                         matmul_tier, prepare, table_wgmma,
                                         twiddle_table)
from gfx_ocean_tpu_torch.ops.propagate import (BandWindows, _f32, as_times,
                                               gather_packed_planes, packed_spectra)
from gfx_ocean_tpu_torch.utils import profiling

MIN_N = 1024
# Largest N the kernels take: the plan's range.
MAX_KERNEL_N = 16384
# Rows of the output reduced by one block of the checksum kernel.
CHECKSUM_ROWS = 4
# Columns per K3 block (csrc/fourstep_step.cu, kColCols).
COL_BAND = 32


class FourstepInputs(NamedTuple):
    """Per-rollout inputs of K2 + K3 (all float32, one device): the state
    itself, the whole grid (None for a row band, whose K2 reads its
    ``BandWindows``)."""

    h0: Optional[torch.Tensor]     # (2, N, N) re, im
    omega: Optional[torch.Tensor]  # (N, N)
    twiddle: torch.Tensor          # (2, N/2) cos, sin of 2 pi k / N: the kernels' table


def fourstep_plan(n: int, config: OceanConfig) -> Tuple[int, int, int, int]:
    """(n1, n2, row band, column band) of ``pallas_step._fourstep_plan``.

    The same split and the same ``ValueError`` outside [1024, 16384]; the
    TPU's HBM warning at 16384 does not apply to an 80 GB card. The bands
    are the TPU kernels' block sizes, kept for the record: the CUDA kernels
    choose their own."""
    n1 = 128
    n2 = n // n1
    block, cblock = 16, 128
    if n % block or n % cblock or n2 < 8 or n2 > 128:
        raise ValueError(
            f"four-step pallas pipeline supports N in [1024, 16384], got {n}")
    return n1, n2, block, cblock


def check_supported(config: OceanConfig, n: int) -> str:
    """Raise for grids the four-step route does not cover (the plan's
    ``ValueError`` outside [1024, 16384]); return the tier."""
    fourstep_plan(n, config)
    return effective_precision(config.matmul_precision, n, impl="pallas")


@functools.lru_cache(maxsize=None)
def fourstep_tables(n: int, n1: int, n2: int, negate: bool):
    """Numpy copy of ``pallas_step._fourstep_tables``.

    Row: (W1cat (2n1, 2n1), stage-2 table, Ttr, Tti (n2, n1)); col: (W1cat
    with (-1)^n1 and the Q2 flip when ``negate``, stage-2 table, W2top
    (n2, 2n2), Ttr, Tti (n1, n2)). When 4 n2 <= 128 the stage-2 tables are
    block diagonal: diag(W2cat, W2cat) (4n2, 4n2) for the row pass and
    diag(W2top, W2cat) (3n2, 4n2) for the column pass."""
    w1_row = _cat_complex_np(*_dft_matrix_out_alt_np(n1, 1, 0, False))
    w1_col = _cat_complex_np(*_dft_matrix_out_alt_np(n1, 1, 0, negate))
    w2r, w2i = _dft_matrix_np(n2, 1)
    w2cat = _cat_complex_np(w2r, w2i)
    w2top = w2cat[:n2]
    if 4 * n2 <= 128:
        z22 = np.zeros((2 * n2, 2 * n2), w2cat.dtype)
        w2_row = np.block([[w2cat, z22], [z22, w2cat]])
        w2_col = np.block([[w2top, np.zeros((n2, 2 * n2), w2cat.dtype)],
                           [z22, w2cat]])
    else:
        w2_row, w2_col = w2cat, w2cat
    ttr_row, tti_row = _twiddle_np(n2, n1, 1)
    ttr, tti = _twiddle_np(n1, n2, 1)
    return ((w1_row, w2_row, ttr_row, tti_row),
            (w1_col, w2_col, w2top, ttr, tti))


@profiling.counted_cache(maxsize=None)
def _device_tables(n: int, negate: bool, device: torch.device, tier: str = "highest"):
    """``fourstep_tables`` on ``device``, made once per tier: the DFT tables
    ``prepare``d for ``tier`` (W1cat transposed for the row pass's
    X W1cat^T), the twiddles float32."""
    n1, n2 = 128, n // 128
    row, col = fourstep_tables(n, n1, n2, negate)
    row, col = ([torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in tabs]
                for tabs in (row, col))
    row[0] = row[0].T
    return (tuple(prepare(a, tier) for a in row[:2]) + tuple(row[2:]),
            tuple(prepare(a, tier) for a in col[:3]) + tuple(col[3:]))


def hoist_fourstep(h0_pair: torch.Tensor, omega: torch.Tensor,
                   config: OceanConfig) -> FourstepInputs:
    """The time-invariant inputs (per rollout, not per frame): a float32
    contiguous state as it is, and the twiddle table made once per N and
    device. Copies nothing and launches nothing."""
    n = h0_pair.shape[-1]
    check_supported(config, n)
    dev = h0_pair.device
    return FourstepInputs(h0_pair.to(torch.float32).contiguous(),
                          omega.to(device=dev, dtype=torch.float32).contiguous(),
                          twiddle_table(n, dev))


def _band(n: int, row_base: int, rows: Optional[int],
          windows: Optional[BandWindows] = None) -> int:
    """The band's row count (all rows when None); raises outside the grid,
    and for windows of another band."""
    rows = n - row_base if rows is None else rows
    if rows < 1 or not 0 <= row_base <= n - rows:
        raise ValueError(f"rows {row_base}..{row_base + rows - 1} lie outside the {n}-row grid")
    if windows is not None and tuple(windows.omega.shape) != (2 * rows + 2, n):
        raise ValueError(f"windows: expected 2 x {rows + 1} rows of {n}, got "
                         f"{tuple(windows.omega.shape)}")
    return rows


# --------------------------------------------------------------------------
# The plain PyTorch version.
# --------------------------------------------------------------------------

def fourstep_row_reference(inputs: FourstepInputs, ts, config: OceanConfig,
                           row_base: int = 0, rows: Optional[int] = None,
                           windows: Optional[BandWindows] = None) -> torch.Tensor:
    """Plain PyTorch K2: ts (tb,) -> Y (tb, 2, 2, rows, N) in true x order,
    on ``rows`` rows (default: to the last) from the global row ``row_base``,
    read from the whole state or from the band's ``windows``.

    With k = n2 k1 + k2 and x = n1 + 128 n2 (``ops/fft._foursteps_last``):
    stage 1 over k1 against W1cat, the twiddle T[k2, n1], stage 2 over k2
    against W2cat (or diag(W2cat, W2cat), both spectra in one matmul). Each
    stacked product is one ``matmul_tier`` at the tier of
    ``config.matmul_precision`` (``ops/fft.kernel_tier``), as the JAX
    kernel's ``_make_dot`` runs it; the twiddle is FP32."""
    dev = inputs.twiddle.device
    n = 2 * inputs.twiddle.shape[-1]
    rows = _band(n, row_base, rows, windows)
    n1, n2, _, _ = fourstep_plan(n, config)
    tier = kernel_tier(config.matmul_precision)
    (w1t, w2, ttr, tti), _ = _device_tables(n, config.compat.ref_sign, dev, tier)
    ts = as_times(ts, dev)
    tb = ts.shape[0]
    pre, pre_rho, om_band, omq = gather_packed_planes(inputs.h0, inputs.omega,
                                                      config.compat.conj_neg, rows, row_base,
                                                      windows)
    h_r, h_i, z_r, z_i = packed_spectra(pre, pre_rho, om_band, omq, ts, config.domain_size,
                                        config.compat.wrap_k, 0.5, row_base)

    def stage12(xr, xi):
        # (tb, rows, N) -> (tb, rows, k2, [k1 of re | k1 of im])
        x = torch.cat([xr.reshape(tb, rows, n1, n2).transpose(-1, -2),
                       xi.reshape(tb, rows, n1, n2).transpose(-1, -2)], dim=-1)
        a = matmul_tier(x, w1t, tier)                  # (tb, rows, k2, [n1 | n1])
        ar, ai = a[..., :n1], a[..., n1:]
        return ar * ttr - ai * tti, ar * tti + ai * ttr  # (tb, rows, k2, n1)

    bh = stage12(h_r, h_i)
    bz = stage12(z_r, z_i)
    if _rows_of(w2) == 4 * n2:
        parts = matmul_tier(w2, torch.cat([*bh, *bz], dim=-2), tier).split(n2, dim=-2)
    else:
        parts = (matmul_tier(w2, torch.cat(bh, dim=-2), tier).split(n2, dim=-2)
                 + matmul_tier(w2, torch.cat(bz, dim=-2), tier).split(n2, dim=-2))
    # each (tb, rows, n2, n1) -> (tb, rows, N): x = n2 * 128 + n1
    return torch.stack([p.reshape(tb, rows, n) for p in parts], dim=1).reshape(
        tb, 2, 2, rows, n)


def _rows_of(w2: Prepared) -> int:
    """Rows of a prepared stage-2 table: 4 n2 (row pass) or 3 n2 (column
    pass) when block diagonal, else 2 n2."""
    v = w2.value
    return (v["hi"] if isinstance(v, dict) else v).shape[0]


def fourstep_col_reference(y: torch.Tensor, config: OceanConfig) -> torch.Tensor:
    """Plain PyTorch K3: Y (tb, 2, 2, N, C) -> (tb, 3, N, C) = (disp_x,
    height, disp_z), rows in true y order.

    With m = n2 m1 + m2 and y = n1 + 128 n2: stage 1 over m1 against W1cat
    (the (-1)^y sign and the Q2 flip folded in), the twiddle T[n1, m2],
    stage 2 over m2: height through W2top, Z through W2cat (or both through
    diag(W2top, W2cat)); each product at the tier, as in
    :func:`fourstep_row_reference`."""
    tb, _, _, n, c = y.shape
    n1, n2, _, _ = fourstep_plan(n, config)
    tier = kernel_tier(config.matmul_precision)
    _, (w1, w2, w2top, ttr, tti) = _device_tables(n, config.compat.ref_sign, y.device, tier)

    def stages(yr, yi):
        a = matmul_tier(w1, torch.cat([yr.reshape(tb, n1, n2 * c),
                                       yi.reshape(tb, n1, n2 * c)], dim=1), tier)
        ar = a[:, :n1].reshape(tb, n1, n2, c)
        ai = a[:, n1:].reshape(tb, n1, n2, c)
        br = ar * ttr[..., None] - ai * tti[..., None]
        bi = ar * tti[..., None] + ai * ttr[..., None]
        return (br.transpose(1, 2).reshape(tb, n2, n1 * c),
                bi.transpose(1, 2).reshape(tb, n2, n1 * c))

    bh = stages(y[:, 0, 0], y[:, 0, 1])
    bz = stages(y[:, 1, 0], y[:, 1, 1])
    if _rows_of(w2) == 3 * n2:
        h_out, x_out, z_out = matmul_tier(w2, torch.cat([*bh, *bz], dim=1),
                                          tier).split(n2, dim=1)
    else:
        h_out = matmul_tier(w2top, torch.cat(bh, dim=1), tier)
        x_out, z_out = matmul_tier(w2, torch.cat(bz, dim=1), tier).split(n2, dim=1)
    # each (tb, n2, n1 * C) -> (tb, N, C): y = n2 * 128 + n1
    return torch.stack([x_out, h_out, z_out], dim=1).reshape(tb, 3, n, c)


def fourstep_planes_reference(inputs: FourstepInputs, ts,
                              config: OceanConfig) -> torch.Tensor:
    """Plain PyTorch K2 + K3: ts (tb,) -> (tb, 3, N, N)."""
    return fourstep_col_reference(fourstep_row_reference(inputs, ts, config), config)


def fourstep_checksums_reference(inputs: FourstepInputs, ts,
                                 config: OceanConfig) -> torch.Tensor:
    """Plain PyTorch K2 + K3 checksums: ts (tb,) -> (tb,)."""
    return checksums_of_planes(fourstep_planes_reference(inputs, ts, config), config)


# --------------------------------------------------------------------------
# The CUDA kernels.
# --------------------------------------------------------------------------

def _check_kernel_n(n: int, who: str) -> None:
    if n < MIN_N or n > MAX_KERNEL_N or n & (n - 1):
        raise ValueError(f"{who} takes a power of two N in [{MIN_N}, {MAX_KERNEL_N}], got {n}")


def _tier_inputs(n: int, config: OceanConfig, dev: torch.device, side: str) -> tuple:
    """The tiered body's arguments of a K2 ("row") or K3 ("col") launch:
    (passes, W1's wgmma table, W2's, Ttr, Tti); passes 0 (the FFT body, at
    "highest") with null tables. W1 is the 128-point table of
    ``fourstep_tables`` (the column pass's with the Q2 flip folded in), the
    twiddles ``fourstep_tables``' own. W2 is the stacked N2-point table
    W2cat where K2's stage 2 runs in its stage-1 kernel (N <= 4096,
    ``row_stage2_in_block``), else the N2-point table's two planes, K
    padded to one 16-term k-step."""
    tier = kernel_tier(config.matmul_precision)
    passes = kernel_passes(tier)
    if not passes:
        return (0, None, None, None, None)
    n2 = n // 128
    negate = side == "col" and config.compat.ref_sign
    twiddle = ("twiddle", n2, 128, 1) if side == "row" else ("twiddle", 128, n2, 1)
    ttr, tti = _table(twiddle, dev)
    w2 = (table_wgmma(("cat", n2), dev, tier) if side == "row" and row_stage2_in_block(n)
          else table_wgmma(("dft", n2, 1), dev, tier, 16))
    return (passes, table_wgmma(("alt", 128, 1, 0, negate), dev, tier).data_ptr(),
            w2.data_ptr(), ttr.data_ptr(), tti.data_ptr())


def row_stage2_in_block(n: int) -> bool:
    """Whether K2's tiered body runs its stage 2 in its stage-1 kernel (a
    stage-1 item holds whole rows, and the stage-2 tiles fit beside W1),
    with no scratch: N <= 4096 (``csrc/fourstep_step.cu``, Stage1Smem)."""
    return n <= 4096


def launch_fourstep_row(inputs: FourstepInputs, ts, config: OceanConfig,
                        row_base: int = 0, rows: Optional[int] = None,
                        windows: Optional[BandWindows] = None) -> torch.Tensor:
    """Launch K2 on the current stream: ts (tb,) -> Y (tb, 2, 2, rows, N) on
    ``rows`` rows (default: to the last) from the global row ``row_base``,
    reading the whole state or, with ``windows``, the band's two windows
    (``fourstep_row_windows``; the same Y bit for bit). At N = 16384 the
    kernel splits a row over a two-block cluster, and raises where the
    device cannot schedule one.

    At "highest" the FFT body runs; at the other tiers the tiered body, the
    JAX kernel's bf16 passes on the tensor cores (``ops/fft.kernel_tier``).
    Counts ``launches.launch_fourstep_row`` per launch of either body and
    ``tiered_launches.launch_fourstep_row`` per launch of the tiered body
    (``kernels.launch``), and ``fourstep.row_scratch`` in the recorded unit
    per launch whose tiered stage 2 runs from the scratch."""
    dev = kernels.cuda_device(inputs.twiddle, "launch_fourstep_row")
    n = 2 * inputs.twiddle.shape[-1]
    _check_kernel_n(n, "K2")
    check_supported(config, n)
    rows = _band(n, row_base, rows, windows)
    kernels.check_tensor("twiddle", inputs.twiddle, torch.float32, (2, n // 2), dev)
    if windows is None:
        kernels.check_tensor("h0", inputs.h0, torch.float32, (2, n, n), dev)
        kernels.check_tensor("omega", inputs.omega, torch.float32, (n, n), dev)
    else:
        kernels.check_tensor("windows.h0", windows.h0, torch.float32, (2 * rows + 2, 2, n), dev)
        kernels.check_tensor("windows.omega", windows.omega, torch.float32, (2 * rows + 2, n),
                             dev)
    ts = as_times(ts, dev)
    tb = ts.shape[0]
    y = torch.empty((tb, 2, 2, rows, n), dtype=torch.float32, device=dev)
    tier = _tier_inputs(n, config, dev, "row")
    scratch = torch.empty_like(y) if tier[0] and not row_stage2_in_block(n) else None
    state = inputs if windows is None else windows
    kernels.launch(
        "launch_fourstep_row", "fourstep_step",
        "fourstep_row" if windows is None else "fourstep_row_windows",
        state.h0.data_ptr(), state.omega.data_ptr(), inputs.twiddle.data_ptr(), ts.data_ptr(),
        tb, n, rows, row_base, _f32(np.pi / config.domain_size), int(config.compat.wrap_k),
        int(config.compat.conj_neg), y.data_ptr(), *tier, kernels.ptr(scratch),
        device=dev, tiered=tier[0] > 0)
    if scratch is not None:
        profiling.count("fourstep.row_scratch")
    return y


def launch_fourstep_col(y: torch.Tensor, twiddle: torch.Tensor, config: OceanConfig,
                        checksum: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K3 on the current stream: Y (tb, 2, 2, N, C) -> ``(planes,
    partials)``, planes (tb, 3, N, C) and, when ``checksum`` (C = N), the
    per-block checksum partials, else None: (tb, P + Q), the second stage's
    P = (N / 128) (C / COL_BAND) sums of the planes and, when the config
    computes normals, the Q = N / CHECKSUM_ROWS sums of the normals' terms.
    The caller sums them over the last axis.

    The kernel's first stage writes a scratch as large as Y. The body is
    chosen by the tier as in :func:`launch_fourstep_row`. Counts
    ``launches.launch_fourstep_col`` per launch of either body and
    ``tiered_launches.launch_fourstep_col`` per launch of the tiered body
    (``kernels.launch``)."""
    dev = kernels.cuda_device(y, "launch_fourstep_col")
    if y.ndim != 5 or tuple(y.shape[1:3]) != (2, 2):
        raise ValueError(f"y: expected shape (tb, 2, 2, N, C), got {tuple(y.shape)}")
    tb, _, _, n, c = y.shape
    _check_kernel_n(n, "K3")
    check_supported(config, n)
    if c % COL_BAND or (checksum and c != n):
        raise ValueError(f"K3 takes a multiple of {COL_BAND} columns, all N of them "
                         f"for the checksum; got {c} of {n}")
    kernels.check_tensor("y", y, torch.float32, (tb, 2, 2, n, c), dev)
    kernels.check_tensor("twiddle", twiddle, torch.float32, (2, n // 2), dev)
    scratch = torch.empty_like(y)
    planes = torch.empty((tb, 3, n, c), dtype=torch.float32, device=dev)
    nscale = normals_scale(config)
    tier = _tier_inputs(n, config, dev, "col")
    # stage 2's sums: one a block, (n / 128) per column band, 128 tiered
    n_partials = ((128 if tier[0] else n // 128) * (c // COL_BAND)
                  + (n // CHECKSUM_ROWS if nscale is not None else 0))
    partials = (torch.empty((tb, n_partials), dtype=torch.float32, device=dev)
                if checksum else None)
    kernels.launch(
        "launch_fourstep_col", "fourstep_step", "fourstep_col",
        y.data_ptr(), scratch.data_ptr(), twiddle.data_ptr(), tb, n, c,
        -1.0 if config.compat.ref_sign else 1.0, planes.data_ptr(), kernels.ptr(partials),
        CHECKSUM_ROWS, nscale if nscale is not None else 0.0, int(nscale is not None), *tier,
        device=dev, tiered=tier[0] > 0)
    return planes, partials


def launch_fourstep_step(inputs: FourstepInputs, ts, config: OceanConfig,
                         checksum: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2 then K3 for ts (tb,): ``(planes (tb, 3, N, N), partials or None)``."""
    y = launch_fourstep_row(inputs, ts, config)
    return launch_fourstep_col(y, inputs.twiddle, config, checksum)


def fourstep_row(inputs: FourstepInputs, ts, config: OceanConfig, row_base: int = 0,
                 rows: Optional[int] = None,
                 windows: Optional[BandWindows] = None) -> torch.Tensor:
    """K2's Y for ts (tb,) on a band (see :func:`launch_fourstep_row`): the
    kernel on CUDA, the plain version on CPU."""
    if inputs.twiddle.is_cuda:
        return launch_fourstep_row(inputs, ts, config, row_base, rows, windows)
    return fourstep_row_reference(inputs, ts, config, row_base, rows, windows)


def fourstep_col(y: torch.Tensor, twiddle: torch.Tensor, config: OceanConfig) -> torch.Tensor:
    """K3's planes (tb, 3, N, C) of Y (tb, 2, 2, N, C), without the
    checksum: the kernel on CUDA, the plain version on CPU. No column's
    output depends on which columns Y holds, so a column band of a
    row-sharded grid takes it as it is."""
    if y.is_cuda:
        return launch_fourstep_col(y, twiddle, config, checksum=False)[0]
    return fourstep_col_reference(y, config)


def _rows_then_cols(inputs: FourstepInputs, ts, config: OceanConfig,
                    checksum: bool) -> torch.Tensor:
    """K2 in the span ``fourstep.rows``, then K3 and, with ``checksum``, the
    partials' sum in ``fourstep.cols`` (the plain versions on CPU tensors):
    the planes (tb, 3, N, N) or the checksums (tb,)."""
    dev = inputs.twiddle.device
    with profiling.span("fourstep.rows", device=dev):
        y = fourstep_row(inputs, ts, config)
    with profiling.span("fourstep.cols", device=dev):
        if not checksum:
            return fourstep_col(y, inputs.twiddle, config)
        if y.is_cuda:
            return launch_fourstep_col(y, inputs.twiddle, config, checksum=True)[1].sum(dim=-1)
        return checksums_of_planes(fourstep_col_reference(y, config), config)


def fourstep_planes(inputs: FourstepInputs, ts, config: OceanConfig) -> torch.Tensor:
    """K2 + K3 planes for ts (tb,): the kernels on CUDA, the plain version
    on CPU, in the spans ``fourstep.rows`` and ``fourstep.cols``."""
    return _rows_then_cols(inputs, ts, config, checksum=False)


def fourstep_checksums(inputs: FourstepInputs, ts, config: OceanConfig) -> torch.Tensor:
    """K2 + K3 checksums for ts (tb,): the kernels on CUDA, the plain
    version on CPU, in the spans ``fourstep.rows`` and ``fourstep.cols``.
    On CUDA the per-block partials are summed outside the kernel by
    ``torch.sum``, in an order fixed by their shape."""
    return _rows_then_cols(inputs, ts, config, checksum=True)
