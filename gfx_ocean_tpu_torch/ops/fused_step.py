"""The fused ocean step on the card: kernel K1 for N <= 512, and the
entry points that route by N and ``hermitian_pack``.

K1 replaces ``gfx_ocean_tpu/ops/pallas_step.py::_packed_grid_kernel``
(launched by ``_packed_single_fields``). Per frame it computes:

1. the packed propagate from the state: per element, h0 at (y, x), at its
   flip, at rho = (-y, -x) and at rho's flip, omega at (y, x) and at rho
   (``ops/propagate.gather_packed_planes``), then the symmetrized height
   spectrum H and Z = H_dx + i H_dz, with the Dekker phase, the polynomial
   sincos and k-hat pairs from indices (``ops/propagate.packed_spectra``).
   The Q2 flip rides the symmetrization's 1/2 (``half = -0.5`` when
   ``ref_sign``);
2. the row DFT Y = X A^T and the column DFT A Y with A = D_alt W
   (``ops/fft._dft_matrix_out_alt_np(n, 1, 0, False)``): height is
   Re F(H), disp_x / disp_z are Re / Im F(Z);
3. optionally the forcing checksum sum(planes) + sum(normal terms).

Two implementations sit side by side:

- ``packed_planes_reference`` / ``packed_checksums_reference``: the plain
  PyTorch version (matmuls against A, made once per N and device, FP32
  with TF32 off). The CPU tests and the kernel-vs-plain comparison on the
  card use it.
- ``launch_packed_step``: the hand-written CUDA kernels of
  ``csrc/packed_step.cu`` (a row pass and a column pass of register-resident
  radix-8 FFTs, then checksum partials).

The JAX entry points ``pallas_planes`` / ``pallas_fields`` /
``pallas_checksums`` become ``fused_planes`` / ``fused_fields`` /
``fused_checksums`` here. As in ``pallas_planes``, N > 512 takes the
four-step pipeline (K2 + K3, ``ops/fourstep_step.py``) before
``hermitian_pack`` is looked at; at N <= 512 ``hermitian_pack=False``
takes the unpacked step (K4, or K5 + K6, ``ops/unpacked_step.py``).
``check_supported`` and ``hoist_packed`` route by N and ``hermitian_pack``;
``packed_planes`` and ``packed_checksums`` by the type of the hoisted
inputs. Each picks by where the tensors lie: CPU tensors take the plain
version, CUDA tensors launch the kernels or raise. Nothing falls back.

Hoisting copies nothing and launches nothing: the inputs are the state's
own h0 and omega and the twiddle table made once per N and device.

Cascades (a (C, 2, N, N) state, the JAX package's ``jax.vmap`` of the fused
step over its leading axis): K1 takes the cascade axis itself, as one more
grid axis, so one launch covers C x tb frames; its plain version broadcasts
over C. The other routes (K2 + K3 above 512; K4, or K5 + K6 unpacked) take
one cascade a call: ``hoist_packed`` hoists one input a cascade
(``CascadeInputs``), and ``packed_planes`` / ``packed_checksums`` loop over
them on the same frame times. Every cascade's propagate uses
``config.domain_size``, as the JAX package's vmap with one config does; only
foam takes a cascade's own domain (``models/ocean.py``). Cascade planes are
(tb, C, 3, N, N); cascade checksums (tb,) sum over the cascades.

What bounds K1 on the H100: at 512^2 a frame reads the 3 MB state (once a
call; later frames find it in the 50 MB L2), writes and rereads the 4 MB
row-pass planes Y, writes 3 MB of planes and rereads them for the
checksum. The FFT does ~50 MFLOP a frame, so bytes and latency bound the
kernels, not arithmetic (``PERF.md`` has the measured split).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from gfx_ocean_tpu_torch import kernels
from gfx_ocean_tpu_torch.config import OceanConfig
from gfx_ocean_tpu_torch.ops import fourstep_step, unpacked_step
from gfx_ocean_tpu_torch.ops.derived import checksums_of_planes, normals_scale
from gfx_ocean_tpu_torch.ops.fft import (_tier_table, effective_precision, kernel_passes,
                                         kernel_tier, matmul_tier, prepare, table_slots,
                                         transposed, twiddle_table)
from gfx_ocean_tpu_torch.ops.fourstep_step import FourstepInputs
from gfx_ocean_tpu_torch.ops.propagate import (_f32, as_times, gather_packed_planes,
                                               packed_spectra)
from gfx_ocean_tpu_torch.ops.unpacked_step import UnpackedInputs
from gfx_ocean_tpu_torch.utils import profiling

MAX_N = 512
# Rows of the output reduced by one block of the checksum kernel.
CHECKSUM_ROWS = 4
# K1t's work items (csrc/packed_step.cu): a tile of 16 rows (columns) and a
# pair of 64-output groups, one a consumer warpgroup.
TIER_TILE, TIER_GROUP, TIER_CONSUMERS = 16, 64, 2


def tier_items(n: int, frames: int) -> int:
    """The work items of a K1t pass over ``frames`` frames (time batch x
    cascades) at N: a tile of 16 rows and a pair of 64-output groups each
    (one group below N = 128), as ``csrc/packed_step.cu``'s ``TierPlan``."""
    groups = max(1, n // TIER_GROUP)
    return frames * (n // TIER_TILE) * -(-groups // TIER_CONSUMERS)


class PackedInputs(NamedTuple):
    """Per-rollout inputs of K1 (all float32, one device): the state itself,
    with or without a leading cascade axis C."""

    h0: torch.Tensor       # (2, N, N) or (C, 2, N, N) re, im
    omega: torch.Tensor    # (N, N) or (C, N, N)
    twiddle: torch.Tensor  # (2, N/2) cos, sin of 2 pi k / N: the kernels' table


def check_supported(config: OceanConfig, n: int) -> str:
    """Raise for configurations the fused step does not cover; return the
    effective tier. N > 512 takes the four-step route whatever
    ``hermitian_pack`` says, as ``pallas_planes`` does."""
    if n > MAX_N:
        return fourstep_step.check_supported(config, n)
    if not config.hermitian_pack:
        return unpacked_step.check_supported(config, n)
    return effective_precision(config.matmul_precision, n, impl="pallas")


class CascadeInputs(NamedTuple):
    """The hoisted inputs of a cascade state on a route that takes one
    cascade a call (K2 + K3, K4, K5 + K6): one entry a cascade."""

    per_cascade: Tuple[Union[UnpackedInputs, FourstepInputs], ...]


FusedInputs = Union[PackedInputs, UnpackedInputs, FourstepInputs, CascadeInputs]


def hoist_packed(h0_pair: torch.Tensor, omega: torch.Tensor,
                 config: OceanConfig) -> FusedInputs:
    """The time-invariant inputs of the route (per rollout, not per frame):
    K1's for N <= 512, K4-K6's for N <= 512 unpacked, K2 + K3's above; for a
    (C, 2, N, N) cascade state K1's with the cascade axis, else one input a
    cascade. A float32 contiguous state is passed through as it is."""
    if h0_pair.ndim not in (3, 4) or omega.shape != h0_pair.shape[:-3] + h0_pair.shape[-2:]:
        raise ValueError("the fused step takes a (2, N, N) state and (N, N) omega, or a "
                         f"(C, 2, N, N) cascade stack; got {tuple(h0_pair.shape)} and "
                         f"{tuple(omega.shape)}")
    n = h0_pair.shape[-1]
    check_supported(config, n)
    if n > MAX_N or not config.hermitian_pack:
        hoist = (fourstep_step.hoist_fourstep if n > MAX_N
                 else unpacked_step.hoist_unpacked)
        if h0_pair.ndim == 4:
            return CascadeInputs(tuple(hoist(h, o, config) for h, o in zip(h0_pair, omega)))
        return hoist(h0_pair, omega, config)
    dev = h0_pair.device
    return PackedInputs(h0_pair.to(torch.float32).contiguous(),
                        omega.to(device=dev, dtype=torch.float32).contiguous(),
                        twiddle_table(n, dev))


# --------------------------------------------------------------------------
# The plain PyTorch version.
# --------------------------------------------------------------------------

def packed_planes_reference(inputs: PackedInputs, ts,
                            config: OceanConfig) -> torch.Tensor:
    """Plain PyTorch K1: ts (tb,) -> (tb, 3, N, N) (disp_x, height, disp_z),
    or (tb, C, 3, N, N) for a cascade state (broadcast over C).

    The products run at the tier of ``config.matmul_precision`` as the JAX
    kernel runs them (``ops/fft.kernel_tier``): every product one
    ``matmul_tier`` of bf16-rounded operands summed in FP32 (the row pass's
    FP32 output rounded again as the column pass's operand), "highest"
    ``full_matmul``. The four real products of each complex output are
    separate, as in ``_packed_grid_kernel``."""
    om = inputs.omega
    pre, pre_rho, _, omq = gather_packed_planes(inputs.h0, om, config.compat.conj_neg)
    h_r, h_i, z_r, z_i = packed_spectra(
        pre, pre_rho, om, omq, as_times(ts, om.device), config.domain_size,
        config.compat.wrap_k, -0.5 if config.compat.ref_sign else 0.5)
    tier = kernel_tier(config.matmul_precision)
    ar, ai = _tier_table(("alt", om.shape[-1], 1, 0, False), om.device, tier)
    art, ait = transposed(ar), transposed(ai)

    def mm(a, b):
        return matmul_tier(a, b, tier)

    h_r, h_i, z_r, z_i = (prepare(x, tier) for x in (h_r, h_i, z_r, z_i))
    yh_r = prepare(mm(h_r, art) - mm(h_i, ait), tier)
    yh_i = prepare(mm(h_r, ait) + mm(h_i, art), tier)
    yz_r = prepare(mm(z_r, art) - mm(z_i, ait), tier)
    yz_i = prepare(mm(z_r, ait) + mm(z_i, art), tier)
    height = mm(ar, yh_r) - mm(ai, yh_i)
    disp_x = mm(ar, yz_r) - mm(ai, yz_i)
    disp_z = mm(ar, yz_i) + mm(ai, yz_r)
    return torch.stack([disp_x, height, disp_z], dim=-3)


def packed_checksums_reference(inputs: PackedInputs, ts,
                               config: OceanConfig) -> torch.Tensor:
    """Plain PyTorch K1 checksums: ts (tb,) -> (tb,), summed over the
    cascades of a cascade state."""
    return checksums_of_planes(packed_planes_reference(inputs, ts, config), config)


# --------------------------------------------------------------------------
# The CUDA kernels.
# --------------------------------------------------------------------------

def launch_packed_step(inputs: PackedInputs, ts: torch.Tensor, config: OceanConfig,
                       checksum: bool):
    """Launch the K1 kernels on the current stream: one launch for every
    cascade of a (C, 2, N, N) state (grid axis z). At "highest" the FFT
    body runs; at the other tiers the tiered body, the JAX kernel's bf16
    passes on the tensor cores (``ops/fft.kernel_tier``).

    Returns ``(planes, partials)``: planes (tb, 3, N, N) and, when
    ``checksum``, the per-block checksum partials (tb, N / CHECKSUM_ROWS),
    else None; for a cascade state (C, tb, 3, N, N) and (C, tb,
    N / CHECKSUM_ROWS), cascade-major as the kernels write them. Counts
    ``launches.launch_packed_step`` per launch of either body and
    ``tiered_launches.launch_packed_step`` per launch of the tiered body
    (``kernels.launch``), and adds a tiered launch's work items
    (``tier_items``, each pass) to ``tiered_items.launch_packed_step``.
    """
    dev = kernels.cuda_device(inputs.omega, "launch_packed_step")
    n = inputs.omega.shape[-1]
    if n < 16 or n > MAX_N or n & (n - 1):
        raise ValueError(f"K1 takes a power of two N in [16, {MAX_N}], got {n}")
    check_supported(config, n)
    lead = tuple(inputs.omega.shape[:-2])  # () or (C,)
    cascades = lead[0] if lead else 1
    if len(lead) > 1 or not 1 <= cascades <= 65535:
        raise ValueError(f"K1 takes at most one cascade axis of 1 to 65535 cascades, "
                         f"got omega of shape {tuple(inputs.omega.shape)}")
    shapes = dict(h0=lead + (2, n, n), omega=lead + (n, n), twiddle=(2, n // 2))
    for name, x in inputs._asdict().items():
        kernels.check_tensor(name, x, torch.float32, shapes[name], dev)
    ts = as_times(ts, dev)
    tb = ts.shape[0]
    if checksum and tb * cascades > 65535:
        raise ValueError(f"K1's checksum takes at most 65535 frames a launch, "
                         f"got {cascades} cascades x {tb} frames")
    tier = kernel_tier(config.matmul_precision)
    passes = kernel_passes(tier)
    # the FFT body's Y; the tiered body's spectra's tiles, then Y's
    y = torch.empty(lead + (tb,) + (2,) * (3 if passes else 2) + (n, n), dtype=torch.float32,
                    device=dev)
    planes = torch.empty(lead + (tb, 3, n, n), dtype=torch.float32, device=dev)
    partials = (torch.empty(lead + (tb, n // CHECKSUM_ROWS), dtype=torch.float32, device=dev)
                if checksum else None)
    nscale = normals_scale(config)
    table = table_slots(("alt", n, 1, 0, False), dev, tier) if passes else None
    ptr = kernels.ptr
    kernels.launch(
        "launch_packed_step", "packed_step", "packed_step",
        ptr(inputs.h0), ptr(inputs.omega), ptr(inputs.twiddle), ptr(ts), tb, cascades, n,
        _f32(np.pi / config.domain_size), int(config.compat.wrap_k),
        int(config.compat.conj_neg), -0.5 if config.compat.ref_sign else 0.5,
        ptr(y), ptr(planes), ptr(partials), CHECKSUM_ROWS,
        nscale if nscale is not None else 0.0, int(nscale is not None), passes, ptr(table),
        device=dev, tiered=passes > 0)
    if passes:
        profiling.tally("tiered_items.launch_packed_step", tier_items(n, tb * cascades))
    return planes, partials


def packed_planes(inputs: FusedInputs, ts, config: OceanConfig) -> torch.Tensor:
    """Planes (tb, 3, N, N) for ts (tb,), (tb, C, 3, N, N) for a cascade
    state: K1, K4-K6 or K2 + K3 by the type of the hoisted inputs; the
    kernels on CUDA, the plain version on CPU."""
    if isinstance(inputs, CascadeInputs):
        return torch.stack([packed_planes(i, ts, config) for i in inputs.per_cascade], dim=1)
    if isinstance(inputs, FourstepInputs):
        return fourstep_step.fourstep_planes(inputs, ts, config)
    if isinstance(inputs, UnpackedInputs):
        return unpacked_step.unpacked_planes(inputs, ts, config)
    if inputs.omega.is_cuda:
        planes = launch_packed_step(inputs, ts, config, checksum=False)[0]
        return planes.transpose(0, 1) if planes.ndim == 5 else planes
    return packed_planes_reference(inputs, ts, config)


def packed_checksums(inputs: FusedInputs, ts, config: OceanConfig) -> torch.Tensor:
    """Checksums (tb,) for ts (tb,): K1, K4-K6 or K2 + K3 by the type of
    the hoisted inputs; the kernels on CUDA, the plain version on CPU.

    On CUDA the per-block partials of K1, K3 and the unpacked route's
    checksum kernel are summed outside the kernels by ``torch.sum``, in an
    order fixed by their shape (no float atomics); a cascade state's
    checksums sum over its cascades too.
    """
    if isinstance(inputs, CascadeInputs):
        return torch.stack([packed_checksums(i, ts, config)
                            for i in inputs.per_cascade]).sum(dim=0)
    if isinstance(inputs, FourstepInputs):
        return fourstep_step.fourstep_checksums(inputs, ts, config)
    if isinstance(inputs, UnpackedInputs):
        return unpacked_step.unpacked_checksums(inputs, ts, config)
    if inputs.omega.is_cuda:
        _, partials = launch_packed_step(inputs, ts, config, checksum=True)
        return partials.sum(dim=(0, 2)) if partials.ndim == 3 else partials.sum(dim=-1)
    return packed_checksums_reference(inputs, ts, config)


# --------------------------------------------------------------------------
# Entry points mirroring pallas_planes / pallas_fields / pallas_checksums.
# --------------------------------------------------------------------------

def fused_planes(h0_pair: torch.Tensor, omega: torch.Tensor, t,
                 config: OceanConfig) -> torch.Tensor:
    """(2, N, N) h0 planes + omega + t -> (3, N, N) (disp_x, height, disp_z);
    (C, 3, N, N) for a (C, 2, N, N) cascade state."""
    inputs = hoist_packed(h0_pair, omega, config)
    return packed_planes(inputs, as_times(t, omega.device), config)[0]


def fused_fields(h0_pair: torch.Tensor, omega: torch.Tensor, t,
                 config: OceanConfig) -> torch.Tensor:
    """Channel-last (..., N, N, 3) displacement of :func:`fused_planes`."""
    return torch.movedim(fused_planes(h0_pair, omega, t, config), -3, -1)


def fused_checksums(h0_pair: torch.Tensor, omega: torch.Tensor, ts,
                    config: OceanConfig) -> torch.Tensor:
    """Forcing checksums for ts (tb,) -> (tb,): sum(planes) + sum(normals)."""
    inputs = hoist_packed(h0_pair, omega, config)
    return packed_checksums(inputs, ts, config)

