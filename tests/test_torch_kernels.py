"""Kernels K1 (``gfx_ocean_tpu_torch/csrc/packed_step.cu``) and K2 + K3
(``csrc/fourstep_step.cu``) against their plain PyTorch versions, and two
checks that run anywhere.

The CUDA tests are marked ``cuda`` and skip without a GPU: a CUDA kernel
has no CPU mode. This file imports no jax, so on a machine with a GPU and
no jax it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gfx_ocean_tpu_torch.config import CompatFlags, OceanConfig, PhillipsConfig
from gfx_ocean_tpu_torch.ops import fourstep_step as fs
from gfx_ocean_tpu_torch.ops import fused_step
from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
from gfx_ocean_tpu_torch.spectra.phillips import synthesize

REPO = Path(__file__).resolve().parent.parent
# Kernel vs plain, |diff| / max |field|: both FP32, FFT against dense matmul,
# so they differ by summation order only (a few float32 ulps of the scale).
TOL_PLANES = 1e-5
# Checksums, |diff| / sum of |summands| (a frame's checksum nearly cancels).
TOL_CHECKSUM = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(n: int, flags: CompatFlags, device) -> tuple:
    noise = np.random.default_rng(n).standard_normal((2, n, n)).astype(np.float32)
    h0, omega = synthesize(n, 1000.0, PhillipsConfig(), noise=torch.from_numpy(noise))
    cfg = OceanConfig(resolution=n, fft_impl="pallas", compat=flags)
    return cfg, fused_step.hoist_packed(h0.to(device), omega.to(device), cfg)


FLAGS = [CompatFlags(), CompatFlags(wrap_k=True), CompatFlags(ref_sign=False),
         CompatFlags(conj_neg=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64, 128, 512])
@pytest.mark.parametrize("flags", FLAGS, ids=["default", "wrap_k", "canonical_sign", "conj_neg"])
def test_packed_step_kernel_matches_plain(cuda, n, flags):
    """t = 1000 s checks the kernel's Dekker phase: a split that nvcc had
    contracted into FMAs would be off by ~|w t| 2^-24 ~ 3e-4 rad there,
    30x the field tolerance."""
    cfg, inputs = _inputs(n, flags, cuda)
    ts = torch.tensor([0.0, 3.25, 11.25, 1000.0], device=cuda)
    got = fused_step.packed_planes(inputs, ts, cfg)
    want = fused_step.packed_planes_reference(inputs, ts, cfg)
    assert got.shape == (4, 3, n, n) and torch.isfinite(got).all()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL_PLANES, rel

    got_ck = fused_step.packed_checksums(inputs, ts, cfg)
    want_ck = fused_step.checksums_of_planes(want, cfg)
    summands = (want.abs().sum(dim=(-3, -2, -1))
                + finite_difference_normals_planes(want[:, 1]).abs().sum(dim=(-3, -2, -1)))
    assert float(((got_ck - want_ck).abs() / summands).max()) < TOL_CHECKSUM


@pytest.mark.cuda
def test_packed_step_frames_identical_for_every_time_batch(cuda):
    cfg, inputs = _inputs(512, CompatFlags(), cuda)
    ts = torch.arange(6, dtype=torch.float32, device=cuda) * 0.7 + 1.0
    batch = fused_step.packed_planes(inputs, ts, cfg)
    for j in range(6):
        single = fused_step.packed_planes(inputs, ts[j:j + 1], cfg)
        assert torch.equal(batch[j], single[0])


@pytest.mark.cuda
def test_packed_step_counts_launches_and_rejects_bad_inputs(cuda):
    cfg, inputs = _inputs(64, CompatFlags(), cuda)
    before = fused_step.launch_packed_step.launches
    fused_step.packed_checksums(inputs, [1.0, 2.0], cfg)
    assert fused_step.launch_packed_step.launches == before + 1
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_step.launch_packed_step(inputs._replace(pre=inputs.pre.double()),
                                      [1.0], cfg, checksum=False)
    with pytest.raises(ValueError, match="expected shape"):
        fused_step.launch_packed_step(
            inputs._replace(omega_rho=inputs.omega_rho[:32, :32].contiguous()),
            [1.0], cfg, checksum=False)
    assert fused_step.launch_packed_step.launches == before + 1


@functools.lru_cache(maxsize=None)
def _state(n: int):
    """A Phillips state at n^2 on the CPU, from a numpy draw seeded n."""
    noise = np.random.default_rng(n).standard_normal((2, n, n)).astype(np.float32)
    return synthesize(n, 1000.0, PhillipsConfig(), noise=torch.from_numpy(noise))


def _fourstep_inputs(n: int, flags: CompatFlags, device) -> tuple:
    h0, omega = _state(n)
    cfg = OceanConfig(resolution=n, fft_impl="pallas", compat=flags)
    return cfg, fused_step.hoist_packed(h0.to(device), omega.to(device), cfg)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192])
@pytest.mark.parametrize("flags", FLAGS, ids=["default", "wrap_k", "canonical_sign", "conj_neg"])
def test_fourstep_kernels_match_plain(cuda, n, flags):
    """K2 alone (Y), K3 alone (fed the kernel's Y), both chained, and the
    checksums, at t up to an hour."""
    cfg, inputs = _fourstep_inputs(n, flags, cuda)
    assert isinstance(inputs, fs.FourstepInputs)
    ts = torch.tensor([3.25, 1000.0] if n == 8192 else [0.0, 3.25, 11.25, 1000.0], device=cuda)
    y = fs.launch_fourstep_row(inputs, ts, cfg)
    y_want = fs.fourstep_row_reference(inputs, ts, cfg)
    assert y.shape == (len(ts), 2, 2, n, n) and torch.isfinite(y).all()
    assert _rel(y, y_want) < TOL_PLANES
    col_want = fs.fourstep_col_reference(y, cfg)
    col_got, _ = fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=False)
    assert _rel(col_got, col_want) < TOL_PLANES

    got = fused_step.packed_planes(inputs, ts, cfg)
    want = fs.fourstep_planes_reference(inputs, ts, cfg)
    assert got.shape == (len(ts), 3, n, n) and torch.isfinite(got).all()
    assert _rel(got, want) < TOL_PLANES
    got_ck = fused_step.packed_checksums(inputs, ts, cfg)
    want_ck = fused_step.checksums_of_planes(want, cfg)
    summands = (want.abs().sum(dim=(-3, -2, -1))
                + finite_difference_normals_planes(want[:, 1]).abs().sum(dim=(-3, -2, -1)))
    assert float(((got_ck - want_ck).abs() / summands).max()) < TOL_CHECKSUM


@pytest.mark.cuda
def test_fourstep_row_band_at_row_base(cuda):
    cfg, inputs = _fourstep_inputs(1024, CompatFlags(), cuda)
    rows = slice(512, 528)
    band = inputs._replace(pre=inputs.pre[:, rows].contiguous(),
                           pre_rho=inputs.pre_rho[:, rows].contiguous(),
                           omega=inputs.omega[rows].contiguous(),
                           omega_rho=inputs.omega_rho[rows].contiguous())
    got = fs.launch_fourstep_row(band, [7.5], cfg, row_base=512)
    assert _rel(got, fs.fourstep_row_reference(band, [7.5], cfg, row_base=512)) < TOL_PLANES
    whole = fs.launch_fourstep_row(inputs, [7.5], cfg)
    assert torch.equal(got, whole[..., rows, :])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 4096])
def test_fourstep_frames_identical_for_every_time_batch(cuda, n):
    cfg, inputs = _fourstep_inputs(n, CompatFlags(), cuda)
    ts = torch.arange(4, dtype=torch.float32, device=cuda) * 0.7 + 1.0
    batch, partials = fs.launch_fourstep_step(inputs, ts, cfg, checksum=True)
    for j in range(4):
        single, single_partials = fs.launch_fourstep_step(inputs, ts[j:j + 1], cfg, checksum=True)
        assert torch.equal(batch[j], single[0])
        assert torch.equal(partials[j], single_partials[0])


@pytest.mark.cuda
def test_fourstep_counts_launches_and_rejects_bad_inputs(cuda):
    cfg, inputs = _fourstep_inputs(1024, CompatFlags(), cuda)
    rows, cols = fs.launch_fourstep_row.launches, fs.launch_fourstep_col.launches
    k1 = fused_step.launch_packed_step.launches
    fused_step.packed_checksums(inputs, [1.0, 2.0], cfg)
    fused_step.packed_planes(inputs, [1.0], cfg)
    assert fs.launch_fourstep_row.launches == rows + 2
    assert fs.launch_fourstep_col.launches == cols + 2
    assert fused_step.launch_packed_step.launches == k1

    def rejected(match, fn):
        with pytest.raises(ValueError, match=match):
            fn()

    rejected("contiguous float32", lambda: fs.launch_fourstep_row(
        inputs._replace(pre=inputs.pre.double()), [1.0], cfg))
    rejected("contiguous float32", lambda: fs.launch_fourstep_row(
        inputs._replace(omega=inputs.omega.t()), [1.0], cfg))
    rejected("expected shape", lambda: fs.launch_fourstep_row(
        inputs._replace(omega_rho=inputs.omega_rho[:512].contiguous()), [1.0], cfg))
    rejected("outside", lambda: fs.launch_fourstep_row(inputs, [1.0], cfg, row_base=16))
    rejected("needs CUDA tensors", lambda: fs.launch_fourstep_row(
        fs.FourstepInputs(*(x.cpu() for x in inputs)), [1.0], cfg))
    for n in (512, 1536):  # below the range, not a power of two
        bad = fs.FourstepInputs(
            torch.zeros(4, n, n, device=cuda), torch.zeros(4, n, n, device=cuda),
            torch.zeros(n, n, device=cuda), torch.zeros(n, n, device=cuda),
            torch.zeros(2, n // 2, device=cuda))
        rejected("power of two N", lambda: fs.launch_fourstep_row(bad, [1.0], cfg))
        rejected("power of two N", lambda: fs.launch_fourstep_col(
            torch.zeros(1, 2, 2, n, n, device=cuda), bad.twiddle, cfg, checksum=False))
    y = torch.zeros(1, 2, 2, 1024, 1024, device=cuda)
    rejected("multiple of 32", lambda: fs.launch_fourstep_col(
        y[..., :1000].contiguous(), inputs.twiddle, cfg, checksum=False))
    rejected("all N of them", lambda: fs.launch_fourstep_col(
        y[..., :512].contiguous(), inputs.twiddle, cfg, checksum=True))
    rejected("contiguous float32", lambda: fs.launch_fourstep_col(
        y.double(), inputs.twiddle, cfg, checksum=False))
    rejected("needs CUDA tensors", lambda: fs.launch_fourstep_col(
        y.cpu(), inputs.twiddle, cfg, checksum=False))
    assert fs.launch_fourstep_row.launches == rows + 2
    assert fs.launch_fourstep_col.launches == cols + 2


def test_import_leaves_out_jax():
    code = ("import sys, gfx_ocean_tpu_torch, gfx_ocean_tpu_torch.kernels, "
            "gfx_ocean_tpu_torch.ops.fused_step, gfx_ocean_tpu_torch.ops.fourstep_step;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gfx_ocean_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr
