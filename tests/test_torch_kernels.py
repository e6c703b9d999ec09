"""Kernels K1 (``gfx_ocean_tpu_torch/csrc/packed_step.cu``), K2 + K3
(``csrc/fourstep_step.cu``, up to 16384^2 on bands there), K4-K6
(``csrc/unpacked_step.cu``) and K7 + K8 + K9 (``csrc/raster.cu``) against their
plain PyTorch versions, and two checks that run anywhere.

The CUDA tests are marked ``cuda`` and skip without a GPU: a CUDA kernel
has no CPU mode. This file imports no jax, so on a machine with a GPU and
no jax it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gfx_ocean_tpu_torch import kernels
from gfx_ocean_tpu_torch.config import CompatFlags, OceanConfig, PhillipsConfig
from gfx_ocean_tpu_torch.ops import fourstep_step as fs
from gfx_ocean_tpu_torch.ops import fused_step
from gfx_ocean_tpu_torch.ops import unpacked_step as us
from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
from gfx_ocean_tpu_torch.ops.propagate import band_windows
from gfx_ocean_tpu_torch.render import raster as rr
from gfx_ocean_tpu_torch.render.camera import Camera
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, synthesize
from gfx_ocean_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
# Kernel vs plain, |diff| / max |field|: at "highest" both FP32, FFT against
# dense matmul, so they differ by summation order only (a few float32 ulps
# of the scale); at the split tiers both take the same bf16 products and
# differ in the FP32 sums' order too.
TOL_PLANES = 1e-5
# Kernel against plain at the tiered bodies, by tier. Both take the same
# bf16 products and differ in the order of the FP32 sums; where a stage's
# FP32 output is split again as the next stage's operand (K1's row pass,
# K2's and K3's stage 1, K2's Y into K3), a one-ulp difference now and then
# moves the operand by a bf16 ulp: of its lo at the split (measured up to
# 8.1e-6 of the field through K2 + K3's three re-splits on an H100), of the
# operand itself at "default" (2^-8 of it; measured up to 1.8e-3).
TOL_BODY = {"highest": TOL_PLANES, "bf16x3": 2.5e-5, "default": 4e-3}
# The tiers of the packed kernels' two bodies: the FFT body ("highest") and
# the tiered body at the split and at one bf16 pass.
BODIES = ["highest", "bf16x3", "default"]
# Checksums, |diff| / sum of |summands| (a frame's checksum nearly cancels).
TOL_CHECKSUM = 1e-5


def _launches(wrapper: str, kind: str = "launches") -> int:
    """The process-wide count ``<kind>.<wrapper>`` (``profiling.tallies``)."""
    return profiling.tallies().get(f"{kind}.{wrapper}", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(n: int, flags: CompatFlags, device, precision: str = "bf16x3") -> tuple:
    noise = np.random.default_rng(n).standard_normal((2, n, n)).astype(np.float32)
    h0, omega = synthesize(n, 1000.0, PhillipsConfig(), noise=torch.from_numpy(noise))
    cfg = OceanConfig(resolution=n, fft_impl="pallas", compat=flags, matmul_precision=precision)
    return cfg, fused_step.hoist_packed(h0.to(device), omega.to(device), cfg)


FLAGS = [CompatFlags(), CompatFlags(wrap_k=True), CompatFlags(ref_sign=False),
         CompatFlags(conj_neg=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("flags", FLAGS, ids=["default", "wrap_k", "canonical_sign", "conj_neg"])
def test_packed_step_kernel_matches_plain(cuda, n, flags, precision):
    """Both bodies of K1 against the plain version at their tier. t = 1000 s
    checks the kernel's Dekker phase: a split that nvcc had contracted into
    FMAs would be off by ~|w t| 2^-24 ~ 3e-4 rad there, 30x the field
    tolerance."""
    cfg, inputs = _inputs(n, flags, cuda, precision)
    ts = torch.tensor([0.0, 3.25, 11.25, 1000.0], device=cuda)
    got = fused_step.packed_planes(inputs, ts, cfg)
    want = fused_step.packed_planes_reference(inputs, ts, cfg)
    assert got.shape == (4, 3, n, n) and torch.isfinite(got).all()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL_BODY[precision], rel

    got_ck = fused_step.packed_checksums(inputs, ts, cfg)
    want_ck = fused_step.checksums_of_planes(want, cfg)
    summands = (want.abs().sum(dim=(-3, -2, -1))
                + finite_difference_normals_planes(want[:, 1]).abs().sum(dim=(-3, -2, -1)))
    assert float(((got_ck - want_ck).abs() / summands).max()) < TOL_CHECKSUM


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
def test_packed_step_frames_identical_for_every_time_batch(cuda, precision):
    cfg, inputs = _inputs(512, CompatFlags(), cuda, precision)
    ts = torch.arange(6, dtype=torch.float32, device=cuda) * 0.7 + 1.0
    batch = fused_step.packed_planes(inputs, ts, cfg)
    for j in range(6):
        single = fused_step.packed_planes(inputs, ts[j:j + 1], cfg)
        assert torch.equal(batch[j], single[0])


@pytest.mark.cuda
def test_packed_step_counts_launches_and_rejects_bad_inputs(cuda):
    cfg, inputs = _inputs(64, CompatFlags(), cuda)
    before = _launches("launch_packed_step")
    fused_step.packed_checksums(inputs, [1.0, 2.0], cfg)
    assert _launches("launch_packed_step") == before + 1
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_step.launch_packed_step(inputs._replace(h0=inputs.h0.double()),
                                      [1.0], cfg, checksum=False)
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_step.launch_packed_step(inputs._replace(omega=inputs.omega.t()),
                                      [1.0], cfg, checksum=False)
    with pytest.raises(ValueError, match="expected shape"):
        fused_step.launch_packed_step(
            inputs._replace(h0=inputs.h0[:, :32, :32].contiguous()),
            [1.0], cfg, checksum=False)
    assert _launches("launch_packed_step") == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 512, 1024])
def test_hoist_passes_the_state_through(cuda, n):
    """K1's and K2's hoist copies nothing: the inputs are the state's own
    tensors and one twiddle table a grid size and device."""
    h0, omega = _state(n)
    h0, omega = h0.to(cuda), omega.to(cuda)
    cfg = OceanConfig(resolution=n, fft_impl="pallas")
    inputs = fused_step.hoist_packed(h0, omega, cfg)
    assert isinstance(inputs, fs.FourstepInputs if n > 512 else fused_step.PackedInputs)
    assert inputs.h0.data_ptr() == h0.data_ptr()
    assert inputs.omega.data_ptr() == omega.data_ptr()
    again = fused_step.hoist_packed(h0, omega, cfg)
    assert again.twiddle.data_ptr() == inputs.twiddle.data_ptr()


def _cascade_inputs(n: int, cascades: int, device, **cfg_kw) -> tuple:
    """A (C, 2, n, n) cascade state on ``device``: cascade c is the numpy
    Phillips state of seed n + c, and the hoisted inputs of its route."""
    draws = [synthesize(n, 1000.0, PhillipsConfig(), noise=torch.from_numpy(
        np.random.default_rng(n + c).standard_normal((2, n, n)).astype(np.float32)))
        for c in range(cascades)]
    h0 = torch.stack([h for h, _ in draws]).to(device)
    omega = torch.stack([o for _, o in draws]).to(device)
    cfg = OceanConfig(resolution=n, fft_impl="pallas", num_cascades=cascades, **cfg_kw)
    return cfg, h0, omega, fused_step.hoist_packed(h0, omega, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
@pytest.mark.parametrize("n", [16, 64, 512])
def test_packed_step_cascade_axis(cuda, n, precision):
    """K1 on C cascades in one launch (grid axis z): against the plain
    version, and bit-equal to C single-cascade launches; the checksums sum
    the cascades."""
    cfg, h0, omega, inputs = _cascade_inputs(n, 3, cuda, matmul_precision=precision)
    assert isinstance(inputs, fused_step.PackedInputs) and inputs.h0.shape == (3, 2, n, n)
    ts = torch.tensor([0.0, 3.25, 11.25, 1000.0], device=cuda)
    before = _launches("launch_packed_step")
    got = fused_step.packed_planes(inputs, ts, cfg)
    assert _launches("launch_packed_step") == before + 1
    assert got.shape == (4, 3, 3, n, n) and torch.isfinite(got).all()
    want = fused_step.packed_planes_reference(inputs, ts, cfg)
    assert _rel(got, want) < TOL_BODY[precision]
    for c in range(3):
        one = fused_step.hoist_packed(h0[c], omega[c], cfg)
        assert torch.equal(got[:, c], fused_step.packed_planes(one, ts, cfg))
    got_ck = fused_step.packed_checksums(inputs, ts, cfg)
    want_ck = fused_step.checksums_of_planes(want, cfg)
    summands = (want.abs().sum(dim=(-4, -3, -2, -1))
                + finite_difference_normals_planes(want[:, :, 1]).abs().sum(dim=(-4, -3, -2, -1)))
    assert got_ck.shape == (4,)
    assert float(((got_ck - want_ck).abs() / summands).max()) < TOL_CHECKSUM
    with pytest.raises(ValueError, match="65535 frames"):
        fused_step.launch_packed_step(inputs, torch.zeros(21846, device=cuda), cfg,
                                      checksum=True)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("n", [16, 64, 256, 512])
@pytest.mark.parametrize("frames", [(1, 1), (6, 1), (6, 3)], ids=["tb1", "tb6", "3x6"])
def test_k1t_persistent_plan_matches_plain(cuda, n, precision, frames):
    """K1t's persistent passes at every plan the launches give them: one
    frame (the renderers' step), a time batch of 6 (the rollout) and 3
    cascades x 6 frames (config 4), against the plain version at the body
    tolerance, the checksums on the scale of their summands; each launch adds
    its work items to ``tiered_items.launch_packed_step``."""
    tb, cascades = frames
    if cascades == 1:
        cfg, inputs = _inputs(n, CompatFlags(), cuda, precision)
    else:
        cfg, _, _, inputs = _cascade_inputs(n, cascades, cuda, matmul_precision=precision)
    ts = torch.arange(tb, dtype=torch.float32, device=cuda) * 0.7 + 1.0
    before = _launches("launch_packed_step", "tiered_items")
    got = fused_step.packed_planes(inputs, ts, cfg)
    items = fused_step.tier_items(n, tb * cascades)
    assert _launches("launch_packed_step", "tiered_items") == before + items
    want = fused_step.packed_planes_reference(inputs, ts, cfg)
    assert got.shape == want.shape and _rel(got, want) < TOL_BODY[precision]
    got_ck = fused_step.packed_checksums(inputs, ts, cfg)
    want_ck = fused_step.checksums_of_planes(want, cfg)
    summands = (want.abs().flatten(1).sum(1)
                + finite_difference_normals_planes(want.select(-3, 1)).abs().flatten(1).sum(1))
    assert float(((got_ck - want_ck).abs() / summands).max()) < TOL_CHECKSUM


@pytest.mark.cuda
def test_k1t_items_of_the_rollout_and_the_frame(cuda):
    """At 512^2 a rollout call (time batch 6) runs 768 work items a pass,
    5 or 6 a block on 132 SMs, and the frame's step (time batch 1) 128."""
    cfg, inputs = _inputs(512, CompatFlags(), cuda)
    for tb, items in ((6, 768), (1, 128)):
        before = _launches("launch_packed_step", "tiered_items")
        fused_step.packed_checksums(inputs, torch.zeros(tb, device=cuda), cfg)
        assert _launches("launch_packed_step", "tiered_items") == before + items


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(resolution=1024), dict(resolution=512, hermitian_pack=False),
                                dict(resolution=512, hermitian_pack=False,
                                     matmul_precision="highest")],
                         ids=["k2+k3", "k4", "k5+k6"])
def test_cascades_on_the_routes_without_a_cascade_axis(cuda, kw):
    """K2 + K3, K4 and K5 + K6 run one cascade a call: each cascade's planes
    equal its single-cascade call bit for bit, one launch a cascade."""
    n = kw.pop("resolution")
    cfg, h0, omega, inputs = _cascade_inputs(n, 2, cuda, **kw)
    assert isinstance(inputs, fused_step.CascadeInputs)
    ts = torch.tensor([0.5, 11.25], device=cuda)
    counters = ("launch_fourstep_row", "launch_unpacked_step", "launch_unpacked_rows")
    before = [_launches(f) for f in counters]
    planes = fused_step.packed_planes(inputs, ts, cfg)
    assert sum(_launches(f) - b for f, b in zip(counters, before)) == 2
    for c in range(2):
        one = fused_step.hoist_packed(h0[c], omega[c], cfg)
        assert torch.equal(planes[:, c], fused_step.packed_planes(one, ts, cfg))
    assert torch.equal(fused_step.packed_checksums(inputs, ts, cfg),
                       fused_step.packed_checksums(inputs.per_cascade[0], ts, cfg)
                       + fused_step.packed_checksums(inputs.per_cascade[1], ts, cfg))


@functools.lru_cache(maxsize=None)
def _state(n: int):
    """A Phillips state at n^2 on the CPU, from a numpy draw seeded n."""
    noise = np.random.default_rng(n).standard_normal((2, n, n)).astype(np.float32)
    return synthesize(n, 1000.0, PhillipsConfig(), noise=torch.from_numpy(noise))


def _fourstep_inputs(n: int, flags: CompatFlags, device, precision: str = "bf16x3") -> tuple:
    h0, omega = _state(n)
    cfg = OceanConfig(resolution=n, fft_impl="pallas", compat=flags, matmul_precision=precision)
    return cfg, fused_step.hoist_packed(h0.to(device), omega.to(device), cfg)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192])
@pytest.mark.parametrize("flags", FLAGS, ids=["default", "wrap_k", "canonical_sign", "conj_neg"])
def test_fourstep_kernels_match_plain(cuda, n, flags, precision):
    """Both bodies of K2 alone (Y), K3 alone (fed the kernel's Y), both
    chained, and the checksums, at t up to an hour."""
    cfg, inputs = _fourstep_inputs(n, flags, cuda, precision)
    tol = TOL_BODY[precision]
    assert isinstance(inputs, fs.FourstepInputs)
    ts = torch.tensor([3.25, 1000.0] if n == 8192 else [0.0, 3.25, 11.25, 1000.0], device=cuda)
    y = fs.launch_fourstep_row(inputs, ts, cfg)
    y_want = fs.fourstep_row_reference(inputs, ts, cfg)
    assert y.shape == (len(ts), 2, 2, n, n) and torch.isfinite(y).all()
    assert _rel(y, y_want) < tol
    col_want = fs.fourstep_col_reference(y, cfg)
    col_got, _ = fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=False)
    assert _rel(col_got, col_want) < tol

    got = fused_step.packed_planes(inputs, ts, cfg)
    want = fs.fourstep_planes_reference(inputs, ts, cfg)
    assert got.shape == (len(ts), 3, n, n) and torch.isfinite(got).all()
    assert _rel(got, want) < tol
    got_ck = fused_step.packed_checksums(inputs, ts, cfg)
    want_ck = fused_step.checksums_of_planes(want, cfg)
    summands = (want.abs().sum(dim=(-3, -2, -1))
                + finite_difference_normals_planes(want[:, 1]).abs().sum(dim=(-3, -2, -1)))
    assert float(((got_ck - want_ck).abs() / summands).max()) < TOL_CHECKSUM


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192])
def test_fourstep_row_band_at_row_base(cuda, n, precision):
    """A 16-row band at global row N/2 - 3 (its partners under the flip and
    rho lie outside it) and a 16-row band through row 0, both equal to the
    same rows of the whole pass."""
    cfg, inputs = _fourstep_inputs(n, CompatFlags(conj_neg=True), cuda, precision)
    whole = fs.launch_fourstep_row(inputs, [7.5, 1000.0], cfg)
    for base in (n // 2 - 3, 0):
        got = fs.launch_fourstep_row(inputs, [7.5, 1000.0], cfg, row_base=base, rows=16)
        assert got.shape == (2, 2, 2, 16, n)
        want = fs.fourstep_row_reference(inputs, [7.5, 1000.0], cfg, row_base=base, rows=16)
        assert _rel(got, want) < TOL_BODY[precision]
        assert torch.equal(got, whole[..., base:base + 16, :])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
@pytest.mark.parametrize("n", [1024, 4096])
def test_fourstep_frames_identical_for_every_time_batch(cuda, n, precision):
    cfg, inputs = _fourstep_inputs(n, CompatFlags(), cuda, precision)
    ts = torch.arange(4, dtype=torch.float32, device=cuda) * 0.7 + 1.0
    batch, partials = fs.launch_fourstep_step(inputs, ts, cfg, checksum=True)
    for j in range(4):
        single, single_partials = fs.launch_fourstep_step(inputs, ts[j:j + 1], cfg, checksum=True)
        assert torch.equal(batch[j], single[0])
        assert torch.equal(partials[j], single_partials[0])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
@pytest.mark.parametrize("n", [1024, 4096])
def test_fourstep_col_on_a_column_band(cuda, n, precision):
    """K3 on C < N columns (no checksum): 96 columns, three of its 32-column
    bands, equal the same columns of the whole pass bit for bit and match
    the plain version."""
    cfg, inputs = _fourstep_inputs(n, CompatFlags(), cuda, precision)
    y = fs.launch_fourstep_row(inputs, [11.25, 1000.0], cfg)
    whole, _ = fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=False)
    band = y[..., 160:256].contiguous()
    got, partials = fs.launch_fourstep_col(band, inputs.twiddle, cfg, checksum=False)
    assert partials is None and got.shape == (2, 3, n, 96)
    assert torch.equal(got, whole[..., 160:256])
    assert _rel(got, fs.fourstep_col_reference(band, cfg)) < TOL_BODY[precision]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
@pytest.mark.parametrize("n", [1024, 4096])
def test_fourstep_row_windows_equal_the_whole_state(cuda, n, precision):
    """K2 on a band reading its two windows of the state
    (``fourstep_row_windows``, as a row-sharded shard does) is bit-equal to
    the same rows of the whole-state launch, for the first band (row b - 1
    wraps), a middle one and the last; its plain version matches."""
    cfg, inputs = _fourstep_inputs(n, CompatFlags(conj_neg=True), cuda, precision)
    whole = fs.launch_fourstep_row(inputs, [7.5, 1000.0], cfg)
    band_inputs = fs.FourstepInputs(None, None, inputs.twiddle)
    rows = n // 8
    for base in (0, 3 * rows, n - rows):
        windows = band_windows(inputs.h0, inputs.omega, base, rows)
        got = fs.launch_fourstep_row(band_inputs, [7.5, 1000.0], cfg, base, rows, windows)
        assert torch.equal(got, whole[..., base:base + rows, :]), base
        want = fs.fourstep_row_reference(band_inputs, [7.5, 1000.0], cfg, base, rows, windows)
        assert _rel(got, want) < TOL_BODY[precision]


@pytest.mark.cuda
def test_launchers_raise_off_their_current_device(cuda, monkeypatch):
    """A ctypes launch runs on the calling thread's current device, so every
    launcher raises when that is not its tensors' device (a shard of a mesh
    of cards runs under its own, ``utils/device.device_guard``)."""
    cfg, inputs = _fourstep_inputs(1024, CompatFlags(), cuda)
    pcfg, pinputs = _inputs(64, CompatFlags(), cuda)
    ucfg = dataclasses.replace(pcfg, hermitian_pack=False)
    uinputs = us.hoist_unpacked(pinputs.h0, pinputs.omega, ucfg)
    y = fs.launch_fourstep_row(inputs, [1.0], cfg)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: cuda.index + 1)
    for launch in (lambda: fs.launch_fourstep_row(inputs, [1.0], cfg),
                   lambda: fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=False),
                   lambda: fused_step.launch_packed_step(pinputs, torch.zeros(1, device=cuda),
                                                         pcfg, checksum=False),
                   lambda: us.launch_unpacked_step(uinputs, [1.0], ucfg),
                   lambda: rr.launch_segmin_kernel(
                       torch.zeros(16, dtype=torch.int32, device=cuda),
                       torch.zeros((5, 16), dtype=torch.int32, device=cuda), 8, 17)):
        with pytest.raises(RuntimeError, match="current device"):
            launch()


@pytest.mark.cuda
def test_sharded_fourstep_step_on_one_card(cuda):
    """The row-sharded K2 + K3 step over a 1 x 4 mesh of cuda:0 (four
    positions on one card) is bit-equal to the single-device kernels: each
    row of K2 and each column of K3 computes alone."""
    from gfx_ocean_tpu_torch.models.ocean import OceanState, make_step
    from gfx_ocean_tpu_torch.parallel import make_mesh, make_sharded_step, shard_state

    cfg, inputs = _fourstep_inputs(1024, CompatFlags(), cuda)
    state = OceanState(inputs.h0, inputs.omega)
    mesh = make_mesh([cuda] * 4, batch=1, row=4)
    rows = _launches("launch_fourstep_row")
    got = make_sharded_step(cfg, mesh, batched=False)(shard_state(state, mesh), 11.25)
    assert _launches("launch_fourstep_row") == rows + 4
    assert torch.equal(got.displacement.gather(), make_step(cfg)(state, 11.25).displacement)


@functools.lru_cache(maxsize=1)
def _big_inputs(device, precision):
    """A 16384^2 state drawn on the card (h0 from a CUDA generator seeded
    16384, the deep-water dispersion as omega) and its K2 + K3 inputs."""
    n = 16384
    gen = torch.Generator(device=device).manual_seed(n)
    h0 = torch.randn((2, n, n), generator=gen, device=device)
    omega = torch.from_numpy(dispersion(n, 1000.0)).to(device)
    cfg = OceanConfig(resolution=n, fft_impl="pallas", matmul_precision=precision)
    return cfg, fused_step.hoist_packed(h0, omega, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_fourstep_16384_on_row_and_column_bands(cuda, precision):
    """K2 at 16384 (a row split into two 8192-point halves over a
    two-block cluster) on 16-row bands and K3 on 128-column bands of the
    whole frame, against the plain version on those bands (the plain
    version of the whole grid needs tens of GB); a banded K2 launch equals
    the same rows of the whole pass, and so does the first frame of a
    two-frame banded launch, whose second frame (the cluster's swap slot
    reused across frames) holds to the plain version too; the checksum's
    partials sum the kernel's own planes. One launch each."""
    cfg, inputs = _big_inputs(cuda, precision)
    n = cfg.resolution
    ts = [11.25]
    rows, cols = _launches("launch_fourstep_row"), _launches("launch_fourstep_col")
    y = fs.launch_fourstep_row(inputs, ts, cfg)
    planes, partials = fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True)
    assert _launches("launch_fourstep_row") == rows + 1
    assert _launches("launch_fourstep_col") == cols + 1
    assert y.shape == (1, 2, 2, n, n) and planes.shape == (1, 3, n, n)
    for base in (n // 2 - 3, n - 16):
        want = fs.fourstep_row_reference(inputs, ts, cfg, row_base=base, rows=16)
        assert _rel(y[..., base:base + 16, :], want) < TOL_BODY[precision]
        band = fs.launch_fourstep_row(inputs, ts, cfg, row_base=base, rows=16)
        assert torch.equal(band, y[..., base:base + 16, :])
        two = fs.launch_fourstep_row(inputs, ts + [3.5], cfg, row_base=base, rows=16)
        assert torch.equal(two[:1], band)
        want = fs.fourstep_row_reference(inputs, [3.5], cfg, row_base=base, rows=16)
        assert _rel(two[1:], want) < TOL_BODY[precision]
    for c0 in (4096 + 32, n - 128):
        want = fs.fourstep_col_reference(y[..., c0:c0 + 128].contiguous(), cfg)
        assert _rel(planes[..., c0:c0 + 128], want) < TOL_BODY[precision]
    # the split kernel on a band's two windows (a row-sharded shard)
    base = 3 * (n // 4)
    windows = band_windows(inputs.h0, inputs.omega, base, 16)
    band = fs.launch_fourstep_row(fs.FourstepInputs(None, None, inputs.twiddle), ts, cfg,
                                  base, 16, windows)
    assert torch.equal(band, y[..., base:base + 16, :])
    del y
    assert bool(torch.isfinite(planes).all())
    assert _checksum_rel(partials.sum(-1), planes, cfg) < TOL_CHECKSUM


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
@pytest.mark.parametrize("normals", [True, False], ids=["normals", "no-normals"])
def test_fourstep_checksum_partials(cuda, normals, precision):
    """K3's partials: one a block of its second stage (the planes' sums:
    N / 128 blocks a 32-column band for the FFT body, 128 for the tiered
    body), then one a block of the normals' pass when the config computes
    normals."""
    n = 1024
    cfg, inputs = _fourstep_inputs(n, CompatFlags(), cuda, precision)
    cfg = dataclasses.replace(cfg, compute_normals=normals)
    ts = torch.tensor([3.25, 1000.0], device=cuda)
    planes, partials = fs.launch_fourstep_step(inputs, ts, cfg, checksum=True)
    stage2 = (n // 128 if precision == "highest" else 128) * (n // fs.COL_BAND)
    assert partials.shape == (2, stage2 + (n // fs.CHECKSUM_ROWS if normals else 0))
    summands = planes.abs().sum(dim=(-3, -2, -1))
    assert float(((partials[:, :stage2].sum(-1) - planes.sum(dim=(-3, -2, -1))).abs()
                  / summands).max()) < TOL_CHECKSUM
    assert _checksum_rel(partials.sum(-1), planes, cfg) < TOL_CHECKSUM


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 1024])
def test_split_tiers_run_one_body(cuda, n):
    """"high" and "bf16x4" run the tiered body of "bf16x3", as the JAX
    kernels run them (pallas_step._make_dot): bit-equal planes through K1
    (512) and K2 + K3 (1024), one launch a call each."""
    ts = torch.tensor([0.5, 11.25], device=cuda)
    runs = {}
    for precision in ("bf16x3", "high", "bf16x4"):
        cfg, inputs = _fourstep_inputs(n, CompatFlags(), cuda, precision)
        runs[precision] = fused_step.packed_planes(inputs, ts, cfg)
    assert torch.equal(runs["high"], runs["bf16x3"])
    assert torch.equal(runs["bf16x4"], runs["bf16x3"])
    cfg, inputs = _fourstep_inputs(n, CompatFlags(), cuda, "highest")
    assert not torch.equal(fused_step.packed_planes(inputs, ts, cfg), runs["bf16x3"])


@pytest.mark.cuda
def test_fourstep_counts_launches_and_rejects_bad_inputs(cuda):
    cfg, inputs = _fourstep_inputs(1024, CompatFlags(), cuda)
    rows, cols = _launches("launch_fourstep_row"), _launches("launch_fourstep_col")
    k1 = _launches("launch_packed_step")
    fused_step.packed_checksums(inputs, [1.0, 2.0], cfg)
    fused_step.packed_planes(inputs, [1.0], cfg)
    assert _launches("launch_fourstep_row") == rows + 2
    assert _launches("launch_fourstep_col") == cols + 2
    assert _launches("launch_packed_step") == k1

    def rejected(match, fn):
        with pytest.raises(ValueError, match=match):
            fn()

    rejected("contiguous float32", lambda: fs.launch_fourstep_row(
        inputs._replace(h0=inputs.h0.double()), [1.0], cfg))
    rejected("contiguous float32", lambda: fs.launch_fourstep_row(
        inputs._replace(omega=inputs.omega.t()), [1.0], cfg))
    rejected("expected shape", lambda: fs.launch_fourstep_row(
        inputs._replace(h0=inputs.h0[:, :512].contiguous()), [1.0], cfg))
    rejected("outside", lambda: fs.launch_fourstep_row(inputs, [1.0], cfg, row_base=16,
                                                       rows=1024))
    rejected("outside", lambda: fs.launch_fourstep_row(inputs, [1.0], cfg, rows=0))
    rejected("needs CUDA tensors", lambda: fs.launch_fourstep_row(
        fs.FourstepInputs(*(x.cpu() for x in inputs)), [1.0], cfg))
    for n in (512, 1536):  # below the range, not a power of two
        bad = fs.FourstepInputs(torch.zeros(2, n, n, device=cuda), torch.zeros(n, n, device=cuda),
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
    assert _launches("launch_fourstep_row") == rows + 2
    assert _launches("launch_fourstep_col") == cols + 2


def _unpacked_inputs(n: int, flags: CompatFlags, device, precision: str = "bf16x3") -> tuple:
    h0, omega = _state(n)
    cfg = OceanConfig(resolution=n, fft_impl="pallas", hermitian_pack=False, compat=flags,
                      matmul_precision=precision)
    return cfg, fused_step.hoist_packed(h0.to(device), omega.to(device), cfg)


def _checksum_rel(got_ck: torch.Tensor, want: torch.Tensor, cfg) -> float:
    want_ck = fused_step.checksums_of_planes(want, cfg)
    summands = want.abs().sum(dim=(-3, -2, -1))
    if cfg.compute_normals:
        summands = summands + finite_difference_normals_planes(want[:, 1]).abs().sum(
            dim=(-3, -2, -1))
    return float(((got_ck - want_ck).abs() / summands).max())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", BODIES)
@pytest.mark.parametrize("n", [16, 64, 128, 512])
@pytest.mark.parametrize("flags", FLAGS, ids=["default", "wrap_k", "canonical_sign", "conj_neg"])
def test_unpacked_step_kernel_matches_plain(cuda, n, flags, precision):
    """K4 against its plain version, t up to 1000 s: the FFT body at
    "highest" (alone at 512, where the route is K5 + K6), the tiered body K4t
    at the split and at "default" (the single route)."""
    cfg, inputs = _unpacked_inputs(n, flags, cuda, precision)
    single = us.unpacked_route(cfg, n) == "single"
    assert isinstance(inputs, us.UnpackedInputs) and single == (precision != "highest" or n < 512)
    ts = torch.tensor([0.0, 3.25, 11.25, 1000.0], device=cuda)
    before = _launches("launch_unpacked_step"), _launches("launch_unpacked_step", "tiered_launches")
    got = (fused_step.packed_planes(inputs, ts, cfg) if single
           else us.launch_unpacked_step(inputs, ts, cfg))
    assert (_launches("launch_unpacked_step"),
            _launches("launch_unpacked_step", "tiered_launches")) == (
        before[0] + 1, before[1] + int(precision != "highest"))
    want = us.unpacked_planes_reference(inputs, ts, cfg)
    assert got.shape == (4, 3, n, n) and torch.isfinite(got).all()
    assert _rel(got, want) < TOL_BODY[precision]
    got_ck = (fused_step.packed_checksums(inputs, ts, cfg) if single
              else us.launch_unpacked_step_checksums(inputs, ts, cfg)[1].sum(-1))
    tol_ck = TOL_CHECKSUM if precision != "default" else 1e-3
    assert _checksum_rel(got_ck, want, cfg) < tol_ck


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("n", [16, 64, 128, 512])
@pytest.mark.parametrize("tb", [1, 6])
def test_k4t_persistent_plan_matches_plain(cuda, tb, n, precision):
    """K4t's persistent passes at the plans of one frame and of a time
    batch of 6 (the rollout), from one group at N <= 64 (the table padded to
    64 rows) to the lo ring's every slot at 512: against the plain version
    at the body tolerance, the checksums on the scale of their summands; one
    tiered launch a call."""
    cfg, inputs = _unpacked_inputs(n, CompatFlags(), cuda, precision)
    ts = torch.arange(tb, dtype=torch.float32, device=cuda) * 0.7 + 1.0
    before = _launches("launch_unpacked_step", "tiered_launches")
    got = us.launch_unpacked_step(inputs, ts, cfg)
    assert _launches("launch_unpacked_step", "tiered_launches") == before + 1
    want = us.unpacked_planes_reference(inputs, ts, cfg)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got, want) < TOL_BODY[precision]
    got_ck = us.launch_unpacked_step_checksums(inputs, ts, cfg)[1].sum(-1)
    tol_ck = TOL_CHECKSUM if precision != "default" else 1e-3
    assert _checksum_rel(got_ck, want, cfg) < tol_ck


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 256, 512])
def test_unpacked_blocked_kernels_match_plain(cuda, n):
    """K5 alone (Y), K6 alone (fed K5's Y), both chained, and K4, which
    runs the same device functions, bit-equal to the chain."""
    cfg, inputs = _unpacked_inputs(n, CompatFlags(conj_neg=True), cuda, "highest")
    ts = torch.tensor([0.0, 11.25, 1000.0], device=cuda)
    y = us.launch_unpacked_rows(inputs, ts, cfg)
    assert y.shape == (3, 3, 2, n, n) and torch.isfinite(y).all()
    assert _rel(y, us.unpacked_rows_reference(inputs, ts, cfg)) < TOL_PLANES
    planes = us.launch_unpacked_cols(y, inputs)
    assert _rel(planes, us.unpacked_cols_reference(y, inputs)) < TOL_PLANES
    want = us.unpacked_planes_reference(inputs, ts, cfg)
    assert _rel(planes, want) < TOL_PLANES
    assert torch.equal(us.launch_unpacked_step(inputs, ts, cfg), planes)
    if n == 512:
        assert us.unpacked_route(cfg, n) == "blocked"
        k5, k6 = _launches("launch_unpacked_rows"), _launches("launch_unpacked_cols")
        k4 = _launches("launch_unpacked_step")
        assert torch.equal(fused_step.packed_planes(inputs, ts, cfg), planes)
        assert _checksum_rel(fused_step.packed_checksums(inputs, ts, cfg), want, cfg) < TOL_CHECKSUM
        assert (_launches("launch_unpacked_rows"), _launches("launch_unpacked_cols"),
                _launches("launch_unpacked_step")) == (k5 + 2, k6 + 2, k4)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["k4", "k5+k6"])
@pytest.mark.parametrize("n", [16, 64, 512])
def test_unpacked_checksum_kernel_matches_plain(cuda, n, route):
    """The checksum kernel behind K4 and behind K6 (fed K5's Y) against
    ``checksums_of_planes`` of the plain planes, with and without normals;
    the planes equal those of the launch without a checksum."""
    # K5 + K6 serve "highest" only; K4 runs its tiered body at "bf16x3"
    cfg, inputs = _unpacked_inputs(n, CompatFlags(), cuda,
                                   "bf16x3" if route == "k4" else "highest")
    ts = torch.tensor([0.0, 3.25, 11.25, 1000.0], device=cuda)
    want = us.unpacked_planes_reference(inputs, ts, cfg)
    for c in (cfg, dataclasses.replace(cfg, compute_normals=False)):
        if route == "k4":
            planes, partials = us.launch_unpacked_step_checksums(inputs, ts, c)
        else:
            planes, partials = us.launch_unpacked_cols_checksums(
                us.launch_unpacked_rows(inputs, ts, c), inputs, c)
        assert partials.shape == (4, n // fs.CHECKSUM_ROWS)
        assert torch.equal(planes, us.launch_unpacked_step(inputs, ts, c))
        assert _checksum_rel(partials.sum(-1), want, c) < TOL_CHECKSUM


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16x3", "highest"], ids=["k4", "k5+k6"])
def test_unpacked_frames_identical_for_every_time_batch(cuda, precision):
    cfg, inputs = _unpacked_inputs(512, CompatFlags(), cuda, precision)
    ts = torch.arange(6, dtype=torch.float32, device=cuda) * 0.7 + 1.0
    batch = fused_step.packed_planes(inputs, ts, cfg)
    for j in range(6):
        assert torch.equal(batch[j], fused_step.packed_planes(inputs, ts[j:j + 1], cfg)[0])


@pytest.mark.cuda
def test_unpacked_counts_launches_and_rejects_bad_inputs(cuda):
    cfg, inputs = _unpacked_inputs(64, CompatFlags(), cuda)
    counts = (_launches("launch_unpacked_step"), _launches("launch_unpacked_rows"),
              _launches("launch_unpacked_cols"))
    tiered = _launches("launch_unpacked_step", "tiered_launches")
    fused_step.packed_checksums(inputs, [1.0, 2.0], cfg)
    assert _launches("launch_unpacked_step") == counts[0] + 1
    assert _launches("launch_unpacked_step", "tiered_launches") == tiered + 1  # K4t at "bf16x3"
    k1 = _launches("launch_packed_step")

    def rejected(match, fn):
        with pytest.raises(ValueError, match=match):
            fn()

    for launch in (lambda i: us.launch_unpacked_step(i, [1.0], cfg),
                   lambda i: us.launch_unpacked_rows(i, [1.0], cfg)):
        rejected("contiguous float32", lambda: launch(inputs._replace(h0=inputs.h0.double())))
        rejected("contiguous float32", lambda: launch(inputs._replace(omega=inputs.omega.t())))
        rejected("expected shape", lambda: launch(
            inputs._replace(h0=inputs.h0[:, :32, :32].contiguous())))
        rejected("needs CUDA tensors", lambda: launch(us.UnpackedInputs(*(x.cpu() for x in inputs))))
    y = torch.zeros(1, 3, 2, 64, 64, device=cuda)
    rejected("expected shape", lambda: us.launch_unpacked_cols(y[:, :2].contiguous(), inputs))
    rejected("contiguous float32", lambda: us.launch_unpacked_cols(y.double(), inputs))
    rejected("needs CUDA tensors", lambda: us.launch_unpacked_cols(
        y.cpu(), us.UnpackedInputs(*(x.cpu() for x in inputs))))
    big = us.UnpackedInputs(torch.zeros(2, 1024, 1024, device=cuda),
                            torch.zeros(1024, 1024, device=cuda), torch.zeros(2, 512, device=cuda))
    rejected("power of two N", lambda: us.launch_unpacked_step(big, [1.0], cfg))
    rejected("FP32 FFT body", lambda: us.launch_unpacked_rows(inputs, [1.0], cfg))
    assert (_launches("launch_unpacked_step"), _launches("launch_unpacked_rows"),
            _launches("launch_unpacked_cols")) == (counts[0] + 1, counts[1], counts[2])
    assert _launches("launch_packed_step") == k1


def _render_disp(device) -> torch.Tensor:
    """A 64^2 displacement map (t = 5 s) of a Phillips state from a numpy
    draw seeded 64, on ``device``."""
    h0, omega = _state(64)
    from gfx_ocean_tpu_torch.models.ocean import OceanState, step  # noqa: PLC0415

    cfg = OceanConfig(resolution=64, fft_impl="matmul", compute_normals=False)
    return step(OceanState(h0, omega), 5.0, cfg).displacement.to(device)


SKIMMING = (np.array([31.0, 2.5, 55.0]), np.zeros(3))   # activates the giant pass
LOW = (np.array([60.0, 4.0, 150.0]), np.array([-0.2, 0.0, 0.0]))      # giant groups at 128 x 4
NEAR = (np.array([10.0, 4.0, 25.0]), np.array([-0.3, 0.0, 0.0]))     # in view of a 20 x 1 mesh


def _slot_tables(device, width, height, mesh=(128, 4), pose=None, y_origin=0,
                 full_height=None, pool=None):
    disp = _render_disp(device)
    cam = Camera()
    if pose is not None:
        cam.position, cam.rotation = pose[0].copy(), pose[1].copy()
    res, patches = mesh
    positions, uvs, tris = rr._mesh_constants(res, patches, device)
    interp = rr._interp_matrices(res, 64, device)
    fh = full_height or height
    bands = fh // height
    tabs = rr._slot_tables(disp, positions, uvs, tris, rr._view_proj(cam, width, fh, device),
                           width, height, pool or rr._auto_pool(width, height, bands), interp,
                           (patches, res), y_origin=y_origin, full_height=fh)
    return tabs, fh


# (width, height, mesh, pose, y_origin, full_height): 96x64 up to 1200x700,
# id_bits 17 (mesh 128 x 4) and 10 (mesh 20 x 1), a band at an odd y_origin.
SLOT_CASES = [
    (96, 64, (128, 4), None, 0, None),
    (96, 64, (20, 1), NEAR, 0, None),
    (96, 64, (32, 4), SKIMMING, 0, None),
    (480, 280, (128, 4), LOW, 0, None),
    (1200, 700, (128, 4), None, 0, None),
    (1200, 175, (128, 4), None, 175, 700),
]
SLOT_IDS = ["96x64", "96x64-id10", "96x64-skim", "480x280-low", "1200x700",
            "1200x700-band-175"]


@pytest.mark.cuda
@pytest.mark.parametrize("width,height,mesh,pose,y_origin,full_height", SLOT_CASES, ids=SLOT_IDS)
def test_raster_kernels_match_plain(cuda, width, height, mesh, pose, y_origin, full_height):
    """K7 on the frame's real slot table, then K8 on the real oct-sorted
    entries: bit-equal to the plain versions."""
    tabs, fh = _slot_tables(cuda, width, height, mesh, pose, y_origin, full_height)
    n_oct = tabs.octs_w * tabs.octs_h
    cov = rr._stage_scalars(tabs.total_covered, y_origin, cuda)
    args = (tabs.crow, cov, width, fh, tabs.octs_w, n_oct, 32 - tabs.id_bits, tabs.id_bits)
    keys, octs = rr.launch_slot_kernel(*args)
    want_keys, want_octs = rr.slot_stage_reference(*args)
    assert keys.shape == (rr._zq_key_rows(tabs.id_bits), tabs.crow.shape[1])
    assert torch.equal(keys, want_keys) and torch.equal(octs, want_octs)
    assert int((octs < n_oct).sum()) == int(tabs.total_covered) > 0
    so, sk = rr._oct_sort(keys, octs, n_oct)
    mins, skey = rr.launch_segmin_kernel(so, sk, n_oct, tabs.id_bits)
    want_mins, want_skey = rr.segmin_stage_reference(so, sk, n_oct, tabs.id_bits)
    assert torch.equal(mins, want_mins) and torch.equal(skey, want_skey)
    assert int((skey < n_oct).sum()) == n_oct


@pytest.mark.cuda
@pytest.mark.parametrize("id_bits", [17, 10])
def test_segmin_kernel_runs_spanning_blocks(cuda, id_bits):
    """K8 at the 1200x700 resolve size with a run over ~30 blocks of 1024
    and random packed rows, against the plain log-shift."""
    n, n_oct = 735_784, 105_000
    rng = np.random.default_rng(id_bits)
    so = np.sort(np.concatenate([rng.integers(0, n_oct + 1, n - 30_000), np.full(30_000, 5_000)]))
    sk = rng.integers(-2**31, 2**31, (rr._zq_key_rows(id_bits), n), dtype=np.int64)
    so_t = torch.from_numpy(so.astype(np.int32)).to(cuda)
    sk_t = torch.from_numpy(sk.astype(np.int32)).to(cuda)
    mins, skey = rr.launch_segmin_kernel(so_t, sk_t, n_oct, id_bits)
    want_mins, want_skey = rr.segmin_stage_reference(so_t, sk_t, n_oct, id_bits)
    assert torch.equal(mins, want_mins) and torch.equal(skey, want_skey)


def _segmin_case(kind: str, n: int, rng):
    """Ascending run ids (n,) and n_oct for K8: runs inside its 1024-entry
    tiles, runs over many tiles, one run over every tile, a tile wholly
    inside a run."""
    tile = rr.SEGMIN_TILE
    if kind == "short_runs":
        return np.sort(rng.integers(0, n // 3, n)), n // 3
    if kind == "spanning_runs":
        return np.sort(np.concatenate([rng.integers(0, 4000, n - 3 * (n // 4)),
                                       np.full(n // 4, 50), np.full(n // 4, 2000),
                                       np.full(n // 4, 3999)])), 4000
    if kind == "one_run":
        return np.full(n, 7), 9
    ids = np.sort(rng.integers(0, 100_000, n))  # tile_inside_run
    ids[5 * tile - 5:6 * tile + 3] = ids[5 * tile - 5]
    return ids, 100_000


@pytest.mark.cuda
@pytest.mark.parametrize("id_bits", [17, 10])
@pytest.mark.parametrize("kind", ["short_runs", "spanning_runs", "one_run", "tile_inside_run"])
@pytest.mark.parametrize("n", [735_784, 100_003], ids=["frame-size", "ragged"])
def test_segmin_kernel_lookback_cases(cuda, n, kind, id_bits):
    """K8's look-back on the cases of tests/test_torch_segmin_lookback.py
    at the frame's resolve size (16-byte loads) and at an n that is not a
    multiple of 4 (scalar loads): bit-equal to the plain version, three
    calls in a row on one stream's look-back state."""
    rng = np.random.default_rng([n, id_bits])
    for _ in range(3):
        so, n_oct = _segmin_case(kind, n, rng)
        sk = rng.integers(-2**31, 2**31, (rr._zq_key_rows(id_bits), n), dtype=np.int64)
        so_t = torch.from_numpy(so.astype(np.int32)).to(cuda)
        sk_t = torch.from_numpy(sk.astype(np.int32)).to(cuda)
        mins, skey = rr.launch_segmin_kernel(so_t, sk_t, n_oct, id_bits)
        want_mins, want_skey = rr.segmin_stage_reference(so_t, sk_t, n_oct, id_bits)
        assert torch.equal(mins, want_mins) and torch.equal(skey, want_skey)


@pytest.mark.cuda
def test_segmin_kernel_is_one_launch_a_call(cuda):
    """torch.profiler sees one K8 kernel a call and no other device work
    but at most one memset a call (the look-back state is made by the
    first call and reused)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    n, n_oct, calls = 735_784, 105_000, 4
    rng = np.random.default_rng(3)
    so = torch.from_numpy(np.sort(rng.integers(0, n_oct + 1, n)).astype(np.int32)).to(cuda)
    sk = torch.from_numpy(rng.integers(-2**31, 2**31, (5, n), dtype=np.int64)
                          .astype(np.int32)).to(cuda)
    rr.launch_segmin_kernel(so, sk, n_oct, 17)
    torch.cuda.synchronize()
    before = _launches("launch_segmin_kernel")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            rr.launch_segmin_kernel(so, sk, n_oct, 17)
        torch.cuda.synchronize()
    assert _launches("launch_segmin_kernel") == before + calls
    counts = {e.key: e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.count}
    k8 = sum(c for k, c in counts.items() if "segmin_lookback" in k)
    memsets = sum(c for k, c in counts.items() if "memset" in k.lower())
    assert k8 == calls and memsets <= calls, counts
    assert all("segmin_lookback" in k or "memset" in k.lower() for k in counts), counts


class _PlainRaster:
    """Routes the rasterizer's K7 / K8 / K9 dispatchers to their plain
    versions (on the card) for the duration of a ``with`` block."""

    def __enter__(self):
        self.saved = rr.slot_stage, rr.segmin_stage, rr.giant_stage

        def slot(crow, total_covered, width, full_height, octs_w, spill_oct, bw_bits,
                 id_bits, y_origin=0):
            cov = rr._stage_scalars(total_covered, y_origin, crow.device)
            return rr.slot_stage_reference(crow, cov, width, full_height, octs_w, spill_oct,
                                           bw_bits, id_bits)

        rr.slot_stage, rr.segmin_stage = slot, rr.segmin_stage_reference
        rr.giant_stage = rr.giant_pass_reference
        return self

    def __exit__(self, *exc):
        rr.slot_stage, rr.segmin_stage, rr.giant_stage = self.saved


@pytest.mark.cuda
@pytest.mark.parametrize("pose", [None, SKIMMING], ids=["default", "skimming"])
def test_frame_through_kernels_equals_plain_and_bands(cuda, pose):
    """A 96x64 frame through K7 + K8 + K9 equals the plain-version frame bit
    for bit, and 4 bands stack to it; each frame launches K7, K8 and K9
    once, K9 over the whole giant selection whether a group is active (the
    skimming pose) or not."""
    disp = _render_disp(cuda)
    cam = Camera()
    if pose is not None:
        cam.position, cam.rotation = pose[0].copy(), pose[1].copy()
    res, patches, w, h = 32, 4, 96, 64
    positions, uvs, tris = rr._mesh_constants(res, patches, cuda)
    interp = rr._interp_matrices(res, 64, cuda)
    vp = rr._view_proj(cam, w, h, cuda)
    cp = torch.tensor(cam.position.astype(np.float32), device=cuda)
    args = (disp, positions, uvs, tris, vp, cp)
    k7, k8 = _launches("launch_slot_kernel"), _launches("launch_segmin_kernel")
    k9 = _launches("launch_giant_kernel")
    full, fz = rr._rasterize_pool(*args, w, h, rr._auto_pool(w, h), 512, interp, (patches, res))
    assert _launches("launch_slot_kernel") == k7 + 1
    assert _launches("launch_segmin_kernel") == k8 + 1
    assert _launches("launch_giant_kernel") == k9 + 1
    with _PlainRaster():
        plain, pz = rr._rasterize_pool(*args, w, h, rr._auto_pool(w, h), 512, interp,
                                       (patches, res))
    assert torch.equal(full, plain) and torch.equal(fz, pz)
    bh = h // 4
    bands = [rr._rasterize_pool(*args, w, bh, rr._auto_pool(w, bh, 4), 512, interp,
                                (patches, res), y_origin=k * bh, full_height=h)
             for k in range(4)]
    assert torch.equal(torch.cat([b[0] for b in bands]), full)
    assert torch.equal(torch.cat([b[1] for b in bands]), fz)


@pytest.mark.cuda
def test_raster_kernels_reject_bad_inputs(cuda):
    tabs, _ = _slot_tables(cuda, 96, 64)
    cov = rr._stage_scalars(tabs.total_covered, 0, cuda)
    ib = tabs.id_bits
    k7, k8 = _launches("launch_slot_kernel"), _launches("launch_segmin_kernel")

    def rejected(match, fn):
        with pytest.raises(ValueError, match=match):
            fn()

    rejected("contiguous", lambda: rr.launch_slot_kernel(
        tabs.crow.to(torch.int64), cov, 96, 64, 24, 768, 32 - ib, ib))
    rejected("expected shape", lambda: rr.launch_slot_kernel(
        tabs.crow[:18].contiguous(), cov, 96, 64, 24, 768, 32 - ib, ib))
    rejected("needs CUDA tensors", lambda: rr.launch_slot_kernel(
        tabs.crow.cpu(), cov.cpu(), 96, 64, 24, 768, 32 - ib, ib))
    rejected("out of range", lambda: rr.launch_slot_kernel(
        tabs.crow, cov, 96, 64, 24, 768, 32 - ib, 25))
    so = torch.zeros(16, dtype=torch.int32, device=cuda)
    rejected("expected shape", lambda: rr.launch_segmin_kernel(
        so, torch.zeros((4, 16), dtype=torch.int32, device=cuda), 8, 17))
    rejected("contiguous", lambda: rr.launch_segmin_kernel(
        so.to(torch.int64), torch.zeros((5, 16), dtype=torch.int32, device=cuda), 8, 17))
    rejected("needs CUDA tensors", lambda: rr.launch_segmin_kernel(
        so.cpu(), torch.zeros((5, 16), dtype=torch.int32), 8, 17))
    assert _launches("launch_slot_kernel") == k7
    assert _launches("launch_segmin_kernel") == k8


# (width, height, mesh, pose, y_origin, full_height, pool, crossing): K9's
# cases. "starved": a pool below the scene's slot demand, so hundreds of
# triangles overflow it and several groups are active (all 512 giant slots,
# 16 groups, but in the band); crossing: an active candidate crosses the eye
# plane (score inf).
GIANT_CASES = [
    (96, 64, (32, 4), SKIMMING, 0, None, None, True),
    (96, 64, (32, 4), SKIMMING, 0, None, 2_000, True),
    (480, 280, (128, 4), LOW, 0, None, None, True),
    (480, 280, (128, 4), LOW, 0, None, 60_000, True),
    (480, 70, (128, 4), LOW, 140, 280, 20_000, True),
    (1200, 700, (128, 4), LOW, 0, None, None, True),
    (1200, 700, (128, 4), None, 0, None, 300_000, False),
    (1200, 175, (128, 4), None, 175, 700, 80_000, False),
]
GIANT_IDS = ["96x64-skim", "96x64-skim-starved", "480x280-low", "480x280-low-starved",
             "480x70-low-band-140-starved", "1200x700-low", "1200x700-starved",
             "1200x175-band-175-starved"]


def _giant_inputs(tabs, tris, key_img, width, height, fh, y_origin):
    """The frame's whole giant selection (16 groups, the active ones
    first) and the other arguments of K9 / its plain version."""
    ids, ok, _ = rr._giant_selection(tabs.score, 512)
    return (ids, ok, tabs.clip, tris, tabs.score, key_img, width, height, fh, y_origin,
            tabs.id_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("width,height,mesh,pose,y_origin,full_height,pool,crossing",
                         GIANT_CASES, ids=GIANT_IDS)
def test_giant_kernel_matches_plain(cuda, width, height, mesh, pose, y_origin, full_height,
                                    pool, crossing):
    """K9 on the frame's real key image and whole giant selection, bands
    included: bit-equal to the plain version's group loop."""
    tabs, fh = _slot_tables(cuda, width, height, mesh, pose, y_origin, full_height, pool)
    tris = rr._mesh_constants(mesh[0], mesh[1], cuda)[2]
    n_oct = tabs.octs_w * tabs.octs_h
    keys, octs = rr.slot_stage(tabs.crow, tabs.total_covered, width, fh, tabs.octs_w, n_oct,
                               32 - tabs.id_bits, tabs.id_bits, y_origin)
    key_img = rr._resolve(keys, octs, tabs, width, height)
    args = _giant_inputs(tabs, tris, key_img, width, height, fh, y_origin)
    ids, ok = args[0], args[1]
    active_groups = int(ok.any(dim=1).sum())
    assert ids.shape[0] == 16 and active_groups > (1 if pool else 0)  # several where starved
    assert bool(torch.isinf(tabs.score[ids[ok]]).any()) == crossing
    before = key_img.clone()
    got = rr.launch_giant_kernel(*args)
    want = rr.giant_pass_reference(*args)
    assert torch.equal(key_img, before)                 # K9 writes a new image
    assert got.shape == (height, width) and got.dtype == torch.int64
    assert torch.equal(got, want)
    assert bool((want != key_img).any())


@pytest.mark.cuda
def test_giant_kernel_whole_frame_equals_plain(cuda):
    """Whole 1200x700 frames at giants=512 through K7 + K8 + K9 equal the
    plain-version frames bit for bit, image and depth: the low pose (a
    crossing group), the default pose on a starved pool (16 groups) and at
    the frame's pool (no active group). K9 is launched once on every frame,
    over the whole selection."""
    disp = _render_disp(cuda)
    w, h = 1200, 700
    positions, uvs, tris = rr._mesh_constants(128, 4, cuda)
    interp = rr._interp_matrices(128, 64, cuda)
    for pose, pool in ((LOW, None), (None, 300_000), (None, None)):
        cam = Camera()
        if pose is not None:
            cam.position, cam.rotation = pose[0].copy(), pose[1].copy()
        args = (disp, positions, uvs, tris, rr._view_proj(cam, w, h, cuda),
                torch.tensor(cam.position.astype(np.float32), device=cuda), w, h,
                pool or rr._auto_pool(w, h), 512, interp, (4, 128))
        k9 = _launches("launch_giant_kernel")
        img, z, dropped = rr._rasterize_pool(*args, with_diag=True)
        assert _launches("launch_giant_kernel") == k9 + 1
        with _PlainRaster():
            plain, pz = rr._rasterize_pool(*args)
        assert _launches("launch_giant_kernel") == k9 + 1
        assert torch.equal(img, plain) and torch.equal(z, pz)
        assert (int(dropped) > 0) == (pool is not None)


@pytest.mark.cuda
def test_giant_kernel_rejects_bad_inputs(cuda):
    tabs, fh = _slot_tables(cuda, 96, 64, (32, 4), SKIMMING)
    tris = rr._mesh_constants(32, 4, cuda)[2]
    key_img = torch.full((64, 96), rr.KEY_MAX, dtype=torch.int64, device=cuda)
    args = list(_giant_inputs(tabs, tris, key_img, 96, 64, fh, 0))
    k9 = _launches("launch_giant_kernel")

    def rejected(match, **swap):
        names = ("ids", "ok", "clip", "tris", "score", "key_img")
        bad = [swap.get(n, a) for n, a in zip(names, args)] + args[len(names):]
        with pytest.raises(ValueError, match=match):
            rr.launch_giant_kernel(*bad)

    rejected("contiguous", key_img=key_img.to(torch.int32))
    rejected("contiguous", key_img=key_img.t().contiguous().t())
    rejected("contiguous", ok=args[1].to(torch.uint8))
    rejected("contiguous", ids=args[0].to(torch.int32))
    rejected("contiguous", clip=args[2].to(torch.float64))
    rejected("expected shape", key_img=key_img[:32].contiguous())
    rejected("expected shape", ids=torch.cat([args[0], args[0]], 1))
    rejected("expected shape", score=args[4][:-1].contiguous())
    rejected("non-empty", ids=args[0][:0], ok=args[1][:0])
    rejected("needs CUDA tensors", key_img=key_img.cpu())
    rejected("contiguous", clip=args[2].cpu())
    with pytest.raises(ValueError, match="out of range"):
        rr.launch_giant_kernel(*args[:-1], 25)
    assert _launches("launch_giant_kernel") == k9


# --- the frame's stages as CUDA graphs (render/raster._StageGraphs) ---------

CELL = OceanConfig(resolution=512, fft_impl="pallas")    # the benchmark's frame: K1t at bf16x3
CELL_W, CELL_H = 1200, 700
SMALL = OceanConfig(resolution=64, fft_impl="matmul", mesh_resolution=32, num_patches=4)


def _card_state(cfg, device, seed: int = 0):
    from gfx_ocean_tpu_torch.models.ocean import ocean_state_from_phillips  # noqa: PLC0415

    return ocean_state_from_phillips(cfg, generator=torch.Generator().manual_seed(seed),
                                     device=device)


def _view(pose, width, height, device):
    cam = Camera()
    if pose is not None:
        cam.position, cam.rotation = pose[0].copy(), pose[1].copy()
    return (rr._view_proj(cam, width, height, device),
            torch.tensor(cam.position.astype(np.float32), device=device))


def _scales(cfg):
    return (float(cfg.height_div), float(cfg.horiz_div), float(cfg.normal_height_scale),
            float(cfg.pbr_roughness))


def _eager_frame(cfg, state, t, vp, cp, width, height, giants=512, band=0, n_bands=1):
    """The frame renderer's body run eagerly, one launch at a time: the
    step, ``_rasterize_pool`` and sRGB. Returns (frame, depth, the count
    of giant-pass candidates past capacity)."""
    from gfx_ocean_tpu_torch.models.ocean import step  # noqa: PLC0415

    cfg = dataclasses.replace(cfg, compute_normals=False)
    fields = step(state, t, cfg)
    dev = vp.device
    positions, uvs, tris = rr._mesh_constants(cfg.mesh_resolution, cfg.num_patches, dev)
    tiles, interp = rr._cascade_setup(fields.displacement, cfg.domains, cfg.mesh_resolution,
                                      dev)
    bh = height // n_bands
    img, depth, dropped = rr._rasterize_pool(
        fields.displacement, positions, uvs, tris, vp, cp, width, bh,
        rr._auto_pool(width, bh, n_bands), giants, interp, (cfg.num_patches, cfg.mesh_resolution),
        fields.foam if cfg.compute_foam else None, 0 if cfg.compat.frag_normal_x else 1,
        _scales(cfg), tiles, y_origin=band * bh, full_height=height, with_diag=True)
    return rr.srgb8(img), depth, dropped


@pytest.mark.cuda
def test_graph_frames_equal_the_eager_body(cuda):
    """The benchmark's 1200x700 frame at 48 poses over its 8-s cycle (every
    10th frame at 60 Hz), the camera switching between the default and the
    low pose: the stages replayed as CUDA graphs equal the eager body bit
    for bit, image and depth, on giant and other frames (45 and 3 on an
    H100); the renderer's frames equal the eager frames."""
    from gfx_ocean_tpu_torch.models.ocean import step  # noqa: PLC0415

    state = _card_state(CELL, cuda)
    cfg = dataclasses.replace(CELL, compute_normals=False)
    positions, uvs, tris = rr._mesh_constants(128, 4, cuda)
    interp = rr._interp_matrices(128, 512, cuda)
    stages = rr._pool_stages(positions, uvs, tris, CELL_W, CELL_H,
                             rr._auto_pool(CELL_W, CELL_H), 512, interp, (4, 128), 1,
                             _scales(cfg), None, 0, CELL_H, False)
    views = [_view(None, CELL_W, CELL_H, cuda), _view(LOW, CELL_W, CELL_H, cuda)]

    def inputs(t, k):
        vp, cp = views[k % 2]
        return {"displacement": step(state, t, cfg).displacement, "view_proj": vp,
                "camera_pos": cp, "foam": None}

    graphs = rr._StageGraphs(stages, inputs(0.0, 0), cuda)
    fn = rr.make_frame_renderer(CELL, CELL_W, CELL_H)
    kinds = {True: 0, False: 0}
    for k in range(48):
        t = 10 * k / 60.0
        graphs.load(inputs(t, k))
        values = graphs.replay()
        eager, eager_depth, _ = _eager_frame(CELL, state, t, *views[k % 2], CELL_W, CELL_H)
        assert torch.equal(rr.srgb8(values["image"]), eager), k
        assert torch.equal(values["depth"], eager_depth), k
        assert torch.equal(fn(state, t, *views[k % 2]), eager), k
        kinds[int(values["giant_counts"][1]) > 0] += 1
    assert kinds[True] and kinds[False], kinds


@pytest.mark.cuda
def test_graph_frames_follow_the_camera(cuda):
    """The camera moves between calls, as the served and CLI renderers move
    it: each replayed frame equals the eager frame at its own camera, and
    a returned frame is not overwritten by later calls."""
    state = _card_state(SMALL, cuda)
    fn = rr.make_frame_renderer(SMALL, 96, 64)
    poses = [None, SKIMMING, LOW, None, SKIMMING]
    got, want = [], []
    for k, pose in enumerate(poses):
        vp, cp = _view(pose, 96, 64, cuda)
        got.append(fn(state, 0.5 * k, vp, cp))
        want.append(_eager_frame(SMALL, state, 0.5 * k, vp, cp, 96, 64)[0])
        assert torch.equal(got[-1], want[-1]), k
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [2, 4])
def test_graph_band_frames_stack_to_the_full_frame(cuda, n_bands):
    """2- and 4-band renderers, each band replayed from its own graphs,
    stack to the full renderer's 1200x700 frame bit for bit."""
    state = _card_state(CELL, cuda)
    full = rr.make_frame_renderer(CELL, CELL_W, CELL_H)
    bands = rr._frame_fn(CELL, CELL_W, CELL_H, 512, None, band_axis="row", n_bands=n_bands)
    for t, pose in ((1.0, None), (2.0, LOW), (3.0, None)):   # the first call captures
        vp, cp = _view(pose, CELL_W, CELL_H, cuda)
        want = full(state, t, vp, cp)
        got = torch.cat([bands(state, t, vp, cp, band=b) for b in range(n_bands)])
        assert torch.equal(got, want), t
    assert torch.equal(want, _eager_frame(CELL, state, 3.0, vp, cp, CELL_W, CELL_H)[0])


@pytest.mark.cuda
def test_graph_cascade_frame_matches(cuda):
    """Config 4's composited frame (three 512^2 cascades with foam) replayed
    as graphs equals its eager frame, with the tripwire's count."""
    cfg = OceanConfig(resolution=512, num_cascades=3, compute_foam=True, fft_impl="pallas")
    state = _card_state(cfg, cuda)
    fn = rr.make_frame_renderer(cfg, CELL_W, CELL_H, diag=True)
    for t, pose in ((0.0, None), (1.5, LOW), (4.0, None)):   # the first call captures
        vp, cp = _view(pose, CELL_W, CELL_H, cuda)
        frame, dropped = fn(state, t, vp, cp)
        want, _, want_dropped = _eager_frame(cfg, state, t, vp, cp, CELL_W, CELL_H)
        assert torch.equal(frame, want) and int(dropped) == int(want_dropped), t


@pytest.mark.cuda
def test_graph_batch_frames_are_distinct_and_equal_single_frames(cuda):
    """make_batch_renderer stacks copies: its frames differ from one another
    and each equals the eager frame of its time and camera."""
    state = _card_state(SMALL, cuda)
    strip = rr.make_batch_renderer(SMALL, 96, 64)
    poses = [None, SKIMMING, LOW, None]
    views = [_view(p, 96, 64, cuda) for p in poses]
    ts = [0.0, 1.0, 2.0, 3.0]
    for _ in range(2):                                       # the first call captures
        frames = strip(state, ts, torch.stack([v[0] for v in views]),
                       torch.stack([v[1] for v in views]))
    for i in range(len(ts)):
        assert torch.equal(frames[i], _eager_frame(SMALL, state, ts[i], *views[i], 96, 64)[0])
        assert not any(torch.equal(frames[i], frames[j]) for j in range(i))


@pytest.mark.cuda
def test_segmin_kernel_replayed_from_a_graph(cuda):
    """K8 captured once in a CUDA graph and replayed 200 times over four
    input sets at the frame's resolve size: every replay bit-equal to the
    plain version (a replay repeats its captured epoch, so its look-back
    state is zeroed inside the graph)."""
    n, n_oct = 735_784, 105_000
    rng = np.random.default_rng(5)
    cases = []
    for kind in ("short_runs", "spanning_runs", "one_run", "tile_inside_run"):
        so, k_oct = _segmin_case(kind, n, rng)
        so = torch.from_numpy(np.minimum(so, n_oct - 1).astype(np.int32)).to(cuda)
        sk = torch.from_numpy(rng.integers(-2**31, 2**31, (5, n), dtype=np.int64)
                              .astype(np.int32)).to(cuda)
        cases.append((so, sk, rr.segmin_stage_reference(so, sk, n_oct, 17)))
    so_in, sk_in = cases[0][0].clone(), cases[0][1].clone()
    rr.launch_segmin_kernel(so_in, sk_in, n_oct, 17)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        mins, skey = rr.launch_segmin_kernel(so_in, sk_in, n_oct, 17)
    for k in range(200):
        so, sk, (want_mins, want_skey) = cases[k % 4]
        so_in.copy_(so)
        sk_in.copy_(sk)
        graph.replay()
        assert torch.equal(mins, want_mins) and torch.equal(skey, want_skey), k


@pytest.mark.cuda
def test_graph_counters_after_the_warm_up(cuda):
    """The first call captures six graphs (``graph.captures`` 6); every
    later frame replays them (``graph.replays`` 6, no capture), launches
    K1t by its wrapper and K7, K8 and K9 once each inside the graphs, and
    counts the giant selection as the eager frame does."""
    state = _card_state(SMALL, cuda)
    fn = rr.make_frame_renderer(SMALL, 96, 64)
    vp, cp = _view(SKIMMING, 96, 64, cuda)
    with profiling.recording():
        fn(state, 0.0, vp, cp)
    (first,) = list(profiling.windows()[-1].units)
    assert first.counters["graph.captures"] == 6 and "graph.replays" not in first.counters
    with profiling.recording():
        for t in (1.0, 2.0, 3.0):
            fn(state, t, vp, cp)
    units = list(profiling.windows()[-1].units)
    assert len(units) == 3
    for unit in units:
        assert unit.counters["graph.replays"] == 6 and "graph.captures" not in unit.counters
        for name in ("launch_slot_kernel", "launch_segmin_kernel", "launch_giant_kernel"):
            assert unit.counters["launches." + name] == 1, unit.counters
        assert unit.counters["giant.groups"] > 0 and "host_syncs" not in unit.counters
        assert all(unit.device_ms(s) > 0 for s in ("frame.slot_tables", "frame.slots",
                                                  "frame.resolve", "frame.giant_pass",
                                                  "frame.shade", "frame.srgb"))
    eager = rr.make_frame_renderer(SMALL, 96, 64)            # its first call: eager
    with profiling.recording():
        eager(state, 3.0, vp, cp)
    (unit,) = list(profiling.windows()[-1].units)
    assert (units[-1].counters["giant.candidates"], units[-1].counters["giant.groups"]) == (
        unit.counters["giant.candidates"], unit.counters["giant.groups"])


@pytest.mark.cuda
def test_raster_stages_make_no_host_sync(cuda, monkeypatch):
    """With CUDA's sync check set to raise, the rasterizer's stages run
    eagerly (``_rasterize_pool``) and replayed as graphs (an unrecorded
    frame of the renderer, its step outside the check) without waiting for
    the device."""
    from gfx_ocean_tpu_torch.models import ocean  # noqa: PLC0415

    state = _card_state(SMALL, cuda)
    vp, cp = _view(SKIMMING, 96, 64, cuda)
    real_step = ocean.step

    def step_unchecked(*a, **k):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real_step(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(ocean, "step", step_unchecked)
    fn = rr.make_frame_renderer(SMALL, 96, 64)
    fn(state, 0.0, vp, cp)                                   # eager, then the captures
    disp = real_step(state, 1.0, dataclasses.replace(SMALL, compute_normals=False)).displacement
    positions, uvs, tris = rr._mesh_constants(32, 4, cuda)
    interp = rr._interp_matrices(32, 64, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rr._rasterize_pool(disp, positions, uvs, tris, vp, cp, 96, 64, rr._auto_pool(96, 64),
                           512, interp, (4, 32))
        frame = fn(state, 1.0, vp, cp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert frame.shape == (64, 96, 3)


def test_import_leaves_out_jax():
    code = ("import sys, gfx_ocean_tpu_torch, gfx_ocean_tpu_torch.kernels, "
            "gfx_ocean_tpu_torch.ops.fused_step, gfx_ocean_tpu_torch.ops.fourstep_step, "
            "gfx_ocean_tpu_torch.ops.unpacked_step, "
            "gfx_ocean_tpu_torch.render, gfx_ocean_tpu_torch.render.raster, "
            "gfx_ocean_tpu_torch.query, gfx_ocean_tpu_torch.checkpoint, "
            "gfx_ocean_tpu_torch.cli, gfx_ocean_tpu_torch.serve, "
            "gfx_ocean_tpu_torch.utils.profiling, gfx_ocean_tpu_torch.utils.png, "
            "gfx_ocean_tpu_torch.native.bincode_native, gfx_ocean_tpu_torch.assets, "
            "gfx_ocean_tpu_torch.golden, gfx_ocean_tpu_torch.parallel, "
            "gfx_ocean_tpu_torch.parallel.render, importlib.util;"
            # python -m gfx_ocean_tpu_torch runs __main__, which imports cli
            "assert importlib.util.find_spec('gfx_ocean_tpu_torch.__main__');"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gfx_ocean_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --- the launch boundary (kernels.launch) on the CPU, against a stand-in library

STAND_IN_CARD = torch.device("cuda", 0)


class _StandInLibrary:
    """A kernel library's stand-in: ``slot_stage`` records its arguments and
    returns ``code``; ``raster_error_string`` is the library's text."""

    def __init__(self):
        self.code, self.calls = 0, []

    def slot_stage(self, *args):
        self.calls.append(args)
        return self.code

    def raster_error_string(self, err):
        return f"stand-in error text {err}".encode()


@pytest.fixture
def stand_in(monkeypatch):
    """``kernels.load`` hands out a stand-in library, card 0 is the current
    device and its current stream is 7."""
    lib = _StandInLibrary()
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    return lib


@pytest.mark.parametrize("tiered", [False, True])
def test_launch_counts_one_launch_and_a_tiered_one_where_asked(stand_in, tiered):
    """One call: the entry point gets the arguments and the current stream,
    the table one ``launches.<counter>``, and one ``tiered_launches.<counter>``
    where asked."""
    before = profiling.tallies()
    kernels.launch("launch_stand_in", "raster", "slot_stage", 3, None, device=STAND_IN_CARD,
                   tiered=tiered)
    ((three, null, stream),) = stand_in.calls
    assert (three, null, stream.value) == (3, None, 7)
    want = {"launches.launch_stand_in": 1}
    if tiered:
        want["tiered_launches.launch_stand_in"] = 1
    assert profiling.grown(before) == want


def test_launch_raises_with_the_library_message_and_counts_nothing(stand_in):
    stand_in.code = 700
    before = profiling.tallies()
    with pytest.raises(RuntimeError, match=r"launch_stand_in: slot_stage \(tiered\) failed to "
                                           r"launch: CUDA error 700 \(stand-in error text 700\)"):
        kernels.launch("launch_stand_in", "raster", "slot_stage", 3, device=STAND_IN_CARD,
                       tiered=True)
    assert len(stand_in.calls) == 1 and profiling.grown(before) == {}


def test_launch_raises_off_the_current_device(stand_in, monkeypatch):
    """A ctypes launch goes to the current device's context: a card that is
    not the current device raises before the call, and counts nothing."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    before = profiling.tallies()
    with pytest.raises(RuntimeError, match="current device is cuda:1"):
        kernels.launch("launch_stand_in", "raster", "slot_stage", device=STAND_IN_CARD)
    assert stand_in.calls == [] and profiling.grown(before) == {}


def test_import_does_not_initialize_cuda():
    """Importing the CLI and the server starts nothing on a card: the port's
    counterpart of tests/test_cli.py::test_import_does_not_initialize_jax_backend
    (``--device`` is read in ``main``, and a test process must stay free to
    choose its device)."""
    code = ("import sys, torch, gfx_ocean_tpu_torch.cli, gfx_ocean_tpu_torch.serve, "
            "gfx_ocean_tpu_torch.render.raster;"
            "sys.exit(1 if torch.cuda.is_initialized() else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --- the precision tiers, the window rasterizer and the native loader on the card

TIER_CASES = [(512, 1024), (64, 16)]   # direct, and the four-step split


def _tier_spectra(n: int):
    rng = np.random.default_rng(n + 1)
    from gfx_ocean_tpu_torch.spectra.phillips import phillips_spectrum  # noqa: PLC0415

    env = np.sqrt(phillips_spectrum(n, 1000.0, PhillipsConfig()) / 2.0).astype(np.float32)
    return (torch.from_numpy((rng.standard_normal((3, n, n)) * env).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((3, n, n)) * env).astype(np.float32)))


# The card's tier against the CPU's same tier, |diff| / max |field|: the
# same exact products summed in another order, where the column pass's
# bf16 rounding of the row pass's output (its lo for the split tiers, all
# of it for "default") turns a float32 difference into a bf16 ulp now and
# then. Measured at 512^2 on an H100: bf16x3 6.5e-6, bf16x4 5.8e-6,
# "highest" 1.3e-6 (the CPU's FP32 sums), "default" 3.0e-4; the nearest
# other tier 8.0e-6 or more away from the split tiers.
TOL_TIER = {"bf16x3": 8e-6, "bf16x4": 8e-6, "high": 8e-6, "highest": 2e-6, "default": 1e-3}
TIER_SCHEME = {"high": "bf16x3"}


@pytest.mark.cuda
@pytest.mark.parametrize("n,direct_max", TIER_CASES, ids=["512", "64-fourstep"])
@pytest.mark.parametrize("tier", ["bf16x3", "bf16x4", "high", "highest", "default"])
def test_tier_on_card_equals_cpu_plain_path(cuda, tier, n, direct_max):
    """Each tier's card scheme (bf16 tensor-core passes returned in FP32, or
    float64 for "highest") against the same tier on the CPU, whose products
    are the same exact values: they differ by summation order only. At the
    direct size the card's result also lies nearer the CPU's same scheme
    than any other tier's, so a tier that ran another scheme on the card
    (FP32 included) fails."""
    from gfx_ocean_tpu_torch.ops import fft as tfft  # noqa: PLC0415

    xr, xi = _tier_spectra(n)

    def run(t, dev):
        kw = dict(direct_max=direct_max, precision=t, centered="ref")
        return [p.cpu() for p in tfft.ifft2_planes_unnorm(xr.to(dev), xi.to(dev), **kw)]

    def dist(a, b):
        return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))

    got = run(tier, cuda)
    assert all(g.dtype == torch.float32 for g in got)
    assert dist(got, run(tier, "cpu")) < TOL_TIER[tier]
    if n <= direct_max:
        own = TIER_SCHEME.get(tier, tier)
        d = {t: dist(got, run(t, "cpu")) for t in ("bf16x3", "bf16x4", "highest", "default")}
        assert all(d[own] < v for t, v in d.items() if t != own), d


@pytest.mark.cuda
def test_matmul_route_leaves_tf32_flag_alone(cuda):
    """No tier, plain version or renderer product reads or writes the
    process's TF32 switch: a matmul-route step, K1's plain version and the
    renderer's vertex stage leave it as the caller set it, either way, and
    compute the same."""
    from gfx_ocean_tpu_torch.models.ocean import OceanState, step  # noqa: PLC0415

    h0, omega = _state(64)
    st = OceanState(h0.to(cuda), omega.to(cuda))
    cfg1, inputs = _inputs(64, CompatFlags(), cuda)
    disp = _render_disp(cuda)
    cam = Camera()
    positions, uvs, _ = rr._mesh_constants(128, 4, cuda)
    interp = rr._interp_matrices(128, disp.shape[0], cuda)
    view_proj = rr._view_proj(cam, 480, 280, cuda)
    flag = torch.backends.cuda.matmul.allow_tf32
    outs = {}
    try:
        for setting in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = setting
            for tier in ("bf16x3", "highest", "default"):
                cfg = OceanConfig(resolution=64, fft_impl="matmul", matmul_precision=tier)
                outs[setting, tier] = step(st, 11.25, cfg).displacement
                assert torch.backends.cuda.matmul.allow_tf32 is setting
            outs[setting, "k1_plain"] = fused_step.packed_planes_reference(
                inputs, torch.tensor([11.25], device=cuda), cfg1)
            outs[setting, "vertex"] = torch.cat(
                rr._vertex_stage(disp, positions, uvs, view_proj, interp), dim=-1)
            assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    for key in ("bf16x3", "highest", "default", "k1_plain", "vertex"):
        assert torch.equal(outs[False, key], outs[True, key]), key


@pytest.mark.cuda
def test_window_frame_matches_pool_frame_on_card(cuda):
    """The window rasterizer against the pool rasterizer (K7 + K8) at 480x280,
    mesh 128 x 4: the near-tie envelope of tests/test_render.py:943-978
    (two programs), with every giant candidate kept."""
    disp = _render_disp(cuda)
    cam = Camera()
    w, h = 480, 280
    positions, uvs, tris = rr._mesh_constants(128, 4, cuda)
    interp = rr._interp_matrices(128, 64, cuda)
    args = (disp, positions, uvs, tris, rr._view_proj(cam, w, h, cuda),
            torch.tensor(cam.position.astype(np.float32), device=cuda))
    pool, pz, p_drop = rr._rasterize_pool(*args, w, h, rr._auto_pool(w, h), 512, interp,
                                          (4, 128), with_diag=True)
    win, wz, w_drop = rr._rasterize(*args, w, h, 32, 2048, interp, (4, 128), with_diag=True)
    assert int(p_drop) == 0 and int(w_drop) == 0
    pool, pz, win, wz = (x.cpu().numpy() for x in (pool, pz, win, wz))
    assert 0.2 < np.isfinite(wz).mean() < 1.0
    d = np.argwhere((pool != win).any(-1))
    assert len(d) <= 1e-3 * w * h
    quantum = 2.0 / (1 << (32 - rr._id_bits(tris.shape[0])))
    one_sided = sum(np.isinf(pz[y, x]) != np.isinf(wz[y, x]) for y, x in d)
    assert one_sided <= 8
    both = np.isfinite(pz) & np.isfinite(wz)
    assert np.abs(pz[both] - wz[both]).max() <= 2 * quantum


@pytest.mark.cuda
def test_native_loader_is_in_use_on_the_card_machine(cuda, tmp_path):
    """Where the card is, the native parser must be the one the loaders take."""
    from gfx_ocean_tpu_torch.assets import bincode  # noqa: PLC0415
    from gfx_ocean_tpu_torch.native import bincode_native  # noqa: PLC0415

    assert bincode.loader_in_use() == "native"
    omega = np.random.default_rng(2).random((32, 32)).astype(np.float32)
    path = str(tmp_path / "omega.bin")
    bincode.save_omega(path, omega)
    with open(path, "rb") as f:
        want = bincode.parse_bincode_f32(f.read(), path)
    assert np.array_equal(bincode_native.parse_f32(path), want)
    assert np.array_equal(bincode.load_omega(path, 32), omega)


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr
