"""K1's plain PyTorch version (``gfx_ocean_tpu_torch.ops.fused_step``)
against the JAX package's Pallas kernel ``_packed_grid_kernel``.

The JAX side runs as the JAX package's own tests run it on the CPU:
``pallas_planes`` / ``pallas_checksums`` with ``interpret=True``. The port
runs its plain version, which is what its wrapper takes for CPU tensors.

Tolerances, relative to the field's max |value|:
- "highest": both sides are float32-grade transforms of the same packed
  spectra, summed in different orders; measured ~2.5e-7, held to 1e-6.
- "bf16x3": both sides split each operand into bf16 halves and drop the
  lo*lo term (``pallas_step._dot3``), ~5e-6 against the float64 golden;
  they differ in the order of the FP32 sums, which the row pass's output,
  split again for the column pass, turns now and then into a bf16 ulp of
  its lo (measured 4.3e-6 at 64^2; tests/test_torch_tier_kernels.py). Held
  to 8e-6, and to 2e-5 against golden (the split tier's own error: the JAX
  figure 8e-6 of the shipped bins, up to 9.3e-6 on such spectra).
Checksums nearly cancel, so they are compared on the scale of their
summands (sum of |planes| and |normals|), as ``tests/test_pallas.py`` does.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.golden.reference import golden_fields
from gfx_ocean_tpu.ops.pallas_step import pallas_checksums, pallas_fields, pallas_planes
from gfx_ocean_tpu_torch.ops import fused_step, unpacked_step
from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum
from gfx_ocean_tpu_torch.utils import profiling

TOL = {"highest": 1e-6, "bf16x3": 8e-6}
# Against the float64 golden: FP32 at "highest", the split tier's own error
# at "bf16x3" (tests/test_torch_precision.py's SPLIT_GOLDEN).
GOLDEN = {"highest": 1e-6, "bf16x3": 2e-5}
CHECKSUM_TOL = 1e-6
FLAGS = [dict(), dict(ref_sign=False), dict(wrap_k=True)]
FLAG_IDS = ["default", "canonical", "wrap_k"]


def _launches(wrapper: str, kind: str = "launches") -> int:
    """The process-wide count ``<kind>.<wrapper>`` (``profiling.tallies``)."""
    return profiling.tallies().get(f"{kind}.{wrapper}", 0)


def _state(n: int, seed: int = 0):
    """A Phillips state at n^2 from a numpy draw: (h0 planes, omega)."""
    xi = np.random.default_rng(seed).standard_normal((2, n, n)).astype(np.float32)
    env = np.sqrt(phillips_spectrum(n, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    return xi * env, dispersion(n, 1000.0)


def _configs(n: int, precision: str, **kwargs):
    flags = kwargs.pop("flags", {})
    common = dict(resolution=n, fft_impl="pallas", matmul_precision=precision, **kwargs)
    return (J.OceanConfig(compat=J.CompatFlags(**flags), **common),
            T.OceanConfig(compat=T.CompatFlags(**flags), **common))


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("n", [64, 128])
def test_plain_k1_matches_pallas_kernel(n, precision, flags):
    h0, om = _state(n)
    jc, tc = _configs(n, precision, flags=flags)
    t = 11.25
    want = pallas_planes(jnp.asarray(h0), jnp.asarray(om), jnp.float32(t), jc, interpret=True)
    got = fused_step.fused_planes(torch.from_numpy(h0), torch.from_numpy(om), t, tc)
    assert got.shape == (3, n, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL[precision]
    gold = golden_fields(h0[0] + 1j * h0[1], om, t, 1000.0, jc.compat)
    assert _rel(np.moveaxis(got.numpy(), 0, -1), gold) < GOLDEN[precision]


def test_fused_fields_is_channel_last():
    h0, om = _state(64, 1)
    jc, tc = _configs(64, "highest")
    want = pallas_fields(jnp.asarray(h0), jnp.asarray(om), jnp.float32(3.25), jc, interpret=True)
    got = fused_step.fused_fields(torch.from_numpy(h0), torch.from_numpy(om), 3.25, tc)
    assert got.shape == (64, 64, 3)
    assert _rel(got.numpy(), want) < TOL["highest"]


def _summand_scale(planes: torch.Tensor, cfg) -> torch.Tensor:
    scale = planes.abs().sum(dim=(-3, -2, -1))
    if cfg.compute_normals:
        normals = finite_difference_normals_planes(planes[:, 1], cfg.normal_height_scale)
        scale = scale + normals.abs().sum(dim=(-3, -2, -1))
    return scale


@pytest.mark.parametrize("normals", [True, False])
@pytest.mark.parametrize("n", [64, 128])
def test_plain_k1_checksums_match_pallas_kernel(n, normals):
    h0, om = _state(n, 2)
    jc, tc = _configs(n, "highest", compute_normals=normals)
    ts = [0.3, 11.25, 1000.0]
    want = np.asarray(pallas_checksums(jnp.asarray(h0), jnp.asarray(om),
                                       jnp.asarray(ts, jnp.float32), jc, interpret=True))
    got = fused_step.fused_checksums(torch.from_numpy(h0), torch.from_numpy(om), ts, tc)
    assert got.shape == (3,)
    inputs = fused_step.hoist_packed(torch.from_numpy(h0), torch.from_numpy(om), tc)
    scale = _summand_scale(fused_step.packed_planes(inputs, ts, tc), tc).numpy()
    assert np.all(np.abs(got.numpy() - want) < CHECKSUM_TOL * scale)


def test_time_batch_frames_equal_single_frames():
    h0, om = _state(64, 4)
    _, tc = _configs(64, "bf16x3")
    inputs = fused_step.hoist_packed(torch.from_numpy(h0), torch.from_numpy(om), tc)
    ts = [1.0, 1.7, 2.4, 1000.0]
    batch = fused_step.packed_planes(inputs, ts, tc)
    assert batch.shape == (4, 3, 64, 64)
    for j, t in enumerate(ts):
        single = fused_step.packed_planes(inputs, [t], tc)[0]
        # the plain version's batched matmul may block differently from the
        # single one; the kernel's frames are bit-identical (CUDA test).
        assert _rel(batch[j].numpy(), single.numpy()) < 1e-7


def test_cpu_tensors_take_the_plain_version():
    h0, om = _state(32, 5)
    _, tc = _configs(32, "bf16x3")
    inputs = fused_step.hoist_packed(torch.from_numpy(h0), torch.from_numpy(om), tc)
    before = _launches("launch_packed_step")
    got = fused_step.packed_checksums(inputs, [1.0, 2.0], tc)
    assert torch.equal(got, fused_step.packed_checksums_reference(inputs, [1.0, 2.0], tc))
    assert _launches("launch_packed_step") == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fused_step.launch_packed_step(inputs, torch.tensor([1.0]), tc, checksum=False)
    assert _launches("launch_packed_step") == before


def test_unsupported_configurations_raise():
    # N > 512 takes the four-step route (K2 + K3) over the plan's range:
    # 16384 returns its tier (K2 runs a row on a cluster there), 32768
    # raises. No state is allocated.
    with pytest.raises(ValueError, match=r"\[1024, 16384\]"):
        fused_step.check_supported(T.OceanConfig(resolution=32768, fft_impl="pallas"), 32768)
    assert fused_step.check_supported(
        T.OceanConfig(resolution=16384, fft_impl="pallas"), 16384) == "bf16x3"
    # hermitian_pack=False at N <= 512 runs the unpacked step (K4-K6): its
    # hoisted inputs, routes and plane shapes; it runs the tier as the packed
    # route does (K4's tiered body at the default "bf16x3").
    unpacked = T.OceanConfig(resolution=64, fft_impl="pallas", hermitian_pack=False)
    assert fused_step.check_supported(unpacked, 64) == "bf16x3"
    h0, om = _state(64, 6)
    inputs = fused_step.hoist_packed(torch.from_numpy(h0), torch.from_numpy(om), unpacked)
    assert isinstance(inputs, fused_step.UnpackedInputs)
    assert fused_step.packed_planes(inputs, [1.0, 2.0], unpacked).shape == (2, 3, 64, 64)
    assert fused_step.fused_fields(torch.from_numpy(h0), torch.from_numpy(om), 1.0,
                                   unpacked).shape == (64, 64, 3)
    assert fused_step.packed_checksums(inputs, [1.0, 2.0], unpacked).shape == (2,)
    assert unpacked_step.unpacked_route(unpacked, 64) == "single"
    assert unpacked_step.unpacked_route(
        T.OceanConfig(resolution=512, fft_impl="pallas", hermitian_pack=False,
                      matmul_precision="highest"), 512) == "blocked"
    # "default" runs too: as one bf16 pass, unpacked (K4t) and packed
    assert fused_step.check_supported(
        T.OceanConfig(resolution=64, fft_impl="pallas", hermitian_pack=False,
                      matmul_precision="default"), 64) == "default"
    assert fused_step.check_supported(
        T.OceanConfig(resolution=64, fft_impl="pallas", matmul_precision="default"),
        64) == "default"
    with pytest.raises(ValueError, match="unknown matmul precision"):
        fused_step.check_supported(
            T.OceanConfig(resolution=64, fft_impl="pallas", matmul_precision="fp8"), 64)
    assert fused_step.check_supported(T.OceanConfig(resolution=512, fft_impl="pallas"),
                                      512) == "bf16x3"
    # a (C, 2, N, N) cascade stack is hoisted (tests/test_torch_cascades.py);
    # more leading axes, or an omega that does not match h0, raise
    with pytest.raises(ValueError, match="cascade stack"):
        fused_step.hoist_packed(torch.zeros(2, 2, 2, 32, 32), torch.zeros(2, 2, 32, 32),
                                T.OceanConfig(resolution=32, fft_impl="pallas"))
    with pytest.raises(ValueError, match="cascade stack"):
        fused_step.hoist_packed(torch.zeros(2, 2, 32, 32), torch.zeros(32, 32),
                                T.OceanConfig(resolution=32, fft_impl="pallas"))
