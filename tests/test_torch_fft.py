"""``gfx_ocean_tpu_torch.ops.fft`` against ``gfx_ocean_tpu.ops.fft`` and the
float64 golden transform.

The DFT tables are the same float64 numpy code rounded once, so they are
bit-equal. The transforms are float32 matmuls in both packages (the JAX
side at "highest", the port in plain FP32), summed in different orders.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfx_ocean_tpu.golden.reference import correction_sign, ifft2_unnorm_np
from gfx_ocean_tpu.ops import fft as jfft
from gfx_ocean_tpu_torch.ops import fft as tfft

# float32 dense DFT of N points: each output sums N products, so the error
# grows like sqrt(N) ulps of the output scale; 1e-6 of the max covers N = 128
# with a wide margin (measured ~2e-7).
TOL = 1e-6


@pytest.mark.parametrize("n", [16, 64, 512])
def test_tables_bit_equal(n):
    for sign in (1, -1):
        for a, b in zip(tfft._dft_matrix_np(n, sign), jfft._dft_matrix_np(n, sign)):
            assert np.array_equal(a, b)
        for axis in (0, 1):
            for negate in (False, True):
                for a, b in zip(tfft._dft_matrix_out_alt_np(n, sign, axis, negate),
                                jfft._dft_matrix_out_alt_np(n, sign, axis, negate)):
                    assert np.array_equal(a, b)
    assert np.array_equal(tfft._alt_np(n), jfft._alt_np(n))
    for a, b in zip(tfft._twiddle_np(8, n // 8, 1), jfft._twiddle_np(8, n // 8, 1)):
        assert np.array_equal(a, b)


def _spectrum(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("centered", [None, "ref", "canonical"])
@pytest.mark.parametrize("shape", [(64, 64), (3, 128, 128)])
def test_ifft2_real_matches_jax_and_golden(centered, shape):
    xr, xi = _spectrum(shape, 1)
    got = tfft.ifft2_real_unnorm(torch.from_numpy(xr), torch.from_numpy(xi),
                                 precision="highest", centered=centered).numpy()
    want = jfft.ifft2_real_unnorm(jnp.asarray(xr), jnp.asarray(xi), impl="matmul",
                                  precision="highest", centered=centered)
    assert got.shape == shape and _rel(got, want) < TOL
    gold = np.real(ifft2_unnorm_np(xr + 1j * xi.astype(np.float64)))
    if centered is not None:
        gold = gold * correction_sign(shape[-1], centered == "ref")
    assert _rel(got, gold) < TOL


@pytest.mark.parametrize("centered", [None, "ref", "canonical"])
@pytest.mark.parametrize("shape", [(64, 64), (2, 128, 128)])
def test_ifft2_planes_matches_jax_and_golden(centered, shape):
    xr, xi = _spectrum(shape, 2)
    got = tfft.ifft2_planes_unnorm(torch.from_numpy(xr), torch.from_numpy(xi),
                                   precision="highest", centered=centered)
    want = jfft.ifft2_planes_unnorm(jnp.asarray(xr), jnp.asarray(xi), impl="matmul",
                                    precision="highest", centered=centered)
    gold = ifft2_unnorm_np(xr + 1j * xi.astype(np.float64))
    if centered is not None:
        gold = gold * correction_sign(shape[-1], centered == "ref")
    for g, w, o in zip(got, want, (gold.real, gold.imag)):
        assert _rel(g.numpy(), w) < TOL
        assert _rel(g.numpy(), o) < TOL


@pytest.mark.parametrize("tier", ["bf16x3", "bf16x4", "high", "highest", "default"])
def test_every_f32_tier_runs_as_fp32(tier):
    # On the kernels' route, packed (K1-K3) or unpacked (K4), the kernels run
    # the JAX kernels' tier ("high" and "bf16x4" as "bf16x3"); the matmul
    # route runs the tier itself, and "xla" takes none.
    assert tfft.effective_precision(tier, 32, impl="pallas").split()[0] == tfft.kernel_tier(tier)
    assert tfft.effective_precision(tier, 32, impl="pallas", hermitian_pack=False) == \
        tfft.effective_precision(tier, 32, impl="pallas")
    assert tfft.effective_precision(tier, 32, impl="matmul") == tier
    assert "do not apply" in tfft.effective_precision(tier, 32, impl="xla")
    xr, xi = _spectrum((32, 32), 3)
    a = tfft.ifft2_real_unnorm(torch.from_numpy(xr), torch.from_numpy(xi), precision=tier)
    b = tfft.ifft2_real_unnorm(torch.from_numpy(xr), torch.from_numpy(xi), precision="highest")
    # the bf16 tiers' own error (3e-3 for one pass, 3e-5 for the splits)
    assert _rel(a, b) < (3e-3 if tier == "default" else 3e-5)
    if tier == "highest":
        assert torch.equal(a, b)


def test_unported_and_unknown_options_raise():
    x = torch.zeros(32, 32)
    with pytest.raises(ValueError, match="unknown matmul precision"):
        tfft.effective_precision("bf16x9")
    with pytest.raises(ValueError, match="unknown matmul precision"):
        tfft.ifft2_real_unnorm(x, x, precision="bf16x9")
    # "default" runs on every route: "xla" (torch.fft, where the tiers do
    # not apply), the direct and the four-step matmul route
    xr, xi = (torch.from_numpy(a) for a in _spectrum((32, 32), 4))
    gold = ifft2_unnorm_np(xr.numpy() + 1j * xi.numpy().astype(np.float64))
    assert _rel(tfft.ifft2_real_unnorm(xr, xi, impl="xla", precision="default"),
                gold.real) < TOL
    yr, yi = tfft.ifft2_planes_unnorm(xr, xi, direct_max=16, precision="default")
    # one bf16 pass in each of the four-step's two stages
    assert _rel(yr, gold.real) < 1e-2 and _rel(yi, gold.imag) < 1e-2
    with pytest.raises(ValueError, match="unknown impl"):
        tfft.ifft2_real_unnorm(x, x, impl="fft")
    with pytest.raises(ValueError, match="centered"):
        tfft.ifft2_real_unnorm(x, x, centered="both")
