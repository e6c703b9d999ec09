"""The four-step path (K2 + K3's plain PyTorch version,
``gfx_ocean_tpu_torch.ops.fourstep_step``, and the matmul four-step of
``ops/fft.py``) against the JAX package on the same numpy inputs.

The JAX side runs as ``tests/test_pallas.py`` runs it on the CPU: the
Pallas calls ``_fourstep_row_call`` / ``_fourstep_col_call`` /
``pallas_planes`` / ``pallas_checksums`` with ``interpret=True``. The JAX
kernels read x-permuted planes (``_fourstep_permute_inputs``), a TPU
layout device; the port reads them in true order, and the contract pinned
here is Y and the planes in true order.

Tolerances, relative to the field's max |value|:
- "highest": float32 transforms of the same spectra summed in different
  orders (measured ~2e-7 at 1024^2), held to 1e-6;
- "high": both sides run the in-kernel bf16x3 split and differ in the
  order of the FP32 sums, which each of the three stage outputs split again
  (K2's stage 1, Y, K3's stage 1) now and then turns into a bf16 ulp of its
  lo (measured 8.9e-6 at 1024^2; tests/test_torch_tier_kernels.py). Held to
  2.4e-5, and to 2e-5 against golden (the split tier's own error).
Checksums nearly cancel, so they are held on the scale of their summands.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu.ops.pallas_step as ps
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.golden.reference import golden_fields, golden_normals
from gfx_ocean_tpu.ops import fft as jfft
from gfx_ocean_tpu.ops.derived import finite_difference_normals as jax_normals
from gfx_ocean_tpu_torch.models.ocean import state_from_numpy
from gfx_ocean_tpu_torch.ops import fft as tfft
from gfx_ocean_tpu_torch.ops import fourstep_step as fs
from gfx_ocean_tpu_torch.ops import fused_step
from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
from gfx_ocean_tpu_torch.ops.propagate import khat_pair
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum
from gfx_ocean_tpu_torch.utils import profiling

TOL = {"highest": 1e-6, "high": 2.4e-5}
# Against the float64 golden: FP32 at "highest", the split tier's own error
# at "high" (tests/test_torch_precision.py's SPLIT_GOLDEN).
GOLDEN = {"highest": 1e-6, "high": 2e-5}
CHECKSUM_TOL = 1e-6
FLAGS = {"default": {}, "canonical": dict(ref_sign=False), "wrap_k": dict(wrap_k=True)}


def _launches(wrapper: str, kind: str = "launches") -> int:
    """The process-wide count ``<kind>.<wrapper>`` (``profiling.tallies``)."""
    return profiling.tallies().get(f"{kind}.{wrapper}", 0)


def _state(n: int, seed: int = 0):
    """A Phillips state at n^2 from a numpy draw: (h0 planes, omega)."""
    xi = np.random.default_rng(seed).standard_normal((2, n, n)).astype(np.float32)
    env = np.sqrt(phillips_spectrum(n, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    return xi * env, dispersion(n, 1000.0)


def _configs(n: int, precision: str = "highest", flags: str = "default", **kwargs):
    common = dict(resolution=n, fft_impl="pallas", matmul_precision=precision, **kwargs)
    return (J.OceanConfig(compat=J.CompatFlags(**FLAGS[flags]), **common),
            T.OceanConfig(compat=T.CompatFlags(**FLAGS[flags]), **common))


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _summands(planes: torch.Tensor, cfg) -> np.ndarray:
    """Sum of |summands| of each frame's checksum: the scale it is held on."""
    scale = planes.abs().sum(dim=(-3, -2, -1))
    if cfg.compute_normals:
        normals = finite_difference_normals_planes(planes[:, 1], cfg.normal_height_scale)
        scale = scale + normals.abs().sum(dim=(-3, -2, -1))
    return scale.numpy()


def _jax_row(h0, om, jc, ts, rows=None, row_base=0):
    """``_fourstep_row_call`` in interpret mode on the (band of) rows:
    Y (tb, 2, 2, rows, N)."""
    n = h0.shape[-1]
    n1, n2, block, _ = ps._fourstep_plan(n, jc)
    row_tabs, _ = ps._fourstep_tables(n, n1, n2, jc.compat.ref_sign)
    planes = ps._fourstep_permute_inputs(jnp.asarray(h0), jnp.asarray(om), jc, n, n1, n2)
    if rows is not None:
        planes = [p[..., row_base:row_base + rows, :] for p in planes]
    t2 = jnp.asarray([list(ts) + [float(row_base)]], jnp.float32)
    y = np.array(ps._fourstep_row_call(t2, *planes, row_tabs, jc, n, n1, n2, block, True))
    return y.reshape((len(ts),) + y.shape[-4:])


def _pallas_planes(h0, om, t, jc):
    """``pallas_planes`` in interpret mode: (3, N, N)."""
    return np.asarray(ps.pallas_planes(jnp.asarray(h0), jnp.asarray(om), jnp.float32(t), jc,
                                       interpret=True))


# --------------------------------------------------------------------------
# Plan, tables, k-hat band.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1024, 2048, 8192, 16384])
def test_plan_and_tables_equal_jax(n):
    jc, tc = _configs(n)
    plan = fs.fourstep_plan(n, tc)
    assert plan == ps._fourstep_plan(n, jc) == (128, n // 128, 16, 128)
    for negate in (False, True):
        want = ps._fourstep_tables(n, 128, n // 128, negate)
        got = fs.fourstep_tables(n, 128, n // 128, negate)
        for g_pass, w_pass in zip(got, want):
            assert len(g_pass) == len(w_pass)
            for g, w in zip(g_pass, w_pass):
                assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n", [512, 32768])
def test_plan_raises_outside_range(n):
    jc, tc = _configs(n)
    with pytest.raises(ValueError, match=r"\[1024, 16384\]"):
        ps._fourstep_plan(n, jc)
    with pytest.raises(ValueError, match=r"\[1024, 16384\]"):
        fs.fourstep_plan(n, tc)


@pytest.mark.parametrize("wrap", [False, True])
def test_khat_band_matches_kernel_formula(wrap):
    """The band form at a row base against the TPU kernel's iota formula,
    whose x-permuted columns (perm_n1) are put back in true order."""
    n, rows, base = 1024, 16, 512
    want = ps._khat_pair_in_kernel(n, 1000.0, wrap, rows, jnp.float32(base), perm_n1=128)
    got = khat_pair(n, 1000.0, wrap, rows=rows, row_base=base)
    true_x = (np.arange(n) % 128) * (n // 128) + np.arange(n) // 128  # column c holds x
    for g, w in zip(got, want):
        unperm = np.empty((rows, n), np.float32)
        unperm[:, true_x] = np.asarray(w)
        assert np.abs(g.numpy() - unperm).max() <= 2 * np.finfo(np.float32).eps
    full = khat_pair(n, 1000.0, wrap)
    for g, f in zip(got, full):
        assert torch.equal(g, f[base:base + rows])


# --------------------------------------------------------------------------
# K2 and K3's plain versions against the Pallas calls.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tb", [1, 3])
@pytest.mark.parametrize("flags", ["default", "canonical", "wrap_k"])
def test_plain_row_pass_matches_pallas(flags, tb):
    n = 1024
    h0, om = _state(n, 1)
    jc, tc = _configs(n, flags=flags)
    ts = [11.25, 0.0, 1000.25][:tb]
    want = _jax_row(h0, om, jc, ts)
    inputs = fs.hoist_fourstep(torch.from_numpy(h0), torch.from_numpy(om), tc)
    got = fs.fourstep_row_reference(inputs, ts, tc)
    assert got.shape == (tb, 2, 2, n, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL["highest"]


def test_plain_row_band_at_row_base_matches_pallas():
    """One 16-row band at global row 512, as a row-sharded caller runs it."""
    n, rows, base = 1024, 16, 512
    h0, om = _state(n, 2)
    jc, tc = _configs(n)
    want = _jax_row(h0, om, jc, [3.5], rows=rows, row_base=base)
    full = fs.hoist_fourstep(torch.from_numpy(h0), torch.from_numpy(om), tc)
    got = fs.fourstep_row_reference(full, [3.5], tc, row_base=base, rows=rows)
    assert got.shape == (1, 2, 2, rows, n)
    assert _rel(got.numpy(), want) < TOL["highest"]
    # the band is the same rows of the full pass
    whole = fs.fourstep_row_reference(full, [3.5], tc)[..., base:base + rows, :]
    assert _rel(got.numpy(), whole.numpy()) < 1e-7


@pytest.mark.parametrize("flags,tb", [("default", 1), ("canonical", 2)])
def test_plain_col_pass_matches_pallas_with_checksum(flags, tb):
    """Both fed the same Y; the planes and the forcing checksum."""
    n = 1024
    h0, om = _state(n, 3)
    jc, tc = _configs(n, flags=flags)
    y = _jax_row(h0, om, jc, [1.5, 9.0][:tb])
    n1, n2, _, cblock = ps._fourstep_plan(n, jc)
    _, col_tabs = ps._fourstep_tables(n, n1, n2, jc.compat.ref_sign)
    planes, sums = ps._fourstep_col_call(jnp.asarray(y if tb > 1 else y[0]), col_tabs, jc, n,
                                         n1, n2, cblock, True, checksum=True,
                                         normals_scale=jc.normal_height_scale)
    want = np.asarray(planes).reshape(tb, 3, n, n)
    got = fs.fourstep_col_reference(torch.from_numpy(y), tc)
    assert got.shape == (tb, 3, n, n)
    assert _rel(got.numpy(), want) < TOL["highest"]
    got_ck = fused_step.checksums_of_planes(got, tc).numpy()
    want_ck = np.asarray(sums).reshape(tb, -1).sum(axis=-1)
    assert np.all(np.abs(got_ck - want_ck) < CHECKSUM_TOL * _summands(got, tc))


# --------------------------------------------------------------------------
# The fused entry points, the step and the rollout.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,precision", [(1024, "high"), (2048, "highest")])
def test_fused_matches_pallas_and_golden(n, precision):
    h0, om = _state(n, 4)
    jc, tc = _configs(n, precision)
    ts = [11.25, 600.5]
    want = _pallas_planes(h0, om, ts[0], jc)
    h0_t, om_t = torch.from_numpy(h0), torch.from_numpy(om)
    got = fused_step.fused_planes(h0_t, om_t, ts[0], tc)
    assert got.shape == (3, n, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL[precision]
    gold = golden_fields(h0[0] + 1j * h0[1], om, ts[0], 1000.0, jc.compat)
    assert _rel(np.moveaxis(got.numpy(), 0, -1), gold) < GOLDEN[precision]

    want_ck = np.asarray(ps.pallas_checksums(jnp.asarray(h0), jnp.asarray(om),
                                             jnp.asarray(ts, jnp.float32), jc, interpret=True))
    got_ck = fused_step.fused_checksums(h0_t, om_t, ts, tc)
    assert got_ck.shape == (2,)
    inputs = fused_step.hoist_packed(h0_t, om_t, tc)
    scale = _summands(fused_step.packed_planes(inputs, ts, tc), tc)
    tol = CHECKSUM_TOL if precision == "highest" else TOL[precision]
    assert np.all(np.abs(got_ck.numpy() - want_ck) < tol * scale)


@pytest.mark.parametrize("n", [1024, 2048])
def test_normals_are_as_far_from_golden_as_the_jax_package(n):
    """Where the four-step normals' distance to golden comes from. The port's
    normals, the JAX package's (its pallas planes in interpret mode through
    its own ``finite_difference_normals``) and ``golden_normals`` on one
    state: both float32 implementations sit equally far from golden
    (measured 8.8e-5 and 8.4e-5 at 1024^2, 1.6e-4 and 1.4e-4 at 2048^2) and
    about as far from each other, and that distance is their float32 height
    error (~2.5e-5 of a height of ~35) amplified by the central difference
    over a 2 / N texel: |dn| <= |dh| N / height_scale. It doubles with N, so
    it is no fault of K2 / K3's path."""
    h0, om = _state(n, 11)
    jc, tc = _configs(n, domain_size=2000.0)
    t = 11.25
    port = T.make_step(tc)(state_from_numpy(h0, om, device="cpu"), t)
    jax_height = _pallas_planes(h0, om, t, jc)[1]
    jax_n = np.asarray(jax_normals(jnp.asarray(jax_height), jc.normal_height_scale))
    gold_height = golden_fields(h0[0] + 1j * h0[1], om, t, 2000.0, jc.compat)[..., 1]
    gold_n = golden_normals(gold_height, jc.normal_height_scale)
    port_n = port.normals.numpy()
    port_err = float(np.abs(port_n - gold_n).max())
    jax_err = float(np.abs(jax_n - gold_n).max())
    assert 5e-5 < port_err < 1.5 * jax_err and jax_err < 1.5 * port_err
    assert float(np.abs(port_n - jax_n).max()) < 1.5 * max(port_err, jax_err)
    amplification = n / jc.normal_height_scale
    port_dh = float(np.abs(port.displacement.numpy()[..., 1] - gold_height).max())
    jax_dh = float(np.abs(jax_height - gold_height).max())
    assert port_err <= port_dh * amplification and jax_err <= jax_dh * amplification
    # golden's own height rounded to float32 moves its normals by a fifth of that
    rounded = golden_normals(gold_height.astype(np.float32).astype(np.float64),
                             jc.normal_height_scale)
    assert float(np.abs(rounded - gold_n).max()) < 0.3 * port_err


def test_unpacked_pallas_config_runs_fourstep_as_jax_does():
    """``hermitian_pack=False`` at N >= 1024 still takes the packed
    four-step in ``pallas_planes``; the port routes the same way."""
    n = 1024
    h0, om = _state(n, 5)
    jc, tc = _configs(n, hermitian_pack=False)
    assert fused_step.check_supported(tc, n) == "highest"
    want = _pallas_planes(h0, om, 2.0, jc)
    inputs = fused_step.hoist_packed(torch.from_numpy(h0), torch.from_numpy(om), tc)
    assert isinstance(inputs, fs.FourstepInputs)
    got = fused_step.fused_fields(torch.from_numpy(h0), torch.from_numpy(om), 2.0, tc)
    assert got.shape == (n, n, 3)
    assert _rel(np.moveaxis(got.numpy(), -1, 0), want) < TOL["highest"]


def test_checksum_rollout_time_batch_2_matches_jax(monkeypatch):
    orig = ps.pallas_checksums
    monkeypatch.setattr(ps, "pallas_checksums",
                        lambda h0, om, ts, cfg, interpret=False: orig(h0, om, ts, cfg, True))
    n = 1024
    h0, om = _state(n, 6)
    jc, tc = _configs(n)
    ts = np.asarray([0.5, 1.0, 7.25, 1000.0], np.float32)
    want = np.asarray(J.make_rollout(jc, keep_fields=False, time_batch=2)(
        J.OceanState(h0=jnp.asarray(h0), omega=jnp.asarray(om)), jnp.asarray(ts)))
    tst = state_from_numpy(h0, om, device="cpu")
    got = T.make_rollout(tc, keep_fields=False, time_batch=2)(tst, torch.from_numpy(ts))
    assert got.shape == (4,) and torch.isfinite(got).all()
    inputs = fused_step.hoist_packed(tst.h0, tst.omega, tc)
    scale = _summands(fused_step.packed_planes(inputs, ts, tc), tc)
    assert np.all(np.abs(got.numpy() - want) < CHECKSUM_TOL * scale)
    # keep_fields through the same route: the step's fields, frame by frame
    fields = T.make_rollout(tc, keep_fields=True, time_batch=2)(tst, ts[:2])
    assert fields.displacement.shape == (2, n, n, 3) and fields.normals.shape == (2, n, n, 3)
    one = T.make_step(tc)(tst, float(ts[1]))
    assert _rel(fields.displacement[1].numpy(), one.displacement.numpy()) < 1e-7


def test_cpu_tensors_take_the_plain_version():
    n = 1024
    h0, om = _state(n, 7)
    _, tc = _configs(n)
    inputs = fs.hoist_fourstep(torch.from_numpy(h0), torch.from_numpy(om), tc)
    rows, cols = _launches("launch_fourstep_row"), _launches("launch_fourstep_col")
    got = fused_step.packed_checksums(inputs, [1.0], tc)
    assert torch.equal(got, fs.fourstep_checksums_reference(inputs, [1.0], tc))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fs.launch_fourstep_row(inputs, [1.0], tc)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fs.launch_fourstep_col(torch.zeros(1, 2, 2, n, n), inputs.twiddle, tc, checksum=True)
    assert (_launches("launch_fourstep_row"), _launches("launch_fourstep_col")) == (rows, cols)
    # frames of a batch equal single frames (the plain version's matmuls may
    # block differently by batch; the kernels' frames are bit-identical)
    batch = fs.fourstep_planes_reference(inputs, [1.0, 2.5], tc)
    single = fs.fourstep_planes_reference(inputs, [2.5], tc)
    assert _rel(batch[1].numpy(), single[0].numpy()) < 1e-7


# --------------------------------------------------------------------------
# The matmul route's four-step split (ops/fft.py).
# --------------------------------------------------------------------------

def _spectrum(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("centered", [None, "ref", "canonical"])
@pytest.mark.parametrize("shape", [(256, 256), (2, 128, 128)])
def test_matmul_fourstep_matches_jax(centered, shape):
    """N > direct_max: both packages run the four-step split (N1 = N2 = 16
    at 256, 16 x 8 at 128)."""
    xr, xi = _spectrum(shape, 8)
    kw = dict(direct_max=64, precision="highest", centered=centered)
    args_t = (torch.from_numpy(xr), torch.from_numpy(xi))
    args_j = (jnp.asarray(xr), jnp.asarray(xi))
    got = tfft.ifft2_real_unnorm(*args_t, **kw).numpy()
    assert _rel(got, jfft.ifft2_real_unnorm(*args_j, impl="matmul", **kw)) < TOL["highest"]
    got_p = tfft.ifft2_planes_unnorm(*args_t, **kw)
    for g, w in zip(got_p, jfft.ifft2_planes_unnorm(*args_j, impl="matmul", **kw)):
        assert _rel(g.numpy(), w) < TOL["highest"]
    direct = tfft.ifft2_planes_unnorm(*args_t, direct_max=256, precision="highest",
                                      centered=centered)
    for g, d in zip(got_p, direct):
        assert _rel(g.numpy(), d.numpy()) < TOL["highest"]


def test_matmul_fourstep_2048_matches_jax():
    """The matmul route at 2048^2 with direct_max 1024 (config 5's first route
    runs the same split at 4096^2)."""
    xr, xi = _spectrum((2048, 2048), 9)
    kw = dict(direct_max=1024, precision="highest", centered="ref")
    args_t = (torch.from_numpy(xr), torch.from_numpy(xi))
    args_j = (jnp.asarray(xr), jnp.asarray(xi))
    got = tfft.ifft2_real_unnorm(*args_t, **kw).numpy()
    assert _rel(got, jfft.ifft2_real_unnorm(*args_j, impl="matmul", **kw)) < TOL["highest"]
    for g, w in zip(tfft.ifft2_planes_unnorm(*args_t, **kw),
                    jfft.ifft2_planes_unnorm(*args_j, impl="matmul", **kw)):
        assert _rel(g.numpy(), w) < TOL["highest"]
