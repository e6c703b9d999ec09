"""The slice end to end: ``gfx_ocean_tpu_torch`` ``make_step`` /
``make_rollout`` against the JAX package's, and against the float64
golden model, on states made with ``state_from_numpy`` from one numpy draw.

The JAX "pallas" route reaches the Pallas kernel, which runs on the CPU
only in interpret mode: the JAX entry points are monkeypatched to pass
``interpret=True``, as ``tests/test_pallas.py`` does. The port's "pallas"
route takes K1's plain version, because its tensors lie on the CPU.
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
from gfx_ocean_tpu_torch.models.ocean import state_from_numpy
from gfx_ocean_tpu_torch.ops.fft import effective_precision
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum
from gfx_ocean_tpu_torch.utils.profiling import time_rollout

N = 64
# Field agreement, relative to max |field|: float32 transforms summed in
# different orders (~3e-7 measured); 5e-5 where the JAX side runs bf16x3.
TOL = {"highest": 1e-6, "bf16x3": 5e-5}
# Normals are unit vectors: absolute agreement. They difference the height,
# so the JAX side's bf16x3 height error shows in them (measured 3e-5).
NORMALS_TOL = {"highest": 1e-5, "bf16x3": 1e-4}
# Checksums nearly cancel; held on the scale of the summands.
CHECKSUM_TOL = 1e-6
# Against the float64 golden, by the height's tier: float32 sums at
# "highest"; at "bf16x3" the split tier's own error (the JAX figure 8e-6 of
# the shipped bins; the JAX function with the MXU's rounding reads up to
# 9.3e-6 on such spectra, tests/test_torch_precision.py), which K1 and its
# plain version compute since the packed kernels run the JAX kernel's tiers.
GOLDEN = {"highest": 1e-6, "bf16x3": 2e-5}


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig_fields, orig_cks = ps.pallas_fields, ps.pallas_checksums
    monkeypatch.setattr(ps, "pallas_fields",
                        lambda h0, om, t, cfg, interpret=False: orig_fields(h0, om, t, cfg, True))
    monkeypatch.setattr(ps, "pallas_checksums",
                        lambda h0, om, ts, cfg, interpret=False: orig_cks(h0, om, ts, cfg, True))


def _numpy_state(n: int = N, seed: int = 0):
    xi = np.random.default_rng(seed).standard_normal((2, n, n)).astype(np.float32)
    env = np.sqrt(phillips_spectrum(n, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    return xi * env, dispersion(n, 1000.0)


def _states(n: int = N, seed: int = 0):
    h0, om = _numpy_state(n, seed)
    return J.OceanState(h0=jnp.asarray(h0), omega=jnp.asarray(om)), state_from_numpy(h0, om, device="cpu")


def _configs(**kwargs):
    flags = kwargs.pop("flags", {})
    kwargs.setdefault("resolution", N)
    return (J.OceanConfig(compat=J.CompatFlags(**flags), **kwargs),
            T.OceanConfig(compat=T.CompatFlags(**flags), **kwargs))


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


ROUTES = [
    dict(fft_impl="pallas", matmul_precision="highest"),
    dict(fft_impl="pallas", matmul_precision="bf16x3"),
    dict(fft_impl="pallas", matmul_precision="highest", flags=dict(ref_sign=False)),
    dict(fft_impl="pallas", matmul_precision="highest", flags=dict(wrap_k=True, conj_neg=True)),
    dict(fft_impl="matmul", matmul_precision="highest"),
    dict(fft_impl="matmul", matmul_precision="highest", hermitian_pack=True),
    dict(fft_impl="matmul", matmul_precision="highest", flags=dict(wrap_k=True)),
    dict(fft_impl="matmul", matmul_precision="highest", choppy_precision="high"),
]
ROUTE_IDS = ["pallas", "pallas-bf16x3", "pallas-canonical", "pallas-wrap+conj",
             "matmul", "matmul-packed", "matmul-wrap_k", "matmul-choppy"]


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_make_step_matches_jax_and_golden(route, interpret_pallas):
    jc, tc = _configs(**dict(route))
    jst, tst = _states()
    t = 11.25
    want = J.make_step(jc)(jst, jnp.float32(t))
    got = T.make_step(tc)(tst, t)
    assert got.displacement.shape == (N, N, 3) and got.normals.shape == (N, N, 3)
    assert got.foam is None and torch.equal(got.height, got.displacement[..., 1])
    disp, want_disp = got.displacement.numpy(), np.asarray(want.displacement)
    scale = np.abs(want_disp).max()
    # The height at the route's tier; the choppy fields at choppy_precision,
    # which the port's matmul route runs as a bf16 split ("high") where the
    # JAX package's CPU dot computes f32: the split's tolerance.
    choppy_tol = TOL["bf16x3"] if tc.choppy_precision else TOL[jc.matmul_precision]
    assert np.abs(disp[..., 1] - want_disp[..., 1]).max() / scale < TOL[jc.matmul_precision]
    assert np.abs(disp[..., ::2] - want_disp[..., ::2]).max() / scale < choppy_tol
    assert (np.abs(got.normals.numpy() - np.asarray(want.normals)).max()
            < NORMALS_TOL[jc.matmul_precision])

    gold = golden_fields(np.asarray(jst.h0[0]) + 1j * np.asarray(jst.h0[1]),
                         np.asarray(jst.omega), t, 1000.0, jc.compat)
    gscale = np.abs(gold).max()
    assert np.abs(disp[..., 1] - gold[..., 1]).max() / gscale < GOLDEN[jc.matmul_precision]
    # "high"'s ceiling against golden (the JAX package's figure, config.py)
    assert (np.abs(disp[..., ::2] - gold[..., ::2]).max() / gscale
            < (2.8e-5 if tc.choppy_precision else GOLDEN[jc.matmul_precision]))
    assert (np.abs(got.normals.numpy() - golden_normals(gold[..., 1])).max()
            < NORMALS_TOL[jc.matmul_precision])


@pytest.mark.parametrize("time_batch", [1, 2])
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_checksum_rollout_matches_jax(time_batch, precision, interpret_pallas):
    jc, tc = _configs(fft_impl="pallas", matmul_precision=precision)
    jst, tst = _states(seed=1)
    ts = np.arange(4, dtype=np.float32) * 0.7 + 1.0
    want = np.asarray(J.make_rollout(jc, keep_fields=False, time_batch=time_batch)(
        jst, jnp.asarray(ts)))
    got = T.make_rollout(tc, keep_fields=False, time_batch=time_batch)(tst, torch.from_numpy(ts))
    assert got.shape == (4,) and got.dtype == torch.float32 and torch.isfinite(got).all()
    fields = T.make_rollout(tc, keep_fields=True)(tst, torch.from_numpy(ts))
    scale = (fields.displacement.abs().sum(dim=(-3, -2, -1))
             + fields.normals.abs().sum(dim=(-3, -2, -1))).numpy()
    tol = CHECKSUM_TOL if precision == "highest" else TOL["bf16x3"]
    assert np.all(np.abs(got.numpy() - want) < tol * scale)


def test_rollout_time_batches_agree():
    _, tc = _configs(fft_impl="pallas", matmul_precision="bf16x3")
    _, tst = _states(seed=2)
    ts = torch.arange(6, dtype=torch.float32) / 60.0
    outs = [T.make_rollout(tc, keep_fields=False, time_batch=tb)(tst, ts) for tb in (1, 2, 3, 6)]
    for o in outs[1:]:
        assert torch.allclose(o, outs[0], rtol=1e-6, atol=0.0)
    with pytest.raises(ValueError, match="not a multiple of time_batch"):
        T.make_rollout(tc, keep_fields=False, time_batch=4)(tst, ts)
    with pytest.raises(ValueError, match="time_batch must be"):
        T.make_rollout(tc, time_batch=0)


@pytest.mark.parametrize("fft_impl", ["pallas", "matmul"])
def test_keep_fields_rollout_equals_steps(fft_impl):
    _, tc = _configs(fft_impl=fft_impl, matmul_precision="highest")
    _, tst = _states(seed=3)
    ts = [0.5, 1.5, 1000.0]
    out = T.make_rollout(tc, keep_fields=True, time_batch=1)(tst, ts)
    assert out.displacement.shape == (3, N, N, 3) and out.normals.shape == (3, N, N, 3)
    for j, t in enumerate(ts):
        one = T.step(tst, t, tc)
        assert _rel(out.displacement[j].numpy(), one.displacement.numpy()) < 1e-7


def test_matmul_checksum_rollout_matches_jax():
    jc, tc = _configs(fft_impl="matmul", matmul_precision="highest")
    jst, tst = _states(seed=4)
    ts = np.asarray([0.0, 2.5], np.float32)
    want = np.asarray(J.make_rollout(jc, keep_fields=False)(jst, jnp.asarray(ts)))
    got = T.make_rollout(tc, keep_fields=False)(tst, ts).numpy()
    fields = T.make_rollout(tc)(tst, ts)
    scale = (fields.displacement.abs().sum(dim=(-3, -2, -1))
             + fields.normals.abs().sum(dim=(-3, -2, -1))).numpy()
    assert np.all(np.abs(got - want) < CHECKSUM_TOL * scale)


@pytest.mark.parametrize("time_batch", [1, 2])
@pytest.mark.parametrize("fft_impl", ["pallas", "matmul"])
def test_foam_and_its_checksum_match_jax(fft_impl, time_batch, interpret_pallas):
    """compute_foam: the Jacobian whitecap mask of every frame and the
    checksum that adds it, against the JAX package. The mask is exact
    except at texels whose Jacobian lies within 1e-5 of the threshold
    (XLA contracts the Jacobian's products into FMAs on the CPU)."""
    kw = dict(fft_impl=fft_impl, matmul_precision="highest", compute_foam=True,
              foam_threshold=0.9, foam_lambda=1.5)
    jc, tc = _configs(**kw)
    jst, tst = _states(seed=6)
    ts = np.asarray([0.5, 3.0, 11.25, 40.0], np.float32)
    want = J.make_rollout(jc, keep_fields=True, time_batch=time_batch)(jst, jnp.asarray(ts))
    got = T.make_rollout(tc, keep_fields=True, time_batch=time_batch)(tst, torch.from_numpy(ts))
    assert got.foam.shape == (4, N, N) and got.foam.dtype == torch.float32
    assert 0.005 < float(got.foam.mean()) < 0.5
    differ = got.foam.numpy() != np.asarray(want.foam)
    disp = got.displacement.double()
    inv2h = N / (2.0 * 1000.0)
    lam = 1.5

    def d(f, axis):
        return (torch.roll(f, -1, dims=axis) - torch.roll(f, 1, dims=axis)) * inv2h

    jac = ((1 + lam * d(disp[..., 0], -1)) * (1 + lam * d(disp[..., 2], -2))
           - lam * d(disp[..., 0], -2) * lam * d(disp[..., 2], -1))
    assert np.all(np.abs(jac.numpy()[differ] - 0.9) < 1e-5)
    assert torch.equal(T.step(tst, 11.25, tc).foam, got.foam[2])

    want_ck = np.asarray(J.make_rollout(jc, keep_fields=False, time_batch=time_batch)(
        jst, jnp.asarray(ts)))
    got_ck = T.make_rollout(tc, keep_fields=False, time_batch=time_batch)(tst, ts).numpy()
    scale = (got.displacement.abs().sum(dim=(-3, -2, -1)) + got.normals.abs().sum(dim=(-3, -2, -1))
             + got.foam.sum(dim=(-2, -1))).numpy()
    assert np.all(np.abs(got_ck - want_ck) < CHECKSUM_TOL * scale + differ.sum(axis=(-2, -1)))


UNPORTED = [
    # the "default" tier runs on every route: on "xla" as torch.fft, which
    # takes no tier, as the "bf16x3" configuration does; on the "pallas"
    # route, unpacked (K4) or packed (K1, K2 + K3), as one bf16 pass, as the
    # JAX kernels run it, within the tier's bound of "bf16x3"
    (dict(fft_impl="pallas", hermitian_pack=False, matmul_precision="default"), N, "default"),
    (dict(fft_impl="pallas", resolution=1024, matmul_precision="default"), 1024, "default"),
    (dict(fft_impl="xla", matmul_precision="default"), N, "n/a"),
    (dict(fft_impl="xla", compute_foam=True, num_cascades=2, matmul_precision="default"),
     N, "n/a"),
    (dict(fft_impl="pallas", num_cascades=2, matmul_precision="default"), N, "default"),
    (dict(fft_impl="pallas", matmul_precision="default"), N, "default"),
]
# One bf16 pass against the split, relative to the field's largest value:
# the "default" tier's bound (tests/test_torch_precision.py, DEFAULT_GOLDEN).
DEFAULT_TIER_TOL = 1e-2


@pytest.mark.parametrize("kwargs,n,match", UNPORTED,
                         ids=["pallas-unpacked", "pallas-1024", "xla", "foam", "cascades",
                              "default-tier"])
def test_unported_configurations_raise(kwargs, n, match):
    kwargs = dict(kwargs)
    kwargs.setdefault("resolution", n)
    cfg = T.OceanConfig(**kwargs)
    same = T.OceanConfig(**{**kwargs, "matmul_precision": "bf16x3"})
    assert effective_precision(cfg.matmul_precision, n, cfg.direct_dft_max,
                               cfg.fft_impl, cfg.hermitian_pack).startswith(match)
    _, st = _states(n, seed=4)
    got, want = T.step(st, 1.0, cfg), T.step(st, 1.0, same)
    assert torch.isfinite(got.displacement).all()
    rollouts = (T.make_rollout(cfg, keep_fields=False)(st, [1.0]),
                T.make_rollout(same, keep_fields=False)(st, [1.0]))
    if match == "default":
        scale = want.displacement.abs().max()
        assert 0 < float((got.displacement - want.displacement).abs().max() / scale) < \
            DEFAULT_TIER_TOL
        assert torch.isfinite(rollouts[0]).all()
    else:
        assert torch.equal(got.displacement, want.displacement)
        assert torch.equal(*rollouts)


def test_batched_state_raises():
    """Cascades are ported: a (2, 2, N, N) state steps, and a two-cascade
    Phillips state is synthesized (tests/test_torch_cascades.py holds both
    against the JAX package). What still raises is a state whose h0 and
    omega do not match."""
    cfg = T.OceanConfig(resolution=32, fft_impl="pallas", num_cascades=2)
    st = T.ocean_state_from_phillips(cfg, device="cpu")
    assert st.h0.shape == (2, 2, 32, 32) and st.omega.shape == (2, 32, 32)
    out = T.step(st, 1.0, cfg)
    assert out.displacement.shape == (2, 32, 32, 3) and torch.isfinite(out.displacement).all()
    with pytest.raises(ValueError, match="not"):
        T.step(T.OceanState(h0=st.h0, omega=st.omega[0]), 1.0, cfg)


def test_phillips_state_runs_end_to_end():
    cfg = T.OceanConfig(resolution=32, fft_impl="pallas")
    st = T.ocean_state_from_phillips(cfg, generator=torch.Generator().manual_seed(1),
                                     device="cpu")
    assert st.h0.shape == (2, 32, 32) and st.omega.shape == (32, 32)
    out = T.make_step(cfg, device="cpu")(st, 1.0)
    assert torch.isfinite(out.displacement).all()


def test_time_rollout_reports_steps_and_checksums():
    _, tc = _configs(fft_impl="pallas", resolution=32)
    _, tst = _states(32, seed=5)
    rollout = T.make_rollout(tc, keep_fields=False, time_batch=2)
    rec = time_rollout(rollout, tst, torch.arange(4, dtype=torch.float32), repeats=2)
    assert rec["steps"] == 4 and len(rec["repeats_sec"]) == 2
    assert rec["steps_per_sec"] > 0 and np.isfinite(rec["checksums"]).all()
