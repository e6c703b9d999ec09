"""The unpacked step (K4, K5 + K6's plain PyTorch versions,
``gfx_ocean_tpu_torch.ops.unpacked_step``) against the JAX package on the
same numpy inputs, and the slice end to end.

The JAX side runs as ``tests/test_pallas.py`` runs it on the CPU:
``pallas_planes`` / ``_blocked_fields`` with ``interpret=True``. The port
runs its plain versions, which its wrappers take for CPU tensors.

Tolerances, relative to the field's max |value|:
- "highest": float32 transforms of the same spectra summed in different
  orders, held to 1e-6;
- "bf16x3": both sides split each operand into bf16 halves
  (``pallas_step._dot3``; K4's tiered body) and sum the exact products in
  FP32 in another order; the row pass's output is split again, where a
  one-ulp difference now and then moves its lo by a bf16 ulp. Held to
  5e-5, inside the 1e-4 golden gate (``tests/test_torch_tier_kernels.py``
  holds the plain K4 to the JAX kernel within 8e-6 at the split).
Checksums nearly cancel, so they are held on the scale of their summands.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

import gfx_ocean_tpu as J
import gfx_ocean_tpu.ops.pallas_step as ps
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.golden.reference import golden_fields
from gfx_ocean_tpu.ops.fft import _dft_matrix_out_alt_np
from gfx_ocean_tpu_torch.models.ocean import state_from_numpy
from gfx_ocean_tpu_torch.ops import fused_step
from gfx_ocean_tpu_torch.ops import unpacked_step as us
from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
from gfx_ocean_tpu_torch.render import camera as tcam
from gfx_ocean_tpu_torch.render import raster as tr
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum
from gfx_ocean_tpu_torch.utils import profiling

TOL = {"highest": 1e-6, "bf16x3": 5e-5}
# At 512^2 against the JAX matmul route, which sums in another order and
# takes k-hat from float64 host grids: measured 1.7e-6 at t = 1000 s.
TOL_512 = 5e-6
# Normals (unit vectors, absolute): at 512^2 a height difference is divided
# by a texel of 2/512, so the same float32 noise moves them by 9.5e-5.
NORMALS_TOL = {64: 1e-5, 512: 2e-4}
# The slice at "bf16x3" against the JAX kernel at the same tier: the split's
# one-resplit tolerance (tests/test_torch_tier_kernels.py) on the
# displacement, and on the normals as NORMALS_TOL[64] scales with it.
SPLIT_SLICE_TOL = 8e-6
SPLIT_NORMALS_TOL = 8e-5
CHECKSUM_TOL = 1e-6
GOLDEN_TOL = 1e-5
FLAGS = [dict(), dict(wrap_k=True), dict(ref_sign=False), dict(conj_neg=True)]
FLAG_IDS = ["default", "wrap_k", "canonical", "conj_neg"]
TIERS = ["bf16x3", "bf16x4", "high", "highest", "default"]


def _launches(wrapper: str, kind: str = "launches") -> int:
    """The process-wide count ``<kind>.<wrapper>`` (``profiling.tallies``)."""
    return profiling.tallies().get(f"{kind}.{wrapper}", 0)


def _state(n: int, seed: int = 0):
    """A Phillips state at n^2 from a numpy draw: (h0 planes, omega)."""
    xi = np.random.default_rng(seed).standard_normal((2, n, n)).astype(np.float32)
    env = np.sqrt(phillips_spectrum(n, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    return xi * env, dispersion(n, 1000.0)


def _configs(n: int, precision: str, flags=None, **kwargs):
    flags = flags or {}
    common = dict(resolution=n, fft_impl="pallas", hermitian_pack=False,
                  matmul_precision=precision, **kwargs)
    return (J.OceanConfig(compat=J.CompatFlags(**flags), **common),
            T.OceanConfig(compat=T.CompatFlags(**flags), **common))


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _hoist(h0, om, tc):
    return fused_step.hoist_packed(torch.from_numpy(h0), torch.from_numpy(om), tc)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("n", [64, 128])
def test_plain_k4_matches_pallas_kernel(n, precision, flags):
    h0, om = _state(n)
    jc, tc = _configs(n, precision, flags)
    t = 11.25
    want = ps.pallas_planes(jnp.asarray(h0), jnp.asarray(om), jnp.float32(t), jc, interpret=True)
    assert us.unpacked_route(tc, n) == "single" and want.shape == (3, n, n)
    inputs = _hoist(h0, om, tc)
    assert isinstance(inputs, us.UnpackedInputs)
    got = us.unpacked_planes_reference(inputs, [t], tc)[0]
    assert got.shape == (3, n, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL[precision]


def _jax_blocked(h0, om, jc, t):
    """``_blocked_fields`` in interpret mode, with the row kernel's Y
    captured on its way to the column kernel: (Y (3, 2, N, N), planes)."""
    n = h0.shape[-1]
    outs = []
    orig = jpl.pallas_call

    def spy(*args, **kwargs):
        call = orig(*args, **kwargs)

        def run(*operands):
            out = call(*operands)
            outs.append(np.asarray(out))
            return out
        return run

    awr, awi = (jnp.asarray(a) for a in _dft_matrix_out_alt_np(n, 1, 0, False))
    h0j = jnp.asarray(h0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps.pl, "pallas_call", spy)
        planes = ps._blocked_fields(h0j, jnp.asarray(om), jnp.reshape(jnp.float32(t), (1, 1)),
                                    h0j[:, ::-1, ::-1], awr, awi, jc, n, True)
    assert len(outs) == 2
    return outs[0], np.asarray(planes)


@pytest.mark.parametrize("flags", [dict(), dict(wrap_k=True, conj_neg=True)],
                         ids=["default", "wrap_k+conj_neg"])
def test_plain_k5_k6_match_blocked_pallas_kernels(flags):
    """At 256^2: 2 row bands of K5, 2 column bands of K6."""
    n, t = 256, 3.25
    h0, om = _state(n, 1)
    jc, tc = _configs(n, "highest", flags)
    want_y, want_planes = _jax_blocked(h0, om, jc, t)
    inputs = _hoist(h0, om, tc)
    y = us.unpacked_rows_reference(inputs, [t], tc)
    assert y.shape == (1, 3, 2, n, n) and want_y.shape == (3, 2, n, n)
    assert _rel(y[0].numpy(), want_y) < TOL["highest"]
    cols = us.unpacked_cols_reference(torch.from_numpy(want_y.copy())[None], inputs)
    assert _rel(cols[0].numpy(), want_planes) < TOL["highest"]
    chained = us.unpacked_cols_reference(y, inputs)
    assert _rel(chained[0].numpy(), want_planes) < TOL["highest"]
    assert torch.equal(chained, us.unpacked_planes_reference(inputs, [t], tc))


@pytest.mark.parametrize("n,precision,route", [(128, "bf16x3", "single"),
                                               (256, "highest", "single"),
                                               (512, "highest", "blocked")])
def test_both_routes_match_golden(n, precision, route):
    h0, om = _state(n, 2)
    jc, tc = _configs(n, precision)
    assert us.unpacked_route(tc, n) == route
    t = 11.25
    got = fused_step.fused_fields(torch.from_numpy(h0), torch.from_numpy(om), t, tc)
    assert got.shape == (n, n, 3)
    gold = golden_fields(h0[0] + 1j * h0[1], om, t, 1000.0, jc.compat)
    assert _rel(got.numpy(), gold) < GOLDEN_TOL


@pytest.mark.parametrize("precision", TIERS)
def test_route_predicate_matches_pallas_planes(precision):
    """The JAX route shows in its output shape (fault F2): the blocked route
    returns channel-last planes. ``jax.eval_shape`` runs no kernel."""
    for n in (16, 32, 64, 128, 256, 512):
        jc, tc = _configs(n, precision)
        shape = jax.eval_shape(
            lambda h, o, t, jc=jc: ps.pallas_planes(h, o, t, jc),
            jax.ShapeDtypeStruct((2, n, n), jnp.float32), jax.ShapeDtypeStruct((n, n), jnp.float32),
            jax.ShapeDtypeStruct((), jnp.float32)).shape
        want = "blocked" if shape == (n, n, 3) else "single"
        assert us.unpacked_route(tc, n) == want, (n, precision, shape)


def test_blocked_layout_fault_f2_is_not_carried():
    """JAX ``pallas_fields`` at 512 / "highest" / unpacked hands back
    (N, 3, N); the port's fields are (N, N, 3) and its planes (3, N, N) on
    both routes, and its checksum reads the true height plane."""
    n = 512
    jc, tc = _configs(n, "highest")
    shape = jax.eval_shape(
        lambda h, o, t: ps.pallas_fields(h, o, t, jc),
        jax.ShapeDtypeStruct((2, n, n), jnp.float32), jax.ShapeDtypeStruct((n, n), jnp.float32),
        jax.ShapeDtypeStruct((), jnp.float32)).shape
    assert shape == (n, 3, n)
    h0, om = _state(n, 3)
    inputs = _hoist(h0, om, tc)
    planes = fused_step.packed_planes(inputs, [2.5], tc)
    assert planes.shape == (1, 3, n, n)
    fields = fused_step.fused_fields(torch.from_numpy(h0), torch.from_numpy(om), 2.5, tc)
    assert fields.shape == (n, n, 3) and torch.equal(fields, torch.movedim(planes[0], 0, -1))
    ck = fused_step.packed_checksums(inputs, [2.5], tc)
    normals = finite_difference_normals_planes(planes[0, 1], tc.normal_height_scale)
    assert torch.allclose(ck[0], planes.sum() + normals.sum(), rtol=0.0, atol=1e-3)


def _jax_state(h0, om):
    return J.OceanState(h0=jnp.asarray(h0), omega=jnp.asarray(om))


SLICE_CASES = [(64, "bf16x3", 1), (64, "bf16x3", 3), (64, "highest", 3), (512, "highest", 3)]
SLICE_IDS = ["k4-tb1", "k4-tb3", "k4-highest-tb3", "k5k6-512-tb3"]


@pytest.mark.parametrize("n,precision,time_batch", SLICE_CASES, ids=SLICE_IDS)
def test_slice_matches_jax_matmul_rollout(n, precision, time_batch, monkeypatch):
    """``step`` and ``make_rollout`` (both modes) on the unpacked "pallas"
    route against JAX ``make_rollout``: at "highest" on the unpacked matmul
    route (``tests/test_pallas.py:40-49`` holds that equal to K4); at
    "bf16x3" on the same unpacked "pallas" route, ``_step_kernel`` at the
    tier in interpret mode (the port's K4 runs the JAX kernel's tier)."""
    h0, om = _state(n, 4)
    if precision == "highest":
        jc = J.OceanConfig(resolution=n, fft_impl="matmul", hermitian_pack=False,
                           matmul_precision="highest")
        tol, normals_tol = (TOL["highest"] if n < 512 else TOL_512), NORMALS_TOL[n]
    else:
        jc = _configs(n, precision)[0]
        tol, normals_tol = SPLIT_SLICE_TOL, SPLIT_NORMALS_TOL
        fields, cks = ps.pallas_fields, ps.pallas_checksums
        monkeypatch.setattr(ps, "pallas_fields",
                            lambda h, o, t, cfg, interpret=False: fields(h, o, t, cfg, True))
        monkeypatch.setattr(ps, "pallas_checksums",
                            lambda h, o, ts, cfg, interpret=False: cks(h, o, ts, cfg, True))
    _, tc = _configs(n, precision)
    jst, tst = _jax_state(h0, om), state_from_numpy(h0, om, device="cpu")
    ts = np.asarray([0.5, 11.25, 1000.0], np.float32)
    want = J.make_rollout(jc, keep_fields=True, time_batch=time_batch)(jst, jnp.asarray(ts))
    got = T.make_rollout(tc, keep_fields=True, time_batch=time_batch)(tst, torch.from_numpy(ts))
    assert got.displacement.shape == (3, n, n, 3) and got.normals.shape == (3, n, n, 3)
    assert _rel(got.displacement.numpy(), want.displacement) < tol
    assert np.abs(got.normals.numpy() - np.asarray(want.normals)).max() < normals_tol
    one = T.step(tst, float(ts[1]), tc)
    assert _rel(one.displacement.numpy(), np.asarray(want.displacement)[1]) < tol

    want_ck = np.asarray(J.make_rollout(jc, keep_fields=False, time_batch=time_batch)(
        jst, jnp.asarray(ts)))
    got_ck = T.make_rollout(tc, keep_fields=False, time_batch=time_batch)(tst, ts)
    assert got_ck.shape == (3,) and torch.isfinite(got_ck).all()
    scale = (got.displacement.abs().sum(dim=(-3, -2, -1))
             + got.normals.abs().sum(dim=(-3, -2, -1))).numpy()
    assert np.all(np.abs(got_ck.numpy() - want_ck) < CHECKSUM_TOL * scale)


def test_frame_renderer_runs_the_unpacked_step():
    """A 96x64 frame through ``make_frame_renderer`` on the unpacked
    "pallas" route equals the same renderer's frame on the unpacked matmul
    route within the renderer's near-tie envelope (values off by more than
    1 in fewer than 1e-3, as ``tests/test_torch_render.py`` holds frames)."""
    h0, om = _state(64, 5)
    tst = state_from_numpy(h0, om, device="cpu")
    kw = dict(resolution=64, hermitian_pack=False, mesh_resolution=32, num_patches=4)
    cam = tcam.Camera()
    vp = (tcam.perspective(96 / 64) @ cam.view()).astype(np.float32)
    cp = cam.position.astype(np.float32)
    frames = []
    for impl in ("pallas", "matmul"):
        cfg = T.OceanConfig(fft_impl=impl, **kw)
        frame, dropped = tr.make_frame_renderer(cfg, 96, 64, pool=32_768, diag=True)(
            tst, 5.0, vp, cp)
        assert frame.dtype == torch.uint8 and frame.shape == (64, 96, 3) and int(dropped) == 0
        frames.append(frame.to(torch.int32))
    assert float(((frames[0] - frames[1]).abs() > 1).float().mean()) < 1e-3
    assert float(frames[0].float().mean()) > 10.0


def test_cpu_tensors_take_the_plain_version():
    h0, om = _state(32, 6)
    _, tc = _configs(32, "bf16x3")
    inputs = _hoist(h0, om, tc)
    counts = (_launches("launch_unpacked_step"), _launches("launch_unpacked_rows"),
              _launches("launch_unpacked_cols"))
    got = fused_step.packed_checksums(inputs, [1.0, 2.0], tc)
    assert torch.equal(got, fused_step.checksums_of_planes(
        us.unpacked_planes_reference(inputs, [1.0, 2.0], tc), tc))
    for launch in (lambda: us.launch_unpacked_step(inputs, [1.0], tc),
                   lambda: us.launch_unpacked_rows(inputs, [1.0], tc),
                   lambda: us.launch_unpacked_cols(torch.zeros(1, 3, 2, 32, 32), inputs)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            launch()
    assert counts == (_launches("launch_unpacked_step"), _launches("launch_unpacked_rows"),
                      _launches("launch_unpacked_cols"))


@pytest.mark.parametrize("precision,route", [("bf16x3", "single"), ("highest", "blocked")])
def test_checksums_dispatch_on_the_tensors_device(precision, route, monkeypatch):
    """``unpacked_checksums`` picks by where the tensors lie. CPU tensors:
    ``checksums_of_planes`` of the plain version. CUDA tensors: the checksum
    kernel's partials behind K4 (single route) or behind K6 fed by K5
    (blocked), summed, and ``checksums_of_planes`` is not called. The
    launchers are stood in for here (a CUDA kernel has no CPU mode): each
    returns the plain version's planes and their row sums as partials."""
    n = 512 if route == "blocked" else 64
    h0, om = _state(n, 10)
    _, tc = _configs(n, precision)
    inputs = _hoist(h0, om, tc)
    assert us.unpacked_route(tc, n) == route
    ts = [1.0, 2.5]
    want = fused_step.checksums_of_planes(us.unpacked_planes_reference(inputs, ts, tc), tc)
    assert torch.equal(us.unpacked_checksums(inputs, ts, tc), want)

    calls = []

    def partials_of(planes):
        normals = finite_difference_normals_planes(planes[:, 1], tc.normal_height_scale)
        return planes.sum(dim=(1, 3)) + normals.sum(dim=(1, 3))

    def fake_step(inp, tt, cfg):
        calls.append("k4")
        planes = us.unpacked_planes_reference(inputs, tt, cfg)
        return planes, partials_of(planes)

    def fake_rows(inp, tt, cfg):
        calls.append("k5")
        return us.unpacked_rows_reference(inputs, tt, cfg)

    def fake_cols(y, inp, cfg):
        calls.append("k6")
        planes = us.unpacked_cols_reference(y, inputs)
        return planes, partials_of(planes)

    def no_plain_checksum(*args):
        raise AssertionError("checksums_of_planes called on the CUDA branch")

    class OnCard:
        """Hoisted inputs that claim to lie on the card."""
        omega = type("Omega", (), {"is_cuda": True, "shape": (n, n)})()

    monkeypatch.setattr(us, "launch_unpacked_step_checksums", fake_step)
    monkeypatch.setattr(us, "launch_unpacked_rows", fake_rows)
    monkeypatch.setattr(us, "launch_unpacked_cols_checksums", fake_cols)
    monkeypatch.setattr(us, "checksums_of_planes", no_plain_checksum)
    got = us.unpacked_checksums(OnCard(), ts, tc)
    assert calls == (["k4"] if route == "single" else ["k5", "k6"])
    summands = (us.unpacked_planes_reference(inputs, ts, tc).abs().sum(dim=(-3, -2, -1))
                + float(3 * n * n))
    assert float(((got - want).abs() / summands).max()) < 1e-6


def test_time_batch_frames_equal_single_frames():
    h0, om = _state(64, 7)
    _, tc = _configs(64, "highest")
    inputs = _hoist(h0, om, tc)
    ts = [1.0, 1.7, 2.4, 1000.0]
    batch = us.unpacked_planes(inputs, ts, tc)
    assert batch.shape == (4, 3, 64, 64)
    for j, t in enumerate(ts):
        # the batched matmul may block differently from the single one; the
        # kernels' frames are bit-identical (CUDA test).
        assert _rel(batch[j].numpy(), us.unpacked_planes(inputs, [t], tc)[0].numpy()) < 1e-7


@pytest.mark.parametrize("maker", ["state_from_numpy", "ocean_state_from_phillips"])
def test_state_constructors_default_to_the_card(maker, monkeypatch):
    """With no card the default device raises instead of quietly building a
    CPU state; ``device="cpu"`` asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h0, om = _state(16, 8)
    cfg = T.OceanConfig(resolution=16)
    build = {"state_from_numpy": lambda **kw: state_from_numpy(h0, om, **kw),
             "ocean_state_from_phillips": lambda **kw: T.ocean_state_from_phillips(cfg, **kw)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build[maker]()
    st = build[maker](device="cpu")
    assert st.h0.device.type == "cpu" and st.h0.shape == (2, 16, 16)


def test_unpacked_configs_keep_their_limits():
    _, tc = _configs(64, "default")
    # "default" runs as one bf16 pass, K4's tiered body
    assert fused_step.check_supported(tc, 64) == "default"
    with pytest.raises(ValueError, match="N <= 512"):
        us.check_supported(dataclasses.replace(tc, matmul_precision="highest"), 1024)
    # N > 512 takes the four-step route whatever hermitian_pack says
    big = T.OceanConfig(resolution=1024, fft_impl="pallas", hermitian_pack=False)
    h0, om = _state(1024, 9)
    assert isinstance(_hoist(h0, om, big), fused_step.FourstepInputs)
