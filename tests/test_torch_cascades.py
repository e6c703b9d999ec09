"""Cascades (BASELINE config 4: a leading axis C of the state) in
``gfx_ocean_tpu_torch`` against the JAX package on the CPU: the step and
the rollouts on every route, foam's per-cascade domain, the synthesis, and
the composited frame.

The two packages get the same cascade state from one numpy draw
(``state_from_numpy`` carries it across). The JAX "pallas" route vmaps its
fused Pallas kernel over the cascades; on the CPU that runs in interpret
mode, so the fixture passes ``interpret=True`` as ``tests/test_torch_step.py``
does. The port's "pallas" route takes the plain versions, because its
tensors lie on the CPU: K1's with the cascade axis, K2 + K3's and K4's one
cascade a call.

Tolerances are the single-cascade tests' for the same route
(``tests/test_torch_step.py``, ``tests/test_torch_render.py``).
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu.ops.pallas_step as ps
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.golden.reference import golden_fields
from gfx_ocean_tpu.render import camera as jcam
from gfx_ocean_tpu.render import mesh as jmesh
from gfx_ocean_tpu.render import raster as jr
from gfx_ocean_tpu.render import shade as jsh
from gfx_ocean_tpu_torch.models.ocean import state_from_numpy
from gfx_ocean_tpu_torch.ops import fused_step
from gfx_ocean_tpu_torch.ops.derived import jacobian_foam
from gfx_ocean_tpu_torch.render import camera as tcam
from gfx_ocean_tpu_torch.render import raster as tr
from gfx_ocean_tpu_torch.render import shade as tsh

jspec = importlib.import_module("gfx_ocean_tpu.spectra.phillips")
tspec = importlib.import_module("gfx_ocean_tpu_torch.spectra.phillips")

N = 64
C = 3
DOMAINS = (1000.0, 250.0, 62.5)   # the default ladder L, L/4, L/16
# Fields relative to max |field| at "highest": float32 transforms summed in
# different orders (test_torch_step.py TOL["highest"]).
TOL = 1e-6
# Normals are unit vectors: absolute (test_torch_step.py NORMALS_TOL["highest"]).
# At 1024^2 they difference a float32 height error amplified by
# N / height_scale, which the JAX package's normals carry as well
# (test_torch_fourstep.py::test_normals_are_as_far_from_golden_as_the_jax_package:
# each ~8.5e-5 from golden, within 1.5x that of each other).
NORMALS_TOL = {64: 1e-5, 1024: 1.5e-4}
# Checksums nearly cancel; held on the scale of their summands.
CHECKSUM_TOL = 1e-6
# Foam: texels whose Jacobian lies within this of the threshold may differ
# (XLA contracts the Jacobian's products into FMAs on the CPU).
FOAM_NEAR = 1e-5
FOAM = dict(compute_foam=True, foam_threshold=0.9, foam_lambda=1.5)
# Frames pool against pool (test_torch_render.py): coverage equal, depth to
# 2e-6 where both cover, color to 1e-4; shading alone to 1e-5.
Z_TOL, COLOR_TOL, SHADE_TOL = 2e-6, 1e-4, 1e-5
# The stored 1200x700 frame's envelope (test_torch_render.py): share of
# uint8 values off by more than 2, and the largest mean-color difference.
FRAME_OFF, FRAME_MEAN_COLOR = 1e-3, 0.5
POOL = 32_768


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig_fields, orig_cks = ps.pallas_fields, ps.pallas_checksums
    monkeypatch.setattr(ps, "pallas_fields",
                        lambda h0, om, t, cfg, interpret=False: orig_fields(h0, om, t, cfg, True))
    monkeypatch.setattr(ps, "pallas_checksums",
                        lambda h0, om, ts, cfg, interpret=False: orig_cks(h0, om, ts, cfg, True))


def _cascade_numpy(n: int, domains, seed: int):
    """A cascade state from one numpy draw: cascade c is the Phillips
    envelope and dispersion at domains[c]."""
    xi = np.random.default_rng(seed).standard_normal((len(domains), 2, n, n)).astype(np.float32)
    env = np.stack([np.sqrt(tspec.phillips_spectrum(n, d, T.PhillipsConfig()) / 2.0)
                    for d in domains]).astype(np.float32)
    return xi * env[:, None], np.stack([tspec.dispersion(n, d) for d in domains])


def _states(n: int = N, domains=DOMAINS, seed: int = 0):
    h0, om = _cascade_numpy(n, domains, seed)
    return (J.OceanState(h0=jnp.asarray(h0), omega=jnp.asarray(om)),
            state_from_numpy(h0, om, device="cpu"))


def _configs(**kwargs):
    kwargs.setdefault("resolution", N)
    kwargs.setdefault("num_cascades", C)
    return J.OceanConfig(**kwargs), T.OceanConfig(**kwargs)


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _foam_differs_only_near_threshold(got, want, disp, domains, cfg) -> np.ndarray:
    """Texels where the foam masks differ, asserting each lies within
    FOAM_NEAR of the threshold (float64 Jacobian at its cascade's domain).
    ``got`` (..., C, N, N), ``disp`` (..., C, N, N, 3)."""
    differ = got.numpy() != np.asarray(want)
    d = disp.double()
    n = d.shape[-2]
    lam = cfg.foam_lambda
    for c, dom in enumerate(domains):
        inv2h = n / (2.0 * dom)

        def dd(f, axis):
            return (torch.roll(f, -1, dims=axis) - torch.roll(f, 1, dims=axis)) * inv2h

        fx, fz = d[..., c, :, :, 0], d[..., c, :, :, 2]
        jac = ((1 + lam * dd(fx, -1)) * (1 + lam * dd(fz, -2))
               - lam * dd(fx, -2) * lam * dd(fz, -1)).numpy()
        dc = differ[..., c, :, :]
        assert np.all(np.abs(jac[dc] - cfg.foam_threshold) < FOAM_NEAR)
    return differ


ROUTES = {
    "pallas": dict(fft_impl="pallas", matmul_precision="highest"),
    "pallas-unpacked": dict(fft_impl="pallas", matmul_precision="highest",
                            hermitian_pack=False),
    # K2 + K3's plain version; two cascades keep the interpret-mode JAX side short
    "pallas-1024": dict(fft_impl="pallas", matmul_precision="highest", resolution=1024,
                        num_cascades=2),
    "matmul": dict(fft_impl="matmul", matmul_precision="highest"),
}


def _route_states(route: str, seed: int):
    kw = ROUTES[route]
    n = kw.get("resolution", N)
    return _states(n, DOMAINS[:kw.get("num_cascades", C)], seed)


# --- the step and the rollouts against the JAX package ---------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_cascade_step_matches_jax_and_golden(route, interpret_pallas):
    jc, tc = _configs(**ROUTES[route], **FOAM)
    jst, tst = _route_states(route, 1)
    n, cc = tst.h0.shape[-1], tst.h0.shape[0]
    t = 11.25
    want = J.make_step(jc)(jst, jnp.float32(t))
    got = T.make_step(tc)(tst, t)
    assert got.displacement.shape == (cc, n, n, 3) and got.normals.shape == (cc, n, n, 3)
    assert got.foam.shape == (cc, n, n) and got.foam.dtype == torch.float32
    assert _rel(got.displacement.numpy(), want.displacement) < TOL
    assert np.abs(got.normals.numpy() - np.asarray(want.normals)).max() < NORMALS_TOL[n]
    assert float(got.foam.mean()) > 1e-3
    _foam_differs_only_near_threshold(got.foam, want.foam, got.displacement, tc.domains, tc)
    # Each cascade against the float64 golden model: within TOL, or as close
    # as the JAX package comes (at 1024^2 the finer cascades' larger omega
    # costs both float32 packages ~1.1e-6).
    h0 = tst.h0.numpy()
    for c in range(cc):
        gold = golden_fields(h0[c, 0] + 1j * h0[c, 1], tst.omega[c].numpy(), t,
                             tc.domain_size, jc.compat)
        jax_err = _rel(np.asarray(want.displacement[c]), gold)
        assert _rel(got.displacement[c].numpy(), gold) < max(TOL, 1.5 * jax_err)


@pytest.mark.parametrize("foam", [False, True], ids=["no-foam", "foam"])
@pytest.mark.parametrize("time_batch", [1, 3])
@pytest.mark.parametrize("route", list(ROUTES))
def test_cascade_rollout_matches_jax(route, time_batch, foam, interpret_pallas):
    """Fields (T, C, ...) and one checksum a frame summed over the cascades,
    against the JAX rollout on the same cascade state."""
    jc, tc = _configs(**ROUTES[route], **(FOAM if foam else {}))
    jst, tst = _route_states(route, 2)
    n, cc = tst.h0.shape[-1], tst.h0.shape[0]
    ts = np.asarray([0.5, 11.25, 1000.0], np.float32)
    want = J.make_rollout(jc, keep_fields=True, time_batch=time_batch)(jst, jnp.asarray(ts))
    got = T.make_rollout(tc, keep_fields=True, time_batch=time_batch)(tst, torch.from_numpy(ts))
    assert got.displacement.shape == (3, cc, n, n, 3) and got.normals.shape == (3, cc, n, n, 3)
    assert _rel(got.displacement.numpy(), want.displacement) < TOL
    assert np.abs(got.normals.numpy() - np.asarray(want.normals)).max() < NORMALS_TOL[n]
    scale = (got.displacement.abs().sum(dim=(-4, -3, -2, -1))
             + got.normals.abs().sum(dim=(-4, -3, -2, -1))).numpy()
    slack = 0.0
    if foam:
        assert got.foam.shape == (3, cc, n, n)
        differ = _foam_differs_only_near_threshold(got.foam, want.foam, got.displacement,
                                                   tc.domains, tc)
        scale = scale + got.foam.sum(dim=(-3, -2, -1)).numpy()
        slack = differ.sum(axis=(-3, -2, -1))
    else:
        assert got.foam is None
    want_ck = np.asarray(J.make_rollout(jc, keep_fields=False, time_batch=time_batch)(
        jst, jnp.asarray(ts)))
    got_ck = T.make_rollout(tc, keep_fields=False, time_batch=time_batch)(tst, ts)
    assert got_ck.shape == (3,) and got_ck.dtype == torch.float32
    assert np.all(np.abs(got_ck.numpy() - want_ck) < CHECKSUM_TOL * scale + slack)


@pytest.mark.parametrize("route", ["pallas", "matmul"])
def test_batched_step_equals_per_cascade_steps(route):
    """As tests/test_spectra.py:265 holds the JAX package: each cascade of a
    batched step against a single step at that cascade's domain."""
    _, tc = _configs(**ROUTES[route], num_cascades=2, compute_normals=False)
    _, tst = _states(N, DOMAINS[:2], 9)
    batched = T.make_step(tc)(tst, 1.0)
    for c in range(2):
        single_cfg = T.OceanConfig(**ROUTES[route], resolution=N, compute_normals=False,
                                   domain_size=tc.domains[c])
        single = T.make_step(single_cfg)(T.OceanState(tst.h0[c], tst.omega[c]), 1.0)
        np.testing.assert_allclose(batched.displacement[c].numpy(),
                                   single.displacement.numpy(), atol=2e-4, rtol=0)


def test_k1_plain_version_on_cascades_equals_single_calls():
    """K1's plain version broadcasts over C: bit for bit the C single-cascade
    calls (the kernel is held to the same on the card)."""
    _, tc = _configs(fft_impl="pallas")
    _, tst = _states(seed=3)
    ts = torch.tensor([0.0, 3.25, 1000.0])
    inputs = fused_step.hoist_packed(tst.h0, tst.omega, tc)
    assert isinstance(inputs, fused_step.PackedInputs) and inputs.h0.shape == (C, 2, N, N)
    planes = fused_step.packed_planes(inputs, ts, tc)
    assert planes.shape == (3, C, 3, N, N)
    checks = fused_step.packed_checksums(inputs, ts, tc)
    singles = []
    for c in range(C):
        one = fused_step.hoist_packed(tst.h0[c], tst.omega[c], tc)
        assert torch.equal(planes[:, c], fused_step.packed_planes(one, ts, tc))
        singles.append(fused_step.packed_checksums(one, ts, tc))
    assert checks.shape == (3,)
    assert torch.allclose(checks, sum(singles), rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("kw", [dict(hermitian_pack=False), dict(resolution=1024)],
                         ids=["unpacked", "fourstep"])
def test_routes_without_a_cascade_axis_run_one_cascade_a_call(kw):
    """K2 + K3 and K4-K6 take one cascade a call: one hoisted input a
    cascade, their planes stacked on axis 1 and their checksums summed."""
    cfg = T.OceanConfig(fft_impl="pallas", num_cascades=2, **{"resolution": 32, **kw})
    n = cfg.resolution
    h0, om = _cascade_numpy(n, DOMAINS[:2], 4)
    h0, om = torch.from_numpy(h0), torch.from_numpy(om)
    inputs = fused_step.hoist_packed(h0, om, cfg)
    assert isinstance(inputs, fused_step.CascadeInputs) and len(inputs.per_cascade) == 2
    ts = torch.tensor([0.5, 2.0])
    planes = fused_step.packed_planes(inputs, ts, cfg)
    assert planes.shape == (2, 2, 3, n, n)
    checks = fused_step.packed_checksums(inputs, ts, cfg)
    singles = [fused_step.hoist_packed(h0[c], om[c], cfg) for c in range(2)]
    for c in range(2):
        assert torch.equal(planes[:, c], fused_step.packed_planes(singles[c], ts, cfg))
    assert torch.equal(checks, fused_step.packed_checksums(singles[0], ts, cfg)
                       + fused_step.packed_checksums(singles[1], ts, cfg))


def test_foam_domain_rule_follows_the_cascade_axis():
    """Foam takes each cascade's domain exactly when num_cascades > 1 and the
    state's cascade axis has num_cascades entries (JAX models/ocean.py:184);
    a time batch of the same length in front does not trigger it."""
    kw = dict(resolution=32, fft_impl="matmul", matmul_precision="highest", **FOAM)
    _, st = _states(32, DOMAINS, 5)
    ts = [0.5, 1.0, 8.0]
    cfg3 = T.OceanConfig(num_cascades=3, **kw)
    casc = T.make_rollout(cfg3, time_batch=3)(st, ts)
    for c, dom in enumerate(DOMAINS):
        assert torch.equal(casc.foam[:, c], jacobian_foam(casc.displacement[:, c], cfg3,
                                                          domain_size=dom))
    single = T.make_rollout(cfg3, time_batch=3)(T.OceanState(st.h0[1], st.omega[1]), ts)
    assert single.foam.shape == (3, 32, 32)
    assert torch.equal(single.foam, jacobian_foam(single.displacement, cfg3))
    # a one-cascade config on a stack keeps config.domain_size for every cascade
    cfg1 = T.OceanConfig(**kw)
    one = T.make_step(cfg1)(st, 1.0)
    assert torch.equal(one.foam, jacobian_foam(one.displacement, cfg1))


# --- synthesis --------------------------------------------------------------------

@pytest.mark.parametrize("model", ["phillips", "jonswap"])
def test_cascade_synthesis(model):
    """The domain ladder; cascade c is the c-th (2, N, N) draw of one
    generator times its envelope at domains[c] (JONSWAP normalized at its own
    domain), against the JAX package's spectra/phillips.py; cascade 0 equals
    the single-cascade state of the same seed."""
    n, seed = 32, 5
    pc = T.PhillipsConfig(model=model, seed=seed)
    cfg = T.OceanConfig(resolution=n, num_cascades=3)
    assert cfg.domains == DOMAINS == J.OceanConfig(resolution=n, num_cascades=3).domains
    st = T.ocean_state_from_phillips(cfg, pc, device="cpu")
    assert st.h0.shape == (3, 2, n, n) and st.omega.shape == (3, n, n)
    gen = torch.Generator().manual_seed(seed)
    jpc = J.PhillipsConfig(model=model, seed=seed)
    for c, dom in enumerate(DOMAINS):
        noise = torch.randn((2, n, n), generator=gen, dtype=torch.float32)
        env = np.sqrt(jspec.spectrum(n, dom, jpc) / 2.0).astype(np.float32)
        assert np.array_equal(st.h0[c].numpy(), noise.numpy() * env)
        assert np.array_equal(st.omega[c].numpy(), jspec.dispersion(n, dom))
        assert float(st.h0[c].abs().max()) > 0
    single = T.ocean_state_from_phillips(T.OceanConfig(resolution=n), pc, device="cpu")
    assert torch.equal(st.h0[0], single.h0) and torch.equal(st.omega[0], single.omega)
    assert not torch.equal(st.h0[0], st.h0[1])
    custom = T.OceanConfig(resolution=n, num_cascades=2, cascade_domains=(500.0, 40.0))
    st2 = T.ocean_state_from_phillips(custom, pc, generator=torch.Generator().manual_seed(1),
                                      device="cpu")
    assert np.array_equal(st2.omega[1].numpy(), jspec.dispersion(n, 40.0))


# --- render -----------------------------------------------------------------------

def _cascade_fields(n: int = N, t: float = 4.0):
    """JAX step fields of a 3-cascade state with foam: (C, N, N, 3), (C, N, N)."""
    jst, _ = _states(n, DOMAINS, 6)
    jc = J.OceanConfig(resolution=n, num_cascades=C, compute_normals=False, **FOAM)
    out = J.make_step(jc)(jst, jnp.float32(t))
    return np.array(out.displacement), np.array(out.foam)


def test_zero_tail_stack_equals_single_field_frame():
    """[disp, 0, 0] composites to the single-field frame (tests/test_render.py:787
    holds the JAX package to 1e-5; the port's zero cascades add exact zeros)."""
    disp = torch.from_numpy(_cascade_fields()[0][0])
    stack = torch.stack([disp, torch.zeros_like(disp), torch.zeros_like(disp)])
    cam = tcam.Camera()
    kw = dict(width=96, height=64, mesh_resolution=64, pool=POOL, return_depth=True)
    single, zs = tr.render_frame(disp, cam, **kw)
    casc, zc = tr.render_frame(stack, cam, cascade_domains=DOMAINS, **kw)
    assert torch.isfinite(zs).float().mean() > 0.05
    assert torch.equal(casc, single) and torch.equal(zc, zs)


def test_cascade_vertex_compositing_matches_numpy_golden():
    """The cascade vertex stage against the float64 numpy composite
    sum_c bilinear(disp_c, uv * tile_c) at the mesh UV grid
    (tests/test_render.py:805)."""
    rng = np.random.default_rng(5)
    n, h = 32, 16
    stack = rng.standard_normal((3, n, n, 3)).astype(np.float32)
    cpu = torch.device("cpu")
    tiles, interp = tr._cascade_setup(torch.from_numpy(stack), DOMAINS, h, cpu)
    assert tiles == (1.0, 4.0, 16.0)
    positions, uvs, _ = tr._mesh_constants(h, 1, cpu)
    world, _ = tr._vertex_stage(torch.from_numpy(stack), positions, uvs, torch.eye(4), interp,
                                height_div=1.0, horiz_div=1.0)
    got = (world - positions).numpy()

    def bilerp64(tex, u, v):
        x, y = u * n - 0.5, v * n - 0.5
        x0, y0 = np.floor(x), np.floor(y)
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        x0i, y0i = np.mod(x0.astype(int), n), np.mod(y0.astype(int), n)
        x1i, y1i = (x0i + 1) % n, (y0i + 1) % n
        t = tex.astype(np.float64)
        return ((t[y0i, x0i] * (1 - fx) + t[y0i, x1i] * fx) * (1 - fy)
                + (t[y1i, x0i] * (1 - fx) + t[y1i, x1i] * fx) * fy)

    grid_u = np.arange(h, dtype=np.float64) / (h - 1)
    uu, vv = np.meshgrid(grid_u, grid_u)
    want = sum(bilerp64(stack[c], uu.ravel() * tiles[c], vv.ravel() * tiles[c])
               for c in range(3))
    np.testing.assert_allclose(got, want, atol=2e-5)
    # the gather form (no matrices) composites as the JAX package's does
    world_g, _ = tr._vertex_stage(torch.from_numpy(stack), positions, uvs, torch.eye(4),
                                  height_div=1.0, horiz_div=1.0, tiles=tiles)
    jworld_g, _ = jr._vertex_stage(jnp.asarray(stack), jnp.asarray(positions.numpy()),
                                   jnp.asarray(uvs.numpy()), jnp.eye(4, dtype=jnp.float32),
                                   height_div=1.0, horiz_div=1.0, tiles=tiles)
    np.testing.assert_allclose(world_g.numpy(), np.asarray(jworld_g), atol=2e-5)
    # tile 1.0 is bit-identical to the untiled matrices, and the tiles match JAX
    assert np.array_equal(tr._interp_matrices_np(h, n, 1.0), tr._interp_matrices_np(h, n))
    for tile in (1.0, 4.0, 16.0):
        assert np.array_equal(tr._interp_matrices_np(128, 512, tile),
                              np.asarray(jr._interp_matrices(128, 512, tile)[0]))


def test_cascade_shading_matches_jax():
    """fragment_normals with the chain rule's tile factor and shade_fragments
    with the union of the per-cascade foam masks, against the JAX package."""
    disp, foam = _cascade_fields(32)
    rng = np.random.default_rng(2)
    u = rng.uniform(-0.2, 1.2, (40, 30)).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, (40, 30)).astype(np.float32)
    world = rng.uniform(-50, 50, (40, 30, 3)).astype(np.float32)
    cam = np.array([1.0, 20.0, -3.0], np.float32)
    tiles = (1.0, 4.0, 16.0)
    for channel in (0, 1):
        want = jsh.fragment_normals(jnp.asarray(disp), jnp.asarray(u), jnp.asarray(v),
                                    channel=channel, tiles=tiles)
        got = tsh.fragment_normals(torch.from_numpy(disp), torch.from_numpy(u),
                                   torch.from_numpy(v), channel=channel, tiles=tiles)
        assert np.abs(got.numpy() - np.asarray(want)).max() < SHADE_TOL
    want = jsh.shade_fragments(jnp.asarray(disp), jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(world), jnp.asarray(cam), foam=jnp.asarray(foam),
                               tiles=tiles)
    got = tsh.shade_fragments(torch.from_numpy(disp), torch.from_numpy(u), torch.from_numpy(v),
                              torch.from_numpy(world), cam, foam=torch.from_numpy(foam),
                              tiles=tiles)
    assert np.abs(got.numpy() - np.asarray(want)).max() < SHADE_TOL


def test_cascade_frame_with_foam_matches_jax():
    """A 3-cascade 96x64 frame with per-cascade foam through mesh 64 x 4,
    against JAX render_frame on the same fields, in the frame envelope of
    tests/test_torch_render.py; and the pool diagnostic on the stack."""
    disp, foam = _cascade_fields()
    cam_j, cam_t = jcam.Camera(), tcam.Camera()
    kw = dict(width=96, height=64, mesh_resolution=64, pool=POOL, return_depth=True)
    want, wz = jr.render_frame(jnp.asarray(disp), cam_j, foam=jnp.asarray(foam),
                               cascade_domains=DOMAINS, **kw)
    got, gz = tr.render_frame(torch.from_numpy(disp), cam_t, foam=torch.from_numpy(foam),
                              cascade_domains=DOMAINS, **kw)
    want, wz, got, gz = np.array(want), np.asarray(wz), got.numpy(), gz.numpy()
    cov = np.isfinite(gz)
    assert got.shape == (64, 96, 3) and np.array_equal(cov, np.isfinite(wz))
    assert 0.05 < cov.mean() < 1.0
    assert np.abs(gz[cov] - wz[cov]).max() <= Z_TOL
    # Colors: the stored frame's envelope (test_torch_render.py), on sRGB
    # uint8. The foam masks' sharp edges turn the two packages' float32 uv
    # rounding (XLA contracts into FMAs) into visible steps on a few pixels
    # (measured: 41 of 2,880 covered pixels past 1e-4, at most 8e-3; no
    # uint8 value off by more than 1).
    diff = np.abs(tr.srgb8(torch.from_numpy(got)).numpy().astype(np.int32)
                  - tr.srgb8(torch.from_numpy(want)).numpy().astype(np.int32))
    assert (diff > 2).mean() < FRAME_OFF
    assert np.abs(diff.reshape(-1, 3).mean(0)).max() < FRAME_MEAN_COLOR
    positions, uvs, tris = jmesh.instantiate(jmesh.build_grid(128, 4))
    vp = (jcam.perspective(480 / 280) @ jcam.Camera().view()).astype(np.float32)
    jwant = jr.pool_overflow(jnp.asarray(disp), positions, uvs, tris.astype(np.int32), vp,
                             480, 280, pool=4096, return_demand=True)
    assert tr.pool_overflow(torch.from_numpy(disp), positions, uvs, tris, vp, 480, 280,
                            pool=4096, return_demand=True) == jwant


def test_cascade_frame_renderer_matches_jax(interpret_pallas):
    """make_frame_renderer(num_cascades=3, compute_foam=True): the port's
    fused frame against the JAX package's, and against step -> render_frame."""
    jst, tst = _states(N, DOMAINS, 7)
    kw = dict(resolution=N, num_cascades=C, fft_impl="pallas", mesh_resolution=64,
              num_patches=4, **FOAM)
    jc, tc = J.OceanConfig(**kw), T.OceanConfig(**kw)
    cam = tcam.Camera()
    vp = (tcam.perspective(96 / 64) @ cam.view()).astype(np.float32)
    cp = cam.position.astype(np.float32)
    got, dropped = tr.make_frame_renderer(tc, 96, 64, pool=POOL, diag=True)(tst, 5.0, vp, cp)
    assert got.dtype == torch.uint8 and got.shape == (64, 96, 3) and int(dropped) == 0
    fields = T.make_step(tc)(tst, 5.0)
    assert fields.foam.shape == (C, N, N)
    again = tr.srgb8(tr.render_frame(fields.displacement, cam, width=96, height=64,
                                     mesh_resolution=64, pool=POOL, foam=fields.foam,
                                     cascade_domains=tc.domains))
    assert torch.equal(got, again)
    jframe = np.asarray(jr.make_frame_renderer(jc, 96, 64, pool=POOL)(
        jst, jnp.float32(5.0), jnp.asarray(vp), jnp.asarray(cp)))
    diff = np.abs(got.numpy().astype(np.int32) - jframe.astype(np.int32))
    assert (diff > 1).mean() < 1e-3
    strip = tr.make_batch_renderer(tc, 96, 64, pool=POOL)(tst, [5.0], vp[None], cp[None])
    assert torch.equal(strip[0], got)


def test_cascade_stack_requires_domains():
    stack = torch.zeros(2, 16, 16, 3)
    with pytest.raises(ValueError, match="cascade_domains"):
        tr.render_frame(stack, tcam.Camera(), 32, 32, mesh_resolution=16)
    with pytest.raises(ValueError, match="cascade_domains"):
        tr.render_frame(stack, tcam.Camera(), 32, 32, mesh_resolution=16,
                        cascade_domains=DOMAINS)
