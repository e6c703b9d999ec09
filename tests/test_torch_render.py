"""The frame renderer of ``gfx_ocean_tpu_torch.render`` against the JAX
package's on the CPU: mesh and camera copies, shading, whole frames, the
fused step -> rasterize -> sRGB pipeline, and the stored 1200x700 frame
that the JAX package rendered.

Inputs are numpy-seeded states only (``_numpy_state``). The JAX "pallas"
step reaches its Pallas kernel, which runs on the CPU only in interpret
mode, so the fixture below passes ``interpret=True`` as
``tests/test_torch_step.py`` does; the JAX rasterizer's kernels pick
interpret mode on the CPU themselves. The port takes its plain versions
because its tensors lie on the CPU.

Regenerate the stored frame (intended changes of the JAX renderer only):

    JAX_PLATFORMS=cpu python tests/test_torch_render.py
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu.ops.pallas_step as ps
from gfx_ocean_tpu.render import camera as jcam
from gfx_ocean_tpu.render import mesh as jmesh
from gfx_ocean_tpu.render import raster as jr
from gfx_ocean_tpu.render import shade as jsh

import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu_torch.models.ocean import state_from_numpy
from gfx_ocean_tpu_torch.render import camera as tcam
from gfx_ocean_tpu_torch.render import mesh as tmesh
from gfx_ocean_tpu_torch.render import raster as tr
from gfx_ocean_tpu_torch.render import shade as tsh
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum, synthesize

REPO = Path(__file__).resolve().parent.parent
STORED = REPO / "gfx_ocean_tpu_torch" / "golden" / "frame_jax_1200x700.npz"
# Pool against pool at small shapes (tests/test_render.py:389-399): coverage
# equal, depth to 2e-6 where both cover, color to 1e-4.
Z_TOL, COLOR_TOL = 2e-6, 1e-4
# Shading and normals: float32 evaluated in another order (XLA contracts
# products into FMAs on the CPU; PyTorch rounds every op).
SHADE_TOL = 1e-5
# Slot pools of the small frames: the default's 2^18-slot floor would make
# every CPU frame pay for ~250K dead slots; the same pool goes to both sides.
POOL = 32_768
# Camera poses skimming the water: eye-plane-crossing triangles reach the
# giant pass with mesh 64 x 4 (SKIM64) and 32 x 4 (SKIM32).
SKIM64 = (np.array([20.0, 1.5, 55.0]), np.zeros(3))
SKIM32 = (np.array([20.0, 1.5, 45.0]), np.zeros(3))


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = ps.pallas_fields
    monkeypatch.setattr(ps, "pallas_fields",
                        lambda h0, om, t, cfg, interpret=False: orig(h0, om, t, cfg, True))


def _numpy_state(n: int, seed: int = 0):
    xi = np.random.default_rng(seed).standard_normal((2, n, n)).astype(np.float32)
    env = np.sqrt(phillips_spectrum(n, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    return xi * env, dispersion(n, 1000.0)


def _states(n: int, seed: int = 0):
    h0, om = _numpy_state(n, seed)
    return J.OceanState(h0=jnp.asarray(h0), omega=jnp.asarray(om)), state_from_numpy(h0, om, device="cpu")


def _disp64() -> np.ndarray:
    """The 64^2 displacement (t = 5 s) both rasterizers are fed."""
    jst, _ = _states(64)
    cfg = J.OceanConfig(resolution=64, compute_normals=False)
    return np.array(J.make_step(cfg)(jst, jnp.float32(5.0)).displacement)


def _cameras(pose=None):
    a, b = jcam.Camera(), tcam.Camera()
    if pose is not None:
        for c in (a, b):
            c.position, c.rotation = pose[0].copy(), pose[1].copy()
    return a, b


# --- mesh and camera: copies, exact ------------------------------------------

@pytest.mark.parametrize("res,patches", [(128, 4), (32, 1), (20, 3)])
def test_mesh_copy_equals_jax(res, patches):
    want, got = jmesh.build_grid(res, patches), tmesh.build_grid(res, patches)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(jmesh.instantiate(want), tmesh.instantiate(got)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_camera_copy_equals_jax():
    for aspect in (1200 / 700, 96 / 64, 1.0):
        assert np.array_equal(jcam.perspective(aspect), tcam.perspective(aspect))
    eye, center = np.array([1.0, 2.0, 3.0]), np.array([-4.0, 0.5, 9.0])
    assert np.array_equal(jcam.look_at(eye, center, np.array([0.0, 1.0, 0.0])),
                          tcam.look_at(eye, center, np.array([0.0, 1.0, 0.0])))
    a, b = _cameras(SKIM64)
    assert np.array_equal(a.view(), b.view()) and np.array_equal(a.view_dir(), b.view_dir())
    x, y = jcam.InputState(), tcam.InputState()
    for key in ("w", "left", "down", "a"):
        x.press(key)
        y.press(key)
    assert (x.forward, x.rot_x, x.rot_y) == (y.forward, y.rot_x, y.rot_y)
    x.touch("started", 800, 1000)
    y.touch("started", 800, 1000)
    assert (x.forward, x.rot_x, x.rot_y) == (y.forward, y.rot_x, y.rot_y)
    script = [(3, ["w", "left"]), (2, ["up", "s"]), (2, [])]
    for (i, ca), (j, cb) in zip(jcam.scripted_camera(script, dt=0.1),
                                tcam.scripted_camera(script, dt=0.1)):
        assert i == j and np.array_equal(ca.position, cb.position)
        assert np.array_equal(ca.rotation, cb.rotation) and np.array_equal(ca.view(), cb.view())


# --- shading -------------------------------------------------------------------

def _fragments(n_pix: int = 4000, seed: int = 1):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.2, 1.3, n_pix).astype(np.float32)
    v = rng.uniform(-0.2, 1.3, n_pix).astype(np.float32)
    world = np.stack([rng.uniform(0, 250, n_pix), rng.uniform(-12, 8, n_pix),
                      rng.uniform(0, 250, n_pix)], -1).astype(np.float32)
    return u, v, world


@pytest.mark.parametrize("channel", [0, 1])
def test_fragment_normals_match_jax(channel):
    disp = _disp64()
    u, v, _ = _fragments()
    want = np.asarray(jsh.fragment_normals(jnp.asarray(disp), jnp.asarray(u), jnp.asarray(v),
                                           channel=channel))
    got = tsh.fragment_normals(torch.from_numpy(disp), torch.from_numpy(u), torch.from_numpy(v),
                               channel=channel).numpy()
    assert np.abs(got - want).max() < SHADE_TOL


@pytest.mark.parametrize("foam,pbr", [(False, 0.0), (True, 0.0), (False, 0.35)],
                         ids=["stylized", "foam", "pbr"])
def test_shade_fragments_match_jax(foam, pbr):
    disp = _disp64()
    u, v, world = _fragments(seed=2)
    cam = np.array([-8.0, 32.0, 120.0], np.float32)
    mask = (np.random.default_rng(3).random((64, 64)) < 0.3).astype(np.float32) if foam else None
    want = np.asarray(jsh.shade_fragments(
        jnp.asarray(disp), jnp.asarray(u), jnp.asarray(v), jnp.asarray(world), jnp.asarray(cam),
        foam=None if mask is None else jnp.asarray(mask), pbr_roughness=pbr))
    got = tsh.shade_fragments(
        torch.from_numpy(disp), torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(world),
        torch.from_numpy(cam), foam=None if mask is None else torch.from_numpy(mask),
        pbr_roughness=pbr).numpy()
    assert got.shape == (u.size, 3) and np.abs(got - want).max() < SHADE_TOL


def test_samplers_and_brdf_helpers_match_jax():
    disp = _disp64()
    u, v, _ = _fragments(seed=4)
    want = np.asarray(jsh.sample_displacement(jnp.asarray(disp), jnp.asarray(u), jnp.asarray(v)))
    got = tsh.sample_displacement(torch.from_numpy(disp), torch.from_numpy(u),
                                  torch.from_numpy(v)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    mask = disp[..., 1] / np.abs(disp[..., 1]).max()
    want_m = np.asarray(jsh.sample_mask_bilinear(jnp.asarray(mask), jnp.asarray(u), jnp.asarray(v)))
    got_m = tsh.sample_mask_bilinear(torch.from_numpy(mask), torch.from_numpy(u),
                                     torch.from_numpy(v)).numpy()
    assert np.abs(got_m - want_m).max() < 1e-6
    x = np.linspace(0.01, 1.0, 50, dtype=np.float32)
    for fj, ft in ((lambda a: jsh.d_ggx(np.float32(0.4), a), lambda a: tsh.d_ggx(0.4, a)),
                   (lambda a: jsh.g_schlick(a, a[::-1], np.float32(0.4)),
                    lambda a: tsh.g_schlick(a, a.flip(0), 0.4))):
        np.testing.assert_allclose(ft(torch.from_numpy(x)).numpy(), np.asarray(fj(jnp.asarray(x))),
                                   rtol=1e-6)


# --- whole frames --------------------------------------------------------------

def _render_pair(disp, pose=None, width=96, height=64, mesh=64, **kwargs):
    a_cam, b_cam = _cameras(pose)
    jfoam = kwargs.pop("foam", None)
    kwargs.setdefault("pool", POOL)
    want, wz = jr.render_frame(jnp.asarray(disp), a_cam, width=width, height=height,
                               mesh_resolution=mesh, return_depth=True,
                               foam=None if jfoam is None else jnp.asarray(jfoam), **kwargs)
    got, gz = tr.render_frame(torch.from_numpy(disp), b_cam, width=width, height=height,
                              mesh_resolution=mesh, return_depth=True,
                              foam=None if jfoam is None else torch.from_numpy(jfoam), **kwargs)
    return np.asarray(want), np.asarray(wz), got.numpy(), gz.numpy()


@pytest.mark.parametrize("pose", [None, SKIM64], ids=["default", "skimming"])
def test_render_frame_matches_jax(pose):
    """96x64 frames over mesh 64 x 4; the skimming pose puts
    eye-plane-crossing triangles through the giant pass."""
    disp = _disp64()
    if pose is not None:
        assert tr._giant_selection(_port_tables(disp, pose).score, 512)[2] > 0
    want, wz, got, gz = _render_pair(disp, pose)
    cov = np.isfinite(gz)
    assert got.shape == (64, 96, 3) and np.array_equal(cov, np.isfinite(wz))
    assert 0.2 < cov.mean() < 1.0
    assert np.abs(gz[cov] - wz[cov]).max() <= Z_TOL
    assert np.abs(got - want).max() <= COLOR_TOL


@pytest.mark.parametrize("kwargs", [dict(frag_normal_x=True), dict(pbr_roughness=0.5),
                                    dict(height_div=2.0, horiz_div=3.0, normal_height_scale=90.0),
                                    dict(foam="mask")],
                         ids=["q8", "pbr", "visual-scales", "foam"])
def test_render_frame_options_match_jax(kwargs):
    disp = _disp64()
    if kwargs.get("foam") == "mask":
        kwargs = dict(foam=(np.random.default_rng(5).random((64, 64)) < 0.2).astype(np.float32))
    want, wz, got, gz = _render_pair(disp, mesh=32, **kwargs)
    assert np.array_equal(np.isfinite(gz), np.isfinite(wz))
    assert np.abs(got - want).max() <= COLOR_TOL


def _port_tables(disp, pose, width=96, height=64, mesh=64, patches=4):
    _, cam = _cameras(pose)
    dev = torch.device("cpu")
    positions, uvs, tris = tr._mesh_constants(mesh, patches, dev)
    return tr._slot_tables(torch.from_numpy(disp), positions, uvs, tris,
                           tr._view_proj(cam, width, height, dev), width, height, POOL,
                           tr._interp_matrices(mesh, 64, dev), (patches, mesh))


@pytest.mark.parametrize("pose", [None, SKIM32], ids=["default", "skimming"])
def test_band_stack_equals_full_frame(pose):
    """Four bands (``y_origin`` / ``full_height``) stack to the full frame
    bit for bit: color and depth."""
    if pose is not None:
        tabs = _port_tables(_disp64(), pose, width=80, height=48, mesh=32)
        assert tr._giant_selection(tabs.score, 64)[2] > 0
    disp = torch.from_numpy(_disp64())
    _, cam = _cameras(pose)
    dev = torch.device("cpu")
    res, patches, w, h = 32, 4, 80, 48
    positions, uvs, tris = tr._mesh_constants(res, patches, dev)
    interp = tr._interp_matrices(res, 64, dev)
    args = (disp, positions, uvs, tris, tr._view_proj(cam, w, h, dev),
            torch.tensor(cam.position.astype(np.float32)))
    full, fz = tr._rasterize_pool(*args, w, h, POOL, 64, interp, (patches, res))
    bh = h // 4
    bands = [tr._rasterize_pool(*args, w, bh, POOL // 2, 64, interp, (patches, res),
                                y_origin=k * bh, full_height=h)
             for k in range(4)]
    assert torch.equal(torch.cat([b[0] for b in bands]), full)
    assert torch.equal(torch.cat([b[1] for b in bands]), fz)


def test_pool_overflow_matches_jax():
    disp = _disp64()
    positions, uvs, tris = jmesh.instantiate(jmesh.build_grid(128, 4))
    vp = (jcam.perspective(480 / 280) @ jcam.Camera().view()).astype(np.float32)
    for kw in (dict(), dict(pool=4096), dict(y_origin=70, full_height=280, bands=4)):
        h = 70 if "bands" in kw else 280
        want = jr.pool_overflow(jnp.asarray(disp), positions, uvs, tris.astype(np.int32), vp,
                                480, h, return_demand=True, **kw)
        got = tr.pool_overflow(torch.from_numpy(disp), positions, uvs, tris, vp, 480, h,
                               return_demand=True, **kw)
        assert got == want, (kw, got, want)


def test_giant_drop_tripwire():
    """``with_diag``: 0 with the default pool, positive when a starved pool
    and one giant slot lose coverage (and the image changes)."""
    disp = torch.from_numpy(_disp64())
    dev = torch.device("cpu")
    _, cam = _cameras()
    w, h = 96, 64
    positions, uvs, tris = tr._mesh_constants(32, 4, dev)
    args = (disp, positions, uvs, tris, tr._view_proj(cam, w, h, dev),
            torch.tensor(cam.position.astype(np.float32)))
    common = dict(interp=tr._interp_matrices(32, 64, dev), grid_shape=(4, 32), with_diag=True)
    img_ok, _, drop_ok = tr._rasterize_pool(*args, w, h, pool=POOL, giants=512, **common)
    img_bad, _, drop_bad = tr._rasterize_pool(*args, w, h, pool=64, giants=1, **common)
    assert int(drop_ok) == 0 and int(drop_bad) > 0
    assert not torch.equal(img_ok, img_bad)


# --- the fused pipeline -----------------------------------------------------------

def _srgb_np(img) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)


def test_frame_renderer_equals_step_then_render(interpret_pallas):
    """make_frame_renderer == step -> render_frame -> sRGB (the bound of
    tests/test_render.py:502-525), and against the JAX fused renderer."""
    jst, tst = _states(64)
    kw = dict(resolution=64, fft_impl="pallas", mesh_resolution=32, num_patches=4)
    jc, tc = J.OceanConfig(**kw), T.OceanConfig(**kw)
    _, cam = _cameras()
    vp = (tcam.perspective(96 / 64) @ cam.view()).astype(np.float32)
    cp = cam.position.astype(np.float32)
    got, dropped = tr.make_frame_renderer(tc, width=96, height=64, pool=POOL, diag=True)(
        tst, 5.0, vp, cp)
    assert got.dtype == torch.uint8 and got.shape == (64, 96, 3) and int(dropped) == 0
    disp = T.make_step(tc)(tst, 5.0).displacement
    want = tr.srgb8(tr.render_frame(disp, cam, width=96, height=64, mesh_resolution=32,
                                    pool=POOL))
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert float((diff > 1).float().mean()) < 1e-3
    jax_frame = np.asarray(jr.make_frame_renderer(jc, width=96, height=64, pool=POOL)(
        jst, jnp.float32(5.0), jnp.asarray(vp), jnp.asarray(cp)))
    jdiff = np.abs(got.numpy().astype(np.int32) - jax_frame.astype(np.int32))
    assert (jdiff > 1).mean() < 1e-3


def test_batch_renderer_and_render_frames_equal_single_frames():
    _, tst = _states(64, seed=1)
    tc = T.OceanConfig(resolution=64, fft_impl="pallas", mesh_resolution=32, num_patches=4)
    cams = [c for _, c in tcam.scripted_camera([(2, ["w"])], dt=0.1)]
    vps = np.stack([(tcam.perspective(80 / 48) @ c.view()).astype(np.float32) for c in cams])
    cps = np.stack([c.position.astype(np.float32) for c in cams])
    ts = [0.5, 1.5]
    strip = tr.make_batch_renderer(tc, 80, 48, pool=POOL)(tst, ts, vps, cps)
    one = tr.make_frame_renderer(tc, 80, 48, pool=POOL)
    assert strip.shape == (2, 48, 80, 3)
    for i in range(2):
        assert torch.equal(strip[i], one(tst, ts[i], vps[i], cps[i]))
    disps = T.make_rollout(dataclasses.replace(tc, compute_normals=False))(tst, ts).displacement
    frames = tr.render_frames(disps, cams, width=80, height=48, mesh_resolution=32, pool=POOL)
    for i in range(2):
        assert torch.equal(frames[i], tr.render_frame(disps[i], cams[i], width=80, height=48,
                                                      mesh_resolution=32, pool=POOL))


def test_unported_render_paths_raise():
    disp = torch.zeros(16, 16, 3)
    # the window rasterizer is ported (tests/test_torch_window.py): a flat
    # sea renders as the pool path renders it
    window, wz = tr.render_frame(disp, tcam.Camera(), 96, 64, mesh_resolution=64,
                                 impl="window", return_depth=True)
    pool, pz = tr.render_frame(disp, tcam.Camera(), 96, 64, mesh_resolution=64,
                               return_depth=True, pool=POOL)
    assert window.shape == (64, 96, 3) and torch.isfinite(wz).float().mean() > 0.2
    assert torch.equal(torch.isfinite(wz), torch.isfinite(pz))
    assert (window - pool).abs().max() <= COLOR_TOL
    # cascade stacks are ported (tests/test_torch_cascades.py); a stack
    # without its domains raises as the JAX package's does
    with pytest.raises(ValueError, match="cascade_domains"):
        tr.render_frame(torch.zeros(2, 16, 16, 3), tcam.Camera(), 32, 32, mesh_resolution=16)
    assert callable(tr.make_frame_renderer(T.OceanConfig(resolution=16, num_cascades=2), 32, 32))
    with pytest.raises(ValueError, match="impl must be"):
        tr.render_frame(disp, tcam.Camera(), 32, 32, mesh_resolution=16, impl="splat")


# --- the stored 1200x700 JAX frame ------------------------------------------------

FRAME_W, FRAME_H, FRAME_N, FRAME_SEED, FRAME_T = 1200, 700, 512, 0, 11.25


def _frame_view(w: int, h: int):
    cam = tcam.Camera()
    return ((tcam.perspective(w / h) @ cam.view()).astype(np.float32),
            cam.position.astype(np.float32))


def test_port_frame_matches_stored_jax_frame():
    """The port's plain path at 1200x700 (K1, K7, K8 plain; 512^2 state from
    the numpy noise of seed 0, rebuilt by ``synthesize(noise=...)`` as
    ``chip_smoke.py`` does on the card) against the frame the JAX package
    rendered, under the envelope of tests/test_render.py:259-264."""
    stored = np.load(STORED)
    want = stored["frame"]
    assert (int(stored["seed"]), float(stored["t"]), int(stored["resolution"])) == (
        FRAME_SEED, FRAME_T, FRAME_N)
    noise = np.random.default_rng(FRAME_SEED).standard_normal((2, FRAME_N, FRAME_N))
    h0, omega = synthesize(FRAME_N, 1000.0, T.PhillipsConfig(),
                           noise=torch.from_numpy(noise.astype(np.float32)))
    assert np.array_equal(h0.numpy(), _numpy_state(FRAME_N, FRAME_SEED)[0])
    vp, cp = _frame_view(FRAME_W, FRAME_H)
    fr = tr.make_frame_renderer(T.OceanConfig(fft_impl="pallas"), FRAME_W, FRAME_H, diag=True)
    got, dropped = fr(T.OceanState(h0, omega), FRAME_T, vp, cp)
    assert int(dropped) == 0 and got.shape == want.shape == (FRAME_H, FRAME_W, 3)
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert (diff > 2).mean() < 1e-3, f"{(diff > 2).mean():.2e} pixels off"
    assert np.abs(got.numpy().reshape(-1, 3).mean(0) - want.reshape(-1, 3).mean(0)).max() < 0.5


def write_stored_frame(path: Path = STORED) -> None:
    """Render the 1200x700 frame with the JAX package on the CPU and store
    it with what made it: the default camera, t, the seed of the numpy
    noise, the mesh and the repository commit."""
    orig = ps.pallas_fields
    ps.pallas_fields = lambda h0, om, t, cfg, interpret=False: orig(h0, om, t, cfg, True)
    try:
        jst, _ = _states(FRAME_N, FRAME_SEED)
        vp, cp = _frame_view(FRAME_W, FRAME_H)
        cfg = J.OceanConfig(fft_impl="pallas")
        frame = np.asarray(jr.make_frame_renderer(cfg, FRAME_W, FRAME_H)(
            jst, jnp.float32(FRAME_T), jnp.asarray(vp), jnp.asarray(cp)))
    finally:
        ps.pallas_fields = orig
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                            text=True, check=True).stdout.strip()
    np.savez_compressed(
        path, frame=frame, seed=FRAME_SEED, t=FRAME_T, resolution=FRAME_N,
        domain_size=cfg.domain_size, width=FRAME_W, height=FRAME_H,
        camera_position=np.asarray(tcam.DEFAULT_POSITION), camera_rotation=np.asarray(
            tcam.DEFAULT_ROTATION), mesh=np.asarray([cfg.mesh_resolution, cfg.num_patches]),
        config='OceanConfig(fft_impl="pallas")', jax_commit=commit,
        state="h0 = standard_normal((2, N, N), default_rng(seed)) * sqrt(phillips / 2); "
              "omega = dispersion(N, 1000)")
    print(f"wrote {path} ({path.stat().st_size} bytes), JAX package at {commit}")


if __name__ == "__main__":
    sys.exit(write_stored_frame())
