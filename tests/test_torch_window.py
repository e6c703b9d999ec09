"""The window rasterizer (``render_frame(impl="window")``, ``_rasterize``)
and meshes other than the standard grid (``grid_shape=None``) of
``gfx_ocean_tpu_torch.render.raster`` against the JAX package's, and the
port's pool rasterizer against its window rasterizer.

Every frame renders the same numpy displacement on both sides: the
``disp64`` state of ``tests/test_render.py:366-371`` (the shipped or
generated 512^2 bins cropped to 64^2, the JAX step at t = 5 s). The port's
tensors lie on the CPU, so K7 and K8 take their plain versions. Bounds are
those of ``tests/test_render.py:389-399`` (coverage equal, depth to 2e-6,
color to 1e-4) and of its near-tie envelope (``:943-978``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
from gfx_ocean_tpu.models.ocean import downsample_state
from gfx_ocean_tpu.render import camera as jcam
from gfx_ocean_tpu.render import mesh as jmesh
from gfx_ocean_tpu.render import raster as jr

from gfx_ocean_tpu_torch.render import camera as tcam
from gfx_ocean_tpu_torch.render import raster as tr
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum

Z_TOL, COLOR_TOL = 2e-6, 1e-4
# sRGB frames with foam: the stored frame's envelope (tests/test_torch_render.py).
FRAME_OFF, FRAME_MEAN_COLOR = 1e-3, 0.5
SAMPLES = 16
# A camera skimming the water: eye-plane-crossing triangles reach the giant
# pass with mesh 64 x 4 (tests/test_torch_render.py SKIM64).
SKIM64 = (np.array([20.0, 1.5, 55.0]), np.zeros(3))
DOMAINS = (1000.0, 250.0, 62.5)


@pytest.fixture(scope="module")
def disp64() -> np.ndarray:
    state = downsample_state(J.ocean_state_from_assets(), 64)
    cfg = J.OceanConfig(resolution=64, compute_normals=False)
    return np.array(J.make_step(cfg)(state, jnp.float32(5.0)).displacement)


def _cameras(pose=None):
    a, b = jcam.Camera(), tcam.Camera()
    if pose is not None:
        for c in (a, b):
            c.position, c.rotation = pose[0].copy(), pose[1].copy()
    return a, b


def _assert_frames_close(got, gz, want, wz):
    cov = np.isfinite(gz)
    assert np.array_equal(cov, np.isfinite(wz))
    assert 0.05 < cov.mean() < 1.0
    assert np.abs(gz[cov] - wz[cov]).max() <= Z_TOL
    assert np.abs(got - want).max() <= COLOR_TOL


@pytest.mark.parametrize("pose", [None, SKIM64], ids=["default", "skimming"])
def test_window_frame_matches_jax_and_pool(disp64, pose):
    """96x64 over mesh 64 x 4 at 16^2 samples: the port's window frame
    against JAX ``render_frame(impl="window")``, and the port's pool frame
    against its window frame; the skimming pose fills the giant pass."""
    jc, tc = _cameras(pose)
    kw = dict(width=96, height=64, mesh_resolution=64, samples=SAMPLES, return_depth=True)
    want, wz = jr.render_frame(jnp.asarray(disp64), jc, impl="window", **kw)
    got, gz = tr.render_frame(torch.from_numpy(disp64), tc, impl="window", **kw)
    assert got.shape == (64, 96, 3) and got.dtype == torch.float32
    _assert_frames_close(got.numpy(), gz.numpy(), np.asarray(want), np.asarray(wz))
    pool, pz = tr.render_frame(torch.from_numpy(disp64), tc, impl="pool", pool=1 << 16, **kw)
    _assert_frames_close(pool.numpy(), pz.numpy(), got.numpy(), gz.numpy())
    if pose is not None:
        dev = torch.device("cpu")
        positions, uvs, tris = tr._mesh_constants(64, 4, dev)
        _, clip = tr._vertex_stage(torch.from_numpy(disp64), positions, uvs,
                                   tr._view_proj(tc, 96, 64, dev))
        score = tr._window_score(clip[tris], 96, 64, SAMPLES * SAMPLES)
        assert bool((score > 0).any())


def test_pool_window_near_tie_envelope(disp64):
    """tests/test_render.py::test_pool_window_near_tie_bound on the port's
    two rasterizers: 800x448, 48^2 samples and 2048 giants. That test's mesh
    32 x 1 lies outside the default camera's view (its frames are all clear
    colour); mesh 32 x 4 puts the patches in view."""
    w, h = 800, 448
    cam = tcam.Camera()
    disp = torch.from_numpy(disp64)
    kw = dict(width=w, height=h, mesh_resolution=32, num_patches=4, giants=2048,
              return_depth=True)
    a, za = tr.render_frame(disp, cam, impl="pool", **kw)
    b, zb = tr.render_frame(disp, cam, impl="window", samples=48, **kw)
    a, za, b, zb = a.numpy(), za.numpy(), b.numpy(), zb.numpy()
    d = np.argwhere((a != b).any(-1))
    assert len(d) <= 64, f"{len(d)} pool/window diffs at {w}x{h}"
    quantum = 2.0 / (1 << (32 - tr._id_bits(2 * 31 * 31 * 4)))
    one_sided = 0
    for y, x in d:
        if np.isinf(za[y, x]) != np.isinf(zb[y, x]):
            one_sided += 1
        else:
            assert abs(za[y, x] - zb[y, x]) <= 2 * quantum
    assert one_sided <= 8
    assert 0.02 < np.isfinite(zb).mean() < 1.0


def test_window_cascade_stack_with_foam():
    """A 3-cascade stack with per-cascade foam through the window
    rasterizer, against JAX's, and the pool frame of the port."""
    n = 64
    xi = np.random.default_rng(6).standard_normal((3, 2, n, n)).astype(np.float32)
    env = np.stack([np.sqrt(phillips_spectrum(n, d, T.PhillipsConfig()) / 2.0)
                    for d in DOMAINS]).astype(np.float32)
    h0 = xi * env[:, None]
    jc = J.OceanConfig(resolution=n, num_cascades=3, compute_normals=False, compute_foam=True,
                       foam_threshold=0.9, foam_lambda=1.5)
    omega = np.stack([dispersion(n, d) for d in DOMAINS]).astype(np.float32)
    out = J.make_step(jc)(J.OceanState(h0=jnp.asarray(h0), omega=jnp.asarray(omega)),
                          jnp.float32(4.0))
    disp, foam = np.array(out.displacement), np.array(out.foam)
    assert 0 < foam.sum() < foam.size
    cam_j, cam_t = _cameras()
    kw = dict(width=96, height=64, mesh_resolution=64, samples=SAMPLES, return_depth=True)
    want, wz = jr.render_frame(jnp.asarray(disp), cam_j, foam=jnp.asarray(foam),
                               cascade_domains=DOMAINS, impl="window", **kw)
    got, gz = tr.render_frame(torch.from_numpy(disp), cam_t, foam=torch.from_numpy(foam),
                              cascade_domains=DOMAINS, impl="window", **kw)
    want, wz, gz = np.array(want), np.asarray(wz), gz.numpy()
    cov = np.isfinite(gz)
    assert np.array_equal(cov, np.isfinite(wz)) and 0.05 < cov.mean() < 1.0
    # Depth to the ulp but for quantized-z near-ties, whose winners the two
    # packages' float32 z (XLA contracts into FMAs) may order differently:
    # within two quanta of _pack_key (measured: 1 pixel of 2,880, 5.6e-6).
    dz = np.abs(gz[cov] - wz[cov])
    quantum = 2.0 / (1 << (32 - tr._id_bits(2 * 63 * 63 * 4)))
    assert (dz > Z_TOL).mean() < FRAME_OFF and dz.max() <= 2 * quantum
    diff = np.abs(tr.srgb8(got).numpy().astype(np.int32)
                  - tr.srgb8(torch.from_numpy(want)).numpy().astype(np.int32))
    assert (diff > 2).mean() < FRAME_OFF
    assert np.abs(diff.reshape(-1, 3).mean(0)).max() < FRAME_MEAN_COLOR
    pool, pz = tr.render_frame(torch.from_numpy(disp), cam_t, foam=torch.from_numpy(foam),
                               cascade_domains=DOMAINS, impl="pool", pool=1 << 16, **kw)
    assert np.array_equal(np.isfinite(pz.numpy()), cov)
    assert np.abs(pz.numpy()[cov] - gz[cov]).max() <= Z_TOL


def test_render_frames_window(disp64):
    """render_frames(impl="window") equals render_frame a frame, bit for
    bit, and JAX's render_frames(impl="window") (one vmapped program) in
    the stored frame's sRGB envelope."""
    cams = [c for _, c in tcam.scripted_camera([(2, ["w", "left"])], dt=0.2)]
    jcams = [c for _, c in jcam.scripted_camera([(2, ["w", "left"])], dt=0.2)]
    disps = np.stack([disp64, disp64[::-1].copy()])
    kw = dict(width=80, height=48, mesh_resolution=32, samples=SAMPLES)
    frames = tr.render_frames(torch.from_numpy(disps), cams, impl="window", **kw)
    want = np.asarray(jr.render_frames(jnp.asarray(disps), jcams, impl="window", **kw))
    assert frames.shape == (2, 48, 80, 3)
    for i in range(2):
        assert torch.equal(frames[i], tr.render_frame(torch.from_numpy(disps[i]), cams[i],
                                                      impl="window", **kw))
        diff = np.abs(tr.srgb8(frames[i]).numpy().astype(np.int32)
                      - tr.srgb8(torch.from_numpy(want[i])).numpy().astype(np.int32))
        assert (diff > 2).mean() < FRAME_OFF and diff.max() <= 2


def _generic_args(disp64, mesh: int, width: int, height: int, perm=None):
    """Both packages' rasterizer arguments for the standard grid mesh given as
    a plain (T, 3) triangle list, its triangles in ``perm`` order."""
    jcam_, tcam_ = _cameras()
    positions, uvs, tris = jmesh.instantiate(jmesh.build_grid(mesh, 4))
    tris = tris.astype(np.int64) if perm is None else tris.astype(np.int64)[perm]
    vp = (jcam.perspective(width / height) @ jcam_.view()).astype(np.float32)
    cp = jcam_.position.astype(np.float32)
    jargs = (jnp.asarray(disp64), jnp.asarray(positions), jnp.asarray(uvs),
             jnp.asarray(tris.astype(np.int32)), jnp.asarray(vp), jnp.asarray(cp))
    targs = tuple(torch.from_numpy(np.ascontiguousarray(a))
                  for a in (disp64, positions, uvs, tris, vp, cp))
    return jargs, targs


@pytest.mark.parametrize("impl", ["pool", "window"])
def test_generic_mesh_matches_jax_and_grid_path(disp64, impl):
    """grid_shape=None: a permuted triangle list against the JAX package's
    ``_rasterize_pool`` / ``_rasterize`` on the same list, and the
    unpermuted list bit-equal to the port's grid path."""
    w, h, mesh = 96, 64, 64
    t_count = 2 * (mesh - 1) ** 2 * 4
    perm = np.random.default_rng(7).permutation(t_count)
    extra = (1 << 15, 512) if impl == "pool" else (SAMPLES, 512)
    jfn = jr._rasterize_pool if impl == "pool" else jr._rasterize
    tfn = tr._rasterize_pool if impl == "pool" else tr._rasterize
    jargs, targs = _generic_args(disp64, mesh, w, h, perm)
    want, wz = jfn(*jargs, w, h, *extra, jr._interp_matrices(mesh, 64), None)
    got, gz = tfn(*targs, w, h, *extra, tr._interp_matrices(mesh, 64, torch.device("cpu")), None)
    _assert_frames_close(got.numpy(), gz.numpy(), np.asarray(want), np.asarray(wz))
    _, targs = _generic_args(disp64, mesh, w, h)
    interp = tr._interp_matrices(mesh, 64, torch.device("cpu"))
    listed = tfn(*targs, w, h, *extra, interp, None)
    grid = tfn(*targs, w, h, *extra, interp, (4, mesh))
    assert torch.equal(listed[0], grid[0]) and torch.equal(listed[1], grid[1])
