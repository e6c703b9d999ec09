"""The port's frame server (``gfx_ocean_tpu_torch.serve``) on the CPU:
routes, payloads, status codes, the dispatch lock, and agreement with the
JAX package's ``FrameService`` and with the port's own renderer.

Every test of ``tests/test_serve.py`` has its counterpart here, the mesh
test on a mesh of four positions on the host. PNGs come from the port's
standard-library writer and are decoded with Pillow.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import io
import json
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

Image = pytest.importorskip("PIL.Image", reason="the tests decode PNG and JPEG with Pillow")

import gfx_ocean_tpu as J  # noqa: E402
import gfx_ocean_tpu_torch as T  # noqa: E402
from gfx_ocean_tpu.serve import FrameService as JFrameService  # noqa: E402
from gfx_ocean_tpu_torch import serve as serve_mod  # noqa: E402
from gfx_ocean_tpu_torch.models.ocean import downsample_state  # noqa: E402
from gfx_ocean_tpu_torch.render import raster as raster_mod  # noqa: E402
from gfx_ocean_tpu_torch.render.camera import Camera, perspective  # noqa: E402
from gfx_ocean_tpu_torch.serve import CameraSession, serve  # noqa: E402
from gfx_ocean_tpu_torch.utils.png import encode_png  # noqa: E402

CFG = dict(resolution=64, compute_normals=True, matmul_precision="highest")


def _state():
    return downsample_state(T.ocean_state_from_assets(device="cpu"), 64)


def _start(state, cfg):
    srv = serve(state, cfg, host="127.0.0.1", port=0)  # ephemeral port
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}", srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def server():
    base, srv = _start(_state(), T.OceanConfig(**CFG))
    yield base, srv
    _stop(srv)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def _png(body) -> np.ndarray:
    with Image.open(io.BytesIO(body)) as im:
        assert im.mode == "RGB"
        return np.asarray(im)


def _direct_frame(srv, t, w, h, camera=None):
    """The port's frame renderer on the served state, outside the server."""
    camera = camera or Camera()
    fn = raster_mod.make_frame_renderer(srv.service.config, width=w, height=h)
    vp = (perspective(w / h) @ camera.view()).astype(np.float32)
    return fn(srv.service.state, t, vp, camera.position.astype(np.float32)).numpy()


def test_health_and_config(server):
    base, _ = server
    code, body, ctype = _get(base + "/health")
    assert code == 200 and json.loads(body) == {"status": "ok", "device": "cpu"}
    code, body, _ = _get(base + "/config")
    assert json.loads(body)["resolution"] == 64
    assert json.loads(body) == dataclasses.asdict(J.OceanConfig(**CFG))  # the JAX config


def test_frame_npz(server):
    base, srv = server
    code, body, ctype = _get(base + "/frame?t=2.5")
    assert code == 200 and ctype == "application/octet-stream"
    with np.load(io.BytesIO(body)) as z:
        assert z["displacement"].shape == (64, 64, 3)
        assert z["normals"].shape == (64, 64, 3)
        assert float(z["t"]) == 2.5
        assert np.isfinite(z["displacement"]).all()
    _, body2, _ = _get(base + "/frame?t=2.5")
    with np.load(io.BytesIO(body)) as a, np.load(io.BytesIO(body2)) as b:
        assert np.array_equal(a["displacement"], b["displacement"])


@pytest.mark.parametrize("t", [2.5, 11.25])
def test_frame_npz_equals_jax_frame_service(server, t):
    """``/frame?t=`` against the JAX ``FrameService.fields(t)`` on the same
    numpy state at "highest": 1e-6 of the displacement's scale, 1e-5 on
    the unit normals."""
    base, srv = server
    jstate = J.OceanState(h0=jnp.asarray(srv.service.state.h0.numpy()),
                          omega=jnp.asarray(srv.service.state.omega.numpy()))
    want = JFrameService(jstate, J.OceanConfig(**CFG)).fields(t)
    with np.load(io.BytesIO(_get(base + f"/frame?t={t}")[1])) as z:
        d, w = z["displacement"], want["displacement"]
        assert np.abs(d - w).max() <= 1e-6 * np.abs(w).max()
        assert np.abs(z["normals"] - want["normals"]).max() <= 1e-5


def test_frame_png(server):
    base, srv = server
    code, body, ctype = _get(base + "/frame.png?t=1.0&w=64&h=48&samples=8")
    assert code == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.array_equal(_png(body), _direct_frame(srv, 1.0, 64, 48))


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (48, 64)])
def test_png_writer_round_trips_through_pillow(shape):
    rgb = np.random.default_rng(shape[1]).integers(0, 256, shape + (3,), dtype=np.uint8)
    body = encode_png(rgb)
    assert np.array_equal(_png(body), rgb)
    assert encode_png(rgb) == body  # a function of the pixels alone
    with pytest.raises(ValueError, match="uint8"):
        encode_png(rgb.astype(np.float32))


def test_metrics_progress(server):
    base, srv = server
    before = json.loads(_get(base + "/metrics")[1])["frames_served"]
    _get(base + "/frame?t=9.0")
    after = json.loads(_get(base + "/metrics")[1])
    assert after["frames_served"] == before + 1
    assert after["latency_ema_sec"] > 0 and after["device"] == "cpu"
    _get(base + "/frame.png?t=9.0&w=64&h=48")
    m = json.loads(_get(base + "/metrics")[1])
    assert m["last_render_sec"] > 0 and m["last_encode_sec"] > 0 and m["mesh"] is None


def test_viewer_page(server):
    base, _ = server
    code, body, ctype = _get(base + "/")
    assert code == 200 and ctype == "text/html"
    assert b"/session/strip.jpg" in body and b"/session/input" in body
    assert b"TPU" not in body and b"tunnel" not in body


def test_session_frame_jpg(server):
    base, _ = server
    code, body, ctype = _get(base + "/session/frame.jpg?w=64&h=48")
    assert code == 200 and ctype == "image/jpeg"
    assert body[:2] == b"\xff\xd8"


def test_session_strip_jpg(server):
    """The strip renders n frames in one call, stacked vertically, and ticks
    the session clock by the full dt."""
    base, srv = server
    t_before = srv.service.session.state()["sim_time"]
    served_before = json.loads(_get(base + "/metrics")[1])["frames_served"]
    code, body, ctype = _get(base + "/session/strip.jpg?w=64&h=48&n=3&dt=0.06")
    assert code == 200 and ctype == "image/jpeg"
    assert Image.open(io.BytesIO(body)).size == (64, 48 * 3)
    assert srv.service.session.state()["sim_time"] == pytest.approx(t_before + 0.06, abs=1e-6)
    assert json.loads(_get(base + "/metrics")[1])["frames_served"] == served_before + 3
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(base + "/session/strip.jpg?w=64&h=48&n=50")
    assert exc.value.code == 400


def test_strip_frames_equal_batch_renderer(server):
    """The strip's frames before the encoder: the batch renderer's frames."""
    _, srv = server
    cams = [Camera() for _ in range(3)]
    cams[1].position = cams[1].position + np.array([5.0, 2.0, -3.0])
    times = [0.5, 0.75, 1.0]
    got = srv.service.strip_frames(times, cams, 64, 48)
    proj = perspective(64 / 48)
    want = raster_mod.make_batch_renderer(srv.service.config, 64, 48)(
        srv.service.state, torch.tensor(times),
        torch.from_numpy(np.stack([(proj @ c.view()).astype(np.float32) for c in cams])),
        torch.from_numpy(np.stack([c.position.astype(np.float32) for c in cams])))
    assert got.shape == (3, 48, 64, 3) and np.array_equal(got, want.numpy())


def test_advance_batch_matches_single_ticks():
    """n strip sub-ticks integrate held keys exactly as n single ``advance``
    calls with dt/n (same trajectory, src/lib.rs:139-148)."""
    a, b = CameraSession(), CameraSession()
    for s in (a, b):
        s.input("press", "w")
        s.input("press", "left")
    ticks = a.advance_batch(4, dt=0.2)
    singles = [b.advance(0.05) for _ in range(4)]
    assert len(ticks) == 4
    for (ta, ca), (tb, cb) in zip(ticks, singles):
        assert ta == pytest.approx(tb)
        np.testing.assert_allclose(ca.position, cb.position, rtol=1e-6)
        np.testing.assert_allclose(ca.rotation, cb.rotation, rtol=1e-6)


def test_frame_jpg_stateless(server):
    base, _ = server
    code, body, ctype = _get(base + "/frame.jpg?t=1.5&w=64&h=48")
    assert code == 200 and ctype == "image/jpeg" and len(body) > 500
    assert _get(base + "/frame.jpg?t=1.5&w=64&h=48")[1] == body


def test_frame_png_pose_override(server):
    base, srv = server
    code, body, _ = _get(base + "/frame.png?t=1&w=64&h=48&samples=8"
                                "&px=0&py=60&pz=200&rx=-0.8&ry=0")
    assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    cam = Camera()
    cam.position = np.array([0.0, 60.0, 200.0])
    cam.rotation = np.array([-0.8, 0.0, 0.0])
    assert np.array_equal(_png(body), _direct_frame(srv, 1.0, 64, 48, cam))


def test_session_loop_reference_semantics(server):
    """The server-side session applies src/camera.rs math exactly."""
    base, srv = server
    prior = srv.service.session
    srv.service.session = CameraSession()
    try:
        st = json.loads(_get(base + "/session/state")[1])
        assert st["position"] == [-8.0, 32.0, 120.0]      # src/lib.rs:74-77
        assert st["rotation"] == [-0.6, -1.5, 0.0]

        _get(base + "/session/input?press=w")
        code, body, ctype = _get(base + "/session/frame.png?dt=0.1&w=32&h=32&samples=4")
        assert code == 200 and ctype == "image/png"
        want = Camera()
        want.input.forward = 1.0
        want.update(0.1)
        st = json.loads(_get(base + "/session/state")[1])
        np.testing.assert_allclose(st["position"], want.position, atol=1e-3)
        assert st["sim_time"] == 0.1

        _get(base + "/session/input?release=w")
        _get(base + "/session/input?press=left")
        _get(base + "/session/frame.png?dt=0.05&w=32&h=32&samples=4")
        st2 = json.loads(_get(base + "/session/state")[1])
        np.testing.assert_allclose(st2["rotation"][1], st["rotation"][1] + 0.1, atol=1e-6)
        assert st2["position"] == st["position"]

        _get(base + "/session/input?release=left")
        _get(base + "/session/input?touch=started&x=10&width=100")
        assert json.loads(_get(base + "/session/state")[1])["input"]["rot_y"] == 1.0
        _get(base + "/session/input?touch=ended")
        assert json.loads(_get(base + "/session/state")[1])["input"]["rot_y"] == 0.0

        _get(base + "/session/input?press=a")  # A/D are ignored (SURVEY.md Q7)
        assert json.loads(_get(base + "/session/state")[1])["input"] == {
            "forward": 0.0, "rot_x": 0.0, "rot_y": 0.0}
    finally:
        srv.service.session = prior


def test_error_paths(server):
    base, srv = server
    errors = srv.service.metrics()["errors"]
    for path, code in (("/frame?t=notanumber", 400), ("/frame.png?t=1&w=99999", 400),
                       ("/session/input", 400), ("/session/input?press=w&x=1", 200),
                       ("/session/strip.jpg?w=1281&h=720&n=2", 400), ("/nope", 404)):
        if code == 200:
            assert _get(base + path)[0] == 200
            continue
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + path)
        assert e.value.code == code
    _get(base + "/session/input?release=w")
    assert srv.service.metrics()["errors"] == errors + 4  # 404 is not an error


def test_jpeg_without_pillow_is_a_500_naming_pillow(server, monkeypatch):
    """Without Pillow, JPEG routes fail visibly; PNG needs no image library."""
    base, _ = server
    monkeypatch.setitem(sys.modules, "PIL", None)
    for path in ("/frame.jpg?t=1&w=64&h=48", "/session/strip.jpg?w=64&h=48&n=2&dt=0.02"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + path)
        assert e.value.code == 500 and b"Pillow" in e.value.read()
    assert _get(base + "/frame.png?t=1&w=64&h=48")[0] == 200


def test_session_concurrent_requests(server):
    """Concurrent session frames and input pokes do not race (the session
    lock covers the pose) and every response is a valid image."""
    base, _ = server

    def frame(_):
        code, body, ctype = _get(base + "/session/frame.jpg?w=48&h=32&dt=0.01")
        return code == 200 and body[:2] == b"\xff\xd8"

    def poke(i):
        _get(base + f"/session/input?{'press' if i % 2 else 'release'}=w")
        return True

    with cf.ThreadPoolExecutor(4) as ex:
        results = list(ex.map(frame, range(8))) + list(ex.map(poke, range(4)))
    assert all(results)
    _get(base + "/session/input?release=w")
    st = json.loads(_get(base + "/session/state")[1])
    assert np.isfinite(st["position"]).all() and st["sim_time"] > 0


def test_concurrent_frames_equal_serial_frames(server):
    """8 threads x 2 stateless frames at distinct t, all in flight at once
    through the one dispatch lock: each equals its frame served alone."""
    base, _ = server
    paths = [f"/frame.png?t={0.25 * i}&w=64&h=48" for i in range(16)]
    serial = {p: _get(base + p)[1] for p in paths}
    with cf.ThreadPoolExecutor(8) as ex:
        got = list(ex.map(lambda p: _get(base + p)[1], paths))
    assert all(g == serial[p] for p, g in zip(paths, got))
    assert len(set(serial.values())) == len(paths)


def test_mixed_concurrent_requests(server):
    """Stateless frames, session frames and metrics at once across several
    viewports: no 500s, the renderer cache stays bounded, no error counted."""
    base, srv = server
    errors_before = json.loads(_get(base + "/metrics")[1])["errors"]
    jobs = (["/frame.png?t=1.0&w=64&h=48&samples=8"] * 3
            + ["/session/frame.jpg?w=48&h=32&dt=0.01"] * 3
            + ["/frame.jpg?t=0.5&w=80&h=44"] * 3
            + ["/frame.jpg?t=0.5&w=72&h=40"] * 2
            + ["/metrics"] * 3)

    def hit(path):
        code, body, _ = _get(base + path)
        return code == 200 and len(body) > 0

    with cf.ThreadPoolExecutor(6) as ex:
        results = list(ex.map(hit, jobs))
    assert all(results)
    assert json.loads(_get(base + "/metrics")[1])["errors"] == errors_before
    assert len(srv.service._renderers) <= srv.service._renderers_max


def test_oversize_viewport_falls_back(server, monkeypatch):
    """Viewports above the area cap render through render_frame of the host
    fields: no renderer is built or cached, and the frame is the fused
    renderer's."""
    base, srv = server
    monkeypatch.setattr(serve_mod, "_FUSED_MAX_AREA", 64 * 48)
    code, body, _ = _get(base + "/frame.png?t=0.2&w=65&h=48&samples=8")
    assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    assert (65, 48, 512) not in srv.service._renderers
    assert np.array_equal(_png(body), _direct_frame(srv, 0.2, 65, 48))


def test_serve_with_mesh_raises_naming_the_roadmap():
    """``mesh=`` takes the port's mesh (``parallel.make_mesh``), which
    serves since the port's parallel/ (see test_serve_with_mesh_renders);
    anything else raises naming what it wants."""
    with pytest.raises(TypeError, match="make_mesh"):
        serve(_state(), T.OceanConfig(resolution=64), port=0, mesh=object())
    with pytest.raises(TypeError, match="make_mesh"):
        serve_mod.FrameService(_state(), T.OceanConfig(resolution=64), mesh=object())


def test_serve_with_mesh_renders():
    """tests/test_serve.py::test_serve_with_mesh_renders: band-height
    viewports render band-parallel over a 1 x 4 mesh (bit-equal to the
    single-device frame), a height the row axis does not divide takes the
    render_frame path of the gathered fields, /frame equals the unsharded
    step's fields and /metrics names the mesh."""
    from gfx_ocean_tpu_torch.parallel import make_mesh

    mesh = make_mesh([torch.device("cpu")] * 4, batch=1, row=4)
    cfg = T.OceanConfig(resolution=64, compute_normals=False)
    srv = serve(_state(), cfg, host="127.0.0.1", port=0, mesh=mesh)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        code, body, ctype = _get(base + "/frame.png?t=1.0&w=64&h=48")
        assert code == 200 and ctype == "image/png"
        assert (64, 48, 512) in srv.service._renderers  # band-parallel path
        want = raster_mod.make_frame_renderer(cfg, 64, 48)(
            _state(), 1.0, (perspective(64 / 48) @ Camera().view()).astype(np.float32),
            Camera().position.astype(np.float32))
        assert np.array_equal(_png(body), want.numpy())
        code, body, ctype = _get(base + "/frame.jpg?t=1.0&w=64&h=47")
        assert code == 200 and body[:2] == b"\xff\xd8"  # 47 % 4 -> render_frame path
        assert (64, 47, 512) not in srv.service._renderers
        code, body, _ = _get(base + "/frame?t=2.0")
        got = np.load(io.BytesIO(body))["displacement"]
        np.testing.assert_array_equal(got, T.make_step(cfg)(_state(), 2.0).displacement.numpy())
        m = json.loads(_get(base + "/metrics")[1])
        assert m["mesh"] == {"batch": 1, "row": 4} and m["giant_dropped_max"] == 0
    finally:
        _stop(srv)


def test_renderer_cache_churn(monkeypatch):
    """More viewports than the renderer cache holds: a working set that fits
    builds each key once across repeat rounds; past the cap only the cold
    keys build while the LRU keeps a hot viewport; the cache stays bounded."""
    base, srv = _start(_state(), T.OceanConfig(resolution=64, mesh_resolution=32,
                                                compute_normals=False))
    builds = []
    real = raster_mod.make_frame_renderer

    def counting(config, width=480, height=280, giants=512, pool=None, **kw):
        builds.append(width)
        return real(config, width, height, giants, pool, **kw)

    monkeypatch.setattr(raster_mod, "make_frame_renderer", counting)
    try:
        svc = srv.service
        maxn = svc._renderers_max
        widths = [32 + 8 * i for i in range(maxn + 2)]
        for _ in range(2):
            for w in widths[:maxn]:
                assert _get(base + f"/frame.jpg?t=0.5&w={w}&h=24")[0] == 200
        assert builds == widths[:maxn]
        assert len(svc._renderers) <= maxn

        hot = widths[maxn - 1]
        before = len(builds)
        for w in widths[maxn:]:
            assert _get(base + f"/frame.jpg?t=0.5&w={w}&h=24")[0] == 200
            assert _get(base + f"/frame.jpg?t=0.5&w={hot}&h=24")[0] == 200
        assert builds[before:] == widths[maxn:]
        assert len(svc._renderers) <= maxn
    finally:
        _stop(srv)


def test_warmup_errors_rise(monkeypatch):
    """``serve`` lets a failure of its warm-up rise instead of serving."""
    def broken(*args, **kwargs):
        raise RuntimeError("renderer failed to launch")

    monkeypatch.setattr(raster_mod, "make_batch_renderer", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        serve(_state(), T.OceanConfig(resolution=64), port=0)
