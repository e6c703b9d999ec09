"""Frame server: the deployment surface of the port.

Counterpart of ``gfx_ocean_tpu/serve.py``, route for route and status code
for status code. A dependency-free stdlib server (ThreadingHTTPServer)
wraps the port's ``step`` and frame renderers:

    GET /health            -> {"status": "ok", "device": ...}
    GET /config            -> the OceanConfig as JSON
    GET /frame?t=12.5      -> .npz of (displacement[, normals][, foam])
    GET /frame.png?t=12.5  -> rendered PNG along the default camera
    GET /frame.jpg?t=12.5  -> same, JPEG (needs Pillow)
                              (&w=&h=&samples= override the viewport;
                              &px=&py=&pz=&rx=&ry=&rz= override the pose)
    GET /metrics           -> frames served, error count, latency EMA
                              (the reference's title-bar EMA, src/lib.rs:146-148),
                              the last frame's render and encode seconds

Every call that launches work on the device (the step, a frame, a strip,
the warm-up) runs under one dispatch lock: the kernels share per-stream
state (K8's look-back scratch and its epoch, ``render/raster.py``), and
the card runs one stream in order anyway. A frame's copy to the host, which
waits for the stream, and its encoding run outside the lock, so the next
request's work overlaps them; the threaded server overlaps request parsing
and response IO. The sim being stateless in time, every request is
addressable by absolute ``t``; replicas need only (h0, omega).

PNG is written by ``utils/png.py`` on the standard library, so
``/frame.png`` needs no image library; JPEG needs Pillow and without it
answers 500 naming Pillow.

An interactive session, the analog of the reference's winit window and
event loop (src/lib.rs:42-157), layers a server-side ``Camera`` over the
stateless engine; the browser is the window and only forwards raw events:

    GET /                     -> HTML viewer (keyboard + touch -> /session/*)
    GET /session/input?press=w | release=left | touch=started&x=&width=
                              -> reference key/touch semantics (camera.py)
    GET /session/frame.png    -> advance camera+clock by dt (wall-clock, or
                              &dt= for determinism), render current pose
    GET /session/frame.jpg    -> same, JPEG
    GET /session/strip.jpg?n= -> advance n sub-frames and render them in one
                              call, returned as one vertically stacked JPEG
    GET /session/state        -> pose, sim time, frame-time EMA (title bar)

With a device mesh (``mesh=``, ``parallel.make_mesh`` with batch 1) the
step runs row-sharded over the mesh (the fields gather to the host for
``/frame``), and frames whose height the row axis divides render
band-parallel, one band a position (``parallel/render.py``, bit-equal to
the single-device frame); other heights take the ``render_frame`` path of
the gathered fields. ``/metrics`` names the mesh.
"""

from __future__ import annotations

import collections
import dataclasses
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gfx_ocean_tpu_torch.config import OceanConfig
from gfx_ocean_tpu_torch.models.ocean import OceanState, make_step
from gfx_ocean_tpu_torch.render import raster
from gfx_ocean_tpu_torch.render.camera import (DEFAULT_POSITION, DEFAULT_ROTATION, Camera,
                                               perspective)
from gfx_ocean_tpu_torch.utils.png import encode_png
from gfx_ocean_tpu_torch.utils.profiling import Ema

# Largest viewport served by the one-call frame renderer (1280x720); bigger
# ones render through render_frame from the host fields. The renderer's
# slot pool grows with the area, and the area is the client's to choose.
_FUSED_MAX_AREA = 1280 * 720

def device_label(device: torch.device) -> str:
    """``cuda:0 NVIDIA H100 80GB HBM3`` for a card, ``cpu`` for the host."""
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        return f"cuda:{index} {torch.cuda.get_device_name(index)}"
    return str(device)


def _encode(rgb: np.ndarray, fmt: str) -> bytes:
    """PNG through ``utils/png.py``; JPEG through Pillow (quality 88)."""
    if fmt.upper() not in ("JPEG", "JPG"):
        return encode_png(rgb)
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError as e:
        raise RuntimeError("JPEG encoding needs Pillow (PIL), which is not installed") from e
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=88)
    return buf.getvalue()


class FrameService:
    """Engine wrapper: the step, the frame renderers, serialization, metrics."""

    def __init__(self, state: OceanState, config: OceanConfig, mesh=None,
                 sharded_fft: str = "gspmd"):
        self.config = config
        self.config_json = json.dumps(dataclasses.asdict(config))
        self.mesh = mesh
        if mesh is not None:
            from gfx_ocean_tpu_torch.parallel import (  # noqa: PLC0415
                Mesh, Sharded, make_sharded_step, shard_state)
            from gfx_ocean_tpu_torch.parallel.render import replicate_state  # noqa: PLC0415

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh: expected a parallel.Mesh (parallel.make_mesh), "
                                f"got {type(mesh).__name__}")
            if isinstance(state.h0, Sharded):   # as the CLI's _mesh_setup places it
                state = OceanState(state.h0.gather(), state.omega.gather())
            self._step = make_sharded_step(config, mesh, batched=False, fft=sharded_fft)
            # The band renderers take the state replicated: copied once here,
            # not at every frame.
            self._render_state = replicate_state(state, mesh)
            self.state = shard_state(state, mesh)
            self.device = mesh.device((0, 0))
        else:
            self._step = make_step(config)
            self.state = self._render_state = state
            self.device = state.h0.device
        self.device_name = device_label(self.device)
        self._lock = threading.Lock()          # every launch of device work
        self._meter_lock = threading.Lock()    # counters / EMA
        # (w, h, giants[, n]) -> frame (or n-frame strip) renderer, least
        # recently used evicted past a handful: the key is the client's.
        self._renderers = collections.OrderedDict()
        self._renderers_max = 6
        self.session = CameraSession()
        self.frames_served = 0
        self.errors = 0
        self.latency_ema = Ema()
        self.last_render_sec = 0.0   # the last frame: step, render and host copy
        self.last_encode_sec = 0.0   # the last frame: PNG / JPEG encoding
        # Coverage tripwire: giant-pass candidates dropped past capacity in
        # the last frame (nonzero: the frame may have lost exact coverage).
        self.giant_dropped_last = 0
        self.giant_dropped_max = 0

    def _served(self, seconds: float, frames: int = 1) -> None:
        with self._meter_lock:
            self.latency_ema.update(seconds / frames)
            self.frames_served += frames

    def fields(self, t: float) -> dict:
        t0 = time.perf_counter()
        with self._lock:
            out = self._step(self.state, float(t))
        if self.mesh is not None:
            out = type(out)(*(None if f is None else f.gather() for f in out))
        arrays = {"displacement": out.displacement.cpu().numpy(), "t": np.float64(t)}
        if out.normals is not None:
            arrays["normals"] = out.normals.cpu().numpy()
        if out.foam is not None:
            arrays["foam"] = out.foam.cpu().numpy()
        self._served(time.perf_counter() - t0)
        return arrays

    def _renderer(self, key):
        """The cached renderer of a key; the caller holds the dispatch lock.
        Building one launches nothing: its first frame is the caller's."""
        fn = self._renderers.get(key)
        if fn is not None:
            self._renderers.move_to_end(key)
            return fn
        width, height, giants = key[:3]
        if self.mesh is not None:
            # Band-parallel: a horizontal band of the viewport a position,
            # gathered (parallel/render.py).
            from gfx_ocean_tpu_torch.parallel import render as prender  # noqa: PLC0415

            if len(key) == 4:
                sharded = prender.make_sharded_batch_renderer(self.config, self.mesh, width,
                                                              height, giants=giants)

                def fn(*args):
                    return sharded(*args).gather()
            else:
                sharded = prender.make_sharded_frame_renderer(self.config, self.mesh, width,
                                                              height, giants=giants, diag=True)

                def fn(*args):
                    frame, dropped = sharded(*args)
                    return frame.gather(), dropped.gather().max()
        elif len(key) == 4:
            fn = raster.make_batch_renderer(self.config, width=width, height=height,
                                            giants=giants)
        else:
            fn = raster.make_frame_renderer(self.config, width=width, height=height,
                                            giants=giants, diag=True)
        while len(self._renderers) >= self._renderers_max:
            self._renderers.popitem(last=False)
        self._renderers[key] = fn
        return fn

    def record_error(self) -> None:
        with self._meter_lock:
            self.errors += 1

    def frame_npz(self, t: float) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, **self.fields(t))
        return buf.getvalue()

    def frame_rgb(self, t: float, width: int, height: int, samples: int,
                  camera=None, giants: int = 512) -> np.ndarray:
        """One rendered frame, (H, W, 3) uint8 on the host.

        Up to ``_FUSED_MAX_AREA`` it is one call of the frame renderer
        (step -> rasterize -> sRGB on the state's device), the analog of
        the reference's single per-frame submission (src/render.rs:1122-1372);
        above, ``render_frame`` of the fields.
        """
        camera = camera if camera is not None else Camera()
        t0 = time.perf_counter()
        view_proj = (perspective(width / height) @ camera.view()).astype(np.float32)
        fused_ok = width * height <= _FUSED_MAX_AREA and (
            self.mesh is None or height % self.mesh.shape["row"] == 0)
        if fused_ok:
            with self._lock:
                fn = self._renderer((width, height, giants))
                srgb_dev, dropped_dev = fn(self._render_state, float(t), view_proj,
                                           camera.position.astype(np.float32))
            srgb = srgb_dev.cpu().numpy()
            dropped = int(dropped_dev)
            with self._meter_lock:
                self.giant_dropped_last = dropped
                self.giant_dropped_max = max(self.giant_dropped_max, dropped)
            self._served(time.perf_counter() - t0)
        else:
            arrays = self.fields(t)
            cfg = self.config
            with self._lock:
                foam = arrays.get("foam")
                img = raster.render_frame(
                    torch.from_numpy(arrays["displacement"]).to(self.device), camera,
                    width=width, height=height, mesh_resolution=cfg.mesh_resolution,
                    num_patches=cfg.num_patches, samples=samples, giants=giants,
                    foam=None if foam is None else torch.from_numpy(foam).to(self.device),
                    frag_normal_x=cfg.compat.frag_normal_x, height_div=cfg.height_div,
                    horiz_div=cfg.horiz_div, normal_height_scale=cfg.normal_height_scale,
                    pbr_roughness=cfg.pbr_roughness,
                    cascade_domains=cfg.domains if cfg.num_cascades > 1 else None)
                srgb_dev = raster.srgb8(img)
            srgb = srgb_dev.cpu().numpy()
        with self._meter_lock:
            self.last_render_sec = time.perf_counter() - t0
        return srgb

    def frame_png(self, t: float, width: int, height: int, samples: int,
                  camera=None, giants: int = 512, fmt: str = "PNG") -> bytes:
        """One rendered frame, PNG (lossless stills) or JPEG (the
        interactive viewer's format) encoded."""
        srgb = self.frame_rgb(t, width, height, samples, camera, giants)
        t0 = time.perf_counter()
        body = _encode(srgb, fmt)
        with self._meter_lock:
            self.last_encode_sec = time.perf_counter() - t0
        return body

    def strip_frames(self, times, cameras, width: int, height: int,
                     giants: int = 512) -> np.ndarray:
        """n session frames in one renderer call and one host copy:
        (n, H, W, 3) uint8. The server-side camera integrates held keys over
        the n sub-frame ticks, the same trajectory as n single frames
        (src/lib.rs:139-148). No coverage tripwire (single frames only)."""
        n = len(times)
        t0 = time.perf_counter()
        proj = perspective(width / height)
        vps = np.stack([(proj @ c.view()).astype(np.float32) for c in cameras])
        cps = np.stack([c.position.astype(np.float32) for c in cameras])
        ts = np.asarray(times, np.float32)
        with self._lock:
            fn = self._renderer((width, height, giants, n))
            frames_dev = fn(self._render_state, torch.from_numpy(ts).to(self.device),
                            torch.from_numpy(vps).to(self.device),
                            torch.from_numpy(cps).to(self.device))
        frames = frames_dev.cpu().numpy()
        self._served(time.perf_counter() - t0, n)
        return frames

    def strip_jpg(self, times, cameras, width: int, height: int,
                  giants: int = 512) -> bytes:
        """:meth:`strip_frames` stacked vertically into one JPEG (the viewer
        slices it back apart)."""
        frames = self.strip_frames(times, cameras, width, height, giants)
        return _encode(np.concatenate(list(frames), axis=0), "JPEG")

    def metrics(self) -> dict:
        with self._meter_lock:
            return {
                "frames_served": self.frames_served,
                "errors": self.errors,
                "giant_dropped_last": self.giant_dropped_last,
                "giant_dropped_max": self.giant_dropped_max,
                "latency_ema_sec": round(self.latency_ema.value, 6),
                "last_render_sec": self.last_render_sec,
                "last_encode_sec": self.last_encode_sec,
                "device": self.device_name,
                "resolution": self.config.resolution,
                "mesh": None if self.mesh is None else dict(self.mesh.shape),
            }


class CameraSession:
    """Server-side analog of the reference's app loop (src/lib.rs:42-157).

    Holds a ``Camera`` + ``InputState`` + a sim clock. Each rendered frame
    advances both by dt (wall-clock by default, like the reference's
    ``Instant``-based elapsed time, src/lib.rs:139-142) and feeds the
    frame-time EMA the reference shows in its title bar
    (src/lib.rs:146-148). Input events use the reference's key/touch
    semantics verbatim (render/camera.py).
    """

    def __init__(self):
        self.camera = Camera()
        self.sim_time = 0.0
        self.frame_ema = Ema()
        self._last = None  # wall-clock of the previous frame
        self._lock = threading.Lock()

    def input(self, action: str, value: str, x: float = 0.0,
              width: float = 1.0) -> None:
        with self._lock:
            if action == "press":
                self.camera.input.press(value)
            elif action == "release":
                self.camera.input.release(value)
            elif action == "touch":
                self.camera.input.touch(value, x, width)
            else:
                raise ValueError(f"unknown input action {action!r}")

    def _snapshot(self) -> Camera:
        # So the render (outside the lock) cannot see a concurrent
        # input/advance move the pose mid-frame.
        return dataclasses.replace(self.camera, position=self.camera.position.copy(),
                                   rotation=self.camera.rotation.copy())

    def _elapsed(self, dt: Optional[float]) -> float:
        now = time.perf_counter()
        if dt is None:
            dt = 0.0 if self._last is None else min(now - self._last, 0.25)
        self._last = now
        return dt

    def advance(self, dt: Optional[float] = None):
        """Tick the loop: returns (sim time, camera snapshot) to render."""
        with self._lock:
            dt = self._elapsed(dt)
            self.camera.update(dt)
            self.sim_time += dt
            self.frame_ema.update(dt)
            return self.sim_time, self._snapshot()

    def advance_batch(self, n: int, dt: Optional[float] = None):
        """Tick the loop n sub-frames for a strip render: the wall-clock
        (or explicit) dt is split evenly and the camera integrates held
        keys across the sub-ticks exactly as n single ``advance`` calls
        with dt/n would. Returns [(sim time, camera snapshot), ...]."""
        with self._lock:
            sub = self._elapsed(dt) / n
            out = []
            for _ in range(n):
                self.camera.update(sub)
                self.sim_time += sub
                self.frame_ema.update(sub)
                out.append((self.sim_time, self._snapshot()))
            return out

    def state(self) -> dict:
        with self._lock:
            return {
                "position": [round(float(v), 4) for v in self.camera.position],
                "rotation": [round(float(v), 4) for v in self.camera.rotation],
                "sim_time": round(self.sim_time, 4),
                "frame_ema_sec": round(self.frame_ema.value, 6),
                "fps": (round(1.0 / self.frame_ema.value, 2)
                        if self.frame_ema.value > 0 else None),
                "input": {"forward": self.camera.input.forward,
                          "rot_x": self.camera.input.rot_x,
                          "rot_y": self.camera.input.rot_y},
            }


# The browser stands in for the winit window: it forwards raw key/touch
# events and displays frames; every piece of camera/timing logic stays
# server-side in the tested Python port of src/camera.rs.
_VIEWER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>gfx_ocean_tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
 body { margin:0; background:#111; color:#ccc; font:13px monospace;
        display:flex; flex-direction:column; align-items:center }
 canvas { width:100%; max-width:960px; image-rendering:auto; margin-top:8px }
 #hud { padding:6px }
</style></head><body>
<canvas id="v" width="960" height="540"></canvas>
<div id="hud">connecting…</div>
<script>
const v = document.getElementById('v'), hud = document.getElementById('hud');
const ctx = v.getContext('2d');
const KEYS = {KeyW:'w', KeyS:'s', ArrowLeft:'left', ArrowRight:'right',
              ArrowUp:'up', ArrowDown:'down'};
const held = new Set();
function send(q) { fetch('/session/input?' + q); }
addEventListener('keydown', e => {
  const k = KEYS[e.code];
  if (k && !held.has(k)) { held.add(k); send('press=' + k); e.preventDefault(); }
});
addEventListener('keyup', e => {
  const k = KEYS[e.code];
  if (k) { held.delete(k); send('release=' + k); e.preventDefault(); }
});
v.addEventListener('touchstart', e => {
  const r = v.getBoundingClientRect();
  send('touch=started&x=' + (e.touches[0].clientX - r.left) + '&width=' + r.width);
}, {passive: true});
addEventListener('touchend', () => send('touch=ended'), {passive: true});
let ema = null;
// Strip mode: each request renders STRIP frames in ONE call + ONE
// transfer (a vertically stacked JPEG the canvas slices), amortizing the
// per-request cost across the strip; two strips stay in flight so the
// next strip renders while this one presents.
// Drop to ?w=480&h=280 on a slow link.
const STRIP = 4, W = 960, H = 540;
const sleep = ms => new Promise(r => setTimeout(r, ms));
const grab = () => fetch('/session/strip.jpg?w=' + W + '&h=' + H +
                         '&n=' + STRIP)
  .then(r => r.blob());
// Two strips in flight, sub-frames presented in order and paced over the
// measured strip interval: the server renders strip n+1 while strip n's
// pixels download and present.
async function loop() {
  let next = grab();
  let last = performance.now();
  for (;;) {
    const cur = next;
    next = grab();
    try {
      const bmp = await createImageBitmap(await cur);
      const now = performance.now();
      const ms = now - last;
      last = now;
      ema = ema === null ? ms : ema * 0.9 + ms * 0.1;   // src/lib.rs:146-148
      const per = ema / STRIP;
      hud.textContent = 'Ocean: ' + per.toFixed(2) + 'ms (' +
        (1000 / per).toFixed(1) + ' fps)  (W/S move, arrows look, touch to yaw)';
      for (let i = 0; i < STRIP; i++) {
        ctx.drawImage(bmp, 0, i * H, W, H, 0, 0, W, H);
        if (i < STRIP - 1) await sleep(per);
      }
      bmp.close();
    } catch (e) { hud.textContent = 'error: ' + e; await sleep(250); }
    await new Promise(requestAnimationFrame);
  }
}
loop();
</script></body></html>"""


def _viewport(q) -> tuple:
    w = int(q.get("w", ["300"])[0])
    h = int(q.get("h", ["175"])[0])
    s = int(q.get("samples", ["16"])[0])
    g = int(q.get("giants", ["512"])[0])
    if not (16 <= w <= 2048 and 16 <= h <= 2048 and 4 <= s <= 128
            and 32 <= g <= 4096):
        raise ValueError("viewport out of range")
    return w, h, s, g


def _pose(q) -> Optional[Camera]:
    """The camera of the &px=&py=&pz=&rx=&ry=&rz= overrides, or None."""
    if not any(k in q for k in ("px", "py", "pz", "rx", "ry", "rz")):
        return None
    camera = Camera()
    camera.position = np.array([float(q.get(k, [d])[0]) for k, d in
                                zip(("px", "py", "pz"), DEFAULT_POSITION)])
    camera.rotation = np.array([float(q.get(k, [d])[0]) for k, d in
                                zip(("rx", "ry", "rz"), DEFAULT_ROTATION)])
    return camera


def _make_handler(service: FrameService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet; metrics cover observability
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802
            try:
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/health":
                    self._json(200, {"status": "ok", "device": service.device_name})
                elif url.path == "/config":
                    self._send(200, service.config_json.encode(), "application/json")
                elif url.path == "/metrics":
                    self._json(200, service.metrics())
                elif url.path == "/frame":
                    t = float(q.get("t", ["0"])[0])
                    self._send(200, service.frame_npz(t), "application/octet-stream")
                elif url.path in ("/frame.png", "/frame.jpg"):
                    t = float(q.get("t", ["0"])[0])
                    fmt = "JPEG" if url.path.endswith(".jpg") else "PNG"
                    w, h, s, g = _viewport(q)
                    self._send(200, service.frame_png(t, w, h, s, _pose(q), giants=g,
                                                      fmt=fmt),
                               f"image/{fmt.lower()}")
                elif url.path == "/":
                    self._send(200, _VIEWER_HTML.encode(), "text/html")
                elif url.path == "/session/input":
                    if "press" in q:
                        service.session.input("press", q["press"][0])
                    elif "release" in q:
                        service.session.input("release", q["release"][0])
                    elif "touch" in q:
                        service.session.input(
                            "touch", q["touch"][0],
                            x=float(q.get("x", ["0"])[0]),
                            width=float(q.get("width", ["1"])[0]))
                    else:
                        raise ValueError("need press=, release=, or touch=")
                    self._json(200, {"ok": True})
                elif url.path in ("/session/frame.png", "/session/frame.jpg"):
                    fmt = "JPEG" if url.path.endswith(".jpg") else "PNG"
                    w, h, s, g = _viewport(q)
                    dt = float(q["dt"][0]) if "dt" in q else None
                    t, cam = service.session.advance(dt)
                    self._send(200, service.frame_png(t, w, h, s, cam, giants=g, fmt=fmt),
                               f"image/{fmt.lower()}")
                elif url.path == "/session/strip.jpg":
                    w, h, _, g = _viewport(q)
                    n = int(q.get("n", ["4"])[0])
                    if not 2 <= n <= 16:
                        raise ValueError("strip n out of range [2, 16]")
                    if w * h > _FUSED_MAX_AREA:
                        raise ValueError(
                            "strip viewport exceeds the fused-path area cap")
                    if service.mesh is not None and n % service.mesh.shape["batch"]:
                        raise ValueError(f"strip n={n} must divide by the mesh batch axis "
                                         f"({service.mesh.shape['batch']})")
                    dt = float(q["dt"][0]) if "dt" in q else None
                    ticks = service.session.advance_batch(n, dt)
                    self._send(200, service.strip_jpg(
                        [t for t, _ in ticks], [c for _, c in ticks],
                        w, h, giants=g), "image/jpeg")
                elif url.path == "/session/state":
                    self._json(200, service.session.state())
                else:
                    self._json(404, {"error": f"no route {url.path}"})
            except (ValueError, KeyError) as e:
                service.record_error()
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - the server keeps serving
                service.record_error()
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(state: OceanState, config: OceanConfig, host: str = "127.0.0.1",
          port: int = 8807, mesh=None, sharded_fft: str = "gspmd") -> ThreadingHTTPServer:
    """Start the frame server (returns it; call ``serve_forever`` or use the
    CLI, which does). On the card it first builds and loads every kernel
    library (one nvcc each, all at once; a library already built is reused),
    then warms up: one step and the viewer's default strip (960x540, 4
    frames) without the encoder. Every error of the build or the warm-up
    rises to the caller. With ``mesh`` the step runs row-sharded over the
    mesh and frames render band-parallel (see the module's docstring)."""
    service = FrameService(state, config, mesh=mesh, sharded_fft=sharded_fft)
    if service.device.type == "cuda":
        from gfx_ocean_tpu_torch import kernels  # noqa: PLC0415

        for name in kernels.build_all(sorted(kernels.SIGNATURES)):
            kernels.load(name)
    service.fields(0.0)
    if mesh is None or (540 % mesh.shape["row"] == 0 and 4 % mesh.shape["batch"] == 0):
        service.strip_frames([0.0] * 4, [Camera()] * 4, 960, 540)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    server.service = service  # for tests/metrics access
    return server
