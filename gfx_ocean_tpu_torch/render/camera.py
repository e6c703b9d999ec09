"""FPS camera with the reference's exact math and input semantics.

A numpy copy of ``gfx_ocean_tpu/render/camera.py`` (the port cannot import
the JAX package); ``tests/test_torch_render.py`` proves it equal.

Port of ``src/camera.rs`` (nalgebra-glm) to numpy:

- ``view_dir`` = rotate_z(rotate_y(rotate_x(-z_hat, rx), ry), rz)
  (``src/camera.rs:135-143``) — intrinsic rotations of the -Z forward axis.
- ``view`` = look_at(pos, pos + dir, +y_hat) (``src/camera.rs:149-155``),
  right-handed.
- ``update(dt)``: move_speed = 90*dt along view_dir for W/S, rot_speed =
  2*dt on pitch (up/down) and yaw (left/right) (``src/camera.rs:126-133``).
  Only W/S and arrows are handled — the README's A/D strafe claim has no
  code behind it (SURVEY.md Q7); we faithfully implement the code.
- touch: left/right half of the screen yaws (``src/camera.rs:56-89``).

Projection = glm::perspective(aspect, half_pi * 0.8, 0.1, 1024.0)
(``src/render.rs:113-116``), OpenGL-style [-1, 1] clip depth (nalgebra-glm
default). The reference negates clip-space y in the vertex shader
(``shader/ocean.vert:26-27``); our rasterizer does the same.

The default pose matches ``src/lib.rs:74-77``: position (-8, 32, 120),
rotation (-0.6, -1.5, 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

DEFAULT_POSITION = (-8.0, 32.0, 120.0)
DEFAULT_ROTATION = (-0.6, -1.5, 0.0)
FOVY = 0.5 * np.pi * 0.8
NEAR, FAR = 0.1, 1024.0


def _rot_x(v: np.ndarray, a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    x, y, z = v
    return np.array([x, c * y - s * z, s * y + c * z], dtype=np.float64)


def _rot_y(v: np.ndarray, a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    x, y, z = v
    return np.array([c * x + s * z, y, -s * x + c * z], dtype=np.float64)


def _rot_z(v: np.ndarray, a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    x, y, z = v
    return np.array([c * x - s * y, s * x + c * y, z], dtype=np.float64)


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::look_at (right-handed), row-major 4x4 acting on column vectors."""
    eye = np.asarray(eye, dtype=np.float64)
    f = np.asarray(center, dtype=np.float64) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, dtype=np.float64)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(aspect: float, fovy: float = FOVY, near: float = NEAR,
                far: float = FAR) -> np.ndarray:
    """glm::perspective, RH, clip z in [-1, 1] (nalgebra-glm default)."""
    t = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class InputState:
    """Mirror of ``src/camera.rs:12-17``: +1 / -1 / 0 per channel."""

    forward: float = 0.0
    rot_x: float = 0.0
    rot_y: float = 0.0

    def press(self, key: str) -> None:
        """Keyboard semantics of ``src/camera.rs:26-53`` (W/S + arrows)."""
        key = key.lower()
        if key == "w":
            self.forward = 1.0
        elif key == "s":
            self.forward = -1.0
        elif key == "left":
            self.rot_y = 1.0
        elif key == "right":
            self.rot_y = -1.0
        elif key == "up":
            self.rot_x = 1.0
        elif key == "down":
            self.rot_x = -1.0
        # anything else (incl. A/D — Q7): ignored, as in the reference

    def release(self, key: str) -> None:
        key = key.lower()
        if key in ("w", "s"):
            self.forward = 0.0
        elif key in ("left", "right"):
            self.rot_y = 0.0
        elif key in ("up", "down"):
            self.rot_x = 0.0

    def touch(self, phase: str, x: float, screen_width: float,
              scale_factor: float = 1.0) -> None:
        """Touch semantics of ``src/camera.rs:56-89``."""
        if phase == "started":
            if x * scale_factor > screen_width / 2.0:
                self.rot_y = -1.0
            elif x * scale_factor < screen_width / 2.0:
                self.rot_y = 1.0
        else:  # any other phase clears all input
            self.forward = 0.0
            self.rot_x = 0.0
            self.rot_y = 0.0


@dataclasses.dataclass
class Camera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(DEFAULT_POSITION, dtype=np.float64))
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(DEFAULT_ROTATION, dtype=np.float64))
    input: InputState = dataclasses.field(default_factory=InputState)

    def view_dir(self) -> np.ndarray:
        v = np.array([0.0, 0.0, -1.0])
        v = _rot_x(v, self.rotation[0])
        v = _rot_y(v, self.rotation[1])
        return _rot_z(v, self.rotation[2])

    def update(self, dt: float) -> None:
        move_speed = 90.0 * dt
        rot_speed = 2.0 * dt
        self.position = self.position + self.input.forward * move_speed * self.view_dir()
        self.rotation[0] += self.input.rot_x * rot_speed
        self.rotation[1] += self.input.rot_y * rot_speed

    def view(self) -> np.ndarray:
        return look_at(self.position, self.position + self.view_dir(),
                       np.array([0.0, 1.0, 0.0]))


def scripted_camera(script, dt: float = 1.0 / 60.0,
                    camera: Optional[Camera] = None):
    """Replay a key script and yield a camera per frame.

    ``script`` is a sequence of (num_frames, held_keys) segments — the
    headless stand-in for the winit event loop (``src/lib.rs:123-157``).
    Yields (frame_index, Camera) with ``update(dt)`` applied per frame.
    Each yielded camera is an independent SNAPSHOT, so collecting them
    (e.g. for ``render_frames``) keeps per-frame poses rather than F
    references to the final one.
    """
    import copy

    cam = camera if camera is not None else Camera()
    frame = 0
    for num_frames, keys in script:
        st = InputState()
        for k in keys:
            st.press(k)
        cam.input = st
        for _ in range(num_frames):
            cam.update(dt)
            yield frame, copy.deepcopy(cam)
            frame += 1
