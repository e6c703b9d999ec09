"""The reference's camera at its default pose: the view-projection matrix
and eye position a frame is drawn with.

``src/camera.rs``: view = look_at(pos, pos + dir, +y), dir the -Z axis
rotated about x, then y, then z; the default pose of ``src/lib.rs:74-77``
is position (-8, 32, 120), rotation (-0.6, -1.5, 0). Projection =
``glm::perspective(aspect, pi/2 * 0.8, 0.1, 1024)`` (``src/render.rs:113-116``),
right-handed, clip z in [-1, 1].
"""

from __future__ import annotations

import numpy as np

DEFAULT_POSITION = (-8.0, 32.0, 120.0)
DEFAULT_ROTATION = (-0.6, -1.5, 0.0)
FOVY = 0.5 * np.pi * 0.8
NEAR, FAR = 0.1, 1024.0


def _rotate(v: np.ndarray, axis: int, a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    x, y, z = v
    if axis == 0:
        return np.array([x, c * y - s * z, s * y + c * z])
    if axis == 1:
        return np.array([c * x + s * z, y, -s * x + c * z])
    return np.array([c * x - s * y, s * x + c * y, z])


def view_dir(rotation) -> np.ndarray:
    v = np.array([0.0, 0.0, -1.0])
    for axis in range(3):
        v = _rotate(v, axis, rotation[axis])
    return v


def look_at(eye, center, up) -> np.ndarray:
    """glm::look_at (right-handed), row-major, acting on column vectors."""
    eye = np.asarray(eye, dtype=np.float64)
    f = np.asarray(center, dtype=np.float64) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -np.dot(s, eye), -np.dot(u, eye), np.dot(f, eye)
    return m


def perspective(aspect: float) -> np.ndarray:
    t = 1.0 / np.tan(FOVY / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = -(FAR + NEAR) / (FAR - NEAR)
    m[2, 3] = -(2.0 * FAR * NEAR) / (FAR - NEAR)
    m[3, 2] = -1.0
    return m


def default_view(width: int, height: int):
    """(view_proj (4, 4) float32, eye position (3,) float32) of the default
    pose at a ``width`` x ``height`` viewport."""
    pos = np.array(DEFAULT_POSITION)
    view = look_at(pos, pos + view_dir(DEFAULT_ROTATION), np.array([0.0, 1.0, 0.0]))
    return (perspective(width / height) @ view).astype(np.float32), pos.astype(np.float32)
