"""The frame renderer of the port: camera, mesh, shading and the pool
rasterizer (kernels K7 + K8 on the card)."""

from .camera import Camera, InputState, look_at, perspective
from .mesh import build_grid
from .raster import (make_batch_renderer, make_frame_renderer, pool_overflow, render_frame,
                     render_frames)
from .shade import shade_fragments

__all__ = [
    "Camera",
    "InputState",
    "build_grid",
    "look_at",
    "make_batch_renderer",
    "make_frame_renderer",
    "perspective",
    "pool_overflow",
    "render_frame",
    "render_frames",
    "shade_fragments",
]
