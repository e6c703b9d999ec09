"""Band-parallel frames over a mesh.

Counterpart of ``gfx_ocean_tpu/parallel/render.py``. The viewport is split
into horizontal bands, one a position along a mesh axis, and each position
runs the frame renderer's own body on its band (``render/raster._frame_fn``
with ``y_origin`` / ``full_height``): step (K1 at 512^2), the band's pool
rasterizer (K7, K8, K9), sRGB. Band pixels sample the same float32 NDC centres
as the full frame, so the bands stack into the single-device frame bit for
bit. The step runs on every position (replicated, as in the JAX package):
it is a small share of a frame and saves gathering the displacement.

``make_sharded_batch_renderer`` adds the frame axis: frames data-parallel
over "batch" times bands over "row", for offline frame production.

The state is replicated: a global ``OceanState`` (its tensors are copied
to each position's device at each call, a no-op on their own device) or
one of ``Sharded`` values with an empty spec (``replicate_state``, copied
once). Frames come back ``Sharded``; ``.gather()`` stacks them.
"""

from __future__ import annotations

import torch

from gfx_ocean_tpu_torch.config import OceanConfig
from gfx_ocean_tpu_torch.models.ocean import OceanState
from gfx_ocean_tpu_torch.parallel.collectives import axis_index
from gfx_ocean_tpu_torch.parallel.mesh import Mesh, Sharded, shard
from gfx_ocean_tpu_torch.render.raster import _frame_fn
from gfx_ocean_tpu_torch.utils.device import device_guard


def replicate_state(state: OceanState, mesh: Mesh) -> OceanState:
    """The state copied once onto every position (spec: replicated)."""
    return OceanState(*(shard(x, mesh, ()) for x in state))


def _local(x, mesh: Mesh, position):
    """The position's copy of a replicated tensor."""
    if isinstance(x, Sharded):
        return x.shard(position)
    return torch.as_tensor(x).to(mesh.device(position))


def make_sharded_frame_renderer(config: OceanConfig, mesh: Mesh, width: int, height: int,
                                giants: int = 512, pool: int | None = None, axis: str = "row",
                                diag: bool = False):
    """``fn(state, t, view_proj, camera_pos) -> (height, width, 3) uint8``,
    ``Sharded`` with rows over ``mesh[axis]``: position d renders rows
    ``[d * height / D, (d + 1) * height / D)``. Bit-equal to
    ``make_frame_renderer(config, width, height, giants)``. With ``diag``
    it returns ``(frame, dropped)``, ``dropped`` the (D,) per-band count of
    giant-pass candidates past capacity (any nonzero entry: that band may
    have lost coverage). ``view_proj`` is built for the full viewport."""
    band_fn = _frame_fn(config, width, height, giants, pool, band_axis=axis,
                        n_bands=mesh.shape[axis], diag=diag)

    def fn(state, t, view_proj, camera_pos):
        frames, dropped = [], []
        for pos in mesh.positions():
            with device_guard(mesh.device(pos)):
                out = band_fn(OceanState(*(_local(x, mesh, pos) for x in state)), t,
                              _local(view_proj, mesh, pos), _local(camera_pos, mesh, pos),
                              band=axis_index(mesh, axis, pos))
            frames.append(out[0] if diag else out)
            if diag:
                dropped.append(out[1].reshape(1))
        frame = Sharded(mesh, (axis, None, None), tuple(frames))
        return (frame, Sharded(mesh, (axis,), tuple(dropped))) if diag else frame

    return fn


def make_sharded_batch_renderer(config: OceanConfig, mesh: Mesh, width: int, height: int,
                                giants: int = 512, pool: int | None = None,
                                frame_axis: str = "batch", band_axis: str = "row"):
    """``fn(state, ts, view_projs, camera_pos) -> (F, height, width, 3)
    uint8``, ``Sharded`` with frames over ``frame_axis`` and rows over
    ``band_axis``; F must divide by ``mesh[frame_axis]``. Bit-equal to
    ``render.raster.make_batch_renderer``."""
    band_fn = _frame_fn(config, width, height, giants, pool, band_axis=band_axis,
                        n_bands=mesh.shape[band_axis])
    n_fp = mesh.shape[frame_axis]

    def call(state, ts, view_projs, camera_pos):
        if len(ts) % n_fp:
            raise ValueError(f"frame count {len(ts)} must divide by mesh axis "
                             f"{frame_axis!r} ({n_fp}); pad the chunk")
        per = len(ts) // n_fp
        out = []
        for pos in mesh.positions():
            first = axis_index(mesh, frame_axis, pos) * per
            with device_guard(mesh.device(pos)):
                local = OceanState(*(_local(x, mesh, pos) for x in state))
                out.append(torch.stack([
                    band_fn(local, ts[i], _local(view_projs[i], mesh, pos),
                            _local(camera_pos[i], mesh, pos),
                            band=axis_index(mesh, band_axis, pos))
                    for i in range(first, first + per)]))
        return Sharded(mesh, (frame_axis, band_axis, None, None), tuple(out))

    return call
