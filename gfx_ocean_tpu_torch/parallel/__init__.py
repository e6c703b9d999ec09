"""Multi-device runs of the port over a ("batch", "row") mesh.

Counterpart of ``gfx_ocean_tpu/parallel``: the row-sharded 2-D DFT with
explicit all_to_all transposes (``distributed_fft.py``), the sharded step
and rollout (``sharding.py``) and band-parallel frames (``render.py``,
loaded on first use), over the port's mesh and sharded values
(``mesh.py``) and its copy-based collectives (``collectives.py``).
"""

from .distributed_fft import ifft2_planes_unnorm_sharded, ifft2_real_unnorm_sharded
from .mesh import Mesh, Sharded, make_mesh, shard
from .sharding import make_sharded_rollout, make_sharded_step, shard_state

__all__ = [
    "Mesh",
    "Sharded",
    "ifft2_planes_unnorm_sharded",
    "ifft2_real_unnorm_sharded",
    "make_mesh",
    "make_sharded_batch_renderer",
    "make_sharded_frame_renderer",
    "make_sharded_rollout",
    "make_sharded_step",
    "shard",
    "shard_state",
]


def __getattr__(name):
    # The band renderers pull in the render stack; simulate / bench over a
    # mesh do not pay that import.
    if name in ("make_sharded_batch_renderer", "make_sharded_frame_renderer"):
        from . import render  # noqa: PLC0415

        return getattr(render, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
