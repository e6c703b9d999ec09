"""gfx_ocean_tpu_torch: the FFT ocean in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100.

The port of ``gfx_ocean_tpu`` (JAX on a TPU), module for module. It imports
torch and numpy only: never jax, and never the JAX package, whose own
``__init__`` imports jax. The framework-free pieces (config, golden model,
bincode loader, spectrum envelopes, DFT tables) are copies, proven equal to
the originals by ``tests/test_torch_*.py``.

The main path is the 512^2 Hermitian-packed step (``fft_impl="pallas"``):
kernel K1, ``ops/fused_step.py`` and ``csrc/packed_step.cu``; unpacked
(``hermitian_pack=False``) the accuracy tier, kernels K4-K6
(``ops/unpacked_step.py``, ``csrc/unpacked_step.cu``); above 512 the
four-step path (K2 + K3). The frame renderer (``render/``, kernels K7 + K8
in ``csrc/raster.cu``) turns a step into a shaded frame. Cascades are a
leading axis of the state through all of it (K1 takes it as a grid axis).
``query.py`` samples the surface at points, ``checkpoint.py`` saves and
loads states in the JAX package's format. States are built on the card
unless a device is given. The entry points are the CLI (``cli.py``,
``python -m gfx_ocean_tpu_torch``; ``--device cpu`` runs it without a card)
and the HTTP frame server (``serve.py``).
"""

from gfx_ocean_tpu_torch.config import CompatFlags, OceanConfig, PhillipsConfig
from gfx_ocean_tpu_torch.query import SurfaceSample, sample_surface
from gfx_ocean_tpu_torch.models.ocean import (
    OceanFields,
    OceanState,
    make_rollout,
    make_step,
    ocean_state_from_assets,
    ocean_state_from_phillips,
    step,
)

__version__ = "0.1.0"

__all__ = [
    "CompatFlags",
    "OceanConfig",
    "OceanFields",
    "OceanState",
    "PhillipsConfig",
    "make_rollout",
    "make_step",
    "ocean_state_from_assets",
    "ocean_state_from_phillips",
    "sample_surface",
    "step",
    "SurfaceSample",
]
