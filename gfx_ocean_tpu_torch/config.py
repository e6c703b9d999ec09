"""Configuration of the PyTorch port: a copy of ``gfx_ocean_tpu/config.py``.

The JAX package cannot be imported where the port runs (its package
``__init__`` imports jax), so the three frozen dataclasses are copied here
with identical fields, defaults and ``__post_init__`` validation.
``tests/test_torch_config_assets.py`` proves the copies equal the originals.

Field semantics are documented on the originals. Two fields read
differently on the port:

- ``fft_impl``: "pallas" selects the hand-written CUDA kernels of
  ``ops/fused_step.py`` (their plain PyTorch version on CPU tensors),
  "matmul" the PyTorch direct-DFT matmul path, "xla" ``torch.fft``.
- ``matmul_precision``: on "matmul" each tier is a scheme of bf16
  tensor-core passes summed in FP32, or for "highest" float64 products
  on the card and FP32 on the CPU (``ops/fft.full_matmul``). On "pallas"
  kernels K1-K4 run the JAX kernels' bf16 tiers in their tiered bodies
  K1t-K4t (``ops/fft.kernel_tier``: bf16 tensor-core passes summed in
  FP32) and their FP32 FFT bodies at "highest" only; K5 and K6 are
  "highest" only. "xla" takes none (``ops/fft.effective_precision``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Bit-parity switches for reference quirks (SURVEY.md §2.4).

    wrap_k:        Q1, the reference's uint32 wraparound of ``2i - N - 1``.
    ref_sign:      Q2, the reference's global flip of the (-1)^(x+y) sign.
    conj_neg:      canonical conj(h0(-k)) pairing instead of the reference's.
    frag_normal_x: Q8, normals from the disp_x channel (render only).
    """

    wrap_k: bool = False
    ref_sign: bool = True
    conj_neg: bool = False
    frag_normal_x: bool = False


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    """Static parameters of the ocean simulation (see the JAX original)."""

    # --- simulation grid (reference src/render.rs:42-46) ---
    resolution: int = 512
    domain_size: float = 1000.0

    # --- FFT implementation ---
    fft_impl: str = "matmul"
    direct_dft_max: int = 1024

    # --- numerics ---
    matmul_precision: str = "bf16x3"
    choppy_precision: Optional[str] = None
    # None = auto: on for resolution >= 1024 or fft_impl == "pallas".
    hermitian_pack: Optional[bool] = None
    dtype: str = "float32"

    # --- quirk compatibility (SURVEY.md §2.4) ---
    compat: CompatFlags = dataclasses.field(default_factory=CompatFlags)

    # --- outputs ---
    compute_normals: bool = True
    compute_foam: bool = False
    foam_threshold: float = 0.6
    foam_lambda: float = 1.0

    # --- visual scales (reference shader/ocean.vert:22-23, ocean.frag:19) ---
    height_div: float = 3.0
    horiz_div: float = 3.5
    normal_height_scale: float = 180.0
    pbr_roughness: float = 0.0

    # --- render mesh (reference src/render.rs:44, :473-605) ---
    mesh_resolution: int = 128
    num_patches: int = 4

    # --- cascades (BASELINE.json config 4) ---
    num_cascades: int = 1
    cascade_domains: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        n = self.resolution
        if n & (n - 1) != 0 or n < 16:
            raise ValueError(f"resolution must be a power of two >= 16, got {n}")
        if self.fft_impl not in ("matmul", "xla", "pallas"):
            raise ValueError(f"unknown fft_impl {self.fft_impl!r}")
        if self.hermitian_pack is None:
            object.__setattr__(
                self, "hermitian_pack",
                self.resolution >= 1024 or self.fft_impl == "pallas")
        if self.cascade_domains is not None and len(self.cascade_domains) != self.num_cascades:
            raise ValueError("cascade_domains length must equal num_cascades")

    @property
    def domains(self) -> Tuple[float, ...]:
        if self.cascade_domains is not None:
            return self.cascade_domains
        return tuple(self.domain_size / (4.0 ** i) for i in range(self.num_cascades))


@dataclasses.dataclass(frozen=True)
class PhillipsConfig:
    """Runtime spectrum synthesis parameters (BASELINE.json config 3)."""

    amplitude: float = 3.0e-7
    wind_speed: float = 31.0
    wind_direction: Tuple[float, float] = (1.0, 0.0)
    gravity: float = 9.81
    small_wave_cutoff: float = 1.0e-3
    directional_power: float = 2.0
    seed: int = 0
    model: str = "phillips"
    fetch: float = 5.0e5
    peak_enhancement: float = 3.3
    depth: float = float("inf")
    opposing_suppression: float = 1.0

    def __post_init__(self):
        if self.model not in ("phillips", "jonswap"):
            raise ValueError(f"unknown spectrum model {self.model!r} "
                             "(expected 'phillips' or 'jonswap')")
        if self.model == "jonswap" and not (
                math.isfinite(self.fetch) and self.fetch > 0):
            raise ValueError("jonswap fetch must be finite and > 0, got "
                             f"{self.fetch}")
        if self.model == "jonswap" and not (
                math.isfinite(self.peak_enhancement)
                and self.peak_enhancement > 0):
            raise ValueError("jonswap peak_enhancement (gamma) must be "
                             f"finite and > 0, got {self.peak_enhancement}")
        if not (self.depth > 0):
            raise ValueError(f"depth must be > 0 (meters), got {self.depth}")
        if not (0.0 <= self.opposing_suppression <= 1.0):
            raise ValueError("opposing_suppression must be in [0, 1], got "
                             f"{self.opposing_suppression}")
