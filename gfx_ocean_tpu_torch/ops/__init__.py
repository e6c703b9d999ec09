from .derived import finite_difference_normals, finite_difference_normals_planes
from .fft import ifft2_planes_unnorm, ifft2_real_unnorm
from .fused_step import fused_checksums, fused_fields, fused_planes
from .propagate import wavenumber_grid

__all__ = [
    "finite_difference_normals",
    "finite_difference_normals_planes",
    "fused_checksums",
    "fused_fields",
    "fused_planes",
    "ifft2_planes_unnorm",
    "ifft2_real_unnorm",
    "wavenumber_grid",
]
