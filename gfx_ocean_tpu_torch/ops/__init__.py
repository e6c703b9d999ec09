from .derived import finite_difference_normals, finite_difference_normals_planes
from .fft import ifft2_planes_unnorm, ifft2_real_unnorm
from .fused_step import fused_checksums, fused_fields, fused_planes
from .propagate import wavenumber_grid
from .unpacked_step import unpacked_checksums, unpacked_planes

__all__ = [
    "finite_difference_normals",
    "finite_difference_normals_planes",
    "fused_checksums",
    "fused_fields",
    "fused_planes",
    "ifft2_planes_unnorm",
    "ifft2_real_unnorm",
    "unpacked_checksums",
    "unpacked_planes",
    "wavenumber_grid",
]
