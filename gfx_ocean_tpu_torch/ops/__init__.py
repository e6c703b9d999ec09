from .derived import (correction, correction_sign, finite_difference_normals,
                      finite_difference_normals_planes, jacobian_foam)
from .fft import ifft1d_real_unnorm, ifft1d_unnorm, ifft2_planes_unnorm, ifft2_real_unnorm, ifft2_unnorm
from .fused_step import fused_checksums, fused_fields, fused_planes
from .propagate import propagate, propagate_planes, wavenumber_grid
from .unpacked_step import unpacked_checksums, unpacked_planes

__all__ = [
    "correction",
    "correction_sign",
    "finite_difference_normals",
    "finite_difference_normals_planes",
    "fused_checksums",
    "fused_fields",
    "fused_planes",
    "ifft1d_real_unnorm",
    "ifft1d_unnorm",
    "ifft2_planes_unnorm",
    "ifft2_real_unnorm",
    "ifft2_unnorm",
    "jacobian_foam",
    "propagate",
    "propagate_planes",
    "unpacked_checksums",
    "unpacked_planes",
    "wavenumber_grid",
]
