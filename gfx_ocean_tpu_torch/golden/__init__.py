from .reference import (golden_fields, golden_foam, golden_normals, golden_propagate,
                        golden_step, ifft2_unnorm_np)

__all__ = ["golden_fields", "golden_foam", "golden_normals", "golden_propagate",
           "golden_step", "ifft2_unnorm_np"]
