from .reference import golden_fields, golden_normals, golden_propagate, ifft2_unnorm_np

__all__ = ["golden_fields", "golden_normals", "golden_propagate", "ifft2_unnorm_np"]
