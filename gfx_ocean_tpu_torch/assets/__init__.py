from .bincode import (load_omega, load_spectrum, loader_in_use, parse_bincode_f32,
                      parse_bincode_vec2f, reference_data_dir)

__all__ = [
    "load_omega",
    "load_spectrum",
    "loader_in_use",
    "parse_bincode_f32",
    "parse_bincode_vec2f",
    "reference_data_dir",
]
