"""PNG writer on the standard library (``zlib``, ``struct``).

The frame server and ``cli render`` write PNGs with it whether Pillow is
installed or not, so still frames need no image library: RGB8, one IDAT,
filter type 0 on every row, zlib's default compression level. The bytes are
a function of the pixels alone.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 image as PNG bytes."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png wants (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    rows = np.empty((h, 1 + 3 * w), dtype=np.uint8)
    rows[:, 0] = 0  # filter type 0 (None)
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image to ``path`` as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
