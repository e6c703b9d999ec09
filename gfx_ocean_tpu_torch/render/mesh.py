"""Render mesh: the displaced instanced grid of the reference.

A numpy copy of ``gfx_ocean_tpu/render/mesh.py`` (the port cannot import
the JAX package); ``tests/test_torch_render.py`` proves it equal.

Replicates ``src/render.rs``:
- vertex grid: HALF_RESOLUTION^2 vertices at (x, 0, z), UV in [0, 1]
  normalized by (HALF_RESOLUTION - 1) (``:473-516``);
- index buffer: 2 triangles per cell, 6*(H-1)^2 u32 indices (``:561-605``);
- 4 patch instances offset by 0 / (H-1) on x/z (``:518-559``) — the
  instanced draw at ``:1360`` becomes a vertex-array tile here.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class GridMesh(NamedTuple):
    positions: np.ndarray  # (V, 3) f32 — object-space (x, 0, z)
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (T, 3) u32
    patch_offsets: np.ndarray  # (P, 2) f32 — instance offsets (x, z)


def build_grid(half_resolution: int = 128, num_patches: int = 4) -> GridMesh:
    h = half_resolution
    x = np.arange(h, dtype=np.float32)
    z = np.arange(h, dtype=np.float32)
    zz, xx = np.meshgrid(z, x, indexing="ij")  # vertex index = z*h + x
    positions = np.stack([xx, np.zeros_like(xx), zz], axis=-1).reshape(-1, 3)
    uvs = np.stack([xx / (h - 1), zz / (h - 1)], axis=-1).reshape(-1, 2).astype(np.float32)

    # indices: for each cell (z, x): (z*h+x, (z+1)*h+x, z*h+x+1),
    #          (z*h+x+1, (z+1)*h+x, (z+1)*h+x+1)   (src/render.rs:586-595)
    cz, cx = np.meshgrid(np.arange(h - 1), np.arange(h - 1), indexing="ij")
    a = (cz * h + cx).reshape(-1)
    b = ((cz + 1) * h + cx).reshape(-1)
    c = (cz * h + cx + 1).reshape(-1)
    d = ((cz + 1) * h + cx + 1).reshape(-1)
    tris = np.concatenate([
        np.stack([a, b, c], axis=-1),
        np.stack([c, b, d], axis=-1),
    ], axis=0).astype(np.uint32)

    # patch offsets (src/render.rs:544-556): (0,0), (h-1,0), (0,h-1), (h-1,h-1)
    all_offsets = np.array([[0, 0], [h - 1, 0], [0, h - 1], [h - 1, h - 1]],
                           dtype=np.float32)
    return GridMesh(positions.astype(np.float32), uvs, tris,
                    all_offsets[:num_patches])


def instantiate(mesh: GridMesh) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand instances into one flat vertex/index set.

    Returns (positions (P*V, 3), uvs (P*V, 2), tris (P*T, 3)).
    """
    p = mesh.patch_offsets.shape[0]
    v = mesh.positions.shape[0]
    offs = np.zeros((p, 1, 3), dtype=np.float32)
    offs[:, 0, 0] = mesh.patch_offsets[:, 0]
    offs[:, 0, 2] = mesh.patch_offsets[:, 1]
    positions = (mesh.positions[None] + offs).reshape(-1, 3)
    uvs = np.tile(mesh.uvs, (p, 1))
    tris = np.concatenate([mesh.indices + i * v for i in range(p)], axis=0)
    return positions, uvs, tris
