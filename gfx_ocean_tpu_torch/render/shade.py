"""Fragment shading: stylized water of ``shader/ocean.frag``, in PyTorch.

Counterpart of ``gfx_ocean_tpu/render/shade.py`` (all constants cited
there):

- finite-difference normals from +-1-texel height taps with
  height_scale = 180 and diff = 2/dim (``ocean.frag:19, 50-67``);
- depth ramp albedo ``mix(shallow, deep, 1 - clamp((y+10)/50, 0, 1.5)^1.2)``
  (``ocean.frag:22-24, 69-70``);
- Schlick Fresnel with f0 = (0.04, 0.04, 0.07), f90 = 1 (``ocean.frag:28-30,
  83``);
- final color ``max(0.7, NdotL) * albedo * (1 - F)``, fixed light direction
  (1, 0.2, 0) (``ocean.frag:72, 85``), with the opt-in Cook-Torrance lobe
  (``pbr_roughness > 0``) built from the GGX helpers.

The JAX package reads the slope and foam taps through a packed table of
float16 pairs (``_packed_table_bilerp``), a gather-cost device of the
TPU. The packing and its row fold are gone here; the float16 rounding of
every tap stays, so that frames agree with the JAX package's to float32
rounding (without it they drift by up to ~1e-3 of a slope).

Inputs are (...,) pixel tensors. A (C, N, N, 3) cascade stack (with its
per-cascade ``tiles``, ``render/raster._cascade_setup``) shades the
composite surface: the slopes sum over the cascades with the chain rule's
tile factor, and foam is the union of the (C, N, N) per-cascade masks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gfx_ocean_tpu_torch.utils import profiling

SHALLOW = np.array([0.0, 0.86, 0.79], dtype=np.float32)
DEEP = np.array([0.03, 0.08, 0.18], dtype=np.float32)
F0 = np.array([0.04, 0.04, 0.07], dtype=np.float32)
LIGHT_DIR = np.array([1.0, 0.2, 0.0], dtype=np.float32) / np.linalg.norm([1.0, 0.2, 0.0])
HEIGHT_SCALE = 180.0
CLEAR_COLOR = np.array([0.6, 0.6, 0.6], dtype=np.float32)
FOAM_COLOR = np.array([0.92, 0.96, 0.98], dtype=np.float32)


@profiling.counted_cache(maxsize=None)
def _device_const(values: tuple, device: torch.device) -> torch.Tensor:
    """Kept for the process: a frame captured as a CUDA graph
    (``render/raster._StageGraphs``) reads these tensors by address."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """A small float32 vector on ``like``'s device, uploaded once: a fresh
    upload from host memory would make the host wait for the device every
    frame."""
    return _device_const(tuple(float(x) for x in np.asarray(a, np.float32)), like.device)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as one IEEE division on every device. A Python scalar
    divisor would not be: on CUDA PyTorch multiplies by its reciprocal."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over a last axis of 3, summed left to right. A reduction
    kernel could pick its summation order by the tensor's shape; a band of a
    frame must shade exactly as the full frame does."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(_dot3(v, v))[..., None]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, each product and difference rounded once."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _bilerp_taps(u: torch.Tensor, v: torch.Tensor, n_y: int, n_x: int):
    """Wrap-mod texel indices and lerp weights of GL-style bilinear
    sampling (texel centers at (i + 0.5) / N)."""
    x = u * n_x - 0.5
    y = v * n_y - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.remainder(x0.to(torch.int64), n_x)
    y0i = torch.remainder(y0.to(torch.int64), n_y)
    return x0i, y0i, torch.remainder(x0i + 1, n_x), torch.remainder(y0i + 1, n_y), fx, fy


def _sample_bilinear_wrap(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of tex[(y, x), C] at normalized (u, v), repeat wrap
    (the reference sampler: linear filter, Tile wrap, ``src/render.rs:397-398``)."""
    n_y, n_x = tex.shape[0], tex.shape[1]
    x0i, y0i, x1i, y1i, fx, fy = _bilerp_taps(u, v, n_y, n_x)
    fx = fx[..., None]
    fy = fy[..., None]
    t00 = tex[y0i, x0i]
    t10 = tex[y0i, x1i]
    t01 = tex[y1i, x0i]
    t11 = tex[y1i, x1i]
    return ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
            + (t01 * (1 - fx) + t11 * fx) * fy)


def sample_displacement(displacement: torch.Tensor, u, v) -> torch.Tensor:
    """(N, N, 3) displacement texture sampled at (u, v) — ``ocean.vert:21``."""
    return _sample_bilinear_wrap(displacement, u, v)


def _bilerp_f16(planes: Sequence[torch.Tensor], u: torch.Tensor, v: torch.Tensor):
    """Bilinear-sample each (N, N) float32 plane at (u, v), repeat wrap, with
    every tap rounded through float16 as the JAX package's packed table
    rounds it. Returns one lerped tensor per plane (shape of ``u``)."""
    n_y, n_x = planes[0].shape
    x0i, y0i, x1i, y1i, fx, fy = _bilerp_taps(u, v, n_y, n_x)
    out = []
    for plane in planes:
        p = plane.to(torch.float16).to(torch.float32)
        a00, a10 = p[y0i, x0i], p[y0i, x1i]
        a01, a11 = p[y1i, x0i], p[y1i, x1i]
        out.append((a00 * (1 - fx) + a10 * fx) * (1 - fy)
                   + (a01 * (1 - fx) + a11 * fx) * fy)
    return out


def fragment_normals(displacement: torch.Tensor, u, v, channel: int = 1,
                     height_scale: float = HEIGHT_SCALE, tiles=None) -> torch.Tensor:
    """textureOffset +-1 taps on one displacement channel (``ocean.frag:54-67``).

    ``channel`` 1 taps the height (the intended math, default); 0 taps
    disp_x as the reference's ``.x`` does (CompatFlags Q8). The difference
    of the +-1 texel taps equals the bilinear sample of the centered
    difference map, whose slopes are pre-scaled by 1 / height_scale before
    their float16 round.

    A (C, N, N, 3) cascade stack: the composite height is
    sum_c h_c(uv tiles[c]), so its texel-space slope is
    sum_c tiles[c] slope_c(uv tiles[c]) (``tiles`` 1 for each when None).
    """
    inv_scale = 1.0 / height_scale

    def slope_maps(h):
        dxh = (torch.roll(h, -1, dims=1) - torch.roll(h, 1, dims=1)) * inv_scale
        dzh = (torch.roll(h, -1, dims=0) - torch.roll(h, 1, dims=0)) * inv_scale
        return dxh, dzh

    if displacement.ndim == 4:
        tiles = tiles or (1.0,) * displacement.shape[0]
        gx = gz = 0.0
        for c in range(displacement.shape[0]):
            gxc, gzc = _bilerp_f16(slope_maps(displacement[c][..., channel]), u * tiles[c],
                                   v * tiles[c])
            gx = gx + gxc * tiles[c]
            gz = gz + gzc * tiles[c]
        n_y, n_x = displacement.shape[1:3]
    else:
        h = displacement[..., channel]
        n_y, n_x = h.shape
        gx, gz = _bilerp_f16(slope_maps(h), u, v)
    diff_x = 2.0 / n_x
    diff_y = 2.0 / n_y
    na = _normalize(torch.stack([torch.full_like(gx, -diff_x), gx, torch.zeros_like(gx)], -1))
    nb = _normalize(torch.stack([torch.zeros_like(gz), gz, torch.full_like(gz, diff_y)], -1))
    return _normalize(_cross(na, nb))


def g1_schlick(no_x, k):
    """``ocean.frag:31-33``: NoX / (NoX * (1 - k) + k)."""
    return no_x / (no_x * (1.0 - k) + k)


def g_schlick(ndotl, ndotv, roughness):
    """``ocean.frag:35-38``: Smith-Schlick visibility, k = roughness / 2."""
    k = roughness / 2.0
    return g1_schlick(ndotl, k) * g1_schlick(ndotv, k)


def d_ggx(roughness, ndoth):
    """``ocean.frag:40-46``: GGX NDF, alpha = roughness^2 (Frostbite form)."""
    alpha = roughness * roughness
    f = (ndoth * alpha - ndoth) * ndoth + 1.0
    return alpha / (f * f * float(np.float32(np.pi)))


def sample_mask_bilinear(mask: torch.Tensor, u, v) -> torch.Tensor:
    """Bilinear-sample an (N, N) scalar mask with repeat wrap, its taps
    rounded through float16 like the normal taps."""
    return _bilerp_f16([mask], u, v)[0]


def shade_fragments(displacement: torch.Tensor, u, v, world_pos, camera_pos,
                    foam: Optional[torch.Tensor] = None,
                    frag_channel: int = 1,
                    height_scale: float = HEIGHT_SCALE,
                    pbr_roughness: float = 0.0, tiles=None) -> torch.Tensor:
    """Full ``ocean.frag`` color for pixel tensors. Returns (..., 3).

    ``foam`` (optional, beyond the reference): an (N, N) [0, 1] coverage
    mask (``ops/derived.jacobian_foam``), bilinear-sampled and mixed into
    the albedo before lighting; (C, N, N) per-cascade masks, each sampled at
    uv * tiles[c], give the union of their coverage. ``pbr_roughness > 0``
    (opt-in) adds the Cook-Torrance lobe
    ``D_GGX * G_Schlick * F / (4 NoL NoV) * NoL``; 0 leaves the stylized
    color unchanged. ``tiles``: a cascade stack's per-cascade uv factors.
    """
    n = fragment_normals(displacement, u, v, channel=frag_channel,
                         height_scale=height_scale, tiles=tiles)
    depth = 1.0 - torch.clamp(_div(world_pos[..., 1] + 10.0, 50.0), 0.0, 1.5) ** 1.2
    depth = depth[..., None]
    albedo = _const(SHALLOW, u) * (1.0 - depth) + _const(DEEP, u) * depth
    if foam is not None:
        if foam.ndim == 3:      # per-cascade masks: union of coverage
            c_tiles = tiles or (1.0,) * foam.shape[0]
            f = sum(sample_mask_bilinear(foam[c], u * c_tiles[c], v * c_tiles[c])
                    for c in range(foam.shape[0]))
        else:
            f = sample_mask_bilinear(foam, u, v)
        f = torch.clamp(f, 0.0, 1.0)[..., None]
        albedo = albedo * (1.0 - f) + _const(FOAM_COLOR, u) * f

    light = _const(LIGHT_DIR, u)
    cam = torch.as_tensor(camera_pos, dtype=torch.float32, device=u.device)
    view = _normalize(cam - world_pos)
    h_vec = _normalize(light + view)

    ndotl = torch.clamp(_dot3(n, light), 0.0001, 1.0)
    hdotv = torch.clamp(_dot3(h_vec, view), 0.0, 1.0)

    f0 = _const(F0, u)
    fres = f0 + (1.0 - f0) * (1.0 - hdotv[..., None]) ** 5.0
    color = torch.clamp(ndotl, min=0.7)[..., None] * albedo * (1.0 - fres)
    if pbr_roughness > 0.0:
        r = float(np.float32(pbr_roughness))
        ndoth = torch.clamp(_dot3(n, h_vec), 0.0, 1.0)
        ndotv = torch.clamp(_dot3(n, view), 0.0001, 1.0)
        spec = (d_ggx(r, ndoth) * g_schlick(ndotl, ndotv, r)
                / (4.0 * ndotv))[..., None] * fres  # * NoL / NoL cancels
        color = color + spec
    return color
