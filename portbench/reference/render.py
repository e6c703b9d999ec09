"""The reference frame: gfx-ocean's displaced grid mesh drawn with the
window rasterizer and the stylized water shading, in plain PyTorch.

A frozen copy of the port's window rasterizer (the JAX package's golden
reference for its pool rasterizer) and of its shading, cut to what one
(N, N, 3) displacement map, the grid mesh and the default visual scales
need (no cascades, foam, bands or triangle lists). The pool rasterizer that
the program times (slot tables, kernel K7, the sort-based resolve with
kernel K8, the giant pass) resolves the same visibility keys a different
way; this file shares none of that code.

- Vertex stage (``shader/ocean.vert``): the map sampled at the mesh's
  static UVs by two bilinear products (float64 products, float32 out),
  visual scales 1/3.5, 1/3, 1/3.5, projection, clip y negated.
- Visibility: every fully-in-front triangle gets ``samples``^2 samples that
  walk row-major through its tight pixel-centre bbox; homogeneous edge
  tests; the key (NDC z quantized into the high bits, the triangle id in
  the low ones) is min-scattered into the image. Triangles whose bbox
  exceeds the samples, and those crossing the eye plane, are tested
  against every pixel, 32 at a time (the giant pass).
- Shading (``shader/ocean.frag``): normals from +-1-texel height taps
  rounded through float16, depth-ramp albedo, Schlick Fresnel, fixed light;
  clear colour 0.6; sRGB as gamma 1/2.2, x255, truncated to uint8.
"""

from __future__ import annotations

import numpy as np
import torch

KEY_MAX = 0xFFFFFFFF
GIANT_GROUP = 32
TRI_CHUNK = 4096
MIN_Z_BITS = 12

SHALLOW = (0.0, 0.86, 0.79)
DEEP = (0.03, 0.08, 0.18)
F0 = (0.04, 0.04, 0.07)
LIGHT_DIR = tuple(np.array([1.0, 0.2, 0.0], dtype=np.float32) / np.linalg.norm([1.0, 0.2, 0.0]))
CLEAR_COLOR = (0.6, 0.6, 0.6)


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([float(np.float32(v)) for v in values], dtype=torch.float32,
                        device=like.device)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as one IEEE division (a Python divisor becomes a reciprocal
    multiply on CUDA)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalize(v):
    return v / torch.sqrt(_dot3(v, v))[..., None]


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _matmul64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() @ b.double()).to(torch.float32)


def grid_mesh(h: int, patches: int, device):
    """``src/render.rs:473-605``: h^2 vertices at (x, 0, z) a patch, uv =
    (x, z) / (h - 1), two triangles a cell ((a, b, c) for every cell, then
    (c, b, d)), patches offset by (h - 1) on x, then z. Returns positions
    (P h^2, 3), tris (P T, 3) int64."""
    x = np.arange(h, dtype=np.float32)
    zz, xx = np.meshgrid(x, x, indexing="ij")
    pos = np.stack([xx, np.zeros_like(xx), zz], axis=-1).reshape(-1, 3)
    cz, cx = np.meshgrid(np.arange(h - 1), np.arange(h - 1), indexing="ij")
    a = (cz * h + cx).reshape(-1)
    b = ((cz + 1) * h + cx).reshape(-1)
    c = (cz * h + cx + 1).reshape(-1)
    d = ((cz + 1) * h + cx + 1).reshape(-1)
    tris = np.concatenate([np.stack([a, b, c], -1), np.stack([c, b, d], -1)]).astype(np.int64)
    offsets = np.array([[0, 0], [h - 1, 0], [0, h - 1], [h - 1, h - 1]],
                       dtype=np.float32)[:patches]
    positions = np.concatenate([pos + np.array([o[0], 0.0, o[1]], dtype=np.float32)
                                for o in offsets])
    all_tris = np.concatenate([tris + i * h * h for i in range(patches)])
    return torch.from_numpy(positions).to(device), torch.from_numpy(all_tris).to(device)


def _interp_matrix(h: int, n: int, device) -> torch.Tensor:
    """(h, N) bilinear weights of the mesh's static uv = k / (h - 1) on an
    N-texel axis, repeat wrap, texel centres at (i + 0.5) / N."""
    u = np.arange(h, dtype=np.float64) / (h - 1)
    x = u * n - 0.5
    x0 = np.floor(x)
    fx = (x - x0).astype(np.float32)
    x0i = np.mod(x0.astype(np.int64), n)
    w = np.zeros((h, n), dtype=np.float32)
    rows = np.arange(h)
    w[rows, x0i] += 1.0 - fx
    w[rows, np.mod(x0i + 1, n)] += fx
    return torch.from_numpy(w).to(device)


def _vertex_stage(disp, positions, view_proj, h: int):
    """Displace, offset and project the mesh: (world (V, 3), clip (V, 4))."""
    w = _interp_matrix(h, disp.shape[0], disp.device)
    tmp = _matmul64(w, disp)                                   # (N_y, h_x, 3): along x
    g = _matmul64(w, tmp.reshape(tmp.shape[0], -1))            # (h_y, h_x * 3): along y
    sampled = g.reshape(h * h, 3).repeat(positions.shape[0] // (h * h), 1)
    world = positions + sampled * _vec((1.0 / 3.5, 1.0 / 3.0, 1.0 / 3.5), sampled)
    ones = torch.ones((world.shape[0], 1), dtype=world.dtype, device=world.device)
    clip = _matmul64(torch.cat([world, ones], dim=-1), view_proj.T)
    return world, clip * _vec((1.0, -1.0, 1.0, 1.0), clip)


def _tri_corners(v: torch.Tensor, patches: int, h: int) -> torch.Tensor:
    """``v[tris]`` for the grid mesh, as shifted slices of the (P, h, h, C)
    vertex grid: (T, 3, C)."""
    c = v.shape[-1]
    g = v.reshape(patches, h, h, c)
    ga, gb, gc, gd = g[:, :-1, :-1], g[:, 1:, :-1], g[:, :-1, 1:], g[:, 1:, 1:]
    t1 = torch.stack([ga, gb, gc], dim=3).reshape(patches, -1, 3, c)
    t2 = torch.stack([gc, gb, gd], dim=3).reshape(patches, -1, 3, c)
    return torch.cat([t1, t2], dim=1).reshape(-1, 3, c)


def _edge_coeffs(v_clip):
    """Sign(det)-folded homogeneous edge coefficients over clip (x, y, w):
    lam_i(p) = cr_i . (pnx, pny, 1); a pixel is hit when every lam_i >= 0
    and their sum > 0."""
    v3 = v_clip[..., (0, 1, 3)]
    cr = _cross(v3[..., (1, 2, 0), :], v3[..., (2, 0, 1), :])
    det = (cr[..., 0, 0] * v3[..., 0, 0] + cr[..., 0, 1] * v3[..., 0, 1]
           + cr[..., 0, 2] * v3[..., 0, 2])
    return cr * torch.sign(det)[..., None, None]


def _lambdas(v_clip, pnx, pny, pix_dims: int):
    cr = _edge_coeffs(v_clip)
    shape = cr.shape[:-2] + (1,) * pix_dims
    return [cr[..., i, 0].reshape(shape) * pnx + cr[..., i, 1].reshape(shape) * pny
            + cr[..., i, 2].reshape(shape) for i in range(3)]


def _depth(lam, v, view_dims: tuple):
    """Perspective-correct NDC z of the edge weights ``lam``."""
    def corner(i, a):
        return v[(slice(None),) + (None,) * len(view_dims) + (i, a)]

    lam_w = lam[0] * corner(0, 3) + lam[1] * corner(1, 3) + lam[2] * corner(2, 3)
    num = lam[0] * corner(0, 2) + lam[1] * corner(1, 2) + lam[2] * corner(2, 2)
    return num / torch.where(lam_w == 0, torch.ones_like(lam_w), lam_w)


def _pixel_ndc(width: int, height: int, device):
    x = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    y = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    return _div(2.0 * (x + 0.5), float(width)) - 1.0, _div(2.0 * (y + 0.5), float(height)) - 1.0


def _pack_key(z, tri_id, hit, id_bits: int) -> torch.Tensor:
    """NDC z over (-1, 1) quantized into the high 32 - id_bits bits
    (clamped below the all-ones miss), the id in the low bits (int64)."""
    z_bits = 32 - id_bits
    top = (1 << z_bits) - 2
    zq = torch.clamp((z * 0.5 + 0.5) * float(1 << z_bits), 0.0, float(top))
    zq = zq.to(torch.int32).clamp_max(top).to(torch.int64)
    key = (zq << id_bits) | tri_id
    return torch.where(hit, key, torch.full_like(key, KEY_MAX))


def _cull(v_clip):
    w = v_clip[..., 3]
    fully_front = (w > 1e-6).all(dim=-1)
    crossing = (w > 1e-6).any(dim=-1) & ~fully_front

    def all_outside(c):
        return (c < -w).all(dim=-1) | (c > w).all(dim=-1)

    outside = (all_outside(v_clip[..., 0]) | all_outside(v_clip[..., 1])
               | all_outside(v_clip[..., 2]))
    return fully_front, crossing, outside


def _window_chunk(keybuf, v, ids, gk, width: int, height: int, id_bits: int) -> None:
    """Min-scatter one chunk's samples into ``keybuf`` ((H W + 1,), the last
    cell a spill)."""
    w = v[..., 3]
    fully_front = (w > 1e-6).all(dim=-1)
    w_safe = torch.where(fully_front[:, None], w, torch.ones_like(w))
    sx = (v[..., 0] / w_safe * 0.5 + 0.5) * float(width)
    sy = (v[..., 1] / w_safe * 0.5 + 0.5) * float(height)
    big = float(1 << 30)
    x_min = torch.clamp(torch.ceil(sx.amin(-1) - 0.5), -big, big).to(torch.int64)[:, None]
    y_min = torch.clamp(torch.ceil(sy.amin(-1) - 0.5), -big, big).to(torch.int64)[:, None]
    x_max = torch.clamp(torch.floor(sx.amax(-1) - 0.5), -big, big).to(torch.int64)[:, None]
    y_max = torch.clamp(torch.floor(sy.amax(-1) - 0.5), -big, big).to(torch.int64)[:, None]
    bw = (x_max - x_min + 1).clamp_min(1)
    px = x_min + gk % bw
    py = y_min + gk // bw
    on_screen = ((px >= 0) & (px < width) & (py >= 0) & (py < height)
                 & (px <= x_max) & (py <= y_max))
    pnx = _div(2.0 * (px.to(torch.float32) + 0.5), float(width)) - 1.0
    pny = _div(2.0 * (py.to(torch.float32) + 0.5), float(height)) - 1.0
    lam = _lambdas(v, pnx, pny, 1)
    mask = ((lam[0] >= 0) & (lam[1] >= 0) & (lam[2] >= 0) & (lam[0] + lam[1] + lam[2] > 0)
            & on_screen & fully_front[:, None])
    z = _depth(lam, v, (None,))
    mask = mask & (z > -1.0) & (z < 1.0)
    key = _pack_key(z, ids[:, None], mask, id_bits)
    flat = torch.where(mask, py * width + px, torch.full_like(px, width * height))
    keybuf.scatter_reduce_(0, flat.reshape(-1), key.reshape(-1), "amin")


def _giant_score(v_clip, width: int, height: int, budget: int) -> torch.Tensor:
    """inf for a visible eye-plane-crossing triangle, the floor-aligned
    screen bbox area where it exceeds ``budget`` samples of a visible
    in-front triangle, else -1."""
    aw = v_clip[..., 3]
    fully_front, crossing, outside = _cull(v_clip)
    aw_safe = torch.where(fully_front[:, None], aw, torch.ones_like(aw))
    asx = (v_clip[..., 0] / aw_safe * 0.5 + 0.5) * float(width)
    asy = (v_clip[..., 1] / aw_safe * 0.5 + 0.5) * float(height)
    area = ((torch.floor(asx.amax(-1)) - torch.floor(asx.amin(-1)) + 1.0)
            * (torch.floor(asy.amax(-1)) - torch.floor(asy.amin(-1)) + 1.0))
    overlaps = ((asx.amax(-1) >= 0) & (asx.amin(-1) < width)
                & (asy.amax(-1) >= 0) & (asy.amin(-1) < height))
    return torch.where(
        crossing & ~outside, torch.full_like(area, float("inf")),
        torch.where(fully_front & ~outside & overlaps & (area > budget), area,
                    torch.full_like(area, -1.0)))


def _giant_pass(v_all, score, key_img, width: int, height: int, giants: int, id_bits: int):
    """Test the ``giants`` highest-scored triangles (ties to the lower id)
    against every pixel, 32 at a time; bbox-limited unless crossing."""
    k = min(giants, score.shape[0])
    ix = torch.sort(score, descending=True, stable=True).indices[:k]
    active = int((score[ix] > 0).sum())
    dev = key_img.device
    pnx, pny = _pixel_ndc(width, height, dev)
    jx = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    jy = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    for g0 in range(0, active, GIANT_GROUP):
        gi = ix[g0:min(g0 + GIANT_GROUP, active)]
        v = v_all[gi]
        lam = _lambdas(v, pnx[None], pny[None], 2)
        hit = (lam[0] >= 0) & (lam[1] >= 0) & (lam[2] >= 0) & (lam[0] + lam[1] + lam[2] > 0)
        wv = v[..., 3]
        sx = (v[..., 0] / wv * 0.5 + 0.5) * float(width)
        sy = (v[..., 1] / wv * 0.5 + 0.5) * float(height)
        in_box = ((jx >= torch.ceil(sx.amin(-1) - 0.5)[:, None, None])
                  & (jx <= torch.floor(sx.amax(-1) - 0.5)[:, None, None])
                  & (jy >= torch.ceil(sy.amin(-1) - 0.5)[:, None, None])
                  & (jy <= torch.floor(sy.amax(-1) - 0.5)[:, None, None]))
        hit = hit & (torch.isinf(score[gi])[:, None, None] | in_box)
        z = _depth(lam, v, (None, None))
        hit = hit & (z > -1.0) & (z < 1.0)
        key = _pack_key(z, gi[:, None, None], hit, id_bits)
        key_img = torch.minimum(key_img, key.amin(dim=0))
    return key_img


def _bilerp_f16(planes, u, v):
    """Bilinear samples (repeat wrap, texel centres at (i + 0.5) / N) of
    each (N, N) plane, every tap rounded through float16."""
    n_y, n_x = planes[0].shape
    x = u * n_x - 0.5
    y = v * n_y - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i = torch.remainder(x0.to(torch.int64), n_x)
    y0i = torch.remainder(y0.to(torch.int64), n_y)
    x1i, y1i = torch.remainder(x0i + 1, n_x), torch.remainder(y0i + 1, n_y)
    out = []
    for plane in planes:
        p = plane.to(torch.float16).to(torch.float32)
        out.append((p[y0i, x0i] * (1 - fx) + p[y0i, x1i] * fx) * (1 - fy)
                   + (p[y1i, x0i] * (1 - fx) + p[y1i, x1i] * fx) * fy)
    return out


def _shade(disp, u, v, world, camera_pos, height_scale: float = 180.0):
    """``ocean.frag``: max(0.7, N.L) * albedo * (1 - Fresnel)."""
    h = disp[..., 1]
    inv = 1.0 / height_scale
    gx, gz = _bilerp_f16([(torch.roll(h, -1, dims=1) - torch.roll(h, 1, dims=1)) * inv,
                          (torch.roll(h, -1, dims=0) - torch.roll(h, 1, dims=0)) * inv], u, v)
    n_y, n_x = h.shape
    na = _normalize(torch.stack([torch.full_like(gx, -2.0 / n_x), gx, torch.zeros_like(gx)], -1))
    nb = _normalize(torch.stack([torch.zeros_like(gz), gz, torch.full_like(gz, 2.0 / n_y)], -1))
    n = _normalize(_cross(na, nb))
    depth = (1.0 - torch.clamp(_div(world[..., 1] + 10.0, 50.0), 0.0, 1.5) ** 1.2)[..., None]
    albedo = _vec(SHALLOW, u) * (1.0 - depth) + _vec(DEEP, u) * depth
    light = _vec(LIGHT_DIR, u)
    view = _normalize(camera_pos - world)
    h_vec = _normalize(light + view)
    ndotl = torch.clamp(_dot3(n, light), 0.0001, 1.0)
    hdotv = torch.clamp(_dot3(h_vec, view), 0.0, 1.0)
    f0 = _vec(F0, u)
    fres = f0 + (1.0 - f0) * (1.0 - hdotv[..., None]) ** 5.0
    return torch.clamp(ndotl, min=0.7)[..., None] * albedo * (1.0 - fres)


def _deferred_shade(disp, ftab, world_c, key_img, camera_pos, width, height, id_bits, h):
    """Interpolate the winning triangle's varyings at each pixel centre and
    shade; uncovered pixels take the clear colour."""
    covered = key_img != KEY_MAX
    tri = torch.where(covered, key_img & ((1 << id_bits) - 1), torch.zeros_like(key_img))
    pnx, pny = _pixel_ndc(width, height, key_img.device)
    t = ftab.T[:, tri]                                        # (15, H, W)
    wc = world_c.reshape(-1, 9).T[:, tri]                     # (9, H, W)
    lam = [t[3 * i] * pnx + t[3 * i + 1] * pny + t[3 * i + 2] for i in range(3)]
    denom = lam[0] + lam[1] + lam[2]
    inv = 1.0 / torch.where(denom == 0, torch.ones_like(denom), denom)
    # The grid's triangle id -> its cell and corners' uv (see grid_mesh).
    cells = (h - 1) * (h - 1)
    r = tri % (2 * cells)
    s = r // cells
    cell = r - s * cells
    cz, cx = cell // (h - 1), cell % (h - 1)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    dx = torch.stack([s, zero, one], dim=-1)
    dz = torch.stack([zero, one, s], dim=-1)
    uc = _div((cx[..., None] + dx).to(torch.float32), float(h - 1))
    vc = _div((cz[..., None] + dz).to(torch.float32), float(h - 1))
    u = (lam[0] * uc[..., 0] + lam[1] * uc[..., 1] + lam[2] * uc[..., 2]) * inv
    v = (lam[0] * vc[..., 0] + lam[1] * vc[..., 1] + lam[2] * vc[..., 2]) * inv
    world = torch.stack([(lam[0] * wc[a] + lam[1] * wc[3 + a] + lam[2] * wc[6 + a]) * inv
                         for a in range(3)], dim=-1)
    color = _shade(disp, u, v, world, camera_pos)
    return torch.where(covered[..., None], color, _vec(CLEAR_COLOR, color))


def frame(disp: torch.Tensor, view_proj: torch.Tensor, camera_pos: torch.Tensor,
          width: int, height: int, mesh_resolution: int = 128, patches: int = 4,
          samples: int = 32, giants: int = 512) -> torch.Tensor:
    """The (H, W, 3) uint8 sRGB frame of an (N, N, 3) float32 displacement
    map (disp_x, height, disp_z) seen along ``view_proj`` (float32 (4, 4),
    projection @ view) from ``camera_pos``."""
    h = mesh_resolution
    dev = disp.device
    positions, tris = grid_mesh(h, patches, dev)
    world, clip = _vertex_stage(disp, positions, view_proj, h)
    t_count = tris.shape[0]
    id_bits = max(int(t_count - 1).bit_length(), 1)
    if 32 - id_bits < MIN_Z_BITS:
        raise ValueError(f"{t_count} triangles leave fewer than {MIN_Z_BITS} z bits")
    v_all = _tri_corners(clip, patches, h)                    # (T, 3, 4)
    budget = samples * samples
    gk = torch.arange(budget, dtype=torch.int64, device=dev)[None, :]
    ids = torch.arange(t_count, dtype=torch.int64, device=dev)
    keybuf = torch.full((width * height + 1,), KEY_MAX, dtype=torch.int64, device=dev)
    for s in range(0, t_count, TRI_CHUNK):
        _window_chunk(keybuf, v_all[s:s + TRI_CHUNK], ids[s:s + TRI_CHUNK], gk, width, height,
                      id_bits)
    key_img = keybuf[:-1].reshape(height, width)
    score = _giant_score(v_all, width, height, budget)
    key_img = _giant_pass(v_all, score, key_img, width, height, giants, id_bits)
    cr = _edge_coeffs(v_all)
    ftab = torch.cat([cr.reshape(t_count, 9), v_all[..., 2], v_all[..., 3]], dim=1)
    img = _deferred_shade(disp, ftab, _tri_corners(world, patches, h), key_img, camera_pos,
                          width, height, id_bits, h)
    return (torch.clamp(img, 0.0, 1.0) ** (1.0 / 2.2) * 255.0).to(torch.uint8)
