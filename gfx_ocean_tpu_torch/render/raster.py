"""The rasterizers in PyTorch, with kernels K7, K8 and K9 on the card.

Counterpart of ``gfx_ocean_tpu/render/raster.py``. The pool rasterizer
(``impl="pool"``, the fast path): vertex displacement and projection with
the reference's clip-space y negation, exact-area slot allocation in
4x2-pixel oct tiles, a sort-based visibility resolve of packed (quantized
z << id_bits | triangle id) keys, the giant pass for eye-plane-crossing and
pool-overflow triangles, and deferred shading from the winning triangle id.
Clear color (0.6, 0.6, 0.6).

The window rasterizer (``impl="window"``, ``_rasterize``; the JAX
package's golden reference for the pool path): every fully-in-front
triangle gets ``samples``^2 samples that walk row-major through its tight
pixel-centre bbox, in chunks of ``_TRI_CHUNK`` triangles; the same edge
tests and ``_pack_key`` decide coverage, and one ``scatter_reduce_``
("amin", int64 keys: order-independent, so deterministic) into an image
with an out-of-screen spill cell resolves visibility. Triangles whose bbox
exceeds the budget, and eye-plane-crossing ones, go to the same giant pass
and deferred shading as the pool path. The scatter is XLA code in the JAX
package, not a Pallas kernel, so its counterpart is a PyTorch op.

Meshes: the standard grid (``grid_shape = (patches, h)``: triangle corners
as shifted slices, uv decoded from the id) or any (T, 3) triangle list
(``grid_shape=None``: corners gathered, uv corners carried in the deferred
table), on both rasterizers.

Three stages are kernels written by hand for Hopper (``csrc/raster.cu``):

- K7, the slot stage (``slot_stage``; replaces ``_slot_kernel``): for each
  pool slot, decode its row of the packed slot table, evaluate the 8 oct
  pixels' edge, denominator and z tests and emit the packed key rows
  (``_zq_pack_rows``) and the oct id;
- K8, the segmented min (``segmin_stage``; replaces ``_segmin_kernel``):
  the component-wise prefix min over oct-sorted runs and the compaction key,
  in one launch: a single-pass scan over 1024-entry tiles whose run carry
  crosses tiles by decoupled look-back;
- K9, the giant pass (``giant_stage``; the JAX package's ``lax.while_loop``
  of jnp ops over 32-triangle groups, ``_giant_pass``): every active
  candidate edge-tested against the image's pixels and merged into the key
  image in one launch, with tile-local candidate lists.

Each has its plain PyTorch version beside it (``slot_stage_reference``,
``segmin_stage_reference``, ``giant_pass_reference``). CPU tensors take the
plain version; CUDA tensors launch the kernel or raise. The kernels and
their plain versions agree bit for bit on the card: integer arithmetic, and
float products, sums and divisions each rounded once (no FMA contraction,
no reciprocal multiply; see ``shade._div``).

Keys. Visibility keys are uint32 in the JAX package. PyTorch has almost
no uint32 kernels on CUDA, so the key image and the plain versions carry
them as int64 values in [0, 2^32), and the packed rows that cross a kernel
boundary travel as their uint32 bit patterns in int32 tensors
(``_u32_bits`` / ``_u32_value``).

What differs from the JAX package, and why:
- ``_prefix_sum_mxu`` (a triangular matmul, a TPU device) is
  ``torch.cumsum`` in int64 with the same clamp at 2^31 - 65536;
- ``lax.sort`` with payload operands is ``torch.sort`` of the key and an
  index gather of the payload; the area sort is stable, as JAX's is;
- ``lax.top_k`` is a stable descending sort, so ties keep the lower index;
- the giant pass's ``lax.while_loop`` over the active 32-triangle groups
  is one launch of K9 over every group of the selection, which skips the
  inactive candidates: nothing is read to the host;
- ``make_batch_renderer`` and ``render_frames`` are Python loops over frames.

CUDA graphs. No stage after the step reads a device value to the host, so
on the card the frame renderers (``_frame_fn``) replay those stages as
CUDA graphs (``_StageGraphs``), one a stage span, in place of ~300 eager
launches a frame: each (device, band, input shapes) is rendered eagerly on
its first call, which then captures the graphs.

Cascade stacks (beyond the reference, as in the JAX package): a (C, N, N, 3)
displacement is composited as the sum of its cascades, cascade c sampled at
uv * tiles[c] with repeat wrap, tiles[c] = domains[0] / domains[c]
(``_cascade_setup``); fragment normals take the chain rule's tile factor and
foam the union of the per-cascade masks (``render/shade.py``). K7, K8 and
K9 see only the composited frame's tables.

Band-parallel frames across a mesh (``parallel/render.py``) run the frame
renderer's body with its band parameters (``_frame_fn``): each band is
rendered from the rows ``y_origin`` of the full viewport, bit-equal to
those rows of the single-device frame.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from gfx_ocean_tpu_torch import kernels
from gfx_ocean_tpu_torch.ops.fft import full_matmul
from gfx_ocean_tpu_torch.render import shade as sh
from gfx_ocean_tpu_torch.render.camera import Camera, perspective
from gfx_ocean_tpu_torch.render.mesh import build_grid, instantiate
from gfx_ocean_tpu_torch.utils import profiling

KEY_MAX = 0xFFFFFFFF     # the no-hit key (all ones)
_GIANT_GROUP = 32        # giant-pass triangles per group
_OCT_W = 4               # oct tile width in pixels
_OCT_H = 2               # oct tile height in pixels
_MIN_Z_BITS = 12
_SLOT_ROWS = 19          # 15 edge-table rows (f32 bits) + start, xy, bw|id, xy1
_TRI_CHUNK = 4096        # window-rasterizer triangles a scatter chunk


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their uint32 bit patterns as int32."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _u32_value(x: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns held in int32 -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & KEY_MAX


def _vertex_stage(displacement, positions, uvs, view_proj, interp=None,
                  height_div: float = 3.0, horiz_div: float = 3.5, tiles=None):
    """``shader/ocean.vert``: displace, offset, project, negate clip y.

    With ``interp`` = (Wy, Wx) (``_interp_matrices``) the displacement is
    sampled at the static mesh UVs by two products (x first, then y);
    without it, by the bilinear gather. These products and the projection
    are ``ops/fft.full_matmul`` (float64 products on the card), whatever
    the process's TF32 setting: clip coordinates quantized to TF32 break
    the homogeneous edge tests into pixel speckle.

    A (C, N, N, 3) cascade stack displaces by the sum of its cascades,
    cascade c sampled at uv * tiles[c] (``interp`` then holds one pair a
    cascade; without it ``tiles`` defaults to 1 for each).
    """
    cascades = displacement.ndim == 4
    if interp is not None:
        pairs = interp if cascades else (interp,)
        stacks = displacement if cascades else (displacement,)
        grid = None
        for c, (w_y, w_x) in enumerate(pairs):
            h = w_y.shape[0]
            tmp = full_matmul(w_x, stacks[c])                   # (n, x, 3)
            g = full_matmul(w_y, tmp.reshape(tmp.shape[0], -1)).reshape(h, h, -1)
            grid = g if grid is None else grid + g
        disp = grid.reshape(h * h, 3).repeat(positions.shape[0] // (h * h), 1)
    elif cascades:
        tiles = tiles or (1.0,) * displacement.shape[0]
        disp = sum(sh.sample_displacement(displacement[c], uvs[:, 0] * tiles[c],
                                          uvs[:, 1] * tiles[c])
                   for c in range(displacement.shape[0]))
    else:
        disp = sh.sample_displacement(displacement, uvs[:, 0], uvs[:, 1])
    # the ocean.vert:22-23 visual scales
    scale = sh._const([1.0 / horiz_div, 1.0 / height_div, 1.0 / horiz_div], disp)
    world = positions + disp * scale
    ones = torch.ones((world.shape[0], 1), dtype=world.dtype, device=world.device)
    clip = full_matmul(torch.cat([world, ones], dim=-1), view_proj.T)
    return world, clip * sh._const([1.0, -1.0, 1.0, 1.0], clip)  # ocean.vert:27


@functools.lru_cache(maxsize=32)
def _interp_matrices_np(mesh_resolution: int, n_tex: int, tile: float = 1.0) -> np.ndarray:
    """Bilinear sampling matrix (h, N) for the static mesh UV grid at
    u = tile k / (h - 1), float32 from float64
    (``gfx_ocean_tpu/render/raster.py:137-170``); Wy = Wx. ``tile`` > 1 is a
    cascade's compositing factor (repeat wrap tiles the texture). Divide,
    then multiply: tile 1.0 is bit-identical to no tile."""
    h = mesh_resolution
    u = np.arange(h, dtype=np.float64) / (h - 1) * float(tile)
    x = u * n_tex - 0.5
    x0 = np.floor(x)
    fx = (x - x0).astype(np.float32)
    x0i = np.mod(x0.astype(np.int64), n_tex)
    x1i = np.mod(x0i + 1, n_tex)
    w = np.zeros((h, n_tex), dtype=np.float32)
    rows = np.arange(h)
    w[rows, x0i] += 1.0 - fx
    w[rows, x1i] += fx
    return w


@profiling.counted_cache(maxsize=16)
def _interp_matrices(mesh_resolution: int, n_tex: int, device: torch.device,
                     tile: float = 1.0):
    """(Wy, Wx) on ``device``, uploaded once per (mesh, texture, device, tile)."""
    w = torch.from_numpy(_interp_matrices_np(mesh_resolution, n_tex, tile)).to(device)
    return w, w


def _cascade_setup(displacement: torch.Tensor, cascade_domains, mesh_resolution: int,
                   device: torch.device):
    """(tiles, interp) for an (N, N, 3) field (tiles None) or a (C, N, N, 3)
    cascade stack: tiles[c] = domain[0] / domain[c], how many times cascade
    c's domain repeats across the patch, and one ``_interp_matrices`` pair a
    cascade. Raises ``ValueError`` when a stack lacks ``cascade_domains`` of
    length C."""
    n_tex = displacement.shape[-2]
    if displacement.ndim == 3:
        return None, _interp_matrices(mesh_resolution, n_tex, device)
    c_count = displacement.shape[0]
    if cascade_domains is None or len(cascade_domains) != c_count:
        raise ValueError(
            f"a (C, N, N, 3) cascade stack needs cascade_domains of "
            f"length {c_count}, got {cascade_domains!r}")
    tiles = tuple(float(cascade_domains[0] / d) for d in cascade_domains)
    return tiles, tuple(_interp_matrices(mesh_resolution, n_tex, device, t) for t in tiles)


@profiling.counted_cache(maxsize=8)
def _mesh_constants(mesh_resolution: int, num_patches: int, device: torch.device):
    """Mesh build and upload, once per (mesh, patches, device):
    positions (V, 3) f32, uvs (V, 2) f32, tris (T, 3) int64."""
    positions, uvs, tris = instantiate(build_grid(mesh_resolution, num_patches))
    return (torch.from_numpy(positions).to(device), torch.from_numpy(uvs).to(device),
            torch.from_numpy(tris.astype(np.int64)).to(device))


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum, exact in int64, clamped below int32's
    top as ``_prefix_sum_mxu`` clamps it (every consumer compares it with
    pool-sized values only)."""
    return torch.cumsum(x.to(torch.int64), 0).clamp_max(2 ** 31 - 65536).to(torch.int32)


def _tri_corners(clip, tris, grid_shape=None):
    """``clip[tris]`` as shifted slices of the (P, h, h, C) vertex grid for
    the standard grid mesh (per patch, every cell's (a, b, c) triangle
    row-major, then every (c, b, d))."""
    if grid_shape is None:
        return clip[tris]
    p, h = grid_shape
    c = clip.shape[-1]
    g = clip.reshape(p, h, h, c)
    ga, gb = g[:, :-1, :-1], g[:, 1:, :-1]
    gc, gd = g[:, :-1, 1:], g[:, 1:, 1:]
    t1 = torch.stack([ga, gb, gc], dim=3).reshape(p, -1, 3, c)
    t2 = torch.stack([gc, gb, gd], dim=3).reshape(p, -1, 3, c)
    return torch.cat([t1, t2], dim=1).reshape(-1, 3, c)


def _edge_coeffs(v_clip):
    """Sign(det)-folded homogeneous edge coefficients of a triangle batch:
    (cr (..., 3, 3), det). lam_i(p) = cr_i . (pnx, pny, 1) over clip
    (x, y, w); det = (v1 x v2) . v0. With the fold, the hit test is
    ``all lam_i >= 0 and sum lam_i > 0`` in every pass."""
    # Slices and rolls, not tuple indices: a tuple index is uploaded to the
    # card as an index tensor at every call, which no CUDA graph can hold.
    v3 = torch.cat([v_clip[..., 0:2], v_clip[..., 3:4]], dim=-1)     # (x, y, w)
    cr = sh._cross(torch.roll(v3, -1, dims=-2), torch.roll(v3, 1, dims=-2))  # corners i+1, i+2
    det = (cr[..., 0, 0] * v3[..., 0, 0] + cr[..., 0, 1] * v3[..., 0, 1]
           + cr[..., 0, 2] * v3[..., 0, 2])
    return cr * torch.sign(det)[..., None, None], det


def _lambdas(v_clip, pnx, pny, pix_dims: int):
    """Edge functions of a (..., 3, 4) triangle batch at pixel-center NDC
    (``pix_dims`` trailing pixel dims): (lam0, lam1, lam2, det)."""
    cr, det = _edge_coeffs(v_clip)
    shape = cr.shape[:-2] + (1,) * pix_dims

    def ev(i):
        return (cr[..., i, 0].reshape(shape) * pnx + cr[..., i, 1].reshape(shape) * pny
                + cr[..., i, 2].reshape(shape))

    return ev(0), ev(1), ev(2), det


def _pixel_ndc(width: int, height: int, device, y_origin: int = 0,
               full_height: Optional[int] = None):
    """Pixel-center NDC rows (1, W) and (H, 1). With ``y_origin`` /
    ``full_height`` the image is a horizontal band of a ``full_height``-row
    viewport: local row j samples the NDC of global row ``y_origin + j``
    bit for bit (integer adds are exact)."""
    full_height = height if full_height is None else full_height
    x = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    pnx = sh._div(2.0 * (x + 0.5), float(width)) - 1.0
    gy = (torch.arange(height, dtype=torch.int32, device=device) + y_origin).to(torch.float32)
    pny = sh._div(2.0 * (gy[:, None] + 0.5), float(full_height)) - 1.0
    return pnx, pny


def _id_bits(t_count: int) -> int:
    """Bits of the triangle id in the packed visibility key (17 at the
    production 128^2 x 4 mesh, leaving 15 z bits). Raises when fewer than
    ``_MIN_Z_BITS`` z bits would be left."""
    bits = max(int(t_count - 1).bit_length(), 1)
    if 32 - bits < _MIN_Z_BITS:
        raise ValueError(
            f"{t_count} triangles need {bits} id bits, leaving "
            f"{32 - bits} z bits in the packed visibility key "
            f"(minimum {_MIN_Z_BITS}); use a mesh with at most "
            f"2^{32 - _MIN_Z_BITS} triangles")
    return bits


def _pack_key(z, tri_id, hit, id_bits: int) -> torch.Tensor:
    """(z, id) -> visibility key (int64 in [0, 2^32)): NDC z quantized
    over (-1, 1) into the high ``32 - id_bits`` bits (integer-clamped to
    2^z_bits - 2, so a hit never aliases ``KEY_MAX``), the id in the low
    bits; a min over keys is the z-buffer with ties to the smaller id."""
    z_bits = 32 - id_bits
    top = (1 << z_bits) - 2
    zq = torch.clamp((z * 0.5 + 0.5) * float(1 << z_bits), 0.0, float(top))
    zq = zq.to(torch.int32).clamp_max(top).to(torch.int64)
    key = (zq << id_bits) | tri_id
    return torch.where(hit, key, torch.full_like(key, KEY_MAX))


def _zq_key_rows(id_bits: int) -> int:
    """Rows of the packed per-slot payload: 5 when the z field fits 16
    bits (pixels 1..7 two to a word), else 8."""
    return 5 if 32 - id_bits <= 16 else 8


def _zq_pack_rows(key, tri_id, id_bits: int) -> torch.Tensor:
    """An oct entry's 8 keys (8, n) sharing one triangle id (1, n) ->
    ``_zq_key_rows`` packed rows (int64 values): row 0 = pixel 0's full
    key layout, then pixels 1..7's z fields only. A miss's z field is all
    ones, which ``_zq_unpack_keys`` maps back to ``KEY_MAX``."""
    z_bits = 32 - id_bits
    zqp = key >> id_bits
    rows = [(zqp[0:1] << id_bits) | tri_id]
    if z_bits <= 16:
        for k in range(1, 8, 2):
            hi = zqp[k + 1:k + 2] if k + 1 < 8 else torch.zeros_like(zqp[0:1])
            rows.append(zqp[k:k + 1] | (hi << 16))
    else:
        rows += [zqp[k:k + 1] for k in range(1, 8)]
    return torch.cat(rows, dim=0)


def _zq_unpack_keys(cols, id_bits: int) -> torch.Tensor:
    """Bit-exact inverse of ``_zq_pack_rows``: (nk, n) packed rows (int64
    values) -> (8, n) keys; an all-ones z field -> ``KEY_MAX``. Every
    extracted field is masked to z_bits, which maps all-ones sentinel rows
    onto the miss mark too."""
    z_bits = 32 - id_bits
    zmax = (1 << z_bits) - 1
    c0 = cols[0:1]
    tri = c0 & ((1 << id_bits) - 1)
    zq = [c0 >> id_bits]
    if z_bits <= 16:
        for r in range(1, 5):
            c = cols[r:r + 1]
            zq.append(c & zmax)
            zq.append((c >> 16) & zmax)
        zq = zq[:8]
    else:
        zq += [cols[r:r + 1] & zmax for r in range(1, 8)]
    zq = torch.cat(zq, dim=0)
    return torch.where(zq == zmax, torch.full_like(zq, KEY_MAX), (zq << id_bits) | tri)


# --------------------------------------------------------------------------
# K7: the slot stage.
# --------------------------------------------------------------------------

def _stage_scalars(total_covered: torch.Tensor, y_origin: int, device) -> torch.Tensor:
    """(2,) int32 on ``device``: [total_covered, y_origin]. K7 reads both
    from device memory; nothing here waits for the device."""
    yo = torch.full((1,), y_origin, dtype=torch.int32, device=device)
    return torch.cat([total_covered.reshape(1).to(torch.int32), yo])


def slot_stage_reference(crow: torch.Tensor, cov: torch.Tensor, width: int,
                         full_height: int, octs_w: int, spill_oct: int,
                         bw_bits: int, id_bits: int):
    """Plain PyTorch K7: the same math as ``_slot_kernel`` vectorized over
    (8, P). ``crow`` (19, P) int32: rows 0..14 the sign-folded edge table
    as float32 bits, then start, [x0 | y0 << 16 | crossing << 31],
    [qw | id << bw_bits], [x1 | y1 << 16] as uint32 bits. ``cov`` (2,)
    int32: [total_covered, y_origin]. Returns (packed key rows (nk, P) as
    uint32 bits in int32, oct ids (P,) int32); slots at or past
    ``total_covered`` emit all-ones z fields and ``spill_oct``."""
    dev = crow.device
    n_slots = crow.shape[1]
    slot = torch.arange(n_slots, dtype=torch.int64, device=dev)
    valid = slot < cov[0]
    ints = _u32_value(crow[15:])
    st, xy, bwid, xy1 = ints[0], ints[1], ints[2], ints[3]
    px0 = xy & 0xFFFF
    py0 = (xy >> 16) & 0x7FFF
    px1 = xy1 & 0xFFFF
    py1 = (xy1 >> 16) & 0x7FFF
    qw = bwid & ((1 << bw_bits) - 1)
    tri_id = bwid >> bw_bits
    # Row-major walk of the oct bbox: float divide and floor, exact for
    # quotients < 2^24 with >= 1/qw margin to the next integer.
    kf = (slot - st).to(torch.float32)
    qwf = qw.to(torch.float32)
    q = torch.floor(kf / qwf)
    colq = (kf - q * qwf).to(torch.int64)
    ox = (px0 >> 2) + colq
    oy = (py0 >> 1) + q.to(torch.int64)
    f = crow[:15].contiguous().view(torch.float32)
    sub = torch.arange(_OCT_W * _OCT_H, dtype=torch.int64, device=dev)[:, None]
    pxs = ox * _OCT_W + sub % _OCT_W                    # (8, P)
    pys = oy * _OCT_H + sub // _OCT_W
    live = valid & (pxs >= px0) & (pxs <= px1) & (pys >= py0) & (pys <= py1)
    pnx = sh._div(2.0 * (pxs.to(torch.float32) + 0.5), float(width)) - 1.0
    pny = sh._div(2.0 * ((pys + cov[1]).to(torch.float32) + 0.5), float(full_height)) - 1.0
    lam0 = f[0] * pnx + f[1] * pny + f[2]
    lam1 = f[3] * pnx + f[4] * pny + f[5]
    lam2 = f[6] * pnx + f[7] * pny + f[8]
    denom = lam0 + lam1 + lam2
    hit = (lam0 >= 0) & (lam1 >= 0) & (lam2 >= 0) & (denom > 0) & live
    lam_w = lam0 * f[12] + lam1 * f[13] + lam2 * f[14]
    z = (lam0 * f[9] + lam1 * f[10] + lam2 * f[11]) / torch.where(
        lam_w == 0, torch.ones_like(lam_w), lam_w)
    hit = hit & (z > -1.0) & (z < 1.0)
    key = _pack_key(z, tri_id, hit, id_bits)
    keys = _u32_bits(_zq_pack_rows(key, tri_id[None], id_bits))
    octs = torch.where(valid, oy * octs_w + ox, torch.full_like(oy, spill_oct))
    return keys, octs.to(torch.int32)


def launch_slot_kernel(crow: torch.Tensor, cov: torch.Tensor, width: int,
                       full_height: int, octs_w: int, spill_oct: int,
                       bw_bits: int, id_bits: int):
    """Launch K7 (``csrc/raster.cu``, ``slot_kernel``) on the current
    stream; same arguments and results as ``slot_stage_reference``. Counts
    ``launches.launch_slot_kernel`` per launch (``kernels.launch``)."""
    dev = kernels.cuda_device(crow, "launch_slot_kernel")
    n_slots = crow.shape[1] if crow.ndim == 2 else -1
    kernels.check_tensor("crow", crow, torch.int32, (_SLOT_ROWS, n_slots), dev)
    kernels.check_tensor("cov", cov, torch.int32, (2,), dev)
    if not 1 <= id_bits <= 32 - _MIN_Z_BITS or bw_bits != 32 - id_bits:
        raise ValueError(f"id_bits {id_bits} / bw_bits {bw_bits} out of range")
    keys = torch.empty((_zq_key_rows(id_bits), n_slots), dtype=torch.int32, device=dev)
    octs = torch.empty((n_slots,), dtype=torch.int32, device=dev)
    kernels.launch("launch_slot_kernel", "raster", "slot_stage",
                   crow.data_ptr(), cov.data_ptr(), n_slots, width, full_height, octs_w,
                   spill_oct, id_bits, keys.data_ptr(), octs.data_ptr(), device=dev)
    return keys, octs


def slot_stage(crow: torch.Tensor, total_covered: torch.Tensor, width: int,
               full_height: int, octs_w: int, spill_oct: int, bw_bits: int,
               id_bits: int, y_origin=0):
    """K7 over the packed slot table: the kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (packed key rows (nk, P) as uint32
    bits in int32, oct ids (P,) int32)."""
    cov = _stage_scalars(total_covered, y_origin, crow.device)
    args = (crow, cov, width, full_height, octs_w, spill_oct, bw_bits, id_bits)
    if crow.is_cuda:
        return launch_slot_kernel(*args)
    return slot_stage_reference(*args)


# --------------------------------------------------------------------------
# K8: the segmented min over oct runs.
# --------------------------------------------------------------------------

def segmin_stage_reference(so: torch.Tensor, sk: torch.Tensor, n_oct: int, id_bits: int):
    """Plain PyTorch K8: a log-shift segmented min over the whole array.

    ``so`` (n,) int32 run ids, ascending; ``sk`` (nk, n) packed key rows
    (uint32 bits in int32). Returns (mins (8, n) as uint32 bits in int32:
    each entry's component-wise min over its run up to itself, so a run's
    min lands on its last entry; skey (n,) int32: the run id at run-last
    entries, ``n_oct`` elsewhere)."""
    m = _zq_unpack_keys(_u32_value(sk), id_bits)
    n = so.shape[0]
    k = 1
    while k < n:
        same = so[k:] == so[:-k]
        shifted = torch.where(same, m[:, :-k], torch.full_like(m[:, :-k], KEY_MAX))
        m = torch.cat([m[:, :k], torch.minimum(m[:, k:], shifted)], dim=1)
        k *= 2
    run_last = torch.cat([so[1:] != so[:-1], torch.ones(1, dtype=torch.bool, device=so.device)])
    skey = torch.where(run_last, so, torch.full_like(so, n_oct))
    return _u32_bits(m), skey.to(torch.int32)


SEGMIN_TILE = 1024       # entries a tile of K8 (256 threads x 4 consecutive entries)
_EPOCHS = 1 << 30        # K8's flags hold epoch << 2 | state in 32 bits


class _SegminScratch:
    """K8's look-back state on one stream: the tile ticket (left zero by
    every call), the tiles' flags, aggregates and inclusive prefixes, and
    the epoch of the last call. Grows with n; allocated, zeroed, once."""

    def __init__(self, n_tiles: int, device: torch.device):
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.flags = torch.zeros(n_tiles, dtype=torch.int32, device=device)
        self.agg = torch.empty((n_tiles, 8), dtype=torch.int32, device=device)
        self.incl = torch.empty((n_tiles, 8), dtype=torch.int32, device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        """The epoch of a new call: flags of earlier calls never match it."""
        self.epoch += 1
        if self.epoch == _EPOCHS:
            self.flags.zero_()
            self.epoch = 1
        return self.epoch


_SEGMIN_SCRATCH: dict = {}


def _segmin_scratch(n_tiles: int, device: torch.device) -> _SegminScratch:
    """The look-back state of the current stream, with room for n_tiles."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    scratch = _SEGMIN_SCRATCH.get(key)
    if scratch is None or scratch.flags.shape[0] < n_tiles:
        scratch = _SEGMIN_SCRATCH[key] = _SegminScratch(n_tiles, device)
    return scratch


def launch_segmin_kernel(so: torch.Tensor, sk: torch.Tensor, n_oct: int, id_bits: int):
    """Launch K8 (``csrc/raster.cu``: ``segmin_lookback``, one kernel: a
    single-pass segmented min-scan over tiles of ``SEGMIN_TILE`` entries
    with decoupled look-back) on the current stream; same arguments and
    results as ``segmin_stage_reference``. The look-back state is kept per
    stream and device and reused by later calls; a launch captured into a
    CUDA graph has its own, zeroed at each replay. Counts
    ``launches.launch_segmin_kernel`` per launch (``kernels.launch``)."""
    dev = kernels.cuda_device(so, "launch_segmin_kernel")
    if not 1 <= id_bits <= 32 - _MIN_Z_BITS:
        raise ValueError(f"id_bits {id_bits} out of range")
    n = so.shape[0] if so.ndim == 1 else -1
    if n < 1:
        raise ValueError("so: expected a non-empty (n,) tensor")
    kernels.check_tensor("so", so, torch.int32, (n,), dev)
    kernels.check_tensor("sk", sk, torch.int32, (_zq_key_rows(id_bits), n), dev)
    mins = torch.empty((8, n), dtype=torch.int32, device=dev)
    skey = torch.empty((n,), dtype=torch.int32, device=dev)
    if torch.cuda.is_current_stream_capturing():
        # A graph replays the epoch it was captured with, so a captured launch
        # takes look-back state of its own, made and zeroed inside the graph:
        # every replay starts from zero flags and a zero ticket.
        scratch = _SegminScratch(-(-n // SEGMIN_TILE), dev)
    else:
        scratch = _segmin_scratch(-(-n // SEGMIN_TILE), dev)
    kernels.launch("launch_segmin_kernel", "raster", "segmin_stage",
                   so.data_ptr(), sk.data_ptr(), n, id_bits, n_oct, mins.data_ptr(),
                   skey.data_ptr(), scratch.ticket.data_ptr(), scratch.flags.data_ptr(),
                   scratch.agg.data_ptr(), scratch.incl.data_ptr(), scratch.next_epoch(),
                   device=dev)
    return mins, skey


def segmin_stage(so: torch.Tensor, sk: torch.Tensor, n_oct: int, id_bits: int):
    """K8: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if so.is_cuda:
        return launch_segmin_kernel(so, sk, n_oct, id_bits)
    return segmin_stage_reference(so, sk, n_oct, id_bits)


# --------------------------------------------------------------------------
# K9: the giant pass.
# --------------------------------------------------------------------------

def giant_pass_reference(ids, ok, clip, tris, score, key_img, width: int, height: int,
                         full_height: int, y_origin: int, id_bits: int):
    """Plain PyTorch K9: edge-test the giant candidates against every pixel
    of the (H, W) int64 key image (rows from ``y_origin`` of a
    ``full_height``-row viewport), one 32-candidate group at a time,
    merging their keys into it. ``ids`` / ``ok`` (G, 32): the candidates'
    triangle ids and whether each is active (``_giant_selection``'s
    groups); an inactive candidate hits no pixel. Finite-score (pool
    overflow) candidates keep the tight pixel-center bbox mask of the slot
    walk; crossing ones (score inf) have no finite bbox and are tested
    everywhere."""
    dev = key_img.device
    pnx, pny = _pixel_ndc(width, height, dev, y_origin, full_height)
    jx = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    jy = (torch.arange(height, dtype=torch.int32, device=dev) + y_origin).to(torch.float32)
    jy = jy[None, :, None]
    for g in range(ids.shape[0]):
        ix, on = ids[g], ok[g]
        v = clip[tris[ix]]                                  # (32, 3, 4)
        lam0, lam1, lam2, _ = _lambdas(v, pnx[None], pny[None], 2)
        denom = lam0 + lam1 + lam2
        hit = (lam0 >= 0) & (lam1 >= 0) & (lam2 >= 0) & (denom > 0) & on[:, None, None]
        wv = v[..., 3]
        sxg = (v[..., 0] / wv * 0.5 + 0.5) * float(width)
        syg = (v[..., 1] / wv * 0.5 + 0.5) * float(full_height)
        x0g = torch.ceil(sxg.amin(-1) - 0.5)[:, None, None]
        x1g = torch.floor(sxg.amax(-1) - 0.5)[:, None, None]
        y0g = torch.ceil(syg.amin(-1) - 0.5)[:, None, None]
        y1g = torch.floor(syg.amax(-1) - 0.5)[:, None, None]
        in_box = (jx >= x0g) & (jx <= x1g) & (jy >= y0g) & (jy <= y1g)
        hit = hit & (torch.isinf(score[ix])[:, None, None] | in_box)
        lam_w = (lam0 * v[:, None, None, 0, 3] + lam1 * v[:, None, None, 1, 3]
                 + lam2 * v[:, None, None, 2, 3])
        z = (lam0 * v[:, None, None, 0, 2] + lam1 * v[:, None, None, 1, 2]
             + lam2 * v[:, None, None, 2, 2]) / torch.where(
                 lam_w == 0, torch.ones_like(lam_w), lam_w)
        hit = hit & (z > -1.0) & (z < 1.0)
        key = _pack_key(z, ix[:, None, None], hit, id_bits)
        key_img = torch.minimum(key_img, key.amin(dim=0))
    return key_img


def launch_giant_kernel(ids, ok, clip, tris, score, key_img, width: int, height: int,
                        full_height: int, y_origin: int, id_bits: int):
    """Launch K9 (``csrc/raster.cu``, ``giant_kernel``: every active
    candidate merged into the key image in one launch, inactive ones
    skipped, the pixel centres' NDC formed in the kernel) on the current
    stream; same arguments and result as ``giant_pass_reference``, which
    it returns as a new tensor. Counts ``launches.launch_giant_kernel`` per
    launch (``kernels.launch``)."""
    dev = kernels.cuda_device(key_img, "launch_giant_kernel")
    g = ids.shape[0] if ids.ndim == 2 else -1
    if g < 1:
        raise ValueError("ids: expected a non-empty (G, 32) tensor")
    kernels.check_tensor("ids", ids, torch.int64, (g, _GIANT_GROUP), dev)
    kernels.check_tensor("ok", ok, torch.bool, (g, _GIANT_GROUP), dev)
    kernels.check_tensor("clip", clip, torch.float32, (clip.shape[0], 4), dev)
    kernels.check_tensor("tris", tris, torch.int64, (tris.shape[0], 3), dev)
    kernels.check_tensor("score", score, torch.float32, (tris.shape[0],), dev)
    kernels.check_tensor("key_img", key_img, torch.int64, (height, width), dev)
    if not 1 <= id_bits <= 32 - _MIN_Z_BITS:
        raise ValueError(f"id_bits {id_bits} out of range")
    out = torch.empty_like(key_img)
    kernels.launch("launch_giant_kernel", "raster", "giant_pass",
                   ids.data_ptr(), ok.data_ptr(), g * _GIANT_GROUP, score.data_ptr(),
                   clip.data_ptr(), tris.data_ptr(), width, height, full_height, y_origin,
                   id_bits, key_img.data_ptr(), out.data_ptr(), device=dev)
    return out


def giant_stage(ids, ok, clip, tris, score, key_img, width: int, height: int,
                full_height: int, y_origin: int, id_bits: int):
    """K9: the kernel for CUDA tensors, the plain version for CPU tensors.
    On the CPU the groups after the last active one, which change nothing,
    are left out: the active count is read on the host, which waits for
    nothing there."""
    args = (clip, tris, score, key_img, width, height, full_height, y_origin, id_bits)
    if key_img.is_cuda:
        return launch_giant_kernel(ids, ok, *args)
    needed = -(-int(ok.sum()) // _GIANT_GROUP)
    return giant_pass_reference(ids[:needed], ok[:needed], *args)


# --------------------------------------------------------------------------
# The frame around K7, K8 and K9.
# --------------------------------------------------------------------------

def _edge_table(v_clip) -> torch.Tensor:
    """Per-triangle sign-folded edge table (T, 15) f32: [cr00..cr22 (9),
    z0 z1 z2, w0 w1 w2], shared by K7 and the deferred pass."""
    cr, _ = _edge_coeffs(v_clip)
    return torch.cat([cr.reshape(v_clip.shape[0], 9), v_clip[..., 2], v_clip[..., 3]], dim=1)


def _deferred_table(ftab, world, tris, uvs, grid_shape) -> torch.Tensor:
    """One per-triangle float32 table for the deferred pass: [edge table (15)
    | world corners (9) | uv corners (6), only for a mesh that is not the
    standard grid, whose uvs ``_decode_tri`` computes]."""
    wc = _tri_corners(world, tris, grid_shape)
    cols = [ftab, wc.reshape(wc.shape[0], 9)]
    if grid_shape is None:
        cols.append(uvs[tris].reshape(-1, 6))
    return torch.cat(cols, dim=1)


def _decode_tri(id_img, grid_shape):
    """Triangle id -> (vertex ids (..., 3), corner uvs (..., 3, 2)) for the
    standard grid mesh, by integer arithmetic (inverts ``build_grid`` /
    ``instantiate``: per patch all (a, b, c) cell triangles, then all
    (c, b, d); uv = (x, z) / (h - 1))."""
    p_count, h = grid_shape
    cells = (h - 1) * (h - 1)
    tp = 2 * cells
    patch = id_img // tp
    r = id_img - patch * tp
    s = r // cells
    cell = r - s * cells
    cz = cell // (h - 1)
    cx = cell - cz * (h - 1)
    base = patch * (h * h) + cz * h + cx
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    dx = torch.stack([s, zero, one], dim=-1)
    dz = torch.stack([zero, one, s], dim=-1)
    vt = base[..., None] + dz * h + dx
    u = sh._div((cx[..., None] + dx).to(torch.float32), float(h - 1))
    v = sh._div((cz[..., None] + dz).to(torch.float32), float(h - 1))
    return vt, torch.stack([u, v], dim=-1)


def _auto_pool(width: int, height: int, bands: int = 1) -> int:
    """Slot pool (one slot = a 4x2-pixel oct tile): ~0.75 slots per viewport
    pixel, floored at 2^18, rounded up to a multiple of 8192; a band of a
    ``bands``-way split gets a 2x skew margin capped at the full frame's
    (``gfx_ocean_tpu/render/raster.py:902-929``)."""
    want = (3 * width * height + 3) // 4
    if bands > 1:
        want = min(2 * want, (3 * width * height * bands + 3) // 4)
    return max(1 << 18, -(-want // 8192) * 8192)


def _cull(v_clip):
    """(fully_front, crossing, outside) of a (T, 3, 4) triangle batch: every
    vertex in front of the eye plane; some but not all; and outside one
    frustum plane with all three vertices (a conservative cull, valid for
    any w sign)."""
    w = v_clip[..., 3]
    fully_front = (w > 1e-6).all(dim=-1)
    crossing = (w > 1e-6).any(dim=-1) & ~fully_front

    def all_outside(c):
        return (c < -w).all(dim=-1) | (c > w).all(dim=-1)

    outside = all_outside(v_clip[..., 0]) | all_outside(v_clip[..., 1]) | all_outside(v_clip[..., 2])
    return fully_front, crossing, outside


def _oct_bounds(v_clip, width: int, height: int, full_height: int, y_origin: int):
    """Culling and the tight viewport-clamped bbox of a (T, 3, 4) triangle
    batch: (x0, y0, x1, y1 int64 pixels, y in band-local rows; qw, the
    width in oct tiles; area int32 in oct tiles, 0 for triangles that are
    culled or cover no pixel center; crossing, outside)."""
    w = v_clip[..., 3]
    fully_front, crossing, outside = _cull(v_clip)
    # Tight pixel-center bbox [ceil(min - 0.5), floor(max - 0.5)], clamped
    # to the viewport. The bounds are also clamped into int32 range before
    # the cast: JAX's conversion saturates, a C cast does not; only
    # triangles that are not live reach those values.
    w_safe = torch.where(fully_front[:, None], w, torch.ones_like(w))
    sx = (v_clip[..., 0] / w_safe * 0.5 + 0.5) * float(width)
    sy = (v_clip[..., 1] / w_safe * 0.5 + 0.5) * float(full_height)
    big = float(1 << 30)
    yof = float(y_origin)
    x0 = torch.clamp(torch.ceil(sx.amin(-1) - 0.5), 0.0, big).to(torch.int64)
    x1 = torch.clamp(torch.floor(sx.amax(-1) - 0.5), -big, width - 1.0).to(torch.int64)
    y0 = torch.clamp(torch.ceil(sy.amin(-1) - 0.5) - yof, 0.0, big).to(torch.int64)
    y1 = torch.clamp(torch.floor(sy.amax(-1) - 0.5) - yof, -big, height - 1.0).to(torch.int64)
    qw = ((x1 >> 2) - (x0 >> 2) + 1).clamp_min(0)
    qh = ((y1 >> 1) - (y0 >> 1) + 1).clamp_min(0)
    live_tri = fully_front & ~outside & (x1 >= x0) & (y1 >= y0)
    area = torch.where(live_tri, qw * qh, torch.zeros_like(qw)).to(torch.int32)
    return x0, y0, x1, y1, qw, area, crossing, outside


class SlotTables(NamedTuple):
    """What the slot stage and the passes after it need from one frame's
    geometry (``_slot_tables``)."""

    world: torch.Tensor          # (V, 3) displaced vertices
    clip: torch.Tensor           # (V, 4) clip coordinates, y negated
    ftab: torch.Tensor           # (T, 15) edge table, triangle order
    crow: torch.Tensor           # (19, pool) int32 packed slot table
    total_covered: torch.Tensor  # () int32 live slots, <= pool
    score: torch.Tensor          # (T,) giant-pass need: inf crossing, area overflow, else -1
    id_bits: int
    octs_w: int
    octs_h: int


def _slot_tables(displacement, positions, uvs, tris, view_proj, width: int,
                 height: int, pool: int, interp=None, grid_shape=None,
                 scales=(3.0, 3.5, 180.0, 0.0), y_origin: int = 0,
                 full_height: Optional[int] = None, tiles=None) -> SlotTables:
    """Vertex stage, culling, tight viewport-clamped bboxes in oct units,
    the stable area sort, slot ranges by prefix sum and the per-slot row
    gather (``_rasterize_pool`` up to ``_slot_stage``)."""
    full_height = height if full_height is None else full_height
    dev = displacement.device
    world, clip = _vertex_stage(displacement, positions, uvs, view_proj, interp,
                                scales[0], scales[1], tiles)
    t_count = tris.shape[0]
    v_clip = _tri_corners(clip, tris, grid_shape)          # (T, 3, 4)
    x0, y0, x1, y1, qw, area, crossing, outside = _oct_bounds(
        v_clip, width, height, full_height, y_origin)

    id_bits = _id_bits(t_count)
    bw_bits = 32 - id_bits
    if not (width < (1 << 16) and (width + 3) // 4 < (1 << bw_bits) and height < (1 << 15)):
        raise ValueError(
            f"viewport {width}x{height} too wide for the packed slot "
            f"table at this mesh size (enforced: width < {1 << 16}, "
            f"ceil(width/4) < {1 << bw_bits} at {id_bits} id bits, "
            f"height < {1 << 15})")
    crossing_visible = (crossing & ~outside).to(torch.int64)
    pack_xy = (x0.clamp(0, width - 1) | (y0.clamp(0, height - 1) << 16)
               | (crossing_visible << 31))
    pack_bw = qw.clamp_min(1) | (torch.arange(t_count, dtype=torch.int64, device=dev) << bw_bits)
    pack_xy1 = x1.clamp(0, width - 1) | (y1.clamp(0, height - 1) << 16)
    ftab = _edge_table(v_clip)                              # (T, 15)

    # Ascending area sort (stable, as lax.sort is: slot ranges at the pool
    # boundary, and the ids in inert slots, depend on the order of ties).
    area_s, order = torch.sort(area, stable=True)
    xy_s = pack_xy[order]
    cum = _prefix_sum(area_s)
    start = cum - area_s
    n_zero = t_count - (area_s > 0).sum()
    ints = torch.stack([start.to(torch.int64), xy_s, pack_bw[order], pack_xy1[order]], dim=1)
    ctab = torch.cat([ftab[order].view(torch.int32), _u32_bits(ints)], dim=1)  # (T, 19)

    # Slot -> sorted triangle: a 1 at every segment start, then a running
    # count (zero-area triangles sort first and start nothing).
    bmask = (area_s > 0) & (start < pool)
    bidx = torch.where(bmask, start, torch.full_like(start, pool)).to(torch.int64)
    segd = torch.zeros((pool + 1,), dtype=torch.int32, device=dev)
    segd.index_add_(0, bidx, torch.ones_like(bidx, dtype=torch.int32))
    sorted_idx = (n_zero + torch.cumsum(segd[:-1], 0) - 1).clamp(0, t_count - 1)
    crow = torch.index_select(ctab.T.contiguous(), 1, sorted_idx)   # (19, pool)
    total_covered = cum[-1].clamp_max(pool)

    # Giant-pass need in sorted space, un-permuted to triangle order.
    cross_s = (xy_s >> 31) != 0
    score_s = torch.where(
        cross_s, torch.full_like(area_s, float("inf"), dtype=torch.float32),
        torch.where((cum > pool) & (area_s > 0), area_s.to(torch.float32),
                    torch.full_like(area_s, -1.0, dtype=torch.float32)))
    score = torch.empty_like(score_s).index_copy_(0, order, score_s)
    return SlotTables(world, clip, ftab, crow, total_covered, score, id_bits,
                      (width + 3) // 4, (height + 1) // 2)


def _oct_sort(keysp: torch.Tensor, octid: torch.Tensor, n_oct: int):
    """Sort the slot entries plus one all-ones background entry per oct
    (so every oct owns a run) by oct id, carrying the packed key rows.
    Unstable: component-wise run mins do not depend on the order."""
    nk = keysp.shape[0]
    dev = keysp.device
    oct_all = torch.cat([octid, torch.arange(n_oct, dtype=torch.int32, device=dev)])
    keys_all = torch.cat([keysp, torch.full((nk, n_oct), -1, dtype=torch.int32, device=dev)], 1)
    so, perm = torch.sort(oct_all)
    return so, torch.index_select(keys_all, 1, perm)


def _resolve(keysp, octid, tabs: SlotTables, width: int, height: int) -> torch.Tensor:
    """Sort-based visibility resolve: oct sort, K8, compaction of the
    run-last rows into oct order, and the oct -> pixel unpacking. Returns
    the (H, W) key image (int64 values)."""
    n_oct = tabs.octs_w * tabs.octs_h
    so, sk = _oct_sort(keysp, octid, n_oct)
    mins, skey = segmin_stage(so, sk, n_oct, tabs.id_bits)
    win = torch.sort(skey).indices[:n_oct]                  # one run-last per oct
    oct_img = torch.index_select(mins, 1, win)              # (8, n_oct)
    key_img = (oct_img.reshape(_OCT_H, _OCT_W, tabs.octs_h, tabs.octs_w)
               .permute(2, 0, 3, 1)
               .reshape(tabs.octs_h * _OCT_H, tabs.octs_w * _OCT_W)[:height, :width])
    return _u32_value(key_img)


def _giant_selection(score: torch.Tensor, giants: int):
    """The ``giants`` highest-scored triangles (ties to the lower index, as
    ``lax.top_k``), in 32-triangle groups: (ids (G, 32), ok (G, 32), the
    number of active candidates, a 0-dim int64 tensor on the device). The
    active candidates (positive score) come first, so the groups that hold
    one are the first ceil(active / 32). Nothing is read to the host."""
    k = min(giants, score.shape[0])
    ix = torch.sort(score, descending=True, stable=True).indices[:k]
    ok = score[ix] > 0
    groups = -(-k // _GIANT_GROUP)
    pad = groups * _GIANT_GROUP - k
    ix = torch.cat([ix, torch.zeros(pad, dtype=ix.dtype, device=ix.device)])
    ok = torch.cat([ok, torch.zeros(pad, dtype=torch.bool, device=ok.device)])
    return ix.reshape(groups, _GIANT_GROUP), ok.reshape(groups, _GIANT_GROUP), ok.sum()


def _giant_pass(clip, tris, score, key_img, width: int, height: int, giants: int,
                id_bits: int, y_origin: int = 0, full_height: Optional[int] = None):
    """Edge-test the highest-scored triangles against every pixel of the
    image, merging keys into ``key_img``: the selection, then K9 over all
    of its groups (one launch, whatever the number of active candidates).
    Returns (key image, (2,) int64 on the device: the active candidates
    and the groups that hold one, for ``_count_giants``)."""
    dev = key_img.device
    if min(giants, tris.shape[0]) == 0:
        return key_img, torch.zeros(2, dtype=torch.int64, device=dev)
    giant_ix, giant_ok, active = _giant_selection(score, giants)
    counts = torch.stack([active, (active + _GIANT_GROUP - 1) // _GIANT_GROUP])
    return giant_stage(giant_ix, giant_ok, clip, tris, score, key_img, width, height,
                       height if full_height is None else full_height, y_origin,
                       id_bits), counts


def _count_giants(counts: torch.Tensor) -> None:
    """Add ``_giant_pass``'s counts to the recorded unit's counters
    ``giant.candidates`` and ``giant.groups``. They stay on the device until
    the unit closes, so no frame waits for them."""
    profiling.count("giant.candidates", counts[0])
    profiling.count("giant.groups", counts[1])


def _deferred_shade(displacement, dtab, key_img, camera_pos, width: int, height: int,
                    id_bits: int, grid_shape, foam=None, frag_channel: int = 1,
                    height_scale: float = 180.0, pbr_roughness: float = 0.0,
                    y_origin: int = 0, full_height: Optional[int] = None, tiles=None):
    """Per-pixel varyings and the exact float32 depth from the winning
    triangle's row of ``dtab`` (``_deferred_table``),
    then ``shade_fragments`` (``tiles`` for a cascade stack). Uncovered
    pixels compute from id 0 and are masked. Returns (color (H, W, 3),
    depth (H, W), inf where uncovered)."""
    dev = key_img.device
    covered = key_img != KEY_MAX
    id_img = torch.where(covered, key_img & ((1 << id_bits) - 1), torch.zeros_like(key_img))
    pnx, pny = _pixel_ndc(width, height, dev, y_origin, full_height)
    tpl = dtab.T.contiguous()[:, id_img]                    # (24, H, W)
    lam0 = tpl[0] * pnx + tpl[1] * pny + tpl[2]
    lam1 = tpl[3] * pnx + tpl[4] * pny + tpl[5]
    lam2 = tpl[6] * pnx + tpl[7] * pny + tpl[8]
    denom = lam0 + lam1 + lam2
    inv_denom = 1.0 / torch.where(denom == 0, torch.ones_like(denom), denom)
    lam_w = lam0 * tpl[12] + lam1 * tpl[13] + lam2 * tpl[14]
    z_pix = (lam0 * tpl[9] + lam1 * tpl[10] + lam2 * tpl[11]) / torch.where(
        lam_w == 0, torch.ones_like(lam_w), lam_w)
    z_img = torch.where(covered, z_pix, torch.full_like(z_pix, float("inf")))

    if grid_shape is not None:
        _, uvc = _decode_tri(id_img, grid_shape)
        uv_img = (lam0[..., None] * uvc[..., 0, :] + lam1[..., None] * uvc[..., 1, :]
                  + lam2[..., None] * uvc[..., 2, :]) * inv_denom[..., None]
    else:  # uv corners [u0 v0 u1 v1 u2 v2] at columns 24..29
        uv_img = torch.stack(
            [(lam0 * tpl[24 + a] + lam1 * tpl[26 + a] + lam2 * tpl[28 + a]) * inv_denom
             for a in range(2)], dim=-1)
    # world corners at columns 15..23 as [x0 y0 z0 x1 y1 z1 x2 y2 z2]
    world_img = torch.stack(
        [(lam0 * tpl[15 + a] + lam1 * tpl[18 + a] + lam2 * tpl[21 + a]) * inv_denom
         for a in range(3)], dim=-1)
    color = sh.shade_fragments(displacement, uv_img[..., 0], uv_img[..., 1], world_img,
                               camera_pos, foam=foam, frag_channel=frag_channel,
                               height_scale=height_scale, pbr_roughness=pbr_roughness,
                               tiles=tiles)
    return torch.where(covered[..., None], color, sh._const(sh.CLEAR_COLOR, color)), z_img


def _pool_stages(positions, uvs, tris, width: int, height: int, pool: int, giants: int,
                 interp, grid_shape, frag_channel: int, scales, tiles, y_origin: int,
                 full_height: int, with_diag: bool):
    """The pool rasterizer as (span name, stage) pairs, in order. A stage
    takes the frame's dict of values, reads what the stages before it
    added and adds its own. Inputs: "displacement", "view_proj",
    "camera_pos" and "foam" (None without foam); then "tabs"
    (``frame.slot_tables``), "keys" and "octs" (``frame.slots``, K7),
    "resolved" (``frame.resolve``, K8), "key_img", "giant_counts" and with
    ``with_diag`` "dropped" (``frame.giant_pass``, K9), "image" and "depth"
    (``frame.shade``). No stage reads a device value to the host, so each
    can be captured as a CUDA graph (``_StageGraphs``)."""

    def slot_tables(v):
        v["tabs"] = _slot_tables(v["displacement"], positions, uvs, tris, v["view_proj"], width,
                                 height, pool, interp, grid_shape, scales, y_origin,
                                 full_height, tiles)

    def slots(v):
        tabs = v["tabs"]
        v["keys"], v["octs"] = slot_stage(tabs.crow, tabs.total_covered, width, full_height,
                                          tabs.octs_w, tabs.octs_w * tabs.octs_h,
                                          32 - tabs.id_bits, tabs.id_bits, y_origin)

    def resolve(v):
        v["resolved"] = _resolve(v["keys"], v["octs"], v["tabs"], width, height)

    def giant_pass(v):
        tabs = v["tabs"]
        v["key_img"], v["giant_counts"] = _giant_pass(tabs.clip, tris, tabs.score, v["resolved"],
                                                      width, height, giants, tabs.id_bits,
                                                      y_origin, full_height)
        if with_diag:
            v["dropped"] = ((tabs.score > 0).sum() - min(giants, tris.shape[0])).clamp_min(0)

    def shade(v):
        tabs = v["tabs"]
        dtab = _deferred_table(tabs.ftab, tabs.world, tris, uvs, grid_shape)
        v["image"], v["depth"] = _deferred_shade(
            v["displacement"], dtab, v["key_img"], v["camera_pos"], width, height, tabs.id_bits,
            grid_shape, v["foam"], frag_channel, scales[2], scales[3] if len(scales) > 3 else 0.0,
            y_origin, full_height, tiles)

    return [("frame.slot_tables", slot_tables), ("frame.slots", slots),
            ("frame.resolve", resolve), ("frame.giant_pass", giant_pass), ("frame.shade", shade)]


def _run_stages(stages, values: dict, dev) -> dict:
    """Run ``stages`` eagerly on ``values``, each inside its span."""
    for name, stage in stages:
        with profiling.span(name, device=dev):
            stage(values)
    return values


def _rasterize_pool(displacement, positions, uvs, tris, view_proj, camera_pos,
                    width: int, height: int, pool: int = 1 << 20, giants: int = 512,
                    interp=None, grid_shape=None, foam=None, frag_channel: int = 1,
                    scales=(3.0, 3.5, 180.0, 0.0), tiles=None, y_origin: int = 0,
                    full_height: Optional[int] = None, with_diag: bool = False):
    """Exact-area pool rasterizer: slot tables, K7, the resolve with K8,
    the giant pass and deferred shading, run eagerly (``_pool_stages``). A
    (C, N, N, 3) cascade stack takes its per-cascade ``interp`` pairs and
    ``tiles`` (``_cascade_setup``) and (C, N, N) ``foam``. ``y_origin`` /
    ``full_height`` render the (height, width) band of a ``full_height``-row
    frame from global row ``y_origin``; stacked bands equal the full frame
    bit for bit.
    Returns (image (H, W, 3), depth (H, W)) and, with ``with_diag``, the
    number of giant-pass candidates past capacity (a 0-dim tensor; must be
    0 for exact coverage). ``grid_shape`` None takes ``tris`` as any
    triangle list. Each stage is a span (``frame.slot_tables``,
    ``frame.slots``, ``frame.resolve``, ``frame.giant_pass``,
    ``frame.shade``; ``utils/profiling.py``)."""
    full_height = height if full_height is None else full_height
    stages = _pool_stages(positions, uvs, tris, width, height, pool, giants, interp,
                          grid_shape, frag_channel, scales, tiles, y_origin, full_height,
                          with_diag)
    v = _run_stages(stages, {"displacement": displacement, "view_proj": view_proj,
                             "camera_pos": camera_pos, "foam": foam}, displacement.device)
    _count_giants(v["giant_counts"])
    if with_diag:
        return v["image"], v["depth"], v["dropped"]
    return v["image"], v["depth"]


def _window_score(all_clip, width: int, height: int, budget: int) -> torch.Tensor:
    """The window rasterizer's giant-pass need, (T,) float32: inf for a
    visible eye-plane-crossing triangle, the floor-aligned screen bbox
    area where it exceeds the ``budget`` samples of a fully-in-front,
    visible, on-screen triangle, else -1 (``_rasterize`` pass 3)."""
    aw = all_clip[..., 3]
    fully_front, crossing, outside = _cull(all_clip)
    aw_safe = torch.where(fully_front[:, None], aw, torch.ones_like(aw))
    asx = (all_clip[..., 0] / aw_safe * 0.5 + 0.5) * float(width)
    asy = (all_clip[..., 1] / aw_safe * 0.5 + 0.5) * float(height)
    bbw = torch.floor(asx.amax(-1)) - torch.floor(asx.amin(-1)) + 1.0
    bbh = torch.floor(asy.amax(-1)) - torch.floor(asy.amin(-1)) + 1.0
    area = bbw * bbh
    overlaps = ((asx.amax(-1) >= 0) & (asx.amin(-1) < width)
                & (asy.amax(-1) >= 0) & (asy.amin(-1) < height))
    return torch.where(
        crossing & ~outside, torch.full_like(area, float("inf")),
        torch.where(fully_front & ~outside & overlaps & (area > budget), area,
                    torch.full_like(area, -1.0)))


def _window_chunk(keybuf, v, ids, gk, width: int, height: int, id_bits: int) -> None:
    """Scatter-min one chunk's samples into ``keybuf`` ((H W + 1,) int64, the
    last cell the spill): ``gk`` (K,) sample indices walk row-major through
    each (C, 3, 4) triangle's tight pixel-centre bbox, as the pool's slots
    do; ``ids`` (C,) are the triangles' ids."""
    w = v[..., 3]
    fully_front = (w > 1e-6).all(dim=-1)            # else: the giant pass owns it
    w_safe = torch.where(fully_front[:, None], w, torch.ones_like(w))
    sx = (v[..., 0] / w_safe * 0.5 + 0.5) * float(width)
    sy = (v[..., 1] / w_safe * 0.5 + 0.5) * float(height)
    # The bounds are clamped into int range before the cast: JAX's
    # conversion saturates, a C cast does not; clamped ones walk off screen.
    big = float(1 << 30)
    x_min = torch.clamp(torch.ceil(sx.amin(-1) - 0.5), -big, big).to(torch.int64)[:, None]
    y_min = torch.clamp(torch.ceil(sy.amin(-1) - 0.5), -big, big).to(torch.int64)[:, None]
    x_max = torch.clamp(torch.floor(sx.amax(-1) - 0.5), -big, big).to(torch.int64)[:, None]
    y_max = torch.clamp(torch.floor(sy.amax(-1) - 0.5), -big, big).to(torch.int64)[:, None]
    bw = (x_max - x_min + 1).clamp_min(1)
    px = x_min + gk % bw                             # (C, K)
    py = y_min + gk // bw
    on_screen = ((px >= 0) & (px < width) & (py >= 0) & (py < height)
                 & (px <= x_max) & (py <= y_max))
    pnx = sh._div(2.0 * (px.to(torch.float32) + 0.5), float(width)) - 1.0
    pny = sh._div(2.0 * (py.to(torch.float32) + 0.5), float(height)) - 1.0
    lam0, lam1, lam2, _ = _lambdas(v, pnx, pny, 1)
    denom = lam0 + lam1 + lam2
    mask = ((lam0 >= 0) & (lam1 >= 0) & (lam2 >= 0) & (denom > 0) & on_screen
            & fully_front[:, None])
    lam_w = lam0 * v[:, None, 0, 3] + lam1 * v[:, None, 1, 3] + lam2 * v[:, None, 2, 3]
    z = (lam0 * v[:, None, 0, 2] + lam1 * v[:, None, 1, 2] + lam2 * v[:, None, 2, 2]) / torch.where(
        lam_w == 0, torch.ones_like(lam_w), lam_w)
    mask = mask & (z > -1.0) & (z < 1.0)
    key = _pack_key(z, ids[:, None], mask, id_bits)
    flat = torch.where(mask, py * width + px, torch.full_like(px, width * height))
    keybuf.scatter_reduce_(0, flat.reshape(-1), key.reshape(-1), "amin")


def _rasterize(displacement, positions, uvs, tris, view_proj, camera_pos, width: int,
               height: int, samples: int, giants: int = 512, interp=None, grid_shape=None,
               foam=None, frag_channel: int = 1, scales=(3.0, 3.5, 180.0, 0.0), tiles=None,
               with_diag: bool = False):
    """The window rasterizer (``gfx_ocean_tpu/render/raster.py:1244-1375``):
    ``samples``^2 samples a fully-in-front triangle scattered by key min in
    chunks of ``_TRI_CHUNK`` triangles, the giant pass for bboxes past the
    budget and eye-plane-crossing triangles, and deferred shading. Takes
    the arguments of ``_rasterize_pool`` with ``samples`` in place of the
    pool and no bands (the JAX function has none). Returns (image (H, W, 3),
    depth (H, W)) and, with ``with_diag``, the number of giant-pass
    candidates past ``giants`` (a 0-dim tensor; 0 for exact coverage)."""
    world, clip = _vertex_stage(displacement, positions, uvs, view_proj, interp,
                                scales[0], scales[1], tiles)
    dev = clip.device
    t_count = tris.shape[0]
    id_bits = _id_bits(t_count)
    budget = samples * samples
    all_clip = _tri_corners(clip, tris, grid_shape)          # (T, 3, 4)
    gk = torch.arange(budget, dtype=torch.int64, device=dev)[None, :]
    ids = torch.arange(t_count, dtype=torch.int64, device=dev)
    keybuf = torch.full((width * height + 1,), KEY_MAX, dtype=torch.int64, device=dev)
    for s in range(0, t_count, _TRI_CHUNK):
        _window_chunk(keybuf, all_clip[s:s + _TRI_CHUNK], ids[s:s + _TRI_CHUNK], gk,
                      width, height, id_bits)
    key_img = keybuf[:-1].reshape(height, width)
    score = _window_score(all_clip, width, height, budget)
    key_img, counts = _giant_pass(clip, tris, score, key_img, width, height, giants, id_bits)
    _count_giants(counts)
    dtab = _deferred_table(_edge_table(all_clip), world, tris, uvs, grid_shape)
    img, z_img = _deferred_shade(displacement, dtab, key_img, camera_pos, width, height,
                                 id_bits, grid_shape, foam, frag_channel, scales[2],
                                 scales[3] if len(scales) > 3 else 0.0, tiles=tiles)
    if with_diag:
        dropped = ((score > 0).sum() - min(giants, t_count)).clamp_min(0)
        return img, z_img, dropped
    return img, z_img


def pool_overflow(displacement, positions, uvs, tris, view_proj, width: int, height: int,
                  pool: Optional[int] = None, y_origin: int = 0,
                  full_height: Optional[int] = None, bands: int = 1,
                  return_demand: bool = False, tiles=None):
    """Diagnostic: how many visible triangles spill past the pool (each
    must win a giant-pass slot for exact coverage); with ``return_demand``
    also the scene's total slot demand. ``y_origin`` / ``full_height`` /
    ``bands`` check one band of a band split; a (C, N, N, 3) cascade stack
    is composited at ``tiles`` (1 for each cascade when None, as the JAX
    package's diagnostic composites it). Eager and host-synchronous,
    for sizing and debugging, never inside a frame loop. Its area sum runs
    in float64 (the JAX package's float32 cumsum is exact only below 2^24)."""
    dev = displacement.device if isinstance(displacement, torch.Tensor) else torch.device("cpu")

    def on_dev(x, dtype):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x).astype(dtype))
        return x.to(device=dev, dtype=getattr(torch, np.dtype(dtype).name))

    # The vertex stage's gather form, as the JAX package's diagnostic uses.
    _, clip = _vertex_stage(on_dev(displacement, np.float32), on_dev(positions, np.float32),
                            on_dev(uvs, np.float32), on_dev(view_proj, np.float32),
                            tiles=tiles)
    area = _oct_bounds(clip[on_dev(tris, np.int64)], width, height, full_height or height,
                       y_origin)[5]
    pool = pool or _auto_pool(width, height, bands)
    area_sorted = torch.sort(area).values
    cum = torch.cumsum(area_sorted.to(torch.float64), 0)
    overflow = int(((cum > pool) & (area_sorted > 0)).sum())
    if return_demand:
        return overflow, int(cum[-1])
    return overflow


def _view_proj(camera: Camera, width: int, height: int, device) -> torch.Tensor:
    proj = perspective(width / height)
    return torch.tensor((proj @ camera.view()).astype(np.float32), device=device)


def render_frame(
    displacement: torch.Tensor,
    camera: Camera,
    width: int = 300,
    height: int = 175,
    mesh_resolution: int = 128,
    num_patches: int = 4,
    samples: int = 16,
    giants: int = 512,
    return_depth: bool = False,
    impl: str = "pool",
    pool: Optional[int] = None,
    foam: Optional[torch.Tensor] = None,
    frag_normal_x: bool = False,
    height_div: float = 3.0,
    horiz_div: float = 3.5,
    normal_height_scale: float = 180.0,
    pbr_roughness: float = 0.0,
    cascade_domains=None,
):
    """Render one frame from an (N, N, 3) displacement map along a camera,
    on the displacement's device. Returns the (H, W, 3) float32 image (and
    the depth buffer with ``return_depth``). The arguments are those of
    ``gfx_ocean_tpu.render.render_frame``: a (C, N, N, 3) cascade stack
    needs ``cascade_domains`` of length C (``ValueError`` without) and takes
    (C, N, N) ``foam``. ``impl="window"`` takes the window rasterizer with
    ``samples``^2 samples a triangle."""
    if impl not in ("pool", "window"):
        raise ValueError(f"impl must be 'pool' or 'window', got {impl!r}")
    displacement = torch.as_tensor(displacement, dtype=torch.float32)
    dev = _device(displacement.device)
    tiles, interp = _cascade_setup(displacement, cascade_domains, mesh_resolution, dev)
    positions, uvs, tris = _mesh_constants(mesh_resolution, num_patches, dev)
    cam_pos = torch.tensor(camera.position.astype(np.float32), device=dev)
    foam = None if foam is None else torch.as_tensor(foam, dtype=torch.float32, device=dev)
    scales = (float(height_div), float(horiz_div), float(normal_height_scale),
              float(pbr_roughness))
    vp = _view_proj(camera, width, height, dev)
    grid_shape = (num_patches, mesh_resolution)
    chan = 0 if frag_normal_x else 1
    if impl == "pool":
        img, depth = _rasterize_pool(displacement, positions, uvs, tris, vp, cam_pos, width,
                                     height, pool or _auto_pool(width, height), giants, interp,
                                     grid_shape, foam, chan, scales, tiles)
    else:
        img, depth = _rasterize(displacement, positions, uvs, tris, vp, cam_pos, width,
                                height, samples, giants, interp, grid_shape, foam, chan,
                                scales, tiles)
    if return_depth:
        return img, depth
    return img


def srgb8(img: torch.Tensor) -> torch.Tensor:
    """sRGB encode as the JAX package's fused frame does: gamma 1/2.2, x255,
    truncating cast to uint8."""
    return (torch.clamp(img, 0.0, 1.0) ** (1.0 / 2.2) * 255.0).to(torch.uint8)


def make_frame_renderer(config, width: int = 480, height: int = 280, giants: int = 512,
                        pool: Optional[int] = None, diag: bool = False):
    """Interactive frame pipeline: ``fn(state, t, view_proj, camera_pos) ->
    (H, W, 3) uint8`` (step -> rasterize -> sRGB) on the state's device;
    ``view_proj`` is the float32 (4, 4) projection @ view. With
    ``diag=True`` it returns ``(frame, dropped)``, ``dropped`` the count of
    giant-pass candidates past capacity (0 for exact coverage). With
    ``config.num_cascades > 1`` the state is a cascade stack and the frame
    composites its cascades at ``config.domains``. On the card the stages
    after the step replay as CUDA graphs from the second call on; a
    renderer serves one call at a time (``_frame_fn``)."""
    return _frame_fn(config, width, height, giants, pool, diag=diag)


def _srgb_stage(values: dict) -> None:
    values["srgb"] = srgb8(values["image"])


class _StageGraphs:
    """A frame's stages after the step on one device, captured once as CUDA
    graphs, one a stage, in one memory pool, and replayed in order, each
    inside its stage's span (whose CUDA events lie outside the graphs).

    ``load(inputs)`` copies the inputs (the step's displacement and foam,
    ``view_proj``, ``camera_pos``) into the graphs' static inputs;
    ``replay()`` runs the graphs on them and returns the dict of the
    stages' values: the tensors the captures made, which every replay
    overwrites. Not reentrant: one frame at a time on an
    instance. A capture that fails raises; there is no eager fallback.

    Counters of the recorded unit: ``graph.captures`` (a capture's graphs)
    and ``graph.replays`` (the graphs a replay ran). A replay adds to the
    recorder's table (``profiling.tally``) what each graph's capture added
    to it, the kernels' launches; the set-up (a warm-up pass and the
    captures) leaves the table as it found it."""

    def __init__(self, stages, inputs: dict, dev: torch.device):
        self.device = dev
        self.stages = stages            # holds the constants the graphs read
        self.values = {k: None if x is None else x.clone() for k, x in inputs.items()}
        stream = torch.cuda.Stream(dev)     # captures need a side stream
        before = profiling.tallies()
        # One eager pass on the capture stream first, so that no lazy set-up
        # of that stream (cuBLAS's workspace) falls inside a capture.
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            warm = dict(self.values)
            for _, stage in stages:
                stage(warm)
            del warm
        torch.cuda.current_stream(dev).wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        for name, stage in stages:
            graph = torch.cuda.CUDAGraph()
            held = profiling.tallies()
            # "thread_local": a server's other threads may copy a finished
            # frame to the host while this one captures.
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                stage(self.values)
            self.graphs.append((name, graph, profiling.grown(held)))
        # Set-up launches nothing a frame counts: each replay counts its own.
        for key, n in profiling.grown(before).items():
            profiling.tally(key, -n)
        profiling.count("graph.captures", len(self.graphs))

    def load(self, inputs: dict) -> None:
        """Copy ``inputs`` into the graphs' static inputs."""
        for name, x in inputs.items():
            if x is not None:
                self.values[name].copy_(x)

    def replay(self) -> dict:
        for name, graph, launched in self.graphs:
            with profiling.span(name, device=self.device):
                graph.replay()
            for key, n in launched.items():
                profiling.tally(key, n)
        profiling.count("graph.replays", len(self.graphs))
        return self.values


def _frame_fn(config, width: int, height: int, giants: int, pool: Optional[int],
              band_axis: Optional[str] = None, n_bands: int = 1, diag: bool = False):
    """The body of :func:`make_frame_renderer` and of the band renderers of
    ``parallel/render.py``: with ``band_axis`` set, ``fn(..., band=i)``
    renders the ``height // n_bands``-row band i of the viewport (rows from
    ``i * height // n_bands``), bit-equal to those rows of the full frame
    (the JAX package's ``_fused_frame_fn``). A frame is the span ``frame``
    (attributes ``t`` and ``band``; CUDA events on the state's device, its
    start event the unit's anchor) with ``frame.step``, ``frame.inputs``
    (the inputs' uploads, and on the card their copies into the graphs'
    static inputs), the stages of ``_pool_stages``, ``frame.srgb`` and
    ``frame.output`` (the image's copy out of the graphs, the giant
    counts' copies) inside it: every launch of a frame lies in one of
    these, its leaves (``utils/profiling.Timeline``).

    The step runs eagerly. On a CUDA device the stages after it are CUDA
    graphs (``_StageGraphs``), captured by the first call for a (device,
    band, input shapes), which renders eagerly; later calls replay them.
    The frame returned is a copy, which later calls leave alone. A renderer
    is not reentrant: one call at a time (``serve.py`` holds one dispatch
    lock over every launch). CPU frames run eagerly."""
    from gfx_ocean_tpu_torch.models.ocean import step as _ocean_step  # noqa: PLC0415

    if band_axis is not None and height % n_bands:
        raise ValueError(
            f"height {height} must divide into mesh axis {band_axis!r} "
            f"({n_bands} bands); pad the viewport or re-shape the mesh")
    band_h = height // n_bands if band_axis is not None else height
    # Fragment normals come from the displacement texture (shade.py); the
    # step's vertex normals are dead weight here.
    config = dataclasses.replace(config, compute_normals=False)
    scales = (float(config.height_div), float(config.horiz_div),
              float(config.normal_height_scale), float(config.pbr_roughness))
    grid_shape = (config.num_patches, config.mesh_resolution)
    chan = 0 if config.compat.frag_normal_x else 1
    pool = pool or _auto_pool(width, band_h, n_bands if band_axis is not None else 1)
    outputs = ("srgb", "dropped") if diag else ("srgb",)
    captured = {}       # (device, band, the inputs' shapes) -> _StageGraphs

    def stages(dev, band, displacement):
        positions, uvs, tris = _mesh_constants(config.mesh_resolution, config.num_patches, dev)
        tiles, interp = _cascade_setup(displacement, config.domains, config.mesh_resolution, dev)
        return _pool_stages(positions, uvs, tris, width, band_h, pool, giants, interp,
                            grid_shape, chan, scales, tiles, band * band_h, height,
                            diag) + [("frame.srgb", _srgb_stage)]

    def fn(state, t, view_proj, camera_pos, band: int = 0):
        dev = _device(state.h0.device)
        with profiling.span("frame", device=dev, t=t, band=band):
            with profiling.span("frame.step", device=dev):
                fields = _ocean_step(state, t, config)
            with profiling.span("frame.inputs", device=dev):
                inputs = {"displacement": fields.displacement,
                          "view_proj": torch.as_tensor(view_proj, dtype=torch.float32,
                                                       device=dev),
                          "camera_pos": torch.as_tensor(camera_pos, dtype=torch.float32,
                                                        device=dev),
                          "foam": fields.foam if config.compute_foam else None}
                key = (dev, band) + tuple(None if x is None else tuple(x.shape)
                                          for x in inputs.values())
                graphs = captured.get(key)
                if graphs is not None:
                    graphs.load(inputs)
            if graphs is not None:
                values = graphs.replay()
            else:
                body = stages(dev, band, fields.displacement)
                values = _run_stages(body, dict(inputs), dev)
                if dev.type == "cuda":
                    captured[key] = _StageGraphs(body, inputs, dev)
            with profiling.span("frame.output", device=dev):
                # The graphs' outputs are overwritten by the next replay.
                out = tuple(values[k].clone() if graphs is not None else values[k]
                            for k in outputs)
                _count_giants(values["giant_counts"])
            return out if diag else out[0]         # diag: (frame, dropped-giants tripwire)

    return fn


def make_batch_renderer(config, width: int, height: int, giants: int = 512,
                        pool: Optional[int] = None):
    """``fn(state, ts, view_projs, camera_pos) -> (F, H, W, 3) uint8``: the
    single-frame pipeline over the frames in a Python loop (the JAX
    package unrolls the same loop inside one jit)."""
    one = make_frame_renderer(config, width, height, giants, pool)

    def strip(state, ts, view_projs, camera_pos):
        return torch.stack([one(state, ts[i], view_projs[i], camera_pos[i])
                            for i in range(len(ts))])

    return strip


def render_frames(displacements, cameras, width: int = 300, height: int = 175,
                  mesh_resolution: int = 128, num_patches: int = 4, samples: int = 16,
                  giants: int = 512, impl: str = "pool",
                  pool: Optional[int] = None) -> torch.Tensor:
    """Frames (F, H, W, 3) float32 from (F, N, N, 3) displacement maps and
    F cameras, one ``render_frame`` each on either rasterizer (the JAX
    package vmaps it)."""
    return torch.stack([
        render_frame(displacements[i], cam, width, height, mesh_resolution, num_patches,
                     samples, giants, impl=impl, pool=pool)
        for i, cam in enumerate(cameras)])
