"""The rasterizer's building blocks and the plain versions of kernels K7
and K8 (``gfx_ocean_tpu_torch/render/raster.py``) against the JAX
package's on the CPU, on the same inputs; K9's dispatch on the CPU.

The JAX slot and segmented-min stages run their Pallas kernels in
interpret mode on the CPU (``_slot_stage`` / ``_segmin_stage`` pick it
themselves). The port's wrappers take the plain versions, because the
tensors lie on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
from gfx_ocean_tpu.render import raster as jr

import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu_torch.render import raster as tr
from gfx_ocean_tpu_torch.render.camera import Camera
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum
from gfx_ocean_tpu_torch.utils import profiling

CPU = torch.device("cpu")
SKIMMING = (np.array([31.0, 2.5, 55.0]), np.zeros(3))
# Slot pool of the small frames (the default's 2^18-slot floor is ~250K dead
# slots at 96x64, which the plain versions would pay for on the CPU).
POOL = 32_768


def _launches(wrapper: str, kind: str = "launches") -> int:
    """The process-wide count ``<kind>.<wrapper>`` (``profiling.tallies``)."""
    return profiling.tallies().get(f"{kind}.{wrapper}", 0)


def _disp64() -> np.ndarray:
    xi = np.random.default_rng(0).standard_normal((2, 64, 64)).astype(np.float32)
    env = np.sqrt(phillips_spectrum(64, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    st = J.OceanState(h0=jnp.asarray(xi * env), omega=jnp.asarray(dispersion(64, 1000.0)))
    cfg = J.OceanConfig(resolution=64, compute_normals=False)
    return np.array(J.make_step(cfg)(st, jnp.float32(5.0)).displacement)


def _u32(x: torch.Tensor) -> np.ndarray:
    """uint32 view of the port's int32 bit patterns or int64 values."""
    return x.numpy().astype(np.int64).astype(np.uint32) if x.dtype == torch.int64 \
        else x.numpy().view(np.uint32)


def _tables(disp, pose=None, width=96, height=64, mesh=(64, 4), y_origin=0, full_height=None,
            pool=POOL):
    cam = Camera()
    if pose is not None:
        cam.position, cam.rotation = pose[0].copy(), pose[1].copy()
    res, patches = mesh
    fh = full_height or height
    positions, uvs, tris = tr._mesh_constants(res, patches, CPU)
    tabs = tr._slot_tables(torch.from_numpy(disp), positions, uvs, tris,
                           tr._view_proj(cam, width, fh, CPU), width, height, pool,
                           tr._interp_matrices(res, disp.shape[0], CPU), (patches, res),
                           y_origin=y_origin, full_height=fh)
    return tabs, fh


# --- packing -------------------------------------------------------------------

@pytest.mark.parametrize("id_bits", [17, 10])
def test_zq_pack_roundtrip_matches_jax(id_bits):
    """Packed rows and their unpacking bit-equal to JAX's, misses and the
    all-ones sentinel rows included (tests/test_render.py:981-1011)."""
    z_bits = 32 - id_bits
    rng = np.random.default_rng(3)
    n = 4096
    tri = rng.integers(0, 1 << id_bits, (1, n), dtype=np.uint32)
    zq = rng.integers(0, (1 << z_bits) - 1, (8, n), dtype=np.uint32)
    keys = ((zq << id_bits) | tri).astype(np.uint32)
    keys = np.where(rng.random((8, n)) < 0.3, np.uint32(0xFFFFFFFF), keys)
    want = np.asarray(jr._zq_pack_rows(jnp.asarray(keys), jnp.asarray(tri), id_bits))
    got = tr._zq_pack_rows(torch.from_numpy(keys.astype(np.int64)),
                           torch.from_numpy(tri.astype(np.int64)), id_bits)
    assert got.shape == (tr._zq_key_rows(id_bits), n) == want.shape
    assert np.array_equal(_u32(got), want)
    back = tr._zq_unpack_keys(got, id_bits)
    assert np.array_equal(_u32(back), keys)
    assert np.array_equal(_u32(back), np.asarray(jr._zq_unpack_keys(jnp.asarray(want), id_bits)))
    ones = torch.full((tr._zq_key_rows(id_bits), 8), tr.KEY_MAX, dtype=torch.int64)
    assert (tr._zq_unpack_keys(ones, id_bits) == tr.KEY_MAX).all()
    bits = tr._u32_bits(got)
    assert bits.dtype == torch.int32 and torch.equal(tr._u32_value(bits), got)


@pytest.mark.parametrize("id_bits", [17, 10, 4])
def test_pack_key_matches_jax(id_bits):
    rng = np.random.default_rng(id_bits)
    z = np.concatenate([rng.uniform(-1.2, 1.2, 5000), [-1.0, 1.0, 0.99999994, -0.99999994,
                                                       np.nan]]).astype(np.float32)
    ids = rng.integers(0, 1 << id_bits, z.size)
    hit = (rng.random(z.size) < 0.8) & (z > -1) & (z < 1)
    want = np.asarray(jr._pack_key(jnp.asarray(z), jnp.asarray(ids.astype(np.int32)),
                                   jnp.asarray(hit), id_bits))
    got = tr._pack_key(torch.from_numpy(z), torch.from_numpy(ids), torch.from_numpy(hit), id_bits)
    assert np.array_equal(_u32(got), want)


# --- geometry blocks ---------------------------------------------------------------

def test_mesh_blocks_match_jax():
    for res, n_tex in ((128, 512), (64, 64), (32, 64)):
        assert np.array_equal(tr._interp_matrices_np(res, n_tex),
                              np.asarray(jr._interp_matrices(res, n_tex)[0]))
    clip = np.random.default_rng(0).standard_normal((2 * 16 * 16, 4)).astype(np.float32)
    _, _, tris = tr._mesh_constants(16, 2, CPU)
    assert np.array_equal(tr._tri_corners(torch.from_numpy(clip), tris, (2, 16)).numpy(),
                          clip[tris.numpy()])
    ids = torch.arange(tris.shape[0])
    vt, uv = tr._decode_tri(ids, (2, 16))
    wvt, wuv = jr._decode_tri(jnp.asarray(ids.numpy().astype(np.int32)), (2, 16))
    assert np.array_equal(vt.numpy(), np.asarray(wvt)) and np.array_equal(vt, tris)
    assert np.array_equal(uv.numpy(), np.asarray(wuv))
    for args in ((96, 64), (1200, 700), (1200, 175, 4), (480, 70, 4), (4000, 3000)):
        assert tr._auto_pool(*args) == jr._auto_pool(*args)
    for t in (2, 3, 1000, 129_032, 1 << 20):
        assert tr._id_bits(t) == jr._id_bits(t)
    with pytest.raises(ValueError, match="z bits"):
        tr._id_bits((1 << 20) + 1)


def test_pixel_ndc_and_prefix_sum_match_jax():
    for args in ((96, 64, 0, None), (1200, 175, 175, 700), (80, 12, 36, 48)):
        w, h, yo, fh = args
        got = tr._pixel_ndc(w, h, CPU, yo, fh)
        want = jr._pixel_ndc(w, h, yo, fh)
        for g, x in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(x))
    x = np.random.default_rng(1).integers(0, 3000, 100_000).astype(np.int32)
    x[-5:] = 2 ** 30
    want = np.asarray(jr._prefix_sum_mxu(jnp.asarray(x)))
    got = tr._prefix_sum(torch.from_numpy(x)).numpy()
    exact = np.cumsum(x.astype(np.int64)) < (1 << 24)
    assert np.array_equal(got[exact], want[exact])
    assert np.array_equal(got, np.minimum(np.cumsum(x.astype(np.int64)), 2 ** 31 - 65536))


def test_vertex_stage_and_edge_table_match_jax():
    disp = _disp64()
    cam = Camera()
    vp = tr._view_proj(cam, 96, 64, CPU)
    positions, uvs, tris = tr._mesh_constants(64, 4, CPU)
    interp = tr._interp_matrices(64, 64, CPU)
    world, clip = tr._vertex_stage(torch.from_numpy(disp), positions, uvs, vp, interp)
    jw, jc = jr._vertex_stage(jnp.asarray(disp), jnp.asarray(positions.numpy()),
                              jnp.asarray(uvs.numpy()), jnp.asarray(vp.numpy()),
                              jr._interp_matrices(64, 64))
    assert np.abs(world.numpy() - np.asarray(jw)).max() < 2e-5
    assert np.abs(clip.numpy() - np.asarray(jc)).max() < 5e-5
    vc = tr._tri_corners(clip, tris, (4, 64))
    got = tr._edge_table(vc).numpy()
    want = np.asarray(jr._edge_table(jnp.asarray(vc.numpy())))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the gather form (no interp matrices) agrees with the matmul form
    _, clip_g = tr._vertex_stage(torch.from_numpy(disp), positions, uvs, vp)
    assert np.abs(clip_g.numpy() - clip.numpy()).max() < 5e-5


# --- K7 and K8: plain versions against the JAX stages ----------------------------------

@pytest.mark.parametrize("pose,y_origin,full_height", [(None, 0, None), (SKIMMING, 0, None),
                                                       (None, 16, 64)],
                         ids=["default", "skimming", "band-16"])
def test_slot_stage_plain_matches_jax(pose, y_origin, full_height):
    """K7's plain version against JAX ``_slot_stage`` on the same slot table.
    Bit-equal, except keys whose quantized z differs by one quantum with the
    same triangle id: XLA contracts the edge and z expressions into FMAs on
    the CPU, which moves z by an ulp across a quantum boundary. Those are
    counted and bounded at 1% of the hit keys (measured: 20 of 4,556 at the
    default pose, 34 of 10,583 skimming, 11 of 2,005 in the band)."""
    disp = _disp64()
    height = 16 if full_height else 64
    tabs, fh = _tables(disp, pose, height=height, y_origin=y_origin, full_height=full_height)
    n_oct = tabs.octs_w * tabs.octs_h
    keys, octs = tr.slot_stage(tabs.crow, tabs.total_covered, 96, fh, tabs.octs_w, n_oct,
                               32 - tabs.id_bits, tabs.id_bits, y_origin)
    crow = jnp.asarray(tabs.crow.numpy().view(np.uint32))
    wkeys, woct = jr._slot_stage(crow, jnp.int32(int(tabs.total_covered)), tabs.crow.shape[1],
                                 96, fh, tabs.octs_w, n_oct, 32 - tabs.id_bits, tabs.id_bits,
                                 y_origin)
    assert np.array_equal(octs.numpy(), np.asarray(woct))
    got = _u32(tr._zq_unpack_keys(tr._u32_value(keys), tabs.id_bits))
    want = np.asarray(jr._zq_unpack_keys(wkeys, tabs.id_bits))
    differ = got != want
    mask = (1 << tabs.id_bits) - 1
    zg, zw = got.astype(np.int64) >> tabs.id_bits, want.astype(np.int64) >> tabs.id_bits
    one_quantum = ((got & mask) == (want & mask)) & (np.abs(zg - zw) == 1)
    assert np.all(one_quantum[differ]), "a key differs by more than one z quantum"
    hits = int((want != 0xFFFFFFFF).sum())
    assert hits > 2_000 and int(differ.sum()) <= hits // 100, (int(differ.sum()), hits)


def _sorted_inputs(n: int, n_oct: int, id_bits: int, long_run: int, seed: int):
    rng = np.random.default_rng(seed)
    so = np.sort(np.concatenate([rng.integers(0, n_oct + 1, n - long_run),
                                 np.full(long_run, n_oct // 3)])).astype(np.int32)
    sk = rng.integers(0, 1 << 32, (tr._zq_key_rows(id_bits), n), dtype=np.uint64).astype(np.uint32)
    sk[:, rng.random(n) < 0.2] = 0xFFFFFFFF
    return so, sk


@pytest.mark.parametrize("id_bits,n", [(17, 30_000), (10, 20_000), (17, 8_192)])
def test_segmin_plain_matches_jax(id_bits, n):
    """K8's plain version bit-equal to JAX ``_segmin_stage`` (its Pallas
    kernel in interpret mode), with a run spanning its 8192-entry blocks."""
    n_oct = 1_500
    so, sk = _sorted_inputs(n, n_oct, id_bits, long_run=min(n // 2, 19_000), seed=id_bits)
    wmins, wskey = jr._segmin_stage(jnp.asarray(so), jnp.asarray(sk), n_oct, id_bits)
    mins, skey = tr.segmin_stage(torch.from_numpy(so), torch.from_numpy(sk.view(np.int32)),
                                 n_oct, id_bits)
    assert np.array_equal(_u32(mins), np.asarray(wmins))
    assert np.array_equal(skey.numpy(), np.asarray(wskey))


def test_resolve_of_a_frame_matches_jax():
    """The oct sort, K8 and the compaction of a real frame give JAX's key
    image for the same slot entries."""
    disp = _disp64()
    tabs, _ = _tables(disp, SKIMMING)
    n_oct = tabs.octs_w * tabs.octs_h
    keys, octs = tr.slot_stage(tabs.crow, tabs.total_covered, 96, 64, tabs.octs_w, n_oct,
                               32 - tabs.id_bits, tabs.id_bits)
    got = tr._resolve(keys, octs, tabs, 96, 64)
    so, sk = tr._oct_sort(keys, octs, n_oct)
    wmins, wskey = jr._segmin_stage(jnp.asarray(so.numpy()),
                                    jnp.asarray(sk.numpy().view(np.uint32)), n_oct, tabs.id_bits)
    win = np.argsort(np.asarray(wskey), kind="stable")[:n_oct]
    want = (np.asarray(wmins)[:, win].reshape(2, 4, tabs.octs_h, tabs.octs_w)
            .transpose(2, 0, 3, 1).reshape(tabs.octs_h * 2, tabs.octs_w * 4)[:64, :96])
    assert np.array_equal(_u32(got), want)
    assert (want != 0xFFFFFFFF).mean() > 0.2


def test_giant_selection_breaks_ties_like_top_k():
    """More crossing triangles (score inf) than giant slots: the lower
    index wins, as ``lax.top_k`` orders ties."""
    score = np.full(200, -1.0, np.float32)
    score[[5, 17, 40, 41, 90, 150, 151, 199]] = np.inf
    score[[3, 60]] = 7.0
    ix, ok, active = tr._giant_selection(torch.from_numpy(score), 6)
    want = np.asarray(jax.lax.top_k(jnp.asarray(score), 6)[1])
    assert np.array_equal(ix.reshape(-1)[:6].numpy(), want) and ix.shape == (1, 32)
    assert active.ndim == 0 and int(active) == 6
    assert ok.reshape(-1)[:6].all() and not ok.reshape(-1)[6:].any()


def test_giant_pass_takes_the_plain_version_on_cpu(monkeypatch):
    """K9's dispatcher sends CPU tensors to its plain version (no launch),
    leaving out the groups after the last active one, and on a skimming pose
    the giant pass merges its crossing triangles into the key image as the
    group loop always did: one group at a time. Its counts are the
    selection's active candidates and groups."""
    pose = (np.array([20.0, 1.5, 45.0]), np.zeros(3))      # crossing at mesh 32 x 4
    tabs, fh = _tables(_disp64(), pose, width=80, height=48, mesh=(32, 4))
    tris = tr._mesh_constants(32, 4, CPU)[2]
    n_oct = tabs.octs_w * tabs.octs_h
    keys, octs = tr.slot_stage(tabs.crow, tabs.total_covered, 80, fh, tabs.octs_w, n_oct,
                               32 - tabs.id_bits, tabs.id_bits)
    key_img = tr._resolve(keys, octs, tabs, 80, 48)
    calls = []
    plain = tr.giant_pass_reference
    monkeypatch.setattr(tr, "giant_pass_reference",
                        lambda *a: calls.append(a[0].shape[0]) or plain(*a))
    k9 = _launches("launch_giant_kernel")
    got, counts = tr._giant_pass(tabs.clip, tris, tabs.score, key_img, 80, 48, 64, tabs.id_bits)
    ids, ok, active = tr._giant_selection(tabs.score, 64)
    groups = -(-int(active) // 32)
    assert counts.tolist() == [int(active), groups] and ids.shape == (2, 32)
    assert calls == [groups] and groups > 0 and _launches("launch_giant_kernel") == k9
    assert torch.isinf(tabs.score[ids[ok]]).any()
    want = key_img
    for g in range(groups):
        want = plain(ids[g:g + 1], ok[g:g + 1], tabs.clip, tris, tabs.score, want, 80, 48, 48, 0,
                     tabs.id_bits)
    assert torch.equal(got, want) and (got < key_img).sum() > 100 and (got <= key_img).all()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tr.launch_giant_kernel(ids, ok, tabs.clip, tris, tabs.score, key_img,
                               80, 48, 48, 0, tabs.id_bits)


# (pose, pool, giants): a natural pose whose crossing triangles fill part of
# the first group, and a pool starved below the slot demand (1,232 slots at
# the default camera), whose 229 overflowing triangles fill 8 of 10 groups.
WHOLE_CASES = [((np.array([20.0, 1.5, 45.0]), np.zeros(3)), POOL, 128),
               (None, 800, 320)]


@pytest.mark.parametrize("pose, pool, giants", WHOLE_CASES, ids=["natural", "starved"])
def test_giant_pass_reference_whole_selection_equals_the_active_groups(pose, pool, giants):
    """K9's plain version over the whole selection, inactive groups and
    all, is bit-equal to the call over its active groups alone: an inactive
    candidate leaves every key as it was."""
    tabs, fh = _tables(_disp64(), pose, width=80, height=48, mesh=(32, 4), pool=pool)
    tris = tr._mesh_constants(32, 4, CPU)[2]
    n_oct = tabs.octs_w * tabs.octs_h
    keys, octs = tr.slot_stage(tabs.crow, tabs.total_covered, 80, fh, tabs.octs_w, n_oct,
                               32 - tabs.id_bits, tabs.id_bits)
    key_img = tr._resolve(keys, octs, tabs, 80, 48)
    ids, ok, active = tr._giant_selection(tabs.score, giants)
    groups = -(-int(active) // 32)
    assert 0 < groups < ids.shape[0] and not ok[groups:].any()
    args = (tabs.clip, tris, tabs.score, key_img, 80, 48, 48, 0, tabs.id_bits)
    whole = tr.giant_pass_reference(ids, ok, *args)
    sliced = tr.giant_pass_reference(ids[:groups], ok[:groups], *args)
    assert torch.equal(whole, sliced) and (whole < key_img).any()


def test_wrappers_take_plain_versions_on_cpu():
    """CPU tensors go through the plain versions: no kernel is launched."""
    disp = _disp64()
    tabs, _ = _tables(disp)
    k7, k8 = _launches("launch_slot_kernel"), _launches("launch_segmin_kernel")
    img = tr.render_frame(torch.from_numpy(disp), Camera(), 96, 64, mesh_resolution=64,
                          pool=POOL)
    assert img.device.type == "cpu" and torch.isfinite(img).all()
    assert (_launches("launch_slot_kernel"), _launches("launch_segmin_kernel")) == (k7, k8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tr.launch_slot_kernel(tabs.crow, torch.zeros(2, dtype=torch.int32), 96, 64,
                              tabs.octs_w, 0, 32 - tabs.id_bits, tabs.id_bits)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tr.launch_segmin_kernel(torch.zeros(4, dtype=torch.int32),
                                torch.zeros((5, 4), dtype=torch.int32), 2, 17)
