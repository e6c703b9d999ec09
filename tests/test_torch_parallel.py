"""The port's ``parallel/`` on an 8-position CPU mesh, against the JAX
package's ``parallel/`` on its 8 virtual CPU devices (``tests/conftest.py``)
and against the port's single-device paths, on the same numpy-seeded
inputs.

Each test of ``tests/test_parallel.py`` has its counterpart here (the JAX
tests marked slow too, at the same sizes: the port's mesh on the host is
plain PyTorch and fast), plus the port's own pieces: the sharded values,
the copy-based collectives, K2's two windows of the state and the halo rows
of the normals and foam. The port's mesh is ``[cpu] * 8``; the "pallas"
route runs K1-K3's plain versions. The tolerances are the JAX tests' own
(atol 1e-4 on fields, 1e-5 / 1e-4 rel against numpy, rtol 1e-4 atol 5e-3 on
checksums) and 1e-6 rel at "highest" against the JAX package; the port's
sharded paths against its single-device ones are bit-equal where the
arithmetic is the same element by element, and within 1e-6 rel where a
band's matrix product may be blocked differently from the whole grid's
(``BAND_TOL``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu import parallel as jpar
from gfx_ocean_tpu.golden.reference import golden_fields
from gfx_ocean_tpu_torch import parallel as tpar
from gfx_ocean_tpu_torch.models.ocean import OceanState, downsample_state
from gfx_ocean_tpu_torch.ops import fourstep_step as fs
from gfx_ocean_tpu_torch.ops.fft import ifft2_planes_unnorm, ifft2_real_unnorm
from gfx_ocean_tpu_torch.ops.propagate import band_windows, gather_packed_planes
from gfx_ocean_tpu_torch.parallel import collectives as coll
from gfx_ocean_tpu_torch.parallel.distributed_fft import pallas_fourstep_fields_sharded
from gfx_ocean_tpu_torch.parallel.render import replicate_state
from gfx_ocean_tpu_torch.render.camera import Camera, perspective, scripted_camera
from gfx_ocean_tpu_torch.render.raster import make_batch_renderer, make_frame_renderer

CPU = torch.device("cpu")
# A band's matrix products against the whole grid's, relative to the
# field's largest value: the same sums, which a BLAS may block otherwise
# for another row count.
BAND_TOL = 1e-6
FIELD_ATOL = 1e-4                      # tests/test_parallel.py's fields
CHECKSUM = dict(rtol=1e-4, atol=5e-3)  # tests/test_parallel.py's checksums


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its eight host positions
    issue many small products one after another, which threads only slow
    when the test workers already fill the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    """(port 2 x 4, JAX 2 x 4): tests/test_parallel.py's mesh8."""
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return tpar.make_mesh([CPU] * 8, batch=2, row=4), jpar.make_mesh(batch=2, row=4)


def _state(seed: int, n: int, batch=None):
    """tests/test_parallel.py's _rand_state from a numpy seed: (port, JAX)."""
    rng = np.random.default_rng(seed)
    shape = (batch, n, n) if batch else (n, n)
    h0 = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.1
    omega = (np.abs(rng.standard_normal(shape)) + 0.1).astype(np.float32)
    pair = np.stack([h0.real, h0.imag], axis=-3).astype(np.float32)
    return (OceanState(torch.from_numpy(pair), torch.from_numpy(omega)),
            J.OceanState(h0=jnp.asarray(pair), omega=jnp.asarray(omega)))


def _planes(seed: int, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x, torch.from_numpy(x.real.astype(np.float32)), torch.from_numpy(
        x.imag.astype(np.float32))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# --------------------------------------------------------------------------
# The mesh, sharded values and collectives.
# --------------------------------------------------------------------------

def test_mesh_shape_validation():
    with pytest.raises(ValueError):
        tpar.make_mesh([CPU] * 8, batch=3)  # 3 does not divide 8
    mesh = tpar.make_mesh([CPU] * 8, batch=2)
    assert mesh.shape == {"batch": 2, "row": 4} and len(mesh.positions()) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.make_mesh()


def test_shard_and_gather_round_trip(meshes):
    mesh, _ = meshes
    x = torch.arange(2 * 3 * 8 * 5, dtype=torch.float32).reshape(2, 3, 8, 5)
    for spec in [("batch", None, "row", None), (None, None, "row"), ("batch",), ()]:
        s = tpar.shard(x, mesh, spec)
        assert torch.equal(s.gather(), x), spec
        assert all(t.is_contiguous() for t in s.shards)
    s = tpar.shard(x, mesh, ("batch", None, "row", None))
    assert s.shard((1, 2)).shape == (1, 3, 2, 5)
    assert torch.equal(s.shard((1, 2)), x[1:, :, 4:6])
    with pytest.raises(ValueError, match="does not divide"):
        tpar.shard(x, mesh, (None, "row"))        # 3 rows over 4 positions


def test_collectives_against_their_global_meaning():
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    blocks = list(x.split(2, dim=0))                # 4 positions, 2 rows each
    cols = coll.all_to_all(blocks, split_dim=-1, concat_dim=-2)
    assert all(torch.equal(c, x[:, 3 * j:3 * j + 3]) for j, c in enumerate(cols))
    back = coll.all_to_all(cols, split_dim=-2, concat_dim=-1)
    assert all(torch.equal(b, blk) for b, blk in zip(back, blocks))
    assert torch.equal(coll.gather_rows(blocks, -1, 4, CPU), x[[7, 0, 1, 2]])
    assert torch.equal(coll.gather_rows(blocks, 5, 6, CPU), x[[5, 6, 7, 0, 1, 2]])
    halo = coll.halo_rows(blocks)
    assert torch.equal(halo[0], x[[7, 0, 1, 2]]) and torch.equal(halo[3], x[[5, 6, 7, 0]])
    partials = [torch.tensor([1.0, 2.0]) * i for i in range(4)]
    assert torch.equal(coll.ordered_sum(partials), torch.tensor([6.0, 12.0]))
    mesh = tpar.make_mesh([CPU] * 8, batch=2, row=4)
    assert coll.axis_index(mesh, "row", (1, 3)) == 3 and coll.axis_index(mesh, "batch", (1, 3)) == 1
    with pytest.raises(ValueError, match="does not split"):
        coll.all_to_all([x[:2, :10]] * 4, split_dim=-1, concat_dim=-2)


# --------------------------------------------------------------------------
# K2's two windows: the reads of a row band.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("conj_neg", [False, True])
def test_windows_gather_equals_the_band_of_the_full_gather(conj_neg):
    """At every band base b, 0 (the wrap of row b - 1) included, the
    windows' gather is bit-equal to the band of the whole state's, for one
    field and for a cascade stack."""
    n, rows = 32, 8
    rng = np.random.default_rng(5)
    for lead in ((), (2,)):
        h0 = torch.from_numpy(rng.standard_normal(lead + (2, n, n)).astype(np.float32))
        om = torch.from_numpy(rng.standard_normal(lead + (n, n)).astype(np.float32))
        full = gather_packed_planes(h0, om, conj_neg)
        for b in range(n - rows + 1):
            got = gather_packed_planes(None, None, conj_neg, rows, b,
                                       band_windows(h0, om, b, rows))
            for g, f in zip(got, full):
                assert torch.equal(g, f[..., b:b + rows, :]), (lead, b)


def test_k2_plain_version_on_windows_equals_its_band():
    """fourstep_row_reference reading a band's windows equals the band of
    its whole-grid Y, at the first band (the wrap) and the last."""
    n, rows = 1024, 128
    (state, _) = _state(11, n)
    cfg = T.OceanConfig(resolution=n, fft_impl="pallas")
    full = fs.hoist_fourstep(state.h0, state.omega, cfg)
    band_inputs = fs.FourstepInputs(None, None, full.twiddle)
    for b in (0, n - rows):
        want = fs.fourstep_row_reference(full, [3.5], cfg, row_base=b, rows=rows)
        got = fs.fourstep_row_reference(band_inputs, [3.5], cfg, b, rows,
                                        band_windows(state.h0, state.omega, b, rows))
        assert torch.equal(got, want), b
    with pytest.raises(ValueError, match="windows"):
        fs.fourstep_row_reference(band_inputs, [3.5], cfg, 0, rows,
                                  band_windows(state.h0, state.omega, 0, rows // 2))


# --------------------------------------------------------------------------
# The distributed FFT.
# --------------------------------------------------------------------------

def test_distributed_fft_matches_numpy(meshes):
    mesh, jmesh = meshes
    n = 128
    x, xr, xi = _planes(1, (n, n))
    got = tpar.ifft2_real_unnorm_sharded(xr, xi, mesh, precision="highest").gather()
    want = np.real(np.fft.ifft2(x) * n * n)
    assert _rel(got, want) < 1e-5
    jgot = jpar.ifft2_real_unnorm_sharded(jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()),
                                          jmesh, precision="highest")
    assert _rel(got, jgot) < 1e-6


def test_distributed_fft_batched(meshes):
    mesh, _ = meshes
    n = 64
    x, xr, xi = _planes(2, (3, n, n))
    got = tpar.ifft2_real_unnorm_sharded(xr, xi, mesh, precision="highest").gather()
    assert _rel(got, np.real(np.fft.ifft2(x) * n * n)) < 1e-5
    # a leading axis over "batch" (2 of them here)
    _, br, bi = _planes(3, (2, n, n))
    got = tpar.ifft2_real_unnorm_sharded(br, bi, mesh, precision="highest",
                                         leading_axes=["batch"])
    assert got.spec == ("batch", "row", None)
    assert _rel(got.gather(), ifft2_real_unnorm(br, bi, precision="highest")) < BAND_TOL


def test_distributed_fft_four_step(meshes):
    """direct_max below N: the four-step split inside the shard body."""
    mesh, _ = meshes
    n = 128
    x, xr, xi = _planes(4, (n, n))
    got = tpar.ifft2_real_unnorm_sharded(xr, xi, mesh, precision="highest",
                                         direct_max=32).gather()
    assert _rel(got, np.real(np.fft.ifft2(x) * n * n)) < 1e-5


@pytest.mark.parametrize("centered", ["ref", "canonical"])
def test_distributed_fft_centered_matches_single_chip(meshes, centered):
    mesh, jmesh = meshes
    n = 64
    _, xr, xi = _planes(5, (n, n))
    got = tpar.ifft2_real_unnorm_sharded(xr, xi, mesh, precision="highest",
                                         centered=centered).gather()
    want = ifft2_real_unnorm(xr, xi, precision="highest", centered=centered)
    assert _rel(got, want) < BAND_TOL
    jgot = jpar.ifft2_real_unnorm_sharded(jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()),
                                          jmesh, precision="highest", centered=centered)
    assert _rel(got, jgot) < 1e-6


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x4", "high", "highest", "default"])
def test_distributed_fft_every_tier(meshes, precision):
    """Each tier runs the single-device passes on the bands: the sharded
    transform is the port's single-device one (held to the JAX package's
    tiers by tests/test_torch_precision.py) within BAND_TOL, and the split
    tiers are within the JAX test's 1e-4 of numpy."""
    mesh, _ = meshes
    n = 64
    x, xr, xi = _planes(6, (n, n))
    got = tpar.ifft2_real_unnorm_sharded(xr, xi, mesh, precision=precision).gather()
    assert _rel(got, ifft2_real_unnorm(xr, xi, precision=precision)) < BAND_TOL
    if precision in ("bf16x3", "bf16x4"):
        assert _rel(got, np.real(np.fft.ifft2(x) * n * n)) < 1e-4
    pr, pi = tpar.ifft2_planes_unnorm_sharded(xr, xi, mesh, precision=precision)
    wr, wi = ifft2_planes_unnorm(xr, xi, precision=precision)
    assert _rel(pr.gather(), wr) < BAND_TOL and _rel(pi.gather(), wi) < BAND_TOL


def test_distributed_fft_planes_matches_single_chip(meshes):
    mesh, jmesh = meshes
    n = 64
    _, xr, xi = _planes(7, (n, n))
    gr, gi = tpar.ifft2_planes_unnorm_sharded(xr, xi, mesh, precision="highest",
                                              centered="ref")
    jr, ji = jpar.ifft2_planes_unnorm_sharded(jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()),
                                              jmesh, precision="highest", centered="ref")
    scale = np.abs(np.asarray(jr)).max()
    assert np.abs(gr.gather().numpy() - np.asarray(jr)).max() < 1e-6 * scale
    assert np.abs(gi.gather().numpy() - np.asarray(ji)).max() < 1e-6 * scale


# --------------------------------------------------------------------------
# The sharded step and rollout.
# --------------------------------------------------------------------------

def _jax_fields(jfields):
    return [None if f is None else np.asarray(f) for f in jfields]


@pytest.mark.parametrize("fft", ["gspmd", "shard_map"])
def test_sharded_step_matches_single_device(meshes, fft):
    """tests/test_parallel.py::test_sharded_step_matches_single_device and
    ::test_sharded_step_shard_map_fft: batched, with normals; against the
    port's single-device step, bit for bit, and the JAX sharded step under
    the same name at "highest" (the default "bf16x3" of the JAX package on
    the CPU keeps its split's low part unrounded: tests/test_torch_precision.py)."""
    mesh, jmesh = meshes
    state, jstate = _state(20, 64, batch=2)
    sstate = tpar.shard_state(state, mesh)
    for tier in ("bf16x3", "highest"):
        cfg = T.OceanConfig(resolution=64, compute_normals=True, matmul_precision=tier)
        want = T.make_step(cfg)(state, 2.5)
        got = tpar.make_sharded_step(cfg, mesh, fft=fft)(sstate, 2.5)
        assert got.displacement.spec == ("batch", "row", None, None)
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g.gather(), w)
    jcfg = J.OceanConfig(resolution=64, compute_normals=True, matmul_precision="highest")
    jgot = jpar.make_sharded_step(jcfg, jmesh, fft=fft)(jpar.shard_state(jstate, jmesh),
                                                        jnp.float32(2.5))
    assert _rel(got.displacement.gather(), jgot.displacement) < 1e-6
    np.testing.assert_allclose(got.normals.gather().numpy(), np.asarray(jgot.normals),
                               atol=FIELD_ATOL, rtol=0)


def test_step_takes_the_jax_hooks():
    """``step(..., ifft2=, ifft2_planes=, pallas_disp=)`` as in the JAX
    package: drop-in transforms replace the route's (each called once a
    frame at its tier) and ``pallas_disp(pre, ts)`` the fused step."""
    state, _ = _state(27, 64)
    calls = []

    def counted(fn):
        def hook(xr, xi, precision, centered):
            calls.append(precision)
            return fn(xr, xi, precision=precision, centered=centered)
        return hook

    for pack in (False, True):
        cfg = T.OceanConfig(resolution=64, hermitian_pack=pack, choppy_precision="highest")
        got = T.step(state, 1.5, cfg, ifft2=counted(ifft2_real_unnorm),
                     ifft2_planes=counted(ifft2_planes_unnorm))
        assert torch.equal(got.displacement, T.step(state, 1.5, cfg).displacement)
    assert calls == ["bf16x3", "highest", "bf16x3", "highest"]
    cfg = T.OceanConfig(resolution=64, fft_impl="pallas")
    disp = torch.zeros(1, 64, 64, 3)
    assert torch.equal(T.step(state, 1.5, cfg, pallas_disp=lambda pre, ts: disp).displacement,
                       disp[0])


def test_sharded_step_unbatched(meshes):
    mesh, _ = meshes
    cfg = T.OceanConfig(resolution=64, compute_normals=False)
    state, _ = _state(21, 64)
    want = T.make_step(cfg)(state, 1.0)
    got = tpar.make_sharded_step(cfg, mesh, batched=False)(tpar.shard_state(state, mesh), 1.0)
    assert got.displacement.spec == ("row", None, None) and got.normals is None
    assert torch.equal(got.displacement.gather(), want.displacement)


def test_sharded_step_vs_golden(meshes):
    mesh, _ = meshes
    cfg = T.OceanConfig(resolution=64, compute_normals=False)
    state, _ = _state(22, 64, batch=2)
    got = tpar.make_sharded_step(cfg, mesh)(tpar.shard_state(state, mesh), 3.0)
    disp = got.displacement.gather().numpy()
    h0 = state.h0.numpy()
    for b in range(2):
        want = golden_fields(h0[b, 0] + 1j * h0[b, 1], state.omega[b].numpy(), 3.0,
                             cfg.domain_size, J.OceanConfig().compat)
        assert _rel(disp[b], want) < 1e-4


@pytest.mark.parametrize("fft", ["gspmd", "shard_map"])
def test_sharded_step_packed_both_strategies(meshes, fft):
    """The packed configuration under both names == single device; with foam
    and two cascades over the batch axis (each batch position's cascade
    takes its own domain) the halo rows give the single-device foam."""
    mesh, jmesh = meshes
    state, jstate = _state(23, 64, batch=2)
    cfg = T.OceanConfig(resolution=64, compute_normals=True, hermitian_pack=True,
                        compute_foam=True, num_cascades=2)
    want = T.make_step(cfg)(state, 2.5)
    got = tpar.make_sharded_step(cfg, mesh, fft=fft)(tpar.shard_state(state, mesh), 2.5)
    for g, w in zip(got, want):
        assert torch.equal(g.gather(), w)
    jcfg = J.OceanConfig(resolution=64, compute_normals=True, hermitian_pack=True)
    jgot = jpar.make_sharded_step(jcfg, jmesh, fft=fft)(jpar.shard_state(jstate, jmesh),
                                                        jnp.float32(2.5))
    # "bf16x3" on both sides: the JAX test's field tolerance, 1.5x (the two
    # packages' splits round the low part apart on the CPU, measured 1.4e-4)
    np.testing.assert_allclose(got.displacement.gather().numpy(), np.asarray(jgot.displacement),
                               atol=1.5 * FIELD_ATOL, rtol=0)


def test_sharded_rollout_matches_single_device(meshes):
    mesh, jmesh = meshes
    cfg = T.OceanConfig(resolution=64, compute_normals=False)
    state, jstate = _state(24, 64, batch=2)
    ts = np.arange(4, dtype=np.float32) * 0.25
    got = tpar.make_sharded_rollout(cfg, mesh)(tpar.shard_state(state, mesh), ts).numpy()
    want = T.make_rollout(cfg, keep_fields=False)(state, ts).numpy()
    np.testing.assert_allclose(got, want, **CHECKSUM)
    jwant = np.asarray(J.make_rollout(J.OceanConfig(resolution=64, compute_normals=False),
                                      keep_fields=False)(jstate, jnp.asarray(ts)))
    np.testing.assert_allclose(got, jwant, **CHECKSUM)


@pytest.mark.parametrize("pack", [False, True])
def test_sharded_rollout_shard_map_and_time_batched(meshes, pack):
    """tests/test_parallel.py's shard_map, time-batched and packed rollouts:
    each agrees with the gspmd-named rollout, and with the unbatched
    rollout on the 2 x 4 mesh (a copy a batch position, summed once)."""
    mesh, _ = meshes
    cfg = T.OceanConfig(resolution=64, compute_normals=True, hermitian_pack=pack)
    state, _ = _state(25, 64, batch=2)
    ts = np.arange(4, dtype=np.float32) * 0.25
    sstate = tpar.shard_state(state, mesh)
    base = tpar.make_sharded_rollout(cfg, mesh)(sstate, ts).numpy()
    for kw in (dict(fft="shard_map"), dict(time_batch=2), dict(fft="shard_map", time_batch=2)):
        np.testing.assert_allclose(tpar.make_sharded_rollout(cfg, mesh, **kw)(sstate, ts).numpy(),
                                   base, **CHECKSUM)
    one = OceanState(state.h0[0], state.omega[0])
    got = tpar.make_sharded_rollout(cfg, mesh, batched=False)(tpar.shard_state(one, mesh), ts)
    want = T.make_rollout(cfg, keep_fields=False)(one, ts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CHECKSUM)
    with pytest.raises(ValueError, match="time_batch"):
        tpar.make_sharded_rollout(cfg, mesh, time_batch=3)(sstate, ts)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX package's fused step in Pallas interpret mode, as
    tests/test_torch_cascades.py runs it on the CPU."""
    from gfx_ocean_tpu.ops import pallas_step as ps

    orig = ps.pallas_fields
    monkeypatch.setattr(ps, "pallas_fields",
                        lambda h0, om, t, cfg, interpret=False: orig(h0, om, t, cfg, True))


def test_sharded_pallas_small_grid_under_gspmd(meshes, interpret_pallas):
    """"pallas" at 64^2 under "gspmd": each position runs K1's plain version
    on the gathered state and keeps its rows, bit-equal to the single-device
    step; the JAX package's gspmd step on the same state agrees within 1e-6
    at "highest" (at a bf16 tier the two sides' sums run in another order,
    and a split's rounding then differs now and then)."""
    mesh, jmesh = meshes
    state, jstate = _state(26, 64)
    cfg = T.OceanConfig(resolution=64, fft_impl="pallas", compute_normals=True,
                        matmul_precision="highest")
    got = tpar.make_sharded_step(cfg, mesh, batched=False)(tpar.shard_state(state, mesh), 2.0)
    want = T.make_step(cfg)(state, 2.0)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g.gather(), w)
    ck = tpar.make_sharded_rollout(cfg, mesh, batched=False, time_batch=2)(
        tpar.shard_state(state, mesh), [0.5, 1.0])
    np.testing.assert_allclose(ck.numpy(), T.make_rollout(cfg, keep_fields=False)(
        state, [0.5, 1.0]).numpy(), **CHECKSUM)
    jcfg = J.OceanConfig(resolution=64, fft_impl="pallas", compute_normals=True,
                         matmul_precision="highest")
    jgot = jpar.make_sharded_step(jcfg, jmesh, batched=False)(jpar.shard_state(jstate, jmesh),
                                                              jnp.float32(2.0))
    assert _rel(got.displacement.gather(), jgot.displacement) < 1e-6


@pytest.fixture(scope="module")
def fourstep_1024():
    """tests/test_parallel.py's 1024^2 four-step case over a 1 x 8 mesh."""
    state, jstate = _state(30, 1024)
    mesh = tpar.make_mesh([CPU] * 8, batch=1, row=8)
    return state, jstate, mesh, tpar.shard_state(state, mesh)


@pytest.mark.parametrize("fft", ["shard_map", "gspmd"])
def test_sharded_pallas_fourstep_step(fourstep_1024, fft):
    """"pallas" at 1024^2 over 1 x 8: K2 on each band from its windows, an
    all_to_all, K3 on each column band, an all_to_all back (plain versions
    here). Bit-equal to the port's single-device plain planes (each row of
    K2 and each column of K3 computes alone), and within 1e-6 of the JAX
    package's sharded matmul step at "highest"."""
    state, jstate, mesh, sstate = fourstep_1024
    cfg = T.OceanConfig(resolution=1024, fft_impl="pallas", matmul_precision="highest",
                        compute_normals=False)
    got = tpar.make_sharded_step(cfg, mesh, batched=False, fft=fft)(sstate, 2.0)
    got = got.displacement.gather()
    assert torch.equal(got, T.make_step(cfg)(state, 2.0).displacement)
    if fft == "shard_map":
        jmesh = jpar.make_mesh(batch=1, row=8)
        jcfg = J.OceanConfig(resolution=1024, fft_impl="matmul", hermitian_pack=False,
                             matmul_precision="highest", compute_normals=False)
        jm = jpar.make_sharded_step(jcfg, jmesh, batched=False, fft="shard_map")(
            jpar.shard_state(jstate, jmesh), jnp.float32(2.0))
        assert _rel(got, jm.displacement) < 1e-6
        disp = pallas_fourstep_fields_sharded(
            state.h0, state.omega, 2.0, cfg, mesh)
        assert torch.equal(disp.gather(), got)


def test_sharded_pallas_fourstep_rollout_and_cascades(fourstep_1024):
    """The rollout hoists the windows once; a cascade batch over a 1 x 8
    mesh runs one cascade a K2 + K3 pass and equals the unbatched run."""
    state, _, mesh, sstate = fourstep_1024
    cfg = T.OceanConfig(resolution=1024, fft_impl="pallas", matmul_precision="highest",
                        compute_normals=False)
    cks = tpar.make_sharded_rollout(cfg, mesh, batched=False, fft="shard_map")(sstate, [0.0, 0.5])
    assert cks.shape == (2,) and torch.isfinite(cks).all()
    np.testing.assert_allclose(cks.numpy(), T.make_rollout(cfg, keep_fields=False)(
        state, [0.0, 0.5]).numpy(), **CHECKSUM)
    one = tpar.make_sharded_step(cfg, mesh, batched=False, fft="shard_map")(sstate, 2.0)
    pair = OceanState(torch.stack([state.h0, state.h0]), torch.stack([state.omega] * 2))
    two = tpar.make_sharded_step(cfg, mesh, batched=True, fft="shard_map")(
        tpar.shard_state(pair, mesh), 2.0).displacement.gather()
    assert two.shape == (2, 1024, 1024, 3)
    assert torch.equal(two[0], two[1]) and torch.equal(two[0], one.displacement.gather())


def test_sharded_pallas_validation(meshes):
    """batch > 1 meshes with "shard_map" and grids the four-step plan does
    not take raise, as the JAX package's; unknown names raise."""
    mesh, _ = meshes
    with pytest.raises(ValueError, match="batch=1"):
        tpar.make_sharded_step(T.OceanConfig(resolution=1024, fft_impl="pallas"), mesh,
                               fft="shard_map")
    mesh8 = tpar.make_mesh([CPU] * 8, batch=1, row=8)
    state, _ = _state(31, 256)
    with pytest.raises(ValueError, match="four-step"):
        tpar.make_sharded_step(T.OceanConfig(resolution=256, fft_impl="pallas"), mesh8,
                               batched=False, fft="shard_map")(
            tpar.shard_state(state, mesh8), 1.0)
    with pytest.raises(ValueError, match="gspmd"):
        tpar.make_sharded_step(T.OceanConfig(resolution=64), mesh, fft="nccl")
    with pytest.raises(ValueError, match="shard_state"):
        tpar.make_sharded_step(T.OceanConfig(resolution=64), mesh, batched=False)(state, 1.0)


# --------------------------------------------------------------------------
# Band-parallel frames.
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame_setup():
    state = downsample_state(T.ocean_state_from_assets(device="cpu"), 64)
    cfg = T.OceanConfig(resolution=64, mesh_resolution=32)
    return state, cfg, 96, 64


def _view(cam: Camera, w: int, h: int):
    return (torch.from_numpy((perspective(w / h) @ cam.view()).astype(np.float32)),
            torch.from_numpy(cam.position.astype(np.float32)))


def test_sharded_frame_renderer_bit_equal(meshes, frame_setup):
    """Bands over "row" of the 2 x 4 mesh, and over all 8 positions, stack
    into the single-device frame bit for bit."""
    mesh, _ = meshes
    state, cfg, w, h = frame_setup
    vp, cp = _view(Camera(), w, h)
    want = make_frame_renderer(cfg, w, h, giants=64)(state, 7.0, vp, cp)
    got = tpar.make_sharded_frame_renderer(cfg, mesh, w, h, giants=64, axis="row")(
        state, 7.0, vp, cp)
    assert got.spec == ("row", None, None) and torch.equal(got.gather(), want)
    full = tpar.make_mesh([CPU] * 8, batch=1)
    got8 = tpar.make_sharded_frame_renderer(cfg, full, w, h, giants=64)(state, 7.0, vp, cp)
    assert torch.equal(got8.gather(), want)


def test_sharded_frame_renderer_validates_height(meshes):
    mesh, _ = meshes
    with pytest.raises(ValueError, match="height"):
        tpar.make_sharded_frame_renderer(T.OceanConfig(resolution=64), mesh, 96, 50,
                                         axis="row")   # 50 % 4 != 0


def test_sharded_batch_renderer_bit_equal(meshes, frame_setup):
    """Frames over "batch" x bands over "row" == make_batch_renderer; a
    frame count the batch axis does not divide raises."""
    mesh, _ = meshes
    state, cfg, w, h = frame_setup
    cams = [c for _, c in scripted_camera([(4, ["w"])], dt=0.2)]
    views = [_view(c, w, h) for c in cams]
    vps = torch.stack([v for v, _ in views])
    cps = torch.stack([c for _, c in views])
    ts = torch.arange(4, dtype=torch.float32) * 0.5
    want = make_batch_renderer(cfg, w, h, giants=64)(state, ts, vps, cps)
    fn = tpar.make_sharded_batch_renderer(cfg, mesh, w, h, giants=64)
    got = fn(replicate_state(state, mesh), ts, vps, cps)
    assert got.spec == ("batch", "row", None, None) and torch.equal(got.gather(), want)
    with pytest.raises(ValueError, match="frame count"):
        fn(state, ts[:3], vps[:3], cps[:3])   # 3 % batch=2 != 0


def test_band_fuzz_adversarial_poses_diag_clean(meshes, frame_setup):
    """tests/test_parallel.py's band fuzz: at poses whose horizon crosses
    band edges, with 16 giants, every band reports no dropped giant
    candidate and the bands stack into the single-device frame."""
    mesh, _ = meshes
    state, cfg, w, h = frame_setup
    one = make_frame_renderer(cfg, w, h, giants=16)
    band = tpar.make_sharded_frame_renderer(cfg, mesh, w, h, giants=16, axis="row", diag=True)
    for rx, ry in [(-0.6, -1.5), (-0.05, -1.5), (-0.35, -1.5), (0.25, -1.5), (-1.2, -0.3)]:
        cam = Camera()
        cam.rotation = np.array([rx, ry, 0.0])
        vp, cp = _view(cam, w, h)
        frame, dropped = band(state, 7.0, vp, cp)
        assert dropped.gather().tolist() == [0, 0, 0, 0], (rx, ry)
        assert torch.equal(frame.gather(), one(state, 7.0, vp, cp)), (rx, ry)
