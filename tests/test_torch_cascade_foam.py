"""BASELINE config 4 as the benchmark's cell ``ocean512_cascades.rollout``
runs it, on the CPU at 64^2: three cascades over 1000 / 250 / 62.5 m with
normals and the Jacobian foam, through ``make_rollout`` on "pallas" (K1t's
plain version, the cascade axis in one call) against the float64
reference of ``portbench/reference/cascades.py``; the foam's per-cascade
domain on a state on which every cascade foams; the rollout's derived
route's spans and counter; the derived stage's count
(``portbench/roofline_derived.py``); and kernel K10
(``ops/derived.derived_checksums``): on the CPU its plain version against
the fields' chain, on the card the kernel against its plain version (the
tests marked ``cuda`` skip without a GPU: a CUDA kernel has no CPU mode).

    python -m pytest tests/test_torch_cascade_foam.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_cascade_foam.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gfx_ocean_tpu_torch.models import ocean
from gfx_ocean_tpu_torch.models.ocean import OceanState, make_rollout
from gfx_ocean_tpu_torch.ops import derived, fused_step
from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
from gfx_ocean_tpu_torch.utils import profiling
from portbench import harness, program, roofline, roofline_derived
from portbench.drives import cascade_rollout
from portbench.reference import cascades

CELL = "ocean512_cascades.rollout"
N = 64
SEEDS = (2 ** 31 + 11, 5)
TS = np.array([0.0, 1.0 / 60.0, 2.0, 3.3], dtype=np.float32)
TIME_BATCH = 2
# Displacement against the float64 reference, relative to the cascade's
# max |field|: the "bf16x3" tier's own error (tests/test_torch_step.py
# GOLDEN, measured here up to 1.04e-5); "default" (one bf16 pass) reads
# 2.7e-3 and more.
DISP_TOL = 2e-5
# Normals are unit vectors: absolute. They difference the height over
# height_scale, so its error shows amplified by N / height_scale
# (tests/test_torch_step.py NORMALS_TOL; measured here up to 4.3e-5;
# "default" 1.4e-2).
NORMALS_TOL = 1e-4
# Checksums nearly cancel; held on the scale of their summands, plus one
# for every foam texel that differs from the reference's mask.
CHECKSUM_TOL = 1e-4
# A foam texel may differ from the reference's only where the float64
# Jacobian lies within FOAM_NEAR_FACTOR * lambda * E / h of the threshold:
# E = DISP_TOL * max |displacement| bounds the fields' error, each of the
# four central differences errs by at most E / h (h the cascade's spacing),
# and J's first-order error is (|1 + a| + |1 + b| + |c| + |d|) times that
# for the differences a, b, c, d; 8 covers differences up to 2 in size,
# more than these states reach (the reference's J stays above -1).
FOAM_NEAR_FACTOR = 8.0


def _cell(seed, **ocean_fields):
    return harness.load_cell(CELL, seed, "cpu", override={
        "config": {"ocean": {"resolution": N, **ocean_fields}}})


def _setup(seed, precision="bf16x3", scale=(1.0, 1.0, 1.0), **ocean_fields):
    """The cell's configuration at 64^2 and tier ``precision`` (with
    ``ocean_fields``), its state for ``seed`` with each cascade's h0 times
    ``scale``."""
    cell = _cell(seed, matmul_precision=precision, **ocean_fields)
    h0, omega = cascade_rollout.state(cell, seed)
    h0 = h0 * torch.tensor(scale, dtype=h0.dtype)[:, None, None, None]
    return cell, program.ocean_config(cell), OceanState(h0, omega)


def _near(cell, ref, c):
    """The Jacobian's margin around the threshold for cascade ``c``."""
    ocean_group = cell.config["ocean"]
    spacing = cascades.domains(ocean_group)[c] / N
    err = DISP_TOL * float(ref[c].displacement.abs().max())
    return FOAM_NEAR_FACTOR * ocean_group["foam_lambda"] * err / spacing


def _compare(cell, config, state):
    """The worst displacement and normal gaps over the frames and
    cascades, and the foam texels that differ from the reference's mask
    farther from the threshold than the margin allows."""
    fields = make_rollout(config, keep_fields=True, time_batch=TIME_BATCH)(state, TS)
    worst = {"disp": 0.0, "normals": 0.0, "far_flips": 0}
    for i, t in enumerate(TS.tolist()):
        ref = cascades.cascades(state.h0, state.omega, t, cell.config["ocean"])
        for c, r in enumerate(ref):
            d = fields.displacement[i, c].double()
            worst["disp"] = max(worst["disp"],
                                float((d - r.displacement).abs().max() / r.displacement.abs().max()))
            worst["normals"] = max(worst["normals"],
                                   float((fields.normals[i, c].double() - r.normals).abs().max()))
            differ = fields.foam[i, c].double() != r.foam
            far = (r.jacobian - cell.config["ocean"]["foam_threshold"]).abs() >= _near(cell, ref, c)
            worst["far_flips"] += int((differ & far).sum())
    return worst, fields


@pytest.mark.parametrize("seed", SEEDS)
def test_cascades_match_the_float64_reference(seed):
    cell, config, state = _setup(seed)
    assert config.num_cascades == 3 and config.compute_foam and config.fft_impl == "pallas"
    worst, _ = _compare(cell, config, state)
    assert worst["disp"] < DISP_TOL and worst["normals"] < NORMALS_TOL, worst
    assert worst["far_flips"] == 0, worst


def test_default_tier_fails_the_tolerances():
    """One bf16 pass, the tier below the configuration's, fails at least
    one tolerance."""
    cell, config, state = _setup(SEEDS[0], "default")
    worst, _ = _compare(cell, config, state)
    assert worst["disp"] > DISP_TOL or worst["normals"] > NORMALS_TOL, worst


@pytest.mark.parametrize("seed", SEEDS)
def test_checksums_match_the_reference(seed):
    cell, config, state = _setup(seed)
    got = make_rollout(config, keep_fields=False, time_batch=TIME_BATCH)(state, TS)
    fields = make_rollout(config, keep_fields=True, time_batch=TIME_BATCH)(state, TS)
    assert got.shape == (len(TS),)
    for i, t in enumerate(TS.tolist()):
        want, scale, jac = cascades.checksum_terms(state.h0, state.omega, t,
                                                   cell.config["ocean"])
        ref_foam = (jac < cell.config["ocean"]["foam_threshold"]).double()
        flips = int((fields.foam[i].double() != ref_foam).sum())
        assert abs(float(got[i]) - want) <= CHECKSUM_TOL * scale + flips, (i, float(got[i]), want)


# Each cascade's h0 scaled so that every cascade foams at 64^2 (unscaled,
# the 62.5-m cascade's Jacobian stays above 0.85).
SCALE = (1.0, 2.0, 8.0)


def test_every_cascade_foams_at_its_own_domain():
    cell, config, state = _setup(SEEDS[0], scale=SCALE)
    ref = cascades.cascades(state.h0, state.omega, float(TS[2]), cell.config["ocean"])
    assert all(float(r.foam.sum()) > 0 for r in ref)
    worst, fields = _compare(cell, config, state)
    assert worst["far_flips"] == 0 and worst["disp"] < DISP_TOL, worst
    assert all(float(fields.foam[:, c].sum()) > 0 for c in range(3))


def test_foam_at_the_wrong_domain_fails(monkeypatch):
    """A foam pass that takes ``config.domain_size`` for every cascade fails
    the comparison on the state on which every cascade foams."""
    cell, config, state = _setup(SEEDS[0], scale=SCALE)
    real = ocean._fields

    def one_domain(disp, config, cascaded, halo=None, domains=None):
        return real(disp, config, cascaded, halo,
                    domains=(config.domain_size,) * config.num_cascades)

    monkeypatch.setattr(ocean, "_fields", one_domain)
    worst, _ = _compare(cell, config, state)
    assert worst["far_flips"] > 0, worst


def _recorded(work):
    with profiling.recording():
        out = work()
    return out, [u for u in profiling.windows()[-1].units if u.name == "rollout"]


def test_derived_route_records_its_spans_and_foam_count():
    cell, config, state = _setup(SEEDS[0])
    rollout = make_rollout(config, keep_fields=False, time_batch=TIME_BATCH)
    want = rollout(state, TS)
    got, (unit,) = _recorded(lambda: rollout(state, TS))
    assert torch.equal(got, want)
    chunks = len(TS) // TIME_BATCH
    names = [s.name for s in unit.spans]
    assert names.count("rollout.step") == names.count("rollout.derived") == chunks
    inside = unit.named("rollout.launches")[0]
    assert all(s.parent is inside for s in unit.named("rollout.step") + unit.named("rollout.derived"))
    fields = make_rollout(config, keep_fields=True, time_batch=TIME_BATCH)(state, TS)
    assert unit.counters["foam.texels"] == int(fields.foam.sum()) > 0


def test_fused_route_records_neither():
    """Without foam the "pallas" route reduces the checksums in the fused
    kernels' pass: no derived span, no foam count."""
    _, config, state = _setup(SEEDS[0], compute_foam=False)
    _, (unit,) = _recorded(lambda: make_rollout(config, keep_fields=False,
                                                time_batch=TIME_BATCH)(state, TS))
    names = [s.name for s in unit.spans]
    assert names == ["rollout", "rollout.times", "rollout.precompute", "rollout.launches"]
    assert "foam.texels" not in unit.counters


def test_derived_bound_by_hand():
    cell = harness.load_cell(CELL, 1, "cpu")
    b = roofline_derived.derived_bound(cell.config)     # three 512^2 cascades' planes a frame
    assert b["by"] == "bytes" and b["bytes"] == 3 * 12 * 512 ** 2 + 4
    assert b["seconds"] == pytest.approx((3 * 12 * 512 ** 2 + 4) / roofline.HBM_BYTES_PER_S)
    assert b["flops"] == 3 * 40 * 512 ** 2
    one = harness.merge(cell.config, {"ocean": {"resolution": 4096, "num_cascades": 1,
                                                "compute_foam": False}})
    b = roofline_derived.derived_bound(one)             # no foam: 3 + 18 operations a texel
    assert b["bytes"] == 12 * 4096 ** 2 + 4 and b["flops"] == 21 * 4096 ** 2
    assert b["seconds"] == pytest.approx((12 * 4096 ** 2 + 4) / 3.35e12)


# --------------------------------------------------------------------------
# K10, the derived stage in one kernel, and its plain version.
# --------------------------------------------------------------------------

def _planes(config, state, ts):
    """K1's planes (tb, C, 3, N, N) of ``state`` at the times ``ts``, as
    the rollout's derived route takes them (plane-major)."""
    inputs = fused_step.hoist_packed(state.h0, state.omega, config)
    return fused_step.packed_planes(inputs, torch.as_tensor(ts, device=state.omega.device), config)


def _layouts(planes):
    """``planes`` (tb, C, 3, N, N) with the frame axis outer in memory and
    with the cascade axis outer (K1's launch writes them cascade-major)."""
    frame_major = planes.contiguous()
    cascade_major = planes.transpose(0, 1).contiguous().transpose(0, 1)
    return {"frame_major": frame_major, "cascade_major": cascade_major}


def _fields_chain(planes, config, cascaded=True):
    """The checksums ``make_rollout`` formed from the fields before K10:
    ``_checksums(_fields(...))`` of the channel-last view."""
    return ocean._checksums(ocean._fields(torch.movedim(planes, -3, -1), config, cascaded))


@pytest.mark.parametrize("layout", ["frame_major", "cascade_major"])
def test_derived_checksums_equal_the_fields_chain_bit_for_bit(layout):
    """On CPU tensors the wrapper runs the fields' chain: the same bits in
    either layout of the planes, on the state on which every cascade foams."""
    _, config, state = _setup(SEEDS[0], scale=SCALE)
    planes = _layouts(_planes(config, state, TS))[layout]
    got = derived.derived_checksums(planes, config, config.domains)
    assert got.shape == (len(TS),)
    assert torch.equal(got, _fields_chain(planes, config))
    one = planes[:, 0]                                   # (tb, 3, N, N): one state, its domain
    assert torch.equal(derived.derived_checksums(one, config), _fields_chain(one, config, False))


def test_derived_checksums_take_each_cascades_domain():
    """The foam at config.domain_size for every cascade moves the checksums
    of the state on which every cascade foams; the layouts agree."""
    _, config, state = _setup(SEEDS[0], scale=SCALE)
    layouts = _layouts(_planes(config, state, TS))
    right = {k: derived.derived_checksums(p, config, config.domains) for k, p in layouts.items()}
    wrong = derived.derived_checksums(layouts["frame_major"], config)
    assert torch.allclose(right["frame_major"], right["cascade_major"], rtol=1e-6, atol=0)
    assert not torch.allclose(wrong, right["frame_major"], rtol=0, atol=0.5)


def test_k10_launcher_takes_cuda_tensors_alone():
    _, config, state = _setup(SEEDS[0])
    with pytest.raises(ValueError, match="CUDA"):
        derived.launch_derived_partials(_planes(config, state, TS[:1]), config)


# On the card. Checksums, |K10 - plain| / sum of |summands|: the same terms
# summed in another order (a thread's 64 texels in turn, then trees; the
# eager chain's reductions), and a normal's three components summed before
# their one quotient by its length where the eager chain divides each:
# float32 sum order, as K1's checksum pass against its plain version
# (tests/test_torch_kernels.py TOL_CHECKSUM).
K10_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _on(state, device, cascades):
    return OceanState(state.h0[:cascades].to(device), state.omega[:cascades].to(device))


def _texels(planes, config, domains):
    """The plain version's foam texels of every (frame, cascade)."""
    return derived.foam_of(torch.movedim(planes, -3, -1), config, domains).sum(dim=(-2, -1))


def _summands(planes, config, texels):
    normals = finite_difference_normals_planes(planes[:, :, 1], config.normal_height_scale)
    return (planes.abs().sum(dim=(-4, -3, -2, -1)) + normals.abs().sum(dim=(-4, -3, -2, -1))
            + texels.sum(dim=-1)).double()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["cascade_major", "frame_major"])
@pytest.mark.parametrize("tb", [1, 20])
@pytest.mark.parametrize("cascades", [1, 3])
@pytest.mark.parametrize("n", [64, 512])
def test_k10_matches_its_plain_version(cuda, n, cascades, tb, layout):
    """K10 against the eager chain on the card, on K1t's planes of the state
    on which every cascade foams: foam texels of every (frame, cascade)
    bit-equal, checksums within K10_TOL of their summands."""
    _, config, state = _setup(SEEDS[0], scale=SCALE, resolution=n)
    state = _on(state, cuda, cascades)
    doms = config.domains[:cascades]
    ts = np.arange(tb, dtype=np.float32) * np.float32(0.37) + np.float32(2.0)
    planes = _layouts(_planes(config, state, ts))[layout]
    _, counts = derived.launch_derived_partials(planes, config, doms)
    got = derived.derived_checksums(planes, config, doms)
    want = derived.derived_checksums_reference(planes, config, doms)
    texels = _texels(planes, config, doms)
    assert counts.shape == (tb, cascades, derived.derived_tiles(n))
    assert torch.equal(counts.sum(dim=-1).double(), texels.double())
    assert float(texels.sum()) > 0
    rel = (got.double() - want.double()).abs() / _summands(planes, config, texels)
    assert float(rel.max()) < K10_TOL, float(rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("normals,foam", [(True, False), (False, True), (False, False)])
def test_k10_follows_the_configs_normals_and_foam(cuda, normals, foam):
    """Without the normals or the foam, K10 leaves their terms out as the
    plain version does."""
    _, config, state = _setup(SEEDS[0], scale=SCALE, compute_normals=normals,
                              compute_foam=foam)
    planes = _planes(config, _on(state, cuda, 3), TS)
    got = derived.derived_checksums(planes, config, config.domains)
    want = derived.derived_checksums_reference(planes, config, config.domains)
    summands = _summands(planes, config, _texels(planes, config, config.domains) * foam)
    assert float(((got.double() - want.double()).abs() / summands).max()) < K10_TOL


@pytest.mark.cuda
def test_k10_fed_the_wrong_domain_fails(cuda):
    """K10 with config.domain_size for every cascade counts other foam
    texels than the plain version at the cascades' own domains, on the
    state on which every cascade foams: cascades 1 and 2 differ, 0 not."""
    _, config, state = _setup(SEEDS[0], scale=SCALE)
    planes = _planes(config, _on(state, cuda, 3), TS)
    want = _texels(planes, config, config.domains)
    _, counts = derived.launch_derived_partials(planes, config)
    got = counts.sum(dim=-1).to(want.dtype)
    assert torch.equal(got[:, 0], want[:, 0])
    assert not torch.equal(got[:, 1], want[:, 1]) and not torch.equal(got[:, 2], want[:, 2])


@pytest.mark.cuda
def test_k10_launches_once_a_chunk_of_the_rollout(cuda):
    """The cell's call, 200 frames at time batch 20: 10 launches of K1 and
    of K10, and the checksums of the eager chain on the same planes."""
    _, config, state = _setup(SEEDS[0], resolution=512)
    state = _on(state, cuda, 3)
    ts = np.arange(200, dtype=np.float32) / np.float32(60.0)
    rollout = make_rollout(config, keep_fields=False, time_batch=20)
    before = profiling.tallies()
    got = rollout(state, ts)
    grown = profiling.grown(before)
    assert grown.get("launches.launch_derived_partials") == 10, grown
    assert grown.get("launches.launch_packed_step") == 10, grown
    plain = torch.cat([derived.derived_checksums_reference(
        _planes(config, state, ts[i:i + 20]), config, config.domains) for i in range(0, 200, 20)])
    assert torch.allclose(got, plain, rtol=K10_TOL, atol=0)


@pytest.mark.cuda
def test_k10_rejects_what_it_does_not_take(cuda):
    _, config, state = _setup(SEEDS[0])
    planes = _planes(config, _on(state, cuda, 3), TS)
    shifted = torch.empty(planes.numel() + 1, device=cuda)[1:].view(planes.shape)
    for bad in (planes.double(), torch.movedim(planes, -3, -1), planes[..., :48, :48],
                planes[:, :, :2], planes[None], shifted):
        with pytest.raises(ValueError):
            derived.launch_derived_partials(bad, config)
    with pytest.raises(ValueError, match="domains"):
        derived.launch_derived_partials(planes, config, config.domains[:2])
