"""BASELINE config 4 as the benchmark's cell ``ocean512_cascades.rollout``
runs it, on the CPU at 64^2: three cascades over 1000 / 250 / 62.5 m with
normals and the Jacobian foam, through ``make_rollout`` on "pallas" (K1t's
plain version, the cascade axis in one call) against the float64
reference of ``portbench/reference/cascades.py``; the foam's per-cascade
domain on a state on which every cascade foams; the rollout's derived
route's spans and counter; and the derived stage's count
(``portbench/roofline_derived.py``).

    python -m pytest tests/test_torch_cascade_foam.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gfx_ocean_tpu_torch.models import ocean
from gfx_ocean_tpu_torch.models.ocean import OceanState, make_rollout
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
