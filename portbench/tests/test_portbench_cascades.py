"""The cell ``ocean512_cascades.rollout`` on the CPU: BASELINE config 4's
three cascades with normals and the Jacobian foam through K1t's plain
version, at small sizes, correct on two seeds, failed by its control and
by each fault the cascades' rollout can have; its configuration against
``ocean512``'s; the readers of its derived route's spans; and on the card,
that its traced window runs K1t once a chunk over every cascade and
records the derived route.

    python -m pytest portbench/tests/test_portbench_cascades.py -q
    python -m pytest portbench/tests/test_portbench_cascades.py -q -m cuda
"""

from __future__ import annotations

import collections
import json
from pathlib import Path

import pytest
import torch

from gfx_ocean_tpu_torch.utils import profiling
from portbench import harness, readings, roofline_derived

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ROOT / "portbench" / "configs"
CELL = "ocean512_cascades.rollout"
SEEDS = (2 ** 31 + 11, 5)
SPANS = ("step_ms.cascades", "derived_ms.cascades", "derived_roofline.cascades")


def _small(n):
    """The cell at N^2 with calls of two 20-frame chunks."""
    return {"config": {"ocean": {"resolution": n}, "rollout": {"chunk_frames": 40}},
            "traffic": {"check_frames": 4, "warmup_calls": 1}}


def _run(n=64, seed=SEEDS[0], traced=False):
    return harness.run(CELL, seed, 0.2, traced, device="cpu", override=_small(n))


def _fails(line):
    return not line["correct"] and any(c["value"] > c["limit"] for c in line["check"].values())


@pytest.mark.parametrize("seed", SEEDS)
def test_cell_runs_small_and_correct(seed):
    line = _run(seed=seed)
    assert line["correct"] and line["attempted"] >= 2, line
    assert set(line["metrics"]) == {"steps_per_s", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in line["check"].values())


def test_control_fails_the_comparison():
    """The control (one bf16 pass) fails the check; the program as
    configured passes, on the same seed."""
    limit = json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json").read_text())
    limit = limit["checksum_gap"]["limit"]
    for control in (False, True):
        (out,) = readings.readings(CELL, [SEEDS[0]], 160, control, device="cpu",
                                   override=_small(256))
        assert (out["numbers"]["checksum_gap"] > limit) == control and out["compared"], out


def _fault(monkeypatch, fault):
    """Break the cascades' rollout where ``models/ocean.py`` forms the
    fields and their checksums."""
    from gfx_ocean_tpu_torch.models import ocean

    real_fields, real_sums, real_disp = ocean._fields, ocean._checksums, ocean._displacement
    if fault == "foam_left_out":
        monkeypatch.setattr(ocean, "_fields", lambda *a, **k: real_fields(*a, **k)._replace(
            foam=None))
    elif fault == "cascade_dropped":            # the last cascade left out of the sum
        monkeypatch.setattr(ocean, "_checksums", lambda f, **k: real_sums(ocean.OceanFields(
            f.displacement[:, :-1], f.normals[:, :-1], f.foam[:, :-1]), **k))
    elif fault == "foam_at_finest_spacing":     # every cascade's foam at 62.5 m
        monkeypatch.setattr(ocean, "_fields", lambda disp, config, cascaded, halo=None,
                            domains=None: real_fields(disp, config, cascaded, halo,
                                                      domains=(62.5,) * config.num_cascades))
    else:                                       # every frame of a call at its first time
        monkeypatch.setattr(ocean, "_displacement", lambda state, ts, *a, **k: real_disp(
            state, ts[:1].expand(ts.shape[0]).contiguous(), *a, **k))


@pytest.mark.parametrize("fault", ["foam_left_out", "cascade_dropped",
                                   "foam_at_finest_spacing", "state_unchanged"])
def test_cascade_faults_come_out_not_correct(monkeypatch, fault):
    _fault(monkeypatch, fault)
    assert _fails(_run())


def test_config_differs_from_ocean512_in_its_cascades_foam_and_calls():
    """The cascades, their domains and the foam, the calls' time batch and
    length, the frame group no cell of it reads, and the source and
    assumptions that say so; nothing cut from the source."""
    one = json.loads((CONFIGS / "ocean512.json").read_text())
    three = json.loads((CONFIGS / "ocean512_cascades.json").read_text())
    assert three["ocean"]["num_cascades"] == 3 and three["ocean"]["compute_foam"] is True
    assert three["ocean"]["cascade_domains"] == [1000.0, 250.0, 62.5]
    assert three["rollout"] == {"time_batch": 20, "chunk_frames": 200}
    assert "frame" not in three and three["reduced"] == []
    for conf in (one, three):
        for key in ("num_cascades", "cascade_domains", "compute_foam"):
            del conf["ocean"][key]
        for key in ("source", "assumed", "rollout"):
            del conf[key]
    del one["frame"]
    assert one == three
    entry = next(c for c in harness.bench()["configs"] if c["name"] == "ocean512_cascades")
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/ocean512_cascades.json"


def test_cell_reads_the_rollout_and_derived_metrics():
    names = {m["name"] for m in harness.metrics_of(CELL, True)}
    assert names == {"step_roofline", "idle_share.rollout", "dispatch_us.rollout", *SPANS}
    assert {m["name"] for m in harness.metrics_of(CELL, False)} == {"steps_per_s", "setup_s"}


# --------------------------------------------------------------------------
# The readers of the derived route's spans.
# --------------------------------------------------------------------------

TRACED = {"trace": {"frames": 1}}


@pytest.fixture
def kept(monkeypatch):
    """The recorder's windows, empty for the test."""
    windows = collections.deque()
    monkeypatch.setattr(profiling, "_windows", windows)
    monkeypatch.setattr(profiling, "_kept", 0)
    return windows


def _call(frames, step_ms, derived_ms):
    """A rollout call made by hand with one chunk's spans."""
    unit = profiling.Unit("rollout", {"frames": frames}, False)
    for name, device_ms in (("rollout", None), ("rollout.step", step_ms),
                            ("rollout.derived", derived_ms)):
        span = profiling.Span(name, None, {}, unit.spans[0] if unit.spans else None)
        span.unit, span.start_ns, span.end_ns, span._device_ms = unit, 0, 1000, device_ms
        unit.spans.append(span)
    return unit


def _read(name, record=TRACED):
    return harness.reader(name)(record)


def test_span_readers_by_hand(kept):
    config = harness.load_cell(CELL, 1, "cpu").config
    window = profiling.Window()
    window.units.extend([_call(200, 2.0, 6.0), _call(200, 4.0, 10.0)])
    kept.append(window)
    record = {**TRACED, "config": config}
    assert _read("step_ms.cascades", record) == pytest.approx(6.0 / 400)
    assert _read("derived_ms.cascades", record) == pytest.approx(16.0 / 400)
    bound = roofline_derived.derived_bound(config)["seconds"]
    assert _read("derived_roofline.cascades", record) == pytest.approx(
        100 * bound / (16.0 / 400 * 1e-3))
    kept[0].units.append(_call(200, None, 1.0))    # a span without device time
    assert _read("step_ms.cascades", record) is None


def test_span_readers_read_nothing_without_the_spans(kept, monkeypatch):
    """No trace, no recorded call, or calls without the derived route's
    spans (the fused route, or a program before them): nothing to read."""
    for name in SPANS:
        assert _read(name, {"config": {}}) is None and _read(name) is None
    unit = profiling.Unit("rollout", {"frames": 200}, False)
    unit.spans.append(profiling.Span("rollout", None, {}, None))
    window = profiling.Window()
    window.units.append(unit)
    kept.append(window)
    for name in SPANS:
        assert _read(name) is None
    monkeypatch.delattr(profiling, "largest_window")
    for name in SPANS:
        assert _read(name) is None


def test_recorded_calls_carry_the_spans_and_count(kept):
    """Calls recorded on the CPU through the cell's drive: the derived
    route's spans once a chunk, the foam count; no device clock here."""
    loop = harness.drive(harness.load_cell(CELL, SEEDS[0], "cpu", override=_small(64)))
    loop.setup()
    with profiling.recording():
        out = loop.window(0.2)
    loop.release()
    units = list(profiling.windows()[-1].units)
    assert out["frames"] == 40 * len(units)
    for u in units:
        assert u.counters["rollout.chunks"] == 2 and u.counters["foam.texels"] > 0
        assert len(u.named("rollout.step")) == len(u.named("rollout.derived")) == 2
    for name in SPANS:
        assert _read(name) is None


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_traced_window_runs_k1t_over_the_cascades():
    """The traced run is correct and reports every per-layer metric; every
    rollout call of its window launched K1t's tiered body once a chunk over
    3 cascades x 20 frames, and recorded the derived route's spans with
    device times and a foam count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the port's CUDA kernels")
    from gfx_ocean_tpu_torch.ops import fused_step

    line = harness.run(CELL, SEEDS[0], 2.0, True, device="cuda")
    assert line["correct"], line
    assert set(line["metrics"]) == {m["name"] for m in harness.metrics_of(CELL, True)}
    assert 0 < line["metrics"]["derived_roofline.cascades"]["value"] <= 100
    units = profiling.largest_window("rollout")
    assert units
    for u in units:
        chunks = u.counters.get("rollout.chunks", 0)
        assert chunks == 10, u.counters                        # 200 frames at time batch 20
        assert u.counters.get("tiered_launches.launch_packed_step") == chunks, u.counters
        assert u.counters.get("launches.launch_packed_step") == chunks, u.counters
        assert (u.counters.get("tiered_items.launch_packed_step")
                == chunks * fused_step.tier_items(512, 3 * 20)), u.counters
        assert u.counters.get("foam.texels", 0) > 0, u.counters
        assert len(u.named("rollout.step")) == len(u.named("rollout.derived")) == chunks
        assert u.device_ms("rollout.step") > 0 and u.device_ms("rollout.derived") > 0
