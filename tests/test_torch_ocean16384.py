"""The offline 16384^2 grid as the benchmark's cell ``ocean16384.rollout``
runs it: its configuration, the banded float64 reference
(``portbench/reference/banded.py``) against ``golden.py``'s whole-grid
one, the four-step route through ``make_rollout`` against the banded
reference at 1024^2 on the CPU (K2 + K3's plain versions), the route's
spans and counter, the row half's count (``portbench/roofline_fourstep.py``)
and the new readers. The tests marked ``cuda`` run the cell's own sizes on
the card (a CUDA kernel has no CPU mode) and skip without one.

    python -m pytest tests/test_torch_ocean16384.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_ocean16384.py -q -s
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from gfx_ocean_tpu_torch.models.ocean import OceanState, make_rollout
from gfx_ocean_tpu_torch.ops import fourstep_step as fs
from gfx_ocean_tpu_torch.ops import fused_step
from gfx_ocean_tpu_torch.utils import profiling
from portbench import harness, inputs, program, roofline_fourstep
from portbench.reference import banded, golden

CELL = "ocean16384.rollout"
SEED = 2 ** 31 + 11
# Every sum of a banded frame is a float64 sum of the same terms as
# golden's in another order (measured up to 1.1e-14 of the value).
BANDED_REL = 1e-12
# At "highest" the FP32 FFT bodies' own error on the scale of the
# checksum's summands (measured 1.3e-6 to 3e-6 at 1024^2).
HIGHEST_GAP = 1e-5
NEW_METRICS = ("rows_ms.fourstep", "cols_ms.fourstep", "rows_roofline.fourstep")


def _cell(n=None, precision=None, seed=SEED, device="cpu"):
    ocean = {}
    if n is not None:
        ocean["resolution"] = n
    if precision is not None:
        ocean["matmul_precision"] = precision
    return harness.load_cell(CELL, seed, device, override={"config": {"ocean": ocean}})


def _recorded(work):
    """``work()`` inside ``recording()``: its result and the ``rollout``
    units it recorded."""
    with profiling.recording():
        out = work()
    return out, [u for u in profiling.windows()[-1].units if u.name == "rollout"]


# --------------------------------------------------------------------------
# On the CPU.
# --------------------------------------------------------------------------

def test_configuration_loads_as_stated():
    spec = harness.bench()
    (conf,) = [c for c in spec["configs"] if c["name"] == "ocean16384"]
    (work,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert conf["reduced"] == [] and (work["config"], work["traffic"], work["chips"]) == (
        "ocean16384", "banded_rollout", 1)
    cell = _cell()
    assert cell.config["reduced"] == []
    assert {"fft_impl", "matmul_precision", "rollout", "state", "deployment"} <= set(
        cell.config["assumed"])
    assert cell.config["rollout"] == {"time_batch": 1, "chunk_frames": 24}
    assert cell.config["control"] == {"ocean": {"matmul_precision": "default"}}
    config = program.ocean_config(cell)
    assert (config.resolution, config.domain_size, config.matmul_precision) == (
        16384, 4000.0, "bf16x3")
    assert config.compute_normals and not config.compute_foam and config.num_cascades == 1
    assert fused_step.check_supported(config, 16384) == "bf16x3"
    assert not fs.row_stage2_in_block(16384) and fs.row_stage2_in_block(4096)
    assert harness.drive(cell).__class__.__module__.endswith("banded_rollout")
    assert {m["name"] for m in harness.metrics_of(CELL, True)} >= set(NEW_METRICS)


@pytest.mark.parametrize("n,rows,cols", [
    (64, 1, 1), (64, 7, 3), (64, 64, 64), (256, 1, 256), (256, 48, 100), (256, None, None),
    (1024, 300, 1024), (1024, None, None)])
@pytest.mark.parametrize("compat", [{}, {"ref_sign": False, "conj_neg": True, "wrap_k": True}],
                         ids=["default", "flags"])
def test_banded_equals_golden(n, rows, cols, compat):
    """One-row, one-column, uneven and whole-grid bands (``None``: BAND,
    the whole grid at these N) give golden's checksum and scale."""
    cell = _cell(n)
    h0, omega = program.state(cell, SEED)
    ocean = dict(cell.config["ocean"], compat=compat)
    for t in (0.0, 0.7):
        want, want_scale = golden.checksum_terms(h0, omega, t, ocean)
        got, scale = banded.checksum_terms(h0, omega, t, ocean, rows, cols)
        assert got == pytest.approx(want, rel=BANDED_REL, abs=0)
        assert scale == pytest.approx(want_scale, rel=BANDED_REL, abs=0)


def test_banded_follows_the_normals_switch():
    cell = _cell(64)
    h0, omega = program.state(cell, SEED)
    ocean = dict(cell.config["ocean"], compute_normals=False)
    assert banded.checksum_terms(h0, omega, 0.3, ocean, 5, 9) == pytest.approx(
        golden.checksum_terms(h0, omega, 0.3, ocean), rel=BANDED_REL, abs=0)
    with pytest.raises(NotImplementedError):
        banded.checksum_terms(h0, omega, 0.3, dict(ocean, compute_foam=True))


@pytest.mark.parametrize("precision", ["bf16x3", "highest"])
def test_fourstep_rollout_matches_the_banded_reference(precision):
    """The cell's route (``make_rollout`` at time batch 1, K2 + K3's plain
    versions) at 1024^2 on a seeded Phillips state: every frame within the
    cell's limit of the banded reference, and within HIGHEST_GAP at
    "highest"; each frame one ``fourstep.rows`` and one ``fourstep.cols``
    span inside ``rollout.launches``, and no scratch launch on the CPU."""
    cell = _cell(1024, precision)
    h0, omega = program.state(cell, SEED)
    ts = inputs.frame_times(7, 3, cell.traffic["frame_rate_hz"])
    rollout = make_rollout(program.ocean_config(cell), keep_fields=False, time_batch=1)
    got, (unit,) = _recorded(lambda: rollout(OceanState(h0, omega), ts))
    limit = cell.limits["checksum_gap"]["limit"]
    for i, t in enumerate(ts.tolist()):
        want, scale = banded.checksum_terms(h0, omega, t, cell.config["ocean"])
        gap = abs(float(got[i]) - want) / scale
        assert gap <= (HIGHEST_GAP if precision == "highest" else limit), (i, gap)
    names = [s.name for s in unit.spans]
    assert names.count("fourstep.rows") == names.count("fourstep.cols") == len(ts)
    inside = unit.named("rollout.launches")[0]
    assert all(s.parent is inside for s in unit.named("fourstep.rows") + unit.named(
        "fourstep.cols"))
    assert "fourstep.row_scratch" not in unit.counters


def test_planes_record_the_same_spans():
    cell = _cell(1024)
    h0, omega = program.state(cell, SEED)
    config = program.ocean_config(cell)
    inputs_ = fused_step.hoist_packed(h0, omega, config)
    with profiling.recording():
        with profiling.span("unit") as top:
            planes = fs.fourstep_planes(inputs_, [0.5], config)
    assert torch.equal(planes, fs.fourstep_planes_reference(inputs_, [0.5], config))
    assert [s.name for s in top.unit.spans] == ["unit", "fourstep.rows", "fourstep.cols"]


def test_row_bound_by_hand():
    """12 N^2 bytes of state a frame at tb 1 over 3.35 TB/s bounds both
    grids: 0.9616 ms at 16384^2 (7.5 N^2 log2 N operations: 0.421 ms), 0.0601
    ms at 4096^2 (0.0225 ms)."""
    big = roofline_fourstep.rows_bound(_cell().config)
    assert big["by"] == "bytes" and big["bytes"] == 12 * 16384 ** 2
    assert big["seconds"] == pytest.approx(12 * 16384 ** 2 / 3.35e12)
    assert big["seconds"] * 1e3 == pytest.approx(0.9616, abs=1e-4)
    assert big["flops"] == 7.5 * 16384 ** 2 * 14
    small = roofline_fourstep.rows_bound(
        harness.load_cell("ocean4096.rollout", 1, "cpu").config)
    assert small["by"] == "bytes" and small["seconds"] * 1e3 == pytest.approx(0.0601, abs=5e-5)
    assert small["flops"] / 67e12 * 1e3 == pytest.approx(0.0225, abs=5e-5)
    # the same work whatever the tier or body
    for tier in ("default", "highest", "high"):
        c = harness.merge(_cell().config, {"ocean": {"matmul_precision": tier}})
        assert roofline_fourstep.rows_bound(c) == big


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_new_readers_read_nothing_without_a_trace(metric):
    read = harness.reader(metric)
    config = _cell().config
    assert read({"config": config, "setup_s": 1.0, "frames": 24, "window_s": 0.6}) is None
    assert read({"config": config, "setup_s": 1.0, "trace": None}) is None


def test_cell_runs_small_and_correct():
    """The cell through the harness at 1024^2 on the CPU: the banded drive's
    window and check."""
    line = harness.run(CELL, SEED, 0.2, False, device="cpu", override={
        "config": {"ocean": {"resolution": 1024}, "rollout": {"chunk_frames": 2}},
        "traffic": {"check_frames": 1, "warmup_calls": 1}})
    assert line["correct"] and line["attempted"] >= 2, line
    assert set(line["metrics"]) == {"steps_per_s", "setup_s"}


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2t and K3t have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_16384_rollout_equals_per_frame_checksums(cuda):
    """One 24-frame ``make_rollout`` call of the cell equals the per-frame
    ``fourstep_checksums`` bit for bit."""
    cell = _cell(device=cuda)
    config = program.ocean_config(cell)
    h0, omega = program.state(cell, SEED)
    ts = inputs.frame_times(240, 24, cell.traffic["frame_rate_hz"])
    got = make_rollout(config, keep_fields=False, time_batch=1)(OceanState(h0, omega), ts)
    pre = fused_step.hoist_packed(h0, omega, config)
    want = torch.cat([fs.fourstep_checksums(pre, ts[i:i + 1], config) for i in range(24)])
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,scratch", [(16384, 1), (4096, 0)])
def test_spans_and_scratch_count_on_the_card(cuda, n, scratch):
    """A recorded call: one ``fourstep.rows`` and one ``fourstep.cols`` a
    frame, each with device time, and ``fourstep.row_scratch`` one a frame
    at 16384^2 (K2t's stage 2 from the scratch), none at 4096^2."""
    cell = _cell(n, device=cuda)
    config = program.ocean_config(cell)
    state = OceanState(*program.state(cell, SEED))
    rollout = make_rollout(config, keep_fields=False, time_batch=1)
    ts = inputs.frame_times(0, 6, 60.0)
    rollout(state, ts)
    _, (unit,) = _recorded(lambda: rollout(state, ts).cpu())
    for name in ("fourstep.rows", "fourstep.cols"):
        assert len(unit.named(name)) == len(ts) and unit.device_ms(name) > 0
    assert unit.counters.get("fourstep.row_scratch", 0) == scratch * len(ts)
    rows, cols = unit.device_ms("fourstep.rows"), unit.device_ms("fourstep.cols")
    print(f"{n}^2: fourstep.rows {rows / len(ts):.4f} ms, fourstep.cols "
          f"{cols / len(ts):.4f} ms a frame, {torch.cuda.get_device_name(cuda)}")


@pytest.mark.cuda
def test_banded_reference_peak_at_16384(cuda):
    """The reference's device memory at the cell's size with no program
    alive: the state and one frame's banded checksum under 25 GB."""
    torch.cuda.empty_cache()
    cell = _cell(device=cuda)
    h0, omega = program.state(cell, SEED)
    torch.cuda.synchronize(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    t0 = time.perf_counter()
    want, scale = banded.checksum_terms(h0, omega, 1.5, cell.config["ocean"])
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(cuda)
    print(f"banded reference at 16384^2: peak {peak} B, {seconds:.3f} s a frame, "
          f"checksum {want!r}, scale {scale!r}")
    assert np.isfinite([want, scale]).all() and peak < 25e9


@pytest.mark.cuda
def test_drive_check_passes_on_the_card(cuda):
    line = harness.run(CELL, SEED + 1, 2.0, False, device=cuda)
    print(f"{CELL}: {line}")
    assert line["correct"], line
