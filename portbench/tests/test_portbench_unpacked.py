"""The cell ``ocean512_unpacked.rollout`` on the CPU: the reference's own
three-spectrum layout (``hermitian_pack`` false) through the unpacked
step's plain version, at small sizes, correct on two seeds, failed by its
control and by each fault a rollout can have; its configuration against
``ocean512``'s; and on the card, that its traced window runs K4t alone.

    python -m pytest portbench/tests/test_portbench_unpacked.py -q
    python -m pytest portbench/tests/test_portbench_unpacked.py -q -m cuda
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import harness, readings, roofline

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ROOT / "portbench" / "configs"
CELL = "ocean512_unpacked.rollout"
SEEDS = (2 ** 31 + 11, 5)


def _small(n):
    """The cell at N^2 with two calls' worth of 6-frame chunks."""
    return {"config": {"ocean": {"resolution": n}, "rollout": {"chunk_frames": 12}},
            "traffic": {"check_frames": 4, "warmup_calls": 1}}


def _run(n=256, seed=SEEDS[0]):
    return harness.run(CELL, seed, 0.2, False, device="cpu", override=_small(n))


def _fails(line):
    return not line["correct"] and any(c["value"] > c["limit"] for c in line["check"].values())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [64, 256])
def test_cell_runs_small_and_correct(n, seed):
    line = _run(n, seed)
    assert line["correct"] and line["attempted"] >= 2, line
    assert set(line["metrics"]) == {"steps_per_s", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in line["check"].values())


def test_the_cell_takes_the_unpacked_route():
    """The configuration as the program reads it: unpacked, K4t's tier."""
    from gfx_ocean_tpu_torch.ops import fused_step, unpacked_step
    from portbench import program

    cell = harness.load_cell(CELL, 1, "cpu")
    config = program.ocean_config(cell)
    assert config.hermitian_pack is False and config.matmul_precision == "bf16x3"
    n = config.resolution
    assert unpacked_step.unpacked_route(config, n) == "single"
    h0, omega = torch.zeros(2, n, n), torch.ones(n, n)
    assert isinstance(fused_step.hoist_packed(h0, omega, config), fused_step.UnpackedInputs)


def test_control_fails_the_comparison():
    """The control (one bf16 pass) fails the check; the program as
    configured passes, on the same seed."""
    limit = json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json").read_text())
    limit = limit["checksum_gap"]["limit"]
    for control in (False, True):
        (out,) = readings.readings(CELL, [SEEDS[0]], 48, control, device="cpu",
                                   override=_small(256))
        assert (out["numbers"]["checksum_gap"] > limit) == control and out["compared"], out


def _rollout_fault(monkeypatch, fault):
    """Break the unpacked step where ``fused_step.packed_checksums`` calls
    it for ``UnpackedInputs``."""
    from gfx_ocean_tpu_torch.ops import unpacked_step

    real = unpacked_step.unpacked_checksums

    def broken(inputs, ts, config):
        if fault == "state_unchanged":          # every frame of the call at its first time
            return real(inputs, ts[:1].expand(ts.shape[0]).contiguous(), config)
        if fault == "half_the_batch":           # half the frames, the mean for the rest
            half = real(inputs, ts[: ts.shape[0] // 2], config)
            return torch.cat([half, half.mean().expand(ts.shape[0] - half.shape[0])])
        return real(inputs, ts, config).flip(0)  # answers altered: frames out of order

    monkeypatch.setattr(unpacked_step, "unpacked_checksums", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_rollout_faults_come_out_not_correct(monkeypatch, fault):
    _rollout_fault(monkeypatch, fault)
    assert _fails(_run())


def test_config_differs_from_ocean512_only_in_its_layout():
    """``hermitian_pack``, the frame group no cell of it reads, and the
    source and assumptions that say so."""
    packed = json.loads((CONFIGS / "ocean512.json").read_text())
    unpacked = json.loads((CONFIGS / "ocean512_unpacked.json").read_text())
    assert packed["ocean"]["hermitian_pack"] is True
    assert unpacked["ocean"]["hermitian_pack"] is False
    assert "frame" not in unpacked and unpacked["reduced"] == []
    for conf in (packed, unpacked):
        del conf["ocean"]["hermitian_pack"], conf["source"], conf["assumed"]
    del packed["frame"]
    assert packed == unpacked
    spec = harness.bench()
    entry = next(c for c in spec["configs"] if c["name"] == "ocean512_unpacked")
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/ocean512_unpacked.json"


def test_step_bound_is_the_packed_cells():
    """The same fields' transforms whatever the layout, so the cell's
    ``step_roofline`` reads against ``ocean512.rollout``'s bound."""
    packed = json.loads((CONFIGS / "ocean512.json").read_text())
    unpacked = json.loads((CONFIGS / "ocean512_unpacked.json").read_text())
    assert roofline.step_bound(unpacked) == roofline.step_bound(packed)


def test_cell_reads_the_rollout_metrics():
    names = {m["name"] for m in harness.metrics_of(CELL, True)}
    assert names == {"step_roofline", "idle_share.rollout", "dispatch_us.rollout"}
    assert {m["name"] for m in harness.metrics_of(CELL, False)} == {"steps_per_s", "setup_s"}


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_traced_window_runs_k4t_alone():
    """The traced run is correct, and every rollout call it recorded
    launched K4t once a chunk and K1 never."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the port's CUDA kernels")
    from gfx_ocean_tpu_torch.utils import profiling

    line = harness.run(CELL, SEEDS[0], 2.0, True, device="cuda")
    assert line["correct"], line
    assert set(line["metrics"]) == {m["name"] for m in harness.metrics_of(CELL, True)}
    units = [u for w in profiling.windows() for u in w.units if u.name == "rollout"]
    assert units
    for u in units:
        chunks = u.counters.get("rollout.chunks", 0)
        assert chunks == 100, u.counters                       # 600 frames at time batch 6
        assert u.counters.get("tiered_launches.launch_unpacked_step") == chunks, u.counters
        assert u.counters.get("launches.launch_unpacked_step") == chunks, u.counters
        assert not u.counters.get("launches.launch_packed_step"), u.counters
        assert not u.counters.get("tiered_launches.launch_packed_step"), u.counters
