"""The benchmark's own tests on the CPU: every cell end to end at a small
size through the program's plain versions, the harness finding a new
configuration, traffic mix, metric and drive by name, the result line, the
imports, the roofline's count, the trace's reduction, and the comparison
failing the control and each fault a cell can have.

    python -m pytest portbench/tests -q

The ``cuda`` tests run each cell on the card (skipped without one):

    python -m pytest portbench/tests -q -m cuda
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, readings, roofline, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
CELLS = ("ocean512.rollout", "ocean4096.rollout", "ocean512.frame")
SEED = 2 ** 31 + 11

# Small sizes for the CPU: the packed route at 256^2, the four-step route at
# its smallest grid, 1024^2, and a 120 x 70 frame of the 128 x 4 mesh.
SMALL = {
    "ocean512.rollout": {"config": {"ocean": {"resolution": 256},
                                    "rollout": {"chunk_frames": 12}},
                         "traffic": {"check_frames": 4, "warmup_calls": 1}},
    "ocean4096.rollout": {"config": {"ocean": {"resolution": 1024},
                                     "rollout": {"chunk_frames": 2}},
                          "traffic": {"check_frames": 1, "warmup_calls": 1}},
    "ocean512.frame": {"config": {"ocean": {"resolution": 64},
                                  "frame": {"width": 120, "height": 70, "reference_samples": 4}},
                       "traffic": {"check_every": 1, "warmup_calls": 1, "cycle_frames": 3,
                                   "frame_rate_hz": 0.5}},
}


def _run(cell, traced=False, root=ROOT, override=None):
    seconds = 1.0 if cell.endswith(".frame") else 0.2     # a few frames, a rollout call
    return harness.run(cell, SEED, seconds, traced, device="cpu", root=root,
                       override=override or SMALL[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_small_and_correct(cell):
    line = _run(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert line["correct"], line
    names = {m["name"] for m in harness.metrics_of(cell, False)}
    assert set(line["metrics"]) == names and "setup_s" in names
    assert all(c["value"] <= c["limit"] for c in line["check"].values())


def test_traced_run_keeps_the_line_shape():
    line = _run("ocean512.rollout", traced=True)
    assert line["correct"] and list(line)[-1] == "check"
    assert line["metrics"] == {}          # no device trace on the CPU: nothing to read


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A configuration, traffic mix, cell and metric added as files and
    entries in a copy of the benchmark, with no file of it edited."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    conf = json.loads((BENCH / "configs" / "ocean512.json").read_text())
    conf["ocean"]["resolution"] = 32
    (tmp_path / "portbench/configs/ocean32.json").write_text(json.dumps(conf))
    (tmp_path / "portbench/traffic/rollout_short.json").write_text(json.dumps(
        {"drive": "rollout", "frame_rate_hz": 30.0, "warmup_calls": 1, "check_frames": 2,
         "trace_seconds": 0.1, "gap_seconds": 0.1}))
    (tmp_path / "portbench/limits/ocean32.rollout_short.json").write_text(json.dumps(
        {"checksum_gap": {"limit": 1e-3}}))
    (tmp_path / "portbench/metrics/frames_done.py").write_text(
        "def read(record):\n    return record.get('frames')\n")
    spec["configs"].append({"name": "ocean32", "source": "https://example.org",
                            "file": "portbench/configs/ocean32.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "ocean32.rollout_short", "config": "ocean32",
                              "traffic": "rollout_short", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["ocean32.rollout_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    line = harness.run("ocean32.rollout_short", 3, 0.1, False, device="cpu", root=tmp_path,
                       override={"config": {"rollout": {"chunk_frames": 6}}})
    assert line["correct"], line
    assert line["metrics"]["frames_done"]["value"] >= 6
    assert set(line["metrics"]) == {"frames_done", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())


# A drive that is not in the benchmark: single ``make_step`` frames, each
# height field compared with the reference's by its relative L-inf gap.
HEIGHTS_DRIVE = '''
import torch

from portbench import inputs, program, trace
from portbench.reference import golden


class Drive:
    def __init__(self, cell):
        self.cell, self.heights, self.frames = cell, {}, 0

    def setup(self):
        from gfx_ocean_tpu_torch.models.ocean import OceanState, make_step

        self.state = OceanState(*program.state(self.cell, self.cell.seed))
        self.fn = make_step(program.ocean_config(self.cell))

    def _t(self, f):
        return float(inputs.frame_times(f, 1, self.cell.traffic["frame_rate_hz"])[0])

    def _next(self):
        self.heights[self.frames] = self.fn(self.state, self._t(self.frames)).height.cpu()
        self.frames += 1
        return 1

    def window(self, seconds):
        return trace.run_for(self._next, seconds)

    def traced(self, seconds):
        return {"trace": trace.traced(self._next, seconds, 1, seconds)}

    def release(self):
        del self.fn, self.state

    def check(self):
        h0, omega = program.state(self.cell, self.cell.seed)
        ocean = self.cell.config["ocean"]
        worst = 0.0
        for f, got in self.heights.items():
            want = golden.fields(h0, omega, self._t(f), ocean["domain_size"], {})[..., 1]
            worst = max(worst, float((got.double() - want).abs().max() / want.abs().max()))
        failed = not worst <= self.cell.limits["height_gap"]["limit"]
        return {"numbers": {"height_gap": worst}, "compared": len(self.heights),
                "failed": int(failed)}
'''


def test_new_drive_is_found_by_name(tmp_path):
    """A drive that brings its own loop and reference comparison, added as a
    file with a traffic mix, limits and a cell, with no file edited."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    (tmp_path / "portbench/drives/heights.py").write_text(HEIGHTS_DRIVE)
    (tmp_path / "portbench/traffic/heights.json").write_text(json.dumps(
        {"drive": "heights", "frame_rate_hz": 60.0}))
    (tmp_path / "portbench/limits/ocean512.heights.json").write_text(json.dumps(
        {"height_gap": {"limit": 1e-4}}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "ocean512.heights", "config": "ocean512",
                              "traffic": "heights", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    line = harness.run("ocean512.heights", 5, 0.1, False, device="cpu", root=tmp_path,
                       override={"config": {"ocean": {"resolution": 64,
                                                      "matmul_precision": "highest"}}})
    assert line["correct"] and line["attempted"] >= 1, line
    assert line["check"]["height_gap"]["value"] < 1e-4
    assert set(line["metrics"]) == {"setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_frame_window_runs_whole_cycles_in_order():
    """Every run renders the same frames: whole cycles of the animation,
    in order from a start drawn from the seed."""
    cell = harness.load_cell("ocean512.frame", SEED, "cpu", override=SMALL["ocean512.frame"])
    loop = harness.drive(cell)
    loop.setup()
    out = loop.window(0.0)
    cycle = cell.traffic["cycle_frames"]
    assert out["frames"] == cycle and len(out["latencies_s"]) == cycle
    poses = [round(loop._time(f) * cell.traffic["frame_rate_hz"]) for f in range(2 * cycle)]
    assert poses[:cycle] == poses[cycle:] and sorted(poses[:cycle]) == list(range(cycle))
    assert all((b - a) % cycle == 1 for a, b in zip(poses, poses[1:]))


def test_trace_summary_by_hand():
    """Busy time is the union of device intervals inside the profiler's
    step; each idle gap goes to the innermost host op around its middle."""
    events = [
        {"ph": "X", "name": "ProfilerStep#1", "cat": "cpu_op", "ts": 0, "dur": 100},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 10, "dur": 20},
        {"ph": "X", "name": "k2", "cat": "kernel", "ts": 25, "dur": 15},   # overlaps k1
        {"ph": "X", "name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 60, "dur": 10},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 95, "dur": 10},   # cut at 100
        {"ph": "X", "name": "aten::add", "cat": "cpu_op", "ts": 40, "dur": 20},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 45, "dur": 10},
    ]
    s = trace.summarize(events, 1.0)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert s["kernel_s"] == pytest.approx((20 + 15 + 5) * 1e-6)
    assert dict(s["device_ops"])["k1"] == pytest.approx(25e-6)
    gaps = dict(s["idle_gaps"])       # [0,10] [40,60] [70,95]: python, the launch, python
    assert gaps["cudaLaunchKernel"] == pytest.approx(20e-6)
    assert gaps["python"] == pytest.approx(35e-6)
    # A session that records the device alone has no step: the host's window.
    s = trace.summarize([e for e in events if e["cat"] in ("kernel", "gpu_memcpy")], 2e-4)
    assert s["window_s"] == 2e-4 and s["busy_s"] == pytest.approx(50e-6)


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""


def test_run_in_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_jax_in_a_run_and_no_program_in_the_reference():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run as r\n"
            "from portbench import harness, readings\n"
            "harness.run('ocean512.rollout', 1, 0.1, False, device='cpu', override=%r)\n"
            "print(r.forbidden(sys.modules))\n" % (str(ROOT), SMALL["ocean512.rollout"]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.golden, portbench.reference.render, "
            "portbench.reference.camera\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gfx_ocean_tpu_torch', 'gfx_ocean_tpu', 'jax'}))\n" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.stdout.strip() == "[]", proc.stderr
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("gfx_ocean_tpu_torch", "gfx_ocean_tpu", "jax")
                           for n in names), path


def test_forbidden_compares_whole_top_level_names():
    from portbench import run

    assert run.forbidden(["gfx_ocean_tpu_torch", "gfx_ocean_tpu_torch.ops", "jaxtyping",
                          "flaxen.x", "torch"]) == []
    assert run.forbidden(["jaxlib.xla", "gfx_ocean_tpu.ops", "flax", "jax"]) == [
        "flax", "gfx_ocean_tpu", "jax", "jaxlib"]


@pytest.mark.parametrize("n", [512, 4096])
def test_step_bound_is_the_same_for_every_tier_and_route(n):
    conf = json.loads((BENCH / "configs" / "ocean512.json").read_text())
    conf["ocean"]["resolution"] = n
    bounds = set()
    for tier in ("bf16x3", "high", "highest", "default"):
        for impl, pack in (("pallas", True), ("pallas", False), ("matmul", True)):
            c = harness.merge(conf, {"ocean": {"matmul_precision": tier, "fft_impl": impl,
                                               "hermitian_pack": pack}})
            bounds.add(roofline.step_bound(c)["seconds"])
    assert len(bounds) == 1


def test_step_bound_by_hand():
    c512 = json.loads((BENCH / "configs" / "ocean512.json").read_text())
    c4096 = json.loads((BENCH / "configs" / "ocean4096.json").read_text())
    b = roofline.step_bound(c512)           # 15 * 512^2 * 9 operations a frame
    assert b["by"] == "operations" and b["seconds"] == pytest.approx(
        15 * 512 ** 2 * 9 / 67e12)
    b = roofline.step_bound(c4096)          # the 201 MB state a frame, tb 1
    assert b["by"] == "bytes" and b["seconds"] == pytest.approx(
        (12 * 4096 ** 2 + 4) / 3.35e12)


# --------------------------------------------------------------------------
# The comparison against the control and the faults.
# --------------------------------------------------------------------------

def _fails(line):
    return not line["correct"] and any(c["value"] > c["limit"] for c in line["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(cell):
    """The configuration's control (one bf16 pass) fails a number of the
    cell's check; the program as configured passes, on the same seed."""
    frames = 4 * SMALL[cell]["config"].get("rollout", {}).get("chunk_frames", 1)
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    for control in (False, True):
        (out,) = readings.readings(cell, [SEED], frames, control, device="cpu",
                                   override=SMALL[cell])
        over = [k for k, v in limits.items() if out["numbers"][k] > v["limit"]]
        assert bool(over) == control and out["compared"], out


def _rollout_fault(monkeypatch, fault):
    from gfx_ocean_tpu_torch.ops import fused_step

    real = fused_step.packed_checksums

    def broken(inputs, ts, config):
        if fault == "state_unchanged":          # every frame of the call at its first time
            return real(inputs, ts[:1].expand(ts.shape[0]).contiguous(), config)
        if fault == "half_the_batch":           # half the frames, the mean for the rest
            half = real(inputs, ts[: ts.shape[0] // 2], config)
            return torch.cat([half, half.mean().expand(ts.shape[0] - half.shape[0])])
        return real(inputs, ts, config).flip(0)  # answers altered: frames out of order

    monkeypatch.setattr(fused_step, "packed_checksums", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_rollout_faults_come_out_not_correct(monkeypatch, fault):
    _rollout_fault(monkeypatch, fault)
    assert _fails(_run("ocean512.rollout"))


def _frame_fault(monkeypatch, fault):
    from gfx_ocean_tpu_torch.models import ocean
    from gfx_ocean_tpu_torch.render import raster

    if fault == "state_unchanged":              # the surface never leaves its first frame
        real_step = ocean.step
        monkeypatch.setattr(ocean, "step", lambda state, t, config, *a, **k:
                            real_step(state, 0.0, config, *a, **k))
    else:                                       # answer altered: the last rows of the image
        real_srgb = raster.srgb8

        def broken(img):
            out = real_srgb(img).clone()
            out[-8:] = 0
            return out

        monkeypatch.setattr(raster, "srgb8", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_frame_faults_come_out_not_correct(monkeypatch, fault):
    _frame_fault(monkeypatch, fault)
    assert _fails(_run("ocean512.frame"))


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_on_the_card(cell, traced):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the port's CUDA kernels")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                           str(SEED), "--seconds", "2", "--trace", str(traced)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    kind = "per_layer" if traced else "end_to_end"
    assert set(line["metrics"]) == {m["name"] for m in harness.metrics_of(cell, bool(traced))}, kind
    assert np.isfinite([m["value"] for m in line["metrics"].values()]).all()
