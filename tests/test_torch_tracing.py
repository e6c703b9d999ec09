"""The port's recorder (``gfx_ocean_tpu_torch/utils/profiling.py``): spans
and counters inside the frame renderer and the rollout, on the CPU at small
sizes (a 96 x 64 frame of a 64^2 state on a 32 x 4 mesh, rollouts of six
frames).

Off, nothing is recorded and ``span`` hands out one shared object; inside
``recording()`` a frame equals the frame rendered with recording off, bit
for bit, and every stage span appears once under its frame; under a
``torch.profiler`` session the warm-up step records nothing and each span's
``record_function`` range lands in the session's trace.

The ``cuda`` tests check on the card that K7, K8 and K9, replayed from the
stages' CUDA graphs, are launched inside the spans of their stages, and
that the stage spans carry device times; that the device timeline of two
frames agrees with ``torch.profiler``'s trace of them; and that
``profile_kernels`` returns kernels alone:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

from __future__ import annotations

import functools
import json
import sys
import threading

import numpy as np
import pytest
import torch

import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu_torch.models.ocean import state_from_numpy
from gfx_ocean_tpu_torch.render import camera as tcam
from gfx_ocean_tpu_torch.render import raster as tr
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum
from gfx_ocean_tpu_torch.utils import profiling

POOL = 32_768            # a pool the 96 x 64 frame fits (tests/test_torch_render.py)
STAGES = ("frame.step", "frame.slot_tables", "frame.slots", "frame.resolve",
          "frame.giant_pass", "frame.shade", "frame.srgb")
# A frame's spans inside its own, in order: its leaves.
FRAME_SPANS = ("frame.step", "frame.inputs") + STAGES[1:] + ("frame.output",)
W, H = 96, 64


def _state(device="cpu"):
    n = 64
    xi = np.random.default_rng(0).standard_normal((2, n, n)).astype(np.float32)
    env = np.sqrt(phillips_spectrum(n, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    return state_from_numpy(xi * env, dispersion(n, 1000.0), device=device)


CONFIG = T.OceanConfig(resolution=64, fft_impl="pallas", mesh_resolution=32, num_patches=4)


def _view(device="cpu"):
    cam = tcam.Camera()
    vp = (tcam.perspective(W / H) @ cam.view()).astype(np.float32)
    return (torch.from_numpy(vp).to(device),
            torch.from_numpy(cam.position.astype(np.float32)).to(device))


def _frame(**kw):
    """A frame renderer and its arguments at time t."""
    fn = tr.make_frame_renderer(CONFIG, W, H, **kw)
    state, (vp, cp) = _state(), _view()
    return lambda t: fn(state, t, vp, cp)


def _recorded(work):
    """``work()`` inside ``recording()``: its result and the units of the
    window it recorded (none where it recorded nothing)."""
    last = profiling.windows()[-1] if profiling.windows() else None
    with profiling.recording():
        out = work()
    new = profiling.windows()[-1] if profiling.windows() else None
    return out, ([] if new is last else list(new.units))


def test_off_by_default_records_nothing_and_hands_out_one_object(monkeypatch):
    draw = _frame(pool=POOL)
    rollout = T.make_rollout(CONFIG, keep_fields=False, time_batch=2)
    state = _state()
    draw(1.0)
    before = [list(w.units) for w in profiling.windows()]

    def no_call(*a, **k):
        raise AssertionError("called while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", no_call)
    monkeypatch.setattr(torch.cuda, "Event", no_call)
    monkeypatch.setattr(profiling, "tallies", no_call)
    draw(2.0)
    rollout(state, np.arange(6) / 60.0)
    assert [list(w.units) for w in profiling.windows()] == before
    first, second = profiling.span("frame", t=1.0), profiling.span("rollout.launches")
    assert first is second is profiling._OFF
    with first as inner:
        assert inner is profiling._OFF
        profiling.count("giant.groups", 3)        # no unit open: nothing to add to
        profiling.annotate(frames=6)


def test_recording_leaves_the_frame_bit_equal():
    draw = _frame(pool=64, giants=32)              # the giant pass runs
    off = draw(4.5)
    on, units = _recorded(lambda: draw(4.5))
    assert torch.equal(on, off) and len(units) == 1


@pytest.mark.parametrize("pool, giants", [(POOL, 512), (64, 32)])
def test_every_stage_span_once_under_its_frame(pool, giants):
    draw = _frame(pool=pool, giants=giants)
    draw(0.0)
    _, units = _recorded(lambda: [draw(t) for t in (1.0, 2.0)])
    assert [u.name for u in units] == ["frame", "frame"]
    for unit, t in zip(units, (1.0, 2.0)):
        top = unit.spans[0]
        assert top.name == "frame" and top.parent is None and unit.attrs == {"t": t, "band": 0}
        for name in FRAME_SPANS:
            (stage,) = unit.named(name)
            assert stage.parent is top and stage.unit is unit
            assert top.start_ns <= stage.start_ns <= stage.end_ns <= top.end_ns
        assert not unit.named("frame.giant_sync")             # the giant count stays on the device
        assert [s.name for s in unit.spans] == ["frame", *FRAME_SPANS]
        assert all(s.device_ms is None for s in unit.spans)     # no device clock on the CPU
    assert units[0].id != units[1].id


@pytest.mark.parametrize("pool, giants, grouped", [(POOL, 512, False), (64, 32, True)])
def test_giant_counters_equal_the_selection(monkeypatch, pool, giants, grouped):
    seen = []
    select = tr._giant_selection

    def spy(score, k):                             # what the host read of the count gave
        out = select(score, k)
        candidates = int((score[torch.sort(score, descending=True, stable=True).indices[:k]]
                          > 0).sum())
        seen.append((candidates, -(-candidates // 32)))
        return out

    monkeypatch.setattr(tr, "_giant_selection", spy)
    draw = _frame(pool=pool, giants=giants)
    draw(0.0)
    seen.clear()
    _, units = _recorded(lambda: [draw(t) for t in (3.0, 7.0)])
    assert len(seen) == len(units) == 2
    for unit, (candidates, groups) in zip(units, seen):
        assert unit.counters["giant.candidates"] == candidates
        assert unit.counters["giant.groups"] == groups
        assert "host_syncs" not in unit.counters and not unit.named("frame.giant_sync")
        assert (groups > 0) == grouped


def test_cpu_frames_run_eagerly(monkeypatch):
    """On the CPU the renderer dispatches every stage, on every frame: no
    graph is captured or replayed, and no frame counts one."""
    def no_graphs(*a, **k):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(tr, "_StageGraphs", no_graphs)
    draw = _frame(pool=64, giants=32)
    off = draw(0.5)
    on, units = _recorded(lambda: [draw(0.5), draw(1.5)])
    assert torch.equal(on[0], off) and len(units) == 2
    for unit in units:
        assert not {"graph.replays", "graph.captures"} & set(unit.counters), unit.counters


def test_device_counts_are_read_when_the_unit_closes():
    """A count held in a tensor is copied when counted and read when its
    unit closes; off, it is neither copied nor read."""
    n = torch.tensor(3)
    with profiling.recording():
        with profiling.span("unit") as top:
            profiling.count("c", n)
            profiling.count("c", 2)
            n += 4                                 # after the count: not counted
            assert top.unit.counters == {"c": 2}
    assert top.unit.counters == {"c": 5}

    class Unreadable(torch.Tensor):
        def clone(self, *a, **k):
            raise AssertionError("copied while recording is off")

    profiling.count("c", torch.tensor(1).as_subclass(Unreadable))


def test_rollout_spans_and_chunks():
    state = _state()
    ts = np.arange(12) / 60.0
    for tb in (1, 3):
        rollout = T.make_rollout(CONFIG, keep_fields=False, time_batch=tb)
        want = rollout(state, ts)
        got, units = _recorded(lambda: rollout(state, ts))
        assert torch.equal(got, want)
        (unit,) = units
        assert unit.name == "rollout" and unit.attrs == {"time_batch": tb, "frames": 12}
        assert unit.counters["rollout.chunks"] == len(ts) // tb
        top = unit.spans[0]
        assert [s.name for s in unit.spans] == ["rollout", "rollout.times",
                                               "rollout.precompute", "rollout.launches"]
        assert all(s.parent is top and s.unit is unit for s in unit.spans[1:])
        assert unit.host_ms("rollout") >= unit.host_ms("rollout.launches") > 0


def test_profiler_session_records_its_active_step_into_the_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile, schedule

    draw = _frame(pool=64, giants=32)
    draw(0.0)
    last = profiling.windows()[-1] if profiling.windows() else None
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        draw(1.0)                                  # the warm-up step: not recorded
        assert profiling.windows()[-1:] == ([last] if last else [])
        prof.step()
        draw(2.0)
        draw(3.0)
    window = profiling.windows()[-1]
    assert window is not last
    units = list(window.units)
    assert [u.attrs["t"] for u in units] == [2.0, 3.0] and all(u.traced for u in units)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    (step,) = [e for e in events if str(e.get("name", "")).startswith("ProfilerStep")]
    names = {s.name for u in units for s in u.spans}
    ranges = sorted((e for e in events if e.get("ph") == "X" and e.get("name") in names),
                    key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in ranges] == [s.name for u in units for s in u.spans]
    assert all(step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"]
               for e in ranges)


def test_second_frame_and_call_build_nothing():
    draw = _frame(pool=64, giants=32)
    state = _state()
    rollout = T.make_rollout(CONFIG, keep_fields=False, time_batch=2)
    tr._mesh_constants.cache_clear()               # the first frame builds the mesh again
    _, units = _recorded(lambda: (draw(1.0), draw(2.0), rollout(state, np.arange(6) / 60.0),
                                  rollout(state, np.arange(6, 12) / 60.0)))
    first, second, call1, call2 = units
    assert first.counters["misses.raster._mesh_constants"] == 1
    for unit in (second, call2):
        assert not [k for k in unit.counters if k.startswith("misses.")], unit.counters


def test_counted_cache_misses_count_in_a_unit():
    """A table declared with ``counted_cache`` counts its misses in a
    recorded unit as ``misses.<module>.<fn>`` and keeps ``lru_cache``'s
    ``cache_info`` and ``cache_clear``; an ``lru_cache`` table without it
    adds no counter."""
    @profiling.counted_cache(maxsize=4)
    def doubled(x):
        return 2 * x

    @functools.lru_cache(maxsize=4)
    def tripled(x):
        return 3 * x

    with profiling.recording():
        with profiling.span("unit") as top:
            got = [doubled(1), doubled(1), doubled(2), tripled(1), tripled(2)]
    assert got == [2, 2, 4, 3, 6]
    assert top.unit.counters == {f"misses.{__name__.rsplit('.', 1)[-1]}.doubled": 2}
    info = doubled.cache_info()
    assert (info.hits, info.misses, info.maxsize, info.currsize) == (1, 2, 4, 2)
    doubled.cache_clear()
    assert doubled.cache_info().currsize == 0


def test_tallies_lose_no_update_across_threads(monkeypatch):
    """Threads adding to one count and to counts of their own, and reading
    the table's growth meanwhile, at a short switch interval: no update is
    lost and no reader fails."""
    monkeypatch.setattr(profiling, "_tallies", {})
    workers, reps = 8, 2000
    errors = []

    def work(k):
        try:
            for i in range(reps):
                profiling.tally("launches.shared")
                if i % 50 == 0:
                    profiling.tally(f"launches.own{k}.{i}")
                profiling.grown({})
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    counts = profiling.tallies()
    assert counts.pop("launches.shared") == workers * reps
    assert counts == {f"launches.own{k}.{i}": 1 for k in range(workers)
                      for i in range(0, reps, 50)}


def test_launch_counters_grow_inside_a_unit():
    with profiling.recording():
        with profiling.span("unit") as top:
            profiling.tally("launches.launch_slot_kernel", 2)
            profiling.tally("launches.launch_segmin_kernel")
    profiling.tally("launches.launch_slot_kernel", -2)
    profiling.tally("launches.launch_segmin_kernel", -1)
    assert top.unit.counters == {"launches.launch_slot_kernel": 2,
                                 "launches.launch_segmin_kernel": 1}


def test_giant_kernel_launches_count_in_a_unit(monkeypatch):
    """K9's wrapper counts through ``kernels.launch``, so a frame whose
    giant pass runs reads ``launches.launch_giant_kernel`` 1; a CPU frame,
    whose giant pass takes the plain version, reads none. The launch runs
    here against a stand-in library, with the card's device and stream
    stubbed, on CPU tensors."""
    from gfx_ocean_tpu_torch import kernels  # noqa: PLC0415

    calls = []

    class Library:
        def giant_pass(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(kernels, "load", lambda name: Library())
    monkeypatch.setattr(kernels, "cuda_device", lambda x, who: x.device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 7}))
    g, n_tris = 2, 6
    ids = torch.zeros((g, 32), dtype=torch.int64)
    key_img = torch.zeros((4, 8), dtype=torch.int64)
    with profiling.recording():
        with profiling.span("unit") as top:
            out = tr.launch_giant_kernel(ids, torch.zeros((g, 32), dtype=torch.bool),
                                         torch.zeros((3, 4)), torch.zeros((n_tris, 3),
                                                                         dtype=torch.int64),
                                         torch.zeros(n_tris), key_img, 8, 4, 4, 0, 17)
    assert top.unit.counters == {"launches.launch_giant_kernel": 1}
    (args,) = calls
    assert out.shape == key_img.shape and args[2] == g * 32 and args[-1].value == 7
    monkeypatch.undo()
    draw = _frame(pool=64, giants=32)              # the giant pass runs
    draw(0.0)
    _, (unit,) = _recorded(lambda: draw(1.0))
    assert unit.counters["giant.groups"] > 0
    assert not [k for k in unit.counters if k.startswith("launches.")], unit.counters


def test_windows_split_at_unrecorded_units_and_keep_at_most_the_cap(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    def unit(name="split.u"):
        with profiling.span(name):
            pass

    unit()                                         # unrecorded: the next unit opens a window
    with profile(activities=[ProfilerActivity.CPU]):
        unit()
        unit()
    unit()                                         # unrecorded: the next window is new
    with profile(activities=[ProfilerActivity.CPU]):
        unit()
    *_, a, b = profiling.windows()
    assert (len(a.units), len(b.units)) == (2, 1)
    assert profiling.largest_window("split.u") == list(a.units)
    assert profiling.largest_window("no such span") is None
    with profiling.recording():
        unit()
    with profile(activities=[ProfilerActivity.CPU]):
        unit()                                     # not in the recording() block's window
    *_, c, d = profiling.windows()
    assert (len(c.units), len(d.units)) == (1, 1)

    monkeypatch.setattr(profiling, "MAX_UNITS", 5)
    monkeypatch.setattr(profiling, "_windows", type(profiling._windows)())
    monkeypatch.setattr(profiling, "_kept", 0)
    for n in (3, 2, 4):
        with profiling.recording():
            for _ in range(n):
                unit()
    assert [len(w.units) for w in profiling.windows()] == [4]   # the older windows went
    with profiling.recording():
        for _ in range(7):
            unit()
    assert [len(w.units) for w in profiling.windows()] == [5]   # then its oldest units


def test_threads_keep_their_own_units():
    """Eight threads record nested spans at once with a short switch
    interval: every span stays in its own thread's unit, and no unit is
    lost."""
    import sys

    per_thread, errors = 40, []

    def work(k):
        try:
            for i in range(per_thread):
                with profiling.span("outer", k=k, i=i):
                    with profiling.span("inner"):
                        profiling.count("n", k)
        except Exception as e:                     # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    units = list(profiling.windows()[-1].units)
    assert len(units) == 8 * per_thread
    for u in units:
        assert [s.name for s in u.spans] == ["outer", "inner"]
        assert u.spans[1].parent is u.spans[0] and u.counters == {"n": u.attrs["k"]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K7 and K8 have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_launch_inside_their_stage_spans_on_the_card(cuda, tmp_path):
    """One traced 1200 x 700 frame, its stages replayed from the graphs the
    first call captured: K7 (``slot_kernel``) is launched inside
    ``frame.slots``, K8 (``segmin_lookback``) inside ``frame.resolve`` and
    K9 (``giant_kernel``) inside ``frame.giant_pass``, on the profiler's
    clock; every stage span has a device time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn = tr.make_frame_renderer(T.OceanConfig(resolution=512, fft_impl="pallas"), 1200, 700)
    state = T.ocean_state_from_phillips(T.OceanConfig(resolution=512),
                                        generator=torch.Generator().manual_seed(0), device=cuda)
    cam = tcam.Camera()
    vp = torch.tensor((tcam.perspective(1200 / 700) @ cam.view()).astype(np.float32),
                      device=cuda)
    cp = torch.tensor(cam.position.astype(np.float32), device=cuda)
    fn(state, 1.0, vp, cp).cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn(state, 2.0, vp, cp).cpu()
        prof.step()
        fn(state, 3.0, vp, cp).cpu()
    (unit,) = list(profiling.windows()[-1].units)
    assert all(unit.device_ms(name) > 0 for name in STAGES)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    assert unit.counters["graph.replays"] == 6
    for kernel, stage in (("slot_kernel", "frame.slots"), ("segmin_lookback", "frame.resolve"),
                          ("giant_kernel", "frame.giant_pass")):
        (rng,) = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == stage]
        (k,) = [e for e in events if e.get("cat") == "kernel" and kernel in e["name"]]
        assert rng["ts"] <= launch_at[k["args"]["correlation"]] <= rng["ts"] + rng["dur"]


def _card_frame(cuda):
    """The cell ``ocean512.frame``'s renderer on a 512^2 Phillips state,
    run once (its stages captured)."""
    config = T.OceanConfig(resolution=512, fft_impl="pallas")
    fn = tr.make_frame_renderer(config, 1200, 700)
    state = T.ocean_state_from_phillips(T.OceanConfig(resolution=512),
                                        generator=torch.Generator().manual_seed(0), device=cuda)
    cam = tcam.Camera()
    vp = torch.tensor((tcam.perspective(1200 / 700) @ cam.view()).astype(np.float32),
                      device=cuda)
    cp = torch.tensor(cam.position.astype(np.float32), device=cuda)

    def frame(t):
        return fn(state, t, vp, cp).cpu()

    frame(0.5)
    return frame


def _union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, cursor = 0.0, float("-inf")
    for a, b in sorted(intervals):
        a = max(a, cursor)
        if b > a:
            total += b - a
            cursor = b
    return total


class _Trace:
    """A Chrome trace's host ranges (``record_function``), the host's CUDA
    event records and the device operations (kernels, copies, fills), each
    with the runtime call that launched it, in us on the profiler's clock."""

    def __init__(self, events):
        self.ranges = sorted((e for e in events if e.get("cat") == "user_annotation"),
                             key=lambda e: e["ts"])
        runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.records = sorted((e["ts"], e["ts"] + e["dur"]) for e in runtime
                              if e["name"].startswith("cudaEventRecord"))
        calls = {e["args"]["correlation"]: e for e in runtime
                 if "correlation" in e.get("args", {})}
        self.ops = [(calls[e["args"]["correlation"]]["ts"], e["ts"], e["ts"] + e["dur"])
                    for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                    and e.get("args", {}).get("correlation") in calls]

    def launched(self, rng) -> list:
        """The ``(start, end)`` of the operations launched inside the range
        ``rng``."""
        lo, hi = rng["ts"], rng["ts"] + rng["dur"]
        return [(a, b) for at, a, b in self.ops if lo <= at <= hi]

    def idle_us(self, rng) -> float:
        """The device's idle time in a unit: its interval, from the end of
        its anchor's record call to the later of its last record call's end
        and its last operation's end, less the union of the operations it
        launched."""
        lo, hi = rng["ts"], rng["ts"] + rng["dur"]
        records = [r for r in self.records if lo <= r[0] <= hi]
        ops = self.launched(rng)
        start = records[0][1]
        end = max([records[-1][1]] + [b for _, b in ops])
        return (end - start) - _union_us((max(a, start), min(b, end)) for a, b in ops)


@pytest.mark.cuda
def test_timeline_agrees_with_the_profiler_on_the_card(cuda, tmp_path):
    """Two traced 1200 x 700 frames under ``torch.profiler`` with host and
    device activity. Each frame and each leaf is cut out of the trace by
    its ``record_function`` range. The recorder's idle time in a frame is
    the device's (the frame's interval less the union of the operations it
    launched, ``_Trace.idle_us``) within 10% or 20 us, whichever is larger;
    each leaf's busy time is the union of the operations launched inside
    its range within 10%."""
    from torch.profiler import ProfilerActivity, profile, schedule

    frame = _card_frame(cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        frame(1.0)
        prof.step()
        frame(2.0)
        frame(3.0)
    units = list(profiling.windows()[-1].units)
    assert [u.name for u in units] == ["frame", "frame"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = _Trace([e for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("ph") == "X"])
    tops = [e for e in trace.ranges if e["name"] == "frame"]
    report, wrong = [], []
    for unit, rng in zip(units, tops):
        line = unit.timeline()
        assert line is not None, "a unit on a drained stream is anchored"
        lo, hi = rng["ts"], rng["ts"] + rng["dur"]
        inside = [e for e in trace.ranges if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
        busy = {name: sum(_union_us(trace.launched(e)) for e in inside if e["name"] == name)
                for name in line.busy_ms}
        idle_us = trace.idle_us(rng)
        report.append({"unit": unit.name, "idle_us": [line.idle_total_ms * 1e3, idle_us],
                       "busy_us": {k: [line.busy_ms[k] * 1e3, v] for k, v in busy.items()}})
        if abs(line.idle_total_ms * 1e3 - idle_us) > max(0.1 * idle_us, 20.0):
            wrong.append((unit.name, "idle"))
        wrong += [(unit.name, k) for k, v in busy.items()
                  if abs(line.busy_ms[k] * 1e3 - v) > 0.1 * v]
    print(json.dumps(report))
    assert not wrong, (wrong, report)


@pytest.mark.cuda
def test_profile_kernels_counts_kernels_alone_on_the_card(cuda):
    """``profile_kernels`` over a recorded frame returns its kernels (K7
    among them) and none of the frame's spans, whose ranges the profiler
    also lays on the device's timeline."""
    frame = _card_frame(cuda)
    seen = profiling.profile_kernels(lambda: frame(1.5), 1, ("slot_kernel",), cpu=True)
    assert seen is not None
    kernels, _ = seen
    assert not set(kernels) & {"frame", *FRAME_SPANS}, sorted(kernels)
