"""The readers of the program's spans and counters
(``portbench/metrics/host_ms.frame.py``, ``sync_ms.frame.py``,
``giant_ms.frame.py``, ``giant_frames.frame.py``, ``dispatch_us.rollout.py``)
on windows made by hand and on small frames and rollout calls recorded on
the CPU, through the cells' own drives.

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""

from __future__ import annotations

import collections

import pytest

from gfx_ocean_tpu_torch.utils import profiling
from portbench import harness

FRAME = ("host_ms.frame", "sync_ms.frame", "giant_ms.frame", "giant_frames.frame")
ROLLOUT = ("dispatch_us.rollout",)
TRACED = {"trace": {"frames": 1}}          # a traced run's record: the readers read the program
SEED = 2 ** 31 + 11
SMALL = {
    "ocean512.frame": {"config": {"ocean": {"resolution": 64},
                                  "frame": {"width": 120, "height": 70, "reference_samples": 4}},
                       "traffic": {"warmup_calls": 1, "cycle_frames": 3, "frame_rate_hz": 0.5}},
    "ocean512.rollout": {"config": {"ocean": {"resolution": 256},
                                    "rollout": {"chunk_frames": 12}},
                         "traffic": {"warmup_calls": 1}},
}


def _unit(name, spans, counters=()):
    """A unit made by hand: ``spans`` (name, host ms, device ms or None),
    the first the unit's own."""
    unit = profiling.Unit(name, {}, False)
    for span_name, host_ms, device_ms in spans:
        span = profiling.Span(span_name, None, {}, unit.spans[0] if unit.spans else None)
        span.unit, span.start_ns, span.end_ns = unit, 0, round(host_ms * 1e6)
        span._device_ms = device_ms
        unit.spans.append(span)
    unit.counters.update(counters)
    return unit


def _frame(host, sync, giant_device, groups):
    return _unit("frame", [("frame", host, None), ("frame.giant_pass", 1.0, giant_device),
                           ("frame.giant_sync", sync, None)], {"giant.groups": groups})


def _window(*units):
    window = profiling.Window()
    window.units.extend(units)
    return window


@pytest.fixture
def kept(monkeypatch):
    """The recorder's windows, empty for the test and as they were after."""
    windows = collections.deque()
    monkeypatch.setattr(profiling, "_windows", windows)
    monkeypatch.setattr(profiling, "_kept", 0)
    return windows


def _read(name, record=TRACED):
    return harness.reader(name)(record)


def test_readers_take_the_largest_window_made_by_hand(kept):
    kept.append(_window(_frame(50.0, 40.0, 30.0, 1), _unit("rollout", [("rollout", 9.0, None)],
                                                          {"rollout.chunks": 1})))
    kept.append(_window(_frame(10.0, 2.0, 6.0, 1), _frame(8.0, 1.0, 3.0, 0),
                        _frame(12.0, 3.0, 9.0, 2), _frame(6.0, 0.0, 0.5, 0)))
    kept.append(_window(*(_unit("rollout", [("rollout", ms, None)], {"rollout.chunks": 100})
                          for ms in (2.0, 4.0))))
    assert _read("host_ms.frame") == pytest.approx((8 + 7 + 9 + 6) / 4)
    assert _read("sync_ms.frame") == pytest.approx((2 + 1 + 3 + 0) / 4)
    assert _read("giant_ms.frame") == pytest.approx((6 + 0 + 9 + 0) / 4)
    assert _read("giant_frames.frame") == pytest.approx(50.0)
    assert _read("dispatch_us.rollout") == pytest.approx(6.0 / 200 * 1e3)


def test_readers_read_nothing_without_a_window_a_trace_or_the_recorder(kept, monkeypatch):
    for name in FRAME + ROLLOUT:
        assert _read(name) is None
    kept.append(_window(_frame(10.0, 2.0, 6.0, 1),
                        _unit("rollout", [("rollout", 9.0, None)], {"rollout.chunks": 1})))
    for name in FRAME + ROLLOUT:
        assert _read(name) is not None
        assert _read(name, {"trace": None}) is None         # an untraced run, or the CPU's
    monkeypatch.delattr(profiling, "largest_window")        # a program without the recorder
    for name in FRAME + ROLLOUT:
        assert _read(name) is None


def test_giant_ms_wants_a_device_time_where_a_group_ran(kept):
    kept.append(_window(_frame(10.0, 2.0, None, 1), _frame(10.0, 2.0, None, 0)))
    assert _read("giant_ms.frame") is None
    kept.append(_window(*(_frame(10.0, 2.0, None, 0) for _ in range(3))))
    assert _read("giant_ms.frame") == 0.0 and _read("giant_frames.frame") == 0.0


def _recorded_window(cell, seconds):
    loop = harness.drive(harness.load_cell(cell, SEED, "cpu", override=SMALL[cell]))
    loop.setup()
    with profiling.recording():
        out = loop.window(seconds)
    loop.release()
    return out, list(profiling.windows()[-1].units)


def test_frame_readers_on_a_recorded_cycle(kept):
    out, units = _recorded_window("ocean512.frame", 0.0)
    assert out["frames"] == len(units) == 3
    frame_ms = sum(u.host_ms("frame") for u in units) / 3
    host, sync = _read("host_ms.frame"), _read("sync_ms.frame")
    assert host > 0 and sync >= 0 and host + sync == pytest.approx(frame_ms)
    assert host + sync <= 1e3 * sum(out["latencies_s"][-3:]) / 3
    share = _read("giant_frames.frame")
    assert share == 100.0 * sum(u.counters["giant.groups"] > 0 for u in units) / 3
    assert _read("giant_ms.frame") == (0.0 if share == 0 else None)   # no device clock here


def test_rollout_reader_on_recorded_calls(kept):
    out, units = _recorded_window("ocean512.rollout", 0.2)
    assert out["frames"] == 12 * len(units)
    assert all(u.counters["rollout.chunks"] == 2 for u in units)      # 12 frames at time batch 6
    per_launch = _read("dispatch_us.rollout")
    assert per_launch == pytest.approx(sum(u.host_ms("rollout") for u in units)
                                       / (2 * len(units)) * 1e3)
    assert 0 < per_launch <= 1e6 * out["window_s"] / (2 * len(units))
