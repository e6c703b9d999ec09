"""The recorder's device timeline (``gfx_ocean_tpu_torch/utils/profiling.py``:
the anchor, ``Unit.timeline``, ``mark``, ``outside_ms``, the pooled CUDA
events) on the CPU, against a stand-in card whose clock is the host's: a
launch runs after the work queued before it, an event completes when the
device reaches it, and every host and device time is known. Then the
benchmark's two readers of the timeline
(``portbench/metrics/idle_ms.frame.py``, ``shade_ms.frame.py``) on windows
recorded there, and on a record of a program without the timeline.

    python -m pytest tests/test_torch_timeline.py -q
"""

from __future__ import annotations

import collections
import types

import pytest
import torch

from gfx_ocean_tpu_torch.utils import profiling
from portbench import harness

CARD = torch.device("cuda", 0)
US = 1000                     # ns
TRACED = {"trace": {"frames": 1}}


class Card:
    """The host's clock (``now``) and a device that runs one launch after
    another (``free``: when it has run everything queued), in ns."""

    def __init__(self):
        self.now = 0
        self.free = 0
        self.events = 0        # events made

    def host(self, us: float) -> None:
        self.now += round(us * US)

    def launch(self, us: float) -> None:
        self.free = max(self.now, self.free) + round(us * US)


@pytest.fixture
def card(monkeypatch):
    """The stand-in card behind the recorder's stream, events and clock,
    and the recorder's windows, queue and pools empty for the test."""
    card = Card()

    class Stream:
        def query(self):
            return card.free <= card.now

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            card.events += 1
            self.at = None

        def record(self, stream):
            self.at = max(card.now, card.free)

        def query(self):
            return self.at <= card.now

        def synchronize(self):
            card.now = max(card.now, self.at)

        def elapsed_time(self, other):
            return (other.at - self.at) / 1e6

    stream = Stream()
    monkeypatch.setattr(profiling, "_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=lambda: card.now))
    monkeypatch.setattr(profiling, "_windows", collections.deque())
    monkeypatch.setattr(profiling, "_kept", 0)
    monkeypatch.setattr(profiling, "_pools", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    return card


def _call(card, slicing=100, chunks=(10, 40), between=20):
    """A call shaped as a rollout's: the times' upload (a 5-us launch),
    ``slicing`` us of the unit's own host time, then one leaf that holds
    every chunk's launch, each marked, ``between`` us of host time apart."""
    with profiling.span("rollout", device=CARD) as top:
        with profiling.span("rollout.times", device=CARD):
            card.launch(5)
        card.host(slicing)
        with profiling.span("rollout.launches", device=CARD):
            for i, us in enumerate(chunks):
                if i:
                    card.host(between)
                card.launch(us)
                profiling.mark()
    return top.unit


def _frame(card, wait=50, shade=100, tables=30, host=5):
    """A frame: leaves of one launch each, the host's ``wait`` us before
    the shading's launch (a graph's replay)."""
    with profiling.span("frame", device=CARD) as top:
        with profiling.span("frame.slot_tables", device=CARD):
            card.launch(tables)
        card.host(host)
        with profiling.span("frame.shade", device=CARD):
            card.host(wait)
            card.launch(shade)
    return top.unit


def test_a_gap_between_leaves_goes_to_the_parent(card):
    with profiling.recording():
        unit = _call(card)
    line = unit.timeline()
    # Device: the times 0-5, idle 5-100 (the call slicing), chunk 100-110,
    # idle 110-120 (the host between chunks), chunk 120-160; the host left
    # at 120.
    assert unit.anchored
    assert line.idle_ms == pytest.approx({"rollout": 0.095, "rollout.times": 0.0,
                                          "rollout.launches": 0.010})
    assert line.busy_ms == pytest.approx({"rollout.times": 0.005, "rollout.launches": 0.050})
    assert (line.start_ns, line.end_ns) == (0, 160 * US)
    assert line.idle_total_ms == pytest.approx(0.105)


def test_marks_cut_a_leaf_of_several_launches(card):
    """A leaf of two launches with host time between them: unmarked, the
    device's work before the host left counts as a wait; marked after each
    launch, each piece's wait is exact."""
    units = []
    with profiling.recording():
        for marked in (False, True):
            with profiling.span("frame", device=CARD) as top:
                with profiling.span("frame.step", device=CARD):
                    card.launch(50)
                    if marked:
                        profiling.mark()
                    card.host(30)
                    card.launch(10)
                    if marked:
                        profiling.mark()
            units.append(top.unit)
            card.now = card.free
    plain, cut = (u.timeline() for u in units)
    assert plain.idle_ms == pytest.approx({"frame.step": 0.030})      # the upper bound
    assert plain.busy_ms == pytest.approx({"frame.step": 0.030})
    assert cut.idle_ms == pytest.approx({"frame.step": 0.0})
    assert cut.busy_ms == pytest.approx({"frame.step": 0.060})


def test_a_mark_falls_on_leaves_of_anchored_units_alone(card, monkeypatch):
    """No event for a mark outside a span with events, in a span with a
    child with events, in an unanchored unit, or while a graph is captured."""
    with profiling.recording():
        with profiling.span("rollout", device=CARD):
            with profiling.span("rollout.launches") as host_only:
                profiling.mark()
            with profiling.span("rollout.launches", device=CARD) as parent:
                with profiling.span("rollout.step", device=CARD):
                    card.launch(5)
                profiling.mark()
        card.launch(100)                       # the next unit finds the stream busy
        with profiling.span("frame", device=CARD) as unanchored:
            profiling.mark()
        card.now = card.free
        with profiling.span("frame", device=CARD) as capturing:
            monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
            profiling.mark()
    assert not unanchored.unit.anchored and capturing.unit.anchored
    for s in (host_only, parent, unanchored, capturing):
        assert not s._marks


def test_a_one_launch_leafs_wait_goes_to_the_leaf(card):
    with profiling.recording():
        unit = _frame(card)
    line = unit.timeline()
    # tables 0-30; host 0-5 in frame, then 50 us in frame.shade before its
    # launch: the device reaches the shading's start event at 30, idle to 55.
    assert line.idle_ms == pytest.approx({"frame.slot_tables": 0.0, "frame.shade": 0.025})
    assert line.busy_ms == pytest.approx({"frame.slot_tables": 0.030, "frame.shade": 0.100})
    assert line.end_ns == 155 * US


def test_a_unit_without_leaves_is_its_own_leaf(card):
    with profiling.recording():
        with profiling.span("frame", device=CARD) as top:
            card.host(30)
            card.launch(70)
    line = top.unit.timeline()
    assert line.idle_ms == pytest.approx({"frame": 0.030})
    assert line.busy_ms == pytest.approx({"frame": 0.070})


def test_a_unit_on_a_busy_stream_is_not_anchored(card):
    card.launch(500)                      # work queued before the unit
    with profiling.recording():
        first = _frame(card)
        card.now = card.free              # the caller waits for the image
        card.host(7)
        second = _frame(card)
    assert not first.anchored and first.timeline() is None
    assert second.anchored and second.timeline() is not None
    assert profiling.outside_ms([first, second]) == []
    assert first.device_ms("frame.shade") == pytest.approx(0.100)   # device times still read


def test_outside_is_the_callers_time_between_units(card):
    with profiling.recording():
        first = _frame(card)
        card.now = card.free
        card.host(12)
        second = _frame(card)
    assert profiling.outside_ms([first, second]) == pytest.approx([0.012])


def test_events_return_to_the_pool_once_read(card):
    """A unit's events stay with it until a reader reads its times; then
    they go back to the pool, and later units take them."""
    units = []
    with profiling.recording():
        for _ in range(3):
            units.append(_call(card, chunks=(10, 10, 10)))
            card.now = card.free
    # A call holds 3 spans with events and 3 marks: 9 events.
    assert card.events == 27 and not profiling._pools
    for unit in units:
        unit.timeline()
    assert len(profiling._pools[CARD]) == 27
    with profiling.recording():
        _call(card, chunks=(10, 10, 10))
    assert card.events == 27 and len(profiling._pools[CARD]) == 18


def test_off_hands_out_one_shared_object_and_records_no_event(card, monkeypatch):
    def no_call(*a, **k):
        raise AssertionError("called while recording is off")

    monkeypatch.setattr(profiling, "_stream", no_call)
    monkeypatch.setattr(profiling, "_event", no_call)
    first = profiling.span("frame", device=CARD, t=0.0)
    assert first is profiling.span("frame.shade", device=CARD) is profiling._OFF
    with first:
        profiling.count("giant.groups", 1)
        profiling.mark()
    assert card.events == 0 and not profiling.windows()


def test_a_span_still_open_keeps_its_events(card):
    with profiling.recording():
        with profiling.span("rollout", device=CARD) as top:
            with profiling.span("rollout.launches", device=CARD) as chunk:
                card.launch(20)
            card.now = card.free
            assert chunk.device_ms == pytest.approx(0.020)     # read inside the open unit
            assert top.unit.timeline() is None
    assert top.unit.timeline().busy_ms == pytest.approx({"rollout.launches": 0.020})


READERS = ("idle_ms.frame", "shade_ms.frame")


def test_readers_read_the_recorded_timeline(card):
    with profiling.recording():
        for wait in (50, 10):
            _frame(card, wait=wait)
            card.now = card.free
        card.launch(100)                 # the next frame finds the stream busy: skipped
        _frame(card, wait=500)
        card.now = card.free
    read = {name: harness.reader(name)(TRACED) for name in READERS}
    # idle: frame 1 waits 25 us for the shading's launch, frame 2 none.
    assert read == pytest.approx({"idle_ms.frame": 0.0125, "shade_ms.frame": 0.100})


def test_readers_read_nothing_from_a_parent_like_record(card, monkeypatch):
    with profiling.recording():
        _frame(card)
    for name in READERS:
        reader = harness.reader(name)
        assert reader(TRACED) is not None
        assert reader({"trace": None}) is None                 # an untraced run
    monkeypatch.delattr(profiling.Unit, "timeline")            # the recorder before the timeline
    for name in READERS:
        assert harness.reader(name)(TRACED) is None
    monkeypatch.delattr(profiling, "largest_window")           # a program without the recorder
    for name in READERS:
        assert harness.reader(name)(TRACED) is None


def test_profile_kernels_leaves_out_spans_and_annotations(monkeypatch):
    """``profile_kernels`` returns kernels alone: a recorded span's range
    and any other user annotation, which the profiler also lays on the
    device's timeline, are not among them (a stand-in profiler)."""
    import torch.profiler as tp

    class Avg:
        def __init__(self, key, annotation=False):
            self.key, self.device_time_total, self.count = key, 1e3, 1
            self.device_type = torch.autograd.DeviceType.CUDA
            self.is_user_annotation = annotation

    class Profile:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            pass

        def key_averages(self):
            return [Avg("slot_kernel"), Avg("frame.shade", annotation=True),
                    Avg("my.range", annotation=True)]

    monkeypatch.setattr(tp, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    kernels, _ = profiling.profile_kernels(lambda: None)
    assert list(kernels) == ["slot_kernel"]
