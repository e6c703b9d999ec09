"""Profiling and timing (counterpart of ``gfx_ocean_tpu/utils/profiling.py``).

- ``trace()``: context manager around ``torch.profiler`` (CPU and CUDA
  activity) that writes a Chrome trace into a directory.
- ``time_rollout()``: steps/s of a checksum rollout, each timed call ended
  by a synchronize and a host copy of the checksums.
- ``profile_kernels()``: the CUDA kernels of a few calls in one
  ``torch.profiler`` window, by kernel, with the window's wall clock.
- ``Ema``: the reference's title-bar smoothing (avg = avg*0.9 + dt*0.1).
- ``tally()`` / ``tallies()``: the process-wide table of counts, and
  ``counted_cache``, an ``lru_cache`` whose misses it counts.
- The recorder: ``span()``, ``count()`` and ``annotate()`` inside the
  program (a frame of ``render/raster.py``, a call of
  ``models/ocean.make_rollout``), kept in memory by window (``windows()``,
  ``largest_window()``).

The recorder. A span is a named interval of the host's clock
(``time.perf_counter_ns``) with its parent span, its attributes and its
unit: the outermost span open on the thread (one frame, one rollout call),
whose id every span inside it shares. A span given a CUDA ``device`` also
records a pair of ``torch.cuda.Event(enable_timing=True)`` on that device's
current stream, taken from a pool of the device's events. Their times are
read only when a reader asks for them (``device_ms``, ``Unit.timeline``),
after the recorded window, and the events then go back to the pool: a
read costs the host more than a new event (PERF.md, PR 28). ``count``
adds to a counter of the current unit (a count held in a device tensor is
read when the unit closes, so nothing waits for the device before then);
each unit also counts the growth of the process-wide table of counts
between its start and its end. The table (``tally()``, ``tallies()``) holds
the kernels' launches, which ``kernels.launch`` adds to
(``launches.<wrapper>``, ``tiered_launches.<wrapper>``), and the misses
of the tables declared with ``counted_cache`` (``misses.<module>.<fn>``).

Recording is on while a ``torch.profiler`` session records (not in its
warm-up steps), and inside ``with recording():``. A span with no recorded
span open on its thread asks (``torch.autograd._profiler_enabled()``); the
spans inside a recorded unit follow it without asking. Off, ``span`` makes
one module-level test and that query and returns one shared object that
does nothing, and ``count`` returns after the test. Under a profiler session each span also enters
``torch.profiler.record_function(name)``, so its range lands in the
session's trace on the clock of the kernels it launched.

Units are kept in windows: a window opens at the first unit recorded after
one that was not, and at the first after the start or the end of a
``recording()`` block. At most
``MAX_UNITS`` units are kept; past it the oldest windows go.

One clock. A unit given a CUDA ``device`` asks its stream whether it is
drained (``Stream.query()``, which does not wait) before it records its own
start event, the anchor. On a drained stream the anchor completes as soon
as it is submitted, so the unit is anchored: each event of the unit on that
device maps onto the host's clock as the unit's ``start_ns`` plus
``elapsed_time(anchor, event)``. A unit whose stream was busy is not
anchored, and has no timeline. ``Unit.timeline()`` charges an anchored
unit's device time (:class:`Timeline`): its leaves are the innermost spans
with CUDA events, which should hold every launch of the unit; the device
interval between two leaves, and between the anchor or the unit's end and
its nearest leaf, is idle and goes to the innermost span open on the host
then that is no leaf (the parent's own time); inside a leaf, the part of
its interval before the host left it is idle and charged to the leaf, the
rest is its busy time. ``mark()`` (``kernels.launch`` calls it after each
launch) records one more event on the innermost open span with events, if
it is a leaf of an anchored unit so far, with the host's time: it cuts the
leaf in two, and each piece's wait runs to the host's time at its end.
What no event on the host's side sees: the gaps between the kernels of one
piece (a CUDA graph's nodes, kernels queued behind each other), which the
timeline counts busy, and a graph's first nodes, which may start before
its launch call returns, which it counts idle. ``outside_ms`` gives the
stretches between consecutive units, the caller's time.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU and, where there is a
    card, CUDA activity) and write its Chrome trace to
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _finish(out: torch.Tensor) -> np.ndarray:
    """Wait for the device and copy the checksums to the host."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out.cpu().numpy()


def time_rollout(rollout: Callable, state, ts, repeats: int = 3) -> dict:
    """Median steps/s of a checksum-mode rollout (``make_rollout(...,
    keep_fields=False)``): one warmup call (kernel build, allocator
    warmup), then ``repeats`` timed calls, each ended by a synchronize and
    a host copy of the per-frame checksums."""
    last = _finish(rollout(state, ts))
    times: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        last = _finish(rollout(state, ts))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    steps = int(np.shape(last)[0])
    return {
        "steps": steps,
        "repeats_sec": times,
        "median_sec": dt,
        "steps_per_sec": steps / dt,
        "ms_per_step": dt / steps * 1e3,
        "checksums": last,
    }


# Profiler sessions ``profile_kernels`` may take: on an H100 machine a
# session now and then records no kernel at all, after a dozen sessions in
# the process that recorded every launch.
PROFILER_ATTEMPTS = 3


def profile_kernels(fn: Callable[[], object], calls: int = 1, names: Sequence[str] = (),
                    cpu: bool = False) -> Optional[Tuple[Dict[str, Tuple[float, int]], float]]:
    """The CUDA kernels of ``calls`` calls of ``fn()`` in one
    ``torch.profiler`` window: ``({kernel: (device ms summed, launches)},
    wall ms of the calls)``.

    One call warms up first, and one more runs as the profiler's warm-up
    step before the window (without it the tracer loses the first launches
    of the window). A session that records no kernel, or not one whose name
    holds each of ``names``, is profiled again, up to ``PROFILER_ATTEMPTS``
    sessions, with a line on stderr; None after the last. ``cpu`` traces
    host activity too. The ``record_function`` ranges (the recorder's spans
    and any other user annotation) are left out: kernels alone.
    """
    from torch.profiler import ProfilerActivity, profile, schedule  # noqa: PLC0415

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.count
                   and not e.key.startswith("ProfilerStep")
                   and not getattr(e, "is_user_annotation", False)}
        if kernels and all(any(n in k for k in kernels) for n in names):
            return kernels, wall_ms
        print(f"torch.profiler saw {len(kernels)} kernels, wanted {list(names)} "
              f"(session {attempt + 1} of {PROFILER_ATTEMPTS})", file=sys.stderr, flush=True)
    return None


def card_name_and_power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    import subprocess  # noqa: PLC0415

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


class Ema:
    """Title-bar EMA of the reference (``src/lib.rs:146-148``)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.value = 0.0

    def update(self, dt: float) -> float:
        self.value = self.value * (1.0 - self.alpha) + dt * self.alpha
        return self.value


# --------------------------------------------------------------------------
# The recorder.
# --------------------------------------------------------------------------

MAX_UNITS = 16384       # units kept over every window

_tallies: Dict[str, int] = {}   # the process-wide counts, by name
_tallies_lock = threading.Lock()  # a server's threads launch and close units at once


def tally(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide count ``name``: a recorded unit counts
    its growth between the unit's start and its end."""
    with _tallies_lock:
        _tallies[name] = _tallies.get(name, 0) + n


def tallies() -> Dict[str, int]:
    """A copy of the process-wide counts, by name; a count never added to is
    absent."""
    with _tallies_lock:
        return dict(_tallies)


def grown(before: Dict[str, int]) -> Dict[str, int]:
    """The counts that changed since ``before`` (a copy of ``tallies()``),
    by how much."""
    return {k: v - before.get(k, 0) for k, v in tallies().items() if v != before.get(k, 0)}


def counted_cache(maxsize: Optional[int]):
    """``functools.lru_cache(maxsize=maxsize)`` whose misses add to the
    count ``misses.<the module's last name>.<fn>`` (``cache_info()`` and
    ``cache_clear()`` as ``lru_cache``'s)."""
    def decorate(fn: Callable) -> Callable:
        name = f"misses.{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"

        @functools.wraps(fn)
        def missed(*args, **kwargs):
            tally(name)
            return fn(*args, **kwargs)

        return functools.lru_cache(maxsize=maxsize)(missed)

    return decorate


_live = 0               # recorded units open on any thread, plus open recording() blocks
_explicit = 0           # open recording() blocks
_between = True         # a unit ran unrecorded since the last recorded one
_lock = threading.Lock()
_tls = threading.local()  # .top: the innermost recorded span open on the thread
_ids = itertools.count(1)
_windows: "collections.deque[Window]" = collections.deque()
_kept = 0               # units in _windows
_pools: Dict[torch.device, list] = {}   # each device's timing events whose times were read
_events_lock = threading.Lock()         # reads the events of a unit and returns them once


def _stream(device: torch.device):
    """The current stream of a CUDA ``device``."""
    return torch.cuda.current_stream(device)


def _event(device: torch.device):
    """A timing event of ``device``: one of its pool, or a new one."""
    try:
        return _pools[device].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True)


class Unit:
    """One recorded frame or call: its spans in the order they opened (its
    own first), its counters; ``anchored`` where its own start event was
    recorded on a drained stream (see the module's docstring)."""

    __slots__ = ("id", "name", "attrs", "spans", "counters", "traced", "anchored",
                 "_marks", "_pending")

    def __init__(self, name: str, attrs: dict, traced: bool):
        self.id = next(_ids)
        self.name, self.attrs, self.traced = name, attrs, traced
        self.anchored = False
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._marks = tallies()
        self._pending: List[Tuple[str, torch.Tensor]] = []   # device counts, read at the close

    def _add(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _close(self) -> None:
        for name, value in self._pending:
            self._add(name, int(value))
        self._pending = []
        for name, n in grown(self._marks).items():
            self._add(name, n)

    def _read(self) -> None:
        """Wait for the unit's closed spans' CUDA events, read their times
        and return the events to their pools. Call under ``_events_lock``."""
        timed = [s for s in self.spans if s._events is not None and s._events[1] is not None]
        if not timed:
            return
        top = self.spans[0]
        # The unit's own end event is recorded after every other on its
        # stream: where it is complete, so are they.
        last = [top] if timed[0] is top and len({s._events[3] for s in timed}) == 1 else timed
        for s in last:
            s._events[1].synchronize()
        anchor = top._events if self.anchored and top._events is not None else None
        read = []
        for s in timed:
            start, end, device, _ = s._events
            read.append((device, [start, end, *(e for _, e in s._marks or ())]))
            if anchor is not None and device == anchor[2]:
                s._at = (0.0 if s is top else anchor[0].elapsed_time(start),
                         anchor[0].elapsed_time(end))
                s._device_ms = s._at[1] - s._at[0]
                if s._marks:
                    s._marks = [(ns, anchor[0].elapsed_time(e)) for ns, e in s._marks]
            else:
                s._device_ms = start.elapsed_time(end)
                s._marks = None
            s._events = None
        for device, events in read:       # once every time is read
            _pools.setdefault(device, []).extend(events)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def host_ms(self, name: str) -> float:
        """The host time of the unit's spans named ``name``, summed (0 where
        there is none)."""
        return sum(s.host_ms for s in self.named(name))

    def device_ms(self, name: str) -> Optional[float]:
        """The device time of the unit's spans named ``name``, summed; None
        where one has none (a CPU device) or there is none."""
        times = [s.device_ms for s in self.named(name)]
        return sum(times) if times and None not in times else None

    def timeline(self) -> Optional["Timeline"]:
        """The unit's device time charged to its spans on the host's clock
        (waiting for its events), or None where it is not anchored or still
        open."""
        if not self.anchored or self.spans[0].end_ns is None:
            return None
        with _events_lock:
            self._read()
        return Timeline(self)


class Timeline:
    """An anchored unit's device time on the host's clock (``Unit.timeline``,
    the module's docstring): ``idle_ms``, the idle time by the name of the
    span it is charged to; ``busy_ms``, the busy time by leaf name (spans of
    one name summed); ``start_ns`` and ``end_ns``, the unit's anchor and its
    last event on the host's clock."""

    __slots__ = ("idle_ms", "busy_ms", "start_ns", "end_ns")

    def __init__(self, unit: Unit):
        top = unit.spans[0]
        self.start_ns = top.start_ns
        self.end_ns = top.start_ns + top._at[1] * 1e6
        self.idle_ms: Dict[str, float] = {}
        self.busy_ms: Dict[str, float] = {}
        timed = [s for s in unit.spans if s._at is not None]
        parents = set()
        for s in timed:
            p = s.parent
            while p is not None and id(p) not in parents:
                parents.add(id(p))
                p = p.parent
        leaves = sorted((s for s in timed if id(s) not in parents), key=lambda s: s._at[0])
        between = leaves[0] is not top      # else the unit's own interval is its one leaf
        segments = _host_segments(unit.spans, {id(s) for s in leaves}) if between else []
        cursor = self.start_ns
        for leaf in leaves:
            begin, end = (top.start_ns + t * 1e6 for t in leaf._at)
            if between and begin > cursor:
                self._charge_gap(cursor, begin, segments, top.name)
            cursor = max(cursor, end)
            marks = leaf._marks or ()
            edges = [begin, *(top.start_ns + t * 1e6 for _, t in marks), end]
            hosts = [*(ns for ns, _ in marks), leaf.end_ns]
            for a, b, host in zip(edges, edges[1:], hosts):
                wait = min(max(host - a, 0.0), b - a)
                self._add(self.idle_ms, leaf.name, wait)
                self._add(self.busy_ms, leaf.name, b - a - wait)
        if between and self.end_ns > cursor:
            self._charge_gap(cursor, self.end_ns, segments, top.name)

    @staticmethod
    def _add(table: Dict[str, float], name: str, ns: float) -> None:
        table[name] = table.get(name, 0.0) + ns * 1e-6

    def _charge_gap(self, a: float, b: float, segments, top: str) -> None:
        """Charge the idle interval [a, b) to the spans open on the host then;
        what lies outside the unit's host interval, to the unit."""
        left = b - a
        for lo, hi, name in segments:
            part = min(b, hi) - max(a, lo)
            if part > 0:
                self._add(self.idle_ms, name, part)
                left -= part
        if left > 0:
            self._add(self.idle_ms, top, left)

    @property
    def idle_total_ms(self) -> float:
        return sum(self.idle_ms.values())


def _host_segments(spans: list, leaves: set) -> list:
    """The host's clock over the unit cut into ``(start_ns, end_ns, name)``
    pieces, each named by the innermost span open then that is neither a
    leaf nor inside one (spans nest on the unit's thread, so the innermost
    is the open span that opened last)."""
    hosts = []
    for s in spans:
        p = s
        while p is not None and id(p) not in leaves:
            p = p.parent
        if p is None:
            hosts.append(s)
    edges = sorted({t for s in hosts for t in (s.start_ns, s.end_ns)})
    segments = []
    for lo, hi in zip(edges, edges[1:]):
        open_ = [s for s in hosts if s.start_ns <= lo and hi <= s.end_ns]
        if open_:
            segments.append((lo, hi, open_[-1].name))
    return segments


def outside_ms(units: Sequence[Unit]) -> List[float]:
    """The device intervals between consecutive anchored units of ``units``
    (in the order they ran, as a window holds them), from one unit's last
    event to the next one's anchor, in ms: the caller's time."""
    lines = [u.timeline() for u in units]
    return [max(0.0, (b.start_ns - a.end_ns) * 1e-6)
            for a, b in zip(lines, lines[1:]) if a is not None and b is not None]


class Window:
    """The units recorded one after another, with no unrecorded unit
    between them."""

    __slots__ = ("units",)

    def __init__(self):
        self.units: "collections.deque[Unit]" = collections.deque()


class Span:
    """A recorded span (see the module's docstring); ``span()`` makes it and
    ``with`` opens and closes it."""

    __slots__ = ("name", "attrs", "parent", "unit", "start_ns", "end_ns", "_device",
                 "_events", "_device_ms", "_at", "_rf", "_marks", "_timed_child")

    def __init__(self, name: str, device, attrs: dict, parent: Optional["Span"]):
        self.name, self.attrs, self.parent = name, attrs, parent
        self._device = device
        self._events = self._device_ms = self._at = self._rf = None
        self._marks: Optional[list] = None     # (host ns, event), then (host ns, device ms)
        self._timed_child = False
        self.start_ns = self.end_ns = None

    def __enter__(self) -> "Span":
        global _live, _between, _kept
        if self.parent is None:
            self.unit = Unit(self.name, self.attrs, torch.autograd._profiler_enabled())
            with _lock:
                _live += 1
                if _between or not _windows:
                    _windows.append(Window())
                    _between = False
                _windows[-1].units.append(self.unit)
                _kept += 1
                while _kept > MAX_UNITS:      # the oldest window goes, or the oldest unit
                    if len(_windows) > 1:
                        _kept -= len(_windows.popleft().units)
                    else:
                        _windows[0].units.popleft()
                        _kept -= 1
        else:
            self.unit = self.parent.unit
        self.unit.spans.append(self)
        _tls.top = self
        if self.unit.traced:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        dev = self._device
        if dev is not None:
            dev = torch.device(dev)
            if dev.type == "cuda":
                if dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                stream = _stream(dev)
                if self.parent is None:
                    self.unit.anchored = stream.query()
                else:
                    self.parent._timed_child = True
                start = _event(dev)
                start.record(stream)
                self._events = (start, None, dev, stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _live
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            start, _, dev, stream = self._events
            end = _event(dev)
            end.record(stream)
            self._events = (start, end, dev, stream)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _tls.top = self.parent
        if self.parent is None:
            self.unit._close()
            with _lock:
                _live -= 1
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """The device time between the span's two CUDA events (waiting for
        the second), None for a span without them."""
        if self._events is not None:
            with _events_lock:
                self.unit._read()
        return self._device_ms


class _Off:
    """The span of a unit that is not recorded: one object for every call."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, device=None, **attrs):
    """A span named ``name`` with ``attrs`` (see the module's docstring),
    for a ``with`` statement; ``device``, a CUDA device, times it with a
    pair of CUDA events on that device's current stream."""
    global _between
    if _live:
        parent = getattr(_tls, "top", None)
        if parent is not None or _explicit:
            return Span(name, device, attrs, parent)
    if torch.autograd._profiler_enabled():
        return Span(name, device, attrs, None)
    _between = True
    return _OFF


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of the recorded unit open on this
    thread, if there is one. ``n`` may be a 0-dim tensor: a copy of it is
    read when the unit closes."""
    if _live:
        top = getattr(_tls, "top", None)
        if top is not None:
            if isinstance(n, torch.Tensor):
                top.unit._pending.append((name, n.detach().clone()))
            else:
                top.unit._add(name, n)


def mark() -> None:
    """After a launch: cut the innermost recorded span open on this thread
    with one more CUDA event, where that span has events, no child with
    events so far, and its unit is anchored (see the module's docstring);
    nothing while a graph is being captured on the current stream."""
    if _live:
        top = getattr(_tls, "top", None)
        if (top is not None and top._events is not None and not top._timed_child
                and top.unit.anchored and not torch.cuda.is_current_stream_capturing()):
            ns = time.perf_counter_ns()
            _, _, dev, stream = top._events
            event = _event(dev)
            event.record(stream)
            if top._marks is None:
                top._marks = []
            top._marks.append((ns, event))


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost recorded span open on this thread, if
    there is one."""
    if _live:
        top = getattr(_tls, "top", None)
        if top is not None:
            top.attrs.update(attrs)


@contextlib.contextmanager
def recording():
    """Record every unit the block runs, in a window of their own (a new
    one, unless the block is inside another)."""
    global _live, _explicit, _between
    with _lock:
        if not _explicit:
            _between = True
        _explicit += 1
        _live += 1
    try:
        yield
    finally:
        with _lock:
            _explicit -= 1
            _live -= 1
            if not _explicit:
                _between = True


def windows() -> List[Window]:
    """The windows kept, oldest first."""
    with _lock:
        return list(_windows)


def largest_window(name: str) -> Optional[List[Unit]]:
    """The units named ``name`` of the window that holds most of them, in
    order; None where no window holds one."""
    best: List[Unit] = []
    for window in windows():
        units = [u for u in list(window.units) if u.name == name]
        if len(units) > len(best):
            best = units
    return best or None
