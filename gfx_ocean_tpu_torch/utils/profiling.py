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
current stream, resolved into its device time only when read. ``count``
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
    host activity too.
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
                   and not e.key.startswith("ProfilerStep")}
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


class Unit:
    """One recorded frame or call: its spans in the order they opened (its
    own first), its counters."""

    __slots__ = ("id", "name", "attrs", "spans", "counters", "traced", "_marks", "_pending")

    def __init__(self, name: str, attrs: dict, traced: bool):
        self.id = next(_ids)
        self.name, self.attrs, self.traced = name, attrs, traced
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
                 "_events", "_device_ms", "_rf")

    def __init__(self, name: str, device, attrs: dict, parent: Optional["Span"]):
        self.name, self.attrs, self.parent = name, attrs, parent
        self._device = device
        self._events = self._device_ms = self._rf = None
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
        if dev is not None and torch.device(dev).type == "cuda":
            stream = torch.cuda.current_stream(dev)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)
            self._events[0].record(stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _live
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
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
            start, end, _ = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
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
