"""Readings of the program's device timeline (``Unit.timeline()`` of
``gfx_ocean_tpu_torch/utils/profiling.py``) for the per-layer metrics: the
traced window's units (frames, recorded in the session
that traces the device alone), each anchored unit's device idle time and
its leaves' busy time on the host's clock. A program without the timeline
(the recorder before it), or a run without a trace, reads nothing."""

from __future__ import annotations

import statistics
from typing import List, Optional


def timelines(record: dict, name: str) -> Optional[List[object]]:
    """The timelines of the anchored units named ``name`` of the largest
    recorded window, in order; None where the run has no trace, the program
    has no timeline, or no unit is anchored."""
    if not record.get("trace"):
        return None
    from gfx_ocean_tpu_torch.utils import profiling  # noqa: PLC0415

    units = getattr(profiling, "largest_window", lambda name: None)(name)
    if not units or not hasattr(units[0], "timeline"):
        return None
    lines = [line for line in (u.timeline() for u in units) if line is not None]
    return lines or None


def idle_ms(record: dict, name: str) -> Optional[float]:
    """The device's idle ms inside a unit named ``name``, the mean over the
    window's anchored units."""
    lines = timelines(record, name)
    return None if lines is None else statistics.fmean(t.idle_total_ms for t in lines)


def busy_ms(record: dict, name: str, span: str) -> Optional[float]:
    """The busy ms of the leaves named ``span`` in a unit named ``name``,
    the mean over the window's anchored units (0 in a unit without one);
    None where no unit has such a leaf."""
    lines = timelines(record, name)
    if lines is None or not any(span in t.busy_ms for t in lines):
        return None
    return statistics.fmean(t.busy_ms.get(span, 0.0) for t in lines)
