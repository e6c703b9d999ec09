"""Readings of the program's own spans (``gfx_ocean_tpu_torch/utils/
profiling.py``) for the per-layer metrics: the traced window's rollout
calls, recorded on the device alone."""

from __future__ import annotations

from typing import Optional


def device_ms_a_frame(record: dict, name: str) -> Optional[float]:
    """The device time of the spans ``name``, by their CUDA events, summed
    over the largest recorded window's ``rollout`` calls, over the frames
    of those calls, in ms. None where the run has no trace, the program has
    no recorder or recorded no such span, or a span has no device time."""
    if not record.get("trace"):
        return None
    from gfx_ocean_tpu_torch.utils import profiling  # noqa: PLC0415

    units = getattr(profiling, "largest_window", lambda name: None)("rollout")
    if not units or not all(u.named(name) for u in units):
        return None
    times = [u.device_ms(name) for u in units]
    frames = sum(u.attrs.get("frames", 0) for u in units)
    if None in times or not frames:
        return None
    return sum(times) / frames
