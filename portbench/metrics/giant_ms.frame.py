"""The giant pass's device time a frame, in ms: the mean over the traced
window's frames (one whole cycle, recorded on the device alone) of the
program's span ``frame.giant_pass`` timed by its CUDA events, 0 for a frame
whose counter ``giant.groups`` is 0 (no group ran)
(``gfx_ocean_tpu_torch/utils/profiling.py``). None where the run has no
trace, the program recorded no frame, or a frame that ran a group has no
device time."""

import statistics


def read(record):
    if not record.get("trace"):
        return None
    from gfx_ocean_tpu_torch.utils import profiling

    units = getattr(profiling, "largest_window", lambda name: None)("frame")
    if not units:
        return None
    times = [u.device_ms("frame.giant_pass") if u.counters.get("giant.groups", 0) else 0.0
             for u in units]
    return None if None in times else statistics.fmean(times)
