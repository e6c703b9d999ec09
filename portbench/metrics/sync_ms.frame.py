"""The host's wait for the giant count a frame, in ms: the mean over the
traced window's frames (one whole cycle, recorded on the device alone) of
the program's span ``frame.giant_sync``, the read that empties the device's
queue (``gfx_ocean_tpu_torch/utils/profiling.py``). None where the run has
no trace or the program recorded no frame."""

import statistics


def read(record):
    if not record.get("trace"):
        return None
    from gfx_ocean_tpu_torch.utils import profiling

    units = getattr(profiling, "largest_window", lambda name: None)("frame")
    if not units:
        return None
    return statistics.fmean(u.host_ms("frame.giant_sync") for u in units)
