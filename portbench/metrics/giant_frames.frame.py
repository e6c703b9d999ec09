"""The share of the traced window's frames (one whole cycle, recorded on
the device alone) that ran the giant pass, in %: the frames whose program
counter ``giant.groups`` is above 0
(``gfx_ocean_tpu_torch/utils/profiling.py``). None where the run has no
trace or the program recorded no frame."""


def read(record):
    if not record.get("trace"):
        return None
    from gfx_ocean_tpu_torch.utils import profiling

    units = getattr(profiling, "largest_window", lambda name: None)("frame")
    if not units:
        return None
    return 100.0 * sum(u.counters.get("giant.groups", 0) > 0 for u in units) / len(units)
