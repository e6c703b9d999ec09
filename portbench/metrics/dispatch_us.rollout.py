"""The rollout's host time a time-batch launch, in us: the program's span
``rollout`` summed over the traced window's calls (recorded on the device
alone) over their counter ``rollout.chunks``
(``gfx_ocean_tpu_torch/utils/profiling.py``). None where the run has no
trace or the program recorded no call."""


def read(record):
    if not record.get("trace"):
        return None
    from gfx_ocean_tpu_torch.utils import profiling

    units = getattr(profiling, "largest_window", lambda name: None)("rollout")
    chunks = sum(u.counters.get("rollout.chunks", 0) for u in units or ())
    if not chunks:
        return None
    return sum(u.host_ms("rollout") for u in units) / chunks * 1e3
