"""The deferred shading's busy device time a frame, in ms: the busy time
of the leaf span ``frame.shade`` (its CUDA graph's replay) on the program's
own timeline (``gfx_ocean_tpu_torch/utils/profiling.py`` ``Unit.timeline``),
its device interval less the wait for the host's launch, the mean over the
traced window's anchored frames. None where the run has no trace or the
program has no timeline."""

from portbench import timeline


def read(record):
    return timeline.busy_ms(record, "frame", "frame.shade")
