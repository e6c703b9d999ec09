"""The device's idle time inside a frame, in ms: the program's own
timeline (``gfx_ocean_tpu_torch/utils/profiling.py`` ``Unit.timeline``) of
the span ``frame``, the idle time between its leaves (the step, the
inputs, the six stage graphs, the output) and inside them before the host
returned from their launches, the mean over the traced window's anchored
frames (one whole cycle, recorded on the device alone). None where the run
has no trace or the program has no timeline."""

from portbench import timeline


def read(record):
    return timeline.idle_ms(record, "frame")
