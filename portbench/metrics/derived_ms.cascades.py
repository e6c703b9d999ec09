"""The derived stage's device time a frame, in ms: the program's span
``rollout.derived`` (the normals, every cascade's Jacobian foam and the
checksums' sums) timed by its CUDA events, summed over the traced window's
calls (recorded on the device alone) over their frames
(``gfx_ocean_tpu_torch/models/ocean.py``). None where the run has no trace
or the program recorded no such span."""

from portbench import spans


def read(record):
    return spans.device_ms_a_frame(record, "rollout.derived")
