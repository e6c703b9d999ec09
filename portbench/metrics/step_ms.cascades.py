"""The displacement's device time a frame, in ms, on the rollout's derived
route: the program's span ``rollout.step`` (on "pallas" one K1 launch for
every cascade of a chunk) timed by its CUDA events, summed over the traced
window's calls (recorded on the device alone) over their frames
(``gfx_ocean_tpu_torch/models/ocean.py``). None where the run has no trace
or the program recorded no such span."""

from portbench import spans


def read(record):
    return spans.device_ms_a_frame(record, "rollout.step")
