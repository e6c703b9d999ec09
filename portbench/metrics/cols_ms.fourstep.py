"""K3's device time a frame, in ms, on the four-step route: the program's
span ``fourstep.cols`` (``gfx_ocean_tpu_torch/ops/fourstep_step.py``: K3's
launch, either body, and the checksum partials' sum) timed by its CUDA
events, summed over the traced window's calls (recorded on the device
alone) over their frames. None where the run has no trace or the program
recorded no such span."""

from portbench import spans


def read(record):
    return spans.device_ms_a_frame(record, "fourstep.cols")
