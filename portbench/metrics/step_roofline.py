"""The step's least time on the card a frame (``portbench.roofline``) over
the device time of every kernel of the step's calls a frame, in the traced
window of whole rollout calls, in %."""

from portbench import roofline


def read(record):
    trace = record.get("trace")
    if not trace or trace["kernel_s"] <= 0:
        return None
    return 100.0 * roofline.step_bound(record["config"])["seconds"] / (
        trace["kernel_s"] / trace["frames"])
