"""The derived stage's least time on the card a frame
(``portbench.roofline_derived``) over ``derived_ms.cascades``, the span
``rollout.derived``'s device time a frame, in %. None where the run has no
trace or the program recorded no such span."""

from portbench import roofline_derived, spans


def read(record):
    ms = spans.device_ms_a_frame(record, "rollout.derived")
    if not ms:
        return None
    return 100.0 * roofline_derived.derived_bound(record["config"])["seconds"] / (ms * 1e-3)
