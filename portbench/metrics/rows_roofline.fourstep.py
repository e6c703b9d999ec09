"""The row half's least time on the card a frame
(``portbench.roofline_fourstep``) over ``rows_ms.fourstep``, the span
``fourstep.rows``' device time a frame, in %. None where the run has no
trace or the program recorded no such span."""

from portbench import roofline_fourstep, spans


def read(record):
    ms = spans.device_ms_a_frame(record, "fourstep.rows")
    if not ms:
        return None
    return 100.0 * roofline_fourstep.rows_bound(record["config"])["seconds"] / (ms * 1e-3)
