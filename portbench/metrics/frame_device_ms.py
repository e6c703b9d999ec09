"""Every device operation's time in the traced window (one whole cycle of
the animation: the step, the renderer's kernels and eager ops, the image's
copy) over its frames, in ms."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["device_op_s"] <= 0:
        return None
    return trace["device_op_s"] / trace["frames"] * 1e3
