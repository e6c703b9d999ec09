"""The window's wall time over the frames presented (host clock); a frame is
presented when its uint8 image is on the host."""


def read(record):
    if "window_s" not in record:
        return None
    return record["window_s"] / record["frames"] * 1e3
