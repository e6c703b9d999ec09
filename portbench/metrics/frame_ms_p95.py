"""The 95th percentile over every frame of the window of one frame's time,
from the start of its step to its image on the host (host clock)."""

import numpy as np


def read(record):
    if not record.get("latencies_s"):
        return None
    return float(np.percentile(record["latencies_s"], 95)) * 1e3
