"""Process start to the first timed frame: the state from the seed, the
kernels' build or load, the warm-up calls."""


def read(record):
    return record["setup_s"]
