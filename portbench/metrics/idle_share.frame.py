"""The share of the traced window (one whole cycle of the animation,
recorded on the device alone) in which no device operation ran, in %: what
the renderer's host dispatch leaves the card idle."""

from portbench import trace


def read(record):
    return trace.idle_share(record)
