"""The share of the traced window of whole rollout calls in which no device
operation ran, in %: what the host dispatch of models/ocean.py and ops/
leaves the card idle."""

from portbench import trace


def read(record):
    return trace.idle_share(record)
