"""The inputs of a run, made from ``--seed``: the ocean state and the frame
times.

The state comes from the spectrum the configuration's ``spectrum`` group
names by its ``model``: ``portbench/spectra/<model>.py``, whose
``state(n, domain_size, params, seed, device)`` returns (h0, omega) on the
device. The same seed gives the same state on the same kind of card, so
the reference rebuilds it instead of reading the program's copy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def state(spectrum: dict, n: int, domain_size: float, seed: int, device, root: Path):
    """(h0 (2, N, N), omega (N, N)) float32 on ``device``."""
    from portbench import harness  # noqa: PLC0415

    return harness.load("spectra", spectrum["model"], root).state(
        n, domain_size, spectrum, seed, device)


def frame_times(first: int, count: int, rate_hz: float) -> np.ndarray:
    """Times of the frames ``first`` .. ``first + count - 1`` at ``rate_hz``:
    float32 of the float64 quotient, the values both sides are given."""
    return (np.arange(first, first + count, dtype=np.float64) / rate_hz).astype(np.float32)
