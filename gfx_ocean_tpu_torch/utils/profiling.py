"""Timing of checksum rollouts (counterpart of ``utils/profiling.py:36-52``)."""

from __future__ import annotations

import time
from typing import Callable, List

import numpy as np
import torch


def _finish(out: torch.Tensor) -> np.ndarray:
    """Wait for the device and copy the checksums to the host."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out.cpu().numpy()


def time_rollout(rollout: Callable, state, ts, repeats: int = 3) -> dict:
    """Median steps/s of a checksum-mode rollout (``make_rollout(...,
    keep_fields=False)``): one warmup call (kernel build, allocator
    warmup), then ``repeats`` timed calls, each ended by a synchronize and
    a host copy of the per-frame checksums."""
    last = _finish(rollout(state, ts))
    times: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        last = _finish(rollout(state, ts))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    steps = int(np.shape(last)[0])
    return {
        "steps": steps,
        "repeats_sec": times,
        "median_sec": dt,
        "steps_per_sec": steps / dt,
        "ms_per_step": dt / steps * 1e3,
        "checksums": last,
    }
