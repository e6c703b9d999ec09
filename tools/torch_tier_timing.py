#!/usr/bin/env python3
"""Time every precision tier of the port's matmul route on one NVIDIA GPU,
for a given checkout of the port (to set two commits side by side).

    python3 tools/torch_tier_timing.py [--root DIR]

``--root`` is the directory that holds the ``gfx_ocean_tpu_torch`` package
to time (default: this checkout). Prints the card's name and power limit,
then one JSON line with, for each tier ("bf16x3", "bf16x4", "high",
"highest", "default"):

- at 512^2, the JAX package's default configuration ``OceanConfig()``
  (``fft_impl="matmul"``, unpacked): ms a 6-frame checksum call (CUDA
  events, mean of 20 back-to-back calls) and steps/s of a 120-frame
  rollout at time batch 6 (``utils.profiling.time_rollout``, median of 3);
- at 4096^2 (config 5: ``domain_size=2000``, matmul route, packed): ms a
  frame and steps/s of an 8-frame rollout at time batch 1, median of 3.

The states are Phillips states from ``torch.Generator`` seed 0, as
``chip_smoke.py`` phases 3 and 8 build them. A tier the package refuses is
recorded with its error. It imports no jax. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

TIERS = ("bf16x3", "bf16x4", "high", "highest", "default")
CALLS = 20
FRAMES_A_CALL = 6
STEPS = 120
BIG_N = 4096
BIG_FRAMES = 8


def event_ms(fn, calls: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def time_tiers(ot, base, frames: int, time_batch: int, call_frames: int) -> dict:
    """Each tier's ms a call of ``call_frames`` frames (0: none) and its
    rollout of ``frames`` frames at ``time_batch``."""
    import torch

    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    dev = torch.device("cuda", 0)
    state = ot.ocean_state_from_phillips(base, generator=torch.Generator().manual_seed(0),
                                         device=dev)
    ts = torch.arange(frames, dtype=torch.float32, device=dev) / 60.0
    out = {}
    for tier in TIERS:
        cfg = dataclasses.replace(base, matmul_precision=tier)
        try:
            roll = ot.make_rollout(cfg, keep_fields=False, time_batch=time_batch)
            rec = {}
            if call_frames:
                rec["call_ms"] = event_ms(lambda: roll(state, ts[:call_frames]), CALLS)
            timed = time_rollout(roll, state, ts, repeats=3)
            rec.update(ms_per_step=timed["ms_per_step"], steps_per_sec=timed["steps_per_sec"])
        except Exception as err:  # noqa: BLE001 - a refused tier is a reading
            rec = {"error": f"{type(err).__name__}: {err}"}
        out[tier] = rec
    del state
    torch.cuda.empty_cache()
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    import gfx_ocean_tpu_torch as ot

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out = {"package": str(Path(ot.__file__).resolve().parent),
           "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "n512": time_tiers(ot, ot.OceanConfig(), STEPS, FRAMES_A_CALL, FRAMES_A_CALL),
           "config5": time_tiers(ot, ot.OceanConfig(resolution=BIG_N, domain_size=2000.0),
                                 BIG_FRAMES, 1, 0)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
