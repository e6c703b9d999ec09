#!/usr/bin/env python3
"""Two trees of the port on one NVIDIA GPU in one run: the tiered bodies
K1t, K2t, K3t and K4t and the paths they carry, measured through entry
points both trees have.

    python3 tools/torch_step_ab.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR holds a checkout of the commit to compare with (for example
``git archive <commit> | tar -x -C build/parent``), CHANGE_DIR (default:
this checkout) the tree under test. Each side runs in a process of its own,
in the order parent, change, change, parent, so that a drift of the card
or the host shows as a difference between the two runs of one side. A side
builds its own kernels (``build/kernels/`` of its tree) and measures:

- K1t, the packed 512^2 step at "bf16x3" on a Phillips state from a
  torch.Generator seeded 0: a call of time batch 6 (the rollout's) and of
  time batch 1 (the frame's), with its checksum, by events and device ms a
  kernel, and the 600-frame checksum rollout at time batch 6;
- K2t at 16384^2 ("bf16x3", the default tier), one frame on a state drawn
  on the card (h0 from a CUDA generator seeded 0, the deep-water dispersion
  as omega): CUDA-event ms a call and torch.profiler's device ms by stage;

and, on Phillips states from a torch.Generator seeded 0:

- config 5 of ``benchmarks/run_all.py`` (4096^2, "high"): K2t one frame,
  K3t with its checksum on K2t's Y, each by events and by device ms a
  stage, the step (K2t + K3t with the checksum) by events, and the
  120-frame checksum rollout at time batch 1;
- the unpacked 512^2 step at "bf16x3" (K4, its tiered body K4t where the
  side has one), a 6-frame call by events and device ms of its kernels,
  and the 600-frame checksum rollouts of both unpacked routes with
  torch.profiler's idle share over 60 frames.

Both sides are timed by this checkout's ``chip_smoke`` helpers
(``event_ms``, ``device_profile``), whatever the side's own; their
profiler window is the side's ``utils/profiling.profile_kernels``, so a
side must be a tree that has it. Prints one JSON line a side and run.
Imports no jax.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

# The stage-2 kernels under the names of either side: fourstep_row_tier2 /
# fourstep_col_tier2 (and their _wide forms) in the trees before the
# warp-specialized stage 1, fourstep_tier2 after it (K2t's stage 2 then runs
# inside fourstep_row_tier1 at N <= 4096).
K2T_KERNELS = ("fourstep_row_tier1", "fourstep_row_tier2", "fourstep_tier2")
K3T_KERNELS = ("fourstep_col_tier1", "fourstep_col_tier2", "fourstep_tier2", "checksum_partials")
# K1t's kernels under the names of either side: packed_spectra_tier only in
# the trees with the persistent product passes.
K1T_KERNELS = ("packed_spectra_tier", "packed_row_tier", "packed_col_tier", "checksum_partials")
K1T_CALLS = 50
# K4 at "bf16x3": the FFT body in the trees before K4t, else K4t's kernels
# (the mma.sync row and column kernels, or the spectra kernel and the
# persistent wgmma passes).
K4_KERNELS = ("unpacked_fused", "unpacked_row_tier", "unpacked_col_tier", "unpacked_spectra_tier",
              "unpacked_row_wgmma", "unpacked_col_wgmma")
BIG_N, BIG_CALLS = 16384, 5
FS_STEPS, FS_REPEATS, FS_CALLS = 120, 3, 20
U_STEPS, U_REPEATS, U_CALLS, U_TIME_BATCH, U_PROFILE_STEPS = 600, 5, 50, 6, 60


def device_ms_seen(smoke, fn, names, calls: int):
    """``kernel_device_ms`` for the kernels of ``names`` that ``fn``
    launches (a side that lacks one launches fewer); None, with a line on
    stderr, where no profiler session recorded any of them."""
    from gfx_ocean_tpu_torch.utils.profiling import profile_kernels

    seen = profile_kernels(fn, calls)
    found = [n for n in names if seen and any(n in k for k in seen[0])]
    if found:
        return smoke.per_launch_ms(seen[0], found)
    print(f"torch.profiler saw none of {names}: not measured", file=sys.stderr, flush=True)
    return None


def measure(root: Path) -> dict:
    """One side: the package of the tree at ``root``, timed by this
    checkout's ``chip_smoke``."""
    sys.path.insert(0, str(root))
    import dataclasses

    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops import unpacked_step as us
    from gfx_ocean_tpu_torch.spectra.phillips import dispersion
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    out = {}

    packed = ot.OceanConfig(resolution=512, fft_impl="pallas", matmul_precision="bf16x3")
    st = ot.ocean_state_from_phillips(packed, generator=torch.Generator().manual_seed(0),
                                      device=dev)
    inputs = fused_step.hoist_packed(st.h0, st.omega, packed)
    for tb in (6, 1):
        ts_tb = torch.arange(tb, dtype=torch.float32, device=dev) / 60.0

        def k1t(ts_tb=ts_tb):
            return fused_step.launch_packed_step(inputs, ts_tb, packed, checksum=True)

        out[f"k1t_tb{tb}_ms"] = smoke.event_ms(k1t, K1T_CALLS)
        out[f"k1t_tb{tb}_device_ms"] = device_ms_seen(smoke, k1t, K1T_KERNELS, K1T_CALLS)
    ts = torch.arange(U_STEPS, dtype=torch.float32, device=dev) / 60.0
    rec = time_rollout(ot.make_rollout(packed, keep_fields=False, time_batch=U_TIME_BATCH), st,
                       ts, repeats=U_REPEATS)
    out["packed_steps_per_sec_tb6"] = rec["steps_per_sec"]
    out["packed_repeats_sec"] = rec["repeats_sec"]
    del st, inputs

    big = ot.OceanConfig(resolution=BIG_N, fft_impl="pallas", matmul_precision="bf16x3")
    gen = torch.Generator(device=dev).manual_seed(0)
    in_big = fs.hoist_fourstep(torch.randn((2, BIG_N, BIG_N), generator=gen, device=dev),
                               torch.from_numpy(dispersion(BIG_N, big.domain_size)).to(dev), big)
    ts1 = torch.zeros(1, device=dev)

    def k2_big():
        return fs.launch_fourstep_row(in_big, ts1, big)

    out["k2t_16384_ms"] = smoke.event_ms(k2_big, BIG_CALLS)
    out["k2t_16384_device_ms"] = device_ms_seen(smoke, k2_big, K2T_KERNELS, BIG_CALLS)
    del in_big
    torch.cuda.empty_cache()

    c5 = ot.OceanConfig(resolution=4096, domain_size=2000.0, fft_impl="pallas",
                        matmul_precision="high")
    st5 = ot.ocean_state_from_phillips(c5, ot.PhillipsConfig(),
                                       generator=torch.Generator().manual_seed(0), device=dev)
    in5 = fs.hoist_fourstep(st5.h0, st5.omega, c5)
    y = fs.launch_fourstep_row(in5, ts1, c5)

    def k2():
        return fs.launch_fourstep_row(in5, ts1, c5)

    def k3():
        return fs.launch_fourstep_col(y, in5.twiddle, c5, checksum=True)

    out["k2t_ms"] = smoke.event_ms(k2, FS_CALLS)
    out["k2t_device_ms"] = device_ms_seen(smoke, k2, K2T_KERNELS, FS_CALLS)
    out["k3t_ms"] = smoke.event_ms(k3, FS_CALLS)
    out["k3t_device_ms"] = device_ms_seen(smoke, k3, K3T_KERNELS, FS_CALLS)
    out["fourstep_step_ms"] = smoke.event_ms(lambda: fused_step.packed_checksums(in5, ts1, c5),
                                             FS_CALLS)
    del y
    ts = torch.arange(FS_STEPS, dtype=torch.float32, device=dev) / 60.0
    rec = time_rollout(ot.make_rollout(c5, keep_fields=False, time_batch=1), st5, ts,
                       repeats=FS_REPEATS)
    out["fourstep_steps_per_sec_tb1"] = rec["steps_per_sec"]
    out["fourstep_repeats_sec"] = rec["repeats_sec"]
    del st5, in5
    torch.cuda.empty_cache()

    single = ot.OceanConfig(resolution=512, fft_impl="pallas", hermitian_pack=False,
                            matmul_precision="bf16x3")
    blocked = dataclasses.replace(single, matmul_precision="highest")
    st = ot.ocean_state_from_phillips(single, generator=torch.Generator().manual_seed(0),
                                      device=dev)
    inputs = us.hoist_unpacked(st.h0, st.omega, single)
    ts6 = torch.arange(U_TIME_BATCH, dtype=torch.float32, device=dev) / 60.0

    def k4():
        return us.launch_unpacked_step(inputs, ts6, single)

    out["k4_ms"] = smoke.event_ms(k4, U_CALLS)
    out["k4_device_ms"] = device_ms_seen(smoke, k4, K4_KERNELS, U_CALLS)
    ts = torch.arange(U_STEPS, dtype=torch.float32, device=dev) / 60.0
    for route, cfg in (("single", single), ("blocked", blocked)):
        rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=U_TIME_BATCH)
        rec = time_rollout(rollout, st, ts, repeats=U_REPEATS)
        prof = smoke.device_profile(lambda: rollout(st, ts[:U_PROFILE_STEPS]).cpu(),
                                    U_PROFILE_STEPS, top=3)
        out[f"unpacked_{route}"] = dict(steps_per_sec=rec["steps_per_sec"],
                                        repeats_sec=rec["repeats_sec"],
                                        idle_share=prof["idle_share"],
                                        device_busy_ms=prof["device_busy_ms"],
                                        wall_ms=prof["wall_ms"])
    return out


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(Path(sys.argv[2]).resolve())), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    change = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else Path(__file__).resolve().parent.parent
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for run, (side, root) in enumerate((("parent", parent), ("change", change),
                                        ("change", change), ("parent", parent))):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", str(root)],
                              cwd=root, capture_output=True, text=True, timeout=1500)
        if proc.returncode:
            sys.exit(f"{side} (run {run}) failed:\n{proc.stdout}\n{proc.stderr}")
        print(json.dumps(dict(run=run, side=side, **json.loads(proc.stdout.splitlines()[-1]))),
              flush=True)


if __name__ == "__main__":
    main()
