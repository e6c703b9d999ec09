#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gfx_ocean_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path: the 512^2 Hermitian-packed step
(``OceanConfig(fft_impl="pallas", matmul_precision="bf16x3")``) through
kernel K1, a 600-frame checksum rollout at time_batch 6, gated against the
float64 golden model. It imports no jax. Phases, one line each:

1. device: nvidia-smi name and power limit, torch's device name;
2. build: nvcc builds the kernels from ``gfx_ocean_tpu_torch/csrc``;
3. state: the 512^2 state from the shipped bins, else synthesized from a
   torch.Generator seeded 0;
4. kernel vs plain: K1 against its plain PyTorch version on the card;
5. golden: the step's fields against the float64 golden model;
6. time: one K1 call against one plain call (CUDA events);
7. rollout: make_rollout through K1 (launch count, finite checksums,
   steps/s) and the same rollout through the plain version.

Then one JSON line with the kernels, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with no
result; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N = 512
STEPS = 600
TIME_BATCH = 6
REPEATS = 5
T_CHECK = 11.25
# Frame times of the kernel-vs-plain check: one time batch, from t = 0 to
# an hour, so the Dekker phase is exercised far from the origin.
T_COMPARE = (T_CHECK, 0.0, 1.0 / 60.0, 100.5, 1000.25, 3599.0)
# Kernel vs plain version, |diff| / max |field|. Both are FP32; they differ
# in the transform (radix-2 FFT against dense matmul) and so in summation
# order, which costs a few float32 ulps of the field's scale.
TOL_KERNEL = 1e-5
# Checksums of kernel vs plain, |diff| / sum of |summands|: the checksum of
# a frame nearly cancels, so its own relative error says nothing.
TOL_CHECKSUM = 1e-5
# Relative L-inf against the float64 golden model (bench.py's gate).
GOLDEN_GATE = 1e-4
TIMING_CALLS = 50


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(label: str, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def event_ms(fn, calls: int) -> float:
    """Mean device time of ``fn()`` over ``calls`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    phase("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)
    run(dev, N)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def run(dev, n: int) -> None:
    """Phases 2-7 on ``dev`` at an n x n grid; prints the kernels line."""
    import torch

    import numpy as np

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch import kernels
    from gfx_ocean_tpu_torch.assets.bincode import reference_data_dir
    from gfx_ocean_tpu_torch.golden.reference import golden_fields, golden_normals
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    so = kernels.build("packed_step")
    build_s = time.perf_counter() - t0
    kernels.load("packed_step")
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "bytes stack frame" in ln]
    phase("build", seconds=build_s, library=str(so.relative_to(kernels.BUILD_DIR.parent.parent)),
          ptxas=ptxas)

    # --- 3. state -----------------------------------------------------------
    cfg = ot.OceanConfig(resolution=n, fft_impl="pallas", matmul_precision="bf16x3")
    tier = fused_step.check_supported(cfg, n)
    data = reference_data_dir()
    if all(os.path.exists(os.path.join(data, f)) for f in ("spectrum.bin", "omega.bin")):
        state = ot.ocean_state_from_assets(resolution=n, device=dev)
        source = f"bincode files in {data}"
    else:
        state = ot.ocean_state_from_phillips(
            cfg, generator=torch.Generator().manual_seed(0), device=dev)
        source = "phillips synthesize, torch.Generator seed 0"
    phase("state", source=source, resolution=n, h0_absmax=float(state.h0.abs().max()),
          omega_max=float(state.omega.max()))

    # --- 4. kernel vs plain -------------------------------------------------
    inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
    ts_cmp = torch.tensor(T_COMPARE, dtype=torch.float32, device=dev)
    got = fused_step.packed_planes(inputs, ts_cmp, cfg)
    want = fused_step.packed_planes_reference(inputs, ts_cmp, cfg)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    rel = max_abs / float(want.abs().max())
    ck_got = fused_step.packed_checksums(inputs, ts_cmp, cfg)
    ck_want = fused_step.checksums_of_planes(want, cfg)
    summands = (want.abs().sum(dim=(-3, -2, -1))
                + finite_difference_normals_planes(want[:, 1], cfg.normal_height_scale)
                .abs().sum(dim=(-3, -2, -1)))
    ck_rel = float(((ck_got - ck_want).abs() / summands).max())
    phase("kernel_vs_plain", frames=list(T_COMPARE), planes_max_abs=max_abs,
          planes_rel=rel, checksum_rel_to_summands=ck_rel, tolerance=TOL_KERNEL,
          checksum_tolerance=TOL_CHECKSUM)
    if not (rel <= TOL_KERNEL):
        fail(f"kernel vs plain planes: {rel:.3e} > {TOL_KERNEL}")
    if not (ck_rel <= TOL_CHECKSUM):
        fail(f"kernel vs plain checksums: {ck_rel:.3e} > {TOL_CHECKSUM}")

    # --- 5. golden gate -----------------------------------------------------
    fields = ot.make_step(cfg)(state, T_CHECK)
    disp = fields.displacement.cpu().numpy()
    h0_np = from_pair_np(state.h0.cpu().numpy())
    om_np = state.omega.cpu().numpy()
    gold = golden_fields(h0_np, om_np, T_CHECK, cfg.domain_size, cfg.compat)
    abs_linf = float(np.abs(disp - gold).max())
    rel_linf = abs_linf / float(np.abs(gold).max())
    nrm_linf = float(np.abs(fields.normals.cpu().numpy()
                            - golden_normals(gold[..., 1], cfg.normal_height_scale)).max())
    phase("golden", t=T_CHECK, rel_linf=rel_linf, abs_linf=abs_linf,
          normals_abs_linf=nrm_linf, gate="rel_linf", gate_limit=GOLDEN_GATE,
          effective_precision=tier)
    if not (np.isfinite(disp).all() and rel_linf <= GOLDEN_GATE):
        fail(f"golden gate: relative L-inf {rel_linf:.3e} > {GOLDEN_GATE}")

    # --- 6. one K1 call against one plain call ------------------------------
    ts_tb = torch.arange(TIME_BATCH, dtype=torch.float32, device=dev) / 60.0
    kernel_ms = event_ms(lambda: fused_step.packed_checksums(inputs, ts_tb, cfg),
                         TIMING_CALLS)
    plain_ms = event_ms(lambda: fused_step.packed_checksums_reference(inputs, ts_tb, cfg),
                        TIMING_CALLS)
    phase("time_one_call", frames=TIME_BATCH, kernel_ms=kernel_ms, plain_ms=plain_ms,
          calls=TIMING_CALLS, clock="cuda events")

    # --- 7. rollout ---------------------------------------------------------
    rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH)
    ts = torch.arange(STEPS, dtype=torch.float32, device=dev) / 60.0
    fused_step.launch_packed_step.launches = 0
    rec = time_rollout(rollout, state, ts, repeats=REPEATS)
    launches = fused_step.launch_packed_step.launches
    expected = (REPEATS + 1) * STEPS // TIME_BATCH

    def plain_rollout(st, tt):
        pre = fused_step.hoist_packed(st.h0, st.omega, cfg)
        return torch.cat([fused_step.packed_checksums_reference(pre, tt[i:i + TIME_BATCH], cfg)
                          for i in range(0, tt.shape[0], TIME_BATCH)])

    plain = time_rollout(plain_rollout, state, ts, repeats=REPEATS)
    cks, plain_cks = rec["checksums"], plain["checksums"]
    ck_diff = float(np.abs(cks - plain_cks).max())
    phase("rollout", steps=STEPS, time_batch=TIME_BATCH, repeats=REPEATS,
          steps_per_sec=rec["steps_per_sec"], repeats_sec=rec["repeats_sec"],
          plain_steps_per_sec=plain["steps_per_sec"], plain_repeats_sec=plain["repeats_sec"],
          k1_launches=launches, expected_launches=expected,
          checksums_finite=bool(np.isfinite(cks).all()),
          checksum_max_abs_diff_vs_plain=ck_diff,
          checksum_first=float(cks[0]), checksum_last=float(cks[-1]))
    if launches != expected:
        fail(f"K1 launched {launches} times in the rollout, expected {expected}")
    if cks.shape != (STEPS,) or not np.isfinite(cks).all():
        fail(f"rollout checksums: shape {cks.shape}, finite {bool(np.isfinite(cks).all())}")
    if not (ck_diff <= TOL_CHECKSUM * float(summands.max())):
        fail(f"rollout checksums differ from the plain version by {ck_diff:.3e}")

    print(json.dumps({"kernels": [{
        "name": "K1 packed_step (row pass, column pass, checksum partials)",
        "route": "cuda",
        "source": "gfx_ocean_tpu_torch/csrc/packed_step.cu",
        "replaces": "gfx_ocean_tpu/ops/pallas_step.py:352",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)


if __name__ == "__main__":
    main()
