#!/usr/bin/env python3
"""The measurements behind the design of the port's precision tiers, on one
NVIDIA GPU (``gfx_ocean_tpu_torch/ops/fft.py``).

    python3 tools/torch_precision_probe.py

Prints the card's name and power limit, then one JSON line:

- ``accumulation``: a bf16 x bf16 product of random (4096, 512) x (512, 512)
  operands summed by the tensor cores (``torch.mm(..., out_dtype=float32)``)
  and the same bf16 values multiplied on the CUDA cores in FP32, each
  against float64: how much less exactly the tensor cores accumulate;
- ``highest``: the 512^2 step of ``OceanConfig(matmul_precision="highest")``
  on the smoke's state (Phillips, ``torch.Generator`` seed 0) against the
  float64 golden model with the DFT's products in FP32 (TF32 off) and in
  float64, the port's form;
- ``bf16x3_complex``: the same step at "bf16x3" with each complex product
  as four real products of N-term sums (the port's form) and as one
  [Xr | Xi] product over 2N terms, each beside ms a 6-frame call;
- ``card_against_cpu``: each tier's 512^2 planes on the card against the
  CPU's planes of every tier (the inputs of the card-vs-CPU tier test):
  how far the summation order moves a tier, against how far the tiers lie
  apart.

It imports no jax. Exits non-zero without a card.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

T_CHECK = 11.25
CALLS = 20


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


def accumulation(dev) -> dict:
    """Tensor-core against CUDA-core sums of one bf16 product, against float64."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(4096, 512, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(512, 512, device=dev, generator=g).to(torch.bfloat16)
    exact = a.double() @ b.double()
    tc = float((torch.mm(a, b, out_dtype=torch.float32).double() - exact).abs().max())
    fp32 = float(((a.float() @ b.float()).double() - exact).abs().max())
    return {"tensor_cores_max_abs": tc, "fp32_cuda_cores_max_abs": fp32,
            "ratio": tc / fp32, "result_max_abs": float(exact.abs().max())}


def tier_forms(dev, time_ms) -> dict:
    """The 512^2 step against golden: "highest" with FP32 and float64
    products; "bf16x3" with four real products and with one [Xr | Xi]
    product a pass."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.golden.reference import golden_fields
    from gfx_ocean_tpu_torch.ops import fft as tfft
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np

    base = ot.OceanConfig()
    state = ot.ocean_state_from_phillips(base, generator=torch.Generator().manual_seed(0),
                                         device=dev)
    gold = golden_fields(from_pair_np(state.h0.cpu().numpy()), state.omega.cpu().numpy(),
                         T_CHECK, base.domain_size, base.compat)
    scale = float(np.abs(gold).max())
    ts6 = torch.arange(6, dtype=torch.float32, device=dev) / 60.0

    def reading(cfg) -> dict:
        disp = ot.step(state, T_CHECK, cfg).displacement.cpu().numpy()
        roll = ot.make_rollout(cfg, keep_fields=False, time_batch=6)
        return {"rel_linf": float(np.abs(disp - gold).max()) / scale,
                "call_ms": time_ms(lambda: roll(state, ts6))}

    out = {}
    highest = dataclasses.replace(base, matmul_precision="highest")
    full, fp64 = tfft.full_matmul, reading(highest)
    try:   # "highest" as FP32 products (the process keeps TF32 off)
        tfft.full_matmul = lambda a, b: a @ b
        fp32 = reading(highest)
    finally:
        tfft.full_matmul = full
    out["highest"] = {"float64_products": fp64, "fp32_products": fp32}

    split = dataclasses.replace(base, matmul_precision="bf16x3")
    four, complex_mm, tables = reading(split), tfft._complex_mm, {}

    def one_product(xr, xi, key, tier, left, real_out):
        if (key, left) not in tables:
            wr, wi = tfft._table(key, xr.device)
            w = (torch.cat([torch.cat([wr, -wi], -1), torch.cat([wi, wr], -1)], 0) if left
                 else torch.cat([torch.cat([wr, wi], -1), torch.cat([-wi, wr], -1)], 0))
            tables[key, left] = tfft.prepare(w, tier)
        w = tables[key, left]
        if left:
            y = tfft.matmul_tier(w, torch.cat([xr, xi], dim=-2), tier)
            yr, yi = y.split(xr.shape[-2], dim=-2)
        else:
            y = tfft.matmul_tier(torch.cat([xr, xi], dim=-1), w, tier)
            yr, yi = y.split(xr.shape[-1], dim=-1)
        return yr, None if real_out else yi

    try:
        tfft._complex_mm = one_product
        cat = reading(split)
    finally:
        tfft._complex_mm = complex_mm
    out["bf16x3_complex"] = {"four_products": four, "one_product_2n_terms": cat}
    return out


def card_against_cpu(dev) -> dict:
    """The inputs of ``tests/test_torch_kernels.py::test_tier_on_card_equals_cpu_plain_path``
    at 512^2: each tier's planes on the card against the CPU's planes of
    every distinct scheme, |diff| / max |field|."""
    import numpy as np
    import torch

    from gfx_ocean_tpu_torch.config import PhillipsConfig
    from gfx_ocean_tpu_torch.ops import fft as tfft
    from gfx_ocean_tpu_torch.spectra.phillips import phillips_spectrum

    n = 512
    rng = np.random.default_rng(n + 1)
    env = np.sqrt(phillips_spectrum(n, 1000.0, PhillipsConfig()) / 2.0).astype(np.float32)
    xr, xi = (torch.from_numpy((rng.standard_normal((3, n, n)) * env).astype(np.float32))
              for _ in range(2))

    def run(tier, where):
        return [p.cpu() for p in tfft.ifft2_planes_unnorm(
            xr.to(where), xi.to(where), direct_max=1024, precision=tier, centered="ref")]

    def dist(a, b):
        return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))

    schemes = ("bf16x3", "bf16x4", "highest", "default")
    cpu = {t: run(t, "cpu") for t in schemes}
    return {t: {f"cpu_{k}": dist(run(t, dev), v) for k, v in cpu.items()} for t in schemes}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "accumulation": accumulation(dev),
           **tier_forms(dev, lambda fn: event_ms(fn, CALLS)),
           "card_against_cpu": card_against_cpu(dev)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
