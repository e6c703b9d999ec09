#!/usr/bin/env python3
"""Launch-shape and register variants of the port's kernels K1-K4 and of
the tiered bodies K2t and K3t, timed on one NVIDIA GPU.

    python3 tools/torch_kernel_variants.py [variant ...]

Each variant is ``gfx_ocean_tpu_torch/csrc/packed_step.cu`` (K1),
``fourstep_step.cu`` (K2, K3) or ``unpacked_step.cu`` (K4) with a few
source edits (the radix, the launch bounds, the block shape), built with
the port's nvcc flags into ``build/variants/`` and called through its C
entry point on the main path's shapes: a 6-frame call at 512^2 (K1 and K4,
with their checksums) and one 4096^2 frame (K2; K3 on K2's Y, with its
checksum), on Phillips states from a torch.Generator seeded 0.
``k1_unpaired`` computes every element's propagate in its own thread,
without sharing the reads of a rho pair of rows. The
``*_loads_only`` variants cut the packed propagate to loads of the
element's own h0 and omega: the time of the staging, passes and stores
alone, so the propagate's share of the kernel. ``k3_moves_only`` and
``k4_moves_only`` drop the FFT passes and keep every load and store (K3's
twiddle and K4's propagate stay): what the data movement alone costs.
``k3_cols64`` runs 64-column bands (256 B a row, 1,024 threads a block),
``k4_together`` the row item's three spectra in one set of passes (six
planes a thread), ``*_two_blocks`` launch bounds for
two 512-thread blocks a SM (64 registers a thread). ``k3_fast_checksum``
swaps the checksum kernel's IEEE divisions and square root for a
reciprocal and ``rsqrtf``: what its per-texel arithmetic costs. The
``k2s*`` variants are K2 at 16384^2
(``fourstep_row_pass_split``, one frame on a 16384^2 state drawn on the
card): ``k2s_split4`` splits a row over a cluster of 4 blocks of 512
threads (4096-point quarters, two blocks a SM; three quarters of the
points cross SMs) in place of 2 of 1,024 (8192-point halves, one a SM),
``k2s_hoisted`` lets the compiler hoist the thread index's addresses out
of the loops (not made opaque each frame), ``k2s_no_swap_stores`` drops
the swap's stores into the slots (the barriers stay; the output is wrong):
what the distributed-shared-memory traffic costs. ``k2s_8192`` is the
repository's K2 at 8192^2, one frame (``fourstep_row_pass<13>``, the
passes each block of the split runs; K2 at 4096^2, ``k2_repo``, runs those
of ``k2s_split4``): four 8192^2 frames, or sixteen 4096^2 ones, hold as
many elements as one 16384^2 frame. The ``k8*``
variants are K8 (``raster.cu``, ``segmin_lookback``) on 735,784 synthetic
entries (ascending ids over 105,000 octs, the frame's resolve size; 5
packed rows): ``k8_late_stores`` stores every entry after the look-back
(not those outside the head run before it), ``k8_min4`` asks for four
blocks a SM (at most 64 registers),
``k8_blockidx`` takes tile blockIdx.x instead of a ticket (no atomic; it
relies on blocks starting in index order, which CUDA does not promise).
The ``k2t*`` and ``k3t*`` variants are K2's and K3's tiered bodies at
config 5 "high" (one 4096^2 frame; K3t on K2t's Y, with its checksum), the
``k2tw*`` variants K2t at 16384^2 "bf16x3" (one frame on the state of the
``k2s`` variants): ``k2t_scratch`` runs K2t's stage 2 from the scratch
(``fourstep_tier2``, as at N >= 8192) in place of in its stage-1 kernel,
``*_default`` run "default", ``*_loads_only`` cut K2t's propagate to the
element's own loads (so the producers' propagate's share of stage 1),
``k2t_p96`` gives stage 1's producers 96 registers a thread where stage 2
runs in the block (the consumers 160) in place of 80 (176), ``k3t_p64``
64 (192), ``k2tw_p80`` 80 at 16384^2 in place of 96, ``*_default_p112``
112 at "default" in place of 80, ``*_producers1`` runs
one producer warpgroup in place of two (each thread two tasks a chunk;
producers 120 registers, consumers 192), ``*_tier2_rolled`` runs
the stage-2 loader's rounds one task at a time. The ``k1t*`` variants are
K1's tiered body at "bf16x3" (a 6-frame 512^2 call with its checksum, 3
cascades x 6 frames for ``k1t_cascades``): ``k1t_no_table`` has the
producers copy the table's first slot (16 KB, L2-resident) in place of
each slot, so the table's reads beyond L2; ``k1t_no_copy`` hands the slots
over without copying them, so the table's transfer from L2;
``k1t_no_products`` hands every slot over but issues no product, so the
products' share; ``k1t_no_epilogue`` stores no output of the product
passes; ``k1t_one_tile`` copies only a block's first tile, so the others'
copies; ``k1t_loads_only`` cuts the spectra kernel's propagate to the
element's own loads (as ``k1_loads_only``); ``k1t_slot1`` runs ring slots
of one k-step (6 a ring) in place of two (3); ``k1t_half_copy`` copies
half of each slot (the L2 traffic a two-block multicast would leave a
block); ``k1t_stages2`` rings of 2 slots in place of 3; ``k1t_one_wave``
runs the 512^2 call at time batch 4, ``k1t_tb1`` one frame (the frame
renderer's call): the plan at other time batches. The ``k4t*`` variants
are K4's tiered body at "bf16x3" (``k4t_default`` at "default"; a 6-frame
512^2 call with its checksum), as the ``k1t*`` ones: ``k4t_half_copy``
(the table's L2 traffic a two-block multicast would leave a block),
``k4t_no_copy``, ``k4t_no_products``, ``k4t_one_tile``,
``k4t_no_epilogue``, ``k4t_slot1``; ``k4t_no_lo`` hands the lo ring's
slots over without copying them, ``k4t_lo3`` runs a lo ring of 3 slots in
place of 5, ``k4t_floor`` copies nothing and multiplies nothing (the
hand-over and the epilogue alone). The outputs of the
variants that take work out are wrong. The FFT-body variants run at
"highest". Names on the command line pick variants.
Prints, per variant and repeat, one JSON line: the ptxas register / stack
lines, the CUDA-event ms of a call, the device ms of the kernels' own
launches (``chip_smoke.kernel_device_ms``; K1 per kernel) and the largest
difference from the repository's kernel relative to its largest value.
Imports no jax.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
import gfx_ocean_tpu_torch as ot  # noqa: E402
from gfx_ocean_tpu_torch import kernels  # noqa: E402
from gfx_ocean_tpu_torch.ops import fft as tfft  # noqa: E402
from gfx_ocean_tpu_torch.ops import fourstep_step as fs  # noqa: E402
from gfx_ocean_tpu_torch.ops import fused_step  # noqa: E402
from gfx_ocean_tpu_torch.ops import unpacked_step as us  # noqa: E402
from gfx_ocean_tpu_torch.ops.propagate import _f32  # noqa: E402
from gfx_ocean_tpu_torch.render import raster as rr  # noqa: E402
from gfx_ocean_tpu_torch.spectra.phillips import dispersion  # noqa: E402

OUT = ROOT / "build" / "variants"
# The C entry points' tiered-body arguments for the FFT body: passes 0,
# no tables or twiddles.
NO_TIER = (0, None, None, None, None)
REPEATS = 2

K2_BOUNDS = "kSmThreads / RowFft<LOG2N>::kT)"
K2S_NO_SWAP_STORES = ("            store_cluster<(q * kRadix + kSplit * g) * kT * 4>(to, c[q][j]);\n",
                      "")

def k2(log2_radix: int, sm_threads: int | None) -> list:
    """K2 at radix 2^log2_radix, launch bounds for sm_threads threads a SM
    (None: one block a SM)."""
    bounds = "1)" if sm_threads is None else f"{sm_threads} / RowFft<LOG2N>::kT)"
    return [("constexpr int kLog2Radix = 3;", f"constexpr int kLog2Radix = {log2_radix};"),
            (K2_BOUNDS, bounds)]


# ocean::packed_propagate_pair cut to the reads of the element's h0 and
# omega: the kernels keep their staging, passes and stores.
LOADS_ONLY = [("ocean_common.cuh", """  float p[4], q[4];
  pre_planes(h0, nn, idx, conj_neg, p);""", """  if (nn > 0) {
    PackedPair r;
    r.e.hr = half * __ldg(h0 + idx);
    r.e.hi = __ldg(h0 + nn + idx);
    r.e.zr = t * __ldg(omega + idx);
    r.e.zi = 0.0f;
    r.rho = r.e;
    r.rho.hi = -r.e.hi;
    return r;
  }
  float p[4], q[4];
  pre_planes(h0, nn, idx, conj_neg, p);""")]

RUN = "\n  Fft::template run<0>(v, tid, tw, sm);\n"
K3_ONE_BLOCK = ("constexpr int kColBlocksPerSm = 2;", "constexpr int kColBlocksPerSm = 1;")
K4_TWO_BLOCKS = ("constexpr int kBlocksPerSm = 1;", "constexpr int kBlocksPerSm = 2;")
K4_TOGETHER = ("constexpr bool kRowTogether = false;", "constexpr bool kRowTogether = true;")
K1_ROW = "__launch_bounds__(Shape<LOG2N>::kRows * Shape<LOG2N>::kT)"
K1_COL = "__launch_bounds__(Shape<LOG2N>::kColThreads)"
# K2t's stage 2 from the scratch at 4096^2 (fourstep_tier2), as at N >= 8192,
# in place of in its stage-1 kernel
# K1t's producer copying the table's first slot (L2-resident) in place of
# each slot: the table's reads beyond L2 taken out.
K1T_NO_TABLE = ("a.table + (static_cast<size_t>(g) * plan.ksteps + ks) * S::kStep,", "a.table,")
# K1t's producers handing the slots over without copying them: the table's
# transfer from L2 taken out.
K1T_NO_COPY = ("""        tr::mbar_expect_tx(full + i, steps * S::kStep);
        tr::bulk_load(rings + static_cast<size_t>(i) * S::kSlot,
                      a.table + (static_cast<size_t>(g) * plan.ksteps + ks) * S::kStep,
                      steps * S::kStep, full + i);
""", "        tr::mbar_arrive(full + i);\n")
# K1t's product passes storing nothing (no epilogue).
K1T_NO_EPILOGUE = ("      if (o >= n) continue;", "      if (o >= 0) continue;")
# K1t's consumers issuing no products (the slots still handed over).
K1T_NO_PRODUCTS = (
    "      slot_products<kTerms, kRow>(acc, ring + slot * S::kSlot, tile, ks, steps, n);\n", "")
# K1t's product passes copying a block's first tile only: the tiles'
# copies after the first taken out.
K1T_ONE_TILE = [("      for (long long t = u0 / plan.pairs; t * plan.pairs < u1; ++t) {",
                 "      for (long long t = u0 / plan.pairs; t == u0 / plan.pairs; ++t) {"),
                ("    if (t != held) {", "    if (held == -1) {")]
# K1t's producers copying half of each slot: the traffic a 2-block multicast
# would leave each block.
K1T_HALF_COPY = [("        tr::mbar_expect_tx(full + i, steps * S::kStep);",
                  "        tr::mbar_expect_tx(full + i, steps * S::kStep / 2);"),
                 ("                      steps * S::kStep, full + i);",
                  "                      steps * S::kStep / 2, full + i);")]
# K1t's rings of 2 slots in place of 3 at the split.
K1T_STAGES2 = ("kTerms == 2 ? 3 : 6;", "kTerms == 2 ? 2 : 6;")
# K1t's ring slots of one k-step (6 a ring at the split) in place of two (3).
K1T_SLOT1 = [("static constexpr int kSlotSteps = 2;", "static constexpr int kSlotSteps = 1;"),
             ("kTerms == 2 ? 3 : 6;", "kTerms == 2 ? 6 : 12;")]
# K4t's lo producer handing its slots over without copying them: the lo
# terms' stream taken out.
K4T_NO_LO = ("""            tr::mbar_expect_tx(lo_full + slot, steps * S::kTileStep);
            tr::bulk_load(lo + slot * S::kLoSlot, src + ks * S::kTileStep, steps * S::kTileStep,
                          lo_full + slot);
""", "            tr::mbar_arrive(lo_full + slot);\n")
# K4t's consumers issuing no products (the slots still handed over).
K4T_NO_PRODUCTS = ("""      slot_products<kTerms, kRow>(acc, ring + slot * S::kSlot, tile, lo + lslot * S::kLoSlot, ks,
                                  steps);
""", "")
# K4t's lo ring of 3 slots in place of 5.
K4T_LO3 = ("kLoStages = kTerms == 2 ? 5 : 0;", "kLoStages = kTerms == 2 ? 3 : 0;")
# K4t's ring slots of one k-step (6 a ring at the split, the lo ring 10) in
# place of two (3, 5).
K4T_SLOT1 = [("static constexpr int kSlotSteps = 2;", "static constexpr int kSlotSteps = 1;"),
             ("kTerms == 2 ? 3 : 6;", "kTerms == 2 ? 6 : 12;"),
             ("kLoStages = kTerms == 2 ? 5 : 0;", "kLoStages = kTerms == 2 ? 10 : 0;")]
K2T_SCRATCH = ("static constexpr bool kFused = kRow && LOG2N <= 12;",
               "static constexpr bool kFused = false;")


REGS = "static constexpr int kProducerRegs = kRow && !kFused ? 96 : 80;"


def regs(split: int, wide: int, default: int) -> tuple:
    """Stage 1's setmaxnreg split: the producers' registers a thread where
    K2t runs stage 2 in the block and in K3t (split), in K2t at N >= 8192
    (wide), each at "default" (default; the consumers take the rest of 128
    x 2)."""
    return (REGS, f"static constexpr int kProducerRegs = kTerms == 1 ? {default} : "
                  f"(kRow && !kFused ? {wide} : {split});")


# Stage 1 with one producer warpgroup (384 threads, 168 registers a thread
# at launch): producers 120, consumers 192
PRODUCERS1 = [("constexpr int kProducers = 2;", "constexpr int kProducers = 1;"),
              regs(120, 120, 120)]
# The stage-2 loader's rounds not unrolled (one task's 8 loads at a time)
TIER2_ROLLED = ("#pragma unroll 4\n    for (int round = 0;", "#pragma unroll 1\n    for (int round = 0;")
VARIANTS = {
    "k2_repo": ("fourstep_step", []),
    "k2_r16": ("fourstep_step", k2(4, None)),
    "k2_r16_t1024": ("fourstep_step", k2(4, 1024)),
    "k2_r8_t2048": ("fourstep_step", k2(3, 2048)),
    "k2_tid_plain": ("fourstep_step", [("const int tid = threadIdx.x % Fft::kT;",
                                        "const int tid = threadIdx.x;")]),
    "k2_loads_only": ("fourstep_step", LOADS_ONLY),
    "k1_repo": ("packed_step", []),
    "k1_cols4": ("packed_step", [("kColCols = 8;", "kColCols = 4;")]),
    "k1_cols16": ("packed_step", [("kColCols = 8;", "kColCols = 16;")]),
    "k1_row256": ("packed_step", [("kRowThreads = 128;", "kRowThreads = 256;")]),
    "k1_row_min12": ("packed_step", [(K1_ROW, K1_ROW[:-1] + ", 12)")]),
    "k1_row_min16": ("packed_step", [(K1_ROW, K1_ROW[:-1] + ", 16)")]),
    "k1_col_min3": ("packed_step", [(K1_COL, K1_COL[:-1] + ", 3)")]),
    "k1_unpaired": ("packed_step", [("rows, side, pair == 0, tid", "rows, side, true, tid")]),
    "k1_loads_only": ("packed_step", LOADS_ONLY),
    "k3_repo": ("fourstep_step", []),
    # every plane stays read: stage 2 otherwise drops Im F(H) with its loads
    "k3_moves_only": ("fourstep_step", [(RUN, "\n"), ("acc += v[0][i] + v[2][i] + v[3][i];",
                                                    "acc += v[0][i] + v[1][i] + v[2][i] + v[3][i];")]),
    "k3_one_block": ("fourstep_step", [K3_ONE_BLOCK]),
    "k3_cols64": ("fourstep_step", [("constexpr int kColCols = 32; ", "constexpr int kColCols = 64; "),
                                    K3_ONE_BLOCK]),
    "k4_repo": ("unpacked_step", []),
    "k4_two_blocks": ("unpacked_step", [K4_TWO_BLOCKS]),
    "k4_together": ("unpacked_step", [K4_TOGETHER]),
    "k4_together_two_blocks": ("unpacked_step", [K4_TOGETHER, K4_TWO_BLOCKS]),
    # reciprocal and rsqrt in place of the checksum's IEEE divisions and sqrt
    "k3_fast_checksum": ("fourstep_step", [
        ("ocean_common.cuh", "const float cx = ((h[rowo + xr] - h[rowo + xl]) / hs) * diff;",
         "const float cx = ((h[rowo + xr] - h[rowo + xl]) * (1.0f / hs)) * diff;"),
        ("ocean_common.cuh", "const float cz = -diff * ((c[j + 2] - c[j]) / hs);",
         "const float cz = -diff * ((c[j + 2] - c[j]) * (1.0f / hs));"),
        ("ocean_common.cuh", "acc += (cx + cy + cz) / sqrtf(cx * cx + cy * cy + cz * cz);",
         "acc += (cx + cy + cz) * rsqrtf(cx * cx + cy * cy + cz * cz);")]),
    "k4_moves_only": ("unpacked_step", [(RUN, "\n")]),
    "k8_repo": ("raster", []),
    "k8_min4": ("raster", [("__global__ void __launch_bounds__(kSegThreads)\nsegmin_lookback",
                            "__global__ void __launch_bounds__(kSegThreads, 4)\nsegmin_lookback")]),
    "k8_late_stores": ("raster", [
        ("  if (final_now) store_entries<VEC>(m, id, next_id, i0, n, n_oct, mins, skey);\n", ""),
        ("  if (!final_now) store_entries<VEC>", "  store_entries<VEC>")]),
    "k8_blockidx": ("raster", [("    const int t = static_cast<int>(atomicAdd(ticket, 1u));",
                                "    const int t = static_cast<int>(blockIdx.x);")]),
    "k2s_repo": ("fourstep_step", []),
    "k2s_split4": ("fourstep_step", [("constexpr int kLog2Split = 1;",
                                      "constexpr int kLog2Split = 2;")]),
    "k2s_hoisted": ("fourstep_step", [('      asm volatile("mov.b32 %0, %1;" : "=r"(ftid) : "r"(tid));',
                                       "      ftid = tid;")]),
    "k2s_no_swap_stores": ("fourstep_step", [K2S_NO_SWAP_STORES]),
    "k2s_loads_only": ("fourstep_step", LOADS_ONLY),
    "k2s_8192": ("fourstep_step", []),
    "k2t_repo": ("fourstep_step", []),
    "k2t_scratch": ("fourstep_step", [K2T_SCRATCH]),
    "k2t_loads_only": ("fourstep_step", LOADS_ONLY),
    "k2t_p96": ("fourstep_step", [regs(96, 96, 96)]),
    "k2t_producers1": ("fourstep_step", PRODUCERS1),
    "k3t_repo": ("fourstep_step", []),
    "k3t_tier2_rolled": ("fourstep_step", [TIER2_ROLLED]),
    "k3t_p64": ("fourstep_step", [regs(64, 96, 64)]),
    "k2t_default": ("fourstep_step", []),
    "k2t_default_p112": ("fourstep_step", [regs(80, 96, 112)]),
    "k3t_default": ("fourstep_step", []),
    "k3t_default_p112": ("fourstep_step", [regs(80, 96, 112)]),
    "k2tw_repo": ("fourstep_step", []),
    "k2tw_loads_only": ("fourstep_step", LOADS_ONLY),
    "k2tw_p80": ("fourstep_step", [regs(80, 80, 80)]),
    "k2tw_producers1": ("fourstep_step", PRODUCERS1),
    "k2tw_tier2_rolled": ("fourstep_step", [TIER2_ROLLED]),
    "k1t_repo": ("packed_step", []),
    "k1t_no_table": ("packed_step", [K1T_NO_TABLE]),
    "k1t_no_products": ("packed_step", [K1T_NO_PRODUCTS]),
    "k1t_one_tile": ("packed_step", K1T_ONE_TILE),
    "k1t_no_copy": ("packed_step", [K1T_NO_COPY]),
    "k1t_no_epilogue": ("packed_step", [K1T_NO_EPILOGUE]),
    "k1t_loads_only": ("packed_step", LOADS_ONLY),
    "k1t_slot1": ("packed_step", K1T_SLOT1),
    "k1t_half_copy": ("packed_step", K1T_HALF_COPY),
    "k1t_stages2": ("packed_step", [K1T_STAGES2]),
    "k1t_one_wave": ("packed_step", []),
    "k1t_tb1": ("packed_step", []),
    "k1t_cascades": ("packed_step", []),
    "k4t_repo": ("unpacked_step", []),
    "k4t_default": ("unpacked_step", []),
    "k4t_half_copy": ("unpacked_step", K1T_HALF_COPY),
    "k4t_no_copy": ("unpacked_step", [K1T_NO_COPY]),
    "k4t_no_lo": ("unpacked_step", [K4T_NO_LO]),
    "k4t_no_products": ("unpacked_step", [K4T_NO_PRODUCTS]),
    "k4t_lo3": ("unpacked_step", [K4T_LO3]),
    "k4t_one_tile": ("unpacked_step", K1T_ONE_TILE),
    "k4t_no_epilogue": ("unpacked_step", [K1T_NO_EPILOGUE]),
    "k4t_slot1": ("unpacked_step", K4T_SLOT1),
    "k4t_floor": ("unpacked_step", [K1T_NO_COPY, K4T_NO_LO, K4T_NO_PRODUCTS]),
}
# The time batch of each k1t variant (6 where not named).
K1T_FRAMES = {"k1t_one_wave": 4, "k1t_tb1": 1}


def build(name: str):
    """Write and compile one variant; returns (name, library, ptxas lines)."""
    src, edits = VARIANTS[name]
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for header in kernels.CSRC.glob("*.cuh"):
        shutil.copy(header, d)
    shutil.copy(kernels.CSRC / f"{src}.cu", d)
    for edit in edits:  # (old, new) in the .cu, or (header, old, new)
        path = d / (edit[0] if len(edit) == 3 else f"{src}.cu")
        old, new = edit[-2:]
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {path.name}")
        if old == RUN and text.count(old) != 2:
            raise RuntimeError(f"{name}: expected two FFT runs in {path.name}")
        path.write_text(text.replace(old, new))
    so = d / f"lib{name}.so"
    cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(d / f"{src}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    # ptxas's register and stack lines, and its notes where it serialized
    # wgmma (C7515-C7520: waits injected around the accumulators)
    ptxas = [ln.split(":", 1)[-1].strip() for ln in proc.stderr.splitlines()
             if "Used" in ln and "registers" in ln or "stack frame" in ln
             or "warpgroup" in ln and "injected" in ln]
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in kernels.SIGNATURES[src].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return name, lib, ptxas


def main() -> None:
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    names = sys.argv[1:] or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def drawn(n: int):
        """A state drawn on the card (h0 from a CUDA generator seeded 0, the
        deep-water dispersion as omega), its K2 inputs and K2's Y of one frame."""
        cfg = ot.OceanConfig(resolution=n, fft_impl="pallas", matmul_precision="highest")
        gen = torch.Generator(device=dev).manual_seed(0)
        inputs = fs.hoist_fourstep(torch.randn((2, n, n), generator=gen, device=dev),
                                   torch.from_numpy(dispersion(n, cfg.domain_size)).to(dev), cfg)
        return n, cfg, inputs, fs.launch_fourstep_row(inputs, torch.zeros(1, device=dev), cfg)

    split = {}  # n -> (n, cfg, inputs, Y) of the k2s variants
    if any((name.startswith("k2s") and name != "k2s_8192") or name.startswith("k2tw")
           for name in names):
        split[16384] = drawn(16384)
    if "k2s_8192" in names:
        split[8192] = drawn(8192)
    if any(name.startswith("k8") for name in names):
        rng = np.random.default_rng(0)
        n8, oct8 = 735_784, 105_000
        so8 = torch.from_numpy(np.sort(rng.integers(0, oct8 + 1, n8)).astype(np.int32)).to(dev)
        sk8 = torch.from_numpy(rng.integers(-2**31, 2**31, (5, n8), dtype=np.int64)
                               .astype(np.int32)).to(dev)
        want8 = torch.cat([x.reshape(-1) for x in rr.launch_segmin_kernel(so8, sk8, oct8, 17)])
        scratch8 = rr._SegminScratch(-(-n8 // rr.SEGMIN_TILE), dev)
    c5t = ot.OceanConfig(resolution=4096, domain_size=2000.0, fft_impl="pallas",
                         matmul_precision="high")
    c5 = dataclasses.replace(c5t, matmul_precision="highest")
    st5 = ot.ocean_state_from_phillips(c5, ot.PhillipsConfig(),
                                       generator=torch.Generator().manual_seed(0), device=dev)
    in5 = fs.hoist_fourstep(st5.h0, st5.omega, c5)
    ts1 = torch.zeros(1, device=dev)
    want2 = fs.launch_fourstep_row(in5, ts1, c5)
    wide = {}  # K2t's Y at 16384^2 "bf16x3" from the repository's kernel
    tiered = {}  # the tier's config, K2t's Y, K3t's planes, row and column tables
    for tier in ("high", "default"):
        ct = dataclasses.replace(c5t, matmul_precision=tier)
        yt = fs.launch_fourstep_row(in5, ts1, ct)
        tiered[tier] = (ct, yt, fs.launch_fourstep_col(yt, in5.twiddle, ct, checksum=False)[0],
                        fs._tier_inputs(4096, ct, dev, "row"),
                        fs._tier_inputs(4096, ct, dev, "col"))
    c1 = ot.OceanConfig(resolution=512, fft_impl="pallas", matmul_precision="highest")
    st1 = ot.ocean_state_from_phillips(c1, generator=torch.Generator().manual_seed(0), device=dev)
    in1 = fused_step.hoist_packed(st1.h0, st1.omega, c1)
    ts6 = torch.arange(6, dtype=torch.float32, device=dev) / 60.0
    want1, _ = fused_step.launch_packed_step(in1, ts6, c1, checksum=False)
    c1t = dataclasses.replace(c1, matmul_precision="bf16x3")
    slots1t = tfft.table_slots(("alt", 512, 1, 0, False), dev, "bf16x3")
    st3 = ot.ocean_state_from_phillips(dataclasses.replace(c1t, num_cascades=3),
                                       generator=torch.Generator().manual_seed(0), device=dev)
    in3 = fused_step.hoist_packed(st3.h0, st3.omega, c1t)
    want3, _ = fs.launch_fourstep_col(want2, in5.twiddle, c5, checksum=False)
    c4 = ot.OceanConfig(resolution=512, fft_impl="pallas", hermitian_pack=False,
                        matmul_precision="highest")
    in4 = us.hoist_unpacked(st1.h0, st1.omega, c4)
    want4 = us.launch_unpacked_step(in4, ts6, c4)

    for rep in range(REPEATS):
        for name, lib, ptxas in built:
            c5t, want2t, want3t, tier_row, tier_col = tiered[
                "default" if "_default" in name else "high"]
            if name.startswith("k3t"):
                scratch = torch.empty_like(want2t)
                out = torch.empty_like(want3t)
                partials = torch.empty((1, 128 * 128 + 4096 // fs.CHECKSUM_ROWS), device=dev)

                def call():
                    err = lib.fourstep_col(
                        want2t.data_ptr(), scratch.data_ptr(), in5.twiddle.data_ptr(), 1, 4096,
                        4096, -1.0, out.data_ptr(), partials.data_ptr(), fs.CHECKSUM_ROWS,
                        float(c5t.normal_height_scale), 1, *tier_col, stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                want, names, calls = want3t, smoke.K3T_KERNELS, 20
            elif name.startswith("k2tw"):
                n, cfg, inputs, _ = split[16384]
                cw = dataclasses.replace(cfg, matmul_precision="bf16x3")
                tier_w = fs._tier_inputs(n, cw, dev, "row")
                if "k2tw" not in wide:
                    wide["k2tw"] = fs.launch_fourstep_row(inputs, ts1, cw)
                want = wide["k2tw"]
                out = torch.empty_like(want)
                scratch = torch.empty_like(want)

                def call(inputs=inputs, tier_w=tier_w, n=n, cfg=cfg):
                    err = lib.fourstep_row(
                        inputs.h0.data_ptr(), inputs.omega.data_ptr(), inputs.twiddle.data_ptr(),
                        ts1.data_ptr(), 1, n, n, 0, _f32(np.pi / cfg.domain_size), 0, 0,
                        out.data_ptr(), *tier_w, scratch.data_ptr(), stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                names, calls = smoke.K2T_KERNELS, 3
            elif name.startswith("k2t"):
                out = torch.empty_like(want2t)
                scratch = torch.empty_like(want2t)
                if name == "k2t_scratch":  # stage 2 from the scratch reads W2's planes
                    tier_row = (*tier_row[:2], tfft.table_wgmma(
                        ("dft", 32, 1), dev, fs.kernel_tier(c5t.matmul_precision), 16).data_ptr(),
                        *tier_row[3:])

                def call(tier_row=tier_row):
                    err = lib.fourstep_row(
                        in5.h0.data_ptr(), in5.omega.data_ptr(), in5.twiddle.data_ptr(),
                        ts1.data_ptr(), 1, 4096, 4096, 0, _f32(np.pi / c5t.domain_size), 0, 0,
                        out.data_ptr(), *tier_row, scratch.data_ptr(), stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                want, calls = want2t, 20
                names = smoke.K2T_KERNELS if name == "k2t_scratch" else smoke.K2T_KERNELS[:1]
            elif name.startswith("k1t"):
                tb = K1T_FRAMES.get(name, 6)
                cas = in3 if name.endswith("_cascades") else in1
                casc = cas.omega.shape[0] if cas.omega.ndim == 3 else 1
                want = fused_step.launch_packed_step(cas, ts6[:tb], c1t, checksum=False)[0]
                y = torch.empty((casc, tb, 2, 2, 2, 512, 512), device=dev)
                out = torch.empty_like(want)
                partials = torch.empty((casc, tb, 512 // fused_step.CHECKSUM_ROWS), device=dev)

                def call(tb=tb, cas=cas, casc=casc, y=y, out=out, partials=partials):
                    err = lib.packed_step(
                        cas.h0.data_ptr(), cas.omega.data_ptr(), cas.twiddle.data_ptr(),
                        ts6.data_ptr(), tb, casc, 512, _f32(np.pi / c1t.domain_size), 0, 0, -0.5,
                        y.data_ptr(), out.data_ptr(), partials.data_ptr(),
                        fused_step.CHECKSUM_ROWS, float(c1t.normal_height_scale), 1, 3,
                        slots1t.data_ptr(), stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                names, calls = smoke.K1T_KERNELS, 50
            elif name.startswith("k4t"):
                c4t = dataclasses.replace(c4, matmul_precision="default" if "_default" in name
                                          else "bf16x3")
                tier4t = tfft.kernel_tier(c4t.matmul_precision)
                passes4t = tfft.kernel_passes(tier4t)
                slots4t = tfft.table_slots(("alt", 512, 1, 0, False), dev, tier4t)
                want = us.launch_unpacked_step(in4, ts6, c4t)
                y = torch.empty((6 * (2 if passes4t == 3 else 1), 3, 2, 512, 512), device=dev)
                out = torch.empty_like(want)
                partials = torch.empty((6, 512 // fs.CHECKSUM_ROWS), device=dev)

                def call(y=y, out=out, partials=partials, passes4t=passes4t, slots4t=slots4t,
                         c4t=c4t):
                    err = lib.unpacked_step(
                        in4.h0.data_ptr(), in4.omega.data_ptr(), in4.twiddle.data_ptr(),
                        ts6.data_ptr(), 6, 512, _f32(np.pi / c4t.domain_size), 0, 0, -1.0,
                        y.data_ptr(), out.data_ptr(), partials.data_ptr(), fs.CHECKSUM_ROWS,
                        float(c4t.normal_height_scale), 1, passes4t, slots4t.data_ptr(),
                        stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                names, calls = smoke.K4T_KERNELS, 50
            elif name.startswith("k3"):
                scratch = torch.empty_like(want2)
                out = torch.empty_like(want3)
                # room for the partials of either band width
                partials = torch.empty((1, 32 * 128 + 4096 // fs.CHECKSUM_ROWS), device=dev)

                def call():
                    err = lib.fourstep_col(
                        want2.data_ptr(), scratch.data_ptr(), in5.twiddle.data_ptr(), 1, 4096,
                        4096, -1.0, out.data_ptr(), partials.data_ptr(), fs.CHECKSUM_ROWS,
                        float(c5.normal_height_scale), 1, *NO_TIER, stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                want, names, calls = want3, smoke.K3_KERNELS, 20
            elif name.startswith("k4"):
                y = torch.empty((6, 3, 2, 512, 512), device=dev)
                out = torch.empty_like(want4)
                partials = torch.empty((6, 512 // fs.CHECKSUM_ROWS), device=dev)

                def call():
                    err = lib.unpacked_step(
                        in4.h0.data_ptr(), in4.omega.data_ptr(), in4.twiddle.data_ptr(),
                        ts6.data_ptr(), 6, 512, _f32(np.pi / c4.domain_size), 0, 0, -1.0,
                        y.data_ptr(), out.data_ptr(), partials.data_ptr(), fs.CHECKSUM_ROWS,
                        float(c4.normal_height_scale), 1, 0, None, stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                want, names, calls = want4, smoke.K4_CHECKSUM_KERNELS, 50
            elif name.startswith("k8"):
                mins8 = torch.empty((8, n8), dtype=torch.int32, device=dev)
                skey8 = torch.empty((n8,), dtype=torch.int32, device=dev)

                def call():
                    err = lib.segmin_stage(
                        so8.data_ptr(), sk8.data_ptr(), n8, 17, oct8, mins8.data_ptr(),
                        skey8.data_ptr(), scratch8.ticket.data_ptr(), scratch8.flags.data_ptr(),
                        scratch8.agg.data_ptr(), scratch8.incl.data_ptr(), scratch8.next_epoch(),
                        stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                out = torch.cat([mins8.reshape(-1), skey8])
                want, names, calls = want8, smoke.K8_KERNELS, 50
            elif name.startswith("k2s"):
                n, cfg, inputs, want = split[8192 if name == "k2s_8192" else 16384]
                out = torch.empty_like(want)

                def call():
                    err = lib.fourstep_row(
                        inputs.h0.data_ptr(), inputs.omega.data_ptr(), inputs.twiddle.data_ptr(),
                        ts1.data_ptr(), 1, n, n, 0, _f32(np.pi / cfg.domain_size), 0, 0,
                        out.data_ptr(), *NO_TIER, None, stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                names = smoke.K2_KERNELS if n == 8192 else smoke.K2_SPLIT_KERNELS
                calls = 10
            elif name.startswith("k2"):
                out = torch.empty_like(want2)

                def call():
                    err = lib.fourstep_row(
                        in5.h0.data_ptr(), in5.omega.data_ptr(), in5.twiddle.data_ptr(),
                        ts1.data_ptr(), 1, 4096, 4096, 0, _f32(np.pi / c5.domain_size), 0, 0,
                        out.data_ptr(), *NO_TIER, None, stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                want, names, calls = want2, smoke.K2_KERNELS, 20
            else:
                y = torch.empty((6, 2, 2, 512, 512), device=dev)
                out = torch.empty_like(want1)
                partials = torch.empty((6, 512 // fused_step.CHECKSUM_ROWS), device=dev)

                def call():
                    err = lib.packed_step(
                        in1.h0.data_ptr(), in1.omega.data_ptr(), in1.twiddle.data_ptr(),
                        ts6.data_ptr(), 6, 1, 512, _f32(np.pi / c1.domain_size), 0, 0, -0.5,
                        y.data_ptr(), out.data_ptr(), partials.data_ptr(),
                        fused_step.CHECKSUM_ROWS, float(c1.normal_height_scale), 1, 0, None,
                        stream())
                    if err:
                        smoke.fail(f"{name}: CUDA error {err}")

                want, names, calls = want1, smoke.K1_KERNELS, 50
            event = smoke.event_ms(call, calls)
            torch.cuda.synchronize()
            if name.startswith("k8"):
                out = torch.cat([mins8.reshape(-1), skey8])
            # large for loads_only and moves_only; K8: entries that differ
            rel = (float((out != want).sum()) if name.startswith("k8")
                   else float((out - want).abs().max() / want.abs().max()))
            frames = K1T_FRAMES.get(name, 6) if name.startswith("k1t") else None
            print(json.dumps(dict(repeat=rep, variant=name, ptxas=ptxas, event_ms=event,
                                  frames=frames,
                                  device_ms=smoke.kernel_device_ms(call, names, calls),
                                  rel_vs_repo=rel)), flush=True)


if __name__ == "__main__":
    main()
