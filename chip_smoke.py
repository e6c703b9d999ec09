#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gfx_ocean_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's five paths: the three step paths, gated against the
float64 golden model, the frame renderer, gated against a frame the JAX
package rendered, and cascades; then its entry points, the CLI and the
frame server, on those paths; then the single-device remainder: the
precision tiers of the matmul route, the window rasterizer, meshes other
than the grid and the native bincode loader; then multi-device runs
(``parallel/``) on meshes of the one card. It imports no jax.

- The 512^2 Hermitian-packed step (``OceanConfig(fft_impl="pallas")``)
  through kernel K1: its FFT body at ``matmul_precision="highest"``
  (phases 4-7) and its tiered body K1t, the JAX kernel's bf16 passes on the
  tensor cores, at the default "bf16x3" (``bench.py``'s headline), "bf16x4",
  "high" and "default" (phase 49); 600-frame checksum rollouts at
  time_batch 6.
- The 4096^2 four-step step, config 5 of ``benchmarks/run_all.py``
  (``resolution=4096, domain_size=2000.0, fft_impl="pallas",
  matmul_precision="high"``), through kernels K2 + K3: their FFT bodies at
  "highest" (phases 8-13) and their tiered bodies K2t + K3t at config 5's
  "high" and the other tiers (phase 50); 120-frame checksum rollouts.
- The interactive frame renderer at the reference's 1200x700 window
  (``make_frame_renderer(OceanConfig(fft_impl="pallas"), 1200, 700)``,
  mesh 128 x 4, 512^2 state from numpy noise of seed 0, default camera)
  through kernels K1, K7, K8 and K9.
- The unpacked 512^2 step, the accuracy tier (``OceanConfig(fft_impl=
  "pallas", hermitian_pack=False)``) on phase 3's state: through kernel K4
  (its tiered body K4t at ``matmul_precision="bf16x3"`` and "default",
  phase 52; its FFT body at "highest", alone at 512^2 and on the route at
  256^2) and through K5 + K6 at "highest", 600-frame checksum rollouts at
  time_batch 6.
- The 16384^2 four-step step, the four-step plan's largest grid
  (``OceanConfig(resolution=16384, fft_impl="pallas")``), through K2 (a
  row split in registers into two 8192-point halves, one a block of a
  two-block cluster) and K3 at "highest", a 24-frame checksum rollout at
  time_batch 1; K2t there at the tiers (phase 51).
- Cascades, config 4 of ``benchmarks/run_all.py`` (``OceanConfig(
  resolution=512, num_cascades=3, compute_foam=True)``, here on "pallas"):
  three 512^2 cascades with foam through K1's cascade axis, a 200-frame
  checksum rollout at time_batch 1 and the composited 1200x700 frame
  through K1, K7 and K8.

Phases, one line each:

1. device: nvidia-smi name and power limit, torch's device name;
2. build: nvcc builds every library of ``gfx_ocean_tpu_torch/csrc`` at
   once, with the ptxas lines (registers, spills) of each;
3. state: the 512^2 state from the shipped bins, else synthesized from a
   torch.Generator seeded 0;
4. kernel vs plain: K1 (the FFT body, "highest") against its plain
   PyTorch version on the card;
5. golden: the step's fields against the float64 golden model;
6. time: one K1 call against one plain call and torch.fft.ifft2 of the
   same spectra (CUDA events), and K1's own device time a call
   (``device_ms``: torch.profiler, the kernels' launches only);
7. rollout: make_rollout through K1 (launch count, finite checksums,
   steps/s) and the same rollout through the plain version;
8. fourstep_state: the 4096^2 state synthesized from a torch.Generator
   seeded 0 (the shipped bins are 512^2 only);
9. fourstep_kernel_vs_plain: K2 alone, K3 alone (fed K2's Y) and both
   chained (the FFT bodies, "highest") against the plain version, planes
   and checksums, at 1024^2 and
   4096^2 over the six frames of T_COMPARE and at 8192^2 over two;
10. fourstep_golden: the 4096^2 step at t = 11.25 against the golden model;
11. fourstep_time_one_call: K2, K3 and the whole step at tb 1 and 4 against
    the plain version, and at tb 1 torch.fft along x, y and both (CUDA
    events) and K2's and K3's own device time (``k2_device_ms``,
    ``k3_device_ms`` by stage, torch.profiler);
12. fourstep_rollout: make_rollout(keep_fields=False) at tb 1 and 4 through
    the kernels (launch counts, finite checksums that agree with the plain
    rollout, steps/s) and through the plain version;
13. fourstep_profile: torch.profiler's device time by kernel over a rollout;
14. render_kernel_vs_plain: K7 and K8 on the real inputs of the 1200x700
    frame at the default camera and at a low camera whose giant pass has
    active groups, and K8 on 735,784 synthetic entries with runs that span
    tiles: bit-equal to their plain versions;
14b. render_giant_vs_plain: K9 on the giant passes of those two frames,
    and of the default camera's with its 512 highest-scored triangles all
    active: bit-equal to its plain version;
15. render_frame: the fused 1200x700 renderer through K1 + K7 + K8 + K9
    against the same pipeline with K7, K8 and K9's plain versions
    (bit-equal uint8 frames), the giant-pass tripwire, the pool overflow,
    the coverage, and a 4-band stack bit-equal to the full frame through
    the kernels;
16. render_vs_jax: the frame against the stored JAX frame
    (``gfx_ocean_tpu_torch/golden/frame_jax_1200x700.npz``);
17. render_time: one frame through the kernels and through the plain
    versions, K7, K8 and K9 alone against theirs and K8 against one
    scatter_reduce("amin") (CUDA events), K7's, K8's and K9's own device
    time (``k7_device_ms``, ``k8_device_ms``, ``k9_device_ms``, K9's also
    at 512 candidates; torch.profiler), 60 frames of the main path by wall
    clock with every launch count (K9 once on each recorded frame with an
    active giant group), and torch.profiler's top device ops of a frame;
18. unpacked_kernel_vs_plain: K4, K5 alone, K6 alone (fed K5's Y) and
    K5 + K6 chained against the plain version, planes and the checksum
    kernel's partial sums behind K4 and behind K6, at 64^2, 256^2 and 512^2
    over the six frames of T_COMPARE, with the default flags and with
    conj_neg;
19. unpacked_golden: 512^2 at t = 11.25 through K4 and through K5 + K6
    against the golden model (rel and abs L-inf);
20. unpacked_time_one_call: a 6-frame call of K4 (its FFT body, at
    "highest"), K5, K6, of the checksums through K4 and their plain versions, and torch.fft of the same three
    spectra (CUDA events); the kernels' own device time (``k4_device_ms``,
    ``k5_device_ms``, ``k6_device_ms``, torch.profiler);
21. unpacked_rollout: make_rollout(keep_fields=False, time_batch=6) over
    600 frames for both routes through the kernels (the single route at
    "bf16x3", K4t; the blocked route; and K4's FFT body on the single route
    at 256^2 "highest", K4's main path) (launch counts, finite
    checksums that agree with the plain rollout, steps/s, torch.profiler's
    device time) and through the plain version;
22. big_state: the 16384^2 state synthesized from a torch.Generator seeded
    0 (on the host, then moved to the card);
23. big_kernel_vs_plain: one frame of K2 and of K3 on the whole grid; K2's
    Y on two 16-row bands and K3's planes on two 128-column bands against
    the plain version on those bands (the whole grid's plain version needs
    tens of GB), a banded K2 launch bit-equal to the whole pass's rows,
    and K3's checksum partials against the sums of its own planes;
24. big_golden: make_step at t = 11.25 (one launch of K2 and of K3) against
    the float64 golden model on the two row bands, computed on the card
    (``golden/reference.golden_fields_rows``);
25. big_time_one_call: K2, K3 and the step at tb 1 (CUDA events), K2's and
    K3's own device time (torch.profiler), the plain K2 over the whole
    grid in 1024-row bands, and torch.fft along x, y and both;
26. big_rollout: make_rollout(keep_fields=False, time_batch=1) over 24
    frames through the kernels (launch counts, finite checksums, steps/s);
27. cascade_state: three 512^2 cascades from one torch.Generator seeded 0
    (cascade c the c-th draw at domains[c]; cascade 0 equals the
    single-cascade state);
28. cascade_kernel_vs_plain, cascade_time_one_call: K1's one launch for
    3 cascades x 6 frames against its plain version and bit-equal to three
    single-cascade launches, its checksums; a 3 x 6-frame call by CUDA
    events and torch.profiler beside the plain version and ifft2 of
    (18, 2, 512, 512);
29. cascade_golden: the step at t = 11.25, every cascade against the
    float64 golden model, foam per cascade;
30. cascade_rollout: the 200-frame foam rollout at time_batch 1 (5 repeats
    by CUDA events, their spread), checksums against the plain rollout;
31. cascade_routes: K2 + K3 (3 x 1024^2) and K4 (3 x 512^2) a cascade a
    call against their plain versions, with launch counts;
32. cascade_render: the composited 1200x700 frame with foam through
    make_frame_renderer: K7 and K8 bit-equal to their plain versions on its
    tables, the frame bit-equal through the plain versions and to
    _rasterize_pool, the giant-pass tripwire, its time and device time;
33. cascade_main_path: the rollout and 10 frames with every launch count;
34. cascade_query_checkpoint: sample_surface on the card against the CPU,
    and a checkpoint round trip on the card.
53. derived_kernel (after 34): K10, the derived stage of a foam rollout
    (``ops/derived.derived_checksums``), at ocean512_cascades.rollout's
    shapes, 3 cascades x 20 frames of K1t's 512^2 planes (phase 27's state):
    against its plain version, the eager chain on the card, in both layouts
    of the planes (K1's cascade-major and a frame-major stack): the foam
    texels of every (frame, cascade) equal, the checksums within
    TOL_CHECKSUM of their summands; a call by CUDA events and torch.profiler
    against its bound (``portbench/roofline_derived.py``) beside the plain
    version; a 200-frame rollout at time batch 20 with its launch counts.

35. cli: ``gfx_ocean_tpu_torch.cli.main`` in this process, with the
    kernels each subcommand launched: info, synth at 512^2 into
    ``build/smoke/cli``, simulate on those files through K1 (600 frames,
    checksums equal to make_rollout's), through K4 (--no-pack) and on
    "xla" (cuFFT, within 5e-5 of K1's), simulate --checkpoint then query
    --resume, bench at 512^2 (tb 6, 600 frames; on "pallas" between two
    direct rollouts of the same state, and on "xla", which must launch no
    kernel, with its device profile) and at config 5 (tb 4, 120 frames)
    beside phases 7 and 12's direct rollouts, render at 1200x700
    (8 frames, bit-equal to make_batch_renderer), and ``python -m
    gfx_ocean_tpu_torch info`` without --device in a subprocess;
36. serve: ``serve(state, OceanConfig(fft_impl="pallas"), port=0)`` on phase
    3's state in a thread: /health, /config, /metrics, /frame at t = 11.25
    under phase 5's golden gate, /frame.png at 1200x700 bit-equal to
    make_frame_renderer (one launch of K1, K7, K8), the 960x540 strip of 4
    frames bit-equal to make_batch_renderer, /frame.png's latency over 20
    requests (median and p90 of wall, render, PNG encode and HTTP), and 8
    threads x 4 frames at distinct t each equal to its frame served alone;
    any status but 200 fails;
38. precision_tiers: the JAX package's default configuration
    ``OceanConfig()`` (512^2, "matmul", unpacked) on phase 3's state at
    each tier ("bf16x3", "bf16x4", "high", "highest", "default"): rel and
    abs L-inf against golden beside the JAX package's ceiling and beside the
    same scheme computed exactly on the host (``scheme_rel``), which the
    card's error must match within the float32 sums' band either way,
    ``effective_precision``, a 6-frame call (CUDA events) and a 120-frame
    rollout at tb 6 beside "highest"; choppy_precision="default" under
    "bf16x3"; "high", "default" and "highest" at config 5 (4096^2, phase 8's
    state, phase 10's golden), 8 frames each;
39. window_render: phase 17's 1200x700 frame through K1 and the window
    rasterizer (32^2 samples, no giant candidate dropped) against the pool
    frame of the same state (the near-tie envelope of
    tests/test_render.py:943-978 scaled to the frame) and the stored JAX
    frame; render_frames(impl="window") equal to render_frame; ms a frame
    beside the pool frame's;
40. generic_mesh: the standard grid as a plain triangle list
    (``grid_shape=None``) bit-equal to the grid path on both rasterizers;
41. native_loader: the native bincode loader (g++, built in phase 2) on
    files of phase 8's state: bit-equal to the numpy parser, MB/s of each,
    write_npy read back; the loaders must take the native parser.

42-48 (``run_parallel``): ``parallel/`` on meshes whose positions repeat
cuda:0, each phase with the launches of K1-K3, K7 and K8 it made:
42. parallel_fourstep: config 5 (phase 8's state) row-sharded over 1 x 4:
    K2 on each band's two windows, all_to_all, K3 on each column band,
    all_to_all back; planes bit-equal to the single-device K2 + K3, normals
    too, the golden gate on phase 10's golden (rel and abs L-inf), one
    frame's planes and each all_to_all by CUDA events, and the main path: a
    24-frame sharded checksum rollout (counts zeroed before it, K2 and K3
    4 a frame) against the single-device rollout at rtol 1e-4;
43. parallel_big_windows: K2 at 16384^2 (phase 23's state) on the last
    shard's 4096-row band from its windows, bit-equal to the whole-state K2
    on those rows;
44. parallel_render: phase 17's 1200x700 frame over 4 bands (giants 512),
    bit-equal to make_frame_renderer with no giant candidate dropped in any
    band (the main path of the frame: K1, K7, K8 once a band), its time;
45. parallel_batch_render: 4 frames over a 2 x 2 mesh against
    make_batch_renderer, at giants 512 and 1024: bit-equal on every frame
    whose single-device render drops no giant candidate (the renderer's
    contract), and no frame drops at 1024;
46. parallel_default_config: ``OceanConfig()`` at 512^2 on a 2 x 4 mesh
    (phase 3's state tiled over "batch", as the CLI's --mesh does) under
    both fft names, checksums against the single-device rollout;
47. parallel_cli: ``simulate --mesh 1,1`` and ``render --mesh 1,1``, and
    ``--mesh 1,2``: it exits with the JAX CLI's message on one card, runs
    on two;
48. parallel_serve: ``serve(mesh=make_mesh([cuda:0] * 4, row=4))``:
    ``/frame.png`` bytes equal the unsharded server's.

49-51 (run before 42-48, which free the states they read): the tiered
bodies K1t, K2t, K3t, each against its plain version at the tier (the
same bf16 products, ``ops/fft.matmul_tier``) and against golden beside its
exact scheme (``exact_products``: the plain version with float64 sums over
the same bf16 operands), held by FP32_SUM_ALLOWANCE (+ DEFAULT_REROUND at
"default") and by the golden gate (DEFAULT_GATE at "default"); "bf16x4"
and "high" bit-equal to "bf16x3"; ms by CUDA events, ``device_ms`` by
torch.profiler, the plain version's ms and the matmul route's at the same
tier (cuBLAS bf16 passes, the library yardstick); the main path's launches
with the counts at 0 just before it:
49. tier_k1: K1t at 512^2 on phase 3's state, a 6-frame call, one cascade
    and three (bit-equal to three single launches), the 600-frame rollout
    at tb 6 at "bf16x3" and "default" beside "highest" in the same call, and
    the headline rollout ("bf16x3") as K1t's main path;
50. tier_fourstep: K2t alone, K3t alone (fed K2t's Y) and chained, with
    the checksums, at 1024^2 and config 5 (phase 8's state, phase 10's
    golden); a one-frame call of K2t, K3t and the step at config 5, the
    120-frame rollouts at "high" and "default" beside "highest", and config
    5's rollout at "high" as K2t's and K3t's main path;
51. tier_big: K2t at 16384^2 (phase 22's state): the whole frame, phase
    23's two 16-row bands against the plain version and bit-equal to the
    frame's rows, "high" and "bf16x4" bit-equal to "bf16x3", one call's
    time beside the FFT body's and the matmul route's row passes, its
    bound; K3t on the whole frame's Y at "bf16x3" (ms, device ms, bound,
    the matmul route's column passes); the step through K2t + K3t on those
    bands against phase 24's golden rows under the gate (its exact scheme
    would need the plain K3 of the whole frame).
52. tier_k4 (after 51): K4t, K4's tiered body (the unpacked route,
    ``hermitian_pack=False``, at every tier but "highest"), at 512^2 on
    phase 3's state: a 6-frame call against its plain version with the
    checksums, against golden beside its exact scheme, "high" and "bf16x4"
    bit-equal to "bf16x3"; at 256^2 "highest" launching K4's FFT body and
    "bf16x3" K4t; the 600-frame rollouts at tb 6 at "bf16x3" and "default"
    beside "highest" (K5 + K6); the matmul route's unpacked step at the
    tier as the library yardstick; the "bf16x3" rollout as K4t's main path.

Then one JSON line with the kernels K1-K10, K2 at 16384^2 and K1t-K4t
(times, bounds from this run's shapes, library yardsticks, ``device_ms``;
K1t's entry carries config 4's cascade call, which runs K1t at
"bf16x3", as ``cascade_*``, the tiered bodies' their "default" tier's
under ``default_tier``), and as
the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with no
result; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

N = 512
STEPS = 600
TIME_BATCH = 6
REPEATS = 5
T_CHECK = 11.25
# Frame times of the kernel-vs-plain check: one time batch, from t = 0 to
# an hour, so the Dekker phase is exercised far from the origin.
T_COMPARE = (T_CHECK, 0.0, 1.0 / 60.0, 100.5, 1000.25, 3599.0)
# Kernel vs plain version, |diff| / max |field|. Both are FP32; they differ
# in the transform (FFT against dense matmul) and so in summation
# order, which costs a few float32 ulps of the field's scale.
TOL_KERNEL = 1e-5
# Checksums of kernel vs plain, |diff| / sum of |summands|: the checksum of
# a frame nearly cancels, so its own relative error says nothing.
TOL_CHECKSUM = 1e-5
# Relative L-inf against the float64 golden model (bench.py's gate).
GOLDEN_GATE = 1e-4
TIMING_CALLS = 50

# The four-step path (K2 + K3): config 5 of benchmarks/run_all.py.
FS_N = 4096
# (grid, frames) of the kernel-vs-plain check: T_COMPARE's first frames.
FS_COMPARE = ((1024, len(T_COMPARE)), (FS_N, len(T_COMPARE)), (8192, 2))
FS_STEPS = 120
FS_REPEATS = 3
FS_TIME_BATCHES = (1, 4)
FS_TIMING_CALLS = 20
FS_PLAIN_TIMING_CALLS = 5
FS_PROFILE_STEPS = 8

# The frame renderer: the reference's window, the 512^2 state from numpy
# noise of seed 0 (as the stored JAX frame was made), t = 11.25 s.
R_W, R_H, R_N, R_SEED, R_T = 1200, 700, 512, 0, 11.25
R_GIANTS = 512
# A camera just above the water whose giant pass has active groups.
R_LOW = ((127.0, 2.5, 200.0), (0.0, 0.0, 0.0))
R_BANDS = 4
R_FRAMES = 60
R_TIMING_CALLS = 10
R_PLAIN_TIMING_CALLS = 3
R_KERNEL_CALLS = 50
R_PROFILE_FRAMES = 3
# K8 at the resolve size of the 1200x700 frame (pool 630,784 + 105,000 octs)
# with one run of 30,000 entries, ~30 of the kernel's 1024-entry tiles.
K8_N, K8_N_OCT, K8_LONG_RUN = 735_784, 105_000, 30_000
# The stored JAX frame's envelope (tests/test_render.py:259-264): quantized-z
# near-ties flip a sliver of silhouette pixels between implementations.
JAX_FRAME_PIXELS_OFF = 1e-3
JAX_FRAME_MEAN_COLOR = 0.5

# The unpacked step (K4, K5 + K6): phase 3's 512^2 state, OceanConfig(
# fft_impl="pallas", hermitian_pack=False) at "bf16x3" (the single route,
# K4) and at "highest" (the blocked route, K5 + K6); the kernel-vs-plain
# check also at the central 64^2 and 256^2 crops of that state.
U_COMPARE = (64, 256, 512)
# The grid of K4's FFT body's rollout: "highest" takes K4 up to 256^2.
U_FFT_ROUTE_N = 256
U_TIMING_CALLS = 50
U_PLAIN_TIMING_CALLS = 10
U_PROFILE_STEPS = 60

# The card's published peaks (H100 SXM data sheet, dense, 700 W): a
# kernel's bound is max(bytes / HBM rate, operations / FP32 rate), with
# each input read once and each output written once. The inputs of a step
# kernel are the state's (h0, omega), the twiddles and the times, which is
# what the step kernels read. Integer work counts at the FP32 rate of the
# CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations a pixel of K7 (pixel center 8, 3 edge functions 12, the
# denominator 2, w and z 11, tests 7), counted from csrc/raster.cu.
K7_OPS_PER_PIXEL = 40
# Operations an entry and key of K8: unpack, compare, select, min.
K8_OPS_PER_KEY = 4
# Operations a pixel and candidate of K9 (three edge functions 12, the
# denominator 2, w and z 11, the key 5, tests 10), counted from csrc/raster.cu.
K9_OPS_PER_PIXEL_CANDIDATE = 40

# The 16384^2 four-step path: K2 split over a two-block cluster a row, K3.
BIG_N = 16384
BIG_ROW_BANDS = (BIG_N // 2 - 3, BIG_N - 16)  # first rows of the 16-row bands
BIG_BAND_ROWS = 16
BIG_COL_BANDS = (4096 + 32, BIG_N - 128)      # first columns of the 128-column bands
BIG_BAND_COLS = 128
BIG_PLAIN_ROWS = 1024  # rows a band of the plain K2 over the whole grid
BIG_STEPS = 24
BIG_REPEATS = 2
BIG_TIMING_CALLS = 10

# Cascades: config 4 of benchmarks/run_all.py:180-195, three 512^2 cascades
# at the default ladder of domains (1000, 250, 62.5) with foam, on "pallas"
# (K1's cascade axis; the benchmark's config runs the default "matmul"), a
# Phillips state from torch.Generator seed 0, the benchmark's 200-frame
# checksum rollout at time batch 1.
C_CASCADES = 3
C_STEPS = 200
C_REPEATS = 5
C_FS_N = 1024          # the four-step route, one cascade a call
C_FRAMES = 10          # frames of the main path's run with its launch counts
C_QUERY_POINTS = 4096
# sample_surface on the card against the CPU: tests/test_torch_query.py's
# bounds (float32 heights to 2e-5, world x / z to 6e-5, normals to 1e-4).
C_QUERY_TOL = dict(height=2e-5, base_xz=6e-5, residual=6e-5, normal=1e-4)

# Phase 53: K10 at the cell ocean512_cascades.rollout's time batch; calls
# timed by CUDA events and torch.profiler.
D_TIME_BATCH = 20
D_CALLS = 50
D_PLAIN_CALLS = 3

# Phases 35-36: the entry points. The CLI at 512^2 on synth's files (a
# Phillips state from torch.Generator seed 0, the state phase 3 builds where
# the shipped bins are absent) and at config 5; the server on phase 3's state.
CLI_STEPS = 600           # the CLI's default --steps
CLI_CHECK_STEPS = 60      # the unpacked route and the checkpoint's rollout
CLI_RENDER_FRAMES = 8
CLI_XLA_TOL = 5e-5        # "xla" (cuFFT) against K1's checksums, relative
CLI_QUERY_POINTS = ("10.5,20", "100,30.25", "300,-7", "480.5,250")
S_LATENCY_REQUESTS = 20
S_THREADS, S_PER_THREAD = 8, 4
S_STRIP_W, S_STRIP_H, S_STRIP_N = 960, 540, 4
# The direct rollouts of phases 7 and 12, by (N, time batch), for phase 35.
DIRECT_ROLLOUTS: dict = {}
# States phases 38-39 reuse: phase 3's 512^2 state ("main"), phase 8's
# 4096^2 state with phase 10's golden ("fourstep", "fourstep_golden"), and
# phase 17's frame state ("render").
STATES: dict = {}

# Phase 38: the precision tiers of the matmul route on the JAX package's
# default configuration, OceanConfig() (512^2, fft_impl="matmul", unpacked).
TIERS = ("bf16x3", "bf16x4", "high", "highest", "default")
# The JAX package's relative L-inf figures for each tier at 512^2
# (gfx_ocean_tpu/config.py:88-96, measured on a TPU on the shipped bins):
# error ceilings only, never speed.
TIER_CEILING = {"bf16x3": 8e-6, "bf16x4": 6e-6, "high": 2.8e-5, "highest": 1e-6,
                "default": 2.6e-3}
# FP32 sums of 512 products (a DFT pass) on the tensor cores, relative to
# the field's scale: how far the card's sums may move the error from the
# scheme's own, either way.
# The tensor cores accumulate less exactly than IEEE FP32 (1.27x the error
# of the CUDA cores' sums on a random 512-term bf16 product:
# tools/torch_precision_probe.py), so 1.5x the 1e-6 of IEEE sums. One bf16 pass ("default") rounds the row
# pass's FP32 output to bf16 again, where a sum-order difference can move a
# value by a bf16 ulp: its field's largest error may move by a percent of
# itself.
FP32_SUM_ALLOWANCE = 1.5e-6
DEFAULT_REROUND = 0.01
# One bf16 pass: its bound at 4096^2, and the whole 512^2 field at "default".
DEFAULT_GATE = 1e-2
TIER_CALLS = 20
TIER_STEPS = 120
TIER_BIG_FRAMES = 8
# Phases 49-51: the tiered bodies of K1, K2 and K3 (K1t, K2t, K3t), the JAX
# kernels' bf16 passes on the tensor cores. K1t at 512^2 (phase 3's state),
# K2t + K3t at 1024^2 and config 5, K2t at 16384^2 (phase 22's state). Their
# bound takes the card's dense bf16 rate.
TIER_K1 = ("bf16x3", "bf16x4", "high", "default")
TIER_BIG_LIBRARY_CALLS = 2
TIER_FOURSTEP = ("high", "bf16x3", "bf16x4", "default")
BF16_OPS_PER_S = 989e12
# Kernel against plain at a tiered body: the same bf16 products, FP32 sums
# in another order; a stage's FP32 output split again as the next stage's
# operand (K1's row pass, K2's and K3's stage 1, Y between K2 and K3) now and
# then moves by a bf16 ulp of its lo at the split tiers, of itself at
# "default" (tests/test_torch_kernels.py's TOL_BODY).
TOL_TIERED = {"bf16x3": 2.5e-5, "default": 4e-3}
TOL_TIERED_CHECKSUM = {"bf16x3": TOL_CHECKSUM, "default": 1e-3}
# Phase 39: the window rasterizer at phase 17's frame. 32^2 samples leave
# 145 giant candidates at the default camera (counted on the CPU), under
# R_GIANTS; the pool/window envelope of tests/test_render.py:943-978
# (64 differing pixels, 8 one-sided flips at 800x448) scaled to 1200x700.
W_SAMPLES = 32
W_DIFF_LIMIT = 64 * (R_W * R_H) // (800 * 448)
W_ONE_SIDED_LIMIT = 8 * (R_W * R_H) // (800 * 448)
W_TIMING_CALLS = 5
# Phase 40: the standard grid as a triangle list at a small viewport.
G_W, G_H = 320, 180
# Phase 41: the native loader on files of phase 8's 4096^2 state.
NATIVE_REPEATS = 3
# Phases 42-48: parallel/ on meshes of cuda:0. Config 5 over 1 x 4 rows.
P_ROWS = 4
P_STEPS = 24
P_REPEATS = 3
P_CALLS = 10
P_RENDER_CALLS = 3
P_FRAMES = 4
# Sharded checksums against the single-device ones: sums of every band's
# partial in another order (tests/test_parallel.py's rtol).
P_CHECKSUM_RTOL = 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(label: str, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fft_ops(n: int, transforms: int) -> float:
    """Operations of ``transforms`` complex n-point FFTs, 5 n log2 n each."""
    return 5.0 * n * math.log2(n) * transforms


def bound(n_bytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over their rate (FP32, or the tensor cores' dense bf16 for
    the tiered bodies), whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def kernel_tol(tier: str) -> float:
    """Kernel against plain: TOL_KERNEL for the FFT bodies ("highest"), the
    tiered bodies' TOL_TIERED otherwise."""
    from gfx_ocean_tpu_torch.ops.fft import kernel_tier

    t = kernel_tier(tier)
    return TOL_KERNEL if t == "highest" else TOL_TIERED[t]


def checksum_tol(tier: str) -> float:
    from gfx_ocean_tpu_torch.ops.fft import kernel_tier

    t = kernel_tier(tier)
    return TOL_CHECKSUM if t == "highest" else TOL_TIERED_CHECKSUM[t]


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


# The kernels' own launches in torch.profiler (substrings of their symbols):
# K1's two passes and its checksum, K2's row pass, K3's two stages and its
# checksum, K4 (and the checksum behind it), K5, K6.
K1_KERNELS = ("packed_row_pass", "packed_col_pass", "checksum_partials")
K2_KERNELS = ("fourstep_row_pass",)
K3_KERNELS = ("fourstep_col_stage1", "fourstep_col_stage2", "checksum_partials")
K4_KERNELS = ("unpacked_fused",)
K4_CHECKSUM_KERNELS = ("unpacked_fused", "checksum_partials")
K5_KERNELS = ("unpacked_row_pass",)
K6_KERNELS = ("unpacked_col_pass",)
K2_SPLIT_KERNELS = ("fourstep_row_pass_split",)
K7_KERNELS = ("slot_kernel",)
K8_KERNELS = ("segmin_lookback",)
K9_KERNELS = ("giant_kernel",)
K1T_KERNELS = ("packed_spectra_tier", "packed_row_tier", "packed_col_tier", "checksum_partials")
# K2t's stage 2 runs inside fourstep_row_tier1 at N <= 4096; fourstep_tier2
# is the stage 2 from the scratch (K2t at N >= 8192, K3t at every N).
K2T_KERNELS = ("fourstep_row_tier1", "fourstep_tier2")
K3T_KERNELS = ("fourstep_col_tier1", "fourstep_tier2", "checksum_partials")
K4T_KERNELS = ("unpacked_spectra_tier", "unpacked_row_wgmma", "unpacked_col_wgmma",
               "checksum_partials")
K10_KERNELS = ("derived_partials",)


def body_kernels(tier: str, fft_names, tiered_names):
    """The kernels a launch at ``tier`` runs: the FFT body's at "highest",
    the tiered body's otherwise."""
    from gfx_ocean_tpu_torch.ops.fft import kernel_tier

    return fft_names if kernel_tier(tier) == "highest" else tiered_names


def k2t_kernels(n: int) -> tuple:
    """K2t's kernels at n: stage 1 alone where it runs stage 2 in the block."""
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs

    return K2T_KERNELS[:1] if fs.row_stage2_in_block(n) else K2T_KERNELS


def kernel_device_ms(fn, names, calls: int) -> dict:
    """torch.profiler's device time of one call of ``fn``: the mean time of
    a launch of each kernel named in ``names`` (each launched once a call),
    and their sum under "total", over ``calls`` calls in one
    ``profile_kernels`` window. The kernels' time without the wrapper's host
    work. A mean over the launches the profiler recorded, since it can drop
    a record."""
    from gfx_ocean_tpu_torch.utils.profiling import profile_kernels

    seen = profile_kernels(fn, calls, names)
    if seen is None:
        fail(f"torch.profiler saw none or not all of {names}")
    return per_launch_ms(seen[0], names)


def per_launch_ms(kernels: dict, names) -> dict:
    """The mean ms a launch of each kernel of ``profile_kernels``' record
    whose name holds one of ``names``, and their sum under "total"."""
    ms = {name: total / count for name in names
          for key, (total, count) in kernels.items() if name in key}
    return {**ms, "total": sum(ms.values())}


def k1_device_ms(state, cfg, ts, calls: int) -> dict:
    """K1's device ms a ``packed_checksums`` call of the frames ts; reaches
    the kernels only through ``hoist_packed`` and ``packed_checksums``."""
    from gfx_ocean_tpu_torch.ops import fused_step

    inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
    return kernel_device_ms(lambda: fused_step.packed_checksums(inputs, ts, cfg), K1_KERNELS,
                            calls)


def k2_device_ms(state, cfg, ts, calls: int) -> dict:
    """K2's device ms a ``launch_fourstep_row`` call of the frames ts;
    reaches the kernel only through ``hoist_fourstep`` and
    ``launch_fourstep_row``."""
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs

    inputs = fs.hoist_fourstep(state.h0, state.omega, cfg)
    return kernel_device_ms(lambda: fs.launch_fourstep_row(inputs, ts, cfg), K2_KERNELS, calls)


def k3_device_ms(state, cfg, ts, calls: int) -> dict:
    """K3's device ms a ``launch_fourstep_col`` call with its checksum, by
    kernel (stage 1, stage 2, the normals' pass), on K2's Y of the frames
    ts."""
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs

    inputs = fs.hoist_fourstep(state.h0, state.omega, cfg)
    y = fs.launch_fourstep_row(inputs, ts, cfg)
    return kernel_device_ms(lambda: fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True),
                            K3_KERNELS, calls)


def k4_device_ms(state, cfg, ts, calls: int) -> dict:
    """K4's device ms a ``launch_unpacked_step`` call of the frames ts (cfg
    an unpacked config, ``hermitian_pack=False``)."""
    from gfx_ocean_tpu_torch.ops import unpacked_step as us

    inputs = us.hoist_unpacked(state.h0, state.omega, cfg)
    return kernel_device_ms(lambda: us.launch_unpacked_step(inputs, ts, cfg), K4_KERNELS, calls)


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
    build()
    k1 = run(dev, N)
    kernels_line = [k1]
    kernels_line += run_fourstep(dev)
    kernels_line += run_render(dev)
    kernels_line += run_unpacked(dev)
    kernels_line += run_big(dev)
    cascades = run_cascades(dev)  # config 4 at "bf16x3": K1's tiered body
    kernels_line.append(run_derived(dev))
    run_cli(dev)
    run_serve(dev)
    run_precision_tiers(dev)
    run_window_render(dev)
    run_generic_mesh(dev)
    run_native_loader()
    kernels_line.append(run_tier_k1(dev) | cascades)
    kernels_line += run_tier_fourstep(dev)
    run_tier_big(dev)
    kernels_line.append(run_tier_k4(dev))
    run_parallel(dev)
    print(json.dumps({"kernels": sorted(kernels_line, key=lambda k: k["name"])}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def build() -> None:
    """Phase 2: one nvcc for each library, all started together."""
    from gfx_ocean_tpu_torch import kernels

    t0 = time.perf_counter()
    libs = kernels.build_all(sorted(kernels.SIGNATURES))
    build_s = time.perf_counter() - t0
    for name in libs:
        kernels.load(name)
    t0 = time.perf_counter()
    native = kernels.build_host("ocean_native")
    STATES["native_build_seconds"] = time.perf_counter() - t0
    root = kernels.BUILD_DIR.parent.parent
    phase("build", seconds=build_s, native_library=str(native.relative_to(root)),
          native_seconds=STATES["native_build_seconds"], libraries={
        name: {"library": str(so.relative_to(root)),
               "ptxas": [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
                         if "registers" in ln or "bytes stack frame" in ln]}
        for name, so in libs.items()})


def main_state(dev, cfg):
    """Phase 3's state: the shipped bins where they are, else a Phillips
    state from a torch.Generator seeded 0. Returns (state, source)."""
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.assets.bincode import reference_data_dir

    data = reference_data_dir()
    if all(os.path.exists(os.path.join(data, f)) for f in ("spectrum.bin", "omega.bin")):
        return (ot.ocean_state_from_assets(resolution=cfg.resolution, device=dev),
                f"bincode files in {data}")
    return (ot.ocean_state_from_phillips(cfg, generator=torch.Generator().manual_seed(0),
                                         device=dev),
            "phillips synthesize, torch.Generator seed 0")


def run(dev, n: int) -> dict:
    """Phases 3-7 on ``dev`` at an n x n grid; returns K1's kernels entry."""
    import torch

    import numpy as np

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.golden.reference import golden_fields, golden_normals
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    # --- 3. state -----------------------------------------------------------
    # "highest": the FFT body of K1 (phase 49 holds the tiered body)
    cfg = ot.OceanConfig(resolution=n, fft_impl="pallas", matmul_precision="highest")
    tier = fused_step.check_supported(cfg, n)
    state, source = main_state(dev, cfg)
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
    # The library yardstick: torch.fft.ifft2 of the H and Z spectra of each frame.
    spectra = torch.randn((TIME_BATCH, 2, n, n), dtype=torch.complex64, device=dev)
    library_ms = event_ms(lambda: torch.fft.ifft2(spectra), TIMING_CALLS)
    del spectra
    k1_device = k1_device_ms(state, cfg, ts_tb, TIMING_CALLS)
    device_ms = k1_device["total"]
    k1_bound = bound(nbytes(state.h0, state.omega, inputs.twiddle, ts_tb)
                     + 4 * TIME_BATCH * (3 * n * n + n // fused_step.CHECKSUM_ROWS),
                     fft_ops(n, TIME_BATCH * 4 * n))
    phase("time_one_call", frames=TIME_BATCH, kernel_ms=kernel_ms, device_ms=k1_device,
          plain_ms=plain_ms, library_ifft2_ms=library_ms, calls=TIMING_CALLS,
          clock="cuda events; device_ms: torch.profiler, K1's launches only", **k1_bound)

    # --- 7. rollout ---------------------------------------------------------
    rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH)
    ts = torch.arange(STEPS, dtype=torch.float32, device=dev) / 60.0
    reset_launches()
    rec = time_rollout(rollout, state, ts, repeats=REPEATS)
    launches = launch_count("k1")
    expected = (REPEATS + 1) * STEPS // TIME_BATCH

    def plain_rollout(st, tt):
        pre = fused_step.hoist_packed(st.h0, st.omega, cfg)
        return torch.cat([fused_step.packed_checksums_reference(pre, tt[i:i + TIME_BATCH], cfg)
                          for i in range(0, tt.shape[0], TIME_BATCH)])

    DIRECT_ROLLOUTS[(n, TIME_BATCH)] = rec
    STATES["main"] = state
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

    return {
        "name": "K1 packed_step (row pass, column pass, checksum partials; "
                "cascades on grid axis z)",
        "route": "cuda",
        "source": "gfx_ocean_tpu_torch/csrc/packed_step.cu",
        "replaces": "gfx_ocean_tpu/ops/pallas_step.py:352",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        **k1_bound,
        "library_ms": library_ms,
    }


def max_err(got, want) -> tuple:
    """(max |got - want|, that over max |want|)."""
    max_abs = float((got - want).abs().max())
    return max_abs, max_abs / float(want.abs().max())


def run_fourstep(dev) -> list:
    """Phases 8-13: the 4096^2 path through K2 + K3; returns their entries."""
    import dataclasses

    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.golden.reference import golden_fields, golden_normals
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops.derived import checksums_of_planes, finite_difference_normals_planes
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    # config 5 at "highest": the FFT bodies of K2 and K3 (phase 50 holds the
    # tiered bodies at config 5's "high")
    cfg = ot.OceanConfig(resolution=FS_N, domain_size=2000.0, fft_impl="pallas",
                         matmul_precision="highest")
    tier = fused_step.check_supported(cfg, FS_N)

    def state_at(n: int):
        return ot.ocean_state_from_phillips(dataclasses.replace(cfg, resolution=n),
                                            ot.PhillipsConfig(),
                                            generator=torch.Generator().manual_seed(0),
                                            device=dev)

    # --- 8. state -----------------------------------------------------------
    state = state_at(FS_N)
    phase("fourstep_state", source="phillips synthesize, torch.Generator seed 0",
          resolution=FS_N, domain_size=cfg.domain_size, matmul_precision=cfg.matmul_precision,
          h0_absmax=float(state.h0.abs().max()), omega_max=float(state.omega.max()))

    # --- 9. kernel vs plain at 1024^2, 4096^2, 8192^2 -----------------------
    errs = {}
    for n, frames in FS_COMPARE:
        c = dataclasses.replace(cfg, resolution=n)
        st = state if n == FS_N else state_at(n)
        inputs = fused_step.hoist_packed(st.h0, st.omega, c)
        ts = torch.tensor(T_COMPARE[:frames], dtype=torch.float32, device=dev)
        y = fs.launch_fourstep_row(inputs, ts, c)
        y_want = fs.fourstep_row_reference(inputs, ts, c)
        planes, partials = fs.launch_fourstep_col(y, inputs.twiddle, c, checksum=True)
        torch.cuda.synchronize()
        k2 = max_err(y, y_want)
        k3 = max_err(planes, fs.fourstep_col_reference(y, c))
        del y
        want = fs.fourstep_col_reference(y_want, c)
        del y_want
        chained = max_err(planes, want)
        summands = (want.abs().sum(dim=(-3, -2, -1))
                    + finite_difference_normals_planes(want[:, 1], c.normal_height_scale)
                    .abs().sum(dim=(-3, -2, -1)))
        ck_rel = float(((partials.sum(dim=-1) - checksums_of_planes(want, c)).abs()
                        / summands).max())
        errs[n] = dict(k2=k2, k3=k3, chained=chained, checksum=ck_rel,
                       summands_max=float(summands.max()))
        phase("fourstep_kernel_vs_plain", resolution=n, frames=list(T_COMPARE[:frames]),
              k2_y_max_abs=k2[0], k2_y_rel=k2[1], k3_planes_max_abs=k3[0],
              k3_planes_rel=k3[1], planes_max_abs=chained[0], planes_rel=chained[1],
              checksum_rel_to_summands=ck_rel, tolerance=TOL_KERNEL,
              checksum_tolerance=TOL_CHECKSUM)
        del inputs, planes, partials, want, summands
        torch.cuda.empty_cache()
        for what, rel in (("K2 Y", k2[1]), ("K3 planes", k3[1]), ("planes", chained[1])):
            if not (rel <= TOL_KERNEL):
                fail(f"{n}^2 kernel vs plain, {what}: {rel:.3e} > {TOL_KERNEL}")
        if not (ck_rel <= TOL_CHECKSUM):
            fail(f"{n}^2 kernel vs plain checksums: {ck_rel:.3e} > {TOL_CHECKSUM}")

    # --- 10. golden gate ----------------------------------------------------
    fields = ot.make_step(cfg)(state, T_CHECK)
    disp = fields.displacement.cpu().numpy()
    gold = golden_fields(from_pair_np(state.h0.cpu().numpy()), state.omega.cpu().numpy(),
                         T_CHECK, cfg.domain_size, cfg.compat)
    abs_linf = float(np.abs(disp - gold).max())
    rel_linf = abs_linf / float(np.abs(gold).max())
    nrm_linf = float(np.abs(fields.normals.cpu().numpy()
                            - golden_normals(gold[..., 1], cfg.normal_height_scale)).max())
    STATES["fourstep"], STATES["fourstep_golden"] = state, gold
    del fields, gold
    phase("fourstep_golden", resolution=FS_N, t=T_CHECK, rel_linf=rel_linf, abs_linf=abs_linf,
          normals_abs_linf=nrm_linf, gate="rel_linf", gate_limit=GOLDEN_GATE,
          effective_precision=tier)
    if not (np.isfinite(disp).all() and rel_linf <= GOLDEN_GATE):
        fail(f"4096^2 golden gate: relative L-inf {rel_linf:.3e} > {GOLDEN_GATE}")
    del disp

    # --- 11. one call of K2, K3 and the step against the plain version ------
    inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
    one_call = {}
    for tb in FS_TIME_BATCHES:
        ts = torch.arange(tb, dtype=torch.float32, device=dev) / 60.0
        y = fs.launch_fourstep_row(inputs, ts, cfg)
        rec = dict(
            k2_ms=event_ms(lambda: fs.launch_fourstep_row(inputs, ts, cfg), FS_TIMING_CALLS),
            k3_ms=event_ms(lambda: fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True),
                           FS_TIMING_CALLS),
            step_ms=event_ms(lambda: fused_step.packed_checksums(inputs, ts, cfg),
                             FS_TIMING_CALLS),
            k2_plain_ms=event_ms(lambda: fs.fourstep_row_reference(inputs, ts, cfg),
                                 FS_PLAIN_TIMING_CALLS),
            k3_plain_ms=event_ms(lambda: checksums_of_planes(fs.fourstep_col_reference(y, cfg),
                                                             cfg), FS_PLAIN_TIMING_CALLS),
            step_plain_ms=event_ms(lambda: fs.fourstep_checksums_reference(inputs, ts, cfg),
                                   FS_PLAIN_TIMING_CALLS))
        if tb == 1:
            # Library yardsticks: torch.fft of the H and Z spectra along x
            # (K2), along y (K3) and both (the step).
            spectra = torch.randn((tb, 2, FS_N, FS_N), dtype=torch.complex64, device=dev)
            rec.update(
                k2_library_ms=event_ms(lambda: torch.fft.ifft(spectra, dim=-1), FS_TIMING_CALLS),
                k3_library_ms=event_ms(lambda: torch.fft.ifft(spectra, dim=-2), FS_TIMING_CALLS),
                step_library_ifft2_ms=event_ms(lambda: torch.fft.ifft2(spectra),
                                               FS_TIMING_CALLS))
            del spectra
            rec["k2_bound"] = bound(nbytes(state.h0, state.omega, inputs.twiddle, ts, y),
                                    fft_ops(FS_N, tb * 2 * FS_N))
            rec["k2_device_ms"] = k2_device_ms(state, cfg, ts, FS_TIMING_CALLS)
            k3_out = fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True)
            rec["k3_bound"] = bound(nbytes(y, inputs.twiddle, *k3_out),
                                    fft_ops(FS_N, tb * 2 * FS_N))
            del k3_out
            rec["k3_device_ms"] = k3_device_ms(state, cfg, ts, FS_TIMING_CALLS)
        one_call[tb] = rec
        phase("fourstep_time_one_call", resolution=FS_N, frames=tb, calls=FS_TIMING_CALLS,
              plain_calls=FS_PLAIN_TIMING_CALLS, clock="cuda events", **rec)
        del y
    torch.cuda.empty_cache()

    # --- 12. rollouts -------------------------------------------------------
    ts = torch.arange(FS_STEPS, dtype=torch.float32, device=dev) / 60.0
    main_launches = None
    for tb in FS_TIME_BATCHES:
        rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=tb)
        reset_launches()
        rec = time_rollout(rollout, state, ts, repeats=FS_REPEATS)
        launches = {k: launch_count(k) for k in ("k1", "k2", "k3")}
        expected = (FS_REPEATS + 1) * FS_STEPS // tb
        DIRECT_ROLLOUTS[(FS_N, tb)] = rec

        def plain_rollout(st, tt, tb=tb):
            pre = fused_step.hoist_packed(st.h0, st.omega, cfg)
            return torch.cat([fs.fourstep_checksums_reference(pre, tt[i:i + tb], cfg)
                              for i in range(0, tt.shape[0], tb)])

        plain = time_rollout(plain_rollout, state, ts, repeats=FS_REPEATS)
        cks, plain_cks = rec["checksums"], plain["checksums"]
        ck_diff = float(np.abs(cks - plain_cks).max())
        ck_limit = TOL_CHECKSUM * errs[FS_N]["summands_max"]
        phase("fourstep_rollout", resolution=FS_N, steps=FS_STEPS, time_batch=tb,
              repeats=FS_REPEATS, steps_per_sec=rec["steps_per_sec"],
              repeats_sec=rec["repeats_sec"], plain_steps_per_sec=plain["steps_per_sec"],
              plain_repeats_sec=plain["repeats_sec"], launches=launches,
              expected_launches=expected, checksums_finite=bool(np.isfinite(cks).all()),
              checksum_max_abs_diff_vs_plain=ck_diff, checksum_limit=ck_limit,
              checksum_first=float(cks[0]), checksum_last=float(cks[-1]))
        if launches != dict(k1=0, k2=expected, k3=expected):
            fail(f"4096^2 rollout at tb {tb} launched {launches}, expected {expected} of K2 and K3")
        if cks.shape != (FS_STEPS,) or not np.isfinite(cks).all():
            fail(f"4096^2 rollout checksums: shape {cks.shape}, "
                 f"finite {bool(np.isfinite(cks).all())}")
        if not (ck_diff <= ck_limit):
            fail(f"4096^2 rollout checksums differ from the plain version by {ck_diff:.3e}")
        if tb == 1:
            main_launches = launches

    # --- 13. device time by kernel -------------------------------------------
    rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=1)
    phase("fourstep_profile", resolution=FS_N, time_batch=1,
          **device_profile(lambda: rollout(state, ts[:FS_PROFILE_STEPS]).cpu(),
                           FS_PROFILE_STEPS))

    entries = []
    for key, name, line, ms, plain_ms in (
            ("k2", "K2 fourstep_row_pass (packed propagate + row FFT)", 614,
             one_call[1]["k2_ms"], one_call[1]["k2_plain_ms"]),
            ("k3", "K3 fourstep_col (column FFT in two stages, checksum partials)", 757,
             one_call[1]["k3_ms"], one_call[1]["k3_plain_ms"])):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "gfx_ocean_tpu_torch/csrc/fourstep_step.cu",
            "replaces": f"gfx_ocean_tpu/ops/pallas_step.py:{line}",
            "launches": main_launches[key],
            "max_abs_err": errs[FS_N][key][0],
            "ms": ms,
            "device_ms": one_call[1][f"{key}_device_ms"]["total"],
            "plain_ms": plain_ms,
            **one_call[1][f"{key}_bound"],
            "library_ms": one_call[1][f"{key}_library_ms"],
        })
    return entries


def render_stages(dev, state, cfg, disp, vp, cp, k7_ms: float) -> dict:
    """CUDA-event ms of each stage of one 1200x700 frame at the default
    camera, each fed the previous stage's output. The giant pass and the
    frame include the host sync that reads the giant pass's group count."""
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.render import raster as rr

    positions, uvs, tris = rr._mesh_constants(cfg.mesh_resolution, cfg.num_patches, dev)
    interp = rr._interp_matrices(cfg.mesh_resolution, R_N, dev)
    grid_shape = (cfg.num_patches, cfg.mesh_resolution)
    pool = rr._auto_pool(R_W, R_H)
    step_cfg = dataclasses.replace(cfg, compute_normals=False)

    def tables():
        return rr._slot_tables(disp, positions, uvs, tris, vp, R_W, R_H, pool, interp, grid_shape)

    tabs = tables()
    n_oct = tabs.octs_w * tabs.octs_h
    keysp, octid = rr.slot_stage(tabs.crow, tabs.total_covered, R_W, R_H, tabs.octs_w, n_oct,
                                 32 - tabs.id_bits, tabs.id_bits)
    key_img = rr._resolve(keysp, octid, tabs, R_W, R_H)
    key_img = rr._giant_pass(tabs.clip, tris, tabs.score, key_img, R_W, R_H, R_GIANTS,
                             tabs.id_bits)[0]
    wc = rr._tri_corners(tabs.world, tris, grid_shape)
    dtab = torch.cat([tabs.ftab, wc.reshape(wc.shape[0], 9)], dim=1)
    calls = R_TIMING_CALLS
    return dict(
        step=event_ms(lambda: ot.step(state, R_T, step_cfg), calls),
        slot_tables=event_ms(tables, calls),
        k7=k7_ms,
        resolve_with_k8=event_ms(lambda: rr._resolve(keysp, octid, tabs, R_W, R_H), calls),
        giant_selection=event_ms(lambda: rr._giant_selection(tabs.score, R_GIANTS), calls),
        giant_pass=event_ms(lambda: rr._giant_pass(tabs.clip, tris, tabs.score, key_img, R_W,
                                                   R_H, R_GIANTS, tabs.id_bits), calls),
        deferred_shade=event_ms(lambda: rr._deferred_shade(disp, dtab, key_img, cp, R_W, R_H,
                                                           tabs.id_bits, grid_shape), calls),
        giant_groups=giant_groups(tabs))


@contextlib.contextmanager
def plain_raster():
    """Route the rasterizer's K7, K8 and K9 dispatchers to their plain
    versions (on the card) inside the block."""
    from gfx_ocean_tpu_torch.render import raster as rr

    saved = rr.slot_stage, rr.segmin_stage, rr.giant_stage

    def slot(crow, total_covered, width, full_height, octs_w, spill_oct, bw_bits, id_bits,
             y_origin=0):
        cov = rr._stage_scalars(total_covered, y_origin, crow.device)
        return rr.slot_stage_reference(crow, cov, width, full_height, octs_w, spill_oct,
                                       bw_bits, id_bits)

    rr.slot_stage, rr.segmin_stage = slot, rr.segmin_stage_reference
    rr.giant_stage = rr.giant_pass_reference
    try:
        yield
    finally:
        rr.slot_stage, rr.segmin_stage, rr.giant_stage = saved


def giant_groups(tabs) -> int:
    """The groups of a 1200x700 frame's giant selection that hold an
    active candidate."""
    from gfx_ocean_tpu_torch.render import raster as rr

    return -(-int(rr._giant_selection(tabs.score, R_GIANTS)[2]) // 32)


def giant_args(tabs, tris, key_img, forced: bool = False) -> tuple:
    """K9's arguments on a 1200x700 frame's key image: its giant
    selection's active groups, or with ``forced`` every one of the
    ``R_GIANTS`` highest-scored triangles as active (the 512-candidate
    giant frame)."""
    import torch

    from gfx_ocean_tpu_torch.render import raster as rr

    ids, ok, _ = rr._giant_selection(tabs.score, R_GIANTS)
    groups = giant_groups(tabs)
    if forced:
        groups, ok = ids.shape[0], torch.ones_like(ok)
    return (ids[:groups], ok[:groups], tabs.clip, tris, tabs.score, key_img, R_W, R_H, R_H, 0,
            tabs.id_bits)


def k9_bound(args, out) -> dict:
    """K9's bound: each active candidate tested at the pixels it needs (a
    crossing one at every pixel, another at its pixel-centre bbox within
    the image), against the key image read and written once and the
    candidates' inputs (id, flag, corners' ids and clip rows, score)."""
    import torch

    ids, ok, clip, tris, score = args[:5]
    active = ids[ok]
    v = clip[tris[active]].double()                     # (n, 3, 4)
    sx = (v[..., 0] / v[..., 3] * 0.5 + 0.5) * R_W
    sy = (v[..., 1] / v[..., 3] * 0.5 + 0.5) * R_H
    cols = (torch.floor(sx.amax(-1) - 0.5).clamp(max=R_W - 1)
            - torch.ceil(sx.amin(-1) - 0.5).clamp(min=0) + 1).clamp(min=0)
    rows = (torch.floor(sy.amax(-1) - 0.5).clamp(max=R_H - 1)
            - torch.ceil(sy.amin(-1) - 0.5).clamp(min=0) + 1).clamp(min=0)
    pixels = torch.where(torch.isinf(score[active]), float(R_W * R_H), cols * rows)
    ops = K9_OPS_PER_PIXEL_CANDIDATE * float(pixels.sum())
    return bound(nbytes(args[5], out) + active.numel() * (8 + 1 + 3 * 8 + 3 * 16 + 4), ops)


def key_err(got, want) -> tuple:
    """(entries that differ, max |difference| of the uint32 values)."""
    from gfx_ocean_tpu_torch.render.raster import _u32_value

    d = (_u32_value(got) - _u32_value(want)).abs()
    return int((d != 0).sum()), float(d.max())


def run_render(dev) -> list:
    """Phases 14-17: the 1200x700 frame renderer through K1 + K7 + K8 + K9;
    returns the entries of K7, K8 and K9."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.render import raster as rr
    from gfx_ocean_tpu_torch.render.camera import Camera
    from gfx_ocean_tpu_torch.spectra.phillips import synthesize
    from gfx_ocean_tpu_torch.utils import profiling

    cfg = ot.OceanConfig(fft_impl="pallas")
    noise = np.random.default_rng(R_SEED).standard_normal((2, R_N, R_N)).astype(np.float32)
    h0, omega = synthesize(R_N, cfg.domain_size, ot.PhillipsConfig(),
                           noise=torch.from_numpy(noise))
    state = ot.OceanState(h0.to(dev), omega.to(dev))
    cam = Camera()
    vp = rr._view_proj(cam, R_W, R_H, dev)
    cp = torch.tensor(cam.position.astype(np.float32), device=dev)
    disp = ot.step(state, R_T, dataclasses.replace(cfg, compute_normals=False)).displacement
    STATES["render"] = state
    positions, uvs, tris = rr._mesh_constants(cfg.mesh_resolution, cfg.num_patches, dev)
    interp = rr._interp_matrices(cfg.mesh_resolution, R_N, dev)
    grid_shape = (cfg.num_patches, cfg.mesh_resolution)
    pool = rr._auto_pool(R_W, R_H)

    # --- 14. K7 and K8 against their plain versions -------------------------
    low = Camera()
    low.position, low.rotation = np.array(R_LOW[0]), np.array(R_LOW[1])
    k7_err = k8_err = 0.0
    for name, camera in (("default", cam), ("low", low)):
        tabs = rr._slot_tables(disp, positions, uvs, tris, rr._view_proj(camera, R_W, R_H, dev),
                               R_W, R_H, pool, interp, grid_shape)
        n_oct = tabs.octs_w * tabs.octs_h
        cov = rr._stage_scalars(tabs.total_covered, 0, dev)
        slot_args = (tabs.crow, cov, R_W, R_H, tabs.octs_w, n_oct, 32 - tabs.id_bits,
                     tabs.id_bits)
        keys, octs = rr.launch_slot_kernel(*slot_args)
        want_keys, want_octs = rr.slot_stage_reference(*slot_args)
        so, sk = rr._oct_sort(keys, octs, n_oct)
        mins, skey = rr.launch_segmin_kernel(so, sk, n_oct, tabs.id_bits)
        want_mins, want_skey = rr.segmin_stage_reference(so, sk, n_oct, tabs.id_bits)
        torch.cuda.synchronize()
        groups = giant_groups(tabs)
        k7 = key_err(keys, want_keys)
        k8 = key_err(mins, want_mins)
        rec = dict(k7_keys_differ=k7[0], k7_octs_differ=int((octs != want_octs).sum()),
                   k8_mins_differ=k8[0], k8_skey_differ=int((skey != want_skey).sum()))
        phase("render_kernel_vs_plain", camera=name, position=list(camera.position),
              rotation=list(camera.rotation), width=R_W, height=R_H, id_bits=tabs.id_bits,
              slots=pool, covered_slots=int(tabs.total_covered), resolve_entries=so.shape[0],
              giant_groups=groups, k7_max_abs=k7[1], k8_max_abs=k8[1], **rec)
        if any(rec.values()):
            fail(f"K7/K8 differ from their plain versions at the {name} camera: {rec}")
        if name == "low" and groups == 0:
            fail("the low camera left the giant pass without an active group")
        k7_err, k8_err = max(k7_err, k7[1]), max(k8_err, k8[1])
        if name == "default":
            k7_args, k8_args = slot_args, (so, sk, n_oct, tabs.id_bits)
            covered_slots = int(tabs.total_covered)
    rng = np.random.default_rng(1)
    so_s = np.sort(np.concatenate([rng.integers(0, K8_N_OCT + 1, K8_N - K8_LONG_RUN),
                                   np.full(K8_LONG_RUN, K8_N_OCT // 3)])).astype(np.int32)
    so_s = torch.from_numpy(so_s).to(dev)
    for id_bits in (17, 10):
        sk_s = torch.from_numpy(rng.integers(-2**31, 2**31, (rr._zq_key_rows(id_bits), K8_N),
                                             dtype=np.int64).astype(np.int32)).to(dev)
        mins, skey = rr.launch_segmin_kernel(so_s, sk_s, K8_N_OCT, id_bits)
        want_mins, want_skey = rr.segmin_stage_reference(so_s, sk_s, K8_N_OCT, id_bits)
        torch.cuda.synchronize()
        k8 = key_err(mins, want_mins)
        rec = dict(k8_mins_differ=k8[0], k8_skey_differ=int((skey != want_skey).sum()))
        phase("render_kernel_vs_plain", inputs="synthetic", entries=K8_N, n_oct=K8_N_OCT,
              longest_run=K8_LONG_RUN, id_bits=id_bits, k8_max_abs=k8[1], **rec)
        if any(rec.values()):
            fail(f"K8 differs from its plain version on synthetic runs: {rec}")
        k8_err = max(k8_err, k8[1])
    del so_s, sk_s, mins, skey, want_mins, want_skey

    # --- 14b. K9 against its plain version on the frames' giant passes ----
    k9_err = 0
    for name, camera, forced in (("default", cam, False), ("low", low, False),
                                 ("default, 512 active", cam, True)):
        tabs = rr._slot_tables(disp, positions, uvs, tris, rr._view_proj(camera, R_W, R_H, dev),
                               R_W, R_H, pool, interp, grid_shape)
        n_oct = tabs.octs_w * tabs.octs_h
        keys, octs = rr.slot_stage(tabs.crow, tabs.total_covered, R_W, R_H, tabs.octs_w, n_oct,
                                   32 - tabs.id_bits, tabs.id_bits)
        key_img = rr._resolve(keys, octs, tabs, R_W, R_H)
        args = giant_args(tabs, tris, key_img, forced)
        got = rr.launch_giant_kernel(*args)
        want = rr.giant_pass_reference(*args)
        torch.cuda.synchronize()
        differ, max_abs = key_err(got, want)
        active = args[1]
        phase("render_giant_vs_plain", camera=name, width=R_W, height=R_H, giants=R_GIANTS,
              groups=args[0].shape[0], active=int(active.sum()),
              crossing=int(torch.isinf(tabs.score[args[0][active]]).sum()),
              pixels_merged=int((want != key_img).sum()), k9_keys_differ=differ,
              k9_max_abs=max_abs)
        if differ or args[0].shape[0] == 0:
            fail(f"K9 differs from its plain version ({differ} keys) or had no active group "
                 f"at the {name} camera")
        k9_err = max(k9_err, max_abs)
        if name == "default":
            k9_args = args
        if forced:
            k9_512_args = args
    del keys, octs, key_img, got, want

    # --- 15. the fused frame through the kernels and through the plain versions
    fr = rr.make_frame_renderer(cfg, R_W, R_H, R_GIANTS, diag=True)
    fr(state, R_T, vp, cp)                  # eager; it captures the stages' CUDA graphs
    frame, dropped = fr(state, R_T, vp, cp)
    with plain_raster():                    # a new renderer: its first frame is eager
        plain_fr = rr.make_frame_renderer(cfg, R_W, R_H, R_GIANTS, diag=True)
        plain_frame, plain_dropped = plain_fr(state, R_T, vp, cp)
    img, depth = rr._rasterize_pool(disp, positions, uvs, tris, vp, cp, R_W, R_H, pool,
                                    R_GIANTS, interp, grid_shape)
    overflow, demand = rr.pool_overflow(disp, positions, uvs, tris, vp, R_W, R_H,
                                        return_demand=True)
    bh = R_H // R_BANDS
    bands = [rr._rasterize_pool(disp, positions, uvs, tris, vp, cp, R_W, bh,
                                rr._auto_pool(R_W, bh, R_BANDS), R_GIANTS, interp, grid_shape,
                                y_origin=k * bh, full_height=R_H, with_diag=True)
             for k in range(R_BANDS)]
    rec = dict(
        frame_differ_vs_plain=int((frame != plain_frame).sum()),
        frame_differ_vs_render_frame=int((frame != rr.srgb8(img)).sum()),
        band_color_differ=int((torch.cat([b[0] for b in bands]) != img).sum()),
        band_depth_differ=int((torch.cat([b[1] for b in bands]) != depth).sum()))
    drops = dict(frame=int(dropped), plain=int(plain_dropped),
                 bands=[int(b[2]) for b in bands])
    phase("render_frame", width=R_W, height=R_H, shape=list(frame.shape),
          dtype=str(frame.dtype), t=R_T, coverage=float(torch.isfinite(depth).float().mean()),
          pool=pool, covered_slots=covered_slots, pool_overflow=overflow, slot_demand=demand,
          giants=R_GIANTS, dropped=drops, bands=R_BANDS, **rec)
    if tuple(frame.shape) != (R_H, R_W, 3) or frame.dtype != torch.uint8:
        fail(f"frame: shape {tuple(frame.shape)}, {frame.dtype}")
    if any(rec.values()):
        fail(f"render_frame: {rec}")
    if drops["frame"] or drops["plain"] or any(drops["bands"]):
        fail(f"giant-pass candidates dropped: {drops}")
    if overflow > R_GIANTS:
        fail(f"{overflow} triangles overflow the pool, past the {R_GIANTS} giant slots")

    # --- 16. against the frame the JAX package rendered ---------------------
    stored = np.load(Path(ot.__file__).resolve().parent / "golden" / "frame_jax_1200x700.npz")
    want = stored["frame"]
    got = frame.cpu().numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    off = float((diff > 2).mean())
    mean_color = float(np.abs(got.reshape(-1, 3).mean(0) - want.reshape(-1, 3).mean(0)).max())
    phase("render_vs_jax", jax_commit=str(stored["jax_commit"]), seed=int(stored["seed"]),
          t=float(stored["t"]), values_off_by_more_than_2=off,
          pixels_differing=int((diff.max(-1) > 0).sum()), max_abs_diff=int(diff.max()),
          mean_color_diff=mean_color, limit_off=JAX_FRAME_PIXELS_OFF,
          limit_mean_color=JAX_FRAME_MEAN_COLOR)
    if not (off < JAX_FRAME_PIXELS_OFF and mean_color < JAX_FRAME_MEAN_COLOR):
        fail(f"frame vs the stored JAX frame: {off:.2e} values off, mean color {mean_color:.3f}")

    # --- 17. time --------------------------------------------------------------
    frame_ms = event_ms(lambda: fr(state, R_T, vp, cp), R_TIMING_CALLS)
    with plain_raster():                    # its graphs hold the plain versions
        plain_frame_ms = event_ms(lambda: plain_fr(state, R_T, vp, cp), R_PLAIN_TIMING_CALLS)
    k7_ms = event_ms(lambda: rr.launch_slot_kernel(*k7_args), R_KERNEL_CALLS)
    k7_plain_ms = event_ms(lambda: rr.slot_stage_reference(*k7_args), R_PLAIN_TIMING_CALLS)
    k8_ms = event_ms(lambda: rr.launch_segmin_kernel(*k8_args), R_KERNEL_CALLS)
    k8_plain_ms = event_ms(lambda: rr.segmin_stage_reference(*k8_args), R_PLAIN_TIMING_CALLS)
    # K8's library yardstick: one scatter_reduce("amin") of the unpacked keys
    # by run id, the run minima K8 leaves on each run's last entry.
    so, sk, n_oct, id_bits = k8_args
    keys64 = rr._zq_unpack_keys(rr._u32_value(sk), id_bits)
    runs = so.long().expand_as(keys64).contiguous()
    empty = torch.full((keys64.shape[0], n_oct + 1), rr.KEY_MAX, dtype=torch.int64, device=dev)
    k8_library_ms = event_ms(lambda: empty.scatter_reduce(1, runs, keys64, "amin",
                                                          include_self=False), R_KERNEL_CALLS)
    del keys64, runs, empty
    k7_keys, k7_octs = rr.launch_slot_kernel(*k7_args)
    k8_mins, k8_skey = rr.launch_segmin_kernel(*k8_args)
    k7_bound = bound(nbytes(k7_args[0], k7_args[1], k7_keys, k7_octs),
                     K7_OPS_PER_PIXEL * 8 * k7_args[0].shape[1])
    k8_bound = bound(nbytes(so, sk, k8_mins, k8_skey), K8_OPS_PER_KEY * 8 * so.shape[0])
    del k7_keys, k7_octs, k8_mins, k8_skey
    k7_device = kernel_device_ms(lambda: rr.launch_slot_kernel(*k7_args), K7_KERNELS,
                                 R_KERNEL_CALLS)
    k8_device = kernel_device_ms(lambda: rr.launch_segmin_kernel(*k8_args), K8_KERNELS,
                                 R_KERNEL_CALLS)
    k9_ms = event_ms(lambda: rr.launch_giant_kernel(*k9_args), R_KERNEL_CALLS)
    k9_plain_ms = event_ms(lambda: rr.giant_pass_reference(*k9_args), R_PLAIN_TIMING_CALLS)
    k9_device = kernel_device_ms(lambda: rr.launch_giant_kernel(*k9_args), K9_KERNELS,
                                 R_KERNEL_CALLS)
    k9_512_device = kernel_device_ms(lambda: rr.launch_giant_kernel(*k9_512_args), K9_KERNELS,
                                     R_KERNEL_CALLS)
    k9_512_plain_ms = event_ms(lambda: rr.giant_pass_reference(*k9_512_args),
                               R_PLAIN_TIMING_CALLS)
    k9_out = rr.launch_giant_kernel(*k9_args)
    k9_b, k9_512_b = k9_bound(k9_args, k9_out), k9_bound(k9_512_args, k9_out)
    del k9_out
    stage_ms = render_stages(dev, state, cfg, disp, vp, cp, k7_ms)

    ts = [R_T + i / 60.0 for i in range(R_FRAMES)]
    reset_launches()
    t0 = time.perf_counter()
    for t in ts:
        fr(state, t, vp, cp)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / R_FRAMES
    launches = {k: launch_count(k) for k in ("k1", "k2", "k3", "k7", "k8", "k9")}
    # The same frames recorded: K9 once on every frame, inside its stage's
    # graph, whether a group is active or not.
    with profiling.recording():
        for t in ts:
            fr(state, t, vp, cp)
    units = list(profiling.windows()[-1].units)
    giant_frames = sum(u.counters.get("giant.groups", 0) > 0 for u in units)
    k9_per_frame = [u.counters.get("launches.launch_giant_kernel", 0) for u in units]
    if len(units) != R_FRAMES or k9_per_frame != [1] * R_FRAMES:
        fail(f"K9 launches a recorded frame {k9_per_frame}, one expected on each")

    prof = device_profile(lambda: [fr(state, t, vp, cp) for t in ts[:R_PROFILE_FRAMES]],
                          R_PROFILE_FRAMES)
    busy_ms = prof["device_busy_ms"] / R_PROFILE_FRAMES
    phase("render_time", width=R_W, height=R_H, clock="cuda events",
          frame_ms=frame_ms, plain_frame_ms=plain_frame_ms, k7_ms=k7_ms,
          k7_plain_ms=k7_plain_ms, k8_ms=k8_ms, k8_plain_ms=k8_plain_ms,
          k7_device_ms=k7_device["total"], k8_device_ms=k8_device["total"],
          k9_ms=k9_ms, k9_plain_ms=k9_plain_ms, k9_device_ms=k9_device["total"],
          k9_candidates=int(k9_args[1].sum()), k9_bound=k9_b,
          k9_512_device_ms=k9_512_device["total"], k9_512_plain_ms=k9_512_plain_ms,
          k9_512_bound=k9_512_b, giant_frames=giant_frames,
          k8_library_scatter_amin_ms=k8_library_ms, k7_bound=k7_bound, k8_bound=k8_bound,
          stage_ms=stage_ms, frames=R_FRAMES, wall_ms_per_frame=wall_ms,
          frames_per_sec=1e3 / wall_ms, launches=launches,
          device_busy_ms_per_frame=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
          profile=prof)
    if launches != dict(k1=R_FRAMES, k2=0, k3=0, k7=R_FRAMES, k8=R_FRAMES, k9=R_FRAMES):
        fail(f"the {R_FRAMES}-frame run launched {launches}, expected {R_FRAMES} of K1, K7, K8 "
             f"and K9")

    return [
        {"name": "K7 slot_kernel (per-slot oct tile tests, packed keys)", "route": "cuda",
         "source": "gfx_ocean_tpu_torch/csrc/raster.cu",
         "replaces": "gfx_ocean_tpu/render/raster.py:666", "launches": launches["k7"],
         "max_abs_err": k7_err, "ms": k7_ms, "device_ms": k7_device["total"],
         "plain_ms": k7_plain_ms, **k7_bound, "library_ms": None},
        {"name": "K8 segmin_lookback (single-pass segmented min over oct runs, "
                 "decoupled look-back)",
         "route": "cuda", "source": "gfx_ocean_tpu_torch/csrc/raster.cu",
         "replaces": "gfx_ocean_tpu/render/raster.py:816", "launches": launches["k8"],
         "max_abs_err": k8_err, "ms": k8_ms, "device_ms": k8_device["total"],
         "plain_ms": k8_plain_ms, **k8_bound, "library_ms": k8_library_ms},
        {"name": "K9 giant_kernel (the giant pass: every active candidate merged into the "
                 "key image, tile-local candidate lists)",
         "route": "cuda", "source": "gfx_ocean_tpu_torch/csrc/raster.cu",
         "replaces": "gfx_ocean_tpu/render/raster.py:436 (a lax.while_loop of jnp ops)",
         "launches": launches["k9"], "max_abs_err": k9_err, "ms": k9_ms,
         "device_ms": k9_device["total"], "plain_ms": k9_plain_ms, **k9_b,
         "candidates": int(k9_args[1].sum()), "device_ms_512": k9_512_device["total"],
         "plain_ms_512": k9_512_plain_ms, "bound_ms_512": k9_512_b["bound_ms"],
         "library_ms": None},
    ]


def device_profile(fn, frames: int, top: int = 15) -> dict:
    """torch.profiler's device time of one call of ``fn()`` (``frames``
    frames) by kernel, per frame, and the idle share of its wall clock, in
    one ``profile_kernels`` window with host activity traced."""
    from gfx_ocean_tpu_torch.utils.profiling import profile_kernels

    seen = profile_kernels(fn, 1, cpu=True)
    if seen is None:
        fail("torch.profiler recorded no device op")
    kernels, wall_ms = seen
    by_op = sorted(((k, ms, cnt) for k, (ms, cnt) in kernels.items()), key=lambda k: -k[1])
    busy_ms = sum(ms for _, ms, _ in by_op)
    return dict(frames=frames, wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                top_device_ops=[{"name": k[:90], "ms_per_frame": ms / frames, "calls": cnt}
                                for k, ms, cnt in by_op[:top]])


def run_unpacked(dev) -> list:
    """Phases 18-21: the unpacked 512^2 step through K4 (the single route)
    and K5 + K6 (the blocked route); returns their kernels entries."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch import kernels
    from gfx_ocean_tpu_torch.golden.reference import golden_fields, golden_normals
    from gfx_ocean_tpu_torch.models.ocean import downsample_state
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops import unpacked_step as us
    from gfx_ocean_tpu_torch.ops.derived import checksums_of_planes, finite_difference_normals_planes
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    single = ot.OceanConfig(resolution=N, fft_impl="pallas", hermitian_pack=False,
                            matmul_precision="bf16x3")
    blocked = dataclasses.replace(single, matmul_precision="highest")
    if (us.unpacked_route(single, N), us.unpacked_route(blocked, N)) != ("single", "blocked"):
        fail("the unpacked 512^2 configs do not take the single and blocked routes")
    state, _ = main_state(dev, single)

    # --- 18. K4, K5, K6 and K5 + K6 against the plain version -------------
    # K4's FFT body runs at "highest" (K4t, its tiered body, is phase 52's);
    # K4 is called alone at 512^2, where the route at "highest" is K5 + K6.
    ts_cmp = torch.tensor(T_COMPARE, dtype=torch.float32, device=dev)
    errs = {}
    for n in U_COMPARE:
        st = downsample_state(state, n)
        for flags in (ot.CompatFlags(), ot.CompatFlags(conj_neg=True)):
            cfg = dataclasses.replace(blocked, resolution=n, compat=flags)
            inputs = fused_step.hoist_packed(st.h0, st.omega, cfg)
            k4_planes, k4_partials = us.launch_unpacked_step_checksums(inputs, ts_cmp, cfg)
            y = us.launch_unpacked_rows(inputs, ts_cmp, cfg)
            k6_planes, k6_partials = us.launch_unpacked_cols_checksums(y, inputs, cfg)
            y_want = us.unpacked_rows_reference(inputs, ts_cmp, cfg)
            want = us.unpacked_cols_reference(y_want, inputs)
            torch.cuda.synchronize()
            summands = (want.abs().sum(dim=(-3, -2, -1))
                        + finite_difference_normals_planes(want[:, 1], cfg.normal_height_scale)
                        .abs().sum(dim=(-3, -2, -1)))
            ck_want = checksums_of_planes(want, cfg)

            def ck_rel(partials):
                return float(((partials.sum(dim=-1) - ck_want).abs() / summands).max())

            rec = dict(k4=max_err(k4_planes, want), k5=max_err(y, y_want),
                       k6=max_err(k6_planes, us.unpacked_cols_reference(y, inputs)),
                       k5_k6=max_err(k6_planes, want))
            cks = dict(k4=ck_rel(k4_partials), k5_k6=ck_rel(k6_partials))
            conj = bool(flags.conj_neg)
            errs[(n, conj)] = dict(rec, summands_max=float(summands.max()))
            phase("unpacked_kernel_vs_plain", resolution=n, conj_neg=conj,
                  frames=list(T_COMPARE), k4_planes_max_abs=rec["k4"][0],
                  k4_planes_rel=rec["k4"][1], k5_y_max_abs=rec["k5"][0], k5_y_rel=rec["k5"][1],
                  k6_planes_max_abs=rec["k6"][0], k6_planes_rel=rec["k6"][1],
                  k5_k6_planes_max_abs=rec["k5_k6"][0], k5_k6_planes_rel=rec["k5_k6"][1],
                  k4_checksum_rel_to_summands=cks["k4"],
                  k5_k6_checksum_rel_to_summands=cks["k5_k6"],
                  k4_bit_equal_k5_k6=bool(torch.equal(k4_planes, k6_planes)),
                  checksum="the kernel's partials, summed",
                  tolerance=TOL_KERNEL, checksum_tolerance=TOL_CHECKSUM)
            if not torch.equal(k4_planes, k6_planes):
                fail(f"{n}^2 unpacked: K4 is not bit-equal to K5 + K6")
            del inputs, k4_planes, y, k6_planes, y_want, want
            for what, (_, rel) in rec.items():
                if not (rel <= TOL_KERNEL):
                    fail(f"{n}^2 unpacked kernel vs plain, {what}: {rel:.3e} > {TOL_KERNEL}")
            for what, rel in cks.items():
                if not (rel <= TOL_CHECKSUM):
                    fail(f"{n}^2 unpacked checksums through {what}: {rel:.3e} > {TOL_CHECKSUM}")
    torch.cuda.empty_cache()

    # --- 19. both routes against the golden model --------------------------
    gold = golden_fields(from_pair_np(state.h0.cpu().numpy()), state.omega.cpu().numpy(),
                         T_CHECK, single.domain_size, single.compat)
    gold_normals = golden_normals(gold[..., 1], single.normal_height_scale)
    for route, cfg in (("single", single), ("blocked", blocked)):
        fields = ot.make_step(cfg)(state, T_CHECK)
        disp = fields.displacement.cpu().numpy()
        abs_linf = float(np.abs(disp - gold).max())
        rel_linf = abs_linf / float(np.abs(gold).max())
        nrm_linf = float(np.abs(fields.normals.cpu().numpy() - gold_normals).max())
        phase("unpacked_golden", route=route, matmul_precision=cfg.matmul_precision,
              resolution=N, t=T_CHECK, shape=list(disp.shape), rel_linf=rel_linf,
              abs_linf=abs_linf, normals_abs_linf=nrm_linf, gate="rel_linf",
              gate_limit=GOLDEN_GATE, effective_precision=fused_step.check_supported(cfg, N))
        if disp.shape != (N, N, 3) or not (np.isfinite(disp).all() and rel_linf <= GOLDEN_GATE):
            fail(f"unpacked {route} golden gate: shape {disp.shape}, "
                 f"relative L-inf {rel_linf:.3e} > {GOLDEN_GATE}")

    # --- 20. one call of K4, K5, K6 against the plain version and torch.fft -
    # K4's FFT body: the "highest" config, K4 called alone.
    inputs = fused_step.hoist_packed(state.h0, state.omega, blocked)
    ts_tb = torch.arange(TIME_BATCH, dtype=torch.float32, device=dev) / 60.0
    y = us.launch_unpacked_rows(inputs, ts_tb, blocked)
    spectra = torch.randn((TIME_BATCH, 3, N, N), dtype=torch.complex64, device=dev)
    calls, plain_calls = U_TIMING_CALLS, U_PLAIN_TIMING_CALLS
    one_call = dict(
        k4_ms=event_ms(lambda: us.launch_unpacked_step(inputs, ts_tb, blocked), calls),
        k5_ms=event_ms(lambda: us.launch_unpacked_rows(inputs, ts_tb, blocked), calls),
        k6_ms=event_ms(lambda: us.launch_unpacked_cols(y, inputs), calls),
        k4_checksums_ms=event_ms(
            lambda: us.launch_unpacked_step_checksums(inputs, ts_tb, blocked)[1].sum(-1), calls),
        k4_checksums_plain_ms=event_ms(lambda: checksums_of_planes(
            us.unpacked_planes_reference(inputs, ts_tb, blocked), blocked), plain_calls),
        k4_plain_ms=event_ms(lambda: us.unpacked_planes_reference(inputs, ts_tb, blocked),
                             plain_calls),
        k5_plain_ms=event_ms(lambda: us.unpacked_rows_reference(inputs, ts_tb, blocked),
                             plain_calls),
        k6_plain_ms=event_ms(lambda: us.unpacked_cols_reference(y, inputs), plain_calls),
        k4_library_ms=event_ms(lambda: torch.fft.ifft2(spectra), calls),
        k5_library_ms=event_ms(lambda: torch.fft.ifft(spectra, dim=-1), calls),
        k6_library_ms=event_ms(lambda: torch.fft.ifft(spectra, dim=-2), calls))
    planes_bytes = 4 * TIME_BATCH * 3 * N * N
    in_bytes = nbytes(inputs.h0, inputs.omega, inputs.twiddle, ts_tb)
    bounds = dict(k4=bound(in_bytes + planes_bytes, fft_ops(N, TIME_BATCH * 6 * N)),
                  k5=bound(in_bytes + nbytes(y), fft_ops(N, TIME_BATCH * 3 * N)),
                  k6=bound(nbytes(y) + planes_bytes, fft_ops(N, TIME_BATCH * 3 * N)))
    device_ms = dict(
        k4=k4_device_ms(state, blocked, ts_tb, calls),
        k4_checksums=kernel_device_ms(
            lambda: us.launch_unpacked_step_checksums(inputs, ts_tb, blocked),
            K4_CHECKSUM_KERNELS, calls),
        k5=kernel_device_ms(lambda: us.launch_unpacked_rows(inputs, ts_tb, blocked), K5_KERNELS,
                            calls),
        k6=kernel_device_ms(lambda: us.launch_unpacked_cols(y, inputs), K6_KERNELS, calls))
    # K4's FFT body at the shape its route gives it ("highest" at N <= 256,
    # phase 21's "single_fft" rollout): its kernels entry reads these.
    fft_n = U_FFT_ROUTE_N
    st_fft = downsample_state(state, fft_n)
    cfg_fft = dataclasses.replace(blocked, resolution=fft_n)
    inputs_fft = fused_step.hoist_packed(st_fft.h0, st_fft.omega, cfg_fft)
    spectra_fft = torch.randn((TIME_BATCH, 3, fft_n, fft_n), dtype=torch.complex64, device=dev)
    route_n = dict(
        k4_route_ms=event_ms(lambda: us.launch_unpacked_step(inputs_fft, ts_tb, cfg_fft), calls),
        k4_route_plain_ms=event_ms(
            lambda: us.unpacked_planes_reference(inputs_fft, ts_tb, cfg_fft), plain_calls),
        k4_route_library_ms=event_ms(lambda: torch.fft.ifft2(spectra_fft), calls))
    device_ms["k4_route"] = k4_device_ms(st_fft, cfg_fft, ts_tb, calls)
    bounds["k4_route"] = bound(nbytes(inputs_fft.h0, inputs_fft.omega, inputs_fft.twiddle, ts_tb)
                               + 4 * TIME_BATCH * 3 * fft_n * fft_n,
                               fft_ops(fft_n, TIME_BATCH * 6 * fft_n))
    phase("unpacked_time_one_call", resolution=N, frames=TIME_BATCH, calls=calls,
          plain_calls=plain_calls,
          clock="cuda events; device_ms: torch.profiler, the kernels' launches only",
          k4_device_ms=device_ms["k4"], k4_checksums_device_ms=device_ms["k4_checksums"],
          k5_device_ms=device_ms["k5"], k6_device_ms=device_ms["k6"],
          k4_route_resolution=fft_n, k4_route_device_ms=device_ms["k4_route"],
          k4_grid_blocks=kernels.load("unpacked_step").unpacked_step_grid(TIME_BATCH, N),
          bounds=bounds, **one_call, **route_n)
    one_call.update(route_n)
    del y, spectra, inputs, spectra_fft, inputs_fft
    torch.cuda.empty_cache()

    # --- 21. the 600-frame checksum rollouts --------------------------------
    # "single" at "bf16x3" runs K4's tiered body K4t (phase 52 holds it);
    # "single_fft" is the route of K4's FFT body: "highest" at N <= 256.
    names = ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8")
    ts = torch.arange(STEPS, dtype=torch.float32, device=dev) / 60.0
    calls_per_rollout = STEPS // TIME_BATCH
    main_launches = {}
    fft_n = U_FFT_ROUTE_N
    single_fft = dataclasses.replace(blocked, resolution=fft_n)
    if us.unpacked_route(single_fft, fft_n) != "single":
        fail(f"the unpacked {fft_n}^2 config at highest does not take the single route")
    for route, cfg, kernels in (("single", single, ("k4",)), ("blocked", blocked, ("k5", "k6")),
                                ("single_fft", single_fft, ("k4",))):
        rstate = state if cfg.resolution == N else downsample_state(state, cfg.resolution)
        rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH)
        reset_launches()
        rec = time_rollout(rollout, rstate, ts, repeats=REPEATS)
        launches = {k: launch_count(k) for k in names}
        expected = {k: (REPEATS + 1) * calls_per_rollout if k in kernels else 0 for k in names}
        tiered = launch_count("k4", "tiered_launches")
        want_tiered = launches["k4"] if route == "single" else 0

        def plain_rollout(st, tt, cfg=cfg):
            pre = fused_step.hoist_packed(st.h0, st.omega, cfg)
            return torch.cat([checksums_of_planes(
                us.unpacked_planes_reference(pre, tt[i:i + TIME_BATCH], cfg), cfg)
                for i in range(0, tt.shape[0], TIME_BATCH)])

        plain = time_rollout(plain_rollout, rstate, ts, repeats=REPEATS)
        cks, plain_cks = rec["checksums"], plain["checksums"]
        ck_diff = float(np.abs(cks - plain_cks).max())
        ck_limit = TOL_CHECKSUM * errs[(cfg.resolution, False)]["summands_max"]
        prof = device_profile(lambda: rollout(rstate, ts[:U_PROFILE_STEPS]).cpu(),
                              U_PROFILE_STEPS)
        phase("unpacked_rollout", route=route, matmul_precision=cfg.matmul_precision,
              resolution=cfg.resolution, k4_tiered_launches=tiered,
              steps=STEPS, time_batch=TIME_BATCH, repeats=REPEATS,
              steps_per_sec=rec["steps_per_sec"], repeats_sec=rec["repeats_sec"],
              plain_steps_per_sec=plain["steps_per_sec"], plain_repeats_sec=plain["repeats_sec"],
              launches=launches, expected_launches=expected,
              launches_per_rollout={k: launches[k] // (REPEATS + 1) for k in kernels},
              checksums_finite=bool(np.isfinite(cks).all()),
              checksum_max_abs_diff_vs_plain=ck_diff, checksum_limit=ck_limit,
              checksum_first=float(cks[0]), checksum_last=float(cks[-1]), profile=prof)
        if launches != expected or tiered != want_tiered:
            fail(f"unpacked {route} rollout launched {launches} ({tiered} of K4t), "
                 f"expected {expected} ({want_tiered} of K4t)")
        if cks.shape != (STEPS,) or not np.isfinite(cks).all():
            fail(f"unpacked {route} rollout checksums: shape {cks.shape}, "
                 f"finite {bool(np.isfinite(cks).all())}")
        if not (ck_diff <= ck_limit):
            fail(f"unpacked {route} rollout checksums differ from the plain version "
                 f"by {ck_diff:.3e}")
        if route != "single":  # K4t's main path is phase 52's
            main_launches.update({k: launches[k] for k in kernels})

    # K4's FFT body runs on the main path only at U_FFT_ROUTE_N ("single_fft"):
    # its entry reads that shape (time, error, bound); the 512^2 standalone
    # call stays in phase 20's line.
    entries = []
    for key, at, name, line in (
            ("k4", "k4_route", "K4 unpacked_fused (one cooperative launch: propagate + row "
                               "FFT, grid sync, column FFT)", 128),
            ("k5", "k5", "K5 unpacked_row_pass (unpacked propagate + row FFT of 3 spectra)", 184),
            ("k6", "k6", "K6 unpacked_col_pass (real-output column FFT)", 241)):
        n_at = U_FFT_ROUTE_N if key == "k4" else N
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "gfx_ocean_tpu_torch/csrc/unpacked_step.cu",
            "replaces": f"gfx_ocean_tpu/ops/pallas_step.py:{line}",
            "launches": main_launches[key],
            "resolution": n_at,
            "max_abs_err": max(errs[(n_at, c)][key][0] for c in (False, True)),
            "ms": one_call[f"{at}_ms"],
            "device_ms": device_ms[at]["total"],
            "plain_ms": one_call[f"{at}_plain_ms"],
            **bounds[at],
            "library_ms": one_call[f"{at}_library_ms"],
        })
    return entries


def run_big(dev) -> list:
    """Phases 22-26: the 16384^2 four-step path through K2 (a row split
    into two halves over a two-block cluster) and K3; returns K2's kernels
    entry at 16384^2."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.golden.reference import golden_fields_rows
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops.derived import checksums_of_planes, finite_difference_normals_planes
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    torch.cuda.empty_cache()
    # "highest": the FFT bodies (phase 51 holds K2's tiered body here)
    cfg = ot.OceanConfig(resolution=BIG_N, fft_impl="pallas", matmul_precision="highest")
    tier = fused_step.check_supported(cfg, BIG_N)
    def launches() -> dict:
        return {k: launch_count(k) for k in ("k1", "k2", "k3")}

    # --- 22. state ----------------------------------------------------------
    t0 = time.perf_counter()
    state = ot.ocean_state_from_phillips(cfg, ot.PhillipsConfig(),
                                         generator=torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    phase("big_state", source="phillips synthesize, torch.Generator seed 0", resolution=BIG_N,
          domain_size=cfg.domain_size, matmul_precision=cfg.matmul_precision,
          effective_precision=tier, seconds=time.perf_counter() - t0,
          h0_absmax=float(state.h0.abs().max()), omega_max=float(state.omega.max()))

    # --- 23. K2 and K3 on bands against the plain version --------------------
    inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
    STATES["big"] = (cfg, inputs)   # phase 43's K2 on a shard's windows
    ts = torch.tensor([T_CHECK], dtype=torch.float32, device=dev)
    y = fs.launch_fourstep_row(inputs, ts, cfg)
    planes, partials = fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True)
    torch.cuda.synchronize()
    k2 = [max_err(y[..., b:b + BIG_BAND_ROWS, :],
                  fs.fourstep_row_reference(inputs, ts, cfg, row_base=b, rows=BIG_BAND_ROWS))
          for b in BIG_ROW_BANDS]
    banded_differ = sum(int((fs.launch_fourstep_row(inputs, ts, cfg, row_base=b,
                                                    rows=BIG_BAND_ROWS)
                             != y[..., b:b + BIG_BAND_ROWS, :]).sum()) for b in BIG_ROW_BANDS)
    k3 = [max_err(planes[..., c:c + BIG_BAND_COLS],
                  fs.fourstep_col_reference(y[..., c:c + BIG_BAND_COLS].contiguous(), cfg))
          for c in BIG_COL_BANDS]
    del y
    summands = (planes.abs().sum(dim=(-3, -2, -1))
                + finite_difference_normals_planes(planes[:, 1], cfg.normal_height_scale)
                .abs().sum(dim=(-3, -2, -1)))
    ck_rel = float(((partials.sum(dim=-1) - checksums_of_planes(planes, cfg)).abs()
                    / summands).max())
    finite = bool(torch.isfinite(planes).all())
    del planes, partials
    err = dict(k2=(max(e[0] for e in k2), max(e[1] for e in k2)),
               k3=(max(e[0] for e in k3), max(e[1] for e in k3)))
    phase("big_kernel_vs_plain", resolution=BIG_N, t=T_CHECK, row_bands=list(BIG_ROW_BANDS),
          band_rows=BIG_BAND_ROWS, col_bands=list(BIG_COL_BANDS), band_cols=BIG_BAND_COLS,
          k2_y_max_abs=err["k2"][0], k2_y_rel=err["k2"][1], k3_planes_max_abs=err["k3"][0],
          k3_planes_rel=err["k3"][1], k2_banded_launch_differ=banded_differ,
          checksum_partials_rel_to_summands=ck_rel, planes_finite=finite,
          tolerance=TOL_KERNEL, checksum_tolerance=TOL_CHECKSUM)
    for what, (_, rel) in err.items():
        if not (rel <= TOL_KERNEL):
            fail(f"{BIG_N}^2 kernel vs plain, {what}: {rel:.3e} > {TOL_KERNEL}")
    if banded_differ or not finite:
        fail(f"{BIG_N}^2: banded K2 differs in {banded_differ} values; planes finite {finite}")
    if not (ck_rel <= TOL_CHECKSUM):
        fail(f"{BIG_N}^2 checksum partials: {ck_rel:.3e} > {TOL_CHECKSUM}")
    torch.cuda.empty_cache()

    # --- 24. the step against the golden model on row bands -----------------
    reset_launches()
    fields = ot.make_step(cfg)(state, T_CHECK)
    step_launches = launches()
    disp = fields.displacement
    finite = bool(torch.isfinite(disp).all()) and bool(torch.isfinite(fields.normals).all())
    shape = list(disp.shape)
    gold = {b: golden_fields_rows(state.h0, state.omega, T_CHECK, cfg.domain_size, cfg.compat,
                                  b, BIG_BAND_ROWS) for b in BIG_ROW_BANDS}
    abs_linf = max(float((disp[b:b + BIG_BAND_ROWS].double() - g).abs().max())
                   for b, g in gold.items())
    rel_linf = abs_linf / max(float(g.abs().max()) for g in gold.values())
    del fields, disp, gold
    phase("big_golden", resolution=BIG_N, t=T_CHECK, row_bands=list(BIG_ROW_BANDS),
          band_rows=BIG_BAND_ROWS, shape=shape, rel_linf=rel_linf, abs_linf=abs_linf,
          finite=finite, launches=step_launches, gate="rel_linf on the bands",
          gate_limit=GOLDEN_GATE, golden="float64 on the card, golden_fields_rows")
    if step_launches != dict(k1=0, k2=1, k3=1):
        fail(f"the {BIG_N}^2 step launched {step_launches}, expected one K2 and one K3")
    if shape != [BIG_N, BIG_N, 3] or not finite or not (rel_linf <= GOLDEN_GATE):
        fail(f"{BIG_N}^2 golden gate: shape {shape}, finite {finite}, "
             f"relative L-inf {rel_linf:.3e} > {GOLDEN_GATE}")
    torch.cuda.empty_cache()

    # --- 25. one call of K2, K3 and the step ---------------------------------
    calls = BIG_TIMING_CALLS
    y = fs.launch_fourstep_row(inputs, ts, cfg)
    rec = dict(
        k2_ms=event_ms(lambda: fs.launch_fourstep_row(inputs, ts, cfg), calls),
        k3_ms=event_ms(lambda: fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True),
                       calls),
        step_ms=event_ms(lambda: fused_step.packed_checksums(inputs, ts, cfg), calls),
        k2_device_ms=kernel_device_ms(lambda: fs.launch_fourstep_row(inputs, ts, cfg),
                                      K2_SPLIT_KERNELS, calls),
        k3_device_ms=kernel_device_ms(
            lambda: fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True), K3_KERNELS,
            calls))
    k3_out = fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True)
    rec["k2_bound"] = bound(nbytes(state.h0, state.omega, inputs.twiddle, ts, y),
                            fft_ops(BIG_N, 2 * BIG_N))
    rec["k3_bound"] = bound(nbytes(y, inputs.twiddle, *k3_out), fft_ops(BIG_N, 2 * BIG_N))
    del k3_out
    y_plain = torch.empty_like(y)

    def plain_k2():
        for r0 in range(0, BIG_N, BIG_PLAIN_ROWS):
            y_plain[..., r0:r0 + BIG_PLAIN_ROWS, :] = fs.fourstep_row_reference(
                inputs, ts, cfg, row_base=r0, rows=BIG_PLAIN_ROWS)

    rec["k2_plain_ms"] = event_ms(plain_k2, 1)
    rec["k2_plain_vs_kernel_rel"] = max_err(y, y_plain)[1]
    del y, y_plain
    torch.cuda.empty_cache()
    spectra = torch.randn((1, 2, BIG_N, BIG_N), dtype=torch.complex64, device=dev)
    rec.update(k2_library_ms=event_ms(lambda: torch.fft.ifft(spectra, dim=-1), calls),
               k3_library_ms=event_ms(lambda: torch.fft.ifft(spectra, dim=-2), calls),
               step_library_ifft2_ms=event_ms(lambda: torch.fft.ifft2(spectra), calls))
    del spectra
    torch.cuda.empty_cache()
    phase("big_time_one_call", resolution=BIG_N, frames=1, calls=calls,
          plain=f"fourstep_row_reference over the grid in {BIG_PLAIN_ROWS}-row bands, one call",
          clock="cuda events; device_ms: torch.profiler, the kernels' launches only", **rec)
    if not (rec["k2_plain_vs_kernel_rel"] <= TOL_KERNEL):
        fail(f"{BIG_N}^2 K2 vs the banded plain version: {rec['k2_plain_vs_kernel_rel']:.3e}")

    # --- 26. the checksum rollout ---------------------------------------------
    rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=1)
    ts_roll = torch.arange(BIG_STEPS, dtype=torch.float32, device=dev) / 60.0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    roll = time_rollout(rollout, state, ts_roll, repeats=BIG_REPEATS)
    roll_launches = launches()
    expected = (BIG_REPEATS + 1) * BIG_STEPS
    cks = roll["checksums"]
    phase("big_rollout", resolution=BIG_N, steps=BIG_STEPS, time_batch=1, repeats=BIG_REPEATS,
          steps_per_sec=roll["steps_per_sec"], repeats_sec=roll["repeats_sec"],
          launches=roll_launches, expected_launches=expected,
          checksums_finite=bool(np.isfinite(cks).all()), checksum_first=float(cks[0]),
          checksum_last=float(cks[-1]), peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if roll_launches != dict(k1=0, k2=expected, k3=expected):
        fail(f"{BIG_N}^2 rollout launched {roll_launches}, expected {expected} of K2 and K3")
    if cks.shape != (BIG_STEPS,) or not np.isfinite(cks).all():
        fail(f"{BIG_N}^2 rollout checksums: shape {cks.shape}, "
             f"finite {bool(np.isfinite(cks).all())}")

    return [{
        "name": "K2 fourstep_row_pass_split (16384^2: packed propagate, a radix-2 split "
                "in registers, one cluster swap, two block-local 8192-point row FFTs)",
        "route": "cuda",
        "source": "gfx_ocean_tpu_torch/csrc/fourstep_step.cu",
        "replaces": "gfx_ocean_tpu/ops/pallas_step.py:614",
        "launches": roll_launches["k2"],
        "max_abs_err": err["k2"][0],
        "ms": rec["k2_ms"],
        "device_ms": rec["k2_device_ms"]["total"],
        "plain_ms": rec["k2_plain_ms"],
        **rec["k2_bound"],
        "library_ms": rec["k2_library_ms"],
    }]


@contextlib.contextmanager
def plain_k1():
    """Route ``fused_step.packed_planes``'s K1 inputs to K1's plain version
    (on the card) inside the block; the other routes stay as they are."""
    from gfx_ocean_tpu_torch.ops import fused_step

    saved = fused_step.packed_planes

    def planes(inputs, ts, config):
        if isinstance(inputs, fused_step.PackedInputs):
            return fused_step.packed_planes_reference(inputs, ts, config)
        return saved(inputs, ts, config)

    fused_step.packed_planes = planes
    try:
        yield
    finally:
        fused_step.packed_planes = saved


def run_cascades(dev) -> dict:
    """Phases 27-34: config 4 of benchmarks/run_all.py (three 512^2 cascades
    with foam) through K1's cascade axis, the per-cascade routes (K2 + K3 at
    1024^2, K4 at 512^2), the composited 1200x700 frame (K1 -> K7 -> K8),
    sample_surface and a checkpoint; returns the fields it adds to K1t's
    kernels entry (config 4 runs at the default "bf16x3": K1's tiered
    body)."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch import checkpoint, query
    from gfx_ocean_tpu_torch.golden.reference import golden_fields
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops import unpacked_step as us
    from gfx_ocean_tpu_torch.ops.derived import checksums_of_planes, finite_difference_normals_planes
    from gfx_ocean_tpu_torch.ops.fft import kernel_passes, kernel_tier, table_slots
    from gfx_ocean_tpu_torch.render import raster as rr
    from gfx_ocean_tpu_torch.render.camera import Camera
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np

    torch.cuda.empty_cache()
    cc = C_CASCADES
    cfg = ot.OceanConfig(resolution=N, num_cascades=cc, compute_foam=True, fft_impl="pallas")
    counters = ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8")
    reset, launches = reset_launches, launch_counts

    def state_at(n: int, cascades: int = cc):
        return ot.ocean_state_from_phillips(
            dataclasses.replace(cfg, resolution=n, num_cascades=cascades), ot.PhillipsConfig(),
            generator=torch.Generator().manual_seed(0), device=dev)

    def summands_of(planes):
        """Sum of |summands| of each frame's checksum, (tb, C, 3, N, N) planes."""
        return (planes.abs().sum(dim=(-4, -3, -2, -1))
                + finite_difference_normals_planes(planes[:, :, 1], cfg.normal_height_scale)
                .abs().sum(dim=(-4, -3, -2, -1)))

    # --- 27. state ----------------------------------------------------------
    t0 = time.perf_counter()
    state = state_at(N)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cascade0_is_single = bool(torch.equal(state.h0[0], state_at(N, 1).h0))
    phase("cascade_state", source="phillips synthesize, torch.Generator seed 0, cascade c "
          "the c-th draw", resolution=N, cascades=cc, domains=list(cfg.domains),
          h0_shape=list(state.h0.shape), omega_shape=list(state.omega.shape), seconds=seconds,
          h0_absmax=[float(h.abs().max()) for h in state.h0],
          omega_max=[float(o.max()) for o in state.omega],
          cascade0_equals_single_cascade_state=cascade0_is_single)
    if tuple(state.h0.shape) != (cc, 2, N, N) or not cascade0_is_single:
        fail(f"cascade state: shape {tuple(state.h0.shape)}, cascade 0 equals the "
             f"single-cascade state {cascade0_is_single}")

    # --- 28. K1 on the cascade axis against the plain version --------------
    inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
    ts_cmp = torch.tensor(T_COMPARE, dtype=torch.float32, device=dev)
    reset()
    planes, partials = fused_step.launch_packed_step(inputs, ts_cmp, cfg, checksum=True)
    one_launch = launches()["k1"]
    want = fused_step.packed_planes_reference(inputs, ts_cmp, cfg)
    torch.cuda.synchronize()
    k1_err = max_err(planes.transpose(0, 1), want)
    singles_differ = 0
    for c in range(cc):
        one = fused_step.hoist_packed(state.h0[c], state.omega[c], cfg)
        singles_differ += int((fused_step.launch_packed_step(one, ts_cmp, cfg, checksum=False)[0]
                               != planes[c]).sum())
    summands = summands_of(want)
    ck_rel = float(((partials.sum(dim=(0, 2)) - checksums_of_planes(want, cfg)).abs()
                    / summands).max())
    tol = kernel_tol(cfg.matmul_precision)  # the tiered body at the default "bf16x3"
    phase("cascade_kernel_vs_plain", cascades=cc, frames=list(T_COMPARE),
          launches_for_the_call=one_launch, planes_max_abs=k1_err[0], planes_rel=k1_err[1],
          values_differing_from_single_cascade_launches=singles_differ,
          checksum_rel_to_summands=ck_rel, tolerance=tol,
          checksum_tolerance=TOL_CHECKSUM)
    del planes, partials, want
    if one_launch != 1:
        fail(f"K1 took {one_launch} launches for {cc} cascades, expected 1")
    if not (k1_err[1] <= tol):
        fail(f"K1 on cascades vs plain: {k1_err[1]:.3e} > {tol}")
    if singles_differ:
        fail(f"K1 on cascades differs from single-cascade launches in {singles_differ} values")
    if not (ck_rel <= TOL_CHECKSUM):
        fail(f"K1 cascade checksums vs plain: {ck_rel:.3e} > {TOL_CHECKSUM}")

    ts_tb = torch.arange(TIME_BATCH, dtype=torch.float32, device=dev) / 60.0
    k1c = dict(
        kernel_ms=event_ms(lambda: fused_step.packed_checksums(inputs, ts_tb, cfg), TIMING_CALLS),
        plain_ms=event_ms(lambda: fused_step.packed_checksums_reference(inputs, ts_tb, cfg),
                          TIMING_CALLS // 5))
    spectra = torch.randn((cc * TIME_BATCH, 2, N, N), dtype=torch.complex64, device=dev)
    k1c["library_ifft2_ms"] = event_ms(lambda: torch.fft.ifft2(spectra), TIMING_CALLS)
    del spectra
    k1c["device_ms"] = kernel_device_ms(lambda: fused_step.packed_checksums(inputs, ts_tb, cfg),
                                        body_kernels(cfg.matmul_precision, K1_KERNELS,
                                                     K1T_KERNELS), TIMING_CALLS)
    # config 4 runs K1's tiered body at the default "bf16x3": 3 passes of
    # 28 N^3 a frame on the tensor cores, the table's slots read
    passes = kernel_passes(cfg.matmul_precision)
    frag = table_slots(("alt", N, 1, 0, False), dev, kernel_tier(cfg.matmul_precision))
    k1c_bound = bound(nbytes(state.h0, state.omega, frag, ts_tb)
                      + 4 * cc * TIME_BATCH * (3 * N * N + N // fused_step.CHECKSUM_ROWS),
                      passes * 28.0 * N ** 3 * cc * TIME_BATCH, BF16_OPS_PER_S)
    phase("cascade_time_one_call", cascades=cc, frames=TIME_BATCH, calls=TIMING_CALLS,
          library=f"torch.fft.ifft2 of ({cc * TIME_BATCH}, 2, {N}, {N}) c64",
          clock="cuda events; device_ms: torch.profiler, K1's launches only", **k1c, **k1c_bound)

    # --- 29. every cascade against the golden model ----------------------------
    fields = ot.make_step(cfg)(state, T_CHECK)
    disp = fields.displacement.cpu().numpy()
    h0_np, om_np = state.h0.cpu().numpy(), state.omega.cpu().numpy()
    per_cascade = []
    for c in range(cc):
        gold = golden_fields(from_pair_np(h0_np[c]), om_np[c], T_CHECK, cfg.domain_size,
                             cfg.compat)
        abs_linf = float(np.abs(disp[c] - gold).max())
        per_cascade.append(dict(cascade=c, domain=cfg.domains[c], abs_linf=abs_linf,
                                rel_linf=abs_linf / float(np.abs(gold).max()),
                                foam_fraction=float(fields.foam[c].mean())))
    shapes = [list(fields.displacement.shape), list(fields.normals.shape), list(fields.foam.shape)]
    finite = bool(np.isfinite(disp).all()) and bool(torch.isfinite(fields.normals).all())
    phase("cascade_golden", t=T_CHECK, shapes=shapes, finite=finite, cascades=per_cascade,
          golden=f"float64 per cascade at domain_size {cfg.domain_size} (the propagate's; "
          "k-hat is scale-free)", gate="rel_linf", gate_limit=GOLDEN_GATE)
    del fields, disp
    if shapes != [[cc, N, N, 3], [cc, N, N, 3], [cc, N, N]] or not finite:
        fail(f"cascade step: shapes {shapes}, finite {finite}")
    for rec in per_cascade:
        if not (rec["rel_linf"] <= GOLDEN_GATE):
            fail(f"cascade {rec['cascade']} golden gate: {rec['rel_linf']:.3e} > {GOLDEN_GATE}")

    # --- 30. the 200-frame checksum rollout through K1 -----------------------
    rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=1)
    ts = torch.arange(C_STEPS, dtype=torch.float32, device=dev) / 60.0
    reset()
    cks = rollout(state, ts)
    torch.cuda.synchronize()
    roll_launches = launches()
    repeats_ms = []
    for _ in range(C_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rollout(state, ts)
        end.record()
        end.synchronize()
        repeats_ms.append(start.elapsed_time(end))
    with plain_k1():
        plain_cks = rollout(state, ts)
        plain_ms = event_ms(lambda: rollout(state, ts), 1)
    # Foam texels within float32 rounding of the threshold may flip between
    # the kernel's fields and the plain version's: each moves a checksum by 1.
    kept = ot.make_rollout(cfg, keep_fields=True, time_batch=1)(state, ts)
    with plain_k1():
        kept_plain = ot.make_rollout(cfg, keep_fields=True, time_batch=1)(state, ts)
    foam_flips = (kept.foam != kept_plain.foam).sum(dim=(-3, -2, -1)).double()
    roll_summands = (kept.displacement.abs().sum(dim=(-4, -3, -2, -1))
                     + kept.normals.abs().sum(dim=(-4, -3, -2, -1))
                     + kept.foam.sum(dim=(-3, -2, -1))).double()
    del kept, kept_plain
    ck_diff = (cks.double() - plain_cks.double()).abs()
    ck_excess = float((ck_diff - TOL_CHECKSUM * roll_summands - foam_flips).max())
    median_ms = float(np.median(repeats_ms))
    phase("cascade_rollout", steps=C_STEPS, time_batch=1, repeats=C_REPEATS,
          clock="cuda events", repeats_ms=repeats_ms, median_ms=median_ms,
          steps_per_sec=C_STEPS / median_ms * 1e3,
          spread=(max(repeats_ms) - min(repeats_ms)) / median_ms,
          plain_steps_per_sec=C_STEPS / plain_ms * 1e3, launches=roll_launches,
          checksums_finite=bool(torch.isfinite(cks).all()),
          checksum_max_abs_diff_vs_plain=float(ck_diff.max()),
          foam_texels_flipped_vs_plain=int(foam_flips.sum()),
          checksum_excess_over_limit=ck_excess, checksum_limit="TOL_CHECKSUM x summands "
          "+ flipped foam texels",
          checksum_first=float(cks[0]), checksum_last=float(cks[-1]))
    if roll_launches != dict({k: 0 for k in counters}, k1=C_STEPS):
        fail(f"the cascade rollout launched {roll_launches}, expected {C_STEPS} of K1")
    if cks.shape != (C_STEPS,) or not bool(torch.isfinite(cks).all()):
        fail(f"cascade rollout checksums: shape {tuple(cks.shape)}, "
             f"finite {bool(torch.isfinite(cks).all())}")
    if not (ck_excess <= 0.0):
        fail(f"cascade rollout checksums exceed the plain version's bound by {ck_excess:.3e}")

    # --- 31. the routes without a cascade axis: K2 + K3 and K4 a cascade a call
    routes = {}
    for name, rcfg, rstate, ts_r in (
            ("k2+k3", dataclasses.replace(cfg, resolution=C_FS_N, compute_foam=False),
             state_at(C_FS_N), ts_cmp[:2]),
            ("k4", dataclasses.replace(cfg, hermitian_pack=False, compute_foam=False), state,
             ts_cmp)):
        rin = fused_step.hoist_packed(rstate.h0, rstate.omega, rcfg)
        reset()
        got = fused_step.packed_planes(rin, ts_r, rcfg)
        got_ck = fused_step.packed_checksums(rin, ts_r, rcfg)
        route_launches = launches()
        plain = (fs.fourstep_planes_reference if name == "k2+k3"
                 else us.unpacked_planes_reference)
        want = torch.stack([plain(i, ts_r, rcfg) for i in rin.per_cascade], dim=1)
        torch.cuda.synchronize()
        err = max_err(got, want)
        rel_ck = float(((got_ck - checksums_of_planes(want, rcfg)).abs()
                        / summands_of(want)).max())
        routes[name] = dict(resolution=rcfg.resolution, frames=int(ts_r.shape[0]),
                            planes_max_abs=err[0], planes_rel=err[1],
                            checksum_rel_to_summands=rel_ck, launches=route_launches)
        del rin, got, want
        torch.cuda.empty_cache()
    # K2 + K3 and K4 run their tiered bodies at the default "bf16x3"
    tols = {"k2+k3": kernel_tol(cfg.matmul_precision), "k4": kernel_tol(cfg.matmul_precision)}
    phase("cascade_routes", cascades=cc, routes=routes, tolerance=tols,
          checksum_tolerance=TOL_CHECKSUM)
    expected_routes = {"k2+k3": dict(k2=2 * cc, k3=2 * cc), "k4": dict(k4=2 * cc)}
    for name, rec in routes.items():
        if not (rec["planes_rel"] <= tols[name] and rec["checksum_rel_to_summands"]
                <= TOL_CHECKSUM):
            fail(f"cascade route {name} vs plain: {rec}")
        want_launches = dict({k: 0 for k in counters}, **expected_routes[name])
        if rec["launches"] != want_launches:
            fail(f"cascade route {name} launched {rec['launches']}, expected {want_launches}")

    # --- 32. the composited 1200x700 frame with foam ---------------------------
    cam = Camera()
    vp = rr._view_proj(cam, R_W, R_H, dev)
    cp = torch.tensor(cam.position.astype(np.float32), device=dev)
    fr = rr.make_frame_renderer(cfg, R_W, R_H, R_GIANTS, diag=True)
    fr(state, R_T, vp, cp)                  # eager; it captures the stages' CUDA graphs
    frame, dropped = fr(state, R_T, vp, cp)
    with plain_raster():                    # a new renderer: its first frame is eager
        plain_frame, plain_dropped = rr.make_frame_renderer(cfg, R_W, R_H, R_GIANTS, diag=True)(
            state, R_T, vp, cp)
    step_cfg = dataclasses.replace(cfg, compute_normals=False)
    fields = ot.step(state, R_T, step_cfg)
    disp, foam = fields.displacement, fields.foam
    tiles, interp = rr._cascade_setup(disp, cfg.domains, cfg.mesh_resolution, dev)
    positions, uvs, tris = rr._mesh_constants(cfg.mesh_resolution, cfg.num_patches, dev)
    grid_shape = (cfg.num_patches, cfg.mesh_resolution)
    pool = rr._auto_pool(R_W, R_H)
    tabs = rr._slot_tables(disp, positions, uvs, tris, vp, R_W, R_H, pool, interp, grid_shape,
                           tiles=tiles)
    n_oct = tabs.octs_w * tabs.octs_h
    cov = rr._stage_scalars(tabs.total_covered, 0, dev)
    slot_args = (tabs.crow, cov, R_W, R_H, tabs.octs_w, n_oct, 32 - tabs.id_bits, tabs.id_bits)
    keys, octs = rr.launch_slot_kernel(*slot_args)
    want_keys, want_octs = rr.slot_stage_reference(*slot_args)
    so, sk = rr._oct_sort(keys, octs, n_oct)
    mins, skey = rr.launch_segmin_kernel(so, sk, n_oct, tabs.id_bits)
    want_mins, want_skey = rr.segmin_stage_reference(so, sk, n_oct, tabs.id_bits)
    torch.cuda.synchronize()
    scales = (float(cfg.height_div), float(cfg.horiz_div), float(cfg.normal_height_scale),
              float(cfg.pbr_roughness))
    img, depth = rr._rasterize_pool(disp, positions, uvs, tris, vp, cp, R_W, R_H, pool, R_GIANTS,
                                    interp, grid_shape, foam, 1, scales, tiles)
    overflow, demand = rr.pool_overflow(disp, positions, uvs, tris, vp, R_W, R_H,
                                        return_demand=True, tiles=tiles)
    rec = dict(k7_keys_differ=key_err(keys, want_keys)[0],
               k7_octs_differ=int((octs != want_octs).sum()),
               k8_mins_differ=key_err(mins, want_mins)[0],
               k8_skey_differ=int((skey != want_skey).sum()),
               frame_differ_vs_plain=int((frame != plain_frame).sum()),
               frame_differ_vs_render_pool=int((frame != rr.srgb8(img)).sum()))
    drops = dict(frame=int(dropped), plain=int(plain_dropped))
    del keys, octs, want_keys, want_octs, so, sk, mins, skey, want_mins, want_skey, img
    frame_ms = event_ms(lambda: fr(state, R_T, vp, cp), R_TIMING_CALLS)
    prof = device_profile(lambda: [fr(state, R_T + i / 60.0, vp, cp)
                                   for i in range(R_PROFILE_FRAMES)], R_PROFILE_FRAMES)
    phase("cascade_render", width=R_W, height=R_H, t=R_T, tiles=list(tiles),
          shape=list(frame.shape), dtype=str(frame.dtype),
          coverage=float(torch.isfinite(depth).float().mean()), pool=pool,
          covered_slots=int(tabs.total_covered), pool_overflow=overflow, slot_demand=demand,
          giants=R_GIANTS, giant_groups=giant_groups(tabs),
          dropped=drops, foam_fraction=[float(f.mean()) for f in foam], clock="cuda events",
          frame_ms=frame_ms, device_busy_ms_per_frame=prof["device_busy_ms"] / R_PROFILE_FRAMES,
          profile=prof, **rec)
    del disp, foam, fields, depth, tabs
    if tuple(frame.shape) != (R_H, R_W, 3) or frame.dtype != torch.uint8:
        fail(f"cascade frame: shape {tuple(frame.shape)}, {frame.dtype}")
    if any(rec.values()):
        fail(f"cascade frame: K7 / K8 or the frame differ from their plain versions: {rec}")
    if drops["frame"] or drops["plain"]:
        fail(f"cascade frame: giant-pass candidates dropped: {drops}")

    # --- 33. the main path: the rollout and frames, with every launch count --
    reset_launches()
    t0 = time.perf_counter()
    rollout(state, ts).cpu()
    roll_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(C_FRAMES):
        fr(state, R_T + i / 60.0, vp, cp)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / C_FRAMES
    main_launches = launches()
    k1t_launches = launch_count("k1", "tiered_launches")
    expected = dict({k: 0 for k in counters}, k1=C_STEPS + C_FRAMES, k7=C_FRAMES, k8=C_FRAMES)
    phase("cascade_main_path", steps=C_STEPS, frames=C_FRAMES, rollout_seconds=roll_s,
          frame_wall_ms=wall_ms, launches=main_launches, k1t_launches=k1t_launches,
          expected_launches=expected)
    if main_launches != expected or k1t_launches != C_STEPS + C_FRAMES:
        fail(f"the cascade main path launched {main_launches} ({k1t_launches} of K1t), "
             f"expected {expected}, all of K1's through K1t")

    # --- 34. sample_surface on the card against the CPU; a checkpoint ---------
    disp = ot.step(state, T_CHECK, step_cfg).displacement
    rng = np.random.default_rng(0)
    span = float(cfg.mesh_resolution - 1) * cfg.num_patches
    x = rng.uniform(0.0, span, C_QUERY_POINTS).astype(np.float32)
    z = rng.uniform(0.0, span, C_QUERY_POINTS).astype(np.float32)
    on_card = query.sample_surface(disp, torch.from_numpy(x).to(dev), torch.from_numpy(z).to(dev),
                                   tiles=tiles)
    on_cpu = query.sample_surface(disp.cpu(), x, z, tiles=tiles)
    q_err = {k: float((getattr(on_card, k).cpu() - getattr(on_cpu, k)).abs().max())
             for k in C_QUERY_TOL}
    q_dev = str(on_card.height.device)
    ck_dir = Path(__file__).resolve().parent / "build" / "smoke"
    ck_dir.mkdir(parents=True, exist_ok=True)
    path = checkpoint.save_checkpoint(str(ck_dir / "cascades"), state, T_CHECK, cfg)
    loaded, t_loaded, cfg_loaded = checkpoint.load_checkpoint(path, device=dev)
    round_trip = dict(h0_equal=bool(torch.equal(loaded.h0, state.h0)),
                      omega_equal=bool(torch.equal(loaded.omega, state.omega)),
                      t_equal=t_loaded == T_CHECK, config_equal=cfg_loaded == cfg,
                      on_card=loaded.h0.is_cuda, path_suffix=path.endswith(".npz"))
    os.unlink(path)
    phase("cascade_query_checkpoint", points=C_QUERY_POINTS, tiles=list(tiles), device=q_dev,
          card_vs_cpu_max_abs=q_err, tolerance=C_QUERY_TOL,
          finite=bool(torch.isfinite(on_card.height).all()), checkpoint=round_trip)
    if q_dev == "cpu" or any(not (q_err[k] <= C_QUERY_TOL[k]) for k in C_QUERY_TOL):
        fail(f"sample_surface on the card vs the CPU: {q_err} (on {q_dev})")
    if not all(round_trip.values()):
        fail(f"checkpoint round trip on the card: {round_trip}")

    return {
        "cascade_config": "benchmarks/run_all.py config 4: 3 x 512^2, foam, fft_impl pallas",
        "cascade_launches": k1t_launches,
        "cascade_max_abs_err": k1_err[0],
        "cascade_frames_a_call": cc * TIME_BATCH,
        "cascade_ms": k1c["kernel_ms"],
        "cascade_device_ms": k1c["device_ms"]["total"],
        "cascade_plain_ms": k1c["plain_ms"],
        "cascade_bound_ms": k1c_bound["bound_ms"],
        "cascade_bound_by": k1c_bound["bound_by"],
        "cascade_library_ms": k1c["library_ifft2_ms"],
    }


def run_derived(dev) -> dict:
    """Phase 53 (after 34): K10 at ocean512_cascades.rollout's shapes
    against its plain version, its time against its bound, and the
    cell's rollout through it; returns K10's entry of the kernels line."""
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.ops import derived, fused_step
    from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
    from portbench.roofline_derived import derived_bound

    torch.cuda.empty_cache()
    cc, tb = C_CASCADES, D_TIME_BATCH
    cfg = ot.OceanConfig(resolution=N, num_cascades=cc, compute_foam=True, fft_impl="pallas")
    doms = cfg.domains
    state = ot.ocean_state_from_phillips(cfg, ot.PhillipsConfig(),
                                         generator=torch.Generator().manual_seed(0), device=dev)
    inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
    ts = torch.arange(tb, dtype=torch.float32, device=dev) / 60.0 + T_CHECK
    planes = fused_step.packed_planes(inputs, ts, cfg)  # (tb, C, 3, N, N), cascade-major
    want = derived.derived_checksums_reference(planes, cfg, doms)
    want_texels = derived.foam_of(torch.movedim(planes, -3, -1), cfg, doms).sum(dim=(-2, -1))
    summands = (planes.abs().sum(dim=(-4, -3, -2, -1))
                + finite_difference_normals_planes(planes[:, :, 1], cfg.normal_height_scale)
                .abs().sum(dim=(-4, -3, -2, -1)) + want_texels.sum(dim=-1)).double()
    plain_ms = event_ms(lambda: derived.derived_checksums_reference(planes, cfg, doms),
                        D_PLAIN_CALLS)
    b = derived_bound({"ocean": {"resolution": N, "num_cascades": cc, "compute_normals": True,
                                 "compute_foam": True}})
    call_bound = bound(b["bytes"] * tb, b["flops"] * tb)
    rec, failures = {}, []
    for name, p in (("cascade_major", planes), ("frame_major", planes.contiguous())):
        _, counts = derived.launch_derived_partials(p, cfg, doms)
        got = derived.derived_checksums(p, cfg, doms)
        texels = counts.sum(dim=-1).double()
        rel = float(((got.double() - want.double()).abs() / summands).max())
        ms = event_ms(lambda: derived.derived_checksums(p, cfg, doms), D_CALLS)
        device = kernel_device_ms(lambda: derived.launch_derived_partials(p, cfg, doms),
                                  K10_KERNELS, D_CALLS)
        rec[name] = dict(strides=list(p.stride()), foam_texels_equal=bool(
            torch.equal(texels, want_texels.double())), foam_texels=int(texels.sum()),
            checksum_rel_to_summands=rel, ms=ms, device_ms=device["total"],
            share_of_bound=call_bound["bound_ms"] / device["total"])
        if not rec[name]["foam_texels_equal"] or not rel <= TOL_CHECKSUM:
            failures.append(f"K10 on {name} planes: {rec[name]}")
    del planes, want, want_texels, summands

    rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=tb)
    steps = torch.arange(C_STEPS, dtype=torch.float32, device=dev) / 60.0
    rollout(state, steps)
    reset_launches()
    t0 = time.perf_counter()
    cks = rollout(state, steps).cpu()
    roll_s = time.perf_counter() - t0
    counts = dict(k1=launch_count("k1"), k10=launch_count("k10"))
    expected = dict(k1=C_STEPS // tb, k10=C_STEPS // tb)
    phase("derived_kernel", cascades=cc, frames=tb, domains=list(doms), t0=T_CHECK,
          clock="cuda events (ms, a call); device_ms: torch.profiler, K10's launch only",
          layouts=rec, plain_ms=plain_ms, tolerance=TOL_CHECKSUM, bound=call_bound,
          bound_a_frame_ms=b["seconds"] * 1e3,
          rollout=dict(steps=C_STEPS, time_batch=tb, seconds=roll_s,
                       steps_per_sec=C_STEPS / roll_s, launches=counts,
                       checksums_finite=bool(torch.isfinite(cks).all())))
    if counts != expected or not bool(torch.isfinite(cks).all()):
        failures.append(f"the cascade rollout launched {counts}, expected {expected}")
    if failures:
        fail(f"derived_kernel: {failures}")
    r = rec["cascade_major"]
    return {
        "name": "K10 derived_partials (a foam rollout's derived stage: planes, normals and "
                "each cascade's Jacobian foam summed in one launch)",
        "route": "cuda", "source": "gfx_ocean_tpu_torch/csrc/derived.cu",
        "replaces": "models/ocean.py's eager chain of normals, foam and sums "
                    "(no TPU kernel: jnp ops)",
        "launches": counts["k10"], "max_abs_err": None, "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": plain_ms, **call_bound, "library_ms": None,
    }


# Each kernel wrapper by its kernel's key.
WRAPPERS = dict(k1="launch_packed_step", k2="launch_fourstep_row", k3="launch_fourstep_col",
                k4="launch_unpacked_step", k5="launch_unpacked_rows", k6="launch_unpacked_cols",
                k7="launch_slot_kernel", k8="launch_segmin_kernel", k9="launch_giant_kernel",
                k10="launch_derived_partials")
# The recorder's table (``utils/profiling.tallies``) at the last
# ``reset_launches()``: the launch counts read from there.
_LAUNCH_ZERO: dict = {}


def reset_launches() -> None:
    """Every wrapper's launch counts, the tiered bodies' too, to 0."""
    from gfx_ocean_tpu_torch.utils import profiling

    global _LAUNCH_ZERO
    _LAUNCH_ZERO = profiling.tallies()


def launch_count(key: str, kind: str = "launches") -> int:
    """``<kind>.<wrapper>`` of the kernel ``key`` (``WRAPPERS``) since the
    last ``reset_launches()``; ``kind`` "tiered_launches" counts the tiered
    body's."""
    from gfx_ocean_tpu_torch.utils import profiling

    name = f"{kind}.{WRAPPERS[key]}"
    return profiling.tallies().get(name, 0) - _LAUNCH_ZERO.get(name, 0)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, K1-K8."""
    return {k: launch_count(k) for k in ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8")}


def launched_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a ``launch_counts()``), by count."""
    return {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}


def cli(argv) -> tuple:
    """``gfx_ocean_tpu_torch.cli.main(argv)`` in this process with its
    stdout captured: (stdout, the kernels it launched)."""
    import contextlib
    import io

    from gfx_ocean_tpu_torch import cli as port_cli

    before = launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli.main(argv)
    if rc != 0:
        fail(f"cli {argv[0]} exited {rc}")
    return out.getvalue(), launched_since(before)


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def run_cli(dev) -> None:
    """Phase 35: the CLI's subcommands in this process, each with the
    kernels it launched, against the direct API on the same state."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.render.camera import Camera, perspective, scripted_camera
    from gfx_ocean_tpu_torch.render.raster import make_batch_renderer
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    work = Path(__file__).resolve().parent / "build" / "smoke" / "cli"
    work.mkdir(parents=True, exist_ok=True)
    sp, op = str(work / "spectrum.bin"), str(work / "omega.bin")
    files = ["--resolution", str(N), "--spectrum", sp, "--omega", op]
    rec = {}

    out, launched = cli(["info", *files[:2], "--phillips"])
    info = json.loads(out)
    rec["info"] = dict(devices=info["devices"], launches=launched)
    if not info["devices"] or kind not in info["devices"][0]:
        fail(f"cli info: devices {info['devices']} do not name the card {kind}")

    _, launched = cli(["synth", "--resolution", str(N), "--out-spectrum", sp, "--out-omega", op])
    rec["synth"] = dict(files=[os.path.getsize(sp), os.path.getsize(op)], launches=launched)

    # simulate through K1 against make_rollout through K1 on the same state
    out, launched = cli(["simulate", *files, "--fft-impl", "pallas", "--steps", str(CLI_STEPS)])
    got = np.array(last_json(out)["checksums_head"])
    cfg = ot.OceanConfig(resolution=N, fft_impl="pallas")
    state = ot.ocean_state_from_assets(sp, op, resolution=None, device=dev)
    ts = np.arange(CLI_STEPS, dtype=np.float32) * (1 / 60)
    want = ot.make_rollout(cfg, keep_fields=False)(state, ts)[:5].cpu().numpy()
    rec["simulate_pallas"] = dict(checksums_head=got.tolist(), launches=launched,
                                  equal_to_make_rollout=bool(np.array_equal(got, want)))
    if launched != {"k1": CLI_STEPS} or not np.array_equal(got, want):
        fail(f"cli simulate --fft-impl pallas: {rec['simulate_pallas']}, make_rollout {want}")

    out, launched = cli(["simulate", *files, "--fft-impl", "pallas", "--no-pack", "--steps",
                         str(CLI_CHECK_STEPS)])
    unpacked = np.array(last_json(out)["checksums_head"])
    rel = float((np.abs(unpacked - got) / np.abs(got)).max())
    rec["simulate_unpacked"] = dict(launches=launched, rel_to_packed=rel)
    if launched != {"k4": CLI_CHECK_STEPS} or not (rel <= CLI_XLA_TOL):
        fail(f"cli simulate --no-pack: {rec['simulate_unpacked']}")

    out, launched = cli(["simulate", *files, "--fft-impl", "xla", "--steps", str(CLI_STEPS)])
    xla = np.array(last_json(out)["checksums_head"])
    rel = float((np.abs(xla - got) / np.abs(got)).max())
    rec["simulate_xla"] = dict(launches=launched, rel_to_pallas=rel, tolerance=CLI_XLA_TOL)
    if launched or not (rel <= CLI_XLA_TOL):
        fail(f"cli simulate --fft-impl xla: {rec['simulate_xla']}")

    ck = str(work / "state.npz")
    _, launched_sim = cli(["simulate", *files, "--fft-impl", "pallas", "--steps",
                           str(CLI_CHECK_STEPS), "--checkpoint", ck])
    out, launched = cli(["query", *CLI_QUERY_POINTS, "--resume", ck])
    samples = json.loads(out)["samples"]
    normals = np.array([s["normal"] for s in samples])
    rec["checkpoint_query"] = dict(
        t=json.loads(out)["t"], heights=[s["height"] for s in samples],
        launches_simulate=launched_sim, launches_query=launched,
        normals_unit_max_err=float(np.abs(np.linalg.norm(normals, axis=1) - 1).max()))
    if (launched != {"k1": 1} or not np.isfinite([s["height"] for s in samples]).all()
            or rec["checkpoint_query"]["normals_unit_max_err"] > 1e-5):
        fail(f"cli simulate --checkpoint / query --resume: {rec['checkpoint_query']}")
    os.unlink(ck)

    # bench at 512^2 and at config 5, beside phases 7 and 12's direct rollouts;
    # at 512^2 (host-bound) also beside the direct rollout of this state just
    # before and just after it
    ts_dev = torch.arange(STEPS, dtype=torch.float32, device=dev) / 60.0
    direct_now = [time_rollout(ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH),
                               state, ts_dev, repeats=REPEATS)]
    out, launched = cli(["bench", *files, "--fft-impl", "pallas", "--time-batch", str(TIME_BATCH),
                         "--steps", str(STEPS), "--repeats", str(REPEATS)])
    direct_now.append(time_rollout(ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH),
                                   state, ts_dev, repeats=REPEATS))
    b512 = json.loads(out)
    direct = DIRECT_ROLLOUTS[(N, TIME_BATCH)]
    rec["bench_512"] = dict(steps_per_sec=b512["steps_per_sec"], repeats_sec=b512["repeats_sec"],
                            direct_steps_per_sec=direct["steps_per_sec"],
                            direct_repeats_sec=direct["repeats_sec"], direct_tier="highest",
                            adjacent_direct_steps_per_sec=[d["steps_per_sec"] for d in direct_now],
                            adjacent_direct_repeats_sec=[d["repeats_sec"] for d in direct_now],
                            launches=launched, effective_precision=b512["effective_precision"],
                            power_limit=b512.get("power_limit"))
    if launched != {"k1": (REPEATS + 1) * STEPS // TIME_BATCH} or "checksums" in b512:
        fail(f"cli bench at {N}^2: {rec['bench_512']}")
    # the "xla" route (cuFFT, no kernel of the port) at the same size: the
    # baseline, with torch.profiler's device time by op over 60 frames
    out, launched = cli(["bench", *files, "--fft-impl", "xla", "--time-batch", str(TIME_BATCH),
                         "--steps", str(STEPS), "--repeats", str(REPEATS)])
    bx = json.loads(out)
    xla_rollout = ot.make_rollout(dataclasses.replace(cfg, fft_impl="xla"), keep_fields=False,
                                  time_batch=TIME_BATCH)
    rec["bench_512_xla"] = dict(
        steps_per_sec=bx["steps_per_sec"], repeats_sec=bx["repeats_sec"], launches=launched,
        profile=device_profile(lambda: xla_rollout(state, ts_dev[:60]).cpu(), 60, top=8))
    if launched:
        fail(f"cli bench --fft-impl xla at {N}^2 launched a kernel: {rec['bench_512_xla']}")
    out, launched = cli(["bench", "--resolution", str(FS_N), "--domain-size", "2000",
                         "--precision", "high", "--fft-impl", "pallas", "--phillips",
                         "--time-batch", "4", "--steps", str(FS_STEPS),
                         "--repeats", str(FS_REPEATS)])
    b5 = json.loads(out)
    direct = DIRECT_ROLLOUTS[(FS_N, 4)]
    calls = (FS_REPEATS + 1) * FS_STEPS // 4
    rec["bench_config5"] = dict(steps_per_sec=b5["steps_per_sec"], repeats_sec=b5["repeats_sec"],
                                direct_steps_per_sec=direct["steps_per_sec"],
                                direct_repeats_sec=direct["repeats_sec"], direct_tier="highest",
                                launches=launched)
    if launched != {"k2": calls, "k3": calls}:
        fail(f"cli bench at config 5: {rec['bench_config5']}")

    # render at 1200x700 against make_batch_renderer on the same poses
    frames_dir = work / "frames"
    _, launched = cli(["render", *files, "--fft-impl", "pallas", "--width", str(R_W),
                       "--height", str(R_H), "--frames", str(CLI_RENDER_FRAMES),
                       "--out", str(frames_dir)])
    proj = perspective(R_W / R_H)
    cams = [c for _, c in scripted_camera([(CLI_RENDER_FRAMES, [])], dt=1 / 60, camera=Camera())]
    want = make_batch_renderer(cfg, R_W, R_H)(
        state, torch.tensor((np.arange(CLI_RENDER_FRAMES) / 60).astype(np.float32), device=dev),
        torch.tensor(np.stack([(proj @ c.view()).astype(np.float32) for c in cams]), device=dev),
        torch.tensor(np.stack([c.position.astype(np.float32) for c in cams]), device=dev)
    ).cpu().numpy()
    got = np.stack([np.load(frames_dir / f"frame_{i:05d}.npy")
                    for i in range(CLI_RENDER_FRAMES)])
    pngs = all((frames_dir / f"frame_{i:05d}.png").stat().st_size > 0
               for i in range(CLI_RENDER_FRAMES))
    differ = int((got != want).sum())
    rec["render"] = dict(shape=list(got.shape), differing_values=differ, pngs=pngs,
                         launches=launched)
    expected = {k: CLI_RENDER_FRAMES for k in ("k1", "k7", "k8")}
    if launched != expected or differ or not pngs:
        fail(f"cli render: {rec['render']}, expected launches {expected}")

    # python -m gfx_ocean_tpu_torch without --device: the card
    proc = subprocess.run([sys.executable, "-m", "gfx_ocean_tpu_torch", "info", *files],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        fail(f"python -m gfx_ocean_tpu_torch info exited {proc.returncode}: {proc.stderr}")
    rec["python_m_info_devices"] = json.loads(proc.stdout)["devices"]
    if kind not in rec["python_m_info_devices"][0]:
        fail(f"python -m gfx_ocean_tpu_torch info: {rec['python_m_info_devices']}")
    phase("cli", seconds=time.perf_counter() - t_start, **rec)


def http_get(url: str) -> bytes:
    """The body of a GET; any status but 200 fails the smoke."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            if r.status != 200:
                fail(f"GET {url}: HTTP {r.status}")
            return r.read()
    except urllib.error.HTTPError as e:
        fail(f"GET {url}: HTTP {e.code} {e.read()[:300]!r}")


def quantiles(xs) -> dict:
    import numpy as np

    return {"median": float(np.median(xs)), "p90": float(np.percentile(xs, 90))}


def run_serve(dev) -> None:
    """Phase 36: ``serve`` on phase 3's state in a thread: every response a
    200, ``/frame`` under the golden gate, ``/frame.png`` and the strip
    bit-equal to the direct renderers, concurrent frames equal to serial
    ones, and the served frame's latency by wall clock."""
    import concurrent.futures as cf
    import io
    import threading

    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.golden.reference import golden_fields
    from gfx_ocean_tpu_torch.render.camera import Camera, perspective
    from gfx_ocean_tpu_torch.render.raster import make_batch_renderer, make_frame_renderer
    from gfx_ocean_tpu_torch.serve import serve
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np
    from gfx_ocean_tpu_torch.utils.png import encode_png

    cfg = ot.OceanConfig(fft_impl="pallas")
    state, source = main_state(dev, cfg)
    kind = torch.cuda.get_device_name(0)
    rec = {"state": source}
    before = launch_counts()
    t0 = time.perf_counter()
    srv = serve(state, cfg, port=0)
    rec["startup"] = dict(seconds=time.perf_counter() - t0, launches=launched_since(before))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    svc = srv.service
    try:
        health = json.loads(http_get(base + "/health"))
        config = json.loads(http_get(base + "/config"))
        metrics = json.loads(http_get(base + "/metrics"))
        rec["health"] = health
        if kind not in health["device"] or config["fft_impl"] != "pallas" \
                or kind not in metrics["device"]:
            fail(f"serve: /health {health}, /config fft_impl {config['fft_impl']}, "
                 f"/metrics device {metrics['device']}")

        before = launch_counts()
        with np.load(io.BytesIO(http_get(base + f"/frame?t={T_CHECK}"))) as z:
            disp = z["displacement"]
        launched = launched_since(before)
        gold = golden_fields(from_pair_np(state.h0.cpu().numpy()), state.omega.cpu().numpy(),
                             T_CHECK, cfg.domain_size, cfg.compat)
        rel_linf = float(np.abs(disp - gold).max() / np.abs(gold).max())
        rec["frame_npz"] = dict(t=T_CHECK, rel_linf=rel_linf, gate_limit=GOLDEN_GATE,
                                launches=launched)
        if launched != {"k1": 1} or not (np.isfinite(disp).all() and rel_linf <= GOLDEN_GATE):
            fail(f"serve /frame: {rec['frame_npz']}")

        cam = Camera()
        vp = (perspective(R_W / R_H) @ cam.view()).astype(np.float32)
        cp = cam.position.astype(np.float32)
        direct = make_frame_renderer(cfg, R_W, R_H)
        before = launch_counts()
        body = http_get(base + f"/frame.png?t={T_CHECK}&w={R_W}&h={R_H}")
        launched = launched_since(before)
        want = direct(state, T_CHECK, vp, cp).cpu().numpy()
        rec["frame_png"] = dict(bytes=len(body), launches=launched,
                                equal_to_make_frame_renderer=encode_png(want) == body,
                                giant_dropped_last=svc.giant_dropped_last)
        if launched != {"k1": 1, "k7": 1, "k8": 1} or encode_png(want) != body:
            fail(f"serve /frame.png: {rec['frame_png']}")

        ticks = svc.session.advance_batch(S_STRIP_N, S_STRIP_N / 60)
        times, cams = [t for t, _ in ticks], [c for _, c in ticks]
        before = launch_counts()
        frames = svc.strip_frames(times, cams, S_STRIP_W, S_STRIP_H)
        launched = launched_since(before)
        proj = perspective(S_STRIP_W / S_STRIP_H)
        want = make_batch_renderer(cfg, S_STRIP_W, S_STRIP_H)(
            state, torch.tensor(times, dtype=torch.float32, device=dev),
            torch.tensor(np.stack([(proj @ c.view()).astype(np.float32) for c in cams]),
                         device=dev),
            torch.tensor(np.stack([c.position.astype(np.float32) for c in cams]), device=dev)
        ).cpu().numpy()
        rec["strip"] = dict(shape=list(frames.shape), launches=launched,
                            differing_values=int((frames != want).sum()))
        if launched != {k: S_STRIP_N for k in ("k1", "k7", "k8")} or rec["strip"][
                "differing_values"] or frames.shape != (S_STRIP_N, S_STRIP_H, S_STRIP_W, 3):
            fail(f"serve strip: {rec['strip']}")

        # latency of /frame.png at 1200x700, serial requests at distinct t
        wall, render, encode = [], [], []
        for i in range(S_LATENCY_REQUESTS):
            t1 = time.perf_counter()
            http_get(base + f"/frame.png?t={T_CHECK + 0.5 + i / 60}&w={R_W}&h={R_H}")
            wall.append(time.perf_counter() - t1)
            render.append(svc.last_render_sec)
            encode.append(svc.last_encode_sec)
        http = [w - r - e for w, r, e in zip(wall, render, encode)]
        rec["frame_png_latency_ms"] = {
            name: {k: v * 1e3 for k, v in quantiles(xs).items()}
            for name, xs in (("wall", wall), ("render", render), ("png_encode", encode),
                             ("http", http))}

        # 8 threads x 4 frames at distinct t against the same frames served alone
        paths = [f"/frame.png?t={T_CHECK + 1.0 + i / 60}&w={R_W}&h={R_H}"
                 for i in range(S_THREADS * S_PER_THREAD)]
        serial = [http_get(base + p) for p in paths]
        before = launch_counts()
        with cf.ThreadPoolExecutor(S_THREADS) as ex:
            concurrent = list(ex.map(lambda p: http_get(base + p), paths))
        launched = launched_since(before)
        mismatched = sum(a != b for a, b in zip(serial, concurrent))
        rec["concurrency"] = dict(threads=S_THREADS, requests=len(paths), mismatched=mismatched,
                                  distinct_frames=len(set(serial)), launches=launched)
        if mismatched or launched != {k: len(paths) for k in ("k1", "k7", "k8")}:
            fail(f"serve concurrency: {rec['concurrency']}")
        rec["metrics"] = json.loads(http_get(base + "/metrics"))
        if rec["metrics"]["errors"] or rec["metrics"]["giant_dropped_max"]:
            fail(f"serve /metrics: {rec['metrics']}")
    finally:
        srv.shutdown()
        srv.server_close()
    phase("serve", **rec)


def scheme_rel(state, cfg, tier: str, gold) -> float:
    """Relative L-inf against golden of the tier's scheme computed exactly
    on the host: the step's float32 spectra and float32 DFT tables, each
    pass's operands rounded to bf16 as the MXU's DEFAULT dot rounds them
    (the JAX package's explicit split and single pass on the TPU; "high" the
    port's 3-pass split; "highest" unrounded), products and sums in float64,
    each complex output of a transform pass rounded once to float32. What
    the tier's own arithmetic costs on these inputs, before any float32
    sum."""
    import numpy as np
    import torch

    from gfx_ocean_tpu_torch.ops import fft as tfft
    from gfx_ocean_tpu_torch.ops.propagate import precompute_propagate, propagate_planes_pre

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).double().numpy()

    def terms(a):
        a = a.astype(np.float32)
        if tier == "highest":
            return {"hi": a.astype(np.float64)}
        hi = bf16(a)
        return {"hi": hi, "lo": bf16(a.astype(np.float64) - hi)}

    passes = {"highest": (("hi", "hi"),), "default": (("hi", "hi"),),
              "high": (("hi", "hi"), ("hi", "lo"), ("lo", "hi")),
              "bf16x3": (("hi", "hi"), ("hi", "lo"), ("lo", "hi")),
              "bf16x4": (("hi", "hi"), ("hi", "lo"), ("lo", "hi"), ("lo", "lo"))}[tier]

    def mm(a, b):
        ta, tb = terms(a), terms(b)
        return sum(ta[p] @ tb[q] for p, q in passes)

    def f32(a):
        return a.astype(np.float32)

    n = state.omega.shape[-1]
    pre = precompute_propagate(state.h0.cpu(), cfg.compat)
    t = torch.full((1, 1, 1), T_CHECK, dtype=torch.float32)
    sr, si = propagate_planes_pre(pre, state.omega.cpu(), t, cfg.domain_size, cfg.compat)
    sr, si = sr[:, 0].numpy(), si[:, 0].numpy()              # (3, N, N): h, dx, dz
    wr, wi = tfft._dft_matrix_out_alt_np(n, 1, 1, False)
    cr, ci = tfft._dft_matrix_out_alt_np(n, 1, 0, cfg.compat.ref_sign)
    fields = []
    for k in range(3):
        ar, ai = f32(mm(sr[k], wr) - mm(si[k], wi)), f32(mm(sr[k], wi) + mm(si[k], wr))
        fields.append(f32(mm(cr, ar) - mm(ci, ai)))
    disp = np.stack([fields[1], fields[0], fields[2]], axis=-1)
    return float(np.abs(disp - gold).max() / np.abs(gold).max())


def run_precision_tiers(dev) -> None:
    """Phase 38: every precision tier of the matmul route on the JAX
    package's default configuration, its error against golden beside the
    JAX ceiling and beside the same scheme computed exactly on the host, a
    6-frame call and a 120-frame rollout beside FP32 ("highest");
    choppy_precision="default"; "high" and "default" at config 5."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.golden.reference import golden_fields
    from gfx_ocean_tpu_torch.ops.fft import effective_precision
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    state = STATES["main"]
    base = ot.OceanConfig()
    n = base.resolution
    gold = golden_fields(from_pair_np(state.h0.cpu().numpy()), state.omega.cpu().numpy(),
                         T_CHECK, base.domain_size, base.compat)
    scale = float(np.abs(gold).max())
    ts6 = torch.arange(TIME_BATCH, dtype=torch.float32, device=dev) / 60.0
    ts = torch.arange(TIER_STEPS, dtype=torch.float32, device=dev) / 60.0
    rec, failures = {}, []
    for tier in TIERS:
        cfg = dataclasses.replace(base, matmul_precision=tier)
        disp = ot.step(state, T_CHECK, cfg).displacement.cpu().numpy()
        err = np.abs(disp - gold)
        rel = float(err.max()) / scale
        roll6 = ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH)
        roll = time_rollout(roll6, state, ts, repeats=3)
        own = scheme_rel(state, cfg, tier, gold)
        # Two-sided: the card's error is its scheme's, give or take the
        # float32 sums, so a tier that ran another scheme (FP32, or bf16x3
        # and bf16x4 swapped) fails. Where the scheme itself meets the JAX
        # figure, so must the card; where it cannot, the scheme bounds (D4).
        band = FP32_SUM_ALLOWANCE + DEFAULT_REROUND * own * (tier == "default")
        limit = TIER_CEILING[tier] if own <= TIER_CEILING[tier] else own + band
        rec[tier] = dict(
            rel_linf=rel, abs_linf=float(err.max()),
            rel_linf_by_field={f: float(err[..., i].max()) / scale
                               for i, f in enumerate(("disp_x", "height", "disp_z"))},
            jax_ceiling=TIER_CEILING[tier], ceiling_met=rel <= TIER_CEILING[tier],
            scheme_rel_linf=own, scheme_band=band, limit=limit,
            effective_precision=effective_precision(tier, n, cfg.direct_dft_max, "matmul"),
            call_ms=event_ms(lambda: roll6(state, ts6), TIER_CALLS),
            steps_per_sec=roll["steps_per_sec"],
            checksums_finite=bool(np.isfinite(roll["checksums"]).all()))
        if not (np.isfinite(disp).all() and rel <= limit and abs(rel - own) <= band
                and rec[tier]["checksums_finite"]):
            failures.append(f"{tier}: rel L-inf {rel:.3e}, limit {limit:.3e}, its exact "
                            f"scheme {own:.3e} +- {band:.3e}")
        if not (rel <= (DEFAULT_GATE if tier == "default" else GOLDEN_GATE)):
            failures.append(f"{tier}: rel L-inf {rel:.3e} past the gate")
    fp32 = rec["highest"]
    for tier in TIERS:
        rec[tier]["call_vs_highest"] = rec[tier]["call_ms"] / fp32["call_ms"]
        rec[tier]["steps_per_sec_vs_highest"] = rec[tier]["steps_per_sec"] / fp32["steps_per_sec"]

    # choppy_precision="default" under "bf16x3": the height keeps its tier.
    cfg = dataclasses.replace(base, choppy_precision="default")
    disp = ot.step(state, T_CHECK, cfg).displacement.cpu().numpy()
    split = ot.step(state, T_CHECK, base).displacement.cpu().numpy()
    choppy = dict(height_rel_linf=float(np.abs(disp[..., 1] - gold[..., 1]).max()) / scale,
                  choppy_rel_linf=float(np.abs(disp[..., ::2] - gold[..., ::2]).max()) / scale,
                  height_equals_bf16x3=bool(np.array_equal(disp[..., 1], split[..., 1])))
    roll6 = ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH)
    choppy.update(call_ms=event_ms(lambda: roll6(state, ts6), TIER_CALLS),
                  steps_per_sec=time_rollout(roll6, state, ts, repeats=3)["steps_per_sec"])
    if not (choppy["height_rel_linf"] <= GOLDEN_GATE and choppy["height_equals_bf16x3"]
            and choppy["choppy_rel_linf"] <= DEFAULT_GATE):
        failures.append(f"choppy_precision='default': {choppy}")

    # Config 5 (4096^2) on the matmul route: "high" and "default", FP32 beside.
    big_state, big_gold = STATES["fourstep"], STATES["fourstep_golden"]
    big_scale = float(np.abs(big_gold).max())
    big = {}
    ts_big = torch.arange(TIER_BIG_FRAMES, dtype=torch.float32, device=dev) / 60.0
    for tier, gate in (("high", GOLDEN_GATE), ("default", DEFAULT_GATE), ("highest", GOLDEN_GATE)):
        cfg = ot.OceanConfig(resolution=FS_N, domain_size=2000.0, matmul_precision=tier)
        disp = ot.step(big_state, T_CHECK, cfg).displacement.cpu().numpy()
        err = float(np.abs(disp - big_gold).max())
        roll = time_rollout(ot.make_rollout(cfg, keep_fields=False), big_state, ts_big, repeats=3)
        big[tier] = dict(rel_linf=err / big_scale, abs_linf=err, gate=gate,
                         effective_precision=effective_precision(tier, FS_N, cfg.direct_dft_max,
                                                                 "matmul"),
                         ms_per_frame=roll["ms_per_step"], steps_per_sec=roll["steps_per_sec"])
        del disp
        if not (err / big_scale <= gate):
            failures.append(f"4096^2 {tier}: rel L-inf {err / big_scale:.3e} > {gate}")
    for tier in big:
        big[tier]["steps_per_sec_vs_highest"] = (big[tier]["steps_per_sec"]
                                                 / big["highest"]["steps_per_sec"])
    del big_gold
    torch.cuda.empty_cache()
    phase("precision_tiers", resolution=n, config="OceanConfig() (matmul, unpacked at 512)",
          t=T_CHECK, frames_a_call=TIME_BATCH, rollout_steps=TIER_STEPS, calls=TIER_CALLS,
          clock="cuda events (call), host clock over synchronized rollouts (steps/s)",
          fp32_sum_allowance=FP32_SUM_ALLOWANCE, tiers=rec, choppy_default=choppy,
          config5={"resolution": FS_N, "frames": TIER_BIG_FRAMES, "tiers": big})
    if failures:
        fail(f"precision tiers: {failures}")


def run_window_render(dev) -> None:
    """Phase 39: phase 17's 1200x700 frame through K1 and the window
    rasterizer, against the pool frame of the same state (the near-tie
    envelope, no giant candidate dropped) and the stored JAX frame;
    render_frames(impl="window") equal to render_frame; the time a frame."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.render import raster as rr
    from gfx_ocean_tpu_torch.render.camera import Camera

    cfg = ot.OceanConfig(fft_impl="pallas")
    state = STATES["render"]
    cam = Camera()
    reset_launches()
    disp = ot.step(state, R_T, dataclasses.replace(cfg, compute_normals=False)).displacement
    k1 = launch_count("k1")
    positions, uvs, tris = rr._mesh_constants(cfg.mesh_resolution, cfg.num_patches, dev)
    interp = rr._interp_matrices(cfg.mesh_resolution, R_N, dev)
    grid_shape = (cfg.num_patches, cfg.mesh_resolution)
    vp = rr._view_proj(cam, R_W, R_H, dev)
    cp = torch.tensor(cam.position.astype(np.float32), device=dev)
    args = (disp, positions, uvs, tris, vp, cp, R_W, R_H)
    win, wz, dropped = rr._rasterize(*args, W_SAMPLES, R_GIANTS, interp, grid_shape,
                                     with_diag=True)
    frame_kw = dict(width=R_W, height=R_H, giants=R_GIANTS, return_depth=True)
    rf, rfz = rr.render_frame(disp, cam, impl="window", samples=W_SAMPLES, **frame_kw)
    pool, pz = rr.render_frame(disp, cam, impl="pool", **frame_kw)
    torch.cuda.synchronize()
    a, za, b, zb = (x.cpu().numpy() for x in (pool, pz, win, wz))
    d = np.argwhere((a != b).any(-1))
    one_sided = int(sum(np.isinf(za[y, x]) != np.isinf(zb[y, x]) for y, x in d))
    both = np.isfinite(za) & np.isfinite(zb)
    quantum = 2.0 / (1 << (32 - rr._id_bits(tris.shape[0])))
    depth_max = float(np.abs(za[both] - zb[both]).max())
    score = rr._window_score(rr._tri_corners(rr._vertex_stage(disp, positions, uvs, vp,
                                                              interp)[1], tris, grid_shape),
                             R_W, R_H, W_SAMPLES * W_SAMPLES)
    rec = dict(samples=W_SAMPLES, giants=R_GIANTS, giant_candidates=int((score > 0).sum()),
               dropped=int(dropped), k1_launches=k1,
               coverage=float(np.isfinite(zb).mean()),
               render_frame_equal=bool(torch.equal(rf, win) and torch.equal(rfz, wz)),
               pixels_differing_vs_pool=len(d), one_sided_vs_pool=one_sided,
               depth_max_abs_vs_pool=depth_max, depth_limit=2 * quantum,
               limit_pixels=W_DIFF_LIMIT, limit_one_sided=W_ONE_SIDED_LIMIT)

    stored = np.load(Path(ot.__file__).resolve().parent / "golden" / "frame_jax_1200x700.npz")
    want = stored["frame"]
    got = rr.srgb8(win).cpu().numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    rec.update(jax_values_off_by_more_than_2=float((diff > 2).mean()),
               jax_pixels_differing=int((diff.max(-1) > 0).sum()),
               jax_mean_color_diff=float(np.abs(got.reshape(-1, 3).mean(0)
                                                - want.reshape(-1, 3).mean(0)).max()),
               jax_limit_off=JAX_FRAME_PIXELS_OFF, jax_limit_mean_color=JAX_FRAME_MEAN_COLOR)

    disps = ot.make_rollout(dataclasses.replace(cfg, compute_normals=False))(
        state, [R_T, R_T + 1.0 / 60.0]).displacement
    frames = rr.render_frames(disps, [cam, cam], R_W, R_H, samples=W_SAMPLES, giants=R_GIANTS,
                              impl="window")
    rec["render_frames_equal"] = all(
        torch.equal(frames[i], rr.render_frame(disps[i], cam, R_W, R_H, samples=W_SAMPLES,
                                               giants=R_GIANTS, impl="window"))
        for i in range(2))
    del frames, disps

    rec["window_frame_ms"] = event_ms(
        lambda: rr.render_frame(disp, cam, R_W, R_H, samples=W_SAMPLES, giants=R_GIANTS,
                                impl="window"), W_TIMING_CALLS)
    rec["pool_frame_ms"] = event_ms(
        lambda: rr.render_frame(disp, cam, R_W, R_H, giants=R_GIANTS), W_TIMING_CALLS)
    phase("window_render", width=R_W, height=R_H, t=R_T, clock="cuda events, render_frame "
          "of the step's displacement", timing_calls=W_TIMING_CALLS, **rec)
    if not (rec["dropped"] == 0 and rec["render_frame_equal"] and rec["render_frames_equal"]
            and k1 == 1):
        fail(f"window frame: {rec}")
    if not (len(d) <= W_DIFF_LIMIT and one_sided <= W_ONE_SIDED_LIMIT
            and depth_max <= 2 * quantum):
        fail(f"window frame against the pool frame: {rec}")
    if not (rec["jax_values_off_by_more_than_2"] < JAX_FRAME_PIXELS_OFF
            and rec["jax_mean_color_diff"] < JAX_FRAME_MEAN_COLOR):
        fail(f"window frame against the stored JAX frame: {rec}")


def run_generic_mesh(dev) -> None:
    """Phase 40: the standard grid passed as a plain (T, 3) triangle list
    (grid_shape=None) renders bit-equal to the grid path on both
    rasterizers, through K7 and K8 on the pool path."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.render import raster as rr
    from gfx_ocean_tpu_torch.render.camera import Camera

    cfg = ot.OceanConfig(fft_impl="pallas")
    disp = ot.step(STATES["render"], R_T,
                   dataclasses.replace(cfg, compute_normals=False)).displacement
    cam = Camera()
    positions, uvs, tris = rr._mesh_constants(cfg.mesh_resolution, cfg.num_patches, dev)
    interp = rr._interp_matrices(cfg.mesh_resolution, R_N, dev)
    grid_shape = (cfg.num_patches, cfg.mesh_resolution)
    args = (disp, positions, uvs, tris, rr._view_proj(cam, G_W, G_H, dev),
            torch.tensor(cam.position.astype(np.float32), device=dev), G_W, G_H)
    rec = {}
    for name, fn, extra in (("pool", rr._rasterize_pool, (rr._auto_pool(G_W, G_H), R_GIANTS)),
                            ("window", rr._rasterize, (W_SAMPLES, R_GIANTS))):
        k7 = launch_count("k7")
        img, z = fn(*args, *extra, interp, grid_shape)
        listed, lz = fn(*args, *extra, interp, None)
        rec[name] = dict(color_equal=bool(torch.equal(img, listed)),
                         depth_equal=bool(torch.equal(z, lz)),
                         coverage=float(torch.isfinite(z).float().mean()),
                         k7_launches=launch_count("k7") - k7)
    phase("generic_mesh", width=G_W, height=G_H, triangles=int(tris.shape[0]), **rec)
    if not all(r["color_equal"] and r["depth_equal"] and r["coverage"] > 0
               for r in rec.values()) or rec["pool"]["k7_launches"] != 2:
        fail(f"generic mesh: {rec}")


def run_native_loader() -> None:
    """Phase 41: the native bincode loader (built in phase 2) on files of
    phase 8's 4096^2 state written by the port's writer: bit-equal to the
    numpy parser, MB/s of each, write_npy read back, and the loaders' parser
    must be native."""
    import numpy as np

    from gfx_ocean_tpu_torch import kernels
    from gfx_ocean_tpu_torch.assets import bincode
    from gfx_ocean_tpu_torch.native import bincode_native

    out = Path(__file__).resolve().parent / "build" / "smoke" / "native"
    out.mkdir(parents=True, exist_ok=True)
    st = STATES["fourstep"]
    h0 = (st.h0[0] + 1j * st.h0[1]).cpu().numpy().astype(np.complex64)
    omega = st.omega.cpu().numpy()
    del st
    spec, om = str(out / "spectrum.bin"), str(out / "omega.bin")
    bincode.save_spectrum(spec, h0)
    bincode.save_omega(om, omega)

    def numpy_parse(path, vec2):
        with open(path, "rb") as f:
            buf = f.read()
        return bincode.parse_bincode_vec2f(buf, path) if vec2 else bincode.parse_bincode_f32(buf, path)

    rec = {}
    for name, path, vec2 in (("spectrum", spec, True), ("omega", om, False)):
        size = os.path.getsize(path)
        timed = {}
        for parser, fn in (("native", bincode_native.parse_vec2f if vec2 else
                            bincode_native.parse_f32),
                           ("numpy", lambda p: numpy_parse(p, vec2))):
            best = math.inf
            for _ in range(NATIVE_REPEATS):
                t0 = time.perf_counter()
                arr = fn(path)
                best = min(best, time.perf_counter() - t0)
            timed[parser] = (arr, best)
        equal = bool(np.array_equal(timed["native"][0].view(np.uint32),
                                    timed["numpy"][0].view(np.uint32)))
        rec[name] = dict(bytes=size, bit_equal=equal,
                         native_mb_per_s=size / 1e6 / timed["native"][1],
                         numpy_mb_per_s=size / 1e6 / timed["numpy"][1])
    npy = str(out / "omega.npy")
    bincode_native.write_npy(npy, omega)
    rec["write_npy_roundtrip"] = bool(np.array_equal(np.load(npy), omega))
    rec["loaded_equal"] = bool(np.array_equal(bincode.load_spectrum(spec, FS_N), h0)
                               and np.array_equal(bincode.load_omega(om, FS_N), omega))
    rec["loader_in_use"] = bincode.loader_in_use()
    phase("native_loader", resolution=FS_N, repeats=NATIVE_REPEATS,
          build_seconds=STATES["native_build_seconds"], clock="host, best of repeats",
          library=str(kernels.host_library_path("ocean_native")), **rec)
    if not (rec["spectrum"]["bit_equal"] and rec["omega"]["bit_equal"]
            and rec["write_npy_roundtrip"] and rec["loaded_equal"]):
        fail(f"native loader: {rec}")
    if rec["loader_in_use"] != "native":
        fail("the bincode loaders fell back to numpy on this machine")



@contextlib.contextmanager
def exact_products():
    """Inside the block every product of the plain K1-K4 is its tier's scheme
    computed exactly: the passes' bf16 products (``ops/fft._PASSES``) summed
    in float64 (DGEMM on the card) and rounded once to float32, each stage's
    output then split or rounded again as the kernels do (``scheme_rel``'s
    arithmetic, for the kernels' routes)."""
    from gfx_ocean_tpu_torch.ops import fft as tfft
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops import unpacked_step as us

    def exact(a, b, tier):
        pa = a.value if isinstance(a, tfft.Prepared) else tfft.prepare(a, tier).value
        pb = b.value if isinstance(b, tfft.Prepared) else tfft.prepare(b, tier).value
        if tier == "highest":
            return (pa.double() @ pb.double()).float()
        return sum(pa[p].double() @ pb[q].double() for p, q in tfft._PASSES[tier]).float()

    saved = fused_step.matmul_tier, fs.matmul_tier, us.matmul_tier
    fused_step.matmul_tier = fs.matmul_tier = us.matmul_tier = exact
    try:
        yield
    finally:
        fused_step.matmul_tier, fs.matmul_tier, us.matmul_tier = saved


def tiered_counts() -> dict:
    """The launches of the tiered bodies (K1t-K4t) and of the FFT bodies
    (K1-K4): a wrapper's launches less its tiered ones."""
    rec = {}
    for k in ("k1", "k2", "k3", "k4"):
        tiered = launch_count(k, "tiered_launches")
        rec[k] = launch_count(k) - tiered
        rec[k + "t"] = tiered
    return rec


def tier_gate(tier: str, rel: float, own: float) -> list:
    """The failures of a tiered step's rel L-inf against golden: its exact
    scheme's own error (``exact_products``) give or take FP32_SUM_ALLOWANCE
    (+ DEFAULT_REROUND of it at "default"), and the golden gate (DEFAULT_GATE
    at "default")."""
    band = FP32_SUM_ALLOWANCE + DEFAULT_REROUND * own * (tier == "default")
    gate = DEFAULT_GATE if tier == "default" else GOLDEN_GATE
    out = []
    if not abs(rel - own) <= band:
        out.append(f"{tier}: rel L-inf {rel:.3e} is not its exact scheme's {own:.3e} +- {band:.3e}")
    if not rel <= gate:
        out.append(f"{tier}: rel L-inf {rel:.3e} past the gate {gate}")
    return out


def run_tier_k1(dev) -> dict:
    """Phase 49: K1's tiered body (K1t) at 512^2 on phase 3's state; returns
    its kernels entry."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.golden.reference import golden_fields
    from gfx_ocean_tpu_torch.ops import fft as tfft
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    state, n = STATES["main"], N
    gold = golden_fields(from_pair_np(state.h0.cpu().numpy()), state.omega.cpu().numpy(),
                         T_CHECK, 1000.0, ot.CompatFlags())
    scale = float(np.abs(gold).max())
    ts_cmp = torch.tensor(T_COMPARE, dtype=torch.float32, device=dev)
    ts6 = torch.arange(TIME_BATCH, dtype=torch.float32, device=dev) / 60.0
    ts = torch.arange(STEPS, dtype=torch.float32, device=dev) / 60.0
    # three cascades for the cascade axis: the state, and two others made from it
    h0c = torch.stack([state.h0, 0.5 * state.h0.roll(1, -1), 0.25 * state.h0.flip(-2)])
    omc = torch.stack([state.omega, state.omega.roll(1, -1), state.omega.flip(-2)])
    rec, planes, failures = {}, {}, []
    for tier in ("highest",) + TIER_K1:
        cfg = ot.OceanConfig(resolution=n, fft_impl="pallas", matmul_precision=tier)
        inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
        got = fused_step.packed_planes(inputs, ts_cmp, cfg)
        want = fused_step.packed_planes_reference(inputs, ts_cmp, cfg)
        with exact_products():
            scheme = fused_step.packed_planes_reference(inputs, ts_cmp[:1], cfg)[0]
        torch.cuda.synchronize()
        err = max_err(got, want)
        planes[tier] = got
        disp = torch.stack([got[0, 0], got[0, 1], got[0, 2]], dim=-1).cpu().numpy()
        rel = float(np.abs(disp - gold).max()) / scale
        own = float(np.abs(torch.stack([scheme[0], scheme[1], scheme[2]], -1).cpu().numpy()
                           - gold).max()) / scale
        cin = fused_step.hoist_packed(h0c, omc, cfg)
        cgot = fused_step.packed_planes(cin, ts_cmp, cfg)
        cerr = max_err(cgot, fused_step.packed_planes_reference(cin, ts_cmp, cfg))
        singles = sum(int((fused_step.packed_planes(fused_step.hoist_packed(h0c[c], omc[c], cfg),
                                                    ts_cmp, cfg) != cgot[:, c]).sum())
                      for c in range(3))
        tol = kernel_tol(tier)
        r = dict(kernel_vs_plain_max_abs=err[0], kernel_vs_plain_rel=err[1], tolerance=tol,
                 cascades3_vs_plain_rel=cerr[1], cascades3_values_differing_from_singles=singles,
                 rel_linf=rel, scheme_rel_linf=own,
                 effective_precision=fused_step.check_supported(cfg, n))
        if not (err[1] <= tol and cerr[1] <= tol and singles == 0):
            failures.append(f"K1 at {tier}: {r}")
        failures += tier_gate(tier, rel, own) if tier != "highest" else []
        calls = TIMING_CALLS
        r["ms"] = event_ms(lambda: fused_step.packed_checksums(inputs, ts6, cfg), calls)
        r["plain_ms"] = event_ms(lambda: fused_step.packed_checksums_reference(inputs, ts6, cfg),
                                 TIER_CALLS)
        names = body_kernels(tier, K1_KERNELS, K1T_KERNELS)
        r["device_ms"] = kernel_device_ms(
            lambda: fused_step.packed_checksums(inputs, ts6, cfg), names, calls)
        if tier in ("highest", "bf16x3", "default"):
            roll = time_rollout(ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH),
                                state, ts, repeats=REPEATS)
            r["rollout_steps_per_sec"] = roll["steps_per_sec"]
            r["rollout_repeats_sec"] = roll["repeats_sec"]
        rec[tier] = r
        del got, want, cgot, cin
    for tier in ("bf16x4", "high"):
        rec[tier]["bit_equal_to_bf16x3"] = bool(torch.equal(planes[tier], planes["bf16x3"]))
        if not rec[tier]["bit_equal_to_bf16x3"]:
            failures.append(f"K1 at {tier} is not bit-equal to bf16x3")
    for tier in ("bf16x3", "default"):
        rec[tier]["rollout_vs_highest"] = (rec[tier]["rollout_steps_per_sec"]
                                           / rec["highest"]["rollout_steps_per_sec"])
        rec[tier]["call_vs_highest"] = rec[tier]["ms"] / rec["highest"]["ms"]
    del planes

    # The library yardstick: the matmul route (cuBLAS bf16 passes, ops/fft) of
    # the same two 2-D transforms a frame (Re F(H), F(Z)) at the same tier.
    spec = torch.randn((4, TIME_BATCH, n, n), dtype=torch.float32, device=dev)
    for tier in ("bf16x3", "default"):
        rec[tier]["library_ms"] = event_ms(lambda: (
            tfft.ifft2_real_unnorm(spec[0], spec[1], precision=tier, centered="ref"),
            tfft.ifft2_planes_unnorm(spec[2], spec[3], precision=tier, centered="ref")),
            TIER_CALLS)
    del spec
    cfg = ot.OceanConfig(resolution=n, fft_impl="pallas")  # the headline: bf16x3
    inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
    frag = tfft.table_slots(("alt", n, 1, 0, False), dev, "bf16x3")
    ops = {t: tfft.kernel_passes(t) * 28.0 * n ** 3 * TIME_BATCH for t in ("bf16x3", "default")}
    io = (nbytes(state.h0, state.omega, ts6)
          + 4 * TIME_BATCH * (3 * n * n + n // fused_step.CHECKSUM_ROWS))
    for tier in ("bf16x3", "default"):
        rec[tier].update(bound(io + nbytes(frag) // (2 if tier == "default" else 1),
                               ops[tier], BF16_OPS_PER_S))

    # The main path: the headline rollout (512^2, tb 6, "bf16x3") with the
    # counts set to 0 just before it.
    rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH)
    reset_launches()
    cks = rollout(state, ts).cpu().numpy()
    counts = tiered_counts()
    expected = STEPS // TIME_BATCH
    phase("tier_k1", resolution=n, frames_a_call=TIME_BATCH, cascades=3, t=T_CHECK,
          clock="cuda events (ms); device_ms: torch.profiler, the kernels' launches only; "
                "rollouts: host clock over synchronized calls",
          fp32_sum_allowance=FP32_SUM_ALLOWANCE, default_reround=DEFAULT_REROUND, tiers=rec,
          main_path=dict(steps=STEPS, time_batch=TIME_BATCH, launches=counts,
                         launches_a_frame=counts["k1t"] / STEPS,
                         checksums_finite=bool(np.isfinite(cks).all())))
    if (counts != dict(k1=0, k1t=expected, k2=0, k2t=0, k3=0, k3t=0, k4=0, k4t=0)
            or not np.isfinite(cks).all()):
        failures.append(f"K1t main path launched {counts}, expected {expected} of K1t")
    if failures:
        fail(f"tier_k1: {failures}")
    r = rec["bf16x3"]
    return {
        "name": "K1t packed_step tiered body (bf16 tensor-core DFT: 3 passes at "
                "bf16x3 / high / bf16x4, 1 at default; wgmma, persistent product passes over "
                "work items of time batch x cascades)",
        "route": "cuda",
        "source": "gfx_ocean_tpu_torch/csrc/packed_step.cu",
        "replaces": "gfx_ocean_tpu/ops/pallas_step.py:352",
        "launches": counts["k1t"],
        "max_abs_err": r["kernel_vs_plain_max_abs"],
        "ms": r["ms"],
        "device_ms": r["device_ms"]["total"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "default_tier": {k: rec["default"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_vs_plain_max_abs")}
        | {"device_ms": rec["default"]["device_ms"]["total"]},
    }


def fourstep_tier_ops(n: int, rows: int, cols: int, passes: int) -> tuple:
    """Tensor-core operations of K2t on ``rows`` rows and of K3t on ``cols``
    columns of an n^2 frame: stage 1 is [Xr | Xi] W1cat^T (256 x 256) on
    rows x N2 (row, k2) or cols x N2 (m2, column) rows of both spectra, stage
    2 W2cat^T (2 N2 x 2 N2) on 128 rows a row (K2) or column (K3) of both,
    the height's real rows only in K3 (zero blocks of the TPU's block-diagonal
    table are not multiplied)."""
    n2 = n // 128
    k2 = 2 * 2 * rows * n2 * 256 * 256 + 2 * 2 * rows * 128 * (2 * n2) ** 2
    k3 = (2 * 2 * cols * n2 * 256 * 256
          + 2 * cols * 128 * (2 * n2) * (n2 + 2 * n2))
    return passes * k2, passes * k3


def run_tier_fourstep(dev) -> list:
    """Phase 50: K2's and K3's tiered bodies (K2t, K3t) at 1024^2 and at
    config 5 (4096^2, phase 8's state and phase 10's golden); returns their
    kernels entries."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.ops import fft as tfft
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops.derived import checksums_of_planes, finite_difference_normals_planes
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    base = ot.OceanConfig(resolution=FS_N, domain_size=2000.0, fft_impl="pallas")
    rec, failures = {}, []
    for n in (1024, FS_N):
        if n == FS_N:
            state, gold = STATES["fourstep"], STATES["fourstep_golden"]
        else:
            state, gold = ot.ocean_state_from_phillips(
                dataclasses.replace(base, resolution=n), ot.PhillipsConfig(),
                generator=torch.Generator().manual_seed(0), device=dev), None
        ts = torch.tensor(T_COMPARE[:2], dtype=torch.float32, device=dev)
        planes, rec[n] = {}, {}
        for tier in ("highest",) + TIER_FOURSTEP:
            cfg = dataclasses.replace(base, resolution=n, matmul_precision=tier)
            inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
            y = fs.launch_fourstep_row(inputs, ts, cfg)
            got, partials = fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True)
            y_want = fs.fourstep_row_reference(inputs, ts, cfg)
            k2 = max_err(y, y_want)
            k3 = max_err(got, fs.fourstep_col_reference(y, cfg))
            del y
            want = fs.fourstep_col_reference(y_want, cfg)
            del y_want
            torch.cuda.synchronize()
            chained = max_err(got, want)
            summands = (want.abs().sum(dim=(-3, -2, -1))
                        + finite_difference_normals_planes(want[:, 1], cfg.normal_height_scale)
                        .abs().sum(dim=(-3, -2, -1)))
            ck = float(((partials.sum(-1) - checksums_of_planes(want, cfg)).abs()
                        / summands).max())
            tol, ck_tol = kernel_tol(tier), checksum_tol(tier)
            r = dict(k2_y_max_abs=k2[0], k2_y_rel=k2[1], k3_planes_max_abs=k3[0],
                     k3_planes_rel=k3[1], planes_max_abs=chained[0], planes_rel=chained[1],
                     checksum_rel_to_summands=ck, tolerance=tol, checksum_tolerance=ck_tol,
                     effective_precision=fused_step.check_supported(cfg, n))
            if not (max(k2[1], k3[1], chained[1]) <= tol and ck <= ck_tol):
                failures.append(f"{n}^2 K2 / K3 at {tier} vs plain: {r}")
            planes[tier] = got[:1].clone()
            del got, want, partials
            if gold is not None:
                scale = float(np.abs(gold).max())
                with exact_products():
                    scheme = fs.fourstep_planes_reference(inputs, ts[:1], cfg)[0]
                for key, p in (("rel_linf", planes[tier][0]), ("scheme_rel_linf", scheme)):
                    r[key] = float(np.abs(torch.stack([p[0], p[1], p[2]], -1).cpu().numpy()
                                          - gold).max()) / scale
                del scheme
                if tier != "highest":
                    failures += tier_gate(tier, r["rel_linf"], r["scheme_rel_linf"])
            torch.cuda.empty_cache()
            rec[n][tier] = r
        for tier in ("bf16x4", "high"):
            rec[n][tier]["bit_equal_to_bf16x3"] = bool(torch.equal(planes[tier],
                                                                   planes["bf16x3"]))
            if not rec[n][tier]["bit_equal_to_bf16x3"]:
                failures.append(f"{n}^2 K2 + K3 at {tier} is not bit-equal to bf16x3")
        del planes

    # Config 5: one call of K2t, K3t and the step (tb 1), the plain version,
    # the matmul route's passes at the same tier, device time; rollouts.
    state = STATES["fourstep"]
    ts1 = torch.tensor([T_CHECK], dtype=torch.float32, device=dev)
    ts_roll = torch.arange(FS_STEPS, dtype=torch.float32, device=dev) / 60.0
    spec = torch.randn((4, 1, FS_N, FS_N), dtype=torch.float32, device=dev)
    timing = {}
    for tier in ("highest", "high", "default"):
        cfg = dataclasses.replace(base, matmul_precision=tier)
        inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
        y = fs.launch_fourstep_row(inputs, ts1, cfg)
        t = dict(
            k2_ms=event_ms(lambda: fs.launch_fourstep_row(inputs, ts1, cfg), FS_TIMING_CALLS),
            k3_ms=event_ms(lambda: fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True),
                           FS_TIMING_CALLS),
            step_ms=event_ms(lambda: fused_step.packed_checksums(inputs, ts1, cfg),
                             FS_TIMING_CALLS),
            k2_plain_ms=event_ms(lambda: fs.fourstep_row_reference(inputs, ts1, cfg),
                                 FS_PLAIN_TIMING_CALLS),
            k3_plain_ms=event_ms(lambda: checksums_of_planes(fs.fourstep_col_reference(y, cfg),
                                                             cfg), FS_PLAIN_TIMING_CALLS))
        k2n = body_kernels(tier, K2_KERNELS, k2t_kernels(FS_N))
        k3n = body_kernels(tier, K3_KERNELS, K3T_KERNELS)
        t["k2_device_ms"] = kernel_device_ms(lambda: fs.launch_fourstep_row(inputs, ts1, cfg),
                                             k2n, FS_TIMING_CALLS)
        t["k3_device_ms"] = kernel_device_ms(
            lambda: fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True), k3n,
            FS_TIMING_CALLS)
        if tier != "highest":
            kt = tfft.kernel_tier(tier)
            t["k2_library_ms"] = event_ms(lambda: tfft.row_pass_complex(
                spec[0], spec[1], 1024, True, kt) + tfft.row_pass_complex(
                spec[2], spec[3], 1024, True, kt), FS_TIMING_CALLS)
            t["k3_library_ms"] = event_ms(lambda: (
                tfft.col_pass_real(spec[0], spec[1], 1024, True, True, kt),
                tfft.col_pass_complex(spec[2], spec[3], 1024, True, True, kt)), FS_TIMING_CALLS)
            passes = tfft.kernel_passes(tier)
            ops2, ops3 = fourstep_tier_ops(FS_N, FS_N, FS_N, passes)
            w1 = tfft.table_wgmma(("alt", 128, 1, 0, True), dev, kt)
            w2_row = tfft.table_wgmma(("cat", FS_N // 128), dev, kt)  # the tables each reads
            w2_col = tfft.table_wgmma(("dft", FS_N // 128, 1), dev, kt, 16)
            y_bytes = 4 * 4 * FS_N * FS_N
            t["k2_bound"] = bound(nbytes(state.h0, state.omega, ts1, w1, w2_row) + y_bytes, ops2,
                                  BF16_OPS_PER_S)
            t["k3_bound"] = bound(y_bytes + nbytes(w1, w2_col) + 4 * 3 * FS_N * FS_N, ops3,
                                  BF16_OPS_PER_S)
        roll = time_rollout(ot.make_rollout(cfg, keep_fields=False), state, ts_roll,
                            repeats=FS_REPEATS)
        t.update(rollout_steps_per_sec=roll["steps_per_sec"],
                 rollout_repeats_sec=roll["repeats_sec"])
        timing[tier] = t
        del y
    del spec
    torch.cuda.empty_cache()
    for tier in ("high", "default"):
        timing[tier]["rollout_vs_highest"] = (timing[tier]["rollout_steps_per_sec"]
                                              / timing["highest"]["rollout_steps_per_sec"])
        timing[tier]["step_vs_highest"] = timing[tier]["step_ms"] / timing["highest"]["step_ms"]

    # The main path: config 5's rollout at "high" (tb 1) with the counts at 0.
    cfg = dataclasses.replace(base, matmul_precision="high")
    reset_launches()
    cks = ot.make_rollout(cfg, keep_fields=False)(state, ts_roll).cpu().numpy()
    counts = tiered_counts()
    phase("tier_fourstep", resolutions=[1024, FS_N], frames=list(T_COMPARE[:2]), t=T_CHECK,
          clock="cuda events (ms); device_ms: torch.profiler, the kernels' launches only; "
                "rollouts: host clock over synchronized calls",
          fp32_sum_allowance=FP32_SUM_ALLOWANCE, default_reround=DEFAULT_REROUND,
          tiers={str(n): r for n, r in rec.items()}, config5_timing=timing,
          main_path=dict(config="config 5 at high", steps=FS_STEPS, time_batch=1,
                         launches=counts, checksums_finite=bool(np.isfinite(cks).all())))
    if (counts != dict(k1=0, k1t=0, k2=0, k2t=FS_STEPS, k3=0, k3t=FS_STEPS, k4=0, k4t=0)
            or not np.isfinite(cks).all()):
        failures.append(f"K2t + K3t main path launched {counts}")
    if failures:
        fail(f"tier_fourstep: {failures}")
    t, r = timing["high"], rec[FS_N]["high"]
    return [{
        "name": f"{key.upper()}t fourstep_{side} tiered body (bf16 tensor-core four-step: "
                f"warp-specialized stage 1 on wgmma, FP32 twiddle, "
                f"{stage2} stage 2 on wgmma)",
        "route": "cuda",
        "source": "gfx_ocean_tpu_torch/csrc/fourstep_step.cu",
        "replaces": f"gfx_ocean_tpu/ops/pallas_step.py:{line}",
        "launches": counts[key + "t"],
        "max_abs_err": r[err_key],
        "ms": t[f"{key}_ms"],
        "device_ms": t[f"{key}_device_ms"]["total"],
        "plain_ms": t[f"{key}_plain_ms"],
        **t[f"{key}_bound"],
        "library_ms": t[f"{key}_library_ms"],
        "default_tier": {k: timing["default"][f"{key}_{k}"] for k in ("ms", "plain_ms",
                                                                     "library_ms")}
        | {"device_ms": timing["default"][f"{key}_device_ms"]["total"]}
        | timing["default"][f"{key}_bound"],
    } for key, side, line, err_key, stage2 in (
        ("k2", "row", 614, "k2_y_max_abs", "in-block (no scratch at N <= 4096)"),
        ("k3", "col", 757, "k3_planes_max_abs", "scratch then"))]


def run_tier_big(dev) -> None:
    """Phase 51: K2t at 16384^2 on phase 22's state: the whole frame, and
    phase 23's 16-row bands against the plain version and bit-equal to the
    whole frame's rows; "high" and "bf16x4" bit-equal to "bf16x3" there;
    one call's time beside the FFT body's and the matmul route's row passes
    at the tier, its bound; K3t on the whole frame at "bf16x3" beside the
    matmul route's column passes; the step through K2t + K3t against phase 24's
    golden rows (the exact scheme needs the plain K3 of the whole frame,
    tens of GB, so only the gate holds it here)."""
    import torch

    from gfx_ocean_tpu_torch.golden.reference import golden_fields_rows
    from gfx_ocean_tpu_torch.ops import fft as tfft
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs
    from gfx_ocean_tpu_torch.ops import fused_step

    big_cfg, inputs = STATES["big"]
    ts = torch.tensor([T_CHECK], dtype=torch.float32, device=dev)
    rec, failures, bands = {}, [], {}
    gold = {b: golden_fields_rows(inputs.h0, inputs.omega, T_CHECK, big_cfg.domain_size,
                                  big_cfg.compat, b, BIG_BAND_ROWS) for b in BIG_ROW_BANDS}
    gold_scale = max(float(g.abs().max()) for g in gold.values())
    for tier in ("highest", "bf16x3", "high", "bf16x4", "default"):
        cfg = dataclasses.replace(big_cfg, matmul_precision=tier)
        if tier in ("highest", "bf16x3", "default"):
            y = fs.launch_fourstep_row(inputs, ts, cfg)
            errs, differ = [], 0
            for b in BIG_ROW_BANDS:
                band = fs.launch_fourstep_row(inputs, ts, cfg, row_base=b, rows=BIG_BAND_ROWS)
                differ += int((band != y[..., b:b + BIG_BAND_ROWS, :]).sum())
                errs.append(max_err(band, fs.fourstep_row_reference(
                    inputs, ts, cfg, row_base=b, rows=BIG_BAND_ROWS)))
            del y
            torch.cuda.empty_cache()
            names = body_kernels(tier, K2_SPLIT_KERNELS, K2T_KERNELS)
            r = dict(band_max_abs=max(e[0] for e in errs), band_rel=max(e[1] for e in errs),
                     tolerance=kernel_tol(tier), banded_values_differing_from_whole=differ,
                     ms=event_ms(lambda: fs.launch_fourstep_row(inputs, ts, cfg),
                                 BIG_TIMING_CALLS),
                     device_ms=kernel_device_ms(lambda: fs.launch_fourstep_row(inputs, ts, cfg),
                                                names, BIG_TIMING_CALLS))
            if not (r["band_rel"] <= r["tolerance"] and differ == 0):
                failures.append(f"{tier}: {r}")
            if tier != "highest":
                planes = fused_step.packed_planes(inputs, ts, cfg)[0]
                r["step_rel_linf_on_bands"] = max(
                    float((planes[:, b:b + BIG_BAND_ROWS].permute(1, 2, 0).double() - g)
                          .abs().max()) for b, g in gold.items()) / gold_scale
                del planes
                torch.cuda.empty_cache()
                gate = DEFAULT_GATE if tier == "default" else GOLDEN_GATE
                r["step_gate"] = gate
                if not r["step_rel_linf_on_bands"] <= gate:
                    failures.append(f"{tier}: the step on the bands {r['step_rel_linf_on_bands']}")
                kt = tfft.kernel_tier(tier)
                passes = tfft.kernel_passes(tier)
                w1 = tfft.table_wgmma(("alt", 128, 1, 0, False), dev, kt)
                w2 = tfft.table_wgmma(("dft", 128, 1), dev, kt)
                r.update(bound(nbytes(inputs.h0, inputs.omega, ts, w1, w2) + 4 * 4 * BIG_N ** 2,
                               fourstep_tier_ops(BIG_N, BIG_N, BIG_N, passes)[0],
                               BF16_OPS_PER_S))
                spec = torch.randn((2, 1, BIG_N, BIG_N), dtype=torch.float32, device=dev)
                r["library_ms"] = event_ms(lambda: tfft.row_pass_complex(
                    spec[0], spec[1], 1024, True, kt), TIER_BIG_LIBRARY_CALLS) * 2
                if tier == "bf16x3":  # K3t on the whole frame's Y, with its checksum
                    r["k3t_library_ms"] = event_ms(lambda: tfft.col_pass_complex(
                        spec[0], spec[1], 1024, True, True, kt), TIER_BIG_LIBRARY_CALLS) * 2
                    del spec
                    torch.cuda.empty_cache()
                    y = fs.launch_fourstep_row(inputs, ts, cfg)

                    def k3t():
                        return fs.launch_fourstep_col(y, inputs.twiddle, cfg, checksum=True)

                    r["k3t_ms"] = event_ms(k3t, BIG_TIMING_CALLS)
                    r["k3t_device_ms"] = kernel_device_ms(k3t, K3T_KERNELS, BIG_TIMING_CALLS)
                    w1c = tfft.table_wgmma(("alt", 128, 1, 0, True), dev, kt)
                    w2c = tfft.table_wgmma(("dft", 128, 1), dev, kt)
                    r["k3t_bound"] = bound(
                        nbytes(y, w1c, w2c) + 4 * (3 * BIG_N ** 2 + BIG_N * 2),
                        fourstep_tier_ops(BIG_N, BIG_N, BIG_N, passes)[1], BF16_OPS_PER_S)
                    del y
                else:
                    del spec
                torch.cuda.empty_cache()
            rec[tier] = r
        bands[tier] = torch.cat([fs.launch_fourstep_row(inputs, ts, cfg, row_base=b,
                                                        rows=BIG_BAND_ROWS)
                                 for b in BIG_ROW_BANDS], dim=-2)
    for tier in ("high", "bf16x4"):
        rec[tier] = dict(bands_bit_equal_to_bf16x3=bool(torch.equal(bands[tier],
                                                                    bands["bf16x3"])))
        if not rec[tier]["bands_bit_equal_to_bf16x3"]:
            failures.append(f"{tier} bands differ from bf16x3")
    for tier in ("bf16x3", "default"):
        rec[tier]["ms_vs_highest"] = rec[tier]["ms"] / rec["highest"]["ms"]
    del bands
    torch.cuda.empty_cache()
    phase("tier_big", resolution=BIG_N, frames=1, row_bands=list(BIG_ROW_BANDS),
          band_rows=BIG_BAND_ROWS, calls=BIG_TIMING_CALLS,
          clock="cuda events; device_ms: torch.profiler, the kernels' launches only",
          library="the matmul route's row pass at the tier (ops/fft.row_pass_complex), one "
                  "spectrum a call, times two; K3t's: its column pass (col_pass_complex), "
                  "the same", tiers=rec)
    if failures:
        fail(f"tier_big: {failures}")


def run_tier_k4(dev) -> dict:
    """Phase 52: K4's tiered body (K4t) at 512^2 on phase 3's state, the
    unpacked route (``hermitian_pack=False``) at every tier but "highest";
    returns its kernels entry."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.golden.reference import golden_fields
    from gfx_ocean_tpu_torch.models.ocean import downsample_state
    from gfx_ocean_tpu_torch.ops import fft as tfft
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops import unpacked_step as us
    from gfx_ocean_tpu_torch.ops.derived import checksums_of_planes, finite_difference_normals_planes
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    state, n = STATES["main"], N
    base = ot.OceanConfig(resolution=n, fft_impl="pallas", hermitian_pack=False)
    gold = golden_fields(from_pair_np(state.h0.cpu().numpy()), state.omega.cpu().numpy(),
                         T_CHECK, base.domain_size, base.compat)
    scale = float(np.abs(gold).max())
    ts_cmp = torch.tensor(T_COMPARE, dtype=torch.float32, device=dev)
    ts6 = torch.arange(TIME_BATCH, dtype=torch.float32, device=dev) / 60.0
    ts = torch.arange(STEPS, dtype=torch.float32, device=dev) / 60.0
    rec, planes, failures = {}, {}, []

    def field_rel(p):
        return float(np.abs(torch.stack([p[0], p[1], p[2]], -1).cpu().numpy() - gold).max()) / scale

    for tier in TIER_K1:
        cfg = dataclasses.replace(base, matmul_precision=tier)
        inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
        reset_launches()
        got = us.unpacked_planes(inputs, ts_cmp, cfg)
        got_ck = us.unpacked_checksums(inputs, ts_cmp, cfg)
        counted = tiered_counts()
        want = us.unpacked_planes_reference(inputs, ts_cmp, cfg)
        with exact_products():
            scheme = us.unpacked_planes_reference(inputs, ts_cmp[:1], cfg)[0]
        torch.cuda.synchronize()
        err = max_err(got, want)
        summands = (want.abs().sum(dim=(-3, -2, -1))
                    + finite_difference_normals_planes(want[:, 1], cfg.normal_height_scale)
                    .abs().sum(dim=(-3, -2, -1)))
        ck = float(((got_ck - checksums_of_planes(want, cfg)).abs() / summands).max())
        planes[tier] = got
        r = dict(kernel_vs_plain_max_abs=err[0], kernel_vs_plain_rel=err[1],
                 tolerance=kernel_tol(tier), checksum_rel_to_summands=ck,
                 checksum_tolerance=checksum_tol(tier), launches=counted,
                 rel_linf=field_rel(got[0]), scheme_rel_linf=field_rel(scheme),
                 effective_precision=fused_step.check_supported(cfg, n),
                 route=us.unpacked_route(cfg, n))
        if not (err[1] <= r["tolerance"] and ck <= r["checksum_tolerance"]
                and counted["k4t"] == 2 and counted["k4"] == 0 and r["route"] == "single"):
            failures.append(f"K4t at {tier}: {r}")
        failures += tier_gate(tier, r["rel_linf"], r["scheme_rel_linf"])
        r["ms"] = event_ms(lambda: us.unpacked_checksums(inputs, ts6, cfg), TIMING_CALLS)
        r["plain_ms"] = event_ms(lambda: checksums_of_planes(
            us.unpacked_planes_reference(inputs, ts6, cfg), cfg), TIER_CALLS)
        r["device_ms"] = kernel_device_ms(lambda: us.unpacked_checksums(inputs, ts6, cfg),
                                          K4T_KERNELS, TIMING_CALLS)
        rec[tier] = r
        del got, want, scheme
    for tier in ("bf16x4", "high"):
        rec[tier]["bit_equal_to_bf16x3"] = bool(torch.equal(planes[tier], planes["bf16x3"]))
        if not rec[tier]["bit_equal_to_bf16x3"]:
            failures.append(f"K4t at {tier} is not bit-equal to bf16x3")
    del planes

    # The route switches on the tier: at 256^2 "highest" is K4's FFT body,
    # "bf16x3" K4t; both against their plain versions.
    st256 = downsample_state(state, U_FFT_ROUTE_N)
    switch = {}
    for tier in ("highest", "bf16x3"):
        cfg = dataclasses.replace(base, resolution=U_FFT_ROUTE_N, matmul_precision=tier)
        inputs = fused_step.hoist_packed(st256.h0, st256.omega, cfg)
        reset_launches()
        got = us.unpacked_planes(inputs, ts_cmp, cfg)
        counted = tiered_counts()
        err = max_err(got, us.unpacked_planes_reference(inputs, ts_cmp, cfg))
        switch[tier] = dict(route=us.unpacked_route(cfg, U_FFT_ROUTE_N), launches=counted,
                            kernel_vs_plain_rel=err[1], tolerance=kernel_tol(tier))
        fft_body = tier == "highest"
        if not (counted["k4"] == int(fft_body) and counted["k4t"] == int(not fft_body)
                and err[1] <= kernel_tol(tier)):
            failures.append(f"256^2 unpacked at {tier}: {switch[tier]}")
    del st256

    # The 600-frame rollouts at tb 6: K4t at "bf16x3" and "default" beside
    # "highest" (K5 + K6 at 512^2) in the same call.
    for tier in ("highest", "bf16x3", "default"):
        cfg = dataclasses.replace(base, matmul_precision=tier)
        roll = time_rollout(ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH),
                            state, ts, repeats=REPEATS)
        rec.setdefault(tier, {}).update(rollout_steps_per_sec=roll["steps_per_sec"],
                                        rollout_repeats_sec=roll["repeats_sec"])
    for tier in ("bf16x3", "default"):
        rec[tier]["rollout_vs_highest"] = (rec[tier]["rollout_steps_per_sec"]
                                           / rec["highest"]["rollout_steps_per_sec"])

    # The library yardstick: the matmul route's unpacked step (cuBLAS bf16
    # passes, ops/fft) of the same three real-output 2-D transforms a frame
    # at the same tier. The bound: 18 products of N^3 multiply-adds a frame
    # a pass, at the tensor cores' dense bf16 rate.
    spec = torch.randn((2, TIME_BATCH, 3, n, n), dtype=torch.float32, device=dev)
    table = tfft.table_slots(("alt", n, 1, 0, False), dev, "bf16x3")
    io = (nbytes(state.h0, state.omega, ts6)
          + 4 * TIME_BATCH * (3 * n * n + n // us.CHECKSUM_ROWS))
    for tier in ("bf16x3", "default"):
        rec[tier]["library_ms"] = event_ms(lambda: tfft.ifft2_real_unnorm(
            spec[0], spec[1], precision=tier, centered="ref"), TIER_CALLS)
        ops = tfft.kernel_passes(tier) * 36.0 * n ** 3 * TIME_BATCH
        rec[tier].update(bound(io + nbytes(table) // (2 if tier == "default" else 1), ops,
                               BF16_OPS_PER_S))
    del spec

    # The main path: the unpacked rollout at "bf16x3" (tb 6) with the counts
    # at 0 just before it.
    cfg = dataclasses.replace(base, matmul_precision="bf16x3")
    rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH)
    reset_launches()
    cks = rollout(state, ts).cpu().numpy()
    counts = tiered_counts()
    expected = STEPS // TIME_BATCH
    phase("tier_k4", resolution=n, frames_a_call=TIME_BATCH, t=T_CHECK,
          clock="cuda events (ms); device_ms: torch.profiler, the kernels' launches only; "
                "rollouts: host clock over synchronized calls",
          fp32_sum_allowance=FP32_SUM_ALLOWANCE, default_reround=DEFAULT_REROUND, tiers=rec,
          route_switch_256=switch,
          main_path=dict(steps=STEPS, time_batch=TIME_BATCH, launches=counts,
                         launches_a_frame=counts["k4t"] / STEPS,
                         checksums_finite=bool(np.isfinite(cks).all())))
    if (counts != dict(k1=0, k1t=0, k2=0, k2t=0, k3=0, k3t=0, k4=0, k4t=expected)
            or not np.isfinite(cks).all()):
        failures.append(f"K4t main path launched {counts}, expected {expected} of K4t")
    if failures:
        fail(f"tier_k4: {failures}")
    r = rec["bf16x3"]
    return {
        "name": "K4t unpacked_step tiered body (bf16 tensor-core DFT: 3 passes at "
                "bf16x3 / high / bf16x4, 1 at default; the spectra, then persistent "
                "wgmma row and column passes)",
        "route": "cuda",
        "source": "gfx_ocean_tpu_torch/csrc/unpacked_step.cu",
        "replaces": "gfx_ocean_tpu/ops/pallas_step.py:128",
        "launches": counts["k4t"],
        "max_abs_err": r["kernel_vs_plain_max_abs"],
        "ms": r["ms"],
        "device_ms": r["device_ms"]["total"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "default_tier": {k: rec["default"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_vs_plain_max_abs")}
        | {"device_ms": rec["default"]["device_ms"]["total"]},
    }


def run_parallel(dev) -> None:
    """Phases 42-48: ``parallel/`` on meshes whose positions repeat cuda:0
    (the card's count of positions; distinct cards take the same code with
    peer copies): the row-sharded K2 + K3 step of config 5 over 1 x 4, K2's
    windows at 16384^2, band-parallel and batch frames, OceanConfig() over
    2 x 4 under both fft names, the CLI's --mesh and serve(mesh=). Each
    phase prints the launches of K1-K3, K7 and K8 it made."""
    import numpy as np
    import torch

    import gfx_ocean_tpu_torch as ot
    from gfx_ocean_tpu_torch.ops import fourstep_step as fs
    from gfx_ocean_tpu_torch.ops import fused_step
    from gfx_ocean_tpu_torch.ops.propagate import band_windows
    from gfx_ocean_tpu_torch.parallel import (make_mesh, make_sharded_batch_renderer,
                                              make_sharded_frame_renderer, make_sharded_rollout,
                                              make_sharded_step, shard_state)
    from gfx_ocean_tpu_torch.parallel import collectives as coll
    from gfx_ocean_tpu_torch.parallel import distributed_fft as dfft
    from gfx_ocean_tpu_torch.render import raster as rr
    from gfx_ocean_tpu_torch.render.camera import Camera, perspective, scripted_camera
    from gfx_ocean_tpu_torch.utils.profiling import time_rollout

    def path_counts():
        counts = launch_counts()
        return {k: counts[k] for k in ("k1", "k2", "k3", "k7", "k8")}

    zero_counts = reset_launches

    # --- 42. config 5, row-sharded K2 + K3 over a 1 x 4 mesh ------------------
    t_phase = time.perf_counter()
    cfg = ot.OceanConfig(resolution=FS_N, domain_size=2000.0, fft_impl="pallas",
                         matmul_precision="high")
    state, gold = STATES.pop("fourstep"), STATES.pop("fourstep_golden")
    mesh = make_mesh([dev] * P_ROWS, batch=1, row=P_ROWS)
    sstate = shard_state(state, mesh)
    ts = torch.tensor([T_CHECK], device=dev)
    single = fused_step.packed_planes(fused_step.hoist_packed(state.h0, state.omega, cfg), ts,
                                      cfg)
    windows = dfft.fourstep_windows_group(list(sstate.h0.shards), list(sstate.omega.shards))
    zero_counts()
    planes = dfft.fourstep_planes_group(windows, ts, cfg)
    launched = path_counts()
    planes_differ = int((torch.cat(planes, dim=-2) != single).sum())
    step = make_sharded_step(cfg, mesh, batched=False)
    fields = step(sstate, T_CHECK)
    disp = fields.displacement.gather().cpu().numpy()
    abs_linf = float(np.abs(disp - gold).max())
    rel_linf = abs_linf / float(np.abs(gold).max())
    normals_differ = int((fields.normals.gather()
                          != ot.make_step(cfg)(state, T_CHECK).normals).sum())
    del fields, disp, gold
    # the two all_to_alls of a frame, alone, by CUDA events
    rows = FS_N // P_ROWS
    y = [fs.launch_fourstep_row(fs.FourstepInputs(None, None, fs.twiddle_table(FS_N, dev)), ts,
                                cfg, r * rows, rows, w) for r, w in enumerate(windows)]
    y_cols = coll.all_to_all(y, split_dim=-1, concat_dim=-2)
    to_cols_ms = event_ms(lambda: coll.all_to_all(y, split_dim=-1, concat_dim=-2), P_CALLS)
    cols = [fs.fourstep_col(v, fs.twiddle_table(FS_N, dev), cfg) for v in y_cols]
    to_rows_ms = event_ms(lambda: coll.all_to_all(cols, split_dim=-2, concat_dim=-1), P_CALLS)
    whole_inputs = fused_step.hoist_packed(state.h0, state.omega, cfg)
    band_k2_ms = dict(
        windows=event_ms(lambda: fs.launch_fourstep_row(
            fs.FourstepInputs(None, None, whole_inputs.twiddle), ts, cfg, rows, rows,
            windows[1]), P_CALLS),
        whole_state=event_ms(lambda: fs.launch_fourstep_row(whole_inputs, ts, cfg, rows, rows),
                             P_CALLS))
    step_ms = event_ms(lambda: dfft.fourstep_planes_group(windows, ts, cfg), P_CALLS)
    single_ms = event_ms(lambda: fused_step.packed_planes(
        fused_step.hoist_packed(state.h0, state.omega, cfg), ts, cfg), P_CALLS)
    del y, y_cols, cols, planes, single
    # the main path: a 24-frame sharded checksum rollout beside the single one
    ts_roll = torch.arange(P_STEPS, dtype=torch.float32, device=dev) / 60.0
    zero_counts()
    sharded_roll = time_rollout(make_sharded_rollout(cfg, mesh, batched=False), sstate, ts_roll,
                                repeats=P_REPEATS)
    roll_launched = path_counts()
    single_roll = time_rollout(ot.make_rollout(cfg, keep_fields=False), state, ts_roll,
                               repeats=P_REPEATS)
    ck_rel = float(np.max(np.abs(sharded_roll["checksums"] - single_roll["checksums"])
                          / np.abs(single_roll["checksums"])))
    expected = (P_REPEATS + 1) * P_STEPS * P_ROWS
    rec = dict(planes_differ=planes_differ, normals_differ=normals_differ,
               planes_launches=launched, rel_linf=rel_linf, abs_linf=abs_linf,
               gate_limit=GOLDEN_GATE, frame_ms=step_ms, single_device_frame_ms=single_ms,
               all_to_all_ms=dict(rows_to_cols_y=to_cols_ms, cols_to_rows_planes=to_rows_ms),
               k2_band_ms=band_k2_ms,
               rollout_steps_per_sec=sharded_roll["steps_per_sec"],
               rollout_repeats_sec=sharded_roll["repeats_sec"],
               single_rollout_steps_per_sec=single_roll["steps_per_sec"],
               checksums_max_rel=ck_rel, checksum_rtol=P_CHECKSUM_RTOL,
               rollout_launches=roll_launched, expected_launches=expected)
    phase("parallel_fourstep", resolution=FS_N, mesh="1 x 4 of cuda:0", clock="cuda events",
          seconds=time.perf_counter() - t_phase, **rec)
    if planes_differ or normals_differ:
        fail(f"row-sharded config 5 differs from the single-device K2 + K3: {rec}")
    if launched != dict(k1=0, k2=P_ROWS, k3=P_ROWS, k7=0, k8=0):
        fail(f"row-sharded config 5 launched {launched}, expected {P_ROWS} of K2 and K3")
    if not rel_linf <= GOLDEN_GATE:
        fail(f"row-sharded config 5 golden gate: {rel_linf:.3e} > {GOLDEN_GATE}")
    if roll_launched != dict(k1=0, k2=expected, k3=expected, k7=0, k8=0):
        fail(f"row-sharded rollout launched {roll_launched}, expected {expected} of K2, K3")
    if not (np.isfinite(sharded_roll["checksums"]).all() and ck_rel <= P_CHECKSUM_RTOL):
        fail(f"row-sharded rollout checksums: max rel {ck_rel:.3e} > {P_CHECKSUM_RTOL}")
    del sstate

    # --- 43. K2 at 16384^2 on a shard's two windows ---------------------------
    t_phase = time.perf_counter()
    big_cfg, big = STATES.pop("big")
    base, rows = 3 * BIG_N // P_ROWS, BIG_N // P_ROWS
    zero_counts()
    whole = fs.launch_fourstep_row(big, ts, big_cfg, row_base=base, rows=rows)
    band = fs.launch_fourstep_row(fs.FourstepInputs(None, None, big.twiddle), ts, big_cfg,
                                  base, rows, band_windows(big.h0, big.omega, base, rows))
    launched = path_counts()
    differ = int((band != whole).sum())
    phase("parallel_big_windows", resolution=BIG_N, row_base=base, rows=rows,
          differing=differ, launches=launched, seconds=time.perf_counter() - t_phase)
    if differ or launched["k2"] != 2:
        fail(f"{BIG_N}^2 K2 on windows differs from the whole-state K2 in {differ} values")
    del big, whole, band
    torch.cuda.empty_cache()

    # --- 44. the 1200x700 frame over 4 bands ----------------------------------
    t_phase = time.perf_counter()
    rstate = STATES.pop("render")
    rcfg = ot.OceanConfig(fft_impl="pallas")
    cam = Camera()
    vp = rr._view_proj(cam, R_W, R_H, dev)
    cp = torch.tensor(cam.position.astype(np.float32), device=dev)
    want = rr.make_frame_renderer(rcfg, R_W, R_H, R_GIANTS)(rstate, R_T, vp, cp)
    band_fn = make_sharded_frame_renderer(rcfg, mesh, R_W, R_H, R_GIANTS, diag=True)
    zero_counts()
    frame, dropped = band_fn(rstate, R_T, vp, cp)
    launched = path_counts()
    differ = int((frame.gather() != want).sum())
    dropped = dropped.gather().tolist()
    band_ms = event_ms(lambda: band_fn(rstate, R_T, vp, cp), P_RENDER_CALLS)
    full_ms = event_ms(lambda: rr.make_frame_renderer(rcfg, R_W, R_H, R_GIANTS)(
        rstate, R_T, vp, cp), P_RENDER_CALLS)
    phase("parallel_render", width=R_W, height=R_H, bands=P_ROWS, giants=R_GIANTS,
          differing=differ, dropped=dropped, launches=launched, band_frame_ms=band_ms,
          single_frame_ms=full_ms, seconds=time.perf_counter() - t_phase)
    if differ or any(dropped) or launched != dict(k1=P_ROWS, k2=0, k3=0, k7=P_ROWS,
                                                   k8=P_ROWS):
        fail(f"4-band frame: {differ} values differ, dropped {dropped}, launched {launched}")
    del want, frame

    # --- 45. frames over batch x bands over rows (2 x 2) ----------------------
    # The bands are bit-equal to a frame that drops no giant candidate (the
    # renderer's contract; ``diag``). At giants 512 the scripted camera's
    # second pose drops 69 on one device and none in two bands of 350 rows
    # (the same on the CPU), so that frame is held at twice the giants.
    t_phase = time.perf_counter()
    mesh22 = make_mesh([dev] * 4, batch=2, row=2)
    proj = perspective(R_W / R_H)
    cams = [c for _, c in scripted_camera([(P_FRAMES, ["w"])], dt=0.2)]
    vps = torch.tensor(np.stack([(proj @ c.view()).astype(np.float32) for c in cams]),
                       device=dev)
    cps = torch.tensor(np.stack([c.position.astype(np.float32) for c in cams]), device=dev)
    fts = torch.arange(P_FRAMES, dtype=torch.float32, device=dev) * 0.5 + R_T
    rec = {}
    for giants in (R_GIANTS, 2 * R_GIANTS):
        one = rr.make_frame_renderer(rcfg, R_W, R_H, giants, diag=True)
        dropped = [int(one(rstate, fts[i], vps[i], cps[i])[1]) for i in range(P_FRAMES)]
        want = rr.make_batch_renderer(rcfg, R_W, R_H, giants)(rstate, fts, vps, cps)
        zero_counts()
        got = make_sharded_batch_renderer(rcfg, mesh22, R_W, R_H, giants)(rstate, fts, vps,
                                                                          cps).gather()
        rec[giants] = dict(single_device_dropped=dropped, launches=path_counts(),
                           differing=[int((got[i] != want[i]).sum()) for i in range(P_FRAMES)])
    phase("parallel_batch_render", width=R_W, height=R_H, mesh="2 x 2 of cuda:0",
          frames=P_FRAMES, seconds=time.perf_counter() - t_phase,
          **{f"giants_{g}": r for g, r in rec.items()})
    for giants, r in rec.items():
        held = [d for d, drop in zip(r["differing"], r["single_device_dropped"]) if drop == 0]
        if any(held) or r["launches"]["k7"] != 2 * P_FRAMES:
            fail(f"2 x 2 batch renderer at giants {giants}: {r}")
    if any(rec[2 * R_GIANTS]["single_device_dropped"]):
        fail(f"2 x 2 batch renderer: frames still drop at giants {2 * R_GIANTS}")
    del want, got

    # --- 46. OceanConfig() at 512^2 over 2 x 4, both fft names ---------------
    t_phase = time.perf_counter()
    dcfg = ot.OceanConfig()
    one = STATES["main"]
    pair = ot.OceanState(torch.stack([one.h0] * 2), torch.stack([one.omega] * 2))
    mesh24 = make_mesh([dev] * 8, batch=2, row=4)
    ts_d = torch.arange(P_STEPS, dtype=torch.float32, device=dev) / 60.0
    want_ck = ot.make_rollout(dcfg, keep_fields=False)(pair, ts_d).cpu().numpy()
    rec = {}
    for fft in ("gspmd", "shard_map"):
        zero_counts()
        got_ck = make_sharded_rollout(dcfg, mesh24, fft=fft)(shard_state(pair, mesh24),
                                                              ts_d).cpu().numpy()
        rel = float(np.max(np.abs(got_ck - want_ck) / np.abs(want_ck)))
        rec[fft] = dict(checksums_max_rel=rel, launches=path_counts())
        if not (np.isfinite(got_ck).all() and rel <= P_CHECKSUM_RTOL):
            fail(f"OceanConfig() over 2 x 4 ({fft}): checksums max rel {rel:.3e}")
    phase("parallel_default_config", config="OceanConfig() (matmul, unpacked, bf16x3)",
          mesh="2 x 4 of cuda:0", steps=P_STEPS, checksum_rtol=P_CHECKSUM_RTOL,
          seconds=time.perf_counter() - t_phase, **rec)

    # --- 47. the CLI's --mesh ------------------------------------------------
    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "smoke" / "cli"
    files = ["--resolution", str(N), "--spectrum", str(work / "spectrum.bin"),
             "--omega", str(work / "omega.bin"), "--fft-impl", "pallas"]
    out, launched_sim = cli(["simulate", *files, "--steps", str(P_STEPS), "--mesh", "1,1"])
    sim = last_json(out)
    plain_sim = last_json(cli(["simulate", *files, "--steps", str(P_STEPS)])[0])
    render_dir = work / "render_mesh"
    _, launched_render = cli(["render", *files, "--frames", "2", "--width", str(R_W),
                              "--height", str(R_H), "--out", str(render_dir), "--mesh", "1,1"])
    cards = torch.cuda.device_count()
    two = {}
    try:
        out, launched_two = cli(["simulate", *files, "--steps", "4", "--mesh", "1,2"])
        two = dict(ran=True, launches=launched_two)
    except SystemExit as e:
        two = dict(exited=str(e.code))
    sim_rel = float(np.max(np.abs(np.array(sim["checksums_head"])
                                  - np.array(plain_sim["checksums_head"]))
                           / np.abs(np.array(plain_sim["checksums_head"]))))
    phase("parallel_cli", simulate=dict(launches=launched_sim, checksums_max_rel=sim_rel),
          render=dict(launches=launched_render), mesh_1_2=two, cards=cards,
          seconds=time.perf_counter() - t_phase)
    if sim_rel > P_CHECKSUM_RTOL or launched_sim.get("k1", 0) < 1:
        fail(f"simulate --mesh 1,1: {sim_rel:.3e} from the unsharded CLI, {launched_sim}")
    if launched_render.get("k7", 0) != 2:
        fail(f"render --mesh 1,1 launched {launched_render}")
    if cards < 2 and two.get("exited") != "--mesh 1,2 wants 2 devices; only 1 visible":
        fail(f"--mesh 1,2 on one card: {two}")
    if cards >= 2 and not two.get("ran"):
        fail(f"--mesh 1,2 on {cards} cards: {two}")

    # --- 48. serve(mesh=) ----------------------------------------------------
    import threading

    from gfx_ocean_tpu_torch.serve import serve

    t_phase = time.perf_counter()
    scfg = ot.OceanConfig(fft_impl="pallas")
    bodies = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        srv = serve(STATES["main"], scfg, port=0, mesh=m)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            base_url = f"http://127.0.0.1:{srv.server_address[1]}"
            before = launch_counts()
            bodies[name] = http_get(base_url + f"/frame.png?t={T_CHECK}&w={R_W}&h={R_H}")
            launched = launched_since(before)
            metrics = json.loads(http_get(base_url + "/metrics"))
        finally:
            srv.shutdown()
            srv.server_close()
        bodies[name + "_launches"] = launched
        bodies[name + "_mesh"] = metrics["mesh"]
    same = bodies["sharded"] == bodies["unsharded"]
    phase("parallel_serve", width=R_W, height=R_H, png_bytes_equal=same,
          png_bytes=len(bodies["sharded"]), launches=bodies["sharded_launches"],
          unsharded_launches=bodies["unsharded_launches"], mesh=bodies["sharded_mesh"],
          seconds=time.perf_counter() - t_phase)
    if not same or bodies["sharded_mesh"] != {"batch": 1, "row": P_ROWS}:
        fail("serve(mesh=): /frame.png differs from the unsharded server's")


if __name__ == "__main__":
    main()
