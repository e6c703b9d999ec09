"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's names and files are in
``BENCHMARK.json`` (see ``portbench/README.md``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` a ``breakdown``, and last ``check``:
each number compared with the reference beside its limit, which also make
the last lines of standard error.

Exits with another code than 0, and prints no result, when there is no
CUDA device or fewer than the cell asks for, when the program cannot be
imported, or when JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache at a fixed path inside the checkout: the
# port builds its CUDA and host libraries into build/kernels and
# build/native; these two would serve a Triton kernel or a torch extension.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
# One host thread for the program's CPU operations, and the process kept on
# one core: the frame cell's pace is the host's, and on a shared host an
# unpinned run wandered twice as widely from run to run.
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))
HOST_CORE = 3


def pin_to_one_core() -> None:
    """Keep this process, and every thread it starts, on one core of those
    it may use (the fourth, where there are that many)."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[min(HOST_CORE, len(cores) - 1)]})

FORBIDDEN = ("jax", "jaxlib", "flax", "gfx_ocean_tpu")


def forbidden(modules) -> list:
    """The top-level names among ``modules`` that are JAX or the JAX
    package, compared whole (``gfx_ocean_tpu_torch`` is not
    ``gfx_ocean_tpu``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_to_one_core()

    import torch

    from portbench import harness

    chips = next(w["chips"] for w in harness.bench()["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    import gfx_ocean_tpu_torch  # noqa: F401  (fails here, before any work, where it is absent)

    line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden(sys.modules)
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
