"""The readings behind the limits of a cell's comparison: the numbers the
check compares, for many seeds in one process, of the program as the
configuration states it and of its control (``--control``: the
configuration's ``control`` group merged in, a lower precision tier).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --frames <F> [--control]

Each seed sets the cell up, computes through the same entry and calls as
its window just the answers its check samples out of a window of ``F``
frames (``replay``), frees the program's state and compares. One JSON line
a seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(workload: str, seeds, frames: int, control: bool, device="cuda",
             override=None):
    """Yield ``{"seed", "control", "numbers", "compared", "failed"}`` a seed."""
    from portbench import harness

    for seed in seeds:
        cell = harness.load_cell(workload, seed, device, override=override)
        if control:
            cell = harness.load_cell(workload, seed, device,
                                     override=harness.merge(override or {},
                                                            {"config": cell.config["control"]}))
        loop = harness.drive(cell)
        loop.setup()
        loop.replay(frames)
        loop.release()
        yield {"seed": seed, "control": control, **loop.check()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    for out in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.frames,
                        args.control):
        print(json.dumps({"workload": args.workload, **out,
                          "elapsed_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
