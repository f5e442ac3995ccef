"""The readings the check's limits are set from, on the card: a cell's
numbers over many seeds with the program sound, and with the control or
another fault of ``faults.py`` planted under the timed path, at the cell's
own size and load, in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --faults none index_shift --seeds 1 2 3

Prints one JSON line per fault and seed.  The benchmark's runs do not run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import check, faults, harness, run, traffic  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=["none", faults.CONTROL],
                   choices=faults.FAULTS)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card is visible", file=sys.stderr)
        return 2
    scan = harness.Scan(cell, "cuda")
    scan.warm(traffic.make(cell, args.seeds[0]), run.WARM_SUPER_STEPS)
    for fault in args.faults:
        for seed in args.seeds:
            inputs = traffic.make(cell, seed)
            t = time.perf_counter()
            with faults.planted(fault, scan.scanner):
                ops, matches, elapsed, state = run.measure(
                    scan, cell, inputs, args.seconds)
            numbers = check.judge(cell, inputs, matches, ops, seed, state)
            correct, _, _ = check.verdict(numbers, cell["limits"])
            print(json.dumps({
                "cell": cell["name"], "fault": fault, "seed": seed,
                "keys": ops, "matches": len(matches), "window_s": elapsed,
                "check_s": time.perf_counter() - t - elapsed,
                "correct": correct, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
