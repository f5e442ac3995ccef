#!/usr/bin/env python3
"""Alternating keys/s readings of the PyTorch port's scans on two trees.

    python3 scripts/torch_ab_scan.py PARENT_DIR CHANGE_DIR \
        [--order pccppc] [--seconds 10] [--pattern ^1BenchNeverMatches] \
        [--range-dfa FORMAT]

Each reading is one process that imports ``vgen_tpu_torch`` from the tree
named by its letter in ``--order`` (p: PARENT_DIR, c: CHANGE_DIR) and runs
its ``scan.scanner.benchmark_device`` (P2PKH, B = 524288, k_sub = 8; table
build, kernel build and warm-up excluded from the timed part), so both
trees are read on the same card in one run, interleaved.  With
``--range-dfa FORMAT`` a reading is instead ``chip_smoke.py`` phase 29's
range DFA rate: a ``DeviceScanner`` of that format scans 64 whole
super-steps of ``--pattern`` (a DFA pattern that never matches) from key
0x5EED00000000 after one warm-up super-step.  Prints one JSON line per
reading and a summary of both trees' readings last.
"""

import argparse
import json
import os
import subprocess
import sys

READING = """
import json, sys
sys.path.insert(0, {tree!r})
from vgen_tpu_torch.scan import scanner as sc
stats = sc.benchmark_device(pattern_str={pattern!r}, min_seconds={seconds!r})
print(json.dumps({{"module": sc.__file__, "keys_per_sec": stats["keys_per_sec"],
                  "operations": stats["operations"],
                  "elapsed": stats["elapsed"]}}))
"""

RANGE_READING = """
import json, sys
sys.path.insert(0, {tree!r})
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan.host import ScanConfig
fmt, pat = AddressFormat({fmt!r}), Pattern({pattern!r})
keys = sc.DEFAULT_K_SUB * sc.DEFAULT_DEVICE_BATCH
start = 0x5EED00000000
scanner = sc.DeviceScanner(fmt)
scanner.scan(pat, ScanConfig(format=fmt, start=start, end=start + keys - 1,
                             count=0))
res = scanner.scan(pat, ScanConfig(format=fmt, start=start,
                                   end=start + 64 * keys - 1, count=0))
if res.matches:
    raise SystemExit("the pattern matched: choose one that never matches")
print(json.dumps({{"module": sc.__file__,
                  "keys_per_sec": res.operations / res.elapsed_secs,
                  "operations": res.operations,
                  "elapsed": res.elapsed_secs}}))
"""


def reading(tree: str, pattern: str, seconds: float, range_dfa=None) -> dict:
    # a tree whose port still used the JAX package's table cache keeps it
    # inside that tree
    env = dict(os.environ, VGEN_TPU_CACHE=os.path.join(tree, "build", "cache"))
    code = (READING.format(tree=tree, pattern=pattern, seconds=seconds)
            if range_dfa is None else
            RANGE_READING.format(tree=tree, pattern=pattern, fmt=range_dfa))
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=tree, env=env, capture_output=True, text=True, check=True,
        timeout=900)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if not got["module"].startswith(tree + os.sep):
        raise SystemExit(f"imported {got['module']}, not from {tree}")
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="pccppc")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pattern", default="^1BenchNeverMatches")
    ap.add_argument("--range-dfa", default=None, metavar="FORMAT",
                    help="read the range DFA rate of this address format")
    args = ap.parse_args()
    trees = {"p": os.path.abspath(args.parent), "c": os.path.abspath(args.change)}
    readings = {"p": [], "c": []}
    for i, which in enumerate(args.order):
        got = reading(trees[which], args.pattern, args.seconds,
                      args.range_dfa)
        readings[which].append(got["keys_per_sec"])
        print(json.dumps({"reading": i, "tree": which, **got}), flush=True)
    print(json.dumps({"pattern": args.pattern, "parent": readings["p"],
                      "change": readings["c"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
