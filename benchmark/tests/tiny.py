"""Cells small enough for the port's plain versions on the CPU, written as
files beside copies of the benchmark's own, as a later cell would be."""

import json
import shutil
from pathlib import Path

from benchmark import harness

TINY_CONFIGS = {
    "tiny-vanity": {"format": "p2pkh", "batch": 32, "k_sub": 2,
                    "in_flight": 4},
    "tiny-range": {"format": "p2pkh", "batch": 256, "k_sub": 2,
                   "in_flight": 4,
                   "address": "1PWo3JeB9jrGwfHDNpdGK54CRas7fsVzXU",
                   "range_start": "0x400000000000000000",
                   "range_end": "0x7fffffffffffffffff",
                   "chunk_keys": 2**20, "checkpoint": True,
                   "checkpoint_save_interval_s": 5.0},
    # kernels A, F, G and H's plain versions, on the ladder table's host
    # build (npz-cached); a super-step's time hardly grows with the batch,
    # so 256 puts enough keys in a window for the control to fail
    "tiny-p2tr": {"format": "p2tr", "batch": 256, "k_sub": 2,
                  "in_flight": 4},
}
TINY_CELLS = {
    # ^1K: about 8 matches a window of 32 positions, 6 keys each, under
    # the 16 a packed row reports
    "tiny-vanity.prefix": {"config": "tiny-vanity", "chips": 1,
                           "scan": "random", "pattern": "^1K",
                           "limits": {"wrong_matches": 0,
                                      "match_deficit": 5.0}},
    "tiny-range.prefix": {"config": "tiny-range", "chips": 1,
                          "scan": "range", "prefix_length": 2,
                          "sample_matches": 64,
                          "limits": {"wrong_matches": 0, "out_of_order": 0,
                                     "out_of_range": 0, "checkpoint_off": 0,
                                     "match_deficit": 5.0}},
    # ^bc1pq: 1 key in 32, about 8 matches a window of 256, under the 16 a
    # packed row reports
    "tiny-p2tr.prefix": {"config": "tiny-p2tr", "chips": 1,
                         "scan": "random", "pattern": "^bc1pq",
                         "limits": {"wrong_matches": 0,
                                    "match_deficit": 5.0}},
}


def tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark's cells and configurations with the tiny ones
    added as files."""
    root = tmp / "benchmark"
    for d in ("configs", "workloads"):
        shutil.copytree(harness.ROOT / d, root / d, dirs_exist_ok=True)
    for name, conf in TINY_CONFIGS.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(conf))
    for name, cell in TINY_CELLS.items():
        (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return root
