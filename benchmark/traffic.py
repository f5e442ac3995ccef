"""The one traffic generator: a cell's file and a seed -> the scan's inputs.

A cell file (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and its traffic:

- ``"scan": "random"`` with a ``"pattern"``: a random scan, as ``vgen
  generate -p <pattern> -c 0``.  The program draws the start itself.
- ``"scan": "range"``: a range scan of the configuration's key range from a
  start drawn from the seed in [range_start, range_end + 1 - chunk_keys],
  to range_end, as ``vgen range ... -c 0 --checkpoint``.  Its pattern,
  ``"prefix_length": n``, is the first n characters of the configuration's
  address as the CLI's ``--prefix-length`` builds it.

The same seed gives the same inputs.
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass
from typing import Optional



@dataclass
class Inputs:
    pattern: str
    start: Optional[int] = None  # None: a random scan
    end: Optional[int] = None


def make(cell: dict, seed: int) -> Inputs:
    rng = random.Random(seed)
    conf = cell["config_spec"]
    if cell["scan"] == "random":
        return Inputs(pattern=cell["pattern"])
    if cell["scan"] != "range":
        raise ValueError(f"unknown scan {cell['scan']!r}")
    lo, hi = int(conf["range_start"], 16), int(conf["range_end"], 16)
    start = rng.randrange(lo, hi + 2 - conf["chunk_keys"])
    pattern = "^" + re.escape(conf["address"][:cell["prefix_length"]])
    return Inputs(pattern=pattern, start=start, end=hi)
