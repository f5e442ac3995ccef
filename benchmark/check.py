"""The comparison that decides ``correct``: what the timed scan reported,
against the plain reference (``benchmark/reference``).

Each number counts a failure, so that a larger number is worse.  A cell
compares the numbers its file gives limits for (``"limits"``):

- ``wrong_matches``: reported matches (all, or a sample drawn from the seed
  with the first and the last) whose key the reference derives to another
  address or WIF, or to none, or whose address the pattern (Python's
  ``re``) does not match;
- ``match_deficit``: -log10 of the Poisson chance of finding no more matches
  than were reported, for the keys the scan counted at the reference's
  share of matching addresses.  Left-out keys, lost answers and answers
  pointing at the wrong key all show here;
- range scans: ``out_of_order`` (neighbours not in rising key order),
  ``out_of_range`` (keys outside the keys the scan counted, from the
  start) and ``checkpoint_off`` (the checkpoint file does not record the
  keys counted and the matches reported).

The derivation and the share are the configuration's format's
(``reference/formats/<format>.py``), so a cell of another format adds
that file and edits none here.
"""

from __future__ import annotations

import importlib.util
import math
import random
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

FORMATS = Path(__file__).resolve().parent / "reference" / "formats"
COUNTS = ("wrong_matches", "out_of_order", "out_of_range", "checkpoint_off")


def poisson_deficit(found: int, mean: float) -> float:
    """-log10 P(X <= found) for X ~ Poisson(mean)."""
    if mean <= 0:
        return 0.0
    k = np.arange(found + 1, dtype=np.float64)
    lgam = np.array([math.lgamma(i + 1) for i in range(found + 1)])
    logp = -mean + k * math.log(mean) - lgam
    top = logp.max()
    log_cdf = top + math.log(np.exp(logp - top).sum())
    return max(0.0, -log_cdf / math.log(10))


def _sample(items: List, n: int, rng: random.Random) -> List:
    if len(items) <= n:
        return list(items)
    middle = rng.sample(items[1:-1], n - 2)
    return [items[0]] + middle + [items[-1]]


def format_reference(fmt: str):
    """The plain reference of the address format ``fmt``:
    ``reference/formats/<fmt>.py``, with ``derive_many`` and ``share``."""
    path = FORMATS / f"{fmt}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"no reference for the address format {fmt!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark_format_{fmt}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def judge(cell: dict, inputs, matches, operations: int, seed: int,
          checkpoint: Optional[dict]) -> Dict[str, float]:
    """The numbers the cell compares (the keys of its ``"limits"``) for one
    run.  ``matches``: (key, address, wif) as the scan reported them, in
    its order; ``checkpoint``: the checkpoint file's contents after the
    scan (range scans)."""
    ref = format_reference(cell["config_spec"]["format"])
    rng = random.Random(f"check:{seed}")
    pat = re.compile(inputs.pattern)
    keys = [k for k, _, _ in matches]
    lo, hi = inputs.start, (inputs.start or 0) + operations  # counted: [lo, hi)

    def wrong_matches():
        picked = _sample(matches, cell.get("sample_matches", 512), rng)
        derived = ref.derive_many([k for k, _, _ in picked])
        return sum(1 for (_, a, w), r in zip(picked, derived)
                   if r is None or (a, w) != r or not pat.search(r[0]))

    def match_deficit():
        share = float(ref.share(inputs.pattern))
        return poisson_deficit(len(matches), operations * share)

    def checkpoint_off():
        return int(checkpoint is None
                   or int(checkpoint["next_key"], 16) != hi
                   or checkpoint["operations"] != operations
                   or [int(k, 16) for k in checkpoint["matches"]] != keys)

    numbers = {
        "wrong_matches": wrong_matches,
        "match_deficit": match_deficit,
        "out_of_order": lambda: sum(1 for a, b in zip(keys, keys[1:])
                                    if a >= b),
        "out_of_range": lambda: sum(1 for k in keys if not lo <= k < hi),
        "checkpoint_off": checkpoint_off,
    }
    unknown = set(cell["limits"]) - set(numbers)
    if unknown:
        raise KeyError(f"no such number: {sorted(unknown)}")
    return {name: numbers[name]() for name in cell["limits"]}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, failed, {name: {"value", "limit"}}): every number at or
    under its limit; failed sums the counts."""
    table = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in table.values())
    failed = int(sum(numbers.get(n, 0) for n in COUNTS))
    return correct, failed, table
