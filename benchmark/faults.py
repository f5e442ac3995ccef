"""Faults planted under the timed path, to show that the check fails them.

``control.py`` reads them on the card at a cell's own size; the tests under
``benchmark/tests`` drive a whole run on the CPU with each.  A benchmark
run plants none.

- ``index_shift`` (the control): every index the device reports points one
  key further, so the host's re-derivation rejects the match and the scan
  reports less than it found, as a kernel that misplaces its answers would;
- ``half_batch``: every window checks its first half and counts all of it;
- ``frozen_state``: every super-step scans the first one's keys again;
- ``altered_match``: each match the host confirms is reported with the next
  key;
- ``reordered``: each super-step's confirmed matches are reported in the
  reverse of key order;
- ``undercount``: every window counts half its keys, so a range scan's
  reported keys and its checkpoint run past what it counted.
"""

from __future__ import annotations

import contextlib
from dataclasses import replace

FAULTS = ("none", "index_shift", "half_batch", "frozen_state",
          "altered_match", "reordered", "undercount")
CONTROL = "index_shift"


@contextlib.contextmanager
def planted(name: str, scanner):
    """Plant fault ``name`` in ``scanner`` (a DeviceScanner) and in the
    scan loop's module while the block runs."""
    from vgen_tpu_torch.ops import pipeline
    from vgen_tpu_torch.scan import scanner as loop

    saved_loop = {k: getattr(loop, k) for k in ("_host_rows",
                                                 "_derive_checked_bulk")}
    saved_obj = dict(vars(scanner))
    top = slice(2, 2 + pipeline.TOP_K)
    try:
        if name == "index_shift":
            def rows(handle, _orig=loop._host_rows):
                arr = _orig(handle).copy()
                idx = arr[:, top]
                idx[idx >= 0] += 1
                return arr
            loop._host_rows = rows
        elif name == "half_batch":
            def submit(route, base_scalars, rems, _orig=scanner._submit):
                full = rems or [scanner.batch] * len(base_scalars)
                return _orig(route, base_scalars, [r // 2 for r in full])

            def rows(handle, _orig=loop._host_rows):
                arr = _orig(handle).copy()
                arr[:, 1] *= 2
                return arr
            scanner._submit = submit
            loop._host_rows = rows
        elif name == "frozen_state":
            first = []

            def base_points(scalars, _orig=scanner._base_points):
                if not first:
                    first.extend(scalars)
                return _orig(first[:len(scalars)])
            scanner._base_points = base_points
        elif name == "altered_match":
            def bulk(keys, fmt, gen, _orig=loop._derive_checked_bulk):
                for k, ga in _orig(keys, fmt, gen):
                    yield k, (ga if ga is None
                              else replace(ga, hex=f"{k + 1:064x}"))
            loop._derive_checked_bulk = bulk
        elif name == "reordered":
            def bulk(keys, fmt, gen, _orig=loop._derive_checked_bulk):
                return reversed(list(_orig(keys, fmt, gen)))
            loop._derive_checked_bulk = bulk
        elif name == "undercount":
            def rows(handle, _orig=loop._host_rows):
                arr = _orig(handle).copy()
                arr[:, 1] //= 2
                return arr
            loop._host_rows = rows
        elif name != "none":
            raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
        yield
    finally:
        for k, v in saved_loop.items():
            setattr(loop, k, v)
        for k in set(vars(scanner)) - set(saved_obj):
            delattr(scanner, k)
