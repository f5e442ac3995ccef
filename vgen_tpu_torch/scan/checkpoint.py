"""Checkpoint/resume for long range scans.

The reference never persists scan position -- a killed range scan restarts
from --range (SURVEY.md §5 flags this as a real gap for pod-scale scans).
Here: a JSON cursor file, written atomically and throttled, recording the
contiguous-completed prefix of the range plus matches found so far.  The
scan loops call ``advance()`` after each completed batch window; ``load()``
refuses to resume when the scan parameters changed.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional


class CheckpointManager:
    """Atomic, throttled cursor persistence for one range scan."""

    def __init__(
        self,
        path: str,
        *,
        pattern: str,
        fmt: str,
        start: int,
        end: int,
        save_interval_secs: float = 5.0,
    ):
        self.path = path
        self.meta = {
            "pattern": pattern,
            "format": fmt,
            "start": hex(start),
            "end": hex(end),
        }
        self.save_interval = save_interval_secs
        self._last_save = 0.0
        self._match_keys: List[str] = []
        self._next_key = start
        self._operations = 0

    # -- loading -----------------------------------------------------------

    def load(self) -> Optional[dict]:
        """Return resume state if the file exists and matches this scan's
        parameters; None otherwise (fresh start)."""
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None
        if {k: data.get(k) for k in self.meta} != self.meta:
            return None
        try:
            state = {
                "next_key": int(data["next_key"], 16),
                "operations": int(data["operations"]),
                "match_keys": [int(k, 16) for k in data.get("matches", [])],
            }
        except (KeyError, ValueError):
            return None
        self._next_key = state["next_key"]
        self._operations = state["operations"]
        self._match_keys = [hex(k) for k in state["match_keys"]]
        return state

    def set_matches(self, match_keys: List[int]) -> None:
        """Replace the match list, once before a scan's first ``advance``:
        after a resume, the stored keys that still derive."""
        self._match_keys = [hex(k) for k in match_keys]

    # -- saving ------------------------------------------------------------

    def advance(self, next_key: int, operations: int,
                new_keys: List[int], force: bool = False) -> None:
        """Record that keys below ``next_key`` are fully scanned, and append
        ``new_keys``, the matches found since the previous call, in key
        order: a call costs its new keys, not all the scan has found."""
        from vgen_tpu_torch import tracing

        self._next_key = next_key
        self._operations = operations
        self._match_keys.extend(hex(k) for k in new_keys)
        tracing.count("checkpoint_matches", len(new_keys))
        now = time.time()
        if force or now - self._last_save >= self.save_interval:
            self._write()
            self._last_save = now

    def finalize(self) -> None:
        self._write()

    def _write(self) -> None:
        from vgen_tpu_torch import tracing

        data = dict(self.meta)
        data["next_key"] = hex(self._next_key)
        data["operations"] = self._operations
        data["matches"] = self._match_keys
        data["saved_at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2)
            size = f.tell()
        os.replace(tmp, self.path)  # atomic on POSIX
        tracing.count("checkpoint_writes")
        tracing.count("checkpoint_bytes", size)

    def remove(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass
