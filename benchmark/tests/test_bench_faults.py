"""Whole runs on the CPU (the harness's look for a card skipped) with the
timed path broken underneath: the check has to come out false for the
control and for each fault a cell can have, and true with none."""

import io
import json
import time

import pytest

from benchmark import faults, harness, run
from benchmark.tests import tiny

SECONDS = 6.0


def _run(tmp_path, monkeypatch, name, fault, seed):
    cell = harness.load_cell(name, tiny.tiny_root(tmp_path))
    window = harness.Scan.window

    def broken(self, *args, **kwargs):
        with faults.planted(fault, self.scanner):
            return window(self, *args, **kwargs)

    monkeypatch.setattr(harness.Scan, "window", broken)
    out = io.StringIO()
    assert run.run(cell, seed, SECONDS, 0, "cpu", time.perf_counter(),
                   out=out) == 0
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("name", ["tiny-vanity.prefix", "tiny-range.prefix",
                                  "tiny-p2tr.prefix"])
def test_sound(tmp_path, monkeypatch, name):
    line = _run(tmp_path, monkeypatch, name, "none", 2**31 + 99)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["wrong_matches"]["value"] == 0


# a fault that checks half of each window and counts all of it fails by the
# match deficit whatever the seed, not by the luck of one key
HALF = [(name, "half_batch", "match_deficit", seed)
        for name in ("tiny-vanity.prefix", "tiny-range.prefix")
        for seed in (2**31 + 7, 2**31 + 11, 2**31 + 12)]


@pytest.mark.parametrize("name, fault, failing, seed", [
    ("tiny-vanity.prefix", "index_shift", "match_deficit", 2**31 + 7),
    ("tiny-vanity.prefix", "frozen_state", "match_deficit", 2**31 + 7),
    ("tiny-vanity.prefix", "altered_match", "wrong_matches", 2**31 + 7),
    ("tiny-range.prefix", "index_shift", "match_deficit", 2**31 + 7),
    ("tiny-range.prefix", "frozen_state", "match_deficit", 2**31 + 7),
    ("tiny-range.prefix", "altered_match", "wrong_matches", 2**31 + 7),
    ("tiny-range.prefix", "reordered", "out_of_order", 2**31 + 7),
    ("tiny-range.prefix", "undercount", "out_of_range", 2**31 + 7),
    ("tiny-range.prefix", "undercount", "checkpoint_off", 2**31 + 7),
    ("tiny-p2tr.prefix", "index_shift", "match_deficit", 2**31 + 7),
    ("tiny-p2tr.prefix", "altered_match", "wrong_matches", 2**31 + 7),
] + HALF)
def test_fault_fails(tmp_path, monkeypatch, name, fault, failing, seed):
    line = _run(tmp_path, monkeypatch, name, fault, seed)
    assert line["correct"] is False
    check = line["checks"][failing]
    assert check["value"] > check["limit"], line["checks"]
