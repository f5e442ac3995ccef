"""``vgen_tpu_torch/tracing.py``: the spans and counters of the scan loop
record only while a ``torch.profiler`` records, land in its Chrome trace,
and ``--profile`` writes them beside the trace; with no profiler they do
nothing."""

import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch import cli, tracing
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan.checkpoint import CheckpointManager
from vgen_tpu_torch.scan.host import ScanConfig

B = 256
SPANS = ("vgen.submit", "vgen.submit.base_points", "vgen.drain",
         "vgen.drain.wait", "vgen.drain.recover", "vgen.drain.derive",
         "vgen.drain.checkpoint")
# keys 1-512 hold 34 addresses with the prefix ^1C, and the window of keys
# 258-513 holds 21 of them, more than TOP_K (16): an overflow recovery
PATTERN, END = "^1C", 512


def _range_scan(scanner, tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "scan.ckpt"), pattern=PATTERN,
                             fmt="p2pkh", start=1, end=END)
    return scanner.scan(Pattern(PATTERN),
                        ScanConfig(start=1, end=END, count=0, checkpoint=ckpt))


def test_import_loads_nothing_beyond_torch():
    code = ("import sys, torch; before = set(sys.modules); "
            "import vgen_tpu_torch.tracing; "
            "print(sorted(set(sys.modules) - before))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert json.loads(out.replace("'", '"')) == ["vgen_tpu_torch",
                                                 "vgen_tpu_torch.tracing"]


def test_no_profiler_no_record(tmp_path, monkeypatch):
    """With no profiler, a span is the shared no-op and no torch call is
    made: a range scan runs with ``record_function`` raising."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("vgen.drain") is tracing.NOOP

    def fail(*args, **kwargs):
        raise AssertionError("record_function called")

    monkeypatch.setattr(torch.profiler, "record_function", fail)
    tracing.reset()
    scanner = sc.DeviceScanner(AddressFormat.P2PKH, B, "cpu", k_sub=1)
    res = _range_scan(scanner, tmp_path)
    assert len(res.matches) == 34
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}
    # the start stages keep their host-clock time all the same
    assert {"start.tables", "start.route", "start.first_step"} <= set(
        snap["start"])


def test_profiler_flag_flips():
    """The private flag the gate reads, on the installed torch."""
    prof = profile(activities=[ProfilerActivity.CPU])
    assert not torch.autograd.profiler._is_profiler_enabled
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled
    finally:
        prof.stop()
    assert not torch.autograd.profiler._is_profiler_enabled


def test_spans_under_a_profiler(tmp_path):
    tracing.reset()
    scanner = sc.DeviceScanner(AddressFormat.P2PKH, B, "cpu", k_sub=1)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        res = _range_scan(scanner, tmp_path)
    finally:
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert set(SPANS) <= annotated

    snap = tracing.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    assert set(spans) == set(SPANS)
    assert spans["vgen.drain"]["count"] == counters["super_steps"] == 2
    assert spans["vgen.submit"]["count"] == 2
    assert counters["matches"] == len(res.matches) == 34
    assert counters["candidates"] >= counters["matches"]
    assert counters["overflow_recoveries"] == 1
    assert counters["checkpoint_writes"] >= 1
    assert counters["checkpoint_bytes"] > 0
    assert counters["launches"] == 0  # plain versions launch no kernel
    # the keys the super-steps counted, under the format and route that
    # checked them; key 1 is checked on the host
    assert {n: c for n, c in counters.items() if n.startswith("keys.")} == {
        "keys.p2pkh.intervals": res.operations - 1}
    for name, s in spans.items():
        assert 0 <= s["self_s"] <= s["total_s"], name
    # the drain's children nest in it
    children = sum(spans[n]["total_s"] for n in SPANS
                   if n.startswith("vgen.drain."))
    assert spans["vgen.drain"]["self_s"] == pytest.approx(
        spans["vgen.drain"]["total_s"] - children, abs=1e-6)
    assert {"start.tables", "start.route", "start.first_step"} <= set(
        snap["start"])


def test_profile_writes_the_spans_beside_the_trace(tmp_path):
    out = tmp_path / "trace"
    assert cli.run_from_args(
        ["range", "-p", PATTERN, "--range", "1:800", "--no-tui", "--quiet",
         "--backend", "cpu", "--device-batch-size", str(B),
         "--profile", str(out)]) == 0
    traces = list(out.glob("vgen_tpu_torch_scan_*.json"))
    spans = list(out.glob("vgen_tpu_torch_spans_*.json"))
    assert len(traces) == 1 and len(spans) == 1
    assert traces[0].name.split("_")[-1] == spans[0].name.split("_")[-1]
    snap = json.loads(spans[0].read_text())
    assert set(snap) == {"start", "spans", "counters"}
    assert snap["spans"]["vgen.drain"]["count"] == snap["counters"][
        "super_steps"] >= 1
