"""The readers of the range cell's idle split, ``idle_drain.range`` and
``idle_submit.range``: on a hand-made trace whose answers are worked out
below, through ``trace.summarize``."""

import pytest

from benchmark import harness, trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# a window of 100 us.  The device is busy over 0-10, 20-21, 30-45, 50-55
# (a copy), 56-58 and 85-90: 38 us.  The host submits over 10-30 (base
# points over 11-20, a launch over 27-30) and drains over 40-80 (the wait
# over 40-45, a torch op over 46-49, the checkpoint over 60-75).  Each idle
# gap goes to the innermost host event at its middle:
#   10-20 (15)   vgen.submit.base_points  10 us
#   21-30 (25.5) vgen.submit               9 us (the launch starts at 27)
#   45-50 (47.5) aten::copy_               5 us (inside the drain)
#   55-56 (55.5) vgen.drain                1 us
#   58-85 (71.5) vgen.drain.checkpoint    27 us
#   90-100 (95)  no traced host call      10 us
HAND = [
    _x("user_annotation", trace.WINDOW, 0, 100),
    _x("kernel", "inv_dx_kernel", 0, 10),
    _x("kernel", "inv_dx_kernel", 20, 1),
    _x("kernel", "range_tile_kernel", 30, 15),
    _x("gpu_memcpy", "Memcpy DtoH", 50, 5),
    _x("kernel", "topk", 56, 2),
    _x("kernel", "inv_dx_kernel", 85, 5),
    _x("user_annotation", "vgen.submit", 10, 20),
    _x("user_annotation", "vgen.submit.base_points", 11, 9),
    _x("cuda_runtime", "cudaLaunchKernel", 27, 3),
    _x("user_annotation", "vgen.drain", 40, 40),
    _x("user_annotation", "vgen.drain.wait", 40, 5),
    _x("cpu_op", "aten::copy_", 46, 3),
    _x("user_annotation", "vgen.drain.checkpoint", 60, 15),
]


def _read(name, record):
    return harness.metric_readers("per_layer")[name].read(record)


def _record(scan, device):
    return {"scan": scan, "format": "p2pkh", "operations": 10**9,
            "scanner_build_s": 0.025, "device": device}


def test_span_readers_by_hand():
    s = trace.summarize(HAND)
    assert dict((k, v) for k, v in s["idle_gaps"]) == pytest.approx({
        "vgen.submit.base_points": 10e-6,
        "vgen.submit": 9e-6,
        "aten::copy_": 5e-6,
        "vgen.drain": 1e-6,
        "vgen.drain.checkpoint": 27e-6,
        trace.NO_HOST_CALL: 10e-6,
    })
    rec = _record("range", dict(s, keys=10**6))
    drain = _read("idle_drain.range", rec)
    submit = _read("idle_submit.range", rec)
    assert drain == pytest.approx(28.0)  # 1 + 27 of 100 us
    assert submit == pytest.approx(19.0)  # 10 + 9 of 100 us
    assert _read("device_idle.range", rec) == pytest.approx(62.0)
    assert drain + submit < _read("device_idle.range", rec)


def test_span_readers_on_a_random_scan():
    rec = _record("random", dict(trace.summarize(HAND), keys=10**6))
    assert _read("idle_drain.range", rec) is None
    assert _read("idle_submit.range", rec) is None


def test_span_readers_untraced_or_without_gaps():
    for name in ("idle_drain.range", "idle_submit.range"):
        assert _read(name, _record("range", None)) is None
        # a breakdown that names no idle gap: no span reads any idle time
        no_gaps = {"kernel_s": 0.9, "busy_s": 0.95, "window_s": 1.0,
                   "keys": 10**8}
        assert _read(name, _record("range", no_gaps)) == 0.0


def test_span_readers_without_the_programs_spans():
    """A program that records no span (the idle gaps name only torch's
    events and Python) reads nothing, where a traced run of it would
    otherwise read 0."""
    plain = [e for e in HAND if not e["name"].startswith("vgen.")]
    s = trace.summarize(plain)
    assert s["idle_gaps"]
    rec = _record("range", dict(s, keys=10**6))
    assert _read("idle_drain.range", rec) is None
    assert _read("idle_submit.range", rec) is None
    assert _read("device_idle.range", rec) == pytest.approx(62.0)
