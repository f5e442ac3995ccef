"""The per-layer metrics' arithmetic: on a hand-made trace whose answers
are worked out below, and on a trace recorded on the card."""

from pathlib import Path

import pytest

from benchmark import harness, trace, work

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "prefix_trace.json"


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# a window of 100 us: kernels at 10-30 and 25-40 (overlapping), a copy at
# 60-70; the host traces nothing over 0-10, waits in cudaEventSynchronize
# over 40-60, and runs aten::to over 75-90 inside a span over 70-95
HAND = [
    _x("user_annotation", trace.WINDOW, 0, 100),
    _x("kernel", "kernel_b", 10, 20),
    _x("kernel", "kernel_a", 25, 15),
    _x("gpu_memcpy", "Memcpy DtoH", 60, 10),
    _x("kernel", "outside", 120, 10),
    _x("cuda_runtime", "cudaEventSynchronize", 40, 20),
    _x("user_annotation", "drain", 70, 25),
    _x("cpu_op", "aten::to", 75, 15),
]


def test_summary_by_hand():
    s = trace.summarize(HAND)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["kernel_s"] == pytest.approx(35e-6)
    assert s["busy_s"] == pytest.approx(40e-6)  # 10-40 and 60-70
    assert dict((k, v) for k, v in s["device_ops"]) == pytest.approx(
        {"kernel_b": 20e-6, "kernel_a": 15e-6, "Memcpy DtoH": 10e-6})
    assert dict((k, v) for k, v in s["idle_gaps"]) == pytest.approx({
        trace.NO_HOST_CALL: 10e-6,
        "cudaEventSynchronize": 20e-6,
        "aten::to": 30e-6,  # the gap 70-100: its middle lies in aten::to
    })


def test_no_window_or_no_device():
    assert trace.summarize(HAND[1:]) is None
    assert trace.summarize([HAND[0], HAND[5]]) is None


def _read(name, record):
    return harness.metric_readers("per_layer")[name].read(record)


def test_readers_by_hand():
    rec = {"scan": "random", "format": "p2pkh", "operations": 10**9,
           "scanner_build_s": 0.025,
           "device": dict(trace.summarize(HAND), keys=10**6)}
    assert _read("device_idle.random", rec) == pytest.approx(60.0)
    assert _read("device_idle.range", rec) is None
    assert _read("kernel_roofline.random", rec) == pytest.approx(
        100 * 10**6 / work.peak_keys_per_s("p2pkh") / 35e-6)
    assert _read("kernel_roofline.range", rec) is None
    assert _read("scanner_build_ms", rec) == pytest.approx(25.0)
    rec = dict(rec, scan="range", device=None)
    assert _read("kernel_roofline.range", rec) is None
    assert _read("device_idle.range", rec) is None


def _union_by_sweep(intervals):
    """Covered length of ``intervals`` by a depth count over the sorted
    endpoints (the other way round from ``trace._idle``)."""
    edges = sorted([(a, 1) for a, b in intervals] + [(b, -1)
                                                     for a, b in intervals])
    covered, depth, last = 0.0, 0, None
    for t, step in edges:
        if depth > 0:
            covered += t - last
        depth += step
        last = t
    return covered


def test_recorded_trace():
    """12 ms of a traced ``p2pkh-vanity.prefix`` window on the card."""
    events = trace.load(str(FIXTURE))
    s = trace.summarize(events)
    w = next(e for e in events if e["name"] == trace.WINDOW)
    w0, w1 = w["ts"], w["ts"] + w["dur"]

    def clipped(cats):
        return [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                for e in events if e["cat"] in cats
                and e["ts"] < w1 and e["ts"] + e["dur"] > w0]

    kernels = clipped({"kernel"})
    assert s["window_s"] == pytest.approx(0.012)
    assert s["kernel_s"] == pytest.approx(sum(b - a for a, b in kernels)
                                          / 1e6)
    busy = _union_by_sweep(clipped(trace.DEVICE_CATS)) / 1e6
    assert s["busy_s"] == pytest.approx(busy)
    idle = sum(v for _, v in s["idle_gaps"])
    assert idle == pytest.approx(s["window_s"] - s["busy_s"])
    names = [n for n, _ in s["device_ops"]]
    assert "interval_kernel" in names[0] and "inv_dx_kernel" in names[1]
    keys = 3 * 8 * 524288 * 6  # three super-steps of the cell
    rec = {"scan": "random", "format": "p2pkh", "scanner_build_s": 0.1,
           "device": dict(s, keys=keys)}
    assert _read("device_idle.random", rec) == pytest.approx(
        100 * (1 - busy / 0.012))
    assert _read("kernel_roofline.random", rec) == pytest.approx(
        100 * keys / work.peak_keys_per_s("p2pkh") / s["kernel_s"])
