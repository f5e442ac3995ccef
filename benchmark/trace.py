"""Reading a ``torch.profiler`` Chrome trace of the measured window.

The window is the host span named ``WINDOW`` that the harness records
around the scan.  Device activity is every kernel, copy and memset inside
it; the host events say what the host was doing while the device sat
idle.  Times in the trace are microseconds.
"""

from __future__ import annotations

import heapq
import json
from collections import defaultdict
from typing import Dict, List, Optional

WINDOW = "benchmark.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
NO_HOST_CALL = "no traced host call (Python)"
TOP = 10


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _window(events: List[dict]):
    for e in events:
        if e.get("name") == WINDOW and e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def _clip(events, cats, w0, w1):
    out = []
    for e in events:
        if e.get("cat") in cats:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                out.append((a, b, e["name"], e["cat"]))
    out.sort()
    return out


def _idle(device, w0, w1):
    """(busy microseconds, idle gaps as (start, end)) of the union of the
    device intervals over [w0, w1]."""
    busy, gaps, t = 0.0, [], w0
    for a, b, _, _ in device:
        if a > t:
            gaps.append((t, a))
        if b > t:
            busy += b - max(a, t)
            t = b
    if w1 > t:
        gaps.append((t, w1))
    return busy, gaps


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Idle microseconds by the innermost host event at each gap's middle:
    of the events that contain it, the one that started last."""
    by_label: Dict[str, float] = defaultdict(float)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    active: list = []
    j = 0
    for i in order:
        a, b = gaps[i]
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(active, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        by_label[active[0][2] if active else NO_HOST_CALL] += b - a
    return by_label


def summarize(events: List[dict]) -> Optional[dict]:
    """The window's device time: kernel seconds (summed), busy seconds
    (the union of all device activity), the window's length, the device
    operations that took most time and the idle time by what the host was
    doing.  None when the trace holds no window or no device activity."""
    w = _window(events)
    if w is None:
        return None
    w0, w1 = w
    device = _clip(events, DEVICE_CATS, w0, w1)
    if not device:
        return None
    host = [h for h in _clip(events, HOST_CATS, w0, w1) if h[2] != WINDOW]
    kernel_us = sum(b - a for a, b, _, cat in device if cat == "kernel")
    busy_us, gaps = _idle(device, w0, w1)
    by_op: Dict[str, float] = defaultdict(float)
    for a, b, name, _ in device:
        by_op[name] += b - a
    idle = _label_gaps(gaps, host)

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "kernel_s": kernel_us / 1e6,
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": top(by_op),
        "idle_gaps": top(idle),
    }
