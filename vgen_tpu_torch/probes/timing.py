"""Timing for the probe tools, on the card only: the card's identity, the
SM clock sampled while a probe runs, the two-point delta cost with its
noise floor, and the opcode counts of a kernel's loop from its SASS.

A probe's cost is (t(2R) - t(R)) / R, each t a CUDA-event time of one
launch: launch overhead and the loads and stores cancel.  R doubles until
the delta clears a noise floor measured from repeated t(R) and t(2R)
(five times their spread, at least ``MIN_FLOOR_MS``), the method of
``scripts/roofline.py``; a delta that never clears it is an error, not a
zero.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import threading
import time
from collections import Counter
from typing import Callable, Dict, Optional

import torch

MIN_FLOOR_MS = 1.0
CLOCK_WINDOW_S = 0.3


def smi_query(fields: str) -> str:
    """One line of ``nvidia-smi --query-gpu=<fields>`` for card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Card:
    """The card the tools measure: name and power limit as nvidia-smi
    gives them (printed beside every number), SM count, and SM clocks per
    second at the maximum SM clock (the bound model's).  Raises SystemExit
    where no CUDA card is visible: the tools measure the card and nothing
    else."""

    def __init__(self):
        if not torch.cuda.is_available():
            raise SystemExit("error: the probe tools measure a CUDA card, and "
                             "none is visible")
        self.device = torch.device("cuda", 0)
        self.smi = smi_query("name,power.limit")
        self.sm_count = torch.cuda.get_device_properties(
            self.device).multi_processor_count
        self.sm_clocks_per_s = (self.sm_count * 1e6
                                * float(smi_query("clocks.max.sm").split()[0]))

    def tag(self) -> str:
        return f"({self.smi})"


class ClockSampler:
    """``nvidia-smi`` sampling the SM clock every 50 ms in the background,
    each reading stamped with the host clock; ``mean_mhz(t0, t1)`` averages
    the readings of a window.  A context manager: the sampler stops on
    exit."""

    def __init__(self):
        self.samples = []
        self._proc = None
        self._thread = None

    def __enter__(self):
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()
        return self

    def _read(self):
        for line in self._proc.stdout:
            try:
                self.samples.append((time.time(), float(line.split()[0])))
            except (ValueError, IndexError):
                continue

    def __exit__(self, *exc):
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._thread.join(timeout=10)

    def mean_mhz(self, t0: float, t1: float) -> Optional[float]:
        window = [mhz for t, mhz in list(self.samples) if t0 <= t <= t1]
        return sum(window) / len(window) if window else None


def event_ms(fn: Callable[[], object]) -> float:
    """Milliseconds of one call of fn() by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def launch_ms(fn: Callable[[], object], reps: int = 10) -> float:
    """Milliseconds per call of fn(): the best of five event-timed runs of
    ``reps`` calls back to back, after one warm-up call."""
    fn()
    return min(event_ms(lambda: [fn() for _ in range(reps)])
               for _ in range(5)) / reps


def in_turns(turns: Dict[str, Callable[[], object]], tag: str,
             rounds: int = 5) -> Dict[str, float]:
    """``rounds`` alternating rounds (forward, then backward) of the named
    calls, each timed by ``launch_ms`` -> {name: median ms}, each reading
    printed with ``tag``."""
    readings = {name: [] for name in turns}
    for r in range(rounds):
        for name in (list(turns) if r % 2 == 0 else list(turns)[::-1]):
            readings[name].append(launch_ms(turns[name]))
    med = {name: statistics.median(v) for name, v in readings.items()}
    for name, v in readings.items():
        print(f"in turns, {name}: median {med[name]:.4f} ms of "
              f"{', '.join(f'{x:.4f}' for x in v)} {tag}", flush=True)
    return med


def delta_ms(run: Callable[[int], object], reps: int):
    """(t(R), t(2R), t(2R) - t(R)) in ms, each the best of five
    event-timed launches after one warm-up launch, as ``measure`` takes
    them: the cost of R repetitions, measured once (no search for R)."""
    run(reps)
    run(2 * reps)
    t1 = min(event_ms(lambda: run(reps)) for _ in range(5))
    t2 = min(event_ms(lambda: run(2 * reps)) for _ in range(5))
    return t1, t2, t2 - t1


def measure(run: Callable[[int], object], reps0: int, max_reps: int,
            clocks: ClockSampler) -> Dict:
    """The two-point cost of ``run(reps)``: R doubles from ``reps0`` until
    t(2R) - t(R) (best of five each) clears the noise floor, then
    the launch at 2R repeats for ``CLOCK_WINDOW_S`` while ``clocks``
    samples the SM clock.  -> {reps, t1_ms, t2_ms, delta_ms, floor_ms,
    mhz}, or with "error" set where the delta never cleared the floor by
    ``max_reps`` or no clock reading fell in the window."""
    reps = reps0
    while True:
        run(reps)
        run(2 * reps)
        t1s = sorted(event_ms(lambda: run(reps)) for _ in range(5))
        t2s = sorted(event_ms(lambda: run(2 * reps)) for _ in range(5))
        spread = max(t1s[1] - t1s[0], t2s[1] - t2s[0])
        res = {"reps": reps, "t1_ms": t1s[0], "t2_ms": t2s[0],
               "delta_ms": t2s[0] - t1s[0],
               "floor_ms": max(5 * spread, MIN_FLOOR_MS)}
        if res["delta_ms"] >= res["floor_ms"]:
            break
        if 2 * reps > max_reps:
            res["error"] = "delta below the noise floor at the largest R"
            return res
        reps *= 2
    t0 = time.time()
    while time.time() - t0 < CLOCK_WINDOW_S:
        run(2 * reps)
        torch.cuda.synchronize()
    res["mhz"] = clocks.mean_mhz(t0, time.time())
    if res["mhz"] is None:
        res["error"] = "no SM clock reading in the window"
    return res


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "cuobjdump")


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")


def _opcode(text: str) -> str:
    op = _PRED.sub("", text).split()[0]
    return ".".join(op.split(".")[:2])


def loop_opcodes(sass: str) -> Counter:
    """Opcode counts (name and first modifier) of the widest loop of one
    function's SASS: the instructions from a backward branch's target to
    the branch."""
    instrs = []
    for m in _INSTR.finditer(sass):
        text = m.group(2).strip()
        if text:
            instrs.append((int(m.group(1), 16), text))
    best = None
    for addr, text in instrs:
        if _opcode(text).split(".")[0] != "BRA":
            continue
        t = _TARGET.search(text)
        if t and int(t.group(1), 16) < addr:
            span = (int(t.group(1), 16), addr)
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    if best is None:
        return Counter()
    return Counter(_opcode(text) for addr, text in instrs
                   if best[0] <= addr <= best[1])


def template_args(kernel: str, mangled: str) -> Optional[tuple]:
    """The integer (and bool, as 0/1) template arguments of an instance of
    the kernel template ``kernel`` from its mangled name, () for the kernel
    ``kernel`` that is no template, or None for another function."""
    m = re.search(kernel + r"I((?:L[bi]\d+E)+)E", mangled)
    if m is None:
        return () if f"{len(kernel)}{kernel}E" in mangled else None
    return tuple(int(x) for x in re.findall(r"L[bi](\d+)E", m.group(1)))


def kernel_loops(library: str, kernel: str) -> Dict[tuple, Counter]:
    """{template arguments: loop opcode counts} for every instance of the
    kernel template ``kernel`` in the library, from ``cuobjdump -sass``."""
    out = subprocess.run([cuobjdump(), "-sass", library], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    loops = {}
    for part in out.split("Function : ")[1:]:
        args = template_args(kernel, part.split(None, 1)[0])
        if args is not None:
            loops[args] = loop_opcodes(part)
    return loops


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_figures(log: str, kernel: str) -> Dict[tuple, Dict[str, int]]:
    """{template arguments: {regs, stack, spill_stores, spill_loads}} of
    every instance of the kernel template ``kernel`` in an nvcc log of
    ``-Xptxas -v`` (``build.build_log``)."""
    figures, current = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = template_args(kernel, m.group(1))
            if current is not None:
                figures[current] = {}
            continue
        if current is None:
            continue
        m = _STACK.search(line)
        if m:
            figures[current].update(zip(("stack", "spill_stores",
                                         "spill_loads"),
                                        map(int, m.groups())))
        m = _REGS.search(line)
        if m:
            figures[current]["regs"] = int(m.group(1))
    return figures


def ptxas_text(fig: Optional[Dict[str, int]]) -> str:
    if not fig:
        return "not in the build log"
    text = f"{fig.get('regs', '?')} regs"
    if fig.get("stack"):
        text += f", {fig['stack']} B stack"
    if fig.get("spill_stores") or fig.get("spill_loads"):
        text += (f", spills {fig.get('spill_stores', 0)} B stored / "
                 f"{fig.get('spill_loads', 0)} B loaded")
    else:
        text += ", no spill"
    return text


def opcode_text(counts: Counter, per: int = 1) -> str:
    """'OP n, ...' by count, each divided by ``per`` (loop iterations per
    repetition unrolled)."""
    return ", ".join(f"{op} {n / per:g}" for op, n in counts.most_common())
