"""Cells, configurations and metrics found by name, and one cell's scan:
set-up, warm-up and the measured window.

Everything that belongs to one cell, configuration or metric is a file of
its own under ``benchmark/``: ``workloads/<cell>.json`` (its
configuration's name, its traffic, its checks' limits),
``configs/<config>.json`` (the deployment), ``metrics/<metric>.py`` (a
reader with ``KIND``, ``UNIT`` and ``read(record)``, which returns None
where it finds nothing to read).  Adding a cell, a configuration or a
metric adds files and edits none.

The program is ``vgen_tpu_torch``; the harness drives the entry a scan on
one card takes (``scan_with_progress``): ``DeviceScanner.scan`` with a
``ScanConfig`` built as the CLI builds it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vgen_tpu")


def load_cell(name: str, root: Path = ROOT) -> dict:
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no workload {name!r} ({path})")
    cell = json.loads(path.read_text())
    cell["name"] = name
    cell["config_spec"] = json.loads(
        (root / "configs" / f"{cell['config']}.json").read_text())
    return cell


def cell_names(root: Path = ROOT):
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def metric_readers(kind: str, root: Path = ROOT) -> Dict[str, object]:
    """{metric name: its reader module} of one kind ("end_to_end" or
    "per_layer"), from ``metrics/<name>.py``."""
    readers = {}
    for path in sorted((root / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if mod.KIND == kind:
            readers[path.stem] = mod
    return readers


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def checkpoint_path(cell_name: str) -> str:
    """A fixed path under the temporary directory the run is given."""
    d = os.path.join(tempfile.gettempdir(), "vgen-benchmark")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{cell_name}.checkpoint.json")


class Tracer:
    """A ``torch.profiler`` over the last ``seconds`` of a window, from the
    first drain past that point to the scan's return, inside a span named
    ``trace.WINDOW``.  ``keys``: the keys counted from its start; they
    include the super-steps in flight when it started (at most in_flight
    - 1), whose kernels may have run before."""

    def __init__(self, profiler, window_s: float, seconds: float):
        from torch.profiler import record_function

        from benchmark.trace import WINDOW

        self.profiler = profiler
        self.start_at = window_s - seconds
        self.span = record_function(WINDOW)
        self.started = False
        self.keys = None

    def reached(self, t: float, ops: int) -> None:
        if not self.started and t >= self.start_at:
            self.started = True
            self.profiler.start()
            self.span.__enter__()
            self._ops0 = ops

    def stop(self, ops: int) -> None:
        if self.started:
            self.span.__exit__(None, None, None)
            self.profiler.stop()
            self.keys = ops - self._ops0


class Scan:
    """One cell's scanner, built once, and its scans."""

    def __init__(self, cell: dict, device: str = "cuda"):
        import torch
        from vgen_tpu_torch import native
        from vgen_tpu_torch.crypto.address import AddressFormat
        from vgen_tpu_torch.scan.scanner import DeviceScanner

        conf = cell["config_spec"]
        self.cell, self.device = cell, device
        # the drain re-derives reported keys with the native library; without
        # it the program takes its Python path and the run measures that
        if not native.available():
            raise RuntimeError("the native library did not load: "
                               f"{native.build_error()}")
        self.fmt = AddressFormat.from_str(conf["format"])
        t = time.perf_counter()
        self.scanner = DeviceScanner(self.fmt, conf["batch"], device,
                                     k_sub=conf["k_sub"])
        if device == "cuda":
            torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t

    def config(self, inputs, ckpt_path: Optional[str]):
        from vgen_tpu_torch.scan.checkpoint import CheckpointManager
        from vgen_tpu_torch.scan.host import ScanConfig

        conf = self.cell["config_spec"]
        ckpt = None
        if ckpt_path is not None and inputs.start is not None:
            ckpt = CheckpointManager(
                ckpt_path, pattern=inputs.pattern, fmt=self.fmt.value,
                start=inputs.start, end=inputs.end,
                save_interval_secs=conf["checkpoint_save_interval_s"])
        return ScanConfig(format=self.fmt, count=0,
                          device_batch_size=conf["batch"],
                          start=inputs.start, end=inputs.end,
                          in_flight=conf["in_flight"], checkpoint=ckpt)

    def _scan(self, inputs, config, stop_when):
        from vgen_tpu_torch.pattern import Pattern
        from vgen_tpu_torch.scan.host import StopFlag

        stop = StopFlag()

        def progress(ops):
            if stop_when(ops):
                stop.set()

        return self.scanner.scan(Pattern(inputs.pattern), config, progress,
                                 stop)

    def warm(self, inputs, super_steps: int) -> None:
        """A few super-steps of the cell's own route; a range scan warms on
        keys far past those its window reaches, with no checkpoint."""
        from dataclasses import replace

        if inputs.start is not None:
            conf = self.cell["config_spec"]
            span = super_steps * conf["k_sub"] * conf["batch"]
            s = inputs.start + conf["chunk_keys"] // 2
            inputs = replace(inputs, start=s, end=s + span - 1)
        calls = [0]

        def enough(_ops):
            calls[0] += 1
            return calls[0] >= super_steps

        self._scan(inputs, self.config(inputs, None), enough)
        self.sync()

    def window(self, inputs, seconds: float, ckpt_path: Optional[str],
               tracer=None):
        """(ScanResult, seconds from the window's start to the scan's
        return, the checkpoint file's contents or None).  The stop flag is
        set once ``seconds`` have passed; what is in flight then is drained
        and counts.  A ``Tracer`` traces the window's last seconds."""
        if ckpt_path is not None and os.path.exists(ckpt_path):
            os.remove(ckpt_path)
        config = self.config(inputs, ckpt_path)
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def stop_when(ops):
            now = time.perf_counter()
            if tracer is not None:
                tracer.reached(now - t0, ops)
            return now >= t_end

        result = self._scan(inputs, config, stop_when)
        self.sync()
        elapsed = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop(result.operations)
        state = None
        if config.checkpoint is not None:
            with open(ckpt_path) as f:
                state = json.load(f)
            os.remove(ckpt_path)
        return result, elapsed, state

    def sync(self) -> None:
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
