"""One run of one benchmark cell of vgen_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the program, builds the cell's scanner, warms its route, scans for
``--seconds``, checks what the scan reported against the plain reference
(``check.py``), and prints one JSON line as the last line of standard
output: ``correct``, ``attempted`` (keys the window counted), ``failed``,
``metrics`` (with ``--trace 0`` the end-to-end metrics, with ``--trace 1``
the per-layer ones, read from a ``torch.profiler`` trace of the window),
``device``, ``breakdown`` (traced runs) and last ``checks``: each number
compared beside its limit, which also end standard error.  Exits non-zero
with no result when no card is visible, when fewer cards are visible than
the cell takes, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()  # the process's start, before the imports

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))  # the program's package and this one

from benchmark import check, harness, trace, traffic  # noqa: E402

WARM_SUPER_STEPS = 4
# a traced run traces its window's last seconds: a whole window of the
# fastest cells would be a trace of gigabytes
TRACE_SECONDS = 4.0


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(scan, cell, inputs, seconds, tracer=None):
    """One window of ``scan``: (keys counted, the matches as (key, address,
    WIF) in the order reported, elapsed seconds, the checkpoint file's
    contents or None)."""
    ckpt = (harness.checkpoint_path(cell["name"])
            if inputs.start is not None
            and cell["config_spec"].get("checkpoint") else None)
    result, elapsed, state = scan.window(inputs, seconds, ckpt, tracer)
    matches = [(int(m.hex, 16), m.address, m.wif) for m in result.matches]
    return result.operations, matches, elapsed, state


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _device(device, chips):
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run(cell, seed, seconds, traced, device, t_start, out=None) -> int:
    out = out or sys.stdout
    inputs = traffic.make(cell, seed)
    scan = harness.Scan(cell, device)
    scan.warm(inputs, WARM_SUPER_STEPS)
    tracer = None
    if traced:
        # a process's first profiler start takes seconds (CUPTI's set-up);
        # the window's, at its tail, has to start at once
        first = _profiler(device)
        first.start()
        scan.sync()
        first.stop()
        tracer = harness.Tracer(_profiler(device), seconds, TRACE_SECONDS)
    setup_s = time.perf_counter() - t_start

    ops, matches, elapsed, state = measure(scan, cell, inputs, seconds,
                                           tracer)
    summary = None
    if tracer is not None and tracer.keys is not None:
        tdir = os.path.join(tempfile.gettempdir(), "vgen-benchmark")
        os.makedirs(tdir, exist_ok=True)
        path = os.path.join(tdir, f"{cell['name']}.trace.json")
        tracer.profiler.export_chrome_trace(path)
        tracer.profiler = None
        summary = trace.summarize(trace.load(path))
        if summary is not None:
            summary["keys"] = tracer.keys
        os.remove(path)

    dev = _device(device, cell["chips"])
    build_s = scan.build_s
    del scan  # the program's state goes before the reference runs
    numbers = check.judge(cell, inputs, matches, ops, seed, state)
    correct, failed, table = check.verdict(numbers, cell["limits"])
    record = {
        "scan": cell["scan"], "format": cell["config_spec"]["format"],
        "operations": ops, "window_s": elapsed,
        "setup_s": setup_s, "scanner_build_s": build_s,
        "device": summary,
    }
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for name, mod in harness.metric_readers(kind).items():
        value = mod.read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    line = {"correct": correct, "attempted": ops,
            "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = table
    bad = harness.forbidden_modules()
    if bad:
        print("error: JAX or the JAX package was loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    print(f"cell {cell['name']} seed {seed} pattern {inputs.pattern} start "
          f"{inputs.start} keys {ops} window_s {elapsed} "
          f"matches {len(matches)}", file=sys.stderr)
    for name, v in table.items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = harness.load_cell(args.workload)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    import torch

    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < cell["chips"]:
        print(f"error: the cell takes {cell['chips']} CUDA card(s); "
              f"{visible} visible", file=sys.stderr)
        return 2
    return run(cell, args.seed, args.seconds, args.trace, "cuda", T_START)


if __name__ == "__main__":
    sys.exit(main())
