"""Cells, configurations and metrics are found by name, agree with
BENCHMARK.json, and a cell added as a file runs with no other edit."""

import io
import json
import subprocess
import sys
import time

import pytest

from benchmark import harness, run
from benchmark.tests import tiny

SPEC = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())


def test_cells_are_the_benchmarks():
    """Every cell of BENCHMARK.json has its file; a file may hold a cell
    that BENCHMARK.json leaves out (PERF.md says which and why)."""
    assert set(w["name"] for w in SPEC["workloads"]) <= set(
        harness.cell_names())
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert cell["why"] == w["why"]
        conf = configs[w["config"]]
        assert conf["file"] == f"benchmark/configs/{w['config']}.json"
        spec = cell["config_spec"]
        assert (spec["name"], spec["source"], spec["reduced"]) == (
            conf["name"], conf["source"], conf["reduced"])


def test_metrics_are_the_benchmarks():
    for kind in ("end_to_end", "per_layer"):
        readers = harness.metric_readers(kind)
        assert sorted(readers) == sorted(m["name"] for m in SPEC[kind])
        for m in SPEC[kind]:
            assert readers[m["name"]].UNIT == m["unit"]


def test_each_cell_reports_what_benchmark_json_lists():
    """The readers report in a cell exactly the metrics that BENCHMARK.json
    gives it."""
    record = {"operations": 10**9, "window_s": 1.0, "setup_s": 9.0,
              "scanner_build_s": 0.02, "format": "p2pkh",
              "device": {"kernel_s": 0.9, "busy_s": 0.95, "window_s": 1.0,
                         "keys": 10**8}}
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        rec = dict(record, scan=cell["scan"])
        for kind in ("end_to_end", "per_layer"):
            got = {n for n, mod in harness.metric_readers(kind).items()
                   if mod.read(rec) is not None}
            want = {m["name"] for m in SPEC[kind]
                    if w["name"] in m.get("workloads", [w["name"]])}
            assert got == want, (w["name"], kind)


def test_unknown_cell():
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no-such.cell")


def test_new_cell_file_runs(tmp_path):
    root = tiny.tiny_root(tmp_path)
    assert "tiny-vanity.prefix" in harness.cell_names(root)
    cell = harness.load_cell("tiny-vanity.prefix", root)
    out = io.StringIO()
    rc = run.run(cell, 2**31 + 17, 2.0, 0, "cpu", time.perf_counter(),
                 out=out)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"keys_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0


def _run_script(tmp_path, prelude=""):
    """The harness on the CPU in a fresh process, on a tiny cell."""
    root = tiny.tiny_root(tmp_path)
    code = (
        "import io, sys, time\n"
        f"sys.path.insert(0, {str(harness.ROOT.parent)!r})\n"
        f"{prelude}\n"
        "from pathlib import Path\n"
        "from benchmark import harness, run\n"
        f"cell = harness.load_cell('tiny-range.prefix', Path({str(root)!r}))\n"
        "rc = run.run(cell, 5, 1.0, 0, 'cpu', time.perf_counter())\n"
        "bad = harness.forbidden_modules()\n"
        "print('forbidden', bad, file=sys.stderr)\n"
        "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)


def test_no_jax_is_loaded(tmp_path):
    proc = _run_script(tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "forbidden []" in proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1])["correct"] is True


def test_jax_loaded_fails_the_run(tmp_path):
    proc = _run_script(tmp_path, "import types; "
                       "sys.modules['jax'] = types.ModuleType('jax')")
    assert proc.returncode == 3
    assert "JAX or the JAX package was loaded: jax" in proc.stderr
    assert proc.stdout.strip() == ""


def test_top_level_names_compare_whole():
    names = ("vgen_tpu_torch_like", "jaxtyping", "vgen_tpu.scan")
    try:
        for n in names:
            sys.modules[n] = sys
        bad = harness.forbidden_modules()
        assert "vgen_tpu.scan" in bad
        assert "vgen_tpu_torch_like" not in bad and "jaxtyping" not in bad
    finally:
        for n in names:
            sys.modules.pop(n)


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "p2pkh-vanity.prefix", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"],
        cwd=harness.ROOT.parent, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr
