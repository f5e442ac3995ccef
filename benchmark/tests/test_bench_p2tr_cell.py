"""The P2TR cell: its frozen work against the program's bound model as it
counts today, its roofline reader, its files, and a traced run of a tiny
P2TR cell on the CPU."""

import io
import json
import math
import time
from fractions import Fraction

import pytest

from benchmark import check, harness, run, trace, work_p2tr
from benchmark.tests import tiny

SPEC = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
CELL = "p2tr-vanity.prefix"


def test_work_equals_the_bound_model_at_16_signed():
    """Each frozen part is what the bound model counts, and their sum the
    ``p2tr_ladder`` recipe of ``probes/roofline.py`` at 16-bit signed
    digits."""
    import numpy as np

    from vgen_tpu_torch.probes import bound_model as bm
    from vgen_tpu_torch.probes import roofline as rl

    assert work_p2tr.LADDER_WINDOW == (16, True)
    assert work_p2tr.EXPECTED_ADDS == rl.expected_adds(16, True)
    assert work_p2tr.TAGGED == tuple(bm.TAGGED)
    assert work_p2tr.LEAN_ADD == tuple(bm.LEAN_ADD)
    assert work_p2tr.FINISH == tuple(2 * bm.FE_MUL + bm.FE_SQR)
    assert work_p2tr.RATES == (bm.MULS_PER_SM_CLOCK, bm.ALU_PER_SM_CLOCK,
                               bm.INSTRUCTIONS_PER_SM_CLOCK)
    recipe = dict(rl.KERNEL_RECIPES["p2tr_ladder"],
                  leanadd=rl.expected_adds(16, True))
    count = sum(n * rl.PRIMITIVES[name][1] for name, n in recipe.items())
    assert np.allclose(work_p2tr.count_per_key(), count, rtol=0, atol=1e-9)
    assert work_p2tr.clocks_per_key() == pytest.approx(bm.sm_clocks(count),
                                                       rel=1e-12)


def test_clocks_and_a_super_step():
    assert work_p2tr.count_per_key() == pytest.approx(
        (11869.827148, 888, 32139.550781), rel=1e-9)
    assert work_p2tr.clocks_per_key() == pytest.approx(370.93210, rel=1e-7)
    # 8 windows of 524,288 keys at 132 SMs and 1980 MHz: 5.953 ms
    keys = 8 * 524288
    assert work_p2tr.roofline_percent(keys, 5.952716e-3) == pytest.approx(
        100.0, rel=1e-5)
    assert work_p2tr.roofline_percent(keys, 0.0) is None


def _record(fmt, traced=True, scan="random"):
    dev = ({"kernel_s": 0.5, "busy_s": 0.51, "window_s": 0.52,
            "keys": 40 * 8 * 524288} if traced else None)
    return {"scan": scan, "format": fmt, "operations": 10**9,
            "window_s": 1.0, "setup_s": 9.0, "scanner_build_s": 0.5,
            "device": dev}


def test_readers():
    readers = harness.metric_readers("per_layer")
    p2tr, random_ = readers["kernel_roofline.p2tr"], readers[
        "kernel_roofline.random"]
    assert p2tr.read(_record("p2tr")) == pytest.approx(
        100.0 * 40 * 5.952716e-3 / 0.5, rel=1e-6)
    assert p2tr.read(_record("p2tr", traced=False)) is None
    assert p2tr.read(_record("p2tr", scan="range")) is None
    assert p2tr.read(_record("p2pkh")) is None
    assert random_.read(_record("p2tr")) is None
    assert random_.read(_record("p2pkh")) is not None


def test_the_cell_reports_what_benchmark_json_lists():
    """The readers report in each cell the metrics BENCHMARK.json gives it,
    on a record of the cell's own format."""
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        rec = _record(cell["config_spec"]["format"], scan=cell["scan"])
        for kind in ("end_to_end", "per_layer"):
            got = {n for n, mod in harness.metric_readers(kind).items()
                   if mod.read(rec) is not None}
            want = {m["name"] for m in SPEC[kind]
                    if w["name"] in m.get("workloads", [w["name"]])}
            assert got == want, (w["name"], kind)


def test_cell_loads():
    cell = harness.load_cell(CELL)
    conf = cell["config_spec"]
    assert (conf["format"], conf["batch"], conf["k_sub"],
            conf["in_flight"]) == ("p2tr", 524288, 8, 4)
    assert (cell["scan"], cell["pattern"], cell["chips"]) == (
        "random", "^bc1pcafe", 1)
    share = check.format_reference(conf["format"]).share(cell["pattern"])
    assert share == Fraction(1, 2**20)


def test_tiny_p2tr_traced_run_reads_a_roofline(tmp_path, monkeypatch):
    """A traced run of the tiny P2TR cell, the harness's look for a card
    skipped.  A CPU trace holds no kernel, so the plain versions' CPU ops
    stand in for the device's here: the share is tiny, but it is read
    from the run's own keys and trace."""
    load = trace.load

    def as_device(path):
        return [dict(e, cat="kernel") if e.get("cat") == "cpu_op" else e
                for e in load(path)]

    monkeypatch.setattr(trace, "load", as_device)
    cell = harness.load_cell("tiny-p2tr.prefix", tiny.tiny_root(tmp_path))
    out = io.StringIO()
    assert run.run(cell, 2**31 + 19, 3.0, 1, "cpu", time.perf_counter(),
                   out=out) == 0
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    share = line["metrics"]["kernel_roofline.p2tr"]["value"]
    assert math.isfinite(share) and 0 < share < 100
    assert "kernel_roofline.random" not in line["metrics"]
