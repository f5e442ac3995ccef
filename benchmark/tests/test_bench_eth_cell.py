"""The Ethereum cell: its plain Keccak-256 and addresses against published
vectors, its frozen work against the program's bound model as it counts
today, its share, its roofline reader, its files, and a traced run of a
tiny Ethereum cell on the CPU."""

import io
import json
import math
import time
from fractions import Fraction

import pytest

from benchmark import check, harness, run, trace, work_eth
from benchmark.reference.formats import ethereum
from benchmark.reference.keccak import keccak256, keccak256_batch
from benchmark.tests import tiny

SPEC = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
CELL = "eth-vanity.zeros"
# kernels A and B's plain versions; ^0x00 (1 in 256): about 0.75 matches a
# window of 32 positions, 6 keys each, far under the 16 a packed row reports
TINY_CONFIG = {"format": "ethereum", "batch": 32, "k_sub": 2, "in_flight": 4}
TINY_CELL = {"config": "tiny-eth", "chips": 1, "scan": "random",
             "pattern": "^0x00",
             "limits": {"wrong_matches": 0, "match_deficit": 5.0}}


def test_keccak256_vectors():
    """The Keccak team's empty-message digest (the pre-FIPS padding, not
    SHA3-256's a7ffc6f8...), and "abc" across a batch of mixed lengths
    up to a full block less one byte."""
    empty = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    abc = "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    assert keccak256(b"").hex() == empty
    got = keccak256_batch([b"abc", b"", b"\x00" * 135, b"abc"])
    assert [got[0].hex(), got[1].hex(), got[3].hex()] == [abc, empty, abc]
    assert got[2] != got[1]
    with pytest.raises(ValueError):
        keccak256(b"\x00" * 136)


def test_addresses_of_known_keys():
    """Key 1's address (k G = G), and EIP-55's own examples."""
    assert ethereum.derive_many([1]) == [
        ("0x7E5F4552091A69125d5DfCb7b8C2659029395Bdf", "0" * 63 + "1")]
    for want in ("0x5aAeb6053F3E94C9b9A09f33669435E7Ef1BeAed",
                 "0xfB6916095ca1df60bB79Ce92cE3Ea74c37c5d359",
                 "0xdbF03B407c01E7cD3CBea99509d93f8DDDC8C6FB",
                 "0xD1220A0cf47c7B9Be7A2E6BA89F429762e7b9aDb"):
        low = want[2:].lower()
        assert ethereum.eip55(bytes.fromhex(low),
                              keccak256(low.encode())) == want


def test_work_equals_the_bound_model():
    from vgen_tpu_torch.probes import bound_model as bm

    assert work_eth.KECCAK == tuple(bm.KECCAK)
    assert work_eth.KECCAK_X_ONLY == tuple(bm.KECCAK_X_ONLY)
    assert work_eth.count_per_key() == (0, 4160, 4160)
    per_key = bm.KECCAK - bm.KECCAK_X_ONLY / 2
    assert work_eth.clocks_per_key() == bm.sm_clocks(per_key) == 65.0


def test_clocks_and_a_super_step():
    # 8 windows of 524,288 positions, six keys each, at 132 SMs and
    # 1980 MHz: 6.259 ms
    keys = 8 * 524288 * 6
    assert work_eth.roofline_percent(keys, 6.258718e-3) == pytest.approx(
        100.0, rel=1e-6)
    assert work_eth.roofline_percent(keys, 0.0) is None


def test_share():
    assert ethereum.share("^0x000000") == Fraction(1, 16**6)
    assert ethereum.share("^0x") == 1
    assert ethereum.share("^0xAb", ignore_case=True) == Fraction(1, 256)
    for pattern in ("^0x0a", "^0xdead", "^0x0A", "00$", "^0x0{6}",
                    "^0x" + "0" * 41):
        with pytest.raises(ValueError):
            ethereum.share(pattern)


def _record(fmt, traced=True, scan="random"):
    dev = ({"kernel_s": 0.5, "busy_s": 0.51, "window_s": 0.52,
            "keys": 60 * 8 * 524288 * 6} if traced else None)
    return {"scan": scan, "format": fmt, "operations": 10**9,
            "window_s": 1.0, "setup_s": 9.0, "scanner_build_s": 0.5,
            "device": dev}


def test_readers():
    readers = harness.metric_readers("per_layer")
    eth = readers["kernel_roofline.eth"]
    assert eth.read(_record("ethereum")) == pytest.approx(
        100.0 * 60 * 6.258718e-3 / 0.5, rel=1e-6)
    assert eth.read(_record("ethereum", traced=False)) is None
    assert eth.read(_record("ethereum", scan="range")) is None
    for fmt in ("p2pkh", "p2tr"):
        assert eth.read(_record(fmt)) is None
    for name in ("kernel_roofline.random", "kernel_roofline.p2tr"):
        assert readers[name].read(_record("ethereum")) is None


def test_the_cell_reports_what_benchmark_json_lists():
    """Each kind of metric BENCHMARK.json gives the cell, and no other, on
    a record of the cell's format."""
    cell = harness.load_cell(CELL)
    rec = _record(cell["config_spec"]["format"], scan=cell["scan"])
    want = {"end_to_end": {"keys_per_s", "setup_s"},
            "per_layer": {"kernel_roofline.eth", "device_idle.random",
                          "scanner_build_ms"}}
    for kind in ("end_to_end", "per_layer"):
        got = {n for n, mod in harness.metric_readers(kind).items()
               if mod.read(rec) is not None}
        listed = {m["name"] for m in SPEC[kind]
                  if CELL in m.get("workloads", [CELL])}
        assert got == listed == want[kind], kind


def test_cell_loads():
    cell = harness.load_cell(CELL)
    conf = cell["config_spec"]
    assert (conf["format"], conf["batch"], conf["k_sub"],
            conf["in_flight"]) == ("ethereum", 524288, 8, 4)
    assert (cell["scan"], cell["pattern"], cell["chips"]) == (
        "random", "^0x000000", 1)
    share = check.format_reference(conf["format"]).share(cell["pattern"])
    assert share == Fraction(1, 16**6)
    assert cell["limits"] == {"wrong_matches": 0, "match_deficit": 5.0}


def test_the_cell_takes_the_exact_interval_route():
    """Digits only, case-sensitive: no EIP-55 casing applies, so the
    program's intervals are exact (kernel B, not the prefilter or E)."""
    from vgen_tpu_torch.crypto.address import AddressFormat
    from vgen_tpu_torch.pattern import Pattern

    pat = Pattern(harness.load_cell(CELL)["pattern"])
    assert pat.exact_match_intervals(AddressFormat.ETHEREUM)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; from benchmark.reference.formats import ethereum; "
            "from benchmark import work_eth; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('vgen_tpu', 'vgen_tpu_torch', 'jax', "
            "'torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=harness.ROOT.parent).stdout
    assert out.strip() == "[]"


def test_tiny_eth_traced_run_reads_a_roofline(tmp_path, monkeypatch):
    """A traced run of a tiny Ethereum cell, the harness's look for a card
    skipped.  A CPU trace holds no kernel, so the plain versions' CPU ops
    stand in for the device's here: the share is tiny, but it is read
    from the run's own keys and trace."""
    load = trace.load

    def as_device(path):
        return [dict(e, cat="kernel") if e.get("cat") == "cpu_op" else e
                for e in load(path)]

    monkeypatch.setattr(trace, "load", as_device)
    root = tiny.tiny_root(tmp_path)
    (root / "configs" / "tiny-eth.json").write_text(json.dumps(TINY_CONFIG))
    (root / "workloads" / "tiny-eth.zeros.json").write_text(
        json.dumps(TINY_CELL))
    cell = harness.load_cell("tiny-eth.zeros", root)
    out = io.StringIO()
    assert run.run(cell, 2**31 + 23, 3.0, 1, "cpu", time.perf_counter(),
                   out=out) == 0
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0
    share = line["metrics"]["kernel_roofline.eth"]["value"]
    assert math.isfinite(share) and 0 < share < 100
    assert "kernel_roofline.random" not in line["metrics"]
    assert "kernel_roofline.p2tr" not in line["metrics"]
