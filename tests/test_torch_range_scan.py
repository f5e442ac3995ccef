"""Range scans and the DFA route of the port's scan loop and CLI on CPU
tensors (the kernels' plain versions), mirroring tests/test_scanner.py:
the port's matches and ``operations`` equal the JAX package's
``scan_with_progress`` (its device path on the XLA:CPU backend) on the same
ranges.  B = 256; the port runs one window per super-step (k_sub = 1) where
``operations`` of a scan that stops early are compared, so both stop after
the same window."""

import json
import re
import types

import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.pattern import Pattern as JPattern
from vgen_tpu.scan import scanner as jsc
from vgen_tpu_torch import cli
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan.checkpoint import CheckpointManager
from vgen_tpu_torch.scan.host import ScanConfig, StopFlag

B = 256
P2PKH = AddressFormat.P2PKH


def _address(key, fmt=P2PKH):
    return AddressGenerator(fmt).generate(key.to_bytes(32, "big")).address


def _exact(key, fmt=P2PKH):
    return Pattern(f"^{re.escape(_address(key, fmt))}$")


def _keys(res):
    return [int(m.hex, 16) for m in res.matches]


@pytest.fixture(scope="module")
def scanners():
    """The port's P2PKH scanners at k_sub 1 and 2."""
    return {k: sc.DeviceScanner(P2PKH, B, "cpu", k_sub=k) for k in (1, 2)}


def _reference(pat, **kw):
    """The JAX package's scan of the same pattern and range, through its
    own types."""
    kw["format"] = JAddressFormat(kw.get("format", P2PKH).value)
    return jsc.scan_with_progress(
        JPattern(pat.original, pat.is_case_insensitive),
        jsc.ScanConfig(device_batch_size=B, **kw))


CASES = {
    # name: (pattern, config, k_sub, expected keys or None)
    "exact_address": (_exact(0xDEAD), dict(start=0xD000, end=0xE000), 1,
                      [0xDEAD]),
    "exhausted": (Pattern("^1ZZZZZZZZZZZZ"),
                  dict(start=1000, end=1000 + 2 * B), 2, []),
    "key_one": (_exact(1), dict(start=1, end=300), 1, [1]),
    # start 0x100 -> base 0xFF -> key 0x1FE sits on the doubling lane
    "doubling_lane": (_exact(0x1FE), dict(start=0x100, end=0x1FF), 1,
                      [0x1FE]),
    "interval_beyond_top_k": (Pattern("^1"),
                              dict(start=1000, end=1299, count=0), 2,
                              list(range(1000, 1300))),
    "dfa_beyond_top_k": (Pattern("1"),
                         dict(start=500, end=500 + B - 1, count=0), 2,
                         list(range(500, 500 + B))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_range_scan_equals_reference(scanners, case):
    pat, kw, k_sub, want = CASES[case]
    res = scanners[k_sub].scan(pat, ScanConfig(format=P2PKH, **kw))
    ref = _reference(pat, **kw)
    assert _keys(res) == want == _keys(ref)
    assert res.operations == ref.operations
    for m in res.matches:
        assert m.address == _address(int(m.hex, 16))


def test_doubling_lane_counted_once(scanners):
    """Every key of [0x100, 0x1FF] counted exactly once, the doubling lane's
    included (its key is checked on the host and adds no ops)."""
    res = scanners[1].scan(_exact(0x1FE),
                           ScanConfig(format=P2PKH, start=0x100, end=0x1FF))
    assert _keys(res) == [0x1FE]
    assert res.operations == 0x100


def test_random_window_below_batch_counts_six_per_position(monkeypatch):
    """A random-scan window based at 1 <= base <= B holds the doubling lane:
    its row counts 6 * B keys, and the drain adds nothing for that lane."""
    monkeypatch.setattr(sc.secrets, "randbelow", lambda n: 0)  # next_key 2
    scanner = sc.DeviceScanner(P2PKH, B, "cpu", k_sub=1)
    stop = StopFlag()
    res = scanner.scan(Pattern("^1ZZZZZZZZZZZZ"),
                       ScanConfig(format=P2PKH, in_flight=1),
                       lambda ops: stop.set(), stop)
    assert res.operations == 6 * B


def test_prefilter_hybrid_range_scan(scanners):
    """A class pattern with a selective literal prefix stays on the
    interval route on a range scan; survivors are regex-checked."""
    key = 0x54321
    addr = _address(key)
    pat = Pattern(f"^{addr[:5]}[{addr[5]}x]")
    assert pat.match_intervals(P2PKH) is None
    kw = dict(start=0x54000, end=0x54FFF, count=0)
    cfg = ScanConfig(format=P2PKH, **kw)
    assert scanners[2]._plan_intervals(pat, cfg) is not None
    res = scanners[2].scan(pat, cfg)
    ref = _reference(pat, **kw)
    assert key in _keys(res)
    assert _keys(res) == _keys(ref)
    assert res.operations == ref.operations == 0x1000
    assert all(pat.matches(m.address) for m in res.matches)


def test_range_prefilter_count_one_returns_lowest_key(scanners):
    """On the prefilter route a device hit is only a survivor.  Window 0 of
    this range holds a survivor of the prefix ^1A[a-z] that fails .*q$;
    window 1, in the same super-step, holds the lowest match.  Counting
    survivors as confirmed matches would end the collection after window 0
    and return a later key; the scan returns the lowest."""
    pat = Pattern("^1A[a-z].*q$")
    start, end = 0x5300, 0x5300 + 4 * B - 1
    cfg = ScanConfig(format=P2PKH, start=start, end=end, count=1)
    assert scanners[2]._plan_intervals(pat, cfg) is not None
    assert pat.match_intervals(P2PKH) is None
    addrs = {k: _address(k) for k in range(start, end + 1)}
    window0 = [addrs[k] for k in range(start, start + B)]
    assert any(re.match("1A[a-z]", a) for a in window0)
    assert not any(pat.matches(a) for a in window0)
    want = min(k for k, a in addrs.items() if pat.matches(a))
    assert want < start + 2 * B
    assert _keys(scanners[2].scan(pat, cfg)) == [want]


@pytest.mark.parametrize("start", [None, 1])
def test_plan_intervals_scales_by_scan_mode(scanners, start):
    """A prefilter probability p with 8/(6B) < p <= 8/B: the interval route
    on range scans (one key per position), the DFA route on random GLV
    scans (six), as the reference's planner decides at the same B."""
    pat = Pattern("^1[a-k]")
    _, p = pat.prefilter_intervals(P2PKH)
    assert 8 / (6 * B) < p <= 8 / B
    cfg = ScanConfig(format=P2PKH, start=start)
    got = scanners[1]._plan_intervals(pat, cfg)
    ref_self = types.SimpleNamespace(
        batch=B, PREFILTER_MAX_SURVIVORS=jsc.DeviceScanner.PREFILTER_MAX_SURVIVORS)
    want = jsc.DeviceScanner._plan_intervals(
        ref_self, JPattern(pat.original),
        jsc.ScanConfig(format=JAddressFormat.P2PKH, start=start))
    assert got == want
    assert (got is not None) == (start is not None)


def test_checkpoint_interrupted_and_resumed(tmp_path, capsys):
    """Leg 1 stops after one super-step and leaves next_key in the file;
    leg 2 (through the CLI) resumes there, carries the saved operations
    and finds the key."""
    start, end, key = 0x10000, 0x10000 + 4095, 0x10000 + 4000
    pat_src = f"^{re.escape(_address(key))}$"
    path = str(tmp_path / "ckpt.json")
    ckpt = CheckpointManager(path, pattern=pat_src, fmt="p2pkh", start=start,
                             end=end)
    stop = StopFlag()
    scanner = sc.DeviceScanner(P2PKH, B, "cpu", k_sub=2)
    leg1 = scanner.scan(Pattern(pat_src),
                        ScanConfig(format=P2PKH, start=start, end=end,
                                   in_flight=1, checkpoint=ckpt),
                        lambda ops: stop.set(), stop)
    assert leg1.matches == [] and leg1.operations == 2 * B
    saved = json.load(open(path))
    assert int(saved["next_key"], 16) == start + 2 * B
    assert saved["operations"] == 2 * B

    rc = cli.run_from_args([
        "range", "-p", pat_src, "-r", f"{start:x}:{end:x}", "--checkpoint",
        path, "--no-tui", "--backend", "cpu", "--device-batch-size", str(B),
        "-o", "jsonl"])
    assert rc == 0
    out = capsys.readouterr()
    assert f"Resuming from checkpoint: next key {hex(start + 2 * B)}" in out.err
    rows = [json.loads(line) for line in out.out.splitlines() if line]
    assert [int(r["private_key_hex"], 16) for r in rows] == [key]
    # 8 windows of the port's default k_sub: the resumed scan ends with the
    # super-step that holds the key, the end of the range
    assert rows[0]["operations"] == end - start + 1


@pytest.mark.parametrize("args,key", [
    (["-p", "boha:b1000:10"], 0x202),
    (["--puzzle", "10"], 0x200),  # the default pattern "." matches any key
])
def test_cli_range_puzzle(capsys, args, key):
    rc = cli.run_from_args(["range", *args, "--no-tui", "--backend", "cpu",
                            "--device-batch-size", str(B), "-o", "jsonl",
                            "-q"])
    assert rc == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line]
    assert [int(r["private_key_hex"], 16) for r in rows] == [key]
    assert rows[0]["address"] == _address(key)


def test_cli_range_dfa_equals_native_scanner(capsys):
    """``range --range 2000:3FFF -p "Cat$"``-style call, count 0: the DFA
    route's match set equals the native CPU scanner's over the range."""
    pat_src = "[Cc][a4]"
    rc = cli.run_from_args(["range", "-r", "2000:27FF", "-p", pat_src, "-c",
                            "0", "--no-tui", "--backend", "cpu",
                            "--device-batch-size", str(B), "-o", "jsonl",
                            "-q"])
    assert rc == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line]
    native = jsc.scan_with_progress(
        JPattern(pat_src), jsc.ScanConfig(start=0x2000, end=0x27FF, count=0,
                                          use_device=False))
    got = sorted(int(r["private_key_hex"], 16) for r in rows)
    assert got == sorted(_keys(native)) and len(got) > 10
    assert rows[0]["operations"] == native.operations == 0x800


def test_cli_estimate_without_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.run_from_args(["estimate", "-p", "^1Cat"]) == 0
    out = capsys.readouterr().out
    assert "Estimated difficulty: 1 in " in out
    assert "Benchmark rate:" in out
    assert "no device calibration" in out


@pytest.mark.parametrize("fmt,pat_src", [("p2pkh", "q$"),
                                         ("p2wpkh", "[ad][02-9]")])
def test_cli_generate_random_dfa(capsys, fmt, pat_src):
    """A random scan of a regex that is not an anchored prefix takes the
    GLV DFA route; every match confirmed by the oracle."""
    rc = cli.run_from_args(["generate", "-f", fmt, "-p", pat_src, "-c", "3",
                            "--no-tui", "--backend", "cpu",
                            "--device-batch-size", str(B), "-o", "jsonl",
                            "-q"])
    assert rc == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line]
    assert len(rows) == 3
    pat = Pattern(pat_src)
    f = AddressFormat.from_str(fmt)
    for r in rows:
        assert _address(int(r["private_key_hex"], 16), f) == r["address"]
        assert pat.matches(r["address"])
