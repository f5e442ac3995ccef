"""The port's range checkpoint (``vgen_tpu_torch/scan/checkpoint.py``) on
the CPU, with no JAX: ``advance`` takes only the matches found since its
previous call and appends them, the file keeps its format (every match as
``hex(k)`` in key order), a file in that format resumes, and the scan loops
hand every match to the checkpoint exactly once."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vgen_tpu_torch import native, tracing
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan.checkpoint import CheckpointManager
from vgen_tpu_torch.scan.host import ScanConfig, StopFlag, _scan_cpu_native

P2PKH = AddressFormat.P2PKH
B = 256
# ^1D: about 8 matches a window of 256 keys, under TOP_K (16), so nearly
# every drain of a one-window super-step finds some
PATTERN = "^1D"
START, END = 0x7000, 0x7000 + 6 * B - 1
META = {"pattern": PATTERN, "format": "p2pkh", "start": hex(START),
        "end": hex(END)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as the port's other CPU tests take: the suite
    runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scanner():
    return sc.DeviceScanner(P2PKH, B, "cpu", k_sub=1)


def _mgr(path, interval=3600.0):
    return CheckpointManager(str(path), pattern=PATTERN, fmt="p2pkh",
                             start=START, end=END,
                             save_interval_secs=interval)


def _read(path):
    return json.loads(path.read_text())


def _recording(ckpt):
    """Wrap ``ckpt.advance``: each call's new keys, in call order."""
    calls = []
    advance = ckpt.advance

    def record(next_key, operations, new_keys, force=False):
        calls.append(list(new_keys))
        advance(next_key, operations, new_keys, force)

    ckpt.advance = record
    return calls


def _keys(res):
    return [int(m.hex, 16) for m in res.matches]


def test_advance_appends_new_keys_through_throttled_calls(tmp_path):
    path = tmp_path / "ck.json"
    m = _mgr(path)
    m.advance(0x7100, 256, [0x7003, 0x7010])  # the first call writes
    m.advance(0x7200, 512, [0x7150])  # throttled: not written
    m.advance(0x7300, 768, [])
    assert _read(path)["matches"] == ["0x7003", "0x7010"]
    assert _read(path)["next_key"] == "0x7100"
    m.advance(0x7400, 1024, [0x7301, 0x73FF])
    m.finalize()
    data = _read(path)
    assert data["matches"] == ["0x7003", "0x7010", "0x7150", "0x7301",
                               "0x73ff"]
    assert data["next_key"] == "0x7400" and data["operations"] == 1024
    assert {k: data[k] for k in META} == META
    assert _mgr(path).load() == {
        "next_key": 0x7400, "operations": 1024,
        "match_keys": [0x7003, 0x7010, 0x7150, 0x7301, 0x73FF]}


def test_force_writes_at_once(tmp_path):
    path = tmp_path / "ck.json"
    m = _mgr(path)
    m.advance(0x7100, 256, [0x7003])
    m.advance(0x7200, 512, [0x7150], force=True)
    data = _read(path)
    assert data["matches"] == ["0x7003", "0x7150"]
    assert data["next_key"] == "0x7200" and data["operations"] == 512


def test_file_in_the_format_resumes_and_extends(tmp_path):
    """A file as the scan has always written it (``indent=2``, every match
    so far as ``hex(k)``) loads, and later calls append to its list."""
    path = tmp_path / "ck.json"
    path.write_text(json.dumps(dict(
        META, next_key="0x7200", operations=512,
        matches=["0x7003", "0x7150"], saved_at="2024-01-01T00:00:00"),
        indent=2))
    m = _mgr(path)
    assert m.load() == {"next_key": 0x7200, "operations": 512,
                        "match_keys": [0x7003, 0x7150]}
    m.advance(0x7300, 768, [0x7201])
    m.advance(0x7400, 1024, [0x73AA])
    m.finalize()
    data = _read(path)
    assert data["matches"] == ["0x7003", "0x7150", "0x7201", "0x73aa"]
    assert data["next_key"] == "0x7400" and data["operations"] == 1024


def test_set_matches_replaces_the_loaded_list(tmp_path):
    path = tmp_path / "ck.json"
    m = _mgr(path)
    m.advance(0x7200, 512, [0x7003, 0x7010, 0x7150], force=True)
    m2 = _mgr(path)
    assert m2.load()["match_keys"] == [0x7003, 0x7010, 0x7150]
    m2.set_matches([0x7003, 0x7150])  # 0x7010 no longer derives
    m2.advance(0x7300, 768, [0x7201])
    m2.finalize()
    assert _read(path)["matches"] == ["0x7003", "0x7150", "0x7201"]


def test_range_scan_hands_each_match_over_once(scanner, tmp_path):
    """Six one-window super-steps, most of which find matches: the keys
    each ``advance`` receives are that drain's own, together the scan's
    matches in order, and the file lists them; under a profiler the
    ``checkpoint_matches`` counter equals ``matches``."""
    path = tmp_path / "ck.json"
    ckpt = _mgr(path)
    calls = _recording(ckpt)
    tracing.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        res = scanner.scan(Pattern(PATTERN),
                           ScanConfig(format=P2PKH, start=START, end=END,
                                      count=0, checkpoint=ckpt))
    finally:
        prof.stop()
    keys = _keys(res)
    assert len(calls) == 6
    assert sum(1 for c in calls if c) >= 4
    assert [k for c in calls for k in c] == keys
    assert sum(len(c) for c in calls) == len(keys) > 6
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    data = _read(path)
    assert data["matches"] == [hex(k) for k in keys]
    assert int(data["next_key"], 16) == END + 1
    assert data["operations"] == res.operations == END - START + 1
    counters = tracing.snapshot()["counters"]
    assert counters["checkpoint_matches"] == counters["matches"] == len(keys)


def test_resumed_range_scan_drops_a_key_that_does_not_derive(scanner,
                                                             tmp_path):
    """Leg 1 stops after its first super-step; its file gets a key that no
    longer derives (N, outside the key space).  The resumed scan re-derives
    the stored keys, drops that one, and its file lists the kept keys and
    then the new ones, as its result does."""
    path = tmp_path / "ck.json"
    stop = StopFlag()
    leg1 = scanner.scan(Pattern(PATTERN),
                        ScanConfig(format=P2PKH, start=START, end=END,
                                   count=0, in_flight=1,
                                   checkpoint=_mgr(path)),
                        lambda ops: stop.set(), stop)
    assert leg1.operations == B and leg1.matches
    data = _read(path)
    assert data["matches"] == [hex(k) for k in _keys(leg1)]
    data["matches"].append(hex(ec.N))
    path.write_text(json.dumps(data, indent=2))

    ckpt = _mgr(path)
    calls = _recording(ckpt)
    leg2 = scanner.scan(Pattern(PATTERN),
                        ScanConfig(format=P2PKH, start=START, end=END,
                                   count=0, checkpoint=ckpt))
    keys = _keys(leg2)
    assert keys[:len(leg1.matches)] == _keys(leg1)
    assert [k for c in calls for k in c] == keys[len(leg1.matches):]
    assert _read(path)["matches"] == [hex(k) for k in keys]
    assert leg2.operations == END - START + 1
    full = scanner.scan(Pattern(PATTERN),
                        ScanConfig(format=P2PKH, start=START, end=END,
                                   count=0))
    assert keys == _keys(full)


def test_native_cpu_range_scan_hands_each_match_over_once(tmp_path):
    """The CPU path (the native scanner, chunks of 4096 keys) under the
    same contract: each ``advance`` gets the chunk's new matches."""
    if not native.available():
        pytest.fail(f"the native library did not build: "
                    f"{native.build_error()}")
    start, end = 0x9000, 0x9000 + 3 * 4096 - 1
    path = tmp_path / "ck.json"
    ckpt = CheckpointManager(str(path), pattern=PATTERN, fmt="p2pkh",
                             start=start, end=end, save_interval_secs=3600)
    calls = _recording(ckpt)
    res = _scan_cpu_native(Pattern(PATTERN),
                           ScanConfig(format=P2PKH, start=start, end=end,
                                      count=0, cpu_batch_size=4096,
                                      checkpoint=ckpt), None, None)
    keys = _keys(res)
    assert len(calls) == 3 and all(calls)
    assert [k for c in calls for k in c] == keys
    data = _read(path)
    assert data["matches"] == [hex(k) for k in keys]
    assert int(data["next_key"], 16) == end + 1
    assert data["operations"] == res.operations == end - start + 1
