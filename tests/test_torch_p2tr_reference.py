"""The port's P2TR scans on CPU tensors against the benchmark's plain
reference of a P2TR address (``benchmark/reference/formats/p2tr.py``:
BIP-340/341/350 in plain Python, sharing no code with the port), with no
JAX: every route of the P2TR scanner over a seeded range, key for key,
a random scan, and the ladder table's start stage."""

import random
import re

import pytest
import torch

from benchmark.reference.formats import p2tr
from vgen_tpu_torch import tracing
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan.host import ScanConfig
from vgen_tpu_torch.scan.scanner import DeviceScanner

P2TR = AddressFormat.P2TR
B, K = 256, 2
KEYS = 600  # a super-step of K windows of B keys, then a part of one
START = random.Random(2**31 + 19).randrange(2**64, 2**200)
END = START + KEYS - 1

# pattern: the route the scanner takes, as its route cache keys it (exact:
# a device hit is a match; the prefilter's survivors are regex-checked on
# the host).  ^bc1pq.*z takes the prefilter of ^bc1pq: 1/32 of a window
# of 256 keys survives, the scanner's limit of 8
CASES = {
    "exact": ("^bc1pq", ("intervals", True)),
    "prefilter": ("^bc1pq.*z", ("intervals", False)),
    "dfa": ("q$", ("dfa",)),
    "random": ("^bc1pq", ("intervals", True)),
}


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
    return DeviceScanner(P2TR, B, "cpu", k_sub=K)


@pytest.fixture(scope="module")
def reference():
    """{key: (address, WIF) or None} of the range, by the reference."""
    keys = list(range(START, END + 1))
    return dict(zip(keys, p2tr.derive_many(keys)))


def _route(scanner):
    """The route the last scan took: its cache key's kind, and for
    intervals whether the route is exact."""
    key, route = next(reversed(scanner._routes.items()))
    return (key[0], route.exact) if key[0] == "intervals" else (key[0],)


@pytest.mark.parametrize("case", list(CASES))
def test_p2tr_scan_equals_reference(scanner, reference, case):
    pattern, route = CASES[case]
    if case == "random":
        res = scanner.scan(Pattern(pattern),
                           ScanConfig(format=P2TR, count=4, in_flight=1))
        assert len(res.matches) >= 4
        keys = [int(m.hex, 16) for m in res.matches]
        derived = p2tr.derive_many(keys)
    else:
        res = scanner.scan(Pattern(pattern), ScanConfig(
            format=P2TR, start=START, end=END, count=0))
        assert res.operations == KEYS
        want = sorted(k for k, d in reference.items()
                      if d is not None and re.search(pattern, d[0]))
        keys = [int(m.hex, 16) for m in res.matches]
        assert sorted(keys) == want and want
        derived = [reference[k] for k in keys]
    assert _route(scanner) == route
    assert [(m.address, m.wif) for m in res.matches] == derived
    assert all(re.search(pattern, m.address) for m in res.matches)


def test_ladder_stage_for_p2tr_only():
    """``start.tables.ladder``, the ladder table's build, is a stage of a
    P2TR scanner's start, inside ``start.tables``, and of no other's."""
    tracing.reset()
    try:
        DeviceScanner(AddressFormat.P2PKH, B, "cpu", k_sub=K)
        start = tracing.snapshot()["start"]
        assert "start.tables" in start
        assert "start.tables.ladder" not in start
        tracing.reset()
        DeviceScanner(P2TR, B, "cpu", k_sub=K)
        start = tracing.snapshot()["start"]
        assert 0 < start["start.tables.ladder"] <= start["start.tables"]
    finally:
        tracing.reset()
