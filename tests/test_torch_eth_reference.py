"""The port's Ethereum scans on CPU tensors against the benchmark's plain
reference of an Ethereum address (``benchmark/reference/formats/
ethereum.py``: secp256k1 on Python integers, Keccak-256 in NumPy and
EIP-55, sharing no code with the port), with no JAX: the three routes of
the scanner over a seeded range, key for key, and random scans, each
counted by its route's ``keys.ethereum.<route>`` counter."""

import collections
import random
import re

import pytest
import torch

from benchmark.reference.formats import ethereum
from vgen_tpu_torch import tracing
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan.host import ScanConfig
from vgen_tpu_torch.scan.scanner import DeviceScanner

ETH = AddressFormat.ETHEREUM
B, K = 256, 2
KEYS = 600  # a super-step of K windows of B keys, then a part of one
START = random.Random(2**31 + 29).randrange(2**64, 2**200)
END = START + KEYS - 1

# pattern: the route the scanner takes.  ^0x0 has digits only, so no
# EIP-55 casing applies and a device hit is a match (exact intervals); the
# letter of ^0xa must be lower case, which only the host checks (the
# prefilter: 1/16 of the keys survive); [Ab]$ takes the DFA, whose symbols
# carry the casing.  Random scans stop at 4 matches; ^0xab's survivors, 6
# a window of 256 positions of 6 keys, stay within the scanner's limit of
# 8, so it keeps the prefilter
CASES = {
    "exact": ("^0x0", "intervals"),
    "prefilter": ("^0xa", "prefilter"),
    "dfa": ("[Ab]$", "dfa"),
    "random_exact": ("^0x00", "intervals"),
    "random_prefilter": ("^0xab", "prefilter"),
    "random_dfa": ("[Ab]$", "dfa"),
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
    return DeviceScanner(ETH, B, "cpu", k_sub=K)


@pytest.fixture(scope="module")
def reference():
    """{key: (address, key as hex)} of the range, by the reference."""
    keys = list(range(START, END + 1))
    return dict(zip(keys, ethereum.derive_many(keys)))


@pytest.fixture
def counts(monkeypatch):
    """What the scan loop counts through ``tracing.count``, recorded with no
    profiler (which counts the same calls, and slows the plain versions'
    many small ops fivefold)."""
    seen = collections.Counter()
    monkeypatch.setattr(tracing, "count",
                        lambda name, n=1: seen.update({name: n}))
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_eth_scan_equals_reference(scanner, reference, counts, case):
    pattern, kind = CASES[case]
    if case.startswith("random"):
        res = scanner.scan(Pattern(pattern),
                           ScanConfig(format=ETH, count=4, in_flight=1))
        assert len(res.matches) >= 4
        keys = [int(m.hex, 16) for m in res.matches]
        derived = ethereum.derive_many(keys)
    else:
        res = scanner.scan(Pattern(pattern), ScanConfig(
            format=ETH, start=START, end=END, count=0))
        assert res.operations == KEYS
        want = sorted(k for k, d in reference.items()
                      if re.search(pattern, d[0]))
        keys = [int(m.hex, 16) for m in res.matches]
        assert sorted(keys) == want and want
        derived = [reference[k] for k in keys]
    assert next(reversed(scanner._routes.values())).kind == kind
    assert [(m.address, m.wif) for m in res.matches] == derived
    assert all(re.search(pattern, m.address) for m in res.matches)
    assert res.operations > 0
    assert {n: c for n, c in counts.items() if n.startswith("keys.")} == {
        f"keys.ethereum.{kind}": res.operations}
