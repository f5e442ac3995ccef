"""The scan loop and CLI of P2SH-P2WPKH, uncompressed P2PKH and Ethereum on
CPU tensors (the kernels' plain versions), and the two repairs of the
drain these formats made reachable:

- the exact-y formats resolve each reported variant bit to one key
  (``glv_bit_variant_keys(parity_exact=True)``, as the JAX package's drain
  does); a bit mask of 0, the doubling lane, still derives all six keys;
- an Ethereum interval route is exact only when the pattern is
  case-insensitive or its literal prefix after "0x" holds no letter: EIP-55
  casing depends on a hash of the whole address, so the intervals of
  ``^0xab`` also hold "0xAB..." addresses, and counting such hits as
  matches ends a ``-c 1`` range scan's collection early.

Every CLI match is confirmed by the oracle; range scans are held against
the port's native CPU scanner over the same range.  B = 256."""

import json

import pytest

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch import cli, native
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.ops import fused, pipeline
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan.host import ScanConfig, StopFlag, _scan_cpu

B = 256
ETH = AddressFormat.ETHEREUM


def _address(key, fmt):
    return AddressGenerator(fmt).generate(key.to_bytes(32, "big")).address


def _run_cli(capsys, argv):
    rc = cli.run_from_args(argv + ["--no-tui", "--backend", "cpu",
                                   "--device-batch-size", str(B), "-o",
                                   "jsonl", "-q"])
    assert rc == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line]


@pytest.mark.parametrize("fmt", [AddressFormat.P2PKH_UNCOMPRESSED, ETH],
                         ids=lambda f: f.value)
def test_exact_y_drain_derives_one_key_per_set_bit(monkeypatch, fmt):
    """One super-step of a random scan whose first window is based at 1:
    the host derives one key per set variant bit, and the six keys of the
    doubling lane (bits 0, key 2)."""
    rows, derived = [], []
    step = fused.fused_range_scan_step
    bulk = sc._derive_checked_bulk

    def step_spy(*args, **kw):
        out = step(*args, **kw)
        rows.append(out.clone())
        return out

    def bulk_spy(keys, *args):
        derived.extend(keys)
        return bulk(keys, *args)

    monkeypatch.setattr(fused, "fused_range_scan_step", step_spy)
    monkeypatch.setattr(sc, "_derive_checked_bulk", bulk_spy)
    monkeypatch.setattr(sc.secrets, "randbelow", lambda n: 0)  # next_key 2
    src = {ETH: "^0xab", AddressFormat.P2PKH_UNCOMPRESSED: "^1Ab"}[fmt]
    scanner = sc.DeviceScanner(fmt, B, "cpu", k_sub=2)
    stop = StopFlag()
    scanner.scan(Pattern(src), ScanConfig(format=fmt, count=10**6,
                                          in_flight=1),
                 lambda ops: stop.set(), stop)
    (packed,) = rows
    bits = [int(b) for row in packed for i, b in zip(row[2:18], row[18:34])
            if i >= 0]
    assert bits and max(int(c) for c in packed[:, 0]) <= pipeline.TOP_K
    want = sum(bin(b).count("1") for b in bits)
    assert len(derived) == want + 6
    assert sorted(ec.glv_variant_keys(2)) == sorted(derived[:6])
    # the bits resolve to distinct keys, each matching the interval's prefix
    assert len(set(derived[6:])) == want
    # a variant whose pair is half set: the old drain derived both keys
    assert any((b >> 2 * v) & 3 in (1, 2) for b in bits for v in range(3))


def test_ethereum_interval_route_exact_only_without_cased_letters():
    cases = {("^0xab", False): False, ("^0xAB", False): False,
             ("^0x12", False): True, ("^0xab", True): True,
             ("^0x", False): True}
    for (src, icase), exact in cases.items():
        got = Pattern(src, icase).exact_match_intervals(ETH)
        assert (got is not None) == exact, src
    assert Pattern("^3ab").exact_match_intervals(
        AddressFormat.P2SH_P2WPKH) is not None


def test_ethereum_letter_prefix_count_one_returns_lowest_key(capsys):
    """Window 0 of this range holds two interval hits of ^0xab, both
    "0xAb..."-cased; window 6 of the same super-step holds the lowest
    match.  Counting the hits as confirmed would end the collection after
    window 0 and return a key of the next super-step; the scan returns the
    lowest, as the native scanner does."""
    start, end = 0x1300, 0x1300 + 16 * B - 1
    pat = Pattern("^0xab")
    w0 = native.derive_addresses(list(range(start, start + B)), ETH.value)
    assert sum(a.lower().startswith("0xab") for a in w0) == 2
    assert not any(pat.matches(a) for a in w0)
    want = _scan_cpu(pat, ScanConfig(format=ETH, start=start, end=end,
                                      count=1, use_device=False), None, None)
    assert [int(m.hex, 16) for m in want.matches] == [0x19C8]
    rows = _run_cli(capsys, ["range", "-f", "ethereum", "-p", "^0xab", "-r",
                             f"{start:x}:{end:x}", "-c", "1"])
    assert [int(r["private_key_hex"], 16) for r in rows] == [0x19C8]
    assert rows[0]["address"] == _address(0x19C8, ETH)


@pytest.mark.parametrize("fmt,src", [
    ("ethereum", "^0xab"), ("ethereum", "[Dd]$"),
    ("p2sh-p2wpkh", "^3A"), ("p2sh-p2wpkh", "q$"),
    ("p2pkh-uncompressed", "^1A"), ("p2pkh-uncompressed", "q$"),
])
def test_cli_generate_new_formats(capsys, fmt, src):
    """Random scans on the interval and the DFA route; every match
    confirmed by the oracle."""
    rows = _run_cli(capsys, ["generate", "-f", fmt, "-p", src, "-c", "1"])
    assert len(rows) == 1
    f = AddressFormat.from_str(fmt)
    key = int(rows[0]["private_key_hex"], 16)
    assert _address(key, f) == rows[0]["address"]
    assert Pattern(src).matches(rows[0]["address"])


@pytest.mark.parametrize("fmt,src", [
    ("ethereum", "[Aa][0-3]"), ("p2sh-p2wpkh", "[Cc][a4]"),
    ("p2pkh-uncompressed", "^1[A-H]"),
])
def test_cli_range_new_formats_equal_native_scanner(capsys, fmt, src):
    """``range -c 0`` over 2048 keys: the match set equals the native CPU
    scanner's, and every key is counted once."""
    f = AddressFormat.from_str(fmt)
    rows = _run_cli(capsys, ["range", "-f", fmt, "-r", "3000:37FF", "-p",
                             src, "-c", "0"])
    want = _scan_cpu(Pattern(src), ScanConfig(format=f, start=0x3000,
                                              end=0x37FF, count=0,
                                              use_device=False), None, None)
    got = sorted(int(r["private_key_hex"], 16) for r in rows)
    assert got == sorted(int(m.hex, 16) for m in want.matches)
    assert len(got) > pipeline.TOP_K
    assert rows[0]["operations"] == want.operations == 0x800
