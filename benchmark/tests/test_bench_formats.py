"""The check's per-format references: found by the configuration's format,
P2PKH's numbers unchanged by the move, P2TR's derivation and shares."""

import io
import json
import random
import time
from fractions import Fraction

import pytest

from benchmark import check, harness, run
from benchmark.reference import address, bech32, hashes
from benchmark.reference import secp256k1 as ec
from benchmark.reference.formats import p2tr
from benchmark.tests import tiny
from benchmark.traffic import Inputs

# keys under 343 whose compressed P2PKH address starts with '1K'
KEYS_1K = [24, 41, 43, 55, 68, 82, 88, 99, 166, 204, 206, 216, 248, 259,
           288, 296, 305, 335, 337, 342]
OPS = 1200  # keys counted, from key 1 in the range case
PINNED_CASES = ("random", "range")


def _case(name, seed=2**31 + 1):
    """(cell, inputs, matches, operations, seed, checkpoint) of one fixed
    list of reported matches, with a wrong WIF, a wrong address, a key one
    off, a key whose address the pattern rejects, two neighbours swapped
    and a key past the keys counted."""
    def sound(k):
        return k, address.p2pkh(k), address.wif_compressed(k)

    matches = [sound(k) for k in KEYS_1K]
    matches[3] = (55, address.p2pkh(55), address.wif_compressed(56))
    matches[7] = (99, address.p2pkh(100), address.wif_compressed(99))
    matches[9] = sound(205)
    matches[12] = (249,) + sound(248)[1:]
    matches[15], matches[16] = matches[16], matches[15]
    matches.append(sound(5000))
    numbers = ["wrong_matches", "match_deficit"]
    if name == "random":
        inputs, ckpt, sample = Inputs(pattern="^1K"), None, 8
    else:
        numbers += ["out_of_order", "out_of_range", "checkpoint_off"]
        inputs, sample = Inputs(pattern="^1K", start=1, end=4000), 512
        ckpt = {"next_key": f"{1 + OPS:x}", "operations": OPS,
                "matches": [f"{k:x}" for k, _, _ in matches]}
    cell = {"config_spec": {"format": "p2pkh"}, "sample_matches": sample,
            "limits": {n: 0 for n in numbers}}
    return cell, inputs, matches, OPS, seed, ckpt


# what the check gave on these lists before the derivation and the share
# moved behind reference/formats/p2pkh.py; the random case samples 8 of 21
# matches, so its count follows the sample's draws, seed by seed
DEFICIT = 6.120127120841653
PINNED_RANDOM = (2, 2, 3, 3, 2, 4, 3, 1)  # seeds 2^31 + 1 to 2^31 + 8
PINNED = {
    "random": [{"wrong_matches": n, "match_deficit": DEFICIT}
               for n in PINNED_RANDOM],
    "range": [{"wrong_matches": 5, "match_deficit": DEFICIT,
               "out_of_order": 1, "out_of_range": 1, "checkpoint_off": 0}],
}


@pytest.mark.parametrize("name", PINNED_CASES)
def test_p2pkh_numbers_as_before(name):
    got = [check.judge(*_case(name, 2**31 + 1 + i))
           for i in range(len(PINNED[name]))]
    assert got == PINNED[name]


def _p2tr_cell():
    return {"config_spec": {"format": "p2tr"}, "sample_matches": 512,
            "limits": {"wrong_matches": 0, "match_deficit": 8.0}}


def test_p2tr_cell_judged_as_p2tr():
    keys = [3, 5, 7, 11]
    sound = [(k, a, w) for k, (a, w) in zip(keys, p2tr.derive_many(keys))]
    inputs = Inputs(pattern="^bc1p")
    got = check.judge(_p2tr_cell(), inputs, sound, 4, 1, None)
    # ^bc1p matches every P2TR address: 4 keys, 4 expected
    assert got == {"wrong_matches": 0,
                   "match_deficit": check.poisson_deficit(4, 4.0)}
    as_p2pkh = [(k, address.p2pkh(k), w) for k, _, w in sound]
    assert check.judge(_p2tr_cell(), inputs, as_p2pkh, 4, 1,
                       None)["wrong_matches"] == 4


def test_no_address_counts_as_wrong(monkeypatch):
    """A tweak t >= n, and Q at infinity (key 1: P = G, t = n - 1), leave
    the key no address, and a match reported for it is wrong."""
    real = p2tr.sha256
    monkeypatch.setattr(check, "format_reference", lambda fmt: p2tr)
    sound = (1, p2tr.p2tr(1), address.wif_compressed(1))
    for t in (2**256 - 1, ec.N - 1):
        monkeypatch.setattr(p2tr, "sha256", lambda b, t=t: (
            t.to_bytes(32, "big") if len(b) == 96 else real(b)))
        assert p2tr.derive_many([1]) == [None]
        assert check.judge(_p2tr_cell(), Inputs(pattern="^bc1p"), [sound],
                           1, 1, None)["wrong_matches"] == 1


def test_missing_format_fails_the_run(tmp_path):
    """A format with no module under reference/formats: the run raises,
    naming the file, and prints no result."""
    root = tiny.tiny_root(tmp_path)
    conf = dict(tiny.TINY_CONFIGS["tiny-vanity"], format="p2wpkh")
    (root / "configs" / "tiny-p2wpkh.json").write_text(json.dumps(conf))
    cell = dict(tiny.TINY_CELLS["tiny-vanity.prefix"], config="tiny-p2wpkh",
                pattern="q$")
    (root / "workloads" / "tiny-p2wpkh.suffix.json").write_text(
        json.dumps(cell))
    out = io.StringIO()
    with pytest.raises(FileNotFoundError, match=r"formats/p2wpkh\.py"):
        run.run(harness.load_cell("tiny-p2wpkh.suffix", root), 2**31 + 3,
                0.5, 0, "cpu", time.perf_counter(), out=out)
    assert out.getvalue() == ""


def test_p2tr_against_the_programs_derivations():
    """Seeded keys and the ends of the key range: the port's pure-Python
    oracle and its native derivation give the reference's address, and the
    oracle its WIF."""
    from vgen_tpu_torch import native
    from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator

    rng = random.Random(2**31 + 86)
    keys = [1, 2, 3, ec.N - 2, ec.N - 1] + [rng.randrange(1, ec.N)
                                            for _ in range(27)]
    ref = p2tr.derive_many(keys)
    gen = AddressGenerator(AddressFormat.P2TR)
    oracle = [gen.generate(k.to_bytes(32, "big")) for k in keys]
    assert [(g.address, g.wif) for g in oracle] == ref
    assert native.available(), native.build_error()
    assert native.derive_addresses(keys, "p2tr") == [a for a, _ in ref]


# BIP-350's valid segwit addresses (scriptPubKey: version opcode, length,
# program), the last two of version 1 (bech32m), of which one holds x(G)
BIP350 = [
    ("BC1QW508D6QEJXTDG4Y5R3ZARVARY0C5XW7KV8F3T4",
     "0014751e76e8199196d454941c45d1b3a323f1433bd6"),
    ("bc1pw508d6qejxtdg4y5r3zarvary0c5xw7kw508d6qejxtdg4y5r3zarvary0c5xw7k"
     "t5nd6y", "5128751e76e8199196d454941c45d1b3a323f1433bd6751e76e8199196d4"
     "54941c45d1b3a323f1433bd6"),
    ("BC1SW50QGDZ25J", "6002751e"),
    ("bc1zw508d6qejxtdg4y5r3zarvaryvaxxpcs",
     "5210751e76e8199196d454941c45d1b3a323"),
    ("tb1pqqqqp399et2xygdj5xreqhjjvcmzhxw4aywxecjdzew6hylgvsesf3hn0c",
     "5120000000c4a5cad46221b2a187905e5266362b99d5e91c6ce24d165dab93e86433"),
    ("bc1p0xlxvlhemja6c4dqv22uapctqupfhlxm9h8z3k2e72q4k9hcz7vqzk5jj0",
     "512079be667ef9dcbbac55a06295ce870b07029bfcdb2dce28d959f2815b16f81798"),
]


@pytest.mark.parametrize("addr, script", BIP350)
def test_bip350_vectors(addr, script):
    raw = bytes.fromhex(script)
    version = raw[0] - 0x50 if raw[0] else 0
    assert raw[1] == len(raw) - 2
    assert bech32.encode(addr[:2].lower(), version, raw[2:]) == addr.lower()


# BIP-86's account 0 of the mnemonic "abandon" x 11 + "about":
# m/86'/0'/0'/0/0, /0/1 and /1/0 (internal key, output key, address)
BIP86 = [
    ("cc8a4bc64d897bddc5fbc2f670f7a8ba0b386779106cf1223c6fc5d7cd6fc115",
     "a60869f0dbcf1dc659c9cecbaf8050135ea9e8cdc487053f1dc6880949dc684c",
     "bc1p5cyxnuxmeuwuvkwfem96lqzszd02n6xdcjrs20cac6yqjjwudpxqkedrcr"),
    ("83dfe85a3151d2517290da461fe2815591ef69f2b18a2ce63f01697a8b313145",
     "a82f29944d65b86ae6b5e5cc75e294ead6c59391a1edc5e016e3498c67fc7bbb",
     "bc1p4qhjn9zdvkux4e44uhx8tc55attvtyu358kutcqkudyccelu0was9fqzwh"),
    ("399f1b2f4393f29a18c937859c5dd8a77350103157eb880f02e8c08214277cef",
     "882d74e5d0572d5a816cef0041a96b6c1de832f6f9676d9605c44d5e9a97d3dc",
     "bc1p3qkhfews2uk44qtvauqyr2ttdsw7svhkl9nkm9s9c3x4ax5h60wqwruhk7"),
]
# the extended private key BIP-86 gives for m/86'/0'/0'/0/0
BIP86_XPRV = ("xprvA449goEeU9okwCzzZaxiy475EQGQzBkc65su82nXEvcwzfSskb2hAt2"
              "WymrjyRL6kpbVTGL3cKtp9herYXSjjQ1j4stsXXiRF7kXkCacK3T")


@pytest.mark.parametrize("internal, output, addr", BIP86)
def test_bip86_tweak(internal, output, addr):
    x = int(internal, 16)
    y = pow(x**3 + 7, (ec.P + 1) // 4, ec.P)  # either root: the even is taken
    assert (y * y - x**3 - 7) % ec.P == 0
    for root in (y, ec.P - y):
        assert p2tr.output_key((x, root)) == int(output, 16)
    assert bech32.encode("bc", 1, bytes.fromhex(output)) == addr


def test_bip86_private_key():
    n = 0
    for c in BIP86_XPRV:
        n = n * 58 + address.ALPHABET.index(c)
    raw = n.to_bytes(82, "big")
    assert hashes.sha256(hashes.sha256(raw[:78]))[:4] == raw[78:]
    key = int.from_bytes(raw[46:78], "big")
    assert ec.compressed(ec.multiply(key))[1:].hex() == BIP86[0][0]
    assert p2tr.derive_many([key]) == [(BIP86[0][2],
                                        address.wif_compressed(key))]


@pytest.mark.parametrize("pattern, k", [
    ("^bc1p", 0), ("^bc1pq", 1), ("^bc1pcafe", 4), ("^bc1p" + "l" * 51, 51),
    ("q$", 1), ("cafe$", 4), ("qpzry9$", 6),
])
def test_p2tr_share(pattern, k):
    assert p2tr.share(pattern) == Fraction(1, 32**k)


@pytest.mark.parametrize("pattern", [
    "^bc1qcafe", "qpzry9x$", "^bc1pcafe|^bc1pdead", "^bc1p" + "q" * 52,
    "^bc1pbad", "cafe", "^bc1p[qp]", "^bc1pcafe$",
])
def test_p2tr_share_has_no_closed_form(pattern):
    with pytest.raises(ValueError):
        p2tr.share(pattern)
