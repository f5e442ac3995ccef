"""The benchmark's plain reference against published vectors."""

import hashlib
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import pytest

from benchmark.reference import address, density, hashes
from benchmark.reference import secp256k1 as ec

REPO = Path(__file__).resolve().parents[2]

# b1000 puzzle number -> (solved key, published address)
SOLVED = {
    1: (0x1, "1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH"),
    2: (0x3, "1CUNEBjYrCn2y1SdiUMohaKUi4wpP326Lb"),
    3: (0x7, "19ZewH8Kk1PDbSNdJ97FP4EiCjTRaZMZQA"),
    4: (0x8, "1EhqbyUMvvs7BfL8goY6qcPbD6YKfPqb7e"),
    5: (0x15, "1E6NuFjCi27W5zoXg8TRdcSRq84zJeBW3k"),
    6: (0x31, "1PitScNLyp2HCygzadCh7FveTnfmpPbfp8"),
    7: (0x4C, "1McVt1vMtCC7yn5b9wgX1833yCcLXzueeC"),
    8: (0xE0, "1M92tSqNmQLYw33fuBvjmeadirh1ysMBxK"),
    10: (0x202, "1LeBZP5QCwwgXRtmVUvTVrraqPUokyLHqe"),
    20: (0xD2C55, "1HsMJxNiV7TLxmoF6uJNkydxPFDog4NQum"),
    32: (0xB862A62E, "1FRoHA9xewq7DjrZ1psWJVeTer8gHRqEvR"),
    34: (0x34A65911D, "1PWABE7oUahG2AFFQhhvViQovnCr4rEv7Q"),
    64: (0xF7051F27B09112D4, "16jY7qLJnxb7CHZyqBP8qca9d51gAjyXQN"),
    65: (0x1A838B13505B26867, "18ZMbwUFLMHoZBbfpCjUJQTCMCbktshgpe"),
    66: (0x2832ED74F2B5E35EE, "13zb1hQbWVsc2S7ZTZnP2G4undNNpdh5so"),
    70: (0x349B84B6431A6C4EF1, "19YZECXj3SxEZMoUeJ1yiPsw8xANe7M7QR"),
    75: (0x4C5CE114686A1336E07, "1J36UjUByGroXcCvmj13U6uwaVv9caEeAt"),
    80: (0xEA1A5C66DCC11B5AD180, "1BCf6rHUW6m3iH2ptsvnjgLruAiPQQepLe"),
    85: (0x11720C4F018D51B8CEBBA8, "1Kh22PvXERd2xpTQk3ur6pPEqFeckCJfAr"),
    90: (0x2CE00BB2136A445C71E85BF, "1L12FHH2FHjvTviyanuiFVfmzCy46RRATU"),
    95: (0x527A792B183C7F64A0E8B1F4, "19eVSDuizydXxhohGh8Ki9WY9KsHdSwoQC"),
    100: (0xAF55FC59C335C8EC67ED24826, "1KCgMv8fo2TPBpddVi9jqmMmcne9uSNJ5F"),
    105: (0x16F14FC2054CD87EE6396B33DF3, "1CMjscKB3QW7SDyQ4c3C3DEUHiHRhiZVib"),
    110: (0x35C0D7234DF7DEB0F20CF7062444,
          "12JzYkkN76xkwvcPT6AWKZtGX6w2LAgsJg"),
    115: (0x60F4D11574F5DEEE49961D9609AC6,
          "1NLbHuJebVwUZ1XqDjsAyfTRUPwDQbemfv"),
    130: (0x33E7665705359F04F28B88CF897C603C9,
          "1Fo65aKq8s8iquMt6weF1rku1moWVEd5Ua"),
}


def test_key_one():
    assert address.p2pkh(1) == "1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH"
    assert address.wif_compressed(1) == (
        "KwDiBf89QgGbjEhKnhXJuH7LrciVrZi3qYjgd9M7rFU73sVHnoWn")


@pytest.mark.parametrize("number", sorted(SOLVED))
def test_solved_puzzles(number):
    key, published = SOLVED[number]
    assert address.p2pkh(key) == published


def test_solved_keys_are_the_providers():
    from vgen_tpu_torch.provider import _B1000_SOLVED_KEYS

    for number, (key, _) in SOLVED.items():
        assert _B1000_SOLVED_KEYS[number] == key


@pytest.mark.parametrize("message, digest", [
    (b"", "9c1185a5c5e9fc54612808977ee8f548b2258d31"),
    (b"a", "0bdc9d2d256b3ee9daae347be6f4dc835a467ffe"),
    (b"abc", "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"),
    (b"message digest", "5d0689ef49d2fae572b881b123a85ffa21595f36"),
    (b"abcdefghijklmnopqrstuvwxyz",
     "f71c27109c692c1b56bbdceb5b9d2865b3708dbc"),
])
def test_ripemd160_vectors(message, digest):
    assert hashes.ripemd160(message).hex() == digest


def test_ripemd160_batch_lengths():
    msgs = [os.urandom(n) for n in range(56)]
    got = hashes.ripemd160_batch(msgs)
    for m, d in zip(msgs, got):
        if "ripemd160" in hashlib.algorithms_available:
            assert d == hashlib.new("ripemd160", m).digest()
        assert d == hashes.ripemd160(m)
    with pytest.raises(ValueError):
        hashes.ripemd160(bytes(56))


def test_curve():
    assert ec.multiply(ec.N - 1) == (ec.GX, ec.P - ec.GY)
    x, y = ec.multiply(2)
    assert (y * y - x ** 3 - 7) % ec.P == 0
    # 2G by the chord-and-tangent formula on affine points
    lam = 3 * ec.GX * ec.GX * pow(2 * ec.GY, -1, ec.P) % ec.P
    x2 = (lam * lam - 2 * ec.GX) % ec.P
    assert (x, y) == (x2, (lam * (ec.GX - x2) - ec.GY) % ec.P)
    assert ec.multiply(3) == ec.to_affine(
        ec._add_affine((x, y, 1), (ec.GX, ec.GY)))
    with pytest.raises(ValueError):
        ec.multiply(ec.N)


def test_density_counts():
    # '^1' + a letter: N >= 2^184 whose first base-58 digit is that letter
    full = density.p2pkh_share("^1K")
    assert full == density.p2pkh_share("^1P")
    assert abs(float(full) - (58**32 + 58**31) / 2**192) < 1e-15
    assert density.p2pkh_share("^1Kitty") == full / 58**4
    assert density.p2pkh_share("Kitty$") == density.p2pkh_share("zzzzz$")
    assert float(density.p2pkh_share("Kitty$")) == 58.0 ** -5
    # digits 24 and up lead only 32-digit numbers
    assert density.p2pkh_share("^1z") == Fraction(58**32 - 57 * 58**31,
                                                  2**192)
    for bad in ("^1Cat|^1Dog", "^11", "[Cc]at$", "^1Ca.t"):
        with pytest.raises(ValueError):
            density.p2pkh_share(bad)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.address, benchmark.reference.density\n"
            "import benchmark.reference.formats.p2pkh\n"
            "import benchmark.reference.formats.p2tr\n"
            "from benchmark import check\n"
            "check.format_reference('p2pkh'), check.format_reference('p2tr')\n"
            "import benchmark.check, benchmark.traffic, benchmark.work\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('vgen_tpu_torch', 'vgen_tpu', 'jax', 'jaxlib', 'flax', "
            "'torch')]\n"
            "assert not bad, bad\n" % str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


@pytest.mark.parametrize("cell", ["p2pkh-vanity.prefix", "p2pkh-vanity.suffix",
                                  "puzzle71-range.prefix",
                                  "puzzle71-range.prefix5"])
def test_cell_shares_against_estimate(cell):
    """The port's ``estimate`` counts 58 values for every character; the
    exact share differs from 1 / estimate only by the character after '1'
    of a prefix, which carries the weight of about 23 of 58 values."""
    from benchmark import harness, traffic
    from vgen_tpu_torch.crypto.address import AddressFormat
    from vgen_tpu_torch.pattern import Pattern

    pattern = traffic.make(harness.load_cell(cell), 1).pattern
    estimate = Pattern(pattern).estimate_difficulty(AddressFormat.P2PKH)
    ratio = density.p2pkh_share(pattern) * estimate
    if pattern.startswith("^1"):
        assert ratio == Fraction(58**33 + 58**32, 2**192)
        assert abs(float(ratio) - 2.528) < 1e-3
    else:
        assert ratio == 1
