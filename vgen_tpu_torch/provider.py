"""Puzzle data providers: resolve "boha:collection:id" references.

Parity with the reference's provider module (provider.rs:12-63): a pattern
of the form "provider:collection:id" (or "provider:collection/id") resolves
to a target address + format + optional key range; build_pattern /
build_exact_pattern turn it into an anchored regex.

Data: the reference pulls from the `boha` crate at build time.  Here the
b1000 collection (the classic "Bitcoin Puzzle" / 32-BTC transaction) is
embedded: every puzzle n has the key range [2^(n-1), 2^n - 1]; addresses
are derived at import time from the publicly known solved keys (verified in
tests against the two addresses the reference's own test suite anchors:
puzzle 1 -> 1BgGZ9... provider.rs:81-85, puzzle 66 -> 13zb1h...
provider.rs:110-117).  Unsolved puzzles without embedded addresses can be
supplied via a JSON file at $VGEN_TPU_PUZZLES or ~/.config/vgen_tpu/puzzles.json
with {"b1000": {"71": {"address": "...", "kind": "p2pkh"}}}.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator

# Publicly known solved keys of the b1000 puzzle (puzzle number -> hex key).
_B1000_SOLVED_KEYS: Dict[int, int] = {
    1: 0x1, 2: 0x3, 3: 0x7, 4: 0x8, 5: 0x15, 6: 0x31, 7: 0x4C, 8: 0xE0,
    9: 0x1D3, 10: 0x202, 11: 0x483, 12: 0xA7B, 13: 0x1460, 14: 0x2930,
    15: 0x68F3, 16: 0xC936, 17: 0x1764F, 18: 0x3080D, 19: 0x5749F,
    20: 0xD2C55, 21: 0x1BA534, 22: 0x2DE40F, 23: 0x556E52, 24: 0xDC2A04,
    25: 0x1FA5EE5, 26: 0x340326E, 27: 0x6AC3875, 28: 0xD916CE8,
    29: 0x17E2551E, 30: 0x3D94CD64, 31: 0x7D4FE747, 32: 0xB862A62E,
    33: 0x1A96CA8D8, 34: 0x34A65911D, 35: 0x4AED21170, 36: 0x9DE820A7C,
    37: 0x1757756A93, 38: 0x22382FACD0, 39: 0x4B5F8303E9, 40: 0xE9AE4933D6,
    41: 0x153869ACC5B, 42: 0x2A221C58D8F, 43: 0x6BD3B27C591,
    44: 0xE02B35A358F, 45: 0x122FCA143C05, 46: 0x2EC18388D544,
    47: 0x6CD610B53CBA, 48: 0xADE6D7CE3B9B, 49: 0x174176B015F4D,
    50: 0x22BD43C2E9354, 51: 0x75070A1A009D4, 52: 0xEFAE164CB9E3C,
    53: 0x180788E47E326C, 54: 0x236FB6D5AD1F43, 55: 0x6ABE1F9B67E114,
    56: 0x9D18B63AC4FFDF, 57: 0x1EB25C90795D61C, 58: 0x2C675B852189A21,
    59: 0x7496CBB87CAB44F, 60: 0xFC07A1825367BBE, 61: 0x13C96A3742F64906,
    62: 0x363D541EB611ABEE, 63: 0x7CCE5EFDACCF6808, 64: 0xF7051F27B09112D4,
    65: 0x1A838B13505B26867, 66: 0x2832ED74F2B5E35EE,
    70: 0x349B84B6431A6C4EF1, 75: 0x4C5CE114686A1336E07,
    80: 0xEA1A5C66DCC11B5AD180, 85: 0x11720C4F018D51B8CEBBA8,
    90: 0x2CE00BB2136A445C71E85BF, 95: 0x527A792B183C7F64A0E8B1F4,
    100: 0xAF55FC59C335C8EC67ED24826, 105: 0x16F14FC2054CD87EE6396B33DF3,
    110: 0x35C0D7234DF7DEB0F20CF7062444,
    115: 0x60F4D11574F5DEEE49961D9609AC6,
    130: 0x33E7665705359F04F28B88CF897C603C9,
}

# Published b1000 puzzle addresses for entries whose key is not embedded
# above (public data: the 32-BTC "Bitcoin Puzzle" transaction outputs).
# Every entry is Base58Check-validated at test time (tests/test_provider.py)
# -- a corrupted entry cannot pass the 4-byte double-SHA256 checksum -- and
# every puzzle that ALSO has a solved key above is cross-checked by
# re-deriving the address from the key.  The reference resolves these
# through the boha crate (provider.rs:23-52); unavailable numbers can still
# be supplied via the $VGEN_TPU_PUZZLES JSON (see _external_puzzles).
_B1000_ADDRESSES: Dict[int, str] = {
    67: "1BY8GQbnueYofwSuFAT3USAhGjPrkxDdW9",
    68: "1MVDYgVaSN6iKKEsbzRUAYFrYJadLYZvvZ",
    69: "19vkiEajfhuZ8bs8Zu2jgmC6oqZbWqhxhG",
    70: "19YZECXj3SxEZMoUeJ1yiPsw8xANe7M7QR",
    71: "1PWo3JeB9jrGwfHDNpdGK54CRas7fsVzXU",
    72: "1JTK7s9YVYywfm5XUH7RNhHJH1LshCaRFR",
    73: "12VVRNPi4SJqUTsp6FmqDqY5sGosDtysn4",
    74: "1FWGcVDK3JGzCC3WtkYetULPszMaK2Jksv",
    75: "1J36UjUByGroXcCvmj13U6uwaVv9caEeAt",
    76: "1DJh2eHFYQfACPmrvpyWc8MSTYKh7w9eRF",
    77: "1Bxk4CQdqL9p22JEtDfdXMsng1XacifUtE",
    78: "15qF6X51huDjqTmF9BJgxXdt1xcj46Jmhb",
    79: "1ARk8HWJMn8js8tQmGUJeQHjSE7KRkn2t8",
    80: "1BCf6rHUW6m3iH2ptsvnjgLruAiPQQepLe",
    81: "15qsCm78whspNQFydGJQk5rexzxTQopnHZ",
    82: "13zYrYhhJxp6Ui1VV7pqa5WDhNWM45ARAC",
    83: "14MdEb4eFcT3MVG5sPFG4jGLuHJSnt1Dk2",
    84: "1CMq3SvFcVEcpLMuuH8PUcNiqsK1oicG2D",
    85: "1Kh22PvXERd2xpTQk3ur6pPEqFeckCJfAr",
    86: "1K3x5L6G57Y494fDqBfrojD28UJv4s5JcK",
    87: "1PxH3K1Shdjb7gSEoTX7UPDZ6SH4qGPrvq",
    88: "16AbnZjZZipwHMkYKBSfswGWKDmXHjEpSf",
    89: "19QciEHbGVNY4hrhfKXmcBBCrJSBZ6TaVt",
    90: "1L12FHH2FHjvTviyanuiFVfmzCy46RRATU",
    91: "1EzVHtmbN4fs4MiNk3ppEnKKhsmXYJ4s74",
    92: "1AE8NzzgKE7Yhz7BWtAcAAxiFMbPo82NB5",
    93: "17Q7tuG2JwFFU9rXVj3uZqRtioH3mx2Jad",
    94: "1K6xGMUbs6ZTXBnhw1pippqwK6wjBWtNpL",
    95: "19eVSDuizydXxhohGh8Ki9WY9KsHdSwoQC",
    96: "15ANYzzCp5BFHcCnVFzXqyibpzgPLWaD8b",
    97: "18ywPwj39nGjqBrQJSzZVq2izR12MDpDr8",
    98: "1CaBVPrwUxbQYYswu32w7Mj4HR4maNoJSX",
    99: "1JWnE6p6UN7ZJBN7TtcbNDoRcjFtuDWoNL",
    100: "1KCgMv8fo2TPBpddVi9jqmMmcne9uSNJ5F",
    105: "1CMjscKB3QW7SDyQ4c3C3DEUHiHRhiZVib",
    110: "12JzYkkN76xkwvcPT6AWKZtGX6w2LAgsJg",
    115: "1NLbHuJebVwUZ1XqDjsAyfTRUPwDQbemfv",
    120: "17s2b9ksz5y7abUm92cHwG8jEPCzK3dLnT",
    125: "1PXAyUB8ZoH3WD8n5zoAthYjN15yN5CVq5",
    130: "1Fo65aKq8s8iquMt6weF1rku1moWVEd5Ua",
    135: "16RGFo6hjq9ym6Pj7N5H7L1NR1rVPJyw2v",
    140: "1QKBaU6WAeycb3DbKbLBkX7vJiaS8r42Xo",
    145: "19GpszRNUej5yYqxXoLnbZWKew3KdVLkXg",
    150: "1MUJSJYtGPVGkBCTqGspnxyHahpt5Te8jy",
    155: "1AoeP37TmHdFh8uN72fu9AqgtLrUwcv2wJ",
    160: "1NBC8uXJy1GiJ6drkiZa1WuKn51ps7EPTv",
}


class ProviderError(ValueError):
    pass


@dataclass
class ProviderResult:
    address: str
    format: AddressFormat
    key_range: Optional[Tuple[int, int]]


@lru_cache(maxsize=None)
def _derived_address(key: int) -> str:
    ga = AddressGenerator(AddressFormat.P2PKH).generate(key.to_bytes(32, "big"))
    assert ga is not None
    return ga.address


def _external_puzzles() -> Dict[str, Dict[str, dict]]:
    for path in (
        os.environ.get("VGEN_TPU_PUZZLES"),
        os.path.expanduser("~/.config/vgen_tpu/puzzles.json"),
    ):
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)
            except (OSError, json.JSONDecodeError):
                pass
    return {}


def resolve(pattern: str) -> Optional[ProviderResult]:
    """None if `pattern` is not a provider reference (plain regex);
    raises ProviderError for a provider reference that cannot resolve."""
    if ":" not in pattern:
        return None
    provider, path = pattern.split(":", 1)
    if provider != "boha":
        return None
    return _resolve_boha(path)


def _resolve_boha(path: str) -> ProviderResult:
    puzzle_id = path.replace(":", "/")
    parts = puzzle_id.split("/")
    if len(parts) != 2:
        raise ProviderError(f"invalid puzzle reference 'boha:{path}'")
    collection, num_str = parts
    if collection != "b1000":
        # boha ships further collections (gsmg, bitaps, ... --
        # reference README.md:115); their data cannot be verified in this
        # offline build, so they resolve only via the external-JSON hook:
        # {"<collection>": {"<id>": {"address": ..., "kind": ...,
        #  "range": [lo_hex, hi_hex]}}}
        ext = _external_puzzles().get(collection, {}).get(num_str)
        if ext and "address" in ext:
            fmt = AddressFormat.from_str(ext.get("kind", "p2pkh"))
            rng = ext.get("range")
            key_range = (
                (int(rng[0], 16), int(rng[1], 16)) if rng else None
            )
            return ProviderResult(ext["address"], fmt, key_range)
        raise ProviderError(
            f"unknown collection '{collection}': only b1000 is embedded "
            f"(this offline build cannot verify third-party puzzle data; "
            f"the reference pulls it from the boha crate at build time). "
            f"To use it, write the puzzle data to a JSON file and point "
            f"$VGEN_TPU_PUZZLES at it (or ~/.config/vgen_tpu/puzzles.json):"
            f'\n  {{"{collection}": {{"{num_str}": {{'
            f'"address": "1YourTargetAddress...", "kind": "p2pkh", '
            f'"range": ["1", "ffffffff"]}}}}}}'
            f"\nkind: p2pkh|p2wpkh|p2sh-p2wpkh|p2tr|ethereum; range "
            f"(optional): [lo_hex, hi_hex] private-key bounds. Then rerun: "
            f"vgen-tpu generate -p 'boha:{collection}:{num_str}'"
        )
    try:
        n = int(num_str)
    except ValueError:
        raise ProviderError(f"invalid puzzle number '{num_str}'")
    if not 1 <= n <= 160:
        raise ProviderError(f"puzzle number {n} out of range 1..160")

    key_range = (1 << (n - 1), (1 << n) - 1)

    ext = _external_puzzles().get("b1000", {}).get(str(n))
    if ext and "address" in ext:
        fmt = AddressFormat.from_str(ext.get("kind", "p2pkh"))
        return ProviderResult(ext["address"], fmt, key_range)

    if n in _B1000_SOLVED_KEYS:
        return ProviderResult(
            _derived_address(_B1000_SOLVED_KEYS[n]), AddressFormat.P2PKH, key_range
        )
    if n in _B1000_ADDRESSES:
        return ProviderResult(
            _B1000_ADDRESSES[n], AddressFormat.P2PKH, key_range
        )
    raise ProviderError(
        f"puzzle b1000/{n} has no embedded address data. Supply it via a "
        f"JSON file at $VGEN_TPU_PUZZLES (or "
        f"~/.config/vgen_tpu/puzzles.json):"
        f'\n  {{"b1000": {{"{n}": {{"address": "1ThePuzzleAddress...", '
        f'"kind": "p2pkh"}}}}}}'
        f"\n(the key range [2^{n - 1}, 2^{n}-1] is implied by the puzzle "
        f"number)"
    )


def build_pattern(result: ProviderResult, prefix_length: int) -> str:
    ln = min(prefix_length, len(result.address))
    return "^" + re.escape(result.address[:ln])


def build_exact_pattern(result: ProviderResult) -> str:
    return f"^{re.escape(result.address)}$"
