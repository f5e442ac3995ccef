"""Ethereum: the address of a key, and the share of addresses a pattern
matches.

The address follows the Yellow Paper (appendix F, the account of a key)
and EIP-55:

- the account is the last 20 bytes of keccak256(x || y), x and y of k G as
  32 big-endian bytes each (the uncompressed key without its 0x04 byte);
- the address is "0x" and the account's 40 hex digits, each letter upper
  case where the same nibble of keccak256 of the 40 lower-case ASCII
  digits is 8 or more (EIP-55's mixed-case checksum).

The second element reported beside it is the key as 64 lower-case hex
digits, as the program and vgen report it for Ethereum in place of a WIF.

Shares, with the account taken as uniform over 160-bit strings (Keccak as
a random oracle, as ``density.py`` takes hash160 uniform): ``^0x`` and k
hex digits, k <= 40, match 16^-k of the accounts where no digit is a
letter, or where the scan ignores case; each letter of a case-sensitive
pattern would add EIP-55's casing, a second hash, so it raises
ValueError, as does anything else.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import List, Tuple

from benchmark.reference import secp256k1 as ec
from benchmark.reference.keccak import keccak256_batch

ACCOUNT_DIGITS = 40


def eip55(account: bytes, digest: bytes) -> str:
    """The EIP-55 form of ``account`` given ``digest``, the keccak256 of its
    lower-case hex digits."""
    low = account.hex()
    return "0x" + "".join(
        c.upper() if c.isalpha() and (digest[i // 2] >> (4 - 4 * (i % 2)))
        & 0xF >= 8 else c for i, c in enumerate(low))


def addresses(keys: List[int]) -> List[str]:
    """The EIP-55 addresses of ``keys`` (each in [1, n))."""
    points = [ec.multiply(k) for k in keys]
    accounts = [h[12:] for h in keccak256_batch(
        [x.to_bytes(32, "big") + y.to_bytes(32, "big") for x, y in points])]
    digests = keccak256_batch([a.hex().encode() for a in accounts])
    return [eip55(a, d) for a, d in zip(accounts, digests)]


def derive_many(keys: List[int]) -> List[Tuple[str, str]]:
    return list(zip(addresses(keys), (f"{k:064x}" for k in keys)))


def share(pattern: str, ignore_case: bool = False) -> Fraction:
    m = re.fullmatch(r"\^0x([0-9a-fA-F]{0,%d})" % ACCOUNT_DIGITS, pattern)
    if m is None or not ignore_case and re.search("[a-fA-F]", m.group(1)):
        raise ValueError(f"no closed-form Ethereum share for {pattern!r}")
    return Fraction(1, 16 ** len(m.group(1)))
