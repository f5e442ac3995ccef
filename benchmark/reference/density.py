"""The share of compressed P2PKH addresses that a pattern matches.

A P2PKH address is '1' (the version byte 0), one more '1' for each
leading zero byte of the hash160, then the base-58 digits of the 24-byte
number N = hash160 || checksum.  With the hash160 uniform, N is uniform
over [0, 2^192), so a pattern's share is a count of integers.
"""

from __future__ import annotations

import re
from fractions import Fraction

from benchmark.reference.address import ALPHABET

_LITERAL = "[" + re.escape(ALPHABET) + "]+"


def _value(digits: str) -> int:
    v = 0
    for c in digits:
        v = v * 58 + ALPHABET.index(c)
    return v


def p2pkh_share(pattern: str) -> Fraction:
    """The exact share for '^1' + a literal that does not start with '1',
    and for a literal + '$'; any other pattern raises ValueError."""
    m = re.fullmatch(r"\^1(" + _LITERAL + ")", pattern)
    if m and not m.group(1).startswith("1"):
        lit = m.group(1)
        v, k = _value(lit), len(lit)
        lo_n, hi_n = 2**184, 2**192  # no zero byte after the version
        count = 0
        for d in range(k, 34):  # d: digits of N
            lo = max(lo_n, 58 ** (d - 1), v * 58 ** (d - k))
            hi = min(hi_n, 58 ** d, (v + 1) * 58 ** (d - k))
            count += max(0, hi - lo)
        return Fraction(count, 2**192)
    m = re.fullmatch("(" + _LITERAL + r")\$", pattern)
    if m:
        return Fraction(1, 58 ** len(m.group(1)))
    raise ValueError(f"no closed-form share for the pattern {pattern!r}")
