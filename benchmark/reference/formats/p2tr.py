"""P2TR, a key-path-only Taproot output: the address and WIF of a key, and
the share of addresses a pattern matches.

The address follows the BIPs:

- P = k G, negated where its Y is odd, so that x(P) is the BIP-340
  x-only internal key;
- t = SHA256(SHA256("TapTweak") || SHA256("TapTweak") || x(P)), the
  BIP-341 tweak of a key with no script tree; where t >= n, or where
  Q = P + t G is the point at infinity, the key has no address (None);
- the address is bech32m (BIP-350) with the HRP "bc", witness version 1
  ('p') and the 32-byte program x(Q): "bc1p", 52 program symbols (the
  first 51 hold 5 bits of x(Q) each, the 52nd its last bit and four zero
  bits), then six checksum symbols.

The WIF is the compressed WIF of k, as the program and vgen report it for
P2TR.

Shares, with Q taken as uniform over the group (SHA-256 as a random
oracle, as ``density.py`` takes hash160 uniform):

- ``^bc1p`` and k <= 51 symbols: 32^-k.  They are the first 5k bits of
  x(Q), which is uniform over the (n - 1) / 2 x-coordinates of curve
  points.  How many of those lie in an interval of [0, p) is half its
  length, off by at most half of a character sum of x^3 + 7, which
  Weil's bound holds under 3 sqrt(p) (1 + ln p) < 2^137.1; the interval
  of the top prefix runs 2^32 + 977 values past p.  So the share departs
  from 32^-k by under 2^-117 whatever k is: far under 2^-100.
- k <= 6 symbols and ``$``: 32^-k.  They are the checksum, which for a
  fixed HRP and length is an affine function of the data bits over GF(2)
  (the polymod is linear), and onto: the six data symbols that hold bits
  225-254 of x(Q) alone reach every checksum, since a power of x is
  invertible modulo the code's generator.  So the last k symbols take
  each of their 32^k values on as many 256-bit programs.  No bound like
  the prefix's is shown here for x(Q) over the curve's x-coordinates:
  the program is taken as uniform over 256-bit strings.
- Anything else raises ValueError, a suffix of 7 or more symbols among
  it: its seventh symbol from the end is the last data symbol, which
  takes only 2 values.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import List, Optional, Tuple

from benchmark.reference import bech32
from benchmark.reference import secp256k1 as ec
from benchmark.reference.address import wif_compressed
from benchmark.reference.hashes import sha256

_TAG = sha256(b"TapTweak")
_SYMBOL = "[" + bech32.CHARSET + "]"
PROGRAM_SYMBOLS = 51  # symbols that hold 5 bits of x(Q) each
CHECKSUM_SYMBOLS = 6


def output_key(point: ec.Affine) -> Optional[int]:
    """x(Q) of the internal key ``point`` (either Y; the even one is
    taken), or None where the tweak is out of range or Q is infinity."""
    x, y = point
    even = (x, y if y % 2 == 0 else ec.P - y)
    t = int.from_bytes(sha256(_TAG + _TAG + x.to_bytes(32, "big")), "big")
    if t >= ec.N:
        return None
    q = ec.add(even, ec.multiply(t)) if t else even
    return None if q is None else q[0]


def p2tr(key: int) -> Optional[str]:
    qx = output_key(ec.multiply(key))
    return None if qx is None else bech32.encode("bc", 1,
                                                 qx.to_bytes(32, "big"))


def derive_many(keys: List[int]) -> List[Optional[Tuple[str, str]]]:
    out = []
    for k in keys:
        a = p2tr(k)
        out.append(None if a is None else (a, wif_compressed(k)))
    return out


def share(pattern: str) -> Fraction:
    m = (re.fullmatch(r"\^bc1p(" + _SYMBOL + f"{{0,{PROGRAM_SYMBOLS}}})",
                      pattern)
         or re.fullmatch("(" + _SYMBOL + f"{{1,{CHECKSUM_SYMBOLS}}})" + r"\$",
                         pattern))
    if m is None:
        raise ValueError(f"no closed-form P2TR share for {pattern!r}")
    return Fraction(1, 32 ** len(m.group(1)))
