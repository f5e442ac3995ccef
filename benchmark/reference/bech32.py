"""Segwit addresses: bech32 (BIP-173) for witness version 0, bech32m
(BIP-350) for versions 1 to 16.

The data part is the witness version as one symbol, then the program
regrouped from 8-bit bytes into 5-bit symbols, most significant bit first,
the last symbol padded with zero bits; then six checksum symbols:
polymod(hrp expanded, data, six zeros) XOR the constant (1 for bech32,
0x2bc830a3 for bech32m), most significant symbol first.
"""

from __future__ import annotations

from typing import List

CHARSET = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"
BECH32, BECH32M = 1, 0x2BC830A3
_GENERATOR = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)


def polymod(values: List[int]) -> int:
    chk = 1
    for v in values:
        top = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i, g in enumerate(_GENERATOR):
            if top >> i & 1:
                chk ^= g
    return chk


def hrp_expand(hrp: str) -> List[int]:
    return [ord(c) >> 5 for c in hrp] + [0] + [ord(c) & 31 for c in hrp]


def to_symbols(program: bytes) -> List[int]:
    """8-bit bytes -> 5-bit symbols, the last padded with zero bits."""
    n, bits = int.from_bytes(program, "big"), 8 * len(program)
    count = -(-bits // 5)
    n <<= 5 * count - bits
    return [n >> 5 * (count - 1 - i) & 31 for i in range(count)]


def encode(hrp: str, version: int, program: bytes) -> str:
    data = [version] + to_symbols(program)
    const = BECH32 if version == 0 else BECH32M
    mod = polymod(hrp_expand(hrp) + data + [0] * 6) ^ const
    data += [mod >> 5 * (5 - i) & 31 for i in range(6)]
    return hrp + "1" + "".join(CHARSET[d] for d in data)
