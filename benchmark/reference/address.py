"""Base58Check, and the compressed P2PKH address and WIF of a key.

Base58Check as Bitcoin Core's ``base58.cpp`` defines it: one '1' for each
leading zero byte, then the rest of the number in base 58, after a
checksum of the first four bytes of SHA-256(SHA-256(payload)).
"""

from __future__ import annotations

from typing import List

from benchmark.reference import secp256k1 as ec
from benchmark.reference.hashes import hash160_batch, sha256

ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def b58encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    digits = []
    while n:
        n, r = divmod(n, 58)
        digits.append(ALPHABET[r])
    zeros = len(data) - len(data.lstrip(b"\0"))
    return "1" * zeros + "".join(reversed(digits))


def b58check(payload: bytes) -> str:
    return b58encode(payload + sha256(sha256(payload))[:4])


def wif_compressed(key: int) -> str:
    return b58check(b"\x80" + key.to_bytes(32, "big") + b"\x01")


def p2pkh(key: int) -> str:
    """The compressed P2PKH address of one key."""
    return p2pkh_many([key])[0]


def p2pkh_many(keys: List[int]) -> List[str]:
    """The compressed P2PKH addresses of ``keys``."""
    pubs = [ec.compressed(ec.multiply(k)) for k in keys]
    return [b58check(b"\x00" + h) for h in hash160_batch(pubs)]
