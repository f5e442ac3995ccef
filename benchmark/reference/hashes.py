"""SHA-256 from hashlib, and RIPEMD-160 written out in NumPy.

RIPEMD-160 follows Dobbertin, Bosselaers and Preneel, "RIPEMD-160: A
strengthened version of RIPEMD" (1996).  It is written here because the
card's machine may carry an OpenSSL without it.  It hashes a batch of
messages of one block each (at most 55 bytes), one message per lane, so
that the check can hash a whole run of keys at once.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# word order and rotation amounts of the left and right lines
_R_LEFT = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
]
_R_RIGHT = [
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
]
_S_LEFT = [
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
]
_S_RIGHT = [
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
]
_K_LEFT = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_K_RIGHT = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]
_H0 = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]


def _f(j: int, x, y, z):
    """The boolean function of round j (0-4) of the left line; the right
    line takes them in the reverse order."""
    if j == 0:
        return x ^ y ^ z
    if j == 1:
        return (x & y) | (~x & z)
    if j == 2:
        return (x | ~y) ^ z
    if j == 3:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


def _rotl(x, s: int):
    return (x << np.uint32(s)) | (x >> np.uint32(32 - s))


def ripemd160_batch(messages: Sequence[bytes]) -> List[bytes]:
    """RIPEMD-160 of each message (each at most 55 bytes long)."""
    n = len(messages)
    if n == 0:
        return []
    block = np.zeros((n, 64), dtype=np.uint8)
    for i, m in enumerate(messages):
        if len(m) > 55:
            raise ValueError("one-block messages only (at most 55 bytes)")
        block[i, :len(m)] = np.frombuffer(m, dtype=np.uint8)
        block[i, len(m)] = 0x80
        block[i, 56:64] = np.frombuffer((8 * len(m)).to_bytes(8, "little"),
                                        dtype=np.uint8)
    x = block.view("<u4").T.astype(np.uint32)  # (16, n) little-endian words
    h = [np.full(n, v, dtype=np.uint32) for v in _H0]
    with np.errstate(over="ignore"):
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for t in range(80):
            j = t // 16
            tl = _rotl(al + _f(j, bl, cl, dl) + x[_R_LEFT[t]]
                       + np.uint32(_K_LEFT[j]), _S_LEFT[t]) + el
            al, bl, cl, dl, el = el, tl, bl, _rotl(cl, 10), dl
            tr = _rotl(ar + _f(4 - j, br, cr, dr) + x[_R_RIGHT[t]]
                       + np.uint32(_K_RIGHT[j]), _S_RIGHT[t]) + er
            ar, br, cr, dr, er = er, tr, br, _rotl(cr, 10), dr
        out = np.stack([h[1] + cl + dr, h[2] + dl + er, h[3] + el + ar,
                        h[4] + al + br, h[0] + bl + cr], axis=1)
    raw = out.astype("<u4").tobytes()
    return [raw[20 * i:20 * i + 20] for i in range(n)]


def ripemd160(data: bytes) -> bytes:
    return ripemd160_batch([data])[0]


def hash160_batch(messages: Sequence[bytes]) -> List[bytes]:
    """RIPEMD-160(SHA-256(m)) of each message."""
    return ripemd160_batch([sha256(m) for m in messages])
