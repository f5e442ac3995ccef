"""Keccak-256 written out in NumPy: Keccak-f[1600] over uint64 lanes, with
the padding of the Keccak submission (a 0x01 byte after the message), as
Ethereum uses it, and not FIPS 202's SHA3-256 (0x06).

Written from the Keccak team's reference ("The Keccak reference", version
3.0, sections 1.2 and 2.1): the round constants come from its LFSR and the
rotation offsets from its walk over the lanes, computed here, not copied.
It hashes a batch of messages of one block each (at most 135 bytes at the
rate of 1088 bits), one message per lane of the batch, so that the check
can hash a whole run of keys at once.  ``hashlib`` has SHA3-256 only.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

RATE_BYTES = 136  # Keccak-256: capacity 512 bits of the 1600
ROUNDS = 24


def _round_constants() -> List[int]:
    """RC[i] of Keccak-f[1600]: bit 2^j - 1 of RC[i] is rc(j + 7i), where
    rc(t) is the output of the LFSR x^8 + x^6 + x^5 + x^4 + 1."""
    def rc(t: int) -> int:
        r = 1
        for _ in range(t % 255):
            r <<= 1
            if r & 0x100:
                r ^= 0x171
        return r & 1

    return [sum(rc(j + 7 * i) << (2 ** j - 1) for j in range(7))
            for i in range(ROUNDS)]


def _rotation_offsets() -> List[int]:
    """r[x + 5y]: lane (1, 0) rotates by 1, and along the walk (x, y) ->
    (y, 2x + 3y) the t-th lane by (t + 1)(t + 2) / 2 mod 64."""
    r = [0] * 25
    x, y = 1, 0
    for t in range(24):
        r[x + 5 * y] = (t + 1) * (t + 2) // 2 % 64
        x, y = y, (2 * x + 3 * y) % 5
    return r


RC = [np.uint64(c) for c in _round_constants()]
ROT = _rotation_offsets()


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return v
    return (v << np.uint64(n)) | (v >> np.uint64(64 - n))


def keccak_f1600(a: List[np.ndarray]) -> List[np.ndarray]:
    """The permutation of 25 lanes (lane x + 5y; each a uint64 array over
    the batch)."""
    for rc in RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]  # theta
        b = [None] * 25
        for x in range(5):
            for y in range(5):  # rho and pi
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y],
                                                         ROT[x + 5 * y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)]
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]  # chi
        a[0] = a[0] ^ rc  # iota
    return a


def keccak256_batch(messages: Sequence[bytes]) -> List[bytes]:
    """Keccak-256 of each message (each at most 135 bytes long)."""
    n = len(messages)
    if n == 0:
        return []
    block = np.zeros((n, RATE_BYTES), dtype=np.uint8)
    for i, m in enumerate(messages):
        if len(m) >= RATE_BYTES:
            raise ValueError("one-block messages only (at most 135 bytes)")
        block[i, :len(m)] = np.frombuffer(m, dtype=np.uint8)
        block[i, len(m)] ^= 0x01
        block[i, RATE_BYTES - 1] ^= 0x80
    words = block.view("<u8").astype(np.uint64)  # (n, 17) little-endian
    a = [words[:, i].copy() if i < RATE_BYTES // 8
         else np.zeros(n, dtype=np.uint64) for i in range(25)]
    with np.errstate(over="ignore"):
        a = keccak_f1600(a)
    raw = np.stack(a[:4], axis=1).astype("<u8").tobytes()
    return [raw[32 * i:32 * i + 32] for i in range(n)]


def keccak256(data: bytes) -> bytes:
    return keccak256_batch([data])[0]
