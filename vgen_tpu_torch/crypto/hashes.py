"""Host-side hash primitives: SHA-256, RIPEMD-160, Keccak-256, tagged hashes.

Ground truth for the device hash kernels (reference device versions:
shaders/sha256.wgsl, shaders/ripemd160.wgsl; Keccak only existed on the
reference's CPU via the `sha3` crate, address.rs:7,100-103).

SHA-256 comes from hashlib.  RIPEMD-160 prefers hashlib/OpenSSL but carries
a pure-Python fallback (modern OpenSSL builds often drop it).  Keccak-256
(the pre-NIST padding Ethereum uses -- NOT sha3_256) is pure Python.
"""

from __future__ import annotations

import hashlib
from typing import List


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha256d(data: bytes) -> bytes:
    return sha256(sha256(data))


def hash160(data: bytes) -> bytes:
    return ripemd160(sha256(data))


def tagged_hash(tag: str, data: bytes) -> bytes:
    """BIP340 tagged hash: SHA256(SHA256(tag) || SHA256(tag) || data)."""
    t = sha256(tag.encode())
    return sha256(t + t + data)


# ---------------------------------------------------------------------------
# RIPEMD-160
# ---------------------------------------------------------------------------

try:  # prefer OpenSSL when the provider still ships ripemd160
    hashlib.new("ripemd160", b"")
    _HAVE_OPENSSL_RIPEMD = True
except Exception:  # pragma: no cover - environment dependent
    _HAVE_OPENSSL_RIPEMD = False


_R_PERM_L = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8],
    [3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12],
    [1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2],
    [4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13],
]
_R_PERM_R = [
    [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12],
    [6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2],
    [15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13],
    [8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14],
    [12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11],
]
_R_SHIFT_L = [
    [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8],
    [7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12],
    [11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5],
    [11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12],
    [9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6],
]
_R_SHIFT_R = [
    [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6],
    [9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11],
    [9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5],
    [15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8],
    [8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11],
]
_R_K_L = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_R_K_R = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]

_M32 = 0xFFFFFFFF


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def _ripemd_f(j: int, x: int, y: int, z: int) -> int:
    if j == 0:
        return x ^ y ^ z
    if j == 1:
        return (x & y) | (~x & z) & _M32
    if j == 2:
        return (x | (~y & _M32)) ^ z
    if j == 3:
        return (x & z) | (y & (~z & _M32))
    return x ^ (y | (~z & _M32))


def ripemd160_pure(data: bytes) -> bytes:
    """Pure-Python RIPEMD-160 (RIPE spec structure)."""
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    # padding: 0x80, zeros, 8-byte little-endian bit length
    bitlen = len(data) * 8
    msg = data + b"\x80"
    msg += b"\x00" * ((56 - len(msg) % 64) % 64)
    msg += bitlen.to_bytes(8, "little")
    for off in range(0, len(msg), 64):
        x = [
            int.from_bytes(msg[off + 4 * i : off + 4 * i + 4], "little")
            for i in range(16)
        ]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for rnd in range(5):
            for i in range(16):
                # left line
                t = (
                    al
                    + _ripemd_f(rnd, bl, cl, dl)
                    + x[_R_PERM_L[rnd][i]]
                    + _R_K_L[rnd]
                ) & _M32
                t = (_rotl32(t, _R_SHIFT_L[rnd][i]) + el) & _M32
                al, bl, cl, dl, el = el, t, bl, _rotl32(cl, 10), dl
                # right line (mirrored round function)
                t = (
                    ar
                    + _ripemd_f(4 - rnd, br, cr, dr)
                    + x[_R_PERM_R[rnd][i]]
                    + _R_K_R[rnd]
                ) & _M32
                t = (_rotl32(t, _R_SHIFT_R[rnd][i]) + er) & _M32
                ar, br, cr, dr, er = er, t, br, _rotl32(cr, 10), dr
        t = (h[1] + cl + dr) & _M32
        h[1] = (h[2] + dl + er) & _M32
        h[2] = (h[3] + el + ar) & _M32
        h[3] = (h[4] + al + br) & _M32
        h[4] = (h[0] + bl + cr) & _M32
        h[0] = t
    return b"".join(v.to_bytes(4, "little") for v in h)


def ripemd160(data: bytes) -> bytes:
    if _HAVE_OPENSSL_RIPEMD:
        return hashlib.new("ripemd160", data).digest()
    return ripemd160_pure(data)


# ---------------------------------------------------------------------------
# Keccak-256 (Ethereum flavour: multi-rate pad 0x01 ... 0x80, NOT SHA3's 0x06)
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y] for lane (x, y)
_KECCAK_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M64 = 0xFFFFFFFFFFFFFFFF


def _rotl64(x: int, n: int) -> int:
    n %= 64
    if n == 0:
        return x
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(state: List[int]) -> List[int]:
    """Keccak-f[1600] permutation. state: 25 lanes, index [x + 5*y]."""
    a = state
    for rc in _KECCAK_RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[x + 5 * y] ^ d[x] for y in range(5) for x in range(5)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                    a[x + 5 * y], _KECCAK_ROT[x][y]
                )
        # chi
        a = [
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y] & _M64) & b[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
        # iota
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    rate = 136  # bytes, for 256-bit output
    state = [0] * 25
    # absorb with multi-rate padding 0x01 .. 0x80
    padded = data + b"\x01"
    padded += b"\x00" * ((rate - len(padded) % rate) % rate)
    padded = padded[:-1] + bytes([padded[-1] | 0x80])
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out[:32]
