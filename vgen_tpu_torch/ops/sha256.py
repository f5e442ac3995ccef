"""SHA-256 of a compressed or uncompressed public key built straight from
32-bit limbs, and the BIP340 tagged hash of a 32-byte value (plain PyTorch
versions of ``csrc/sha256.cuh``).

Words are int64 tensors holding uint32 values; every sum is masked with
``& 0xFFFFFFFF``.  No partial evaluation: the CUDA compiler folds the
constant schedule words itself.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import torch

M32 = 0xFFFFFFFF

K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def compress(state: List, w: List) -> List[torch.Tensor]:
    """One SHA-256 compression.  state: 8 words, w: 16 words (tensors or
    ints that broadcast against them).  Returns the 8 IV-added words."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t >= 16:
            w15 = w[(t - 15) % 16]
            w2 = w[(t - 2) % 16]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w[t % 16] = (w[t % 16] + s0 + w[(t - 7) % 16] + s1) & M32
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + K[t] + w[t % 16]) & M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + S0 + maj) & M32)
    return [(v + s) & M32 for v, s in zip((a, b, c, d, e, f, g, h), state)]


def x33_schedule_words(x: torch.Tensor, parity) -> List:
    """Message words of SHA-256(parity || x big-endian), from (8, *S)
    32-bit limbs (limb 7 is the most significant).

    Word 0 is the parity byte and the top three bytes of x; words 1..7
    straddle two limbs by 8 bits; word 8 is x's last byte then the 0x80
    pad; word 15 is the bit length 264.  ``parity``: 2, 3 or a tensor."""
    w = [((parity << 24) | (x[7] >> 8)) & M32]
    for i in range(1, 8):
        w.append(((x[8 - i] << 24) | (x[7 - i] >> 8)) & M32)
    w.append(((x[0] & 0xFF) << 24) | 0x00800000)
    w += [0, 0, 0, 0, 0, 0, 264]
    return w


def sha256_x33_state(x: torch.Tensor, parity) -> List[torch.Tensor]:
    """The 8 state words (the digest, big-endian) of the 33-byte compressed
    public key (parity || x)."""
    like = x[0]
    return compress([torch.full_like(like, v) for v in IV],
                    x33_schedule_words(x, parity))


def sha256_x65_state(x: torch.Tensor, y: torch.Tensor) -> List[torch.Tensor]:
    """The 8 state words of the 65-byte uncompressed public key
    04 || x || y (big-endian), two compressions, from (8, *S) 32-bit limbs.

    Block 1: word 0 is 0x04 and x's top three bytes, words 1..7 straddle
    x's limbs by 8 bits, word 8 is x's last byte and y's top three, words
    9..15 straddle y's limbs.  Block 2: y's last byte, the 0x80 pad and the
    bit length 520."""
    w = [((0x04 << 24) | (x[7] >> 8)) & M32]
    w += [((x[8 - i] << 24) | (x[7 - i] >> 8)) & M32 for i in range(1, 8)]
    w.append(((x[0] << 24) | (y[7] >> 8)) & M32)
    w += [((y[8 - i] << 24) | (y[7 - i] >> 8)) & M32 for i in range(1, 8)]
    st = compress([torch.full_like(x[0], v) for v in IV], w)
    w2 = [((y[0] & 0xFF) << 24) | 0x00800000] + [0] * 14 + [520]
    return compress(st, w2)


def tagged_midstate(tag: str) -> Tuple[int, ...]:
    """Host: the SHA-256 state after the first block of a BIP340 tagged
    hash, SHA256(tag) || SHA256(tag) (the counterpart of
    ``vgen_tpu/ops/sha256.py`` ``tagged_midstate``)."""
    t = hashlib.sha256(tag.encode()).digest()
    block = t + t
    w = [int.from_bytes(block[4 * i:4 * i + 4], "big") for i in range(16)]
    return tuple(compress(list(IV), w))


def tagged_hash_32(midstate, x: torch.Tensor) -> torch.Tensor:
    """SHA256(SHA256(tag) || SHA256(tag) || x_be) from the tag's
    ``midstate``: one compression of x's 32 big-endian bytes and the
    padding of a 96-byte message.  x: (8, *S) int64 32-bit limbs (limb 7 the
    most significant) -> the digest as a 256-bit big-endian number in the
    same limb layout."""
    w = [x[7 - i] for i in range(8)]
    w += [0x80000000, 0, 0, 0, 0, 0, 0, 96 * 8]
    st = compress([torch.full_like(x[0], v) for v in midstate], w)
    return torch.stack(st[::-1])
