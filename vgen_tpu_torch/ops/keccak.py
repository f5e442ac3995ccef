"""Keccak-f[1600] and the two Keccak-256 hashes of the Ethereum format: the
account keccak256(x || y)[12:32] of a public key, and the EIP-55 checksum
hash of the 40 lowercase-hex ASCII bytes of an account (plain PyTorch
versions of ``csrc/keccak.cuh``; counterparts of ``vgen_tpu/ops/keccak.py``).

The state keeps the reference's layout: each 64-bit lane as a (hi, lo)
pair of 32-bit halves in int64 tensors, lane index x + 5y, stacked as
(25, *S).  PyTorch on the CPU has no uint64 right shift and no uint32
arithmetic, so the halves stand in for the 64-bit lanes the card uses.
Both messages fit one 136-byte block: pad byte 0x01 right after the
message, 0x80 in byte 135 (lane 16, top bit).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from vgen_tpu_torch.ops.ripemd160 import bswap32

M32 = 0xFFFFFFFF

RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
# rho offset of lane (x, y) at index x + 5y
_ROT_XY = ((0, 36, 3, 41, 18), (1, 44, 10, 45, 2), (62, 6, 43, 15, 61),
           (28, 55, 25, 21, 56), (27, 20, 39, 8, 14))
ROT = tuple(_ROT_XY[i % 5][i // 5] for i in range(25))
# pi: lane (x, y) moves to (y, 2x + 3y); PI_SRC[dst] is its source lane
PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
# chi: lane x + 5y combines lanes (x + 1) % 5 + 5y and (x + 2) % 5 + 5y
_CHI1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
_CHI2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]
_THETA_PREV = [(x + 4) % 5 for x in range(5)]
_THETA_NEXT = [(x + 1) % 5 for x in range(5)]


def _rotl64(hi, lo, n):
    """Rotate 64-bit lanes left by n (an int, or a tensor that broadcasts
    against hi), on 32-bit halves."""
    n = torch.as_tensor(n, device=hi.device)
    swap = n >= 32
    h, l = torch.where(swap, lo, hi), torch.where(swap, hi, lo)
    m = n % 32  # a shift by 32 - 0 moves a value < 2^32 out entirely
    return (((h << m) | (l >> (32 - m))) & M32,
            ((l << m) | (h >> (32 - m))) & M32)


def keccak_f1600(hi: torch.Tensor, lo: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 24-round permutation of (25, *S) int64 halves -> (hi, lo)."""
    dev = hi.device
    shape = (25,) + (1,) * (hi.dim() - 1)
    rot = torch.tensor([ROT[s] for s in PI_SRC], device=dev).reshape(shape)
    pi_src = torch.tensor(PI_SRC, device=dev)
    chi1, chi2 = torch.tensor(_CHI1, device=dev), torch.tensor(_CHI2, device=dev)
    prev, nxt = (torch.tensor(_THETA_PREV, device=dev),
                 torch.tensor(_THETA_NEXT, device=dev))
    for r in range(24):
        # theta
        ch = hi[0:5] ^ hi[5:10] ^ hi[10:15] ^ hi[15:20] ^ hi[20:25]
        cl = lo[0:5] ^ lo[5:10] ^ lo[10:15] ^ lo[15:20] ^ lo[20:25]
        rh, rl = _rotl64(ch[nxt], cl[nxt], 1)
        dh, dl = ch[prev] ^ rh, cl[prev] ^ rl
        hi = hi ^ dh.repeat((5,) + (1,) * (hi.dim() - 1))
        lo = lo ^ dl.repeat((5,) + (1,) * (lo.dim() - 1))
        # rho and pi
        hi, lo = _rotl64(hi[pi_src], lo[pi_src], rot)
        # chi (~b & c keeps 32 bits: c < 2^32)
        hi = hi ^ (~hi[chi1] & hi[chi2])
        lo = lo ^ (~lo[chi1] & lo[chi2])
        # iota
        hi[0] ^= RC[r] >> 32
        lo[0] ^= RC[r] & M32
    return hi, lo


def _block(hi_words: List, lo_words: List, like: torch.Tensor):
    """(25, *S) halves of one block: the given lanes, then zeros."""
    def col(v):
        return v if torch.is_tensor(v) else torch.full_like(like, v)

    hi = [col(v) for v in hi_words] + [torch.zeros_like(like)] * (25 - len(hi_words))
    lo = [col(v) for v in lo_words] + [torch.zeros_like(like)] * (25 - len(lo_words))
    return torch.stack(hi), torch.stack(lo)


def eth_account_words_from_xy(x: torch.Tensor, y: torch.Tensor
                              ) -> List[torch.Tensor]:
    """5 big-endian words of keccak256(x_be || y_be)[12:32], the Ethereum
    account, from (8, *S) int64 32-bit limbs (limb 7 the most significant).

    Lane j of a 32-byte big-endian value holds its bytes 8j..8j+7 little-
    endian: lo = bswap32(limb 7 - 2j), hi = bswap32(limb 6 - 2j).  Lanes 0-3
    are x, 4-7 y, lane 8 the 0x01 pad, lane 16 the 0x80 pad.  The account
    is digest bytes 12..31: lanes 1.hi, 2.lo, 2.hi, 3.lo, 3.hi."""
    lo = ([bswap32(x[7 - 2 * j]) for j in range(4)]
          + [bswap32(y[7 - 2 * j]) for j in range(4)] + [0x01])
    hi = ([bswap32(x[6 - 2 * j]) for j in range(4)]
          + [bswap32(y[6 - 2 * j]) for j in range(4)] + [0] * 8
          + [0x80000000])
    hi, lo = keccak_f1600(*_block(hi, lo, x[0]))
    return [bswap32(w) for w in (hi[1], lo[2], hi[2], lo[3], hi[3])]


def keccak256_hex40_bytes(ascii_bytes: List[torch.Tensor]) -> List[torch.Tensor]:
    """The first 20 digest bytes of Keccak-256 over a 40-byte message
    (bytes as int64 tensors): lanes 0-4 hold the message, lane 5 the 0x01
    pad, lane 16 the 0x80 pad."""
    def half(l, b0):
        v = ascii_bytes[8 * l + b0]
        for b in range(1, 4):
            v = v | (ascii_bytes[8 * l + b0 + b] << (8 * b))
        return v

    lo = [half(l, 0) for l in range(5)] + [0x01]
    hi = [half(l, 4) for l in range(5)] + [0] * 11 + [0x80000000]
    hi, lo = keccak_f1600(*_block(hi, lo, ascii_bytes[0]))
    out = []
    for d in range(20):
        lane, b = d // 8, d % 8
        word = lo[lane] if b < 4 else hi[lane]
        out.append((word >> (8 * (b % 4))) & 0xFF)
    return out
