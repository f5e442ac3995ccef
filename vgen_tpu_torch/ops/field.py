"""secp256k1 base field F_p: plain PyTorch versions of ``csrc/field.cuh``.

p = 2^256 - 2^32 - 977, so 2^256 = 2^32 + 977 (mod p): a 512-bit product
folds its high half back with one multiply by 977 and one 32-bit shift,
as ``vgen_tpu/native/src/field.h`` does with 64-bit limbs.

Values are (8, *S) int64 tensors of 32-bit limbs (``u256``), canonical
(< p) at every function boundary.  These are the reference the CUDA
kernels are checked against on the card and what a wrapper runs for CPU
tensors; the scan's hot path on the card never calls them.
"""

from __future__ import annotations

import torch

from vgen_tpu_torch.crypto.secp256k1 import N as N_INT
from vgen_tpu_torch.crypto.secp256k1 import P as P_INT
from vgen_tpu_torch.ops import u256
from vgen_tpu_torch.ops.u256 import MASK32, NLIMBS

__all__ = ["P_INT", "N_INT", "normalize", "add", "sub", "neg", "mul_small",
           "mul", "square", "inv", "batch_inverse_chain"]

_C = 977


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Reduce a value < 2^256 (< 2p) to [0, p): a >= p exactly when
    a + (2^32 + 977) carries out of 2^256, and then that sum is a - p."""
    t, carry = u256.add(a, u256.constant((1 << 32) + _C, a))
    return u256.select(carry == 1, t, a)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical a, b."""
    d, borrow = u256.sub(a, b)
    # on borrow d = a - b + 2^256; adding p is subtracting 2^32 + 977
    d2, _ = u256.sub(d, u256.constant((1 << 32) + _C, d))
    return u256.select(borrow == 1, d2, d)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical a, b: a carry out of 2^256 is worth
    2^32 + 977, and the folded sum is < 2p."""
    s, carry = u256.add(a, b)
    s2, _ = u256.add(s, u256.constant((1 << 32) + _C, s))
    # carry set: the true sum s + 2^256 - p = s + 2^32 + 977 < p
    return normalize(u256.select(carry == 1, s2, s))


def neg(a: torch.Tensor) -> torch.Tensor:
    """-a mod p, canonical (-0 = 0), so ``neg(y)[0] & 1`` is the parity."""
    d, _ = u256.sub(u256.constant(P_INT, a), a)
    return u256.select(u256.is_zero(a), a, d)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k mod p for a small constant 0 <= k < 2^16."""
    cols = [a[i] * k for i in range(NLIMBS)]
    r, top = _carry(cols, 32)  # top < 2^16
    # fold: top * 2^256 = top * (2^32 + 977); the result is < 2^256 + p,
    # and one more fold of a carry leaves a value < 2p
    r[0] = r[0] + top * _C
    r[1] = r[1] + top
    r, c = _carry(r, 32)
    r[0] = r[0] + c * _C
    r[1] = r[1] + c
    r, _ = _carry(r, 32)
    return normalize(torch.stack(r))


def _carry(cols, bits: int):
    """Propagate carries through a list of non-negative int64 columns into
    ``bits``-bit limbs; returns (limbs, carry out)."""
    mask = (1 << bits) - 1
    out = []
    carry = torch.zeros_like(cols[0])
    for c in cols:
        v = c + carry
        out.append(v & mask)
        carry = v >> bits
    return out, carry


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p, canonical.  Products are formed on 16-bit halves so no
    intermediate reaches 2^63."""
    a, b = torch.broadcast_tensors(a, b)
    a16 = u256.limbs32_to_16(a)
    b16 = u256.limbs32_to_16(b)
    # schoolbook columns: 16 products of < 2^32 each -> < 2^36
    cols = torch.zeros((31,) + tuple(a.shape[1:]), dtype=torch.int64,
                       device=a.device)
    for i in range(16):
        cols[i:i + 16] += a16[i] * b16
    # fold 1: column 16+j is worth 2^(16j) * (2^32 + 977)
    lo = torch.cat([cols[:16], torch.zeros_like(cols[:1])])
    hi = cols[16:]
    lo[0:15] += hi * _C
    lo[2:17] += hi
    limbs16, carry = _carry(list(lo), 16)  # 17 limbs + carry: < 2^289
    top = limbs16[16] + (carry << 16)  # bits 256.. as one int64, < 2^33
    low = torch.stack([limbs16[2 * i] | (limbs16[2 * i + 1] << 16)
                       for i in range(NLIMBS)])
    # fold 2: top * (2^32 + 977) into the 32-bit limbs
    t977 = top * _C
    cols32 = list(low)
    cols32[0] = cols32[0] + (t977 & MASK32)
    cols32[1] = cols32[1] + (t977 >> 32) + (top & MASK32)
    cols32[2] = cols32[2] + (top >> 32)
    r, c2 = _carry(cols32, 32)
    # fold 3: c2 in {0, 1}; when set the low part is tiny, so it cannot carry
    r[0] = r[0] + c2 * _C
    r[1] = r[1] + c2
    r, _ = _carry(r, 32)
    return normalize(torch.stack(r))


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def _sqn(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = square(x)
    return x


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) by the secp256k1 addition chain of ``vgen_tpu/ops/field.py``
    ``inv``: 255 squarings and 15 multiplies.  inv(0) = 0."""
    x1 = a
    x2 = mul(_sqn(x1, 1), x1)
    x3 = mul(_sqn(x2, 1), x1)
    x6 = mul(_sqn(x3, 3), x3)
    x9 = mul(_sqn(x6, 3), x3)
    x11 = mul(_sqn(x9, 2), x2)
    x22 = mul(_sqn(x11, 11), x11)
    x44 = mul(_sqn(x22, 22), x22)
    x88 = mul(_sqn(x44, 44), x44)
    x176 = mul(_sqn(x88, 88), x88)
    x220 = mul(_sqn(x176, 44), x44)
    x223 = mul(_sqn(x220, 3), x3)
    t = mul(_sqn(x223, 23), x22)
    t = mul(_sqn(t, 5), x1)
    t = mul(_sqn(t, 3), x2)
    return mul(_sqn(t, 2), x1)


def batch_inverse_chain(values: torch.Tensor) -> torch.Tensor:
    """Montgomery batch inversion along axis 1 of an (8, C, *rest) tensor:
    C dependent multiplies forward, one ``inv`` of the totals, 2C back.
    Inputs must be nonzero; outputs are canonical, so any chain geometry
    gives the same result."""
    C = values.shape[1]
    one = u256.constant(1, values[:, 0])
    prefix = []  # exclusive prefix products
    acc = one.expand_as(values[:, 0])
    for c in range(C):
        prefix.append(acc)
        acc = mul(acc, values[:, c])
    acc = inv(acc)
    out = torch.empty_like(values)
    for c in range(C - 1, -1, -1):
        out[:, c] = mul(acc, prefix[c])
        acc = mul(acc, values[:, c])
    return out
