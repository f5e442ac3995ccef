"""secp256k1 on Python integers: the curve and scalar multiplication.

Written from SEC 2 (v2, section 2.4.1); it shares no code with the
program under test.
"""

from __future__ import annotations

from typing import Optional, Tuple

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

Affine = Tuple[int, int]
# Jacobian (X, Y, Z) stands for (X / Z^2, Y / Z^3); Z == 0 is infinity
Jacobian = Tuple[int, int, int]
INFINITY: Jacobian = (1, 1, 0)


def _double(p: Jacobian) -> Jacobian:
    x, y, z = p
    if z == 0 or y == 0:
        return INFINITY
    yy = y * y % P
    s = 4 * x * yy % P
    m = 3 * x * x % P  # a = 0
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * yy * yy) % P
    return x3, y3, 2 * y * z % P


def _add_affine(p: Jacobian, q: Affine) -> Jacobian:
    """p + q for a Jacobian p and an affine q."""
    x1, y1, z1 = p
    if z1 == 0:
        return q[0], q[1], 1
    zz = z1 * z1 % P
    u2 = q[0] * zz % P
    s2 = q[1] * zz * z1 % P
    h = (u2 - x1) % P
    r = (s2 - y1) % P
    if h == 0:
        return _double(p) if r == 0 else INFINITY
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - y1 * hhh) % P
    return x3, y3, z1 * h % P


def to_affine(p: Jacobian) -> Optional[Affine]:
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return x * zi2 % P, y * zi2 * zi % P


def add(p: Affine, q: Affine) -> Optional[Affine]:
    """p + q of two affine points; None for the point at infinity."""
    return to_affine(_add_affine((p[0], p[1], 1), q))


def multiply(k: int) -> Affine:
    """k * G for 1 <= k < N, by double-and-add from the top bit."""
    if not 1 <= k < N:
        raise ValueError("scalar out of range")
    acc = INFINITY
    for bit in bin(k)[2:]:
        acc = _double(acc)
        if bit == "1":
            acc = _add_affine(acc, (GX, GY))
    return to_affine(acc)


def compressed(pt: Affine) -> bytes:
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")
