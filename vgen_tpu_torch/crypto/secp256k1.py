"""secp256k1 elliptic-curve arithmetic over Python integers.

Host-side ground truth for the device kernels (the reference delegates this
to the `bitcoin` crate, reference address.rs:4-6; its device version lives in
shaders/field.wgsl).  Also used to precompute the i*G table that the device
scan consumes, via Montgomery batch inversion so table generation stays fast.

Curve: y^2 = x^3 + 7 over F_p,
  p = 2^256 - 2^32 - 977, group order n, generator G.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7

# GLV endomorphism: phi(x, y) = (BETA*x, y) equals scalar mult by LAMBDA
# (BETA^3 = 1 mod p, LAMBDA^3 = 1 mod n; verified in tests/test_curve.py).
# Used to derive 6 candidate keys {±k, ±λk, ±λ²k} per computed point in the
# device scan -- amortizing the EC add + inversion the way VanitySearch does.
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA2 = BETA * BETA % P
LAMBDA2 = LAMBDA * LAMBDA % N


def glv_variant_keys(k: int) -> List[int]:
    """The 6 private keys whose points share {x, BETA*x, BETA2*x} with k*G.

    Variant index = 2*v + neg for v in (1, LAMBDA, LAMBDA2) powers and neg
    in (+, -); device GLV match masks must report variants in this order."""
    out = []
    for lam in (1, LAMBDA, LAMBDA2):
        kk = lam * k % N
        out.append(kk)
        out.append((N - kk) % N)
    return out


def glv_bit_variant_keys(k: int, bits: int,
                         parity_exact: bool = False) -> List[int]:
    """Candidate private keys for a device GLV variant bitmask.

    Device GLV masks set bit 2v+pi when the variant with x-coordinate
    BETA^v * x(kG) and parity index pi matched (ops/pipeline.py
    glv_interval_mask).  For Ethereum (parity_exact=True) pi indexes
    {+y, -y} directly, so bit 2v+pi resolves to exactly LAMBDA^v*k (pi=0)
    or N - LAMBDA^v*k (pi=1).  For hash160 formats pi is the
    compressed-pubkey PREFIX parity, which depends on y(kG)'s parity --
    both signs of an active v are returned and the caller's
    derive-and-match gate picks the real one (still 3x fewer host
    derivations than all 6 variants when one v is active, the common
    case).  bits <= 0 falls back to all 6 variants."""
    if bits <= 0:
        return glv_variant_keys(k)
    out = []
    for v, lam in enumerate((1, LAMBDA, LAMBDA2)):
        vb = (bits >> (2 * v)) & 3
        if not vb:
            continue
        kk = lam * k % N
        if parity_exact:
            if vb & 1:
                out.append(kk)
            if vb & 2:
                out.append((N - kk) % N)
        else:
            out.append(kk)
            out.append((N - kk) % N)
    return out


# Affine point: (x, y) tuple of ints, or None for the point at infinity.
Point = Optional[Tuple[int, int]]

G: Point = (GX, GY)


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def point_neg(pt: Point) -> Point:
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P)


def point_add(p1: Point, p2: Point) -> Point:
    """Full affine addition (handles identity, doubling, inverses)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def point_double(pt: Point) -> Point:
    return point_add(pt, pt)


def scalar_mult(k: int, pt: Point = G) -> Point:
    """k * pt via MSB-first Jacobian double-and-add (single inversion)."""
    k %= N
    if k == 0 or pt is None:
        return None
    x2, y2 = pt
    X, Y, Z = 0, 1, 0  # infinity
    for bit in bin(k)[2:]:
        X, Y, Z = jacobian_double(X, Y, Z) if Z else (X, Y, Z)
        if bit == "1":
            if Z == 0:
                X, Y, Z = x2, y2, 1
            else:
                X, Y, Z = jacobian_add_affine(X, Y, Z, x2, y2)
                if Z == 0:  # landed on infinity (P == -Q)
                    X, Y = 0, 1
    if Z == 0:
        return None
    zi = pow(Z, P - 2, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 % P * zi % P)


def pubkey_point(secret: int) -> Point:
    if not 1 <= secret < N:
        raise ValueError("secret key out of range [1, n-1]")
    return scalar_mult(secret, G)


def scalar_mult_base_fast(k: int) -> Point:
    """k*G through the native C++ code when available (~10us vs ~30ms for
    the Python ladder).  The scan loops need one base point per dispatched
    window; with pure Python this dominated whole-scan throughput.  The
    pure-Python scalar_mult above remains the conformance oracle."""
    k %= N
    if k == 0:
        return None
    try:
        from vgen_tpu_torch import native

        if native.available():
            return native.pubkey_point(k)
    except Exception:  # pragma: no cover - fall back to the oracle
        pass
    return scalar_mult(k)


def serialize_compressed(pt: Point) -> bytes:
    if pt is None:
        raise ValueError("cannot serialize point at infinity")
    x, y = pt
    prefix = b"\x03" if y & 1 else b"\x02"
    return prefix + x.to_bytes(32, "big")


def serialize_uncompressed(pt: Point) -> bytes:
    if pt is None:
        raise ValueError("cannot serialize point at infinity")
    x, y = pt
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def lift_x(x: int) -> Point:
    """BIP340 lift_x: the curve point with this x and even y, or None."""
    if x >= P:
        return None
    c = (pow(x, 3, P) + B) % P
    y = pow(c, (P + 1) // 4, P)
    if (y * y) % P != c:
        return None
    if y & 1:
        y = P - y
    return (x, y)


def xonly(pt: Point) -> Tuple[int, Point]:
    """BIP340 x-only form: (x, point-with-even-y)."""
    if pt is None:
        raise ValueError("infinity has no x-only form")
    x, y = pt
    if y & 1:
        return x, (x, P - y)
    return x, pt


def batch_inverse(values: Sequence[int]) -> List[int]:
    """Montgomery batch inversion mod p: one pow() amortized over the batch.

    Mirrors the algorithm the device uses (reference does the same per
    256-wide workgroup in shaders/search.wgsl:59-135; the device build does
    it over chunked scan chains).
    """
    n = len(values)
    if n == 0:
        return []
    prefix = [0] * n
    acc = 1
    for i, v in enumerate(values):
        if v % P == 0:
            raise ZeroDivisionError("batch_inverse of zero")
        acc = acc * v % P
        prefix[i] = acc
    inv = pow(acc, P - 2, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        if i == 0:
            out[i] = inv
        else:
            out[i] = inv * prefix[i - 1] % P
            inv = inv * values[i] % P
    return out


def jacobian_add_affine(
    X1: int, Y1: int, Z1: int, x2: int, y2: int
) -> Tuple[int, int, int]:
    """Mixed Jacobian + affine addition (no inversions).

    Assumes the points are distinct and neither is infinity (true for the
    sequential i*G chain below as long as i never wraps past n).
    """
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1 % P * Z1Z1 % P
    H = (U2 - X1) % P
    r = (S2 - Y1) % P
    if H == 0:
        if r == 0:
            return jacobian_double(X1, Y1, Z1)
        return (0, 1, 0)  # P == -Q: infinity
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (r * r - HHH - 2 * V) % P
    Y3 = (r * (V - X3) - Y1 * HHH) % P
    Z3 = Z1 * H % P
    return X3, Y3, Z3


def jacobian_double(X1: int, Y1: int, Z1: int) -> Tuple[int, int, int]:
    """Jacobian doubling for a = 0 curves (dbl-2009-l)."""
    A = X1 * X1 % P
    Bv = Y1 * Y1 % P
    C = Bv * Bv % P
    D = 2 * ((X1 + Bv) * (X1 + Bv) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y1 * Z1 % P
    return X3, Y3, Z3


def multiples_table(
    base: Point, count: int, first: Point = None
) -> List[Tuple[int, int]]:
    """Affine [first, first+base, first+2*base, ...] (count entries) via a
    Jacobian add chain + ONE Montgomery-batched normalization."""
    if count <= 0:
        return []
    if first is None:
        first = base
    assert first is not None and base is not None
    bx, by = base
    X, Y, Z = first[0], first[1], 1
    jac: List[Tuple[int, int, int]] = [(X, Y, Z)]
    for _ in range(count - 1):
        X, Y, Z = jacobian_add_affine(X, Y, Z, bx, by)
        jac.append((X, Y, Z))
    zinvs = batch_inverse([z for (_, _, z) in jac])
    out: List[Tuple[int, int]] = []
    for (Xj, Yj, _), zi in zip(jac, zinvs):
        zi2 = zi * zi % P
        out.append((Xj * zi2 % P, Yj * zi2 % P * zi % P))
    return out


def ig_table(count: int, start: int = 1) -> List[Tuple[int, int]]:
    """Affine points [start*G, (start+1)*G, ..., (start+count-1)*G].

    Host analogue of the reference's init_table kernel (shaders/init.wgsl:4-10)
    but incremental: one scalar-mult, then `count` Jacobian mixed adds and a
    single Montgomery-batched normalization instead of a scalar-mult (or a
    field inversion) per entry.
    """
    return multiples_table(G, count, first=scalar_mult(start, G))


def window_table(window_bits: int = 8) -> np.ndarray:
    """Precomputed fixed-window table for device scalar multiplication:
    shape (n_windows, 2^w, 2, 16) uint32 with entry [w, d] = affine
    (d * 2^(w*window_bits)) * G as 16-bit limbs; d=0 rows are zero filler.

    Feeds curve.scalar_mul_windowed (the on-chip taproot-tweak ladder)."""
    n_windows = 256 // window_bits
    D = 1 << window_bits
    out = np.zeros((n_windows, D, 2, 16), dtype=np.uint32)
    base: Point = G
    for w in range(n_windows):
        row = multiples_table(base, D - 1)
        for d, (x, y) in enumerate(row, start=1):
            for i in range(16):
                out[w, d, 0, i] = (x >> (16 * i)) & 0xFFFF
                out[w, d, 1, i] = (y >> (16 * i)) & 0xFFFF
        # next window base = 2^window_bits * base
        for _ in range(window_bits):
            base = point_double(base)
    return out
