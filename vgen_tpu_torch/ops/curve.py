"""Affine point addition with a precomputed inverse (plain PyTorch).

The scan adds one base point B = k*G to every table point T[i] = i*G and
shares one batch inversion of dx = tx - bx across the batch
(``fused.batch_inverse_dx``).  On the card ``csrc/scan_lanes.cuh``
``lane_add`` does both finishes: x only (kernels B and E) and x and y
(kernels C and D).  The P2TR tweak ladder (kernel F,
``csrc/p2tr_lanes.cuh``) accumulates with ``jacobian_add_affine_lean``,
and doubles with ``affine_double`` where an add meets its own point.
"""

from __future__ import annotations

from vgen_tpu_torch.ops import field, u256


def affine_add_batch(bx, by, tx, ty, inv_dx):
    """P = B + T given inv_dx = 1/(tx - bx); all (8, *S) int64 limbs.
    The caller masks lanes where tx == bx."""
    lam = field.mul(field.sub(ty, by), inv_dx)
    x3 = field.sub(field.sub(field.square(lam), bx), tx)
    y3 = field.sub(field.mul(lam, field.sub(bx, x3)), by)
    return x3, y3


def ec_finish_x(bx, by, tx, ty, inv_dx):
    """x-coordinate of B + T only, and the validity mask dx != 0 (the
    counterpart of ``vgen_tpu/ops/pallas_fused.py`` ``_ec_finish_x``).
    Enough for the compressed-hash160 GLV formats: the y parity is never
    needed because both prefixes are hashed."""
    valid = ~u256.is_zero(field.sub(tx, bx))
    lam = field.mul(field.sub(ty, by), inv_dx)
    x3 = field.sub(field.sub(field.square(lam), bx), tx)
    return x3, valid


def ec_finish(bx, by, tx, ty, inv_dx):
    """(x3, y3, valid) of B + T with both coordinates canonical (< p), so
    y3's parity is the compressed key's prefix (the counterpart of
    ``vgen_tpu/ops/pallas_fused.py`` ``_ec_finish``).  valid: dx != 0."""
    valid = ~u256.is_zero(field.sub(tx, bx))
    x3, y3 = affine_add_batch(bx, by, tx, ty, inv_dx)
    return x3, y3, valid


def jacobian_add_affine_lean(X1, Y1, Z1, x2, y2):
    """Mixed add of a Jacobian (X1, Y1, Z1) and an affine (x2, y2) without
    the doubling and infinity fallbacks: 8M + 3S.  Returns (X3, Y3, Z3, ok)
    with ok False where H == 0 (P == +-Q, which would need a doubling or
    gives infinity); the caller masks those lanes (the counterpart of
    ``vgen_tpu/ops/curve.py`` ``jacobian_add_affine_lean``)."""
    Z1Z1 = field.square(Z1)
    U2 = field.mul(x2, Z1Z1)
    S2 = field.mul(field.mul(y2, Z1), Z1Z1)
    H = field.sub(U2, X1)
    r = field.sub(S2, Y1)
    ok = ~u256.is_zero(H)
    HH = field.square(H)
    HHH = field.mul(H, HH)
    V = field.mul(X1, HH)
    X3 = field.sub(field.sub(field.square(r), HHH), field.mul_small(V, 2))
    Y3 = field.sub(field.mul(r, field.sub(V, X3)), field.mul(Y1, HHH))
    Z3 = field.mul(Z1, H)
    return X3, Y3, Z3, ok


def affine_double(x, y):
    """2 (x, y) in Jacobian coordinates from an affine point (dbl-2009-l
    with Z1 = 1: 1M + 4S): (X3, Y3, Z3) with Z3 = 2y."""
    A = field.square(x)
    Bv = field.square(y)
    C = field.square(Bv)
    D = field.mul_small(field.sub(field.sub(field.square(field.add(x, Bv)), A),
                                  C), 2)
    E = field.mul_small(A, 3)
    X3 = field.sub(field.square(E), field.mul_small(D, 2))
    Y3 = field.sub(field.mul(E, field.sub(D, X3)), field.mul_small(C, 8))
    return X3, Y3, field.mul_small(y, 2)
