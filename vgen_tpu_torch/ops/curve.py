"""Affine point addition with a precomputed inverse (plain PyTorch).

The scan adds one base point B = k*G to every table point T[i] = i*G and
shares one batch inversion of dx = tx - bx across the batch
(``fused.batch_inverse_dx``).  On the card ``csrc/scan_lanes.cuh``
``lane_add`` does both finishes: x only (kernels B and E) and x and y
(kernels C and D).
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
