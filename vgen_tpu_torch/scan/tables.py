"""The host-built tables the scan kernels read: the i*G table the scan adds
its window base points to, and the fixed-window t*G tables of the P2TR
tweak ladder (``ladder_table``, at any window schedule kernel F takes; the
JAX package's 8-bit ``window_table`` among them).

Both are built on the host by the port's own oracle
(``vgen_tpu_torch.crypto.secp256k1``), cached as npz files in
``build/vgen_tpu_torch/tables/`` at the repository root (gitignored), and
uploaded.  ``ig_table_limbs``, ``window_table_u32`` and ``_ints_to_limbs``
are the port's copies of ``vgen_tpu/scan/tables.py``'s host builders (16-bit
limbs, the JAX package's layout); the upload converts to the port's 32-bit
limbs.  (The JAX package built the i*G table on the TPU only because its
host link was slow.)
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.ops import fused, u256

CACHE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    "build", "vgen_tpu_torch", "tables"))


def _save_npz(path: str, **arrays) -> None:
    """np.savez through a temporary name, so a concurrent reader sees the
    whole file or none."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _ints_to_limbs(values, nlimbs: int = 16) -> np.ndarray:
    """Bulk int -> (N, nlimbs) uint16-limbs-in-uint32 conversion via bytes."""
    buf = b"".join(v.to_bytes(2 * nlimbs, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), nlimbs)
    return arr.astype(np.uint32)


def ig_table_path(count: int) -> str:
    return os.path.join(CACHE_DIR, f"torch_ig_table_{count}.npz")


def build_ig_table_limbs(count: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tx, ty): (16, count) uint32 limb arrays for [1..count]*G, built on
    the host by the oracle."""
    pts = ec.ig_table(count, start=1)
    tx = _ints_to_limbs([p[0] for p in pts]).T.copy()  # (16, count)
    ty = _ints_to_limbs([p[1] for p in pts]).T.copy()
    return tx, ty


def ig_table_limbs(count: int) -> Tuple[np.ndarray, np.ndarray]:
    """``build_ig_table_limbs``, disk-cached."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = ig_table_path(count)
    if os.path.exists(path):
        with np.load(path) as z:
            return z["tx"], z["ty"]
    tx, ty = build_ig_table_limbs(count)
    _save_npz(path, tx=tx, ty=ty)
    return tx, ty


def upload_ig_table(tx16: np.ndarray, ty16: np.ndarray, device) -> tuple:
    """The 16-bit limb arrays as (8, count) int32 32-bit limbs on
    ``device``."""
    return (u256.as_i32(u256.limbs16_to_32(tx16)).to(device),
            u256.as_i32(u256.limbs16_to_32(ty16)).to(device))


def window_table_u32(window_bits: int = 8) -> np.ndarray:
    """(32, 256, 2, 16) fixed-window table for t*G, disk-cached."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"torch_window_table_{window_bits}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["tbl"]
    tbl = ec.window_table(window_bits)
    _save_npz(path, tbl=tbl)
    return tbl


def ig_table(count: int, device) -> tuple:
    """(tx, ty): (8, count) int32 limbs of [1..count]*G on ``device``:
    32 MB at count = 524288, a few milliseconds over PCIe."""
    return upload_ig_table(*ig_table_limbs(count), device)


def window_table(device) -> torch.Tensor:
    """(32, 256, 2, 8) int32 limbs of the P2TR ladder's table on
    ``device``: entry [w, d] is the affine (x, y) of d * 2^(8w) * G, the
    d = 0 rows zero filler (a zero digit adds nothing).  512 KB: the JAX
    package's table, the 8-bit unsigned schedule of ``ladder_table``."""
    tbl16 = window_table_u32(8)  # (32, 256, 2, 16)
    tbl32 = u256.limbs16_to_32(np.moveaxis(tbl16, 3, 0))  # (8, 32, 256, 2)
    return u256.as_i32(np.moveaxis(tbl32, 0, 3)).to(device)


def ladder_table_limbs(bits: int, signed: bool,
                       refresh: bool = False) -> np.ndarray:
    """(windows, entries, 2, 8) uint32 32-bit limbs of the ladder table of
    digits of ``bits`` bits (``fused.ladder_shape``): entry [w, d] is the
    affine (x, y) of d * 2^(bits w) * G, the d = 0 rows zero filler.
    Unlike ``window_table_u32`` (the copy of the JAX package's builder,
    which floors the window count), the windows cover all 256 bits of t,
    and signed digits' carry.  Each window is one ``multiples_table`` run
    (a Jacobian add chain and one batched normalization), packed through
    bytes.  Disk-cached; ``refresh`` rebuilds and rewrites the cache."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    kind = "s" if signed else "u"
    path = os.path.join(CACHE_DIR, f"torch_ladder_table_{bits}{kind}.npz")
    if os.path.exists(path) and not refresh:
        with np.load(path) as z:
            return z["tbl"]
    windows, entries = fused.ladder_shape(bits, signed)
    tbl = np.zeros((windows, entries, 2, 8), dtype=np.uint32)
    base: ec.Point = ec.G
    for w in range(windows):
        row = ec.multiples_table(base, entries - 1)
        for c in (0, 1):
            buf = b"".join(p[c].to_bytes(32, "little") for p in row)
            tbl[w, 1:, c] = np.frombuffer(buf, dtype="<u4").reshape(-1, 8)
        for _ in range(bits):  # the next window's base, 2^bits * base
            base = ec.point_double(base)
    _save_npz(path, tbl=tbl)
    return tbl


def ladder_table(device, bits: int = fused.LADDER_WINDOW[0],
                 signed: bool = fused.LADDER_WINDOW[1]) -> torch.Tensor:
    """The ladder table of ``ladder_table_limbs`` as int32 on ``device``
    (default: the product's schedule, ``fused.LADDER_WINDOW``: 16-bit
    signed digits, 17 windows of 32769 entries, 34 MiB, which the card's
    50 MB L2 holds), uploaded once per scanner."""
    return u256.as_i32(ladder_table_limbs(bits, signed)).to(device)
