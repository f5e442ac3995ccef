"""The host-built tables the scan kernels read: the i*G table the scan adds
its window base points to, and the fixed-window t*G table of the P2TR
tweak ladder.

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
from vgen_tpu_torch.ops import u256

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


def ig_table_limbs(count: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tx, ty): (16, count) uint32 limb arrays for [1..count]*G, disk-cached."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"torch_ig_table_{count}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["tx"], z["ty"]
    pts = ec.ig_table(count, start=1)
    tx = _ints_to_limbs([p[0] for p in pts]).T.copy()  # (16, count)
    ty = _ints_to_limbs([p[1] for p in pts]).T.copy()
    _save_npz(path, tx=tx, ty=ty)
    return tx, ty


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
    tx16, ty16 = ig_table_limbs(count)
    return (u256.as_i32(u256.limbs16_to_32(tx16)).to(device),
            u256.as_i32(u256.limbs16_to_32(ty16)).to(device))


def window_table(device) -> torch.Tensor:
    """(32, 256, 2, 8) int32 limbs of the P2TR ladder's table on
    ``device``: entry [w, d] is the affine (x, y) of d * 2^(8w) * G, the
    d = 0 rows zero filler (a zero digit adds nothing).  512 KB, uploaded
    once per scanner; the kernel reads it by index, so L2 holds it."""
    tbl16 = window_table_u32(8)  # (32, 256, 2, 16)
    tbl32 = u256.limbs16_to_32(np.moveaxis(tbl16, 3, 0))  # (8, 32, 256, 2)
    return u256.as_i32(np.moveaxis(tbl32, 0, 3)).to(device)
