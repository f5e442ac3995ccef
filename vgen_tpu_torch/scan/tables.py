"""The tables the scan kernels read: the i*G table the scan adds its window
base points to, and the fixed-window t*G tables of the P2TR tweak ladder
(``ladder_table``, at any window schedule kernel F takes; the JAX package's
8-bit ``window_table`` among them).

On a card both are built there (``build_multiples``), as the JAX package
builds its i*G table on the accelerator (``vgen_tpu/scan/tables.py``
``ig_table_arrays``, ``ig_table_jax``): rows of multiples [1..count] P_r of
affine base points by log-doubling, kernel T1 (``fused.table_grow``; step s
adds the host's 2^s P_r to the columns built so far, in Jacobian
coordinates), one batch inversion of Z (kernel G) and the affine pass T2
(``fused.table_affine``) into the consumer's layout.  Only about 20 points a
row cross from the host, the build takes milliseconds, and nothing is
cached on disk.  The ladder table (17 rows of 2^(16w) G at the product's
schedule) takes the same kernels; the JAX package builds its 8-bit one on
the host.

On the CPU the host builders by the port's own oracle
(``vgen_tpu_torch.crypto.secp256k1``) stay the path, cached as npz files in
``build/vgen_tpu_torch/tables/`` at the repository root (gitignored), and
are the oracle the card's build is held to.  ``ig_table_limbs``,
``window_table_u32`` and ``_ints_to_limbs`` are the port's copies of
``vgen_tpu/scan/tables.py``'s host builders (16-bit limbs, the JAX package's
layout); the upload converts to the port's 32-bit limbs.
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


def _doubling_chain(pt: ec.Point, n: int) -> list:
    """The affine [2^0 pt, ..., 2^(n-1) pt]: Jacobian doublings and one
    batch inversion."""
    jac = [(pt[0], pt[1], 1)]
    for _ in range(n - 1):
        jac.append(ec.jacobian_double(*jac[-1]))
    out = []
    for (X, Y, _), zi in zip(jac, ec.batch_inverse([j[2] for j in jac])):
        zi2 = zi * zi % ec.P
        out.append((X * zi2 % ec.P, Y * zi2 % ec.P * zi % ec.P))
    return out


def _point_limbs(rows) -> np.ndarray:
    """Rows of equally many affine points -> (R, n, 2, 8) uint32 limbs."""
    buf = b"".join(c.to_bytes(32, "little") for row in rows for p in row
                   for c in p)
    return np.frombuffer(buf, dtype="<u4").reshape(len(rows), -1, 2, 8).copy()


def _on_card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev}: no CUDA device is visible")
    return dev


def build_multiples(bases, count: int, device, ladder: bool = False):
    """The rows [1..count] P_r of the affine base points ``bases`` (R of
    them), built on ``device``: kernel T1's log-doubling steps from the
    host's 2^s P_r (s < ``fused.table_steps(count)``, uploaded once), kernel
    G on Z (``fused.TABLE_INV_GEOMETRY``), kernel T2.  -> ladder False:
    (tx, ty) (8, count) int32 (one row); ladder True: the ladder layout (R,
    count + 1, 2, 8) int32, entry [r][d] = d P_r, the d = 0 rows zero.  On
    the CPU the kernels' plain versions run: only the tests take that path.
    A lane that meets the point at infinity raises."""
    dev = _on_card(device)
    steps = fused.table_steps(count)
    b = u256.as_i32(_point_limbs([_doubling_chain(p, steps)
                                  for p in bases])).to(dev)
    X, Y, Z = fused.table_grow(b, count)
    zi = fused.batch_inverse_chain(Z, *fused.TABLE_INV_GEOMETRY)
    return fused.table_affine(X, Y, zi, len(bases), ladder)


def ig_table(count: int, device) -> tuple:
    """(tx, ty): (8, count) int32 limbs of [1..count]*G on ``device`` by
    the cheapest route (the counterpart of ``vgen_tpu/scan/tables.py``
    ``ig_table_arrays``): built on a card by ``build_multiples`` (the
    counterpart of ``ig_table_jax``), about 20 points uploaded and no npz
    read or written; on the CPU the host build, npz-cached
    (``ig_table_limbs``)."""
    dev = _on_card(device)
    if dev.type != "cpu":
        return build_multiples([ec.G], count, dev)
    return upload_ig_table(*ig_table_limbs(count), dev)


def window_table(device) -> torch.Tensor:
    """(32, 256, 2, 8) int32 limbs of the P2TR ladder's table on
    ``device``: entry [w, d] is the affine (x, y) of d * 2^(8w) * G, the
    d = 0 rows zero filler (a zero digit adds nothing).  512 KB: the JAX
    package's table, the 8-bit unsigned schedule of ``ladder_table``."""
    tbl16 = window_table_u32(8)  # (32, 256, 2, 16)
    tbl32 = u256.limbs16_to_32(np.moveaxis(tbl16, 3, 0))  # (8, 32, 256, 2)
    return u256.as_i32(np.moveaxis(tbl32, 0, 3)).to(device)


def ladder_table_path(bits: int, signed: bool) -> str:
    kind = "s" if signed else "u"
    return os.path.join(CACHE_DIR, f"torch_ladder_table_{bits}{kind}.npz")


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
    path = ladder_table_path(bits, signed)
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


def ladder_bases(bits: int, signed: bool) -> list:
    """The affine window bases 2^(bits w) G of the ladder table of digits
    of ``bits`` bits, one per window, from one doubling chain of G."""
    windows = fused.ladder_shape(bits, signed)[0]
    return _doubling_chain(ec.G, bits * (windows - 1) + 1)[::bits]


def ladder_table(device, bits: int = fused.LADDER_WINDOW[0],
                 signed: bool = fused.LADDER_WINDOW[1]) -> torch.Tensor:
    """The ladder table of ``ladder_table_limbs`` as int32 on ``device``
    (default: the product's schedule, ``fused.LADDER_WINDOW``: 16-bit
    signed digits, 17 windows of 32769 entries, 34 MiB, which the card's
    50 MB L2 holds), once per scanner.  On a card it is built there by
    ``build_multiples``, one row per window of base 2^(bits w) G (doubled
    on the host), and no npz is read or written; on the CPU it is
    ``ladder_table_limbs``."""
    dev = _on_card(device)
    if dev.type == "cpu":
        return u256.as_i32(ladder_table_limbs(bits, signed))
    entries = fused.ladder_shape(bits, signed)[1]
    return build_multiples(ladder_bases(bits, signed), entries - 1, dev,
                           ladder=True)
