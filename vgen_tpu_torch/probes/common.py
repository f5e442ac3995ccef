"""What the probe kernels share: their inputs, the plain versions' fold
and 32-bit multiply, and the wrappers' checks and launch.

A probe's inputs are a, b: (8, N) int32 limb-major arrays of field
elements below p (the layout of kernels A to I), made from a numpy seed.
The plain versions compute on int64 tensors of 32-bit values, on the CPU
or the card; only the tests and ``chip_smoke.py`` call them.  A wrapper
runs its plain version for CPU tensors; for CUDA tensors it launches its
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from vgen_tpu_torch.crypto.secp256k1 import P
from vgen_tpu_torch.ops import field, u256

M32 = 0xFFFFFFFF
TIMED_N = 524_288  # lanes of a timed launch: one window of the scan


def inputs(n: int, seed: int):
    """(a, b): two (8, n) int32 tensors of random field elements."""
    rng = np.random.default_rng(seed)

    def elements():
        limbs = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
        limbs[7] %= (P >> 224)  # below 2^256 - 2^224 < p
        return u256.as_i32(limbs.astype(np.uint32))

    return elements(), elements()


def mul_lo32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of x * y for 32-bit values in int64 tensors."""
    xl, xh = x & 0xFFFF, x >> 16
    return (xl * y + (((xh * y) & 0xFFFF) << 16)) & M32


def mul_hi32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The high 32 bits of x * y for 32-bit values in int64 tensors."""
    xl, xh = x & 0xFFFF, x >> 16
    return (xh * y + ((xl * y) >> 16)) >> 16


def feedback(a: torch.Tensor, b: torch.Tensor, out):
    """The fold of ``probe_lanes.cuh`` ``feedback``: a[j mod 8] ^= out[j mod
    n] for j < max(8, n), b ^= a, both reduced below p -> (a, b).  ``out``
    is a list of n (N,) int64 words."""
    n = len(out)
    rows = [a[i] for i in range(8)]
    for j in range(max(8, n)):
        rows[j % 8] = rows[j % 8] ^ out[j % n]
    a = field.normalize(torch.stack(rows))
    return a, field.normalize(b ^ a)


def check_cuda(name: str, tensors, n: int, reps: int, multiple: int = 1):
    """All (8, n) contiguous int32 CUDA tensors on one device, n > 0 and
    reps >= 0 a multiple of ``multiple`` -> the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors on {t.device} and {dev} "
                             "(all CUDA, or all CPU for the plain version)")
        if t.dtype != torch.int32 or t.shape != (8, n) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous (8, {n}) int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if n <= 0 or reps < 0 or reps % multiple:
        raise ValueError(f"{name}: n = {n}, reps = {reps} (a multiple of "
                         f"{multiple} is required)")
    return dev


def launch(entry: str, dev: torch.device, *args) -> None:
    """Call vgen_<entry> of the probe library on the current stream of
    ``dev`` (ints and data pointers, the stream appended)."""
    from vgen_tpu_torch.csrc import build

    lib = build.load("probes")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"vgen_{entry}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed, cudaError {rc}")


def launch_interval(entry: str, codes, args) -> torch.Tensor:
    """Launch vgen_<entry>, a kernel with kernel B's contract (bx, by, tx,
    ty, inv, lo, hi, remaining: ``fused.range_glv_match``), after its
    instance's template ``codes`` -> the (K, B) int32 mask."""
    from vgen_tpu_torch.ops import fused

    bx, tx, lo, remaining = args[0], args[2], args[5], args[7]
    K, B = bx.shape[0], tx.shape[1]
    dev = fused._interval_specs(entry, *args)
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    launch(entry, dev, *codes, *(t.data_ptr() for t in args[:7]),
           lo.shape[0], remaining.data_ptr(), out.data_ptr(), K, B)
    return out
