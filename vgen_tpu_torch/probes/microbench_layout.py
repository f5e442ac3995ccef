"""Whether the limb layout in global memory matters on the card: kernel
``probe_layout`` and its tool.

    python -m vgen_tpu_torch.probes.microbench_layout

The counterpart of ``scripts/microbench_layout.py`` (its ``make(mode)``
:60, ``pallas_call`` :75), which laid the batch of a (16, B) array of
16-bit limbs out as (1024,), (8, 128), (16, 128) or (32, 32) tiles and
ran R chained ``field.mul_weak(a, b) & 0xFFFF``, then ``b ^= a``.  On the
card the batch's shape is the layout of the same (8, B) 32-bit limbs in
global memory, read and written once per lane:

- ``limb_major``: (8, B), limb l of lane e at l B + e, the layout of every
  kernel A to I;
- ``lane_major``: (B, 8), a lane's limbs side by side, loaded and stored
  as two 16-byte vectors;
- ``tile32``, ``tile128``: (B / W, 8, W) tiles of W = 32 or 128 lanes.

Each lane runs R repetitions of a = a * b mod p (``fe_mul``), b ^= a, and
stores a in its input's layout (``from_layout`` converts it back).  The
script's ``& 0xFFFF`` acts on 16-bit limbs that ``mul_weak`` has already
normalised, so it is the identity, and the card drops it.  The tool runs
B = 2^20 lanes of the script's inputs at R = 1, 2 and 8 (at R = 1 the 96
bytes a lane moves weigh the most against one multiply), each layout's
output checked equal to the limb-major one's.  It measures the card only:
without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vgen_tpu_torch.ops import field, u256
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, timing

# layout: template code of geometry_lanes.cuh Layout
LAYOUTS = {"limb_major": 0, "lane_major": 1, "tile32": 2, "tile128": 3}
TILE = {"tile32": 32, "tile128": 128}
LANES = 1 << 20  # the script's B
REPS = (1, 2, 8)  # the tool's R; the script's default is 8
R = 8
BYTES_PER_LANE = 3 * 32  # a and b read, a written


def layout_shape(layout: str, n: int):
    if layout == "limb_major":
        return (8, n)
    if layout == "lane_major":
        return (n, 8)
    return (n // TILE[layout], 8, TILE[layout])


def to_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """(8, n) limbs -> the same values in ``layout`` (contiguous)."""
    n = t.shape[1]
    if layout == "limb_major":
        return t.contiguous()
    if layout == "lane_major":
        return t.T.contiguous()
    w = TILE[layout]
    return t.reshape(8, n // w, w).permute(1, 0, 2).contiguous()


def from_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """The inverse of ``to_layout``: -> (8, n)."""
    if layout == "limb_major":
        return t
    if layout == "lane_major":
        return t.T.contiguous()
    return t.permute(1, 0, 2).reshape(8, -1).contiguous()


def layout_inputs(n: int, seed: int = 7):
    """The script's inputs (``microbench_layout.py`` :85-87): a, b (8, n)
    int32 from random 16-bit limbs."""
    rng = np.random.default_rng(seed)
    return tuple(u256.as_i32(u256.limbs16_to_32(
        rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)))
        for _ in range(2))


def layout_count(reps: int):
    """The bound model's count of one lane: R multiplies and R 8-limb
    XORs."""
    return reps * (bm.FE_MUL + bm.ops(0, 8, 8))


def probe_layout_plain(layout, a, b, reps):
    """Plain version of ``probe_layout``: a, b in ``layout`` (int32) -> a
    after R repetitions of a = a * b mod p, b ^= a, in the same layout."""
    a64 = u256.to_i64(from_layout(a, layout))
    b64 = u256.to_i64(from_layout(b, layout))
    for _ in range(reps):
        a64 = field.mul(a64, b64)
        b64 = b64 ^ a64
    return to_layout(u256.to_i32(a64), layout)


def probe_layout(layout, a, b, reps):
    """Kernel ``probe_layout`` (``probes/probes.cu``), one launch; n a
    multiple of 128.  The plain version for CPU tensors."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return probe_layout_plain(layout, a, b, reps)
    n = a.numel() // 8
    dev = a.device
    for t in (a, b):
        if (t.device != dev or t.device.type != "cuda"
                or t.dtype != torch.int32 or not t.is_contiguous()
                or tuple(t.shape) != layout_shape(layout, n)):
            raise ValueError(f"probe_layout: expected contiguous int32 CUDA "
                             f"tensors of shape {layout_shape(layout, n)} on "
                             f"one device, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if n == 0 or n % 128 or reps < 0:
        raise ValueError(f"probe_layout: n = {n} (a multiple of 128), reps = "
                         f"{reps}")
    out = torch.empty_like(a)
    common.launch("probe_layout", dev, LAYOUTS[layout], a.data_ptr(),
                  b.data_ptr(), out.data_ptr(), n, reps)
    probe_layout.launches += 1
    return out


probe_layout.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.microbench_layout",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    n, tag = LANES, card.tag()
    a, b = (t.to(card.device) for t in layout_inputs(n))
    operands = {lay: (to_layout(a, lay), to_layout(b, lay)) for lay in LAYOUTS}
    print(f"# microbench_layout: probe_layout at B={n} lanes, R chained "
          f"fe_mul, b ^= a; ms per launch, best of five means of 10 {tag}",
          flush=True)
    for reps in REPS:
        ref = probe_layout("limb_major", a, b, reps)
        bms, bby = bm.bound(n * layout_count(reps), BYTES_PER_LANE * n,
                            card.sm_clocks_per_s)
        for lay, (la, lb) in operands.items():
            out = probe_layout(lay, la, lb, reps)
            if not torch.equal(from_layout(out, lay), ref):
                print(f"error: {lay} at R={reps} differs from limb_major",
                      file=sys.stderr)
                return 1
            ms = timing.launch_ms(lambda: probe_layout(lay, la, lb, reps))
            print(f"{lay} R={reps}: {ms:.4f} ms, {ms * 1e6 / n / reps:.4f} ns "
                  f"per lane and multiply, {BYTES_PER_LANE * n / ms / 1e6:.1f} "
                  f"GB/s moved; bound {bms:.4f} ms ({bby}, share "
                  f"{bms / ms:.2f}); output == limb_major's {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
