"""One dependent chain against many on the card: kernel ``probe_rows`` and
its tool.

    python -m vgen_tpu_torch.probes.microbench_rows

The counterpart of ``scripts/microbench_rows.py`` (``make_row1d`` :46 and
its ``pallas_call`` :51, ``make_row2d`` :62/:69, ``make_full2d`` :80/:92,
each with ``mul`` False or True), which asked whether a dependent chain of
row ops ran at the TPU's issue rate.  Every lane holds its 16 input words
x_i (row i of a (16, lanes) array) in registers, one thread per lane, and
runs the script's chain of steps r = (r + x) ^ rotl(r, 7), with r = r x + 1
at every fourth step when ``mul``:

- ``row1d``: one chain r = x_0 of ``steps`` steps, step i with x_(i mod
  16), over 1-D blocks (1024 threads at the script's size) -> (1, lanes);
- ``row2d``: the same chain over (128, threads / 128) blocks, the card's
  counterpart of the TPU's (R, 128) rows -> (1, lanes);
- ``full2d``: 16 independent chains r_c = x_c of steps / 16 steps each,
  with x_c -> (16, lanes).

Chain length, lane count and threads per block are launch arguments.  The
tool runs the script's sizes (8192 steps, 1024 x 128 lanes, input
``arange``), then a lane sweep that runs the one chain at 1, 4 and 16
warps per scheduler (and 524288 lanes), printing lane-steps per second,
the SM clocks each step of one chain takes, and the opcode counts of the
kernel's loop from ``cuobjdump -sass``.  It measures the card only:
without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vgen_tpu_torch.ops import u256
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, timing

# shape: template code of geometry_lanes.cuh RowShape
SHAPES = {"row1d": 0, "row2d": 1, "full2d": 2}
MULS = (False, True)
CH_LEN, LANES, GRID = 8192, 1024, 128  # the script's sizes
THREADS = 1024  # the script's 1024-lane rows as one block
UNROLL = 64  # steps per loop iteration (geometry_lanes.cuh kRowUnroll)


def instances():
    return [(shape, mul) for shape in SHAPES for mul in MULS]


def instance_name(shape: str, mul: bool) -> str:
    return shape + ("_mul" if mul else "")


def rows_inputs(lanes: int) -> torch.Tensor:
    """The script's input: arange(16 lanes) as a (16, lanes) int32
    array."""
    return u256.as_i32(np.arange(16 * lanes, dtype=np.uint32)
                       .reshape(16, lanes))


def rows_count(mul: bool, steps: int):
    """The bound model's count of one lane's ``steps`` steps (a quarter of
    them multiplies when ``mul``)."""
    if mul:
        return steps // 4 * bm.ROW_MUL_STEP + (steps - steps // 4) * bm.ROW_STEP
    return steps * bm.ROW_STEP


def _step(r, x, mul):
    if mul:
        return (common.mul_lo32(r, x) + 1) & common.M32
    rot = ((r << 7) & common.M32) | (r >> 25)
    return ((r + x) & common.M32) ^ rot


def probe_rows_plain(shape, mul, x, steps):
    """Plain version of ``probe_rows``: x (16, lanes) int32 -> (1, lanes)
    int32, or (16, lanes) for full2d."""
    x64 = u256.to_i64(x)
    if shape == "full2d":
        r = x64
        for j in range(steps // 16):
            r = _step(r, x64, mul and j % 4 == 0)
        return u256.to_i32(r)
    r = x64[0]
    for i in range(steps):
        r = _step(r, x64[i % 16], mul and i % 4 == 0)
    return u256.to_i32(r[None])


def probe_rows(shape, mul, x, steps, threads=THREADS):
    """Kernel ``probe_rows`` (``probes/probes.cu``), one launch of blocks of
    ``threads`` threads; steps a multiple of 64.  The plain version for a
    CPU tensor."""
    if shape not in SHAPES or mul not in MULS:
        raise ValueError(f"unknown instance {shape!r} mul={mul!r}")
    if steps % UNROLL or steps < 0:
        raise ValueError(f"probe_rows: steps = {steps}, a multiple of "
                         f"{UNROLL} is required")
    if x.device.type == "cpu":
        return probe_rows_plain(shape, mul, x, steps)
    lanes = x.shape[1] if x.dim() == 2 else 0
    if (x.device.type != "cuda" or x.dtype != torch.int32
            or x.shape != (16, lanes) or lanes == 0 or not x.is_contiguous()):
        raise ValueError(f"probe_rows: expected a contiguous (16, lanes) int32 "
                         f"CUDA tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    if threads % 128 or not 128 <= threads <= THREADS:
        raise ValueError(f"probe_rows: {threads} threads per block (a "
                         f"multiple of 128 up to {THREADS})")
    out = torch.empty((16 if shape == "full2d" else 1, lanes),
                      dtype=torch.int32, device=x.device)
    common.launch("probe_rows", x.device, SHAPES[shape], int(mul),
                  x.data_ptr(), out.data_ptr(), lanes, steps, threads)
    probe_rows.launches += 1
    return out


probe_rows.launches = 0


def blocks_per_sm(shape, mul, threads) -> int:
    """Blocks of ``threads`` threads of the instance one SM holds at once
    (the card only)."""
    from vgen_tpu_torch.csrc import build

    n = build.load("probes").vgen_probe_rows_blocks_per_sm(
        SHAPES[shape], int(mul), threads)
    if n <= 0:
        raise RuntimeError(f"occupancy query failed, cudaError {-n}")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.microbench_rows",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    from vgen_tpu_torch.csrc import build

    tag, sms = card.tag(), card.sm_count
    probe_rows("row1d", False, rows_inputs(128).to(card.device), UNROLL)
    loops = timing.kernel_loops(str(build.library_path("probes")),
                                "probe_rows")
    mhz = card.sm_clocks_per_s / sms / 1e6
    # (threads per block, lanes): the script's size, then 1, 4 and 16 warps
    # per scheduler (one block of 128 or 512 threads per SM, two of 1024:
    # full2d holds one), then 524288 lanes
    sizes = [(THREADS, LANES * GRID), (128, sms * 128), (512, sms * 512),
             (THREADS, sms * 2 * THREADS), (THREADS, common.TIMED_N)]
    print(f"# microbench_rows: probe_rows, {CH_LEN} steps per lane (full2d: "
          f"16 chains of {CH_LEN // 16}); ms per launch, best of five means "
          f"of 10; clocks at the maximum SM clock, {mhz:.0f} MHz {tag}",
          flush=True)
    for threads, lanes in sizes:
        x = rows_inputs(lanes).to(card.device)
        for shape, mul in instances():
            name = instance_name(shape, mul)
            ms = timing.launch_ms(
                lambda: probe_rows(shape, mul, x, CH_LEN, threads))
            occupancy = blocks_per_sm(shape, mul, threads)
            # blocks on an SM at once, on average over the SMs
            resident = min(occupancy, -(-lanes // threads) / sms)
            warps = resident * threads / 32 / 4
            waves = lanes / (occupancy * threads * sms)
            bms, bby = bm.bound(lanes * rows_count(mul, CH_LEN),
                                (16 + (16 if shape == "full2d" else 1)) * 4
                                * lanes, card.sm_clocks_per_s)
            # with every lane in flight at once, the time is one chain's
            chain = CH_LEN // 16 if shape == "full2d" else CH_LEN
            per_step = (f"{ms * 1e-3 * mhz * 1e6 / chain:.2f} clocks per step "
                        "of a chain" if waves <= 1 else "more than one wave")
            sass = timing.opcode_text(
                loops.get((SHAPES[shape], int(mul)), {}), UNROLL)
            print(f"{name} lanes={lanes} threads={threads}: {ms:.4f} ms, "
                  f"{CH_LEN * lanes / ms / 1e6:.1f} G lane-steps/s, "
                  f"{CH_LEN * lanes / (ms * 1e-3 * card.sm_clocks_per_s):.2f} "
                  f"per SM per clock; {warps:.2f} warps per scheduler, "
                  f"{waves:.2f} waves; {per_step}; bound {bms:.4f} ms "
                  f"({bby}, share {bms / ms:.2f}); SASS per step: {sass} "
                  f"{tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
