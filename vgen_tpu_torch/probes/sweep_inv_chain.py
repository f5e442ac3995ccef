"""Kernels A and G's batch-inversion geometry, swept on the card.

    python -m vgen_tpu_torch.probes.sweep_inv_chain

The counterpart of ``scripts/sweep_inv_chain.py``, which swept the
Montgomery chain length of the TPU's batch inversion.  Kernels A
(``csrc/kernels.cu`` ``vgen_batch_inverse_dx``) and G (``csrc/p2tr.cu``
``vgen_batch_inverse_chain``) share one block (``csrc/inv_block.cuh``): each
thread a chain of M elements strided by the thread count, so K B / M
threads run, and G threads of a block sharing one inversion through a
product tree in shared memory.  (M, G) are launch arguments
(``fused.batch_inverse_dx(..., chain=M, group=G)``, ``fused.INV_GEOMETRY``
in the product; (64, 1) is one inversion per thread) and change no value,
since the output is canonical.  The tool times both kernels at K = 8, B =
524288 on random field elements (G's with a zero every 4097 elements) for
every (M, G) of ``GEOMETRIES``, holds each output bit-equal to the
product geometry's, and prints the warps per SM the threads come to
(spread evenly over the SMs), the ms, the bound of the work at that
geometry (``chain_count``) and its share, and each block size's ptxas
registers, stack and spill.  It measures the card only: without one it
exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import torch

from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import fused
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, timing

K, B = 8, common.TIMED_N
CHAINS = (8, 16, 32, 64, 128)
GROUPS = (1, 32, 256, 512)
GEOMETRIES = tuple((m, g) for m in CHAINS for g in GROUPS)
# per element: kernel A's subtraction tx - bx, kernel G's zero guard
A_INPUT = bm.FE_ADD
G_INPUT = bm.ops(0, 0, 8)


def chain_count(m: int, g: int = 1, per_input=A_INPUT):
    """The bound model's count of one element of a chain of m in a group of
    g threads: three multiplies and the input's cost, the inversion shared
    by the group's m g elements, and the product tree's 3 (g - 1)
    multiplies (g - 1 up, 2 g - 2 down) shared by the same."""
    return (3 * bm.FE_MUL + per_input + bm.INV / (m * g)
            + 3 * bm.FE_MUL * (g - 1) / (g * m))


def block_threads(g: int) -> int:
    """Threads per block of the launchers for group g."""
    return max(256, g)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.sweep_inv_chain",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    tag, n = card.tag(), K * B
    tx = common.inputs(B, seed=73)[0].to(card.device)
    bx = common.inputs(K, seed=74)[0].T.contiguous().to(card.device)
    v = common.inputs(n, seed=75)[0]
    v[:, ::4097] = 0  # zero lanes, guarded to 1
    v = v.to(card.device)
    kernels = {
        "batch_inverse_dx": (lambda m, g: fused.batch_inverse_dx(
            bx, tx, chain=m, group=g), A_INPUT, 32 * (K + B + n)),
        "batch_inverse_chain": (lambda m, g: fused.batch_inverse_chain(
            v, chain=m, group=g), G_INPUT, 64 * n),
    }
    prod = fused.INV_GEOMETRY
    log = build.build_log(("kernels", "p2tr"))
    for name, kern in (("inv_dx_kernel", "A"), ("inv_chain_kernel", "G")):
        figs = timing.ptxas_figures(log, name)
        print(f"# ptxas kernel {kern} ({name}): " + "; ".join(
            f"block {args[0]}: {timing.ptxas_text(f)}"
            for args, f in sorted(figs.items())) + f" {tag}", flush=True)
    print(f"# sweep_inv_chain: kernels A and G at K={K} B={B}; ms per "
          f"launch, best of five means of 10; outputs held to (M, G) = "
          f"{prod} {tag}", flush=True)
    best = {}
    for kname, (run, per_input, nbytes) in kernels.items():
        ref = run(*prod)
        for m, g in GEOMETRIES:
            out = run(m, g)
            if not torch.equal(out, ref):
                print(f"error: {kname} (M, G) = ({m}, {g}) differs from "
                      f"{prod}", file=sys.stderr)
                return 1
            ms = timing.launch_ms(lambda: run(m, g))
            threads = n // m
            bms, bby = bm.bound(n * chain_count(m, g, per_input), nbytes,
                                card.sm_clocks_per_s)
            old_bms = bm.bound(n * chain_count(m, 1, per_input), nbytes,
                               card.sm_clocks_per_s)[0]
            best.setdefault(kname, []).append((ms, m, g))
            print(f"{kname} M={m} G={g}: {threads} threads in blocks of "
                  f"{block_threads(g)}, {threads / 32 / card.sm_count:.1f} "
                  f"warps per SM, {n // (m * g)} inversions; {ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({bby}, share {bms / ms:.2f}; one "
                  f"inversion per thread's bound {old_bms:.4f}); output == "
                  f"{prod}'s {tag}", flush=True)
    for kname, rows in best.items():
        ms, m, g = min(rows)
        old = [r[0] for r in rows if r[1:] == (64, 1)]
        print(f"# {kname}: fastest (M, G) = ({m}, {g}) at {ms:.4f} ms"
              + (f", {old[0] / ms:.2f}x (64, 1)'s {old[0]:.4f}" if old else "")
              + f" {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
