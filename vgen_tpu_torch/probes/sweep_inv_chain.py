"""Kernel A's chain length, swept on the card.

    python -m vgen_tpu_torch.probes.sweep_inv_chain

The counterpart of ``scripts/sweep_inv_chain.py``, which swept the
Montgomery chain length of the TPU's batch inversion.  Kernel A
(``csrc/kernels.cu`` ``vgen_batch_inverse_dx``) gives each thread a chain
of M elements strided by the thread count, so K B / M threads run; M is a
launch argument (``fused.batch_inverse_dx(..., chain=M)``, 64 in the
product) and changes no value, since the output is canonical.  The tool
times kernel A at K = 8, B = 524288 on random field elements for M = 16,
32, 64, 128 and 256, holds each output bit-equal to M = 64's, and prints
the threads, the warps per SM they come to (spread evenly over the SMs),
the ms and the bound of each M.  It measures the card only: without one it
exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import torch

from vgen_tpu_torch.ops import fused
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, timing

K, B = 8, common.TIMED_N
CHAINS = (16, 32, 64, 128, 256)
THREADS = 256  # kernel A's block


def chain_count(m: int):
    """The bound model's count of one element of a chain of m: three
    multiplies and a subtraction, and the inversion shared by m."""
    return 3 * bm.FE_MUL + bm.FE_ADD + bm.INV / m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.sweep_inv_chain",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    tag, n = card.tag(), K * B
    tx = common.inputs(B, seed=73)[0].to(card.device)
    bx = common.inputs(K, seed=74)[0].T.contiguous().to(card.device)
    ref = fused.batch_inverse_dx(bx, tx)
    print(f"# sweep_inv_chain: kernel A at K={K} B={B}, blocks of {THREADS} "
          f"threads; ms per launch, best of five means of 10 {tag}",
          flush=True)
    for m in CHAINS:
        out = fused.batch_inverse_dx(bx, tx, chain=m)
        if not torch.equal(out, ref):
            print(f"error: M={m} differs from M={fused.INV_CHAIN}",
                  file=sys.stderr)
            return 1
        ms = timing.launch_ms(lambda: fused.batch_inverse_dx(bx, tx, chain=m))
        threads = n // m
        bms, bby = bm.bound(n * chain_count(m), 32 * (K + B + n),
                            card.sm_clocks_per_s)
        print(f"M={m}: {threads} threads in {threads // THREADS} blocks, "
              f"{threads / 32 / card.sm_count:.1f} warps per SM; {ms:.4f} ms,"
              f" bound {bms:.4f} ms ({bby}, share {bms / ms:.2f}); output == "
              f"M={fused.INV_CHAIN}'s {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
