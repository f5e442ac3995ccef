"""Kernel F's ladder window, swept on the card.

    python -m vgen_tpu_torch.probes.sweep_ladder_window

Kernel F (``csrc/p2tr.cu`` ``ladder_kernel``) adds t*G to the internal key
by fixed windows of t: one lean Jacobian add per nonzero digit, the
entry read from a table of (x, y) of d * 2^(bits w) * G.  The window is
a template parameter, (bits, signed digits), instanced for every schedule
of ``fused.LADDER_WINDOWS``; the JAX package's 8 unsigned bits (32
windows, a 512 KB table) among them.  Wider digits cut the adds and grow
the table (``fused.ladder_shape``), which L2 has to serve.

The tool builds each schedule's table (``scan.tables.ladder_table_limbs``,
rebuilt, timed) and times kernel F (finish=True) at K = 8, B = 524288 on
the scan's own inputs (the i*G table and K random window bases, kernel A's
inverses), holds its output key x, qx = X * Z^-2 (Z inverted by kernel
G), and ok equal to the product schedule's (``fused.LADDER_WINDOW``), and
prints the table's size and build seconds, the adds per lane this data
needs, the ms, the bound of that work (``ladder_count``) and its share,
and the instance's ptxas registers, stack and spill.  It measures the card
only: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import torch

from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import curve, field, fused, sha256, u256
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, timing
from vgen_tpu_torch.scan import tables

K, B = 8, common.TIMED_N
# per lane: the full finish (lambda, x, y: two multiplies, a squaring, six
# subtractions), the even-Y negation, the tweak's compression of x from
# the tag's midstate and t < n
FINISH_XY = 2 * bm.FE_MUL + bm.FE_SQR + 6 * bm.FE_ADD
TWEAK = bm.FE_ADD + bm.TAGGED + bm.ops(0, 0, 16)


def schedule_name(bits: int, signed: bool) -> str:
    return f"{bits}{'s' if signed else 'u'}"


def tweaks(x):
    """t = TapTweak(x) of the internal keys' x ((8, n) int64)."""
    return sha256.tagged_hash_32(fused.TAPTWEAK_MIDSTATE, x)


def ladder_work(t, bits: int, signed: bool):
    """(adds, negations) the ladder of schedule (bits, signed) does for the
    tweaks t ((8, n) int64, ``tweaks``): its nonzero digits, and the
    negative ones among them (each a negation of y)."""
    adds = negs = 0
    for d, neg in fused.ladder_digits(t, bits, signed):
        adds += int(d.ne(0).sum())
        negs += int(neg.sum())
    return adds, negs


def ladder_count(lanes: int, adds: int, negs: int, finish: bool = True):
    """The bound model's count of kernel F over ``lanes`` lanes: per lane
    the full finish (``finish``) and the tweak, per add a lean add, per
    negative digit a negation."""
    per_lane = (FINISH_XY if finish else bm.ops()) + TWEAK
    return lanes * per_lane + adds * bm.LEAN_ADD + negs * bm.FE_ADD


def table_bytes(bits: int, signed: bool) -> int:
    windows, entries = fused.ladder_shape(bits, signed)
    return windows * entries * 2 * 8 * 4


def scan_inputs(device, seed: int = 931):
    """(bx, by, tx, ty, inv) of one super-step of the scan: the i*G table,
    K random window bases, kernel A's inverses."""
    tx, ty = tables.ig_table(B, device)
    rng = random.Random(seed)
    pts = [ec.scalar_mult_base_fast(rng.randrange(1, ec.N)) for _ in range(K)]
    bx = u256.as_i32(u256.from_ints([p[0] for p in pts]).T).to(device)
    by = u256.as_i32(u256.from_ints([p[1] for p in pts]).T).to(device)
    return bx, by, tx, ty, fused.batch_inverse_dx(bx, tx)


def output_x(X, Z):
    """qx = X * Z^-2 ((8, n) int64) through kernel G's inverses."""
    zi = u256.to_i64(fused.batch_inverse_chain(Z))
    return field.mul(u256.to_i64(X), field.square(zi))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.sweep_ladder_window",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    tag, n = card.tag(), K * B
    lanes = scan_inputs(card.device)
    x3, _, _ = curve.ec_finish(*fused._lanes(*lanes))
    t = tweaks(x3.reshape(8, n))
    del x3
    figs = timing.ptxas_figures(build.build_log(("p2tr",)), "ladder_kernel")
    prod = fused.LADDER_WINDOW
    print(f"# sweep_ladder_window: kernel F (finish=True) at K={K} B={B}; ms "
          f"per launch, best of five means of 3; outputs held to "
          f"{schedule_name(*prod)}'s {tag}", flush=True)
    ref = None
    rows = []
    for bits, signed in (prod,) + tuple(s for s in fused.LADDER_WINDOWS
                                        if s != prod):
        name = schedule_name(bits, signed)
        t0 = time.time()
        limbs = tables.ladder_table_limbs(bits, signed, refresh=True)
        build_s = time.time() - t0
        wt = u256.as_i32(limbs).to(card.device)
        X, Z, ok = fused.p2tr_ladder(*lanes, wt)
        qx = output_x(X, Z)
        if ref is None:
            ref = (qx, ok)
        elif not (torch.equal(ok, ref[1])
                  and torch.equal(qx[:, ok != 0], ref[0][:, ok != 0])):
            print(f"error: schedule {name} differs from "
                  f"{schedule_name(*prod)} in qx or ok", file=sys.stderr)
            return 1
        del X, Z, qx
        ms = timing.launch_ms(lambda: fused.p2tr_ladder(*lanes, wt), reps=3)
        adds, negs = ladder_work(t, bits, signed)
        bms, bby = bm.bound(ladder_count(n, adds, negs),
                            64 * (K + B) + 100 * n + table_bytes(bits, signed),
                            card.sm_clocks_per_s)
        rows.append((ms, name))
        print(f"{name}: {fused.ladder_shape(bits, signed)[0]} windows, table "
              f"{table_bytes(bits, signed) / 2**20:.2f} MiB built in "
              f"{build_s:.2f} s; {adds / n:.3f} adds and {negs / n:.3f} "
              f"negations per lane; {ms:.3f} ms, bound {bms:.3f} ms ({bby}, "
              f"share {bms / ms:.2f}); ptxas "
              f"{timing.ptxas_text(figs.get((1, bits, int(signed))))}; "
              f"ok {int(ok.sum())} of {n}, qx == {schedule_name(*prod)}'s "
              f"{tag}", flush=True)
        del wt
        torch.cuda.empty_cache()
    ms, name = min(rows)
    old = [r[0] for r in rows if r[1] == "8u"]
    print(f"# fastest schedule {name} at {ms:.3f} ms"
          + (f", {old[0] / ms:.2f}x 8u's {old[0]:.3f}" if old else "")
          + f" {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
