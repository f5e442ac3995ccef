"""Kernel B's time split by stage on the card: kernel ``probe_glv_stage``
and its tool.

    python -m vgen_tpu_torch.probes.profile_glv

The counterpart of ``scripts/profile_glv.py`` (its ``make_kernel(mode)``
:87, ``pallas_call`` :165), which timed kernel B's P2PKH body cut down by
stage.  One window of B = 524288 lanes, as the script runs it: the i*G
table, the base point 0xABC0 * G, the inverses from kernel A and the ^1C
intervals.  Each mode's output is the TPU body's function (lane e of
window k, 0 where dx == 0 or b >= remaining[k]):

- ``ec``: the x-only finish, xs = (x, beta x, beta^2 x); 1 where the low
  16 bits of some xs[v] equal v (the TPU compared its low 16-bit limb, and
  its body ORs 1, not 1 << v, for each v);
- ``ec2``: as ``ec`` after two more multiplies by beta of each value;
- ``ecc``: as ``ec2`` with those six multiplies in the column form
  (``candidates.cuh`` ``fe_mul_colsum``), the TPU's ``mulc``; its mask is
  ``ec2``'s;
- ``hash2``: bits 0 and 1, hash160(02 + pi || x) in an interval;
- ``full``: kernel B's P2PKH mask (``range_glv_lane`` itself);
- ``hash2r``, ``fullr``: the values of ``hash2`` and ``full`` from two
  lanes per thread whose hashes run interleaved (the TPU reshaped the
  hash input to (32, 8, T/8) rows for more lanes per dependent step).

The tool times kernel A and production kernel B beside the seven modes,
as the script does, and prints B's split: the finish and the beta
products (``ec``), a multiply ((``ec2`` - ``ec``) / 6) against one in the
column form ((``ecc`` - ``ec``) / 6), the hashes and their compares
(``full`` - ``ec``), and a compare alone (``full`` - ``hash2`` less two
multiplies, over four, less hash160 as ``probe_primitive`` times it), with
each mode's ptxas figures.  It measures the card only: without one it
exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import torch

from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.ops import encode, field, fused, pipeline, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, microbench_fieldmul, roofline, timing
from vgen_tpu_torch.scan import tables

P2PKH = AddressFormat.P2PKH
# mode: template code of geometry_lanes.cuh GlvStage
MODES = {"ec": 0, "ec2": 1, "ecc": 2, "hash2": 3, "hash2r": 4, "full": 5,
         "fullr": 6}
TWO_LANES = ("hash2r", "fullr")
BASE = 0xABC0  # the script's window base scalar
PATTERN = "^1C"
# lane of window 0: (v, extra multiplies) whose ec bit ``stage_inputs``
# forces, for the ec modes' masks (otherwise 2^-16 per value)
FORCED = {1: (0, 0), 2: (1, 0), 3: (2, 0), 4: (0, 2), 5: (1, 2), 6: (2, 2)}


def extra_muls(mode: str) -> int:
    return 0 if mode == "ec" else 2


def stage_count(mode: str, n_slots: int):
    """The bound model's count of one lane of ``mode``: the finish, the
    beta products it uses, its hashes and compares."""
    if mode in ("ec", "ec2", "ecc"):
        mul = bm.FE_MUL_COLSUM if mode == "ecc" else bm.FE_MUL
        # two beta products, the extra multiplies, three 16-bit compares
        return (bm.FINISH_X + 2 * bm.FE_MUL + 3 * extra_muls(mode) * mul
                + bm.ops(0, 0, 3))
    variants = 1 if mode.startswith("hash2") else 3
    return (bm.FINISH_X + 2 * (variants - 1) * bm.FE_MUL
            + 2 * variants * (bm.HASH160 + bm.compare(n_slots, 5)))


def stage_nbytes(K: int, B: int, n_slots: int) -> int:
    """Bytes read and written once: the bases, the table, the inverses,
    the intervals, remaining, and the (K, B) int32 mask."""
    return 64 * K + 64 * B + 32 * K * B + 40 * n_slots + 4 * K + 4 * K * B


def _intervals():
    """(lo, hi) (8, 5) int32 of ^1C, padded to 8 slots as the script pads."""
    lo, hi = pipeline.intervals_to_words(
        Pattern(PATTERN).match_intervals(P2PKH))
    return u256.as_i32(lo), u256.as_i32(hi)


def _force_ec_hits(bx, by, tx, ty, inv):
    """inv with the lanes of ``FORCED`` replaced so that the finish gives
    an x whose xs[v] after ``extra`` beta multiplies has v as its low 16
    bits: x = c beta^-(v + extra) with c = v mod 2^16, lambda a square
    root of x + bx + tx, inv = lambda / (ty - by).  CPU tensors."""
    inv = inv.clone()
    bxi, byi = u256.to_ints(bx.T)[0], u256.to_ints(by.T)[0]
    P = ec.P
    for lane, (v, extra) in FORCED.items():
        txi = u256.to_ints(tx[:, lane:lane + 1])[0]
        tyi = u256.to_ints(ty[:, lane:lane + 1])[0]
        beta_inv = pow(ec.BETA, (3 - (v + extra) % 3) % 3, P)
        for hi_part in range(1, 1 << 16):
            x = (v + (hi_part << 16)) * beta_inv % P
            a = (x + bxi + txi) % P
            lam = pow(a, (P + 1) // 4, P)
            if lam * lam % P == a and (tyi - byi) % P:
                break
        lane_inv = lam * pow(tyi - byi, P - 2, P) % P
        inv[:, lane] = u256.as_i32(u256.from_ints([lane_inv]))[:, 0]
    return inv


def stage_inputs(B: int, device, force: bool = False):
    """The script's inputs for one window of B lanes on ``device``: (bx,
    by, tx, ty, inv, lo, hi, remaining), inv from kernel A (its plain
    version on the CPU); with ``force``, the ``FORCED`` lanes' inverses
    are replaced (``_force_ec_hits``)."""
    tx, ty = tables.ig_table(B, "cpu")
    x, y = ec.scalar_mult(BASE)
    bx = u256.as_i32(u256.from_ints([x]).T)
    by = u256.as_i32(u256.from_ints([y]).T)
    lo, hi = _intervals()
    remaining = torch.tensor([B], dtype=torch.int32)
    dev = torch.device(device)
    if dev.type == "cpu":
        inv = fused.batch_inverse_dx(bx, tx)
    else:
        inv = fused.batch_inverse_dx(bx.to(dev), tx.to(dev)).cpu()
    if force:
        inv = _force_ec_hits(bx, by, tx, ty, inv)
    return tuple(t.to(dev) for t in (bx, by, tx, ty, inv, lo, hi, remaining))


def stage_values(mode: str, x3: torch.Tensor):
    """xs of an ec mode: (x, beta x, beta (beta x)), each multiplied by
    beta ``extra_muls(mode)`` more times, ``ecc`` in the column form.
    x3 (8, *S) int64 -> three (8, *S) int64."""
    beta = u256.constant(ec.BETA, x3)
    x1 = field.mul(x3, beta)
    xs = [x3, x1, field.mul(x1, beta)]
    for _ in range(extra_muls(mode)):
        if mode == "ecc":
            xs = [mul_colsum(x, beta) for x in xs]
        else:
            xs = [field.mul(x, beta) for x in xs]
    return xs


def mul_colsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p in the column form (``fe_mul_colsum``): column sums,
    one carry pass, the fold."""
    limbs, _ = microbench_fieldmul.carry_cols(
        microbench_fieldmul.mul_cols_nocarry(a, b))
    return field.reduce512(torch.stack(limbs))


def glv_stage_plain(mode, bx, by, tx, ty, inv, lo, hi, remaining):
    """Plain version of ``probe_glv_stage``: kernel B's arguments (bx, by
    (K, 8); tx, ty (8, B); inv (8, K*B); lo, hi (n_slots, 5); remaining
    (K,); int32) -> the (K, B) int32 mask of ``mode``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode in ("full", "fullr"):
        return fused.range_glv_match_plain(P2PKH, bx, by, tx, ty, inv, lo, hi,
                                           remaining)
    x3, _, valid = fused._glv_finish(P2PKH, bx, by, tx, ty, inv, remaining)
    mask = torch.zeros(x3.shape[1:], dtype=torch.int64, device=x3.device)
    if mode in ("hash2", "hash2r"):
        lo64, hi64 = u256.to_i64(lo), u256.to_i64(hi)
        for pi in range(2):
            hit = pipeline.in_intervals(
                encode.hash160_33_words_from_x(x3, 2 + pi), lo64, hi64)
            mask = mask | (hit.to(torch.int64) << pi)
    else:
        for v, xv in enumerate(stage_values(mode, x3)):
            mask = mask | ((xv[0] & 0xFFFF) == v).to(torch.int64)
    return torch.where(valid, mask, 0).to(torch.int32)


def probe_glv_stage(mode, bx, by, tx, ty, inv, lo, hi, remaining):
    """Kernel ``probe_glv_stage`` (``probes/probes.cu``), one launch for
    all K*B lanes; the plain version for CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    args = (bx, by, tx, ty, inv, lo, hi, remaining)
    if all(t.device.type == "cpu" for t in args):
        return glv_stage_plain(mode, *args)
    if mode in TWO_LANES and bx.shape[0] * tx.shape[1] % 2:
        raise ValueError(f"probe_glv_stage: {mode} takes an even K*B")
    out = common.launch_interval("probe_glv_stage", (MODES[mode],), args)
    probe_glv_stage.launches += 1
    return out


probe_glv_stage.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.profile_glv",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    from vgen_tpu_torch.csrc import build

    B, tag = common.TIMED_N, card.tag()
    args = stage_inputs(B, card.device)
    bx, by, tx, ty, inv, lo, hi, remaining = args
    n_slots = lo.shape[0]
    probe_glv_stage("ec", *args)  # builds the probe library
    ptxas = timing.ptxas_figures(build.build_log(("probes",)),
                                 "probe_glv_stage")
    ref = fused.range_glv_match(P2PKH, *args)
    print(f"# profile_glv: one window of B={B} lanes, base {BASE:#x} * G, "
          f"pattern {PATTERN} ({n_slots} slots); ms per launch, best of five "
          f"means of 10 {tag}", flush=True)
    ms = {"A": timing.launch_ms(lambda: fused.batch_inverse_dx(bx, tx)),
          "B": timing.launch_ms(lambda: fused.range_glv_match(P2PKH, *args))}
    print(f"kernel A (batch_inverse_dx): {ms['A']:.4f} ms; kernel B "
          f"(range_glv_match): {ms['B']:.4f} ms, {6 * B / ms['B'] / 1e3:.1f} "
          f"M keys/s {tag}", flush=True)
    for mode, code in MODES.items():
        out = probe_glv_stage(mode, *args)
        if mode in ("full", "fullr") and not torch.equal(out, ref):
            print(f"error: {mode} differs from kernel B", file=sys.stderr)
            return 1
        ms[mode] = timing.launch_ms(lambda m=mode: probe_glv_stage(m, *args))
        bms, bby = bm.bound(B * stage_count(mode, n_slots),
                            stage_nbytes(1, B, n_slots), card.sm_clocks_per_s)
        print(f"{mode}: {ms[mode]:.4f} ms, {B / ms[mode] / 1e3:.1f} M lanes/s,"
              f" bound {bms:.4f} ms ({bby}, share {bms / ms[mode]:.2f}); "
              f"ptxas {timing.ptxas_text(ptxas.get((code,)))} {tag}",
              flush=True)
    # hash160 alone, net of the probe's fold, for the compare's share
    a, b = (t.to(card.device) for t in common.inputs(B, seed=165))
    table = roofline.dfa_table().to(card.device)
    with timing.ClockSampler() as clocks:
        net = {}
        for name in ("empty", "hash160c"):
            res = timing.measure(
                lambda r, p=name: roofline.probe_primitive(p, a, b, table, r),
                roofline.R0, roofline.MAX_REPS, clocks)
            if "error" in res:
                print(f"error: {name}: {res}", file=sys.stderr)
                return 1
            net[name] = res["delta_ms"] / res["reps"]
    hash160 = net["hash160c"] - net["empty"]
    mul = (ms["ec2"] - ms["ec"]) / 6
    per_hash = (ms["full"] - ms["hash2"] - 2 * mul) / 4
    print(f"# B's split (one window, ms): finish + beta products (ec) "
          f"{ms['ec']:.4f}; a multiply (ec2 - ec) / 6 = {mul:.4f}, in the "
          f"column form (ecc - ec) / 6 = {(ms['ecc'] - ms['ec']) / 6:.4f}; "
          f"six hashes and compares (full - ec) = {ms['full'] - ms['ec']:.4f}"
          f"; one hash and compare (full - hash2 - 2 mul) / 4 = "
          f"{per_hash:.4f}, hash160 alone (probe_primitive, net of its fold) "
          f"{hash160:.4f}, so a compare {per_hash - hash160:.4f}; full / B "
          f"{ms['full'] / ms['B']:.3f}, fullr / full "
          f"{ms['fullr'] / ms['full']:.3f}, hash2r / hash2 "
          f"{ms['hash2r'] / ms['hash2']:.3f} {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
