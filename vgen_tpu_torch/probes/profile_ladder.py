"""Kernel F split by stage on the card: kernel ``probe_ladder_stage`` and
its tool.

    python -m vgen_tpu_torch.probes.profile_ladder

Kernel F (``csrc/p2tr.cu`` ``ladder_kernel``, the product's schedule
``fused.LADDER_WINDOW``) runs per lane the full finish, the even-Y key
and the TapTweak hash, then one table entry and one lean add per nonzero
digit of t.  ``probe_ladder_stage`` (``probes/ladder_stages.cuh``) cuts
that lane after a stage: ``finish``; ``tagged`` (the finish, then the
hash); ``digits`` (those, then the digits and their entries' loads, XORed
into the output in place of the adds); ``full`` (the whole lane).  The
tool holds each stage to its plain version at K = 2, B = 4096 and
``full`` to kernel F at K = 8, B = 524288 on the scan's own inputs
(``sweep_ladder_window.scan_inputs``), then times the four and kernel F
in turns there and prints each stage's share: the finish, the tagged hash
(tagged - finish), the digits and loads (digits - tagged) and the lean
adds (full - digits), with each instance's ptxas registers, stack and
spill.  It measures the card only: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import torch

from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import curve, field, fused, sha256, u256
from vgen_tpu_torch.probes import common, sweep_ladder_window, timing
from vgen_tpu_torch.scan import tables

# stage: template code of ladder_stages.cuh LadderStage
STAGES = {"finish": 0, "tagged": 1, "digits": 2, "full": 3}


def ladder_stage_plain(stage, bx, by, tx, ty, inv, wt):
    """Plain version of ``probe_ladder_stage``: kernel F's contract
    (``fused.p2tr_ladder_plain``) cut after ``stage`` -> (X, Z (8, K*B),
    ok (K*B,)) int32, as ``ladder_stages.cuh`` says."""
    if stage == "full":
        return fused.p2tr_ladder_plain(bx, by, tx, ty, inv, wt)
    K, B = bx.shape[0], tx.shape[1]
    x, y, ok = (v.reshape(v.shape[0], K * B) if v.dim() == 3
                else v.reshape(K * B)
                for v in curve.ec_finish(*fused._lanes(bx, by, tx, ty, inv)))
    if stage != "finish":
        y = u256.select((y[0] & 1) == 0, y, field.neg(y))
        t = sha256.tagged_hash_32(fused.TAPTWEAK_MIDSTATE, x)
        _, borrow = u256.sub(t, u256.constant(field.N_INT, t))
        ok = ok & (borrow == 1)
        if stage == "tagged":
            x = t
        else:
            bits, signed = fused.ladder_schedule(wt)
            wt64 = u256.to_i64(wt)
            for w, (digit, neg) in enumerate(fused.ladder_digits(t, bits,
                                                                 signed)):
                pt = wt64[w][digit]  # (N, 2, 8)
                px, py = pt[:, 0].T, pt[:, 1].T
                py = u256.select(neg, field.neg(py), py)
                nz = digit != 0
                x = u256.select(nz, x ^ px, x)
                y = u256.select(nz, y ^ py, y)
    return u256.to_i32(x), u256.to_i32(y), ok.to(torch.int32)


def probe_ladder_stage(stage, bx, by, tx, ty, inv, wt):
    """Kernel ``probe_ladder_stage`` (``probes/probes.cu``), one launch at
    the product's window schedule; the plain version for CPU tensors."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    if all(t.device.type == "cpu" for t in (bx, by, tx, ty, inv, wt)):
        return ladder_stage_plain(stage, bx, by, tx, ty, inv, wt)
    if fused.ladder_schedule(wt) != fused.LADDER_WINDOW:
        raise ValueError("probe_ladder_stage: instanced for the product's "
                         f"schedule {fused.LADDER_WINDOW} only")
    K, B = bx.shape[0], tx.shape[1]
    dev = fused._check_cuda("probe_ladder_stage", [
        ("bx", bx, (K, 8)), ("by", by, (K, 8)), ("tx", tx, (8, B)),
        ("ty", ty, (8, B)), ("inv", inv, (8, K * B)),
        ("wt", wt, tuple(wt.shape))])
    X = torch.empty((8, K * B), dtype=torch.int32, device=dev)
    Z = torch.empty_like(X)
    ok = torch.empty((K * B,), dtype=torch.int32, device=dev)
    common.launch("probe_ladder_stage", dev, STAGES[stage], bx.data_ptr(),
                  by.data_ptr(), tx.data_ptr(), ty.data_ptr(), inv.data_ptr(),
                  wt.data_ptr(), X.data_ptr(), Z.data_ptr(), ok.data_ptr(), K,
                  B)
    return X, Z, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.profile_ladder",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    tag = card.tag()
    K, B = sweep_ladder_window.K, sweep_ladder_window.B
    lanes = sweep_ladder_window.scan_inputs(card.device)
    wt = tables.ladder_table(card.device)
    # each stage against its plain version on two windows of 4096 lanes
    bx, by, tx, ty, _ = lanes
    small = (bx[:2], by[:2], tx[:, :4096].contiguous(),
             ty[:, :4096].contiguous())
    small += (fused.batch_inverse_dx(small[0], small[2]),)
    for stage in STAGES:
        got = probe_ladder_stage(stage, *small, wt)
        want = ladder_stage_plain(stage, *(t.cpu() for t in small), wt.cpu())
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            print(f"error: stage {stage} differs from its plain version",
                  file=sys.stderr)
            return 1
    got = probe_ladder_stage("full", *lanes, wt)
    if not all(torch.equal(g, w) for g, w in
               zip(got, fused.p2tr_ladder(*lanes, wt))):
        print("error: stage full differs from kernel F", file=sys.stderr)
        return 1
    del got
    figs = timing.ptxas_figures(build.build_log(("probes",)),
                                "probe_ladder_stage")
    print(f"# profile_ladder: kernel F cut by stage at K={K} B={B}, schedule "
          f"{fused.LADDER_WINDOW}; each stage bit-equal to its plain version "
          f"(K=2, B=4096), full to kernel F {tag}", flush=True)
    turns = {stage: (lambda s=stage: probe_ladder_stage(s, *lanes, wt))
             for stage in STAGES}
    turns["kernel F"] = lambda: fused.p2tr_ladder(*lanes, wt)
    med = timing.in_turns(turns, tag)
    for stage, code in STAGES.items():
        print(f"ptxas probe_ladder_stage<{code}> ({stage}): "
              f"{timing.ptxas_text(figs.get((code,)))} {tag}", flush=True)
    full = med["full"]
    parts = {"finish": med["finish"],
             "tagged hash": med["tagged"] - med["finish"],
             "digits and loads": med["digits"] - med["tagged"],
             "lean adds": med["full"] - med["digits"]}
    print("# stages of kernel F: " + "; ".join(
        f"{name} {ms:.4f} ms ({100 * ms / full:.1f}%)"
        for name, ms in parts.items())
        + f"; full {full:.4f} ms, kernel F {med['kernel F']:.4f} ms {tag}",
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
