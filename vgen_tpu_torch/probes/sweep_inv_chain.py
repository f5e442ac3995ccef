"""Kernels A and G's batch inversion, split by stage and swept on the card.

    python -m vgen_tpu_torch.probes.sweep_inv_chain

The counterpart of ``scripts/sweep_inv_chain.py``, which swept the
Montgomery chain length of the TPU's batch inversion.  Kernels A
(``csrc/kernels.cu`` ``vgen_batch_inverse_dx``) and G (``csrc/p2tr.cu``
``vgen_batch_inverse_chain``) share one block (``csrc/inv_block.cuh``): T =
N / M chains of M elements strided by T, groups of G chains sharing one
inversion through a product tree in shared memory, and persistent blocks
(``fused.inv_schedule``: one an SM, each walking the same number of rounds
of ``fused.INV_BLOCK`` chains) whose tree warps build a round's trees and
invert its groups' products while the block's chains run the next round's
forward chains.  (M, G) are launch arguments
(``fused.batch_inverse_dx(..., chain=M, group=G)``, ``fused.INV_GEOMETRY``
in the product; (64, 1) is one inversion per chain) and change no value,
since the output is canonical.

First the stage split at K = 8, B = 524288 and the product's geometry:
kernel A's forward chains, its trees with their inversions, and its
backward chains, each launched alone over all chains
(``probes/inv_stages.cuh``), the three stages in a row held to the whole
kernel's output; beside them the whole kernels A and G, and one lane's
inversion (its latency: the time of 2R inversions in a row less that of
R, over R).  Then every (M, G) of ``GEOMETRIES`` for both kernels on
random field elements (G's with a zero every 4097 elements): the
schedule (blocks, rounds and groups a block, whether the tree warps
overlap the chains), the ms, the bound of the work at that geometry
(``chain_count``) and its share, each output held bit-equal to the
product geometry's; and each kernel's ptxas registers, stack and spill.
It measures the card only: without one it exits non-zero.

    python -m vgen_tpu_torch.probes.sweep_inv_chain --n 524288 557056

sweeps kernel G alone at each N instead, on random nonzero elements, over
chains of 1 to 64 (``TABLE_CHAINS``): the Z of the tables the card builds
(``scan/tables.py`` ``build_multiples``: the i*G table's 524288 points,
the 16-bit ladder table's 17 x 32768), where few SMs have work.  Its
fastest geometry is ``fused.TABLE_INV_GEOMETRY``.
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
GROUPS = (1, 8, 32, 256, 512)
GEOMETRIES = tuple((m, g) for m in CHAINS for g in GROUPS)
TABLE_CHAINS = (1, 2, 4, 8, 16, 32, 64)
TABLE_GEOMETRIES = tuple((m, g) for m in TABLE_CHAINS for g in GROUPS)
# per element: kernel A's subtraction tx - bx, kernel G's zero guard
A_INPUT = bm.FE_ADD
G_INPUT = bm.ops(0, 0, 8)
STAGES = ("forward", "trees and inversions", "backward")
LANE_REPS = 16


def chain_count(m: int, g: int = 1, per_input=A_INPUT):
    """The bound model's count of one element of a chain of m in a group of
    g chains: three multiplies and the input's cost, the group's inversion
    (divsteps) shared by its m g elements, and the product tree's 3 (g - 1)
    multiplies (g - 1 up, 2 g - 2 down) shared by the same."""
    return (3 * bm.FE_MUL + per_input + bm.INV_DIVSTEPS / (m * g)
            + 3 * bm.FE_MUL * (g - 1) / (g * m))


def schedule_text(n: int, m: int, g: int, sms: int) -> str:
    s = fused.inv_schedule(n, m, g, sms=sms)
    return (f"{s.blocks} blocks, {s.rounds} rounds of {fused.INV_BLOCK} and "
            f"{s.groups} groups a block, "
            + ("tree warp overlapped" if s.overlapped else "not overlapped"))


def stage_split(card, bx, tx, v, tag) -> int:
    """Kernel A by stage at the product's geometry; whole kernels A and G;
    one lane's inversion.  -> 0, or 1 if an output differs."""
    dev, n = card.device, K * B
    want = fused.batch_inverse_dx(bx, tx)
    m, g = fused._inv_geometry(n, *fused.INV_GEOMETRY)
    leaf = torch.empty((8, n // m), dtype=torch.int32, device=dev)
    out, scratch = torch.empty_like(want), torch.empty_like(want)

    def stage(s):
        common.launch("probe_inv_stage", dev, s, bx.data_ptr(),
                      tx.data_ptr(), leaf.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), K, B, m, g)

    for s in range(3):
        stage(s)
    if not torch.equal(out, want):
        print("error: kernel A's stages differ from kernel A",
              file=sys.stderr)
        return 1
    ms = [timing.launch_ms(lambda s=s: stage(s)) for s in range(3)]
    whole = {"A": timing.launch_ms(lambda: fused.batch_inverse_dx(bx, tx)),
             "G": timing.launch_ms(lambda: fused.batch_inverse_chain(v))}
    print(f"# stage split at (M, G) = ({m}, {g}), K = {K}, B = {B}: "
          + ", ".join(f"{s} {t:.4f} ms" for s, t in zip(STAGES, ms))
          + f" (sum {sum(ms):.4f}); whole kernel A {whole['A']:.4f} ms, G "
          f"{whole['G']:.4f} ms; {schedule_text(n, m, g, card.sm_count)}; "
          f"the stages' output == kernel A's {tag}", flush=True)
    a = common.inputs(1, seed=77)[0].to(dev)
    outs = {r: torch.empty_like(a) for r in (LANE_REPS, 2 * LANE_REPS)}

    def run(reps):
        common.launch("probe_inv_lane", dev, a.data_ptr(),
                      outs[reps].data_ptr(), reps)

    t = {r: timing.launch_ms(lambda r=r: run(r), reps=3) for r in outs}
    if not all(torch.equal(o, a) for o in outs.values()):
        print("error: the inversion applied an even number of times does "
              "not give its input back", file=sys.stderr)
        return 1
    lane = (t[2 * LANE_REPS] - t[LANE_REPS]) / LANE_REPS
    print(f"# one lane's inversion (divsteps): {lane * 1e3:.2f} us {tag}",
          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.sweep_inv_chain",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=None,
                    help="sweep kernel G alone at these element counts "
                    "(the tables' Z) over TABLE_GEOMETRIES")
    args = ap.parse_args(argv)
    card = timing.Card()
    tag = card.tag()
    # name -> (run(m, g), per-element input cost, bytes, elements)
    kernels = {}
    if args.n:
        geometries = TABLE_GEOMETRIES
        for n in args.n:
            vn = common.inputs(n, seed=76)[0].to(card.device)
            kernels[f"batch_inverse_chain[N={n}]"] = (
                lambda m, g, vn=vn: fused.batch_inverse_chain(
                    vn, chain=m, group=g), G_INPUT, 64 * n, n)
    else:
        geometries, n = GEOMETRIES, K * B
        tx = common.inputs(B, seed=73)[0].to(card.device)
        bx = common.inputs(K, seed=74)[0].T.contiguous().to(card.device)
        v = common.inputs(n, seed=75)[0]
        v[:, ::4097] = 0  # zero lanes, guarded to 1
        v = v.to(card.device)
        kernels = {
            "batch_inverse_dx": (lambda m, g: fused.batch_inverse_dx(
                bx, tx, chain=m, group=g), A_INPUT, 32 * (K + B + n), n),
            "batch_inverse_chain": (lambda m, g: fused.batch_inverse_chain(
                v, chain=m, group=g), G_INPUT, 64 * n, n),
        }
    prod = fused.INV_GEOMETRY
    build.build(build.UNITS + build.PROBE_UNITS)
    log = build.build_log(("kernels", "p2tr"))
    probe_log = build.build_log(("probes",))
    for name, kern, unit_log in (
            ("inv_dx_kernel", "A", log), ("inv_chain_kernel", "G", log),
            ("inv_stage_kernel", "A's stages", probe_log)):
        figs = timing.ptxas_figures(unit_log, name)
        print(f"# ptxas kernel {kern} ({name}): " + "; ".join(
            f"<{', '.join(map(str, args))}>: {timing.ptxas_text(f)}"
            for args, f in sorted(figs.items())) + f" {tag}", flush=True)
    if not args.n and stage_split(card, bx, tx, v, tag):
        return 1
    print(f"# sweep_inv_chain: {', '.join(kernels)}; ms per launch, best "
          f"of five means of 10; outputs held to (M, G) = {prod} {tag}",
          flush=True)
    best = {}
    for kname, (run, per_input, nbytes, n) in kernels.items():
        ref = run(*prod)
        for m, g in geometries:
            out = run(m, g)
            if not torch.equal(out, ref):
                print(f"error: {kname} (M, G) = ({m}, {g}) differs from "
                      f"{prod}", file=sys.stderr)
                return 1
            ms = timing.launch_ms(lambda: run(m, g))
            mm = fused._chain_len(n, m)
            bms, bby = bm.bound(n * chain_count(mm, g, per_input), nbytes,
                                card.sm_clocks_per_s)
            best.setdefault(kname, []).append((ms, m, g))
            print(f"{kname} M={m} G={g}: {n // mm} chains, "
                  f"{schedule_text(n, m, g, card.sm_count)}, "
                  f"{n // (mm * g)} inversions; {ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({bby}, share {bms / ms:.2f}); output == "
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
