"""Integer issue rates on the card: kernel ``probe_issue`` and its tool.

    python -m vgen_tpu_torch.probes.microbench_vpu

The counterpart of ``scripts/microbench_vpu.py`` (its ``make(op)`` :43,
``pallas_call`` :66), which timed R serialized repetitions of one op on
(16, T) tiles.  Here each lane runs R repetitions of one instruction in
1, 2, 4 or 8 independent dependent chains (``probe_lanes.cuh``
``issue_lane``): IADD3, LOP3, SHF (a funnel shift by a register), IMAD,
IMAD.HI, IMAD.WIDE, FFMA, and the one-to-one mixes LOP3 + IMAD and
IADD3 + LOP3 + SHF.  At N = 524288 lanes the tool reports SM clocks per
lane and repetition and lane results per SM per clock (at the SM clock
sampled while it ran), and their share of the bound model's published
rate for the op; with one chain it also runs one warp per
scheduler (one block of 128 lanes per SM), where a step's clocks are its
latency.  Beside each rate it prints the opcode counts of the kernel's
loop from ``cuobjdump -sass``, per repetition, so a reader sees that the
instruction asked for is the one timed.  It measures the card only:
without one it exits non-zero, and so it does when a delta never clears
its noise floor.
"""

from __future__ import annotations

import argparse
import sys

import torch

from vgen_tpu_torch.ops import u256
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, timing

# op: (template code of probe_lanes.cuh IssueOp, steps per repetition,
# the model's count of one step averaged over the repetition: only
# IMAD.WIDE is the model's multiply, a 32x32 -> 64 multiply-add)
OPS = {
    "iadd3": (0, 2, bm.ops(0, 0, 1)),
    "lop3": (1, 2, bm.ops(0, 1, 1)),
    "shf": (2, 2, bm.ops(0, 1, 1)),
    "imad": (3, 2, bm.ops(0, 0, 1)),
    "imad_hi": (4, 2, bm.ops(0, 0, 1)),
    "imad_wide": (5, 2, bm.ops(1, 0, 1)),
    "ffma": (6, 2, bm.ops(0, 0, 1)),
    "lop3_imad": (7, 2, bm.ops(0, 0.5, 1)),
    "iadd3_lop3_shf": (8, 3, bm.ops(0, 2 / 3, 1)),
}
CHAINS = (1, 2, 4, 8)
UNROLL = 8  # repetitions per loop iteration (probe_lanes.cuh kIssueUnroll)
R0, MAX_REPS = 1024, 1 << 22


def instances():
    return [(op, c) for op in OPS for c in CHAINS]


def instance_name(op: str, chains: int) -> str:
    return f"{op}x{chains}"


def model_count(op: str, chains: int):
    """The bound model's count of one repetition of one lane."""
    _, steps, per_step = OPS[op]
    return per_step * steps * chains


def _step(kind: str, x, y, k):
    if kind == "iadd3":
        return (x + y + k) & common.M32
    if kind == "lop3":
        return (x | y) ^ k
    if kind == "shf":
        s = k & 31
        return ((x << s) & common.M32) | (y >> (32 - s))
    if kind == "imad":
        return (common.mul_lo32(x, y) + k) & common.M32
    if kind == "imad_hi":
        return (common.mul_hi32(x, y) + k) & common.M32
    raise ValueError(kind)


def _mul_wide_add(u, v, K):
    """(low, high) of u * v + K for 32-bit u, v and a 64-bit (low, high)
    K."""
    lo = common.mul_lo32(u, v) + K[0]
    hi = (common.mul_hi32(u, v) + K[1] + (lo >> 32)) & common.M32
    return lo & common.M32, hi


def probe_issue_plain(op, chains, a, b, reps):
    """Plain version of ``probe_issue``: (8, N) int32 -> (8, N) int32."""
    a64, b64 = u256.to_i64(a), u256.to_i64(b)
    r = [a64[i] for i in range(8)]
    if op == "ffma":
        # x = fma(x, m, k) is exact in f64 here (probe_lanes.cuh), so one
        # rounding to f32 gives the fused result
        m = (0.5 + (b64[0] & 0xFFFF) * 2.0 ** -18).to(torch.float64)
        k = (0.25 + (a64[0] >> 16) * 2.0 ** -18).to(torch.float64)
        for c in range(chains):
            x = (0.25 + (a64[c] & 0xFFFF) * 2.0 ** -18).to(torch.float32)
            for _ in range(2 * reps):
                x = (x.to(torch.float64) * m + k).to(torch.float32)
            r[c] = x.view(torch.int32).to(torch.int64) & common.M32
        return u256.to_i32(torch.stack(r))
    k = a64[1] ^ b64[3]  # the constant every chain shares
    if op == "imad_wide":
        # 64-bit values as (low, high) halves
        K = (k ^ common.M32, k)
        for c in range(chains):
            x, y = (a64[c], b64[c]), (b64[c], a64[c])
            for _ in range(2 * reps):
                x = _mul_wide_add(x[0], y[1], K)
                x, y = y, x
            r[c] = x[0] ^ x[1] ^ y[0] ^ y[1]
        return u256.to_i32(torch.stack(r))
    s0, s1 = {"lop3_imad": ("lop3", "imad"),
              "iadd3_lop3_shf": ("iadd3", "lop3")}.get(op, (op, op))
    for c in range(chains):
        x, y = a64[c], b64[c]
        for _ in range(reps):
            x = _step(s0, x, y, k)
            y = _step(s1, y, x, k)
            if op == "iadd3_lop3_shf":
                x = _step("shf", x, y, k)
        r[c] = x ^ y
    return u256.to_i32(torch.stack(r))


def probe_issue(op, chains, a, b, reps):
    """Kernel ``probe_issue`` (``probes/probes.cu``), one launch; reps a
    multiple of 8.  The plain version for CPU tensors."""
    if op not in OPS or chains not in CHAINS:
        raise ValueError(f"unknown instance {op!r} x {chains}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return probe_issue_plain(op, chains, a, b, reps)
    n = a.shape[1]
    dev = common.check_cuda("probe_issue", [a, b], n, reps, UNROLL)
    out = torch.empty_like(a)
    common.launch("probe_issue", dev, OPS[op][0], chains, a.data_ptr(),
                  b.data_ptr(), out.data_ptr(), n, reps)
    probe_issue.launches += 1
    return out


probe_issue.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.microbench_vpu",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    from vgen_tpu_torch.csrc import build

    n = common.TIMED_N
    n_lat = card.sm_count * 128  # one warp per scheduler
    a, b = (t.to(card.device) for t in common.inputs(n, seed=66))
    tag = card.tag()
    probe_issue("iadd3", 1, a, b, UNROLL)  # builds the probe library
    loops = timing.kernel_loops(str(build.library_path("probes")),
                                "probe_issue")
    print(f"# microbench_vpu: probe_issue at N={n} (rate) and N={n_lat} "
          f"(latency, one chain), cost (t(2R) - t(R)) / R; model rates per "
          f"SM per clock: multiplies {bm.MULS_PER_SM_CLOCK}, ALU-only "
          f"{bm.ALU_PER_SM_CLOCK}, instructions "
          f"{bm.INSTRUCTIONS_PER_SM_CLOCK} {tag}", flush=True)
    errors = []
    with timing.ClockSampler() as clocks:
        for op in OPS:
            code, steps, _ = OPS[op]
            for chains in CHAINS:
                name = instance_name(op, chains)
                sass = timing.opcode_text(loops.get((code, chains), {}),
                                          UNROLL)
                runs = [("rate", a, b, n)]
                if chains == 1:
                    runs.append(("latency", a[:, :n_lat].contiguous(),
                                 b[:, :n_lat].contiguous(), n_lat))
                for what, ta, tb, lanes in runs:
                    res = timing.measure(
                        lambda reps: probe_issue(op, chains, ta, tb, reps), R0,
                        MAX_REPS, clocks)
                    if "error" in res:
                        errors.append(f"{name} {what}")
                        print(f"{name} {what}: MEASUREMENT ERROR {res} {tag}",
                              flush=True)
                        continue
                    clk = res["delta_ms"] * 1e-3 * res["mhz"] * 1e6
                    work = lanes * res["reps"] * steps * chains
                    per_lane = clk * card.sm_count / (lanes * res["reps"])
                    head = (f"{name} {what}: R={res['reps']} "
                            f"delta={res['delta_ms']:.4f} ms (floor "
                            f"{res['floor_ms']:.4f}) at {res['mhz']:.0f} MHz: "
                            f"{per_lane:.3f} SM clocks per lane and "
                            f"repetition, ")
                    if what == "rate":
                        model = bm.sm_clocks(model_count(op, chains))
                        body = (f"{work / (clk * card.sm_count):.2f} results "
                                f"per SM per clock, share {model / per_lane:.2f}"
                                f" of the model's {steps * chains / model:.0f}")
                    else:
                        body = (f"{clk / (res['reps'] * steps):.2f} clocks "
                                f"per dependent step")
                    print(f"{head}{body}; SASS per repetition: {sass} {tag}",
                          flush=True)
    if errors:
        print(f"error: no cost cleared its noise floor for {errors}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
