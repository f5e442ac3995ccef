"""The parts of the field multiply on the card: kernel ``probe_fieldmul``
and its tool.

    python -m vgen_tpu_torch.probes.microbench_fieldmul

The counterpart of ``scripts/microbench_fieldmul.py`` (its ``make(mode)``
:71, ``pallas_call`` :120), which split the TPU's 16-bit-limb multiply.
Each instance runs R chained repetitions of one part, fed back as
``probe_lanes.cuh`` describes: the production multiply's 8x8 product
``fe_mul_wide`` and its fold ``fe_reduce512`` (both in 32-bit carry
chains, ``mad.lo.cc``/``madc.hi.cc``); the candidates of
``candidates.cuh``: column sums with no carry, their carry pass and the
whole multiply with 64-bit accumulators (``fe_mul_u64``, the product's
before its carry chains); and SHA-256 of a 33-byte key and RIPEMD-160 of
a digest.  The whole ``fe_mul``, the
dedicated squaring and hash160 are ``probe_primitive`` instances
(``roofline.py``), which the tool times beside them.  At N = 524288 lanes
the tool reports SM clocks per lane (at the SM clock sampled while it
ran) beside the bound model's count and its share of it, with the opcode
counts of the kernel's loop from ``cuobjdump -sass``.  It measures the card only: without one it
exits non-zero, and so it does when a delta never clears its noise
floor.
"""

from __future__ import annotations

import argparse
import sys

import torch

from vgen_tpu_torch.ops import field, ripemd160, sha256, u256
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, roofline, timing

# mode: (template code of probe_lanes.cuh FieldMulMode, the model's count
# of one repetition)
MODES = {
    "mul_wide": (0, bm.FE_MUL_WIDE),
    "nocarry": (1, bm.FE_MUL_COLS),
    "fold": (2, bm.FE_FOLD),
    "carry": (3, bm.FE_CARRY_COLS),
    "u64_mul": (4, bm.FE_MUL),
    "sha256": (5, bm.SHA256),
    "ripemd160": (6, bm.RIPEMD160),
}
# the probe_primitive instances the tool times beside the parts
WHOLE = ("fe_mul", "fe_sqr_dedicated", "hash160c")
R0, MAX_REPS = 32, 1 << 16


def mul_cols_nocarry(a: torch.Tensor, b: torch.Tensor):
    """The 16 column sums of a * b with no carry (``candidates.cuh``
    ``fe_mul_cols_nocarry``): 16 (N,) int64 values below 2^36."""
    cols = [torch.zeros_like(a[0]) for _ in range(16)]
    for i in range(8):
        for j in range(8):
            cols[i + j] = cols[i + j] + common.mul_lo32(a[i], b[j])
            cols[i + j + 1] = cols[i + j + 1] + common.mul_hi32(a[i], b[j])
    return cols


def carry_cols(cols):
    """16 columns -> 16 limbs and the carry out (``fe_carry_cols``)."""
    out, c = [], torch.zeros_like(cols[0])
    for col in cols:
        c = c + col
        out.append(c & common.M32)
        c = c >> 32
    return out, c


def fieldmul_out(mode: str, a: torch.Tensor, b: torch.Tensor):
    """The output words of one repetition of ``mode`` (before the fold):
    a, b (8, N) int64."""
    if mode == "u64_mul":
        return list(field.mul(a, b))
    if mode == "mul_wide":
        return list(field.mul_wide(a, b))
    if mode == "nocarry":
        cols = mul_cols_nocarry(a, b)
        return [w for col in cols for w in (col & common.M32, col >> 32)]
    if mode == "fold":
        return list(field.reduce512(torch.cat([a, b])))
    if mode == "carry":
        limbs, c = carry_cols([a[k % 8] + (b[k % 8] << 4) for k in range(16)])
        return limbs + [c]
    if mode == "sha256":
        return sha256.sha256_x33_state(a, 2 + (b[0] & 1))
    if mode == "ripemd160":
        return ripemd160.ripemd160_sha_state_words(list(a))
    raise ValueError(f"unknown mode {mode!r}")


def probe_fieldmul_plain(mode, a, b, reps):
    """Plain version of ``probe_fieldmul``: (8, N) int32 -> (8, N) int32."""
    a64, b64 = u256.to_i64(a), u256.to_i64(b)
    for _ in range(reps):
        a64, b64 = common.feedback(a64, b64, fieldmul_out(mode, a64, b64))
    return u256.to_i32(a64)


def probe_fieldmul(mode, a, b, reps):
    """Kernel ``probe_fieldmul`` (``probes/probes.cu``), one launch; the
    plain version for CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return probe_fieldmul_plain(mode, a, b, reps)
    n = a.shape[1]
    dev = common.check_cuda("probe_fieldmul", [a, b], n, reps)
    out = torch.empty_like(a)
    common.launch("probe_fieldmul", dev, MODES[mode][0], a.data_ptr(),
                  b.data_ptr(), out.data_ptr(), n, reps)
    probe_fieldmul.launches += 1
    return out


probe_fieldmul.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.microbench_fieldmul",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    from vgen_tpu_torch.csrc import build

    n = common.TIMED_N
    a, b = (t.to(card.device) for t in common.inputs(n, seed=120))
    table = roofline.dfa_table().to(card.device)
    tag = card.tag()
    probe_fieldmul("mul_wide", a, b, 1)  # builds the probe library
    library = str(build.library_path("probes"))
    loops = timing.kernel_loops(library, "probe_fieldmul")
    loops_whole = timing.kernel_loops(library, "probe_primitive")
    # (name, run, the model's count, the loop's opcode counts)
    runs = [(mode, lambda reps, m=mode: probe_fieldmul(m, a, b, reps),
             count, loops.get((code,), {}))
            for mode, (code, count) in MODES.items()]
    runs += [(f"{name} (probe_primitive)",
              lambda reps, p=name: roofline.probe_primitive(p, a, b, table,
                                                            reps),
              roofline.PRIMITIVES[name][1],
              loops_whole.get((roofline.PRIMITIVES[name][0],), {}))
             for name in WHOLE]
    print(f"# microbench_fieldmul: probe_fieldmul at N={n}, cost "
          f"(t(2R) - t(R)) / R; model rates per SM per clock: multiplies "
          f"{bm.MULS_PER_SM_CLOCK}, ALU-only {bm.ALU_PER_SM_CLOCK}, "
          f"instructions {bm.INSTRUCTIONS_PER_SM_CLOCK} {tag}", flush=True)
    errors = []
    with timing.ClockSampler() as clocks:
        for name, run, count, loop in runs:
            res = timing.measure(run, R0, MAX_REPS, clocks)
            if "error" in res:
                errors.append(name)
                print(f"{name}: MEASUREMENT ERROR {res} {tag}", flush=True)
                continue
            clk = (res["delta_ms"] * 1e-3 * res["mhz"] * 1e6 * card.sm_count
                   / (res["reps"] * n))
            model = bm.sm_clocks(count)
            print(f"{name}: R={res['reps']} delta={res['delta_ms']:.4f} ms "
                  f"(floor {res['floor_ms']:.4f}) at {res['mhz']:.0f} MHz: "
                  f"{clk:.2f} SM clocks per lane; model (multiplies "
                  f"{count[0]}, ALU-only {count[1]}, instructions {count[2]}) "
                  f"= {model:.2f} clocks, share {model / clk:.2f}; SASS per "
                  f"repetition: {timing.opcode_text(loop)} {tag}", flush=True)
    if errors:
        print(f"error: no cost cleared its noise floor for {errors}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
