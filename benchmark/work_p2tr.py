"""The work the P2TR kernel roofline counts, frozen.

One P2TR key costs what no two keys can share: the output key Q = P + t G
with t the TapTweak tagged hash of x(P), so a full fixed-base
multiplication by t per key, which no incremental step or GLV split
serves.  The count is that of kernel F in the program's bound model
(``vgen_tpu_torch/probes/bound_model.py``, the ``p2tr_ladder`` recipe of
``probes/roofline.py``) at the ladder schedule it ships with, 16-bit
signed digits (``fused.LADDER_WINDOW``), as it counted when this file was
written:

- the TapTweak compression of x(P) from the tag's midstate: 888 ALU-only
  of 1,316 instructions, no multiply (``bound_model.TAGGED``);
- 16.499755859375 expected lean Jacobian-affine additions (8M + 3S and
  seven modular adds: 708 multiplies, 1,840 instructions each): 17
  windows of 16-bit signed digits, each of the first 16 nonzero but one
  time in 2^16, the last (the recoding's carry alone) one time in two
  (``roofline.expected_adds(16, True)``);
- the affine finish, 2M + 1S: 188 multiplies, 464 instructions.

That is (multiplies, ALU-only, all) = (11,869.827, 888, 32,139.551) a
key.  An SM needs at least max(multiplies / 32, ALU-only / 64, all / 128)
clocks for it: multiplies bind, 370.932 SM clocks a key, 5.953 ms for the
4,194,304 keys of a super-step of 8 x 524,288 at 132 SMs and 1980 MHz.

The numbers are constants here, not imports of the program, so that a
later change to the schedule moves the time and not the count.  Left
out, so the count stays below the whole step's work: the inversion's
share (kernels A and G), P = base + i G (kernel A's addition), x(Q) of
kernel H, the match, and bech32m.  A share above 100% means keys were
skipped, or the time left out part of the work, or a schedule with fewer
additions has outgrown the frozen count; the last is for a change to the
benchmark to correct.
"""

from __future__ import annotations

from benchmark.work import (ALU_PER_SM_CLOCK, INSTRUCTIONS_PER_SM_CLOCK,
                            SM_CLOCK_HZ, SMS)

LADDER_WINDOW = (16, True)  # (bits, signed) of the schedule counted
# (multiplies, ALU-only, all instructions) of each part, per key
TAGGED = (0, 888, 1316)
LEAN_ADD = (708, 0, 1840)
EXPECTED_ADDS = 16.499755859375
FINISH = (188, 0, 464)

# 32x32 -> 64 multiply-adds an SM completes a clock: each is two of the 64
# 32-bit multiply-adds the CUDA guide gives for compute capability 9.0
MULS_PER_SM_CLOCK = 32
RATES = (MULS_PER_SM_CLOCK, ALU_PER_SM_CLOCK, INSTRUCTIONS_PER_SM_CLOCK)


def count_per_key() -> tuple:
    """(multiplies, ALU-only, all) of one key."""
    return tuple(t + EXPECTED_ADDS * a + f
                 for t, a, f in zip(TAGGED, LEAN_ADD, FINISH))


def clocks_per_key() -> float:
    """SM clocks one key needs at the least."""
    return max(n / r for n, r in zip(count_per_key(), RATES))


def roofline_percent(keys: int, kernel_s: float):
    """The least time for ``keys`` keys over the kernels' summed time, in
    percent; None where no kernel ran."""
    if kernel_s <= 0:
        return None
    return 100.0 * keys * clocks_per_key() / (SMS * SM_CLOCK_HZ) / kernel_s
