"""The work the Ethereum kernel roofline counts, frozen.

One Ethereum key costs what no two keys can share: keccak256 of its
64-byte public key x || y, one Keccak-f[1600] permutation of a block whose
lanes 0-7 are data and lanes 8 and 16 the padding, of which the account
(the high half of lane 1 and lanes 2, 3) is read.  The count is that of
the program's bound model (``vgen_tpu_torch/probes/bound_model.py``
``KECCAK``) as it counted when this file was written: 4,161 instructions,
every one ALU-only (three-input XORs, the chi step's LOP3s and the
rotations' funnel shifts on 64-bit lanes split into 32-bit halves).  A
random scan checks six keys a position, the GLV pairs (x, +-y), (x beta,
+-y), (x beta^2, +-y); the key of -y shares with that of +y only the first
round's parity of column 3 (``KECCAK_X_ONLY``: two instructions), so half
of that comes off each key.

That is 4,160 ALU-only instructions a key.  An SM needs at least
max(ALU-only / 64, all / 128) clocks for it: 65.0 SM clocks a key, 6.259
ms for the 25,165,824 keys of a super-step of 8 x 524,288 positions at
132 SMs and 1980 MHz.

The numbers are constants here, not imports of the program, so that a
later change to the hash moves the time and not the count.  Left out, so
the count stays below the whole step's work: the inversion's share
(kernel A), the x-only EC finish and x beta, x beta^2 (kernel B's first
stage), the interval compare, the pack tail, and EIP-55's second hash,
which only the host computes for a match.  A share above 100% means keys
were skipped, or the time left out part of the work.
"""

from __future__ import annotations

from benchmark.work import (ALU_PER_SM_CLOCK, INSTRUCTIONS_PER_SM_CLOCK,
                            SM_CLOCK_HZ, SMS)

# (multiplies, ALU-only, all instructions) of one Keccak-f[1600] of x || y,
# and of what the key of -y shares with that of +y
KECCAK = (0, 4161, 4161)
KECCAK_X_ONLY = (0, 2, 2)


def count_per_key() -> tuple:
    """(multiplies, ALU-only, all) of one key."""
    return tuple(k - s / 2 for k, s in zip(KECCAK, KECCAK_X_ONLY))


def clocks_per_key() -> float:
    """SM clocks one key needs at the least."""
    _, alu, total = count_per_key()
    return max(alu / ALU_PER_SM_CLOCK, total / INSTRUCTIONS_PER_SM_CLOCK)


def roofline_percent(keys: int, kernel_s: float):
    """The least time for ``keys`` keys over the kernels' summed time, in
    percent; None where no kernel ran."""
    if kernel_s <= 0:
        return None
    return 100.0 * keys * clocks_per_key() / (SMS * SM_CLOCK_HZ) / kernel_s
