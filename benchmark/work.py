"""The work the kernel roofline counts, frozen, and the card's published
rates.

The work of one compressed P2PKH key is what no two keys can share: the
64 rounds of SHA-256 over the 33-byte key and the 160 steps of RIPEMD-160
over its digest.  Each is counted as the program's bound model
(``vgen_tpu_torch/probes/bound_model.py``) counted it when the benchmark
was written: 14 instructions a round, 10 of them ALU-only (the Sigmas'
funnel-shift rotates and three-input XORs, Ch and Maj), and 6 a step, 3 of
them ALU-only.  The message schedule, the EC addition and the inversion
share, the match and the encoding are left out, so the count stays a lower
bound whatever implements it: a share above 100% means hashes were
skipped, or the time left out part of the work.

An SM needs at least max(ALU-only / 64, all / 128) clocks for a count
(the CUDA guide's rates per SM per clock for compute capability 9.0).
"""

from __future__ import annotations

SHA256_ROUNDS = 64
SHA256_ROUND = (10, 14)  # (ALU-only, all) instructions a round
RIPEMD160_STEPS = 160
RIPEMD160_STEP = (3, 6)

ALU_PER_SM_CLOCK = 64
INSTRUCTIONS_PER_SM_CLOCK = 128

# NVIDIA H100 SXM: 132 SMs at a maximum SM clock of 1980 MHz (its data
# sheet; at the 700 W power limit)
SMS = 132
SM_CLOCK_HZ = 1.98e9


def _clocks(rounds: int, per: tuple) -> tuple:
    return rounds * per[0], rounds * per[1]


def clocks_per_key(fmt: str):
    """SM clocks one key needs at the least, or None for a format whose
    work is not frozen here."""
    if fmt != "p2pkh":
        return None
    sha = _clocks(SHA256_ROUNDS, SHA256_ROUND)
    rmd = _clocks(RIPEMD160_STEPS, RIPEMD160_STEP)
    alu, total = sha[0] + rmd[0], sha[1] + rmd[1]
    return max(alu / ALU_PER_SM_CLOCK, total / INSTRUCTIONS_PER_SM_CLOCK)


def peak_keys_per_s(fmt: str):
    c = clocks_per_key(fmt)
    return None if c is None else SMS * SM_CLOCK_HZ / c


def roofline_percent(fmt: str, keys: int, kernel_s: float):
    """The least time for ``keys`` keys over the kernels' summed time, in
    percent; None where the format's work is not frozen or no kernel ran."""
    peak = peak_keys_per_s(fmt)
    if peak is None or kernel_s <= 0:
        return None
    return 100.0 * keys / peak / kernel_s
