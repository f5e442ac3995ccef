"""The bound model of ``chip_smoke.py``'s ``bound_ms`` and of the probe
tools: per-lane instruction counts of each primitive, the fewest the
algorithm needs, and the card's rates per SM per clock.

A count is (multiplies, ALU-only instructions, all instructions):

- a multiply is a 32x32 -> 64 multiply-add (IMAD.WIDE);
- an ALU-only instruction is one with no form on the multiply-add pipe: a
  three-input logic op (LOP3) or a funnel-shift rotate (SHF).  Adds,
  plain shifts (IMAD.SHL, IMAD.HI by a power of two), selects and byte
  permutes are left out, so the count stays a lower bound;
- all instructions counts each of those once.

An SM then needs at least max(multiplies / MULS, ALU-only / ALU, all /
INSTRUCTIONS) clocks for the work, at the rates below; a kernel's bound
is that over the SMs at the maximum SM clock, or its bytes over the
memory rate, whichever is larger.  The rates are the card's published
ones, not readings of the probes (which report their share of them):

- all instructions 128 lane results per SM per clock: four schedulers,
  each issuing one warp instruction a clock (the CUDA guide's 128
  float32 multiply-adds per SM per clock for compute capability 9.0; 67
  TFLOP/s at 132 SMs and 1980 MHz);
- ALU-only 64: the CUDA guide's 32-bit integer shift, compare and
  bitwise rate for compute capability 9.0, the pipe LOP3 and SHF run on;
- multiplies 32: the guide gives 64 32-bit integer multiply-adds per SM
  per clock, and a 32x32 -> 64 multiply-add yields two 32-bit results
  (PTX's mul.lo and mul.hi), so it counts as two.

The counts, per lane:

- field multiply: 64 partial products (a multiply-add and a carry add
  each), the fold of the high half by 977 (8 more), the fold's one-limb
  shift (8 adds) and a 16-op conditional subtract of p;
- field squaring: 36 distinct partial products, the 28 cross products
  doubled by a 16-op shift, then the same fold and subtract: what the
  product's ``fe_sqr`` does (the ``fe_sqr`` probe times ``fe_mul(a, a)``,
  for which this count is a lower bound too);
- modular add or subtract: 8 carrying adds and 8 for the fix-up;
- SHA-256 compression (``sha256_ops``): 64 rounds of 14 (per Sigma three
  funnel-shift rotates and one three-input XOR, one LOP3 each for Ch and
  Maj, four three-input adds) and 48 schedule words of 10 (per sigma two
  rotates, a shift and a XOR), counted term by term: a sigma of a
  constant word costs nothing, constant terms of a sum fold into one, a
  schedule word of constant terms is a constant, and so are the Ch, Maj
  and Sigmas of a constant initial state;
- RIPEMD-160 of a 32-byte digest: 160 steps of 6 (a LOP3, two rotates,
  three adds), one add fewer in the 80 steps on constant padding words,
  10 for the final combination and 8 byte swaps;
- Keccak-f[1600] (``keccak_ops``): 24 rounds on 64-bit lanes as 32-bit
  halves, all of it LOP3 and rotates: theta's five column parities (two
  three-input XORs per half, 20), five rotates by one (two funnel
  shifts, 10) and the 25 lanes' XOR with two terms (one LOP3 per half,
  50); rho's 24 rotates (48); chi (one LOP3 per half, 50); iota (2).  The
  first round's parities skip the zero lanes of the absorbed block, whose
  theta results a column shares; the last round computes only the
  output's halves and the five lanes that chi reads for them;
- inversion: 255 squarings and 15 multiplies; by divsteps (kernels A
  and G's groups): 20 rounds of 30 steps of 20 ALU instructions (the
  masks, three conditional adds, the swap and the shifts), and a round's
  matrix applied to (f, g) and (d, e) in 72 multiply-adds (a lower count:
  9 limbs of 4 and 4, and p's three nonzero limbs);
- a DFA step: the index's multiply-add and the load, from the read-only
  cache or from shared memory;
- kernel D's Base58Check walk (``B58_WALK``): the checksum, the 49
  divisions, 34 compares for the leading-zero count, 34 digit splits and
  the 35 steps;
- kernel I's bech32m walk (``BECH32M_WALK``): the checksum as 52 table
  lookups of the program's five-bit groups (``BECH32M_CHECKSUM``), the
  checksum's 6 groups and the 60 steps;
- an interval compare of W words against S slots: a subtract with borrow
  per word against lo and against hi, and one combine, per slot;
- the column form of the multiply: the 8x8 product's halves into 16
  columns with no carry, a carry pass, then the fold;
- a step of a row chain: an add, a rotate and a XOR, or one 32-bit
  multiply-add (IMAD, not a 32x32 -> 64 one).
"""

from __future__ import annotations

import numpy as np

# SM rates per clock, lane results: 32x32 -> 64 multiply-adds, ALU-only
# instructions, and all instructions (the published figures above)
MULS_PER_SM_CLOCK = 32
ALU_PER_SM_CLOCK = 64
INSTRUCTIONS_PER_SM_CLOCK = 128
HBM_BYTES_PER_S = 3.35e12


def ops(muls=0, alu=0, instructions=0) -> np.ndarray:
    return np.array([muls, alu, instructions])


FE_MUL = ops(64 + 8, 0, 2 * 64 + 2 * 8 + 8 + 16)
FE_SQR = ops(36 + 8, 0, 2 * 36 + 16 + 2 * 8 + 8 + 16)
FE_ADD = ops(0, 0, 16)
# the parts of the field multiply: the 8x8 product (a multiply-add and a
# carry add per partial product) and the fold with its subtract of p
FE_MUL_WIDE = ops(64, 0, 2 * 64)
FE_FOLD = FE_MUL - FE_MUL_WIDE
# the column form of the multiply (candidates.cuh): the 64 products'
# halves summed into 16 columns with no carry (a multiply-add and two
# adds each), one carry pass (two per column), the production fold
FE_MUL_COLS = ops(64, 0, 64 + 2 * 64)
FE_CARRY_COLS = ops(0, 0, 2 * 16)
FE_MUL_COLSUM = FE_MUL_COLS + FE_CARRY_COLS + FE_FOLD
# kernel B's x-only finish: lambda = (ty - by) inv, x = lambda^2 - bx - tx
# (one multiply, one squaring, four subtractions)
FINISH_X = FE_MUL + FE_SQR + 4 * FE_ADD
# the row chains' steps: (r + x) ^ rotl(r, 7) as IADD3, SHF and LOP3 (the
# rotate and the XOR ALU-only), r * x + 1 as one 32-bit IMAD
ROW_STEP = ops(0, 2, 3)
ROW_MUL_STEP = ops(0, 0, 1)


def _adds(operands):
    """Three-input adds (or XORs) that sum ``operands`` values."""
    return operands // 2


def _sum(variables, constant):
    return _adds(variables + constant) if variables else 0


def sha256_ops(const_words, const_state=True, shared=0) -> np.ndarray:
    """Count of one SHA-256 compression whose message words
    ``const_words`` (padding, length) and, with ``const_state``, whose
    initial state are constants.  The first ``shared`` rounds, and the
    sigma0 of their words, are those of a compression already counted
    (the same leading words under the same state)."""
    var = [j not in const_words for j in range(16)]
    alu = n = 0
    for t in range(16, 64):
        a, b, c, d = var[t - 2], var[t - 7], var[t - 15], var[t - 16]
        terms = a + b + c + d
        s0 = c and t - 15 >= shared
        n += 4 * a + 4 * s0 + _sum(terms, terms < 4)
        alu += 3 * a + 3 * s0  # two rotates and a XOR per sigma
        var.append(terms > 0)
    st = [not const_state] * 8
    for t in range(64):
        a, b, c, d, e, f, g, h = st
        ch, maj = e or f or g, a or b or c
        t1 = h + e + ch + var[t]
        e2, a2 = d + (t1 > 0), (t1 > 0) + a + maj
        if t >= shared:
            alu += 4 * e + ch + 4 * a + maj
            n += (4 * e + ch + 4 * a + maj + _sum(t1, 1) + _sum(e2, e2 < 2)
                  + _sum(a2, a2 < 3))
        st = [a2 > 0, a, b, c, e2 > 0, e, f, g]
    return ops(0, alu, n)


def sha256_msg(nbytes) -> np.ndarray:
    """One compression of an ``nbytes``-byte message (< 56) from the
    standard initial state: the words past its data are constants."""
    return sha256_ops(range(-(-nbytes // 4), 16))


def keccak_ops(var_lanes, const_lanes, out_halves, out_lane0) -> np.ndarray:
    """Count of Keccak-f[1600] on a block whose lanes ``var_lanes`` are
    data and ``const_lanes`` nonzero constants (padding; the rest zero),
    when the caller reads ``out_halves`` 32-bit halves of the first plane,
    lane 0 among them if ``out_lane0`` (its iota).  Every instruction is
    ALU-only."""
    rnd = 20 + 10 + 50 + 48 + 50 + 2
    first = 10 + 48 + 50 + 2
    for x in range(5):
        col = [x + 5 * y for y in range(5)]
        nv = sum(lane in var_lanes for lane in col)
        nc = sum(lane in const_lanes for lane in col)
        first += 2 * _adds(nv + (nc > 0)) + 2 * (nv + nc + (nv + nc < 5))
    last = 20 + 10 + 10 + 8 + out_halves + 2 * out_lane0
    n = first + 22 * rnd + last
    return ops(0, n, n)


# the 33-byte compressed key's hash160: its compression, then RIPEMD-160
SHA256 = sha256_msg(33)
RIPEMD160 = ops(0, 160 * 3, 160 * 6 - 80 + 10 + 8)
HASH160 = SHA256 + RIPEMD160
INV = 255 * FE_SQR + 15 * FE_MUL
INV_DIVSTEPS = 20 * (30 * ops(0, 20, 20) + ops(72, 0, 2 * 72))
# hash160 of 04 || x || y: a 64-byte block, then one of y's last byte and
# padding from the first block's state; the P2SH-P2WPKH redeem script
# 00 14 || hash160 (22 bytes) through SHA-256 and RIPEMD-160
SHA256_X65 = sha256_ops(()) + sha256_ops(range(1, 16), const_state=False)
SCRIPT_HASH = sha256_msg(22) + RIPEMD160
# The first block of 04 || x || y holds x's words 0-7 only, so the key of
# -y shares the first eight rounds with the key of +y
SHA256_X65_PAIR = (SHA256_X65 + sha256_ops((), shared=8)
                   + sha256_ops(range(1, 16), const_state=False))
# keccak256(x || y): lanes 0-7 data, the pads in lanes 8 and 16; the
# account is the high half of lane 1 and lanes 2, 3
KECCAK = keccak_ops(range(8), (8, 16), 5, False)
# what the key of -y shares with that of +y: the first round's parity of
# column 3 (x's lane 3 and the pad), one three-input XOR per half
KECCAK_X_ONLY = ops(0, 2, 2)
# EIP-55's keccak256 of 40 hex bytes: lanes 0-4 data, pads in lanes 5 and
# 16; the 40 checksum nibbles are lanes 0, 1 and the low half of lane 2
KECCAK_EIP55 = keccak_ops(range(5), (5, 16), 5, True)
# Base58Check's checksum: SHA-256 of the 21-byte payload, then of its digest
B58_CHECKSUM = sha256_msg(21) + sha256_msg(32)
# Base58Check symbols of a 21-byte payload: the checksum, 49 64-bit
# divisions by 58^5 (8 each) and 35 digit splits (5)
B58_SYMBOLS = B58_CHECKSUM + ops(0, 0, 49 * 8 + 35 * 5)
# EIP-55 symbols: the nibbles' ASCII (4 each), the second Keccak-f and
# the casing (3 each)
EIP55_SYMBOLS = KECCAK_EIP55 + ops(0, 0, 40 * (4 + 3))
DFA_STEP = ops(1, 0, 2)
# kernel D's register form of Base58Check (csrc/dfa.cuh base58check_walk):
# the checksum, the 49 divisions and 34 compares of the leading-zero count
# (base58check_limbs), 34 digit splits as the walk takes them (5 each) and
# 35 steps (34 - shift symbols, the end of the string, shift paddings)
B58_LIMBS = ops(0, 0, 49 * 8 + 34)
B58_WALK = B58_CHECKSUM + B58_LIMBS + ops(0, 0, 34 * 5) + 35 * DFA_STEP
# the TapTweak tagged hash: one compression of x from the tag's midstate
TAGGED = sha256_ops(range(8, 16))
# one lean Jacobian add (8M + 3S): six subtractions and 2V as an addition
LEAN_ADD = 8 * FE_MUL + 3 * FE_SQR + 7 * FE_ADD
# bech32m's checksum of a P2TR key as kernel I computes it
# (csrc/encode.cuh bech32m_p2tr_checksum: the polymod is linear, so the
# checksum is a XOR of one table entry per group): the program's 52
# five-bit groups (a funnel shift and a mask, ALU-only), a load each, and
# their XOR as three-input XORs (the constant folded in)
BECH32M_CHECKSUM = ops(0, 52 * 2 + 26, 52 * 2 + 52 + 26)
# kernel I's walk (csrc/dfa.cuh bech32m_p2tr_walk): the checksum, its 6
# groups (a shift and a mask) and 60 steps (the witness version, 52
# groups, 6 checksum symbols, the end of the string)
BECH32M_WALK = BECH32M_CHECKSUM + ops(0, 12, 12) + 60 * DFA_STEP
# kernels H and I's output key x: qx = X * zi^2
P2TR_QX = FE_MUL + FE_SQR
# bech32 of a P2WPKH key: 38 five-bit groups (2 each: the program's 32 and
# the checksum's 6) and 38 polymod steps on them (12 each: shift, mask,
# the symbol's XOR and five conditional XORs of 2, the XORs ALU-only; the
# human-readable part and the witness version fold to constants)
BECH32 = ops(0, 38 * 6, 38 * (2 + 12))
# the full affine finish of kernels C and D: lambda = (ty - by) inv, x =
# lambda^2 - bx - tx, y = lambda (bx - x) - by
FINISH_XY = 2 * FE_MUL + FE_SQR + 6 * FE_ADD


def compare(slots, words) -> np.ndarray:
    return ops(0, 0, slots * (2 * words + 1))


def sm_clocks(count) -> float:
    """SM clocks one lane's ``count`` needs at the model's rates."""
    return max(count[0] / MULS_PER_SM_CLOCK, count[1] / ALU_PER_SM_CLOCK,
               count[2] / INSTRUCTIONS_PER_SM_CLOCK)


def bound(count, nbytes, sm_clocks_per_s):
    """(bound_ms, bound_by): the larger of the instructions' time on the
    SMs (``sm_clocks_per_s``: SMs x clock) for a total ``count`` and
    ``nbytes`` bytes over the memory rate."""
    t_ops = sm_clocks(count) / sm_clocks_per_s
    t_mem = nbytes / HBM_BYTES_PER_S
    return float(max(t_ops, t_mem) * 1e3), ("operations" if t_ops >= t_mem
                                            else "bytes")
