"""Kernels C and D split by stage on the card: kernel ``probe_single_key``
and its tool.

    python -m vgen_tpu_torch.probes.profile_dfa

No TPU script has this split; it is ``profile_glv``'s for the single-key
kernels of range scans.  At the scan's shape (K = 8 windows of B = 524288
lanes: the i*G table, eight base points from a numpy seed, the inverses
from kernel A) it times kernel D's P2PKH lane over the product's tiles
(one tile of 256 lanes per block) cut after each stage (lane e of window
k, 0 where dx == 0 or b >= remaining[k]; each mode returns a word of its
stage, so nothing before the cut is dead code):

- ``finish``: the full affine add; the XOR of x's and y's 16 words;
- ``value``: the hash160 of the compressed key; the XOR of its 5 words;
- ``checksum``: the Base58Check checksum word (two SHA-256 compressions);
- ``symbols``: the base conversion (7 rounds of division by 58^5) and the
  leading-zero shift (``base58check_limbs``); the XOR of the 7 limbs and
  the shift << 26;

then the whole kernels as the product does not run them: C (``^1C``) and
D (P2PKH) over the persistent tile loop, reading their rows from device
memory (``c_persistent``, ``d_persistent``) or from the stage buffer that
``cp.async`` fills under the hashing (``c_prefetch``, ``d_prefetch``); D
one tile per block with the symbols in a per-thread array (kernel E's
walk, ``d_arrays``); and C and D on the per-lane grid (``c_lane``,
``d_lane``: one thread per lane over N / 256 blocks, dividing by B, D's
symbols in a per-thread array).  The walk itself is timed through the
product's wrapper ``fused.dfa_match`` in both table forms ("shared": the
narrow table in shared memory; "global": the int32 table through the
read-only cache), in turns, on the product's pattern ``[Cc]at`` and on
random DFAs of 16 to 128 states, of the most states the shared form
holds, and of more than it holds (global only): the sweep that places the
budget.  The narrow tables are built before any timing, as the scanner
builds them once per pattern.  Every D output is held bit-equal to the
product's, every C output to ``fused.range_match``.  It prints each
mode's ms, its bound (``stage_count``) and share, the stage differences
(finish, hash160, checksum, base conversion, walk, compare), the
occupancy of each form, and the ptxas figures of each instance; then, for
every hash format, five alternating rounds of the product's C and D
against the per-lane grid's, D's two table forms and D with symbol
arrays, with their medians.  It measures the card only: without one it
exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.ops import encode, fused, pipeline, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, timing
from vgen_tpu_torch.scan import tables

P2PKH = AddressFormat.P2PKH
# mode: template code of single_key_lanes.cuh SingleKeyMode
MODES = {m: code for code, m in enumerate((
    "finish", "value", "checksum", "symbols", "c_persistent", "c_prefetch",
    "d_persistent", "d_prefetch", "d_arrays", "c_lane", "d_lane"))}
STAGES = ("finish", "value", "checksum", "symbols")
C_MODES = ("c_persistent", "c_prefetch", "c_lane")
D_MODES = ("d_persistent", "d_prefetch", "d_arrays", "d_lane")
# the modes that take any hash format (the others P2PKH alone)
ANY_FORMAT = ("d_arrays", "c_lane", "d_lane")
# D's modes that take the narrow table in shared memory
D_SHARED = D_MODES[:-1]
K, B = 8, common.TIMED_N
BASE_SEED = 165
INTERVAL_PATTERN, DFA_PATTERN = "^1C", "[Cc]at"
B58_WIDTH = pipeline.FORMAT_DFA_WIDTH[P2PKH]
# random DFAs of the walk's timing: 16 to 128 states, the most the shared
# budget holds at width 60, and more than it holds
BUDGET_STATES = fused.DFA_SHARED_MAX // (2 * B58_WIDTH + 1)
RANDOM_STATES = (16, 64, 128, BUDGET_STATES, 4 * BUDGET_STATES)
B58_POW5 = 58 ** 5
# (interval pattern, DFA pattern) of each hash format's turns
TURN_PATTERNS = {
    P2PKH: (INTERVAL_PATTERN, DFA_PATTERN),
    AddressFormat.P2WPKH: ("^bc1qq", DFA_PATTERN),
    AddressFormat.P2SH_P2WPKH: ("^3A", DFA_PATTERN),
    AddressFormat.P2PKH_UNCOMPRESSED: ("^1A", DFA_PATTERN),
    AddressFormat.ETHEREUM: ("^0x1", "[Dd][Ee][Aa][Dd]")}


def stage_count(mode: str, n_slots: int = 8):
    """The bound model's count of one lane of ``mode``: the full finish,
    then its stages; C's and D's modes the kernels' counts."""
    count = bm.FINISH_XY
    if mode == "finish":
        return count
    count = count + bm.HASH160
    if mode in C_MODES:
        return count + bm.compare(n_slots, 5)
    if mode == "value":
        return count
    count = count + bm.B58_CHECKSUM
    if mode == "checksum":
        return count
    if mode == "symbols":
        return count + bm.B58_LIMBS
    if mode in ("d_lane", "d_arrays"):
        return count - bm.B58_CHECKSUM + bm.B58_SYMBOLS + 35 * bm.DFA_STEP
    return count - bm.B58_CHECKSUM + bm.B58_WALK


def stage_nbytes(mode: str, n_slots: int, table_bytes: int) -> int:
    """Bytes read and written once: the bases, the table, the inverses,
    remaining, the (K, B) int32 output, and the intervals or the DFA."""
    n = 64 * K + 64 * B + 32 * K * B + 4 * K + 4 * K * B
    if mode in C_MODES:
        return n + 40 * n_slots
    return n + (table_bytes if mode in D_MODES else 0)


def inputs(device, seed: int = BASE_SEED):
    """(bx, by, tx, ty, inv, remaining) of K full windows of B lanes on
    ``device``: eight random base scalars from ``seed``, inv from kernel A
    (its plain version on the CPU)."""
    rng = np.random.default_rng(seed)
    scalars = [int(rng.integers(1 << 40, 1 << 62)) for _ in range(K)]
    return window_inputs(scalars, [B] * K, B, device)


def window_inputs(scalars, remaining, batch, device):
    """(bx, by, tx, ty, inv, remaining) of the windows based at
    ``scalars`` (window k: keys scalars[k] + 1 ...) of ``batch`` lanes."""
    pts = [ec.scalar_mult(s) for s in scalars]
    bx = u256.as_i32(u256.from_ints([p[0] for p in pts]).T.copy())
    by = u256.as_i32(u256.from_ints([p[1] for p in pts]).T.copy())
    dev = torch.device(device)
    tx, ty = tables.ig_table(batch, dev)
    bx, by = bx.to(dev), by.to(dev)
    inv = fused.batch_inverse_dx(bx, tx)
    rem = torch.tensor(remaining, dtype=torch.int32, device=dev)
    return bx, by, tx, ty, inv, rem


def intervals(device, fmt=P2PKH, src=INTERVAL_PATTERN):
    """(lo, hi) int32 of an interval pattern, padded as the scanner pads."""
    ivs = Pattern(src).match_intervals(fmt)
    lo, hi = pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs)))
    return u256.as_i32(lo).to(device), u256.as_i32(hi).to(device)


def pattern_dfa(src: str, fmt=P2PKH, device="cpu"):
    """(table, accept, start) int32 of a pattern's DFA for ``fmt``."""
    dfa = Pattern(src).device_dfa(fmt)
    return (torch.from_numpy(dfa.table.astype(np.int32)).to(device),
            torch.from_numpy(dfa.accept.astype(np.int32)).to(device),
            int(dfa.start))


def random_dfa(n_states: int, width: int = B58_WIDTH, seed: int = 60,
               device="cpu"):
    """(table, accept, start) of a random DFA of ``n_states`` states: every
    entry uniform, half the states accepting, start 0."""
    rng = np.random.default_rng(seed + n_states)
    table = rng.integers(0, n_states, size=(n_states, width), dtype=np.int32)
    accept = rng.integers(0, 2, size=n_states, dtype=np.int32)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(accept).to(device), 0)


def base58_limbs_plain(version: int, words):
    """The seven base-58^5 limbs of Base58Check's payload, least
    significant first: words, 5 (N,) int64 hash160 words."""
    n = ([torch.full_like(words[0], version)] + list(words)
         + [encode.base58check_checksum_word(version, words)])
    limbs = []
    for _ in range(7):
        rem = torch.zeros_like(n[0])
        for i in range(7):
            cur = (rem << 32) | n[i]
            n[i] = cur // B58_POW5
            rem = cur - n[i] * B58_POW5
        limbs.append(rem)
    return limbs


def _stage_words(mode, bx, by, tx, ty, inv, remaining):
    x3, y3, valid = fused._full_finish(bx, by, tx, ty, inv, remaining)
    if mode == "finish":
        w = torch.zeros_like(x3[0])
        for i in range(8):
            w = w ^ x3[i] ^ y3[i]
        return w, valid
    h = pipeline.interval_value_words(P2PKH, x3, y3)
    if mode == "value":
        return h[0] ^ h[1] ^ h[2] ^ h[3] ^ h[4], valid
    if mode == "checksum":
        return encode.base58check_checksum_word(0, h), valid
    _, length = encode.base58check_symbols(0, h)
    w = (encode.BASE58_SYMS - length) << 26
    for limb in base58_limbs_plain(0, h):
        w = w ^ limb
    return w, valid


def _check_mode(mode, fmt):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if fmt not in fused.FMT_CODE or (fmt != P2PKH and mode not in ANY_FORMAT):
        raise ValueError(f"probe_single_key: {mode} takes P2PKH (the modes "
                         f"{', '.join(ANY_FORMAT)} any hash format), not "
                         f"{fmt.value}")


def single_key_plain(mode, bx, by, tx, ty, inv, lo, hi, dfa_table,
                     dfa_accept, start, remaining, fmt=P2PKH):
    """Plain version of ``probe_single_key``: kernel C's and D's arguments
    (D's int32 table) -> the (K, B) int32 output of ``mode``: the stage's
    word, or C's or D's 0/1 for ``fmt``."""
    _check_mode(mode, fmt)
    if mode in C_MODES:
        return fused.range_match_plain(fmt, bx, by, tx, ty, inv, lo, hi,
                                       remaining)
    if mode in D_MODES:
        return fused.dfa_match_plain(fmt, bx, by, tx, ty, inv, dfa_table,
                                     dfa_accept, start, remaining)
    w, valid = _stage_words(mode, bx, by, tx, ty, inv, remaining)
    return u256.to_i32(torch.where(valid, w & 0xFFFFFFFF, 0))


def probe_single_key(mode, bx, by, tx, ty, inv, lo, hi, dfa_table,
                     dfa_accept, start, remaining, fmt=P2PKH, form="shared",
                     narrow=None):
    """Kernel ``probe_single_key`` (``probes/probes.cu``), one launch for
    all K*B lanes; the plain version for CPU tensors.  D's tile modes take
    the table ``form`` ("shared" must fit ``fused.DFA_SHARED_MAX``; it
    reads ``narrow``, the table's ``fused.narrow_dfa``, or builds it), the
    per-lane D the int32 table."""
    _check_mode(mode, fmt)
    args = (bx, by, tx, ty, inv, lo, hi, dfa_table, dfa_accept, start,
            remaining)
    tensors = args[:9] + args[10:]
    if all(t.device.type == "cpu" for t in tensors):
        return single_key_plain(mode, *args, fmt=fmt)
    Kk, Bb = bx.shape[0], tx.shape[1]
    S, W = dfa_table.shape
    dev = fused._interval_specs("probe_single_key", bx, by, tx, ty, inv, lo,
                                hi, remaining)
    fused._check_cuda("probe_single_key", [
        ("dfa_table", dfa_table, (S, W)), ("dfa_accept", dfa_accept, (S,))])
    if W != pipeline.FORMAT_DFA_WIDTH[fmt]:
        raise ValueError(f"probe_single_key: DFA width {W}, expected "
                         f"{pipeline.FORMAT_DFA_WIDTH[fmt]}")
    table, accept = dfa_table, dfa_accept
    if form not in fused.DFA_FORMS:
        raise ValueError(f"probe_single_key: table form {form!r}")
    shared = mode in D_SHARED and form == "shared"
    if shared:
        if S * (2 * W + 1) > fused.DFA_SHARED_MAX:
            raise ValueError(f"probe_single_key: {mode} takes a table within "
                             f"{fused.DFA_SHARED_MAX} bytes")
        table, accept = (narrow if narrow is not None
                         else fused.narrow_dfa(dfa_table, dfa_accept))
    out = torch.empty((Kk, Bb), dtype=torch.int32, device=dev)
    common.launch("probe_single_key", dev, MODES[mode], fused.FMT_CODE[fmt],
                  int(shared),
                  *(t.data_ptr() for t in (bx, by, tx, ty, inv, lo, hi)),
                  lo.shape[0], table.data_ptr(), accept.data_ptr(), S, W,
                  int(start), remaining.data_ptr(), out.data_ptr(), Kk, Bb)
    probe_single_key.launches += 1
    return out


probe_single_key.launches = 0


def blocks_per_sm(form: str, table_bytes: int = 0) -> int:
    """Blocks of 256 threads of the product's kernel D (P2PKH) in table
    ``form`` resident per SM (the occupancy API), the shared form at a
    table of ``table_bytes``: what the shared-memory budget costs."""
    from vgen_tpu_torch.csrc import build

    if form not in fused.DFA_FORMS:
        raise ValueError(f"table form {form!r}, expected one of "
                         f"{fused.DFA_FORMS}")
    rc = build.load("probes").vgen_probe_dfa_blocks_per_sm(
        int(form == "shared"), table_bytes)
    if rc < 0:
        raise RuntimeError(f"kernel D occupancy query failed, cudaError "
                           f"{-rc}")
    return rc


def _shared_fits(table) -> bool:
    S, W = table.shape
    return S * (2 * W + 1) <= fused.DFA_SHARED_MAX


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.profile_dfa",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    from vgen_tpu_torch.csrc import build

    tag, dev = card.tag(), card.device
    lanes = inputs(dev)
    bx, by, tx, ty, inv, rem = lanes
    lo, hi = intervals(dev)
    n_slots = lo.shape[0]
    dfa = pattern_dfa(DFA_PATTERN, device=dev)
    nar = fused.narrow_dfa(*dfa[:2])  # once, as the scanner builds it
    table_bytes = dfa[0].shape[0] * (2 * B58_WIDTH + 1)
    margs = (lo, hi) + dfa + (rem,)
    probe_single_key("finish", *lanes[:5], *margs)  # builds the probe unit
    fused.range_match(P2PKH, *lanes[:5], lo, hi, rem)  # and the product's
    log = build.build_log(("probes",)) + build.build_log(("kernels",))
    print(f"# profile_dfa: K={K} windows of B={B} lanes, pattern "
          f"{INTERVAL_PATTERN} ({n_slots} slots) for C, {DFA_PATTERN} "
          f"({dfa[0].shape[0]} states) for D; ms per launch, best of five "
          f"means of 10 {tag}", flush=True)
    ref_c = fused.range_match(P2PKH, *lanes[:5], lo, hi, rem)
    ref_d = fused.dfa_match(P2PKH, *lanes[:5], *dfa, rem, narrow=nar)
    ms = {"A": timing.launch_ms(lambda: fused.batch_inverse_dx(bx, tx))}
    print(f"kernel A (batch_inverse_dx): {ms['A']:.4f} ms {tag}", flush=True)
    ptx_stage = timing.ptxas_figures(log, "probe_single_key")
    for mode in MODES:
        out = probe_single_key(mode, *lanes[:5], *margs, narrow=nar)
        ref = ref_c if mode in C_MODES else ref_d if mode in D_MODES else None
        if ref is not None and not torch.equal(out, ref):
            print(f"error: {mode} differs from the product's kernel",
                  file=sys.stderr)
            return 1
        ms[mode] = timing.launch_ms(lambda m=mode: probe_single_key(
            m, *lanes[:5], *margs, narrow=nar))
        bms, bby = bm.bound(K * B * stage_count(mode, n_slots),
                            stage_nbytes(mode, n_slots, table_bytes),
                            card.sm_clocks_per_s)
        fig = ptx_stage.get((MODES[mode],)) if mode in STAGES else None
        print(f"{mode}: {ms[mode]:.4f} ms, {K * B / ms[mode] / 1e3:.1f} M "
              f"lanes/s, bound {bms:.4f} ms ({bby}, share "
              f"{bms / ms[mode]:.2f})"
              + (f"; ptxas {timing.ptxas_text(fig)}" if mode in STAGES
                 else "") + f" {tag}", flush=True)
    # the walk in both table forms, through the product's wrapper, each
    # narrow table built before the timing
    walks = [(DFA_PATTERN, dfa)] + [
        (f"random {s} states", random_dfa(s, device=dev))
        for s in RANDOM_STATES]
    for what, d in walks:
        S = d[0].shape[0]
        forms = ("shared", "global") if _shared_fits(d[0]) else ("global",)
        nar_d = fused.narrow_dfa(*d[:2]) if len(forms) == 2 else None
        outs = {form: fused.dfa_match(P2PKH, *lanes[:5], *d, rem, form=form,
                                      narrow=nar_d) for form in forms}
        med = timing.in_turns({f"dfa_match[{form}] on {what}": (
            lambda f=form: fused.dfa_match(P2PKH, *lanes[:5], *d, rem,
                                           form=f, narrow=nar_d))
            for form in forms}, tag)
        for form in forms:
            t = ms[f"{form} {what}"] = med[f"dfa_match[{form}] on {what}"]
            tb = (S * (2 * B58_WIDTH + 1) if form == "shared"
                  else 4 * S * (B58_WIDTH + 1))
            bms, bby = bm.bound(K * B * stage_count("d_prefetch"),
                                stage_nbytes("d_prefetch", 0, tb),
                                card.sm_clocks_per_s)
            print(f"dfa_match[{form}] on {what} ({S} states, {tb} table "
                  f"bytes, {blocks_per_sm(form, tb)} blocks per SM): median "
                  f"{t:.4f} ms, bound {bms:.4f} ms ({bby}, share "
                  f"{bms / t:.2f}), walk (less symbols) "
                  f"{t - ms['symbols']:.4f} ms {tag}", flush=True)
        if len(forms) == 2:
            print(f"# {what}: shared / global "
                  f"{ms[f'shared {what}'] / ms[f'global {what}']:.4f} {tag}",
                  flush=True)
            if not torch.equal(outs["shared"], outs["global"]):
                print(f"error: the two table forms differ on {what}",
                      file=sys.stderr)
                return 1
    for kernel, names in (("dfa_tile_kernel", ("fmt", "shared")),
                          ("range_tile_kernel", ("fmt",)),
                          ("probe_dfa_tiles", ("fmt", "schedule", "arrays",
                                               "shared")),
                          ("probe_range_tiles", ("schedule",))):
        for args, fig in sorted(timing.ptxas_figures(log, kernel).items()):
            print(f"ptxas {kernel}<" + ", ".join(
                f"{n} {v}" for n, v in zip(names, args))
                + f">: {timing.ptxas_text(fig)}", flush=True)
    # for every hash format: the product's C and D against the per-lane
    # grid's, D in both table forms and with symbol arrays, in turns
    turns, product_form = {}, {}
    for fmt, (iv_src, dfa_src) in TURN_PATTERNS.items():
        lo_f, hi_f = intervals(dev, fmt, iv_src)
        dfa_f = pattern_dfa(dfa_src, fmt, dev)
        nar_f = fused.narrow_dfa(*dfa_f[:2])
        m_f = (lo_f, hi_f) + dfa_f + (rem,)
        form_f = product_form[fmt] = fused.dfa_form(*dfa_f[0].shape)
        turns.update({
            f"C {fmt.value}": lambda f=fmt, lo_f=lo_f, hi_f=hi_f:
                fused.range_match(f, *lanes[:5], lo_f, hi_f, rem),
            f"C lane {fmt.value}": lambda f=fmt, m_f=m_f: probe_single_key(
                "c_lane", *lanes[:5], *m_f, fmt=f),
            f"D lane {fmt.value}": lambda f=fmt, m_f=m_f: probe_single_key(
                "d_lane", *lanes[:5], *m_f, fmt=f),
            f"d_arrays {fmt.value}": (
                lambda f=fmt, m_f=m_f, n=nar_f, form=form_f: probe_single_key(
                    "d_arrays", *lanes[:5], *m_f, fmt=f, form=form,
                    narrow=n))})
        turns.update({f"D {form} {fmt.value}": (
            lambda f=fmt, d=dfa_f, n=nar_f, form=form: fused.dfa_match(
                f, *lanes[:5], *d, rem, form=form, narrow=n))
            for form in fused.DFA_FORMS})
    med = timing.in_turns(turns, tag)

    def product_d(f):
        return med[f"D {product_form[f]} {f.value}"]

    print("# in turns, product / the per-lane grid's: " + ", ".join(
        f"C {f.value} {med[f'C {f.value}'] / med[f'C lane {f.value}']:.4f}, "
        f"D {f.value} {product_d(f) / med[f'D lane {f.value}']:.4f}"
        for f in TURN_PATTERNS) + f" {tag}", flush=True)
    print("# in turns, D shared / global, and D with symbol arrays / the "
          "product's D: " + "; ".join(
              f"{f.value} (product {product_form[f]}) "
              f"{med[f'D shared {f.value}'] / med[f'D global {f.value}']:.4f}"
              f", {med[f'd_arrays {f.value}'] / product_d(f):.4f}"
              for f in TURN_PATTERNS) + f" {tag}", flush=True)
    ms["C"] = med["C p2pkh"]
    walk = ms["D"] = ms[f"{fused.dfa_form(*dfa[0].shape)} {DFA_PATTERN}"]
    print(f"# D's split (P2PKH, ms): finish {ms['finish']:.4f}; hash160 "
          f"(value - finish) {ms['value'] - ms['finish']:.4f}; checksum "
          f"{ms['checksum'] - ms['value']:.4f}; base conversion and shift "
          f"{ms['symbols'] - ms['checksum']:.4f}; digits and walk "
          f"{walk - ms['symbols']:.4f} (from shared memory "
          f"{ms[f'shared {DFA_PATTERN}'] - ms['symbols']:.4f}, from L1 "
          f"{ms[f'global {DFA_PATTERN}'] - ms['symbols']:.4f}); C's compare "
          f"(C - value) {ms['C'] - ms['value']:.4f} {tag}", flush=True)
    print("# the product's C " + f"{ms['C']:.4f}, D {ms['D']:.4f}; " + ", ".join(
        f"{m} {ms[m]:.4f}" for m in C_MODES + D_MODES) + f" {tag}",
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
