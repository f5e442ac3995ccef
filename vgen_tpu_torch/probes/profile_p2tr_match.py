"""Kernel I split by stage on the card: kernel ``probe_p2tr_match`` and its
tool.

    python -m vgen_tpu_torch.probes.profile_p2tr_match

No TPU script has this split; it is ``profile_dfa``'s for the P2TR DFA
finish.  At the scan's shape (K = 8 windows of B = 524288 lanes: X and Z
random field elements from a numpy seed, zi their inverses from kernel G,
ok 1 but on every 4099th lane) it times kernel I's lane over the
product's tiles (one tile of 256 lanes of one window per block; 0 where ok
is 0, Z is 0 or b >= remaining[k]) cut after each stage, each mode
returning a word of its stage, so nothing before the cut is dead code:

- ``qx``: the output key's x, qx = X * zi^2; the XOR of its eight words;
- ``checksum``: the bech32m checksum of qx as the product computes it (a
  XOR of 52 table lookups, no walk); its six symbols as one word;
- ``polymod``: the same checksum by the polymod's 58 dependent steps;

and the whole kernel as the product does not run it, in both table forms:
``polymod_walk`` (the register walk with the polymod's checksum, this
redesign's first form), ``bounded`` (the product's walk under a minimum of
4 blocks per SM, at most 64 registers), ``arrays`` (the 59 symbols in a
per-thread array walked after them, the per-lane walk); and ``i_lane``,
the per-lane kernel I whole (one thread per lane over N / 256 blocks
dividing by B, the symbol array, the int32 table through the read-only
cache).

The product (``fused.p2tr_finish_match``) is timed in both table forms
("shared": the narrow table in shared memory; "global": the int32 table
through the read-only cache) on the product's pattern ``qq$``, on ``q$``
and on random width-34 DFAs of 16 to 64 states, of the most states the
budget (``fused.DFA_SHARED_BUDGET``) and the shared form
(``fused.DFA_SHARED_MAX``) hold, and of more (the global form only).  Each narrow table is built before the timing, as the scanner
builds it once per pattern.  Every walk's output is held bit-equal to the
product's.  It prints each mode's ms, its bound and share, the stage
differences (qx, checksum, walk), five alternating rounds of the product
in both forms beside every walk mode and ``i_lane`` on ``qq$`` with their
medians and ratios, and the ptxas figures of each instance.  It measures
the card only: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import torch

from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.ops import encode, fused, pipeline, u256
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, profile_dfa, timing

P2TR = AddressFormat.P2TR
# mode: template code of p2tr_match_lanes.cuh P2trMatchMode
MODES = {m: code for code, m in enumerate((
    "qx", "checksum", "polymod", "polymod_walk", "bounded", "arrays",
    "i_lane"))}
STAGES = ("qx", "checksum", "polymod")
# the walks (I's 0/1 output), and those that take either table form
WALKS = ("polymod_walk", "bounded", "arrays", "i_lane")
FORM_WALKS = WALKS[:-1]
K, B = 8, common.TIMED_N
BASE_SEED = 978
DEAD_EVERY = 4099  # ok is 0 on every lane e with e % DEAD_EVERY == 0
PATTERN = "qq$"
PATTERNS = (PATTERN, "q$")
WIDTH = pipeline.FORMAT_DFA_WIDTH[P2TR]
# random DFAs of the form sweep: 16 and 64 states, the most the budget
# (DFA_SHARED_BUDGET) and the shared form (DFA_SHARED_MAX) hold at width
# 34, and more than the form holds
BUDGET_STATES = fused.DFA_SHARED_BUDGET // (2 * WIDTH + 1)
CAP_STATES = fused.DFA_SHARED_MAX // (2 * WIDTH + 1)
RANDOM_STATES = (16, 64, BUDGET_STATES, CAP_STATES, 4 * CAP_STATES)


def stage_count(mode: str):
    """The bound model's count of one lane of ``mode``: the least work of
    its function, so the polymod's checksum counts as the table lookups,
    and every walk (and the product) as kernel I's qx and walk."""
    if mode == "qx":
        return bm.P2TR_QX
    if mode in STAGES:
        return bm.P2TR_QX + bm.BECH32M_CHECKSUM
    return bm.P2TR_QX + bm.BECH32M_WALK


def stage_nbytes(mode: str, table_bytes: int = 0, k: int = K,
                 b: int = B) -> int:
    """Bytes read and written once: X, Z, zi, ok, remaining, the (K, B)
    int32 output, and the walks' table in the form they read."""
    n = k * b
    return 100 * n + 4 * k + 4 * n + (0 if mode in STAGES else table_bytes)


def table_bytes(table, form: str) -> int:
    """The table's bytes in ``form``: the narrow form's or the int32
    table and accept flags."""
    S, W = table.shape
    return S * (2 * W + 1) if form == "shared" else 4 * S * (W + 1)


def inputs(device, k: int = K, b: int = B, seed: int = BASE_SEED,
           remaining=None):
    """(X, Z, zi, ok, remaining) of k windows of b lanes on ``device``: X, Z
    random field elements from ``seed``, zi = 1 / Z from kernel G (its
    plain version on the CPU), ok 1 but on every DEAD_EVERY-th lane;
    remaining b per window unless given."""
    X, Z = common.inputs(k * b, seed)
    ok = torch.ones(k * b, dtype=torch.int32)
    ok[::DEAD_EVERY] = 0
    dev = torch.device(device)
    X, Z, ok = X.to(dev), Z.to(dev), ok.to(dev)
    zi = fused.batch_inverse_chain(Z)
    rem = torch.tensor([b] * k if remaining is None else remaining,
                       dtype=torch.int32, device=dev)
    return X, Z, zi, ok, rem


def pattern_dfa(src: str, device="cpu"):
    """(table, accept, start) int32 of a pattern's P2TR DFA."""
    return profile_dfa.pattern_dfa(src, P2TR, device)


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")


def match_plain(mode, X, Z, zi, ok, dfa_table, dfa_accept, start,
                remaining):
    """Plain version of ``probe_p2tr_match``: kernel I's arguments -> the
    (K, B) int32 output of ``mode``: the stage's word, or I's 0/1."""
    _check_mode(mode)
    if mode in WALKS:
        return fused.p2tr_finish_match_plain(X, Z, zi, ok, dfa_table,
                                             dfa_accept, start, remaining)
    qx, valid = fused._p2tr_qx(X, Z, zi, ok, remaining)
    if mode == "qx":  # else the checksum, by either method
        w = qx[0]
        for i in range(1, 8):
            w = w ^ qx[i]
    else:
        syms, _ = encode.bech32m_p2tr_symbols(qx)
        w = torch.zeros_like(qx[0])
        for i in range(6):
            w = (w << 5) | syms[53 + i]
    return u256.to_i32(torch.where(valid, w & common.M32, 0))


def probe_p2tr_match(mode, X, Z, zi, ok, dfa_table, dfa_accept, start,
                     remaining, form=None, narrow=None):
    """Kernel ``probe_p2tr_match`` (``probes/probes.cu``), one launch for
    all K*B lanes; the plain version for CPU tensors.  The walks of
    FORM_WALKS take the table ``form`` as kernel I does (None: its choice,
    ``fused.dfa_form``'s; "shared" must fit ``fused.DFA_SHARED_MAX`` and reads
    ``narrow`` or builds it), ``i_lane`` the int32 table; the stages read
    no table."""
    _check_mode(mode)
    tensors = (X, Z, zi, ok, dfa_table, dfa_accept, remaining)
    if all(t.device.type == "cpu" for t in tensors):
        return match_plain(mode, X, Z, zi, ok, dfa_table, dfa_accept, start,
                           remaining)
    S, W = dfa_table.shape
    if W != WIDTH:
        raise ValueError(f"probe_p2tr_match: DFA width {W}, expected {WIDTH}")
    dev, Kk, Bb = fused._finish_specs(
        "probe_p2tr_match", X, Z, zi, ok, remaining,
        [("dfa_table", dfa_table, (S, W)), ("dfa_accept", dfa_accept, (S,))])
    table, accept, shared = dfa_table, dfa_accept, False
    if mode in FORM_WALKS:
        table, accept, used = fused._table_form(
            "probe_p2tr_match", dfa_table, dfa_accept, narrow, form, dev)
        shared = used == "shared"
    elif form not in (None,) + fused.DFA_FORMS:
        raise ValueError(f"probe_p2tr_match: table form {form!r}")
    out = torch.empty((Kk, Bb), dtype=torch.int32, device=dev)
    common.launch("probe_p2tr_match", dev, MODES[mode], int(shared),
                  *(t.data_ptr() for t in (X, Z, zi, ok, table, accept)), S,
                  W, int(start), remaining.data_ptr(), out.data_ptr(), Kk, Bb)
    probe_p2tr_match.launches += 1
    return out


probe_p2tr_match.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.profile_p2tr_match",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    from vgen_tpu_torch.csrc import build

    tag, dev = card.tag(), card.device
    lanes = inputs(dev)
    X, Z, zi, ok, rem = lanes
    dfas = {src: pattern_dfa(src, dev) for src in PATTERNS}
    dfa = dfas[PATTERN]
    nar = fused.narrow_dfa(*dfa[:2])  # once, as the scanner builds it
    probe_p2tr_match("qx", *lanes[:4], *dfa, rem)  # builds the probe unit
    ref = fused.p2tr_finish_match(*lanes[:4], *dfa, rem, narrow=nar)
    log = build.build_log(("probes",)) + build.build_log(("p2tr",))
    print(f"# profile_p2tr_match: K={K} windows of B={B} lanes, pattern "
          f"{PATTERN} ({dfa[0].shape[0]} states, product form "
          f"{fused.dfa_form(*dfa[0].shape)}); ms per launch, best of five "
          f"means of 10 {tag}", flush=True)
    ms = {}
    runs = {m: (lambda m=m: probe_p2tr_match(m, *lanes[:4], *dfa, rem))
             for m in STAGES + ("i_lane",)}
    for m in FORM_WALKS:
        for form in fused.DFA_FORMS:
            runs[f"{m}[{form}]"] = (
                lambda m=m, form=form: probe_p2tr_match(
                    m, *lanes[:4], *dfa, rem, form=form, narrow=nar))
    for form in fused.DFA_FORMS:
        runs[f"I[{form}]"] = (lambda form=form: fused.p2tr_finish_match(
            *lanes[:4], *dfa, rem, form=form, narrow=nar))
    for name, run in runs.items():
        mode = name.split("[")[0]
        if mode not in STAGES and not torch.equal(run(), ref):
            print(f"error: {name} differs from the product's kernel I",
                  file=sys.stderr)
            return 1
        ms[name] = timing.launch_ms(run)
        form = "global" if name == "i_lane" else (
            name.split("[")[1][:-1] if "[" in name else None)
        tb = table_bytes(dfa[0], form) if form else 0
        bms, bby = bm.bound(K * B * stage_count(mode), stage_nbytes(mode, tb),
                            card.sm_clocks_per_s)
        print(f"{name}: {ms[name]:.4f} ms, {K * B / ms[name] / 1e3:.1f} M "
              f"lanes/s, bound {bms:.4f} ms ({bby}, share "
              f"{bms / ms[name]:.2f}) {tag}", flush=True)
    # in turns on the product's pattern: the product in both forms beside
    # every walk it does not take, and the per-lane kernel I
    med = timing.in_turns({name: run for name, run in runs.items()
                           if name.split("[")[0] not in STAGES}, tag)
    prod = f"I[{fused.dfa_form(*dfa[0].shape)}]"
    print(f"# in turns on {PATTERN}: the product ({prod}) / i_lane "
          f"{med[prod] / med['i_lane']:.4f}; I shared / global "
          f"{med['I[shared]'] / med['I[global]']:.4f}; each walk / the "
          f"product in its form: " + ", ".join(
              f"{m}[{f}] {med[f'{m}[{f}]'] / med[f'I[{f}]']:.4f}"
              for m in FORM_WALKS for f in fused.DFA_FORMS) + f" {tag}",
          flush=True)
    print(f"# I's split ({PATTERN}, ms): qx {ms['qx']:.4f}; the checksum by "
          f"table lookups (checksum - qx) {ms['checksum'] - ms['qx']:.4f}, by "
          f"the polymod {ms['polymod'] - ms['qx']:.4f}; the walk "
          f"(I - checksum) shared {med['I[shared]'] - ms['checksum']:.4f}, "
          f"global {med['I[global]'] - ms['checksum']:.4f}; the product "
          f"{med[prod]:.4f}, i_lane {med['i_lane']:.4f} {tag}", flush=True)
    # the register walk in both table forms, in turns, on the second
    # pattern and on random DFAs: the sweep that places the budget
    walks = [("q$", dfas["q$"])] + [
        (f"random {s} states", profile_dfa.random_dfa(s, WIDTH, device=dev))
        for s in RANDOM_STATES]
    for what, d in walks:
        S = d[0].shape[0]
        fits = S * (2 * WIDTH + 1) <= fused.DFA_SHARED_MAX
        forms = fused.DFA_FORMS if fits else ("global",)
        nar_d = fused.narrow_dfa(*d[:2]) if fits else None
        outs = {form: fused.p2tr_finish_match(*lanes[:4], *d, rem, form=form,
                                              narrow=nar_d) for form in forms}
        if fits and not torch.equal(outs["shared"], outs["global"]):
            print(f"error: the two table forms differ on {what}",
                  file=sys.stderr)
            return 1
        med = timing.in_turns({f"I[{form}] on {what}": (
            lambda f=form, d=d, n=nar_d: fused.p2tr_finish_match(
                *lanes[:4], *d, rem, form=f, narrow=n)) for form in forms},
            tag)
        for form in forms:
            t = med[f"I[{form}] on {what}"]
            tb = table_bytes(d[0], form)
            bms, bby = bm.bound(K * B * stage_count("I"),
                                stage_nbytes("I", tb), card.sm_clocks_per_s)
            print(f"I[{form}] on {what} ({S} states, {tb} table bytes): "
                  f"median {t:.4f} ms, bound {bms:.4f} ms ({bby}, share "
                  f"{bms / t:.2f}) {tag}", flush=True)
        if fits:
            print(f"# {what}: shared / global "
                  f"{med[f'I[shared] on {what}'] / med[f'I[global] on {what}']:.4f}"
                  f" (product form {fused.dfa_form(*d[0].shape)}) {tag}",
                  flush=True)
    for kernel, names in (("finish_match_tile_kernel", ("shared",)),
                          ("probe_p2tr_match", ("mode", "shared")),
                          ("probe_p2tr_match_bounded", ("shared",)),
                          ("probe_p2tr_match_lane", ())):
        for args, fig in sorted(timing.ptxas_figures(log, kernel).items()):
            print(f"ptxas {kernel}<" + ", ".join(
                f"{n} {v}" for n, v in zip(names, args))
                + f">: {timing.ptxas_text(fig)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
