"""Primitive costs on the card: kernel ``probe_primitive`` and its tool.

    python -m vgen_tpu_torch.probes.roofline [--kernels FILE]

The counterpart of ``scripts/roofline.py`` (its ``make`` at :162, body
``_body`` :76, fold ``_feedback`` :68).  Each instance runs R dependent
repetitions of one production primitive of ``csrc/`` per lane (fed back
as ``probe_lanes.cuh`` describes) at N = 524288 lanes; the tool times
t(2R) - t(R) with CUDA events, reports SM clocks per lane (at the SM
clock sampled while it ran) beside the bound model's count, then composes
each kernel A to I's per-lane cost from the primitives, as the TPU script
composes its paths, and prints it beside the kernel's ``bound_ms`` and
time from a ``chip_smoke.py`` log (``--kernels``).  It measures the card
only: without one it exits non-zero, and so it does when a delta never
clears its noise floor.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from vgen_tpu_torch.ops import curve, encode, field, fused, keccak, sha256, u256
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, timing

# name: (template code of probe_lanes.cuh Primitive, the model's count of
# one repetition)
PRIMITIVES = {
    "empty": (0, bm.ops()),
    "fe_mul": (1, bm.FE_MUL),
    "fe_sqr": (2, bm.FE_SQR),
    "fe_sqr_dedicated": (3, bm.FE_SQR),
    "hash160c": (4, bm.HASH160),
    "scripthash": (5, bm.SCRIPT_HASH),
    "hash160u": (6, bm.SHA256_X65 + bm.RIPEMD160),
    "keccak": (7, bm.KECCAK),
    "tagged": (8, bm.TAGGED),
    "leanadd": (9, bm.LEAN_ADD),
    "dfachar24": (10, bm.DFA_STEP),
    "dfachar60": (11, bm.DFA_STEP),
    "b58syms": (12, bm.B58_SYMBOLS),
    "ethsyms": (13, bm.EIP55_SYMBOLS),
    "dfachar60s": (14, bm.DFA_STEP),
}
# the DFA step instances and their row length: dfachar60s steps through
# kernel D's shared-memory form (the table staged as uint16)
DFA_PRIMITIVES = {"dfachar24": 24, "dfachar60": 60, "dfachar60s": 60}
DFA_STATES, DFA_WIDTH = 64, 60  # the table both dfachar instances read
TAPTWEAK_MIDSTATE = sha256.tagged_midstate("TapTweak")
R0, MAX_REPS = 8, 1 << 14

# Kernels A to I as primitives per lane (the scan's K = 8 windows of B =
# 524288), for the composition; the finish counts field multiplies and
# squarings only (the product squares with the dedicated squaring; the
# ``fe_sqr`` probe times the full multiply fe_mul(a, a)), the product tree
# is spread over kernels A's and G's groups (``fused.INV_GEOMETRY``),
# P2TR's ladder adds its schedule's expected
# nonzero digits (``fused.LADDER_WINDOW``), and the negations of signed
# digits and bech32m, which no primitive times, count as nothing.
SQR = "fe_sqr_dedicated"


def expected_adds(bits: int, signed: bool) -> float:
    """The ladder's nonzero digits for a uniform t < 2^256: 1 - 2^-bits a
    window, but the last, which holds the top bits and, for signed digits,
    the carry (zero one time in two)."""
    windows, _ = fused.ladder_shape(bits, signed)
    top = 256 - bits * (windows - 1)
    last = 1 - 2.0 ** -top * (0.5 if signed else 1)
    return (windows - 1) * (1 - 2.0 ** -bits) + last


def _chain(m: int, g: int):
    # the group's inversion (divsteps, no primitive of its own) is left out:
    # shared by m g elements, under 1% of a chain's multiplies
    return {"fe_mul": 3 + 3 * (g - 1) / (m * g)}


_GLV_FINISH = {"fe_mul": 3, SQR: 1}  # x-only finish, beta x, beta^2 x
_GLV_FINISH_XY = {"fe_mul": 4, SQR: 1}  # the full finish and the betas
_FINISH = {"fe_mul": 2, SQR: 1}
_CHAIN = _chain(*fused.INV_GEOMETRY)
_VALUE = {"p2pkh": {"hash160c": 1},
          "p2sh-p2wpkh": {"hash160c": 1, "scripthash": 1},
          "p2pkh-uncompressed": {"hash160u": 1},
          "ethereum": {"keccak": 1}}
_SYMBOLS = {f: ({"ethsyms": 1, "dfachar24": 41} if f == "ethereum"
                else {"b58syms": 1, "dfachar60": 35}) for f in _VALUE}
# kernel D walks its table in shared memory (dfachar60s, for every width);
# bech32's symbols, which no primitive times, count as nothing
_WALK = {f: ({"ethsyms": 1, "dfachar60s": 41} if f == "ethereum"
             else {"b58syms": 1, "dfachar60s": 35}) for f in _VALUE}
_WALK["p2wpkh"] = {"dfachar60s": 40}


def _plus(*parts, times=1):
    out: Dict[str, float] = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + times * v
    return out


def _kernel_recipes():
    recipes = {"batch_inverse_dx": _CHAIN, "batch_inverse_chain": _CHAIN,
               "p2tr_ladder": _plus(_FINISH, {
                   "tagged": 1,
                   "leanadd": expected_adds(*fused.LADDER_WINDOW)}),
               "p2tr_finish_range": {"fe_mul": 1, SQR: 1},
               # kernel I walks its table in shared memory (dfachar60s) or,
               # in the global form, through the read-only cache
               "p2tr_finish_match": {"fe_mul": 1, SQR: 1, "dfachar60s": 60},
               "p2tr_finish_match[global]": {"fe_mul": 1, SQR: 1,
                                             "dfachar60": 60}}
    for f, value in _VALUE.items():
        sfx = "" if f == "p2pkh" else f"[{f}]"
        glv = _GLV_FINISH_XY if f in ("p2pkh-uncompressed", "ethereum") \
            else _GLV_FINISH
        recipes["range_glv_match" + sfx] = _plus(glv, _plus(value, times=6))
        recipes["range_match" + sfx] = _plus(_FINISH, value)
        recipes["dfa_match" + sfx] = _plus(_FINISH, value, _WALK[f])
        recipes["glv_dfa_match" + sfx] = _plus(
            glv, _plus(value, _SYMBOLS[f], times=6))
    recipes["range_match[p2wpkh]"] = _plus(_FINISH, _VALUE["p2pkh"])
    recipes["dfa_match[p2wpkh]"] = _plus(_FINISH, _VALUE["p2pkh"],
                                         _WALK["p2wpkh"])
    # kernel D at the int32 table through the read-only cache
    recipes["dfa_match[global]"] = _plus(_FINISH, _VALUE["p2pkh"],
                                         _SYMBOLS["p2pkh"])
    return recipes


KERNEL_RECIPES = _kernel_recipes()
KERNEL_LANES = 8 * common.TIMED_N


def dfa_table(seed: int = 60) -> torch.Tensor:
    """(64, 60) int32 table of states below 64 (dfachar24 reads it as
    rows of 24)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, DFA_STATES,
                                         size=(DFA_STATES, DFA_WIDTH),
                                         dtype=np.int32))


def primitive_out(name: str, a: torch.Tensor, b: torch.Tensor,
                  table: torch.Tensor):
    """The output words of one repetition of primitive ``name`` (before
    the fold): a, b (8, N) int64, table the flat int64 DFA table."""
    if name == "empty":
        return [(b[0] + 1) & common.M32]
    if name == "fe_mul":
        return list(field.mul(a, b))
    if name in ("fe_sqr", "fe_sqr_dedicated"):
        return list(field.square(a))
    if name == "hash160c":
        return encode.hash160_33_words_from_x(a, 2 + (b[0] & 1))
    if name == "scripthash":
        return encode.script_hash_words(list(a[:5]))
    if name == "hash160u":
        return encode.hash160_65_words_from_xy(a, b)
    if name == "keccak":
        return keccak.eth_account_words_from_xy(a, b)
    if name == "tagged":
        return list(sha256.tagged_hash_32(TAPTWEAK_MIDSTATE, a))
    if name == "leanadd":
        X, Y, Z, ok = curve.jacobian_add_affine_lean(a, b, a, b, a)
        return list(X) + list(Y) + list(Z) + [ok.to(torch.int64)]
    if name in DFA_PRIMITIVES:
        width = DFA_PRIMITIVES[name]
        return [table[(b[0] % DFA_STATES) * width + a[0] % width]]
    if name == "b58syms":
        syms, length = encode.base58check_symbols(0, list(a[:5]))
        return list(syms) + [length]
    if name == "ethsyms":
        return list(encode.eth_symbols(list(a[:5]))[0])
    raise ValueError(f"unknown primitive {name!r}")


def probe_primitive_plain(name, a, b, table, reps):
    """Plain version of ``probe_primitive``: (8, N) int32 -> (8, N) int32,
    a after ``reps`` repetitions."""
    a64, b64 = u256.to_i64(a), u256.to_i64(b)
    flat = table.to(torch.int64).reshape(-1)
    for _ in range(reps):
        a64, b64 = common.feedback(a64, b64, primitive_out(name, a64, b64,
                                                           flat))
    return u256.to_i32(a64)


def probe_primitive(name, a, b, table, reps):
    """Kernel ``probe_primitive`` (``probes/probes.cu``), one launch; the
    plain version for CPU tensors."""
    if name not in PRIMITIVES:
        raise ValueError(f"unknown primitive {name!r}")
    if all(t.device.type == "cpu" for t in (a, b, table)):
        return probe_primitive_plain(name, a, b, table, reps)
    n = a.shape[1]
    dev = common.check_cuda("probe_primitive", [a, b], n, reps)
    if (table.device != dev or table.dtype != torch.int32
            or table.shape != (DFA_STATES, DFA_WIDTH)
            or not table.is_contiguous()):
        raise ValueError("probe_primitive: the table must be a contiguous "
                         f"({DFA_STATES}, {DFA_WIDTH}) int32 tensor on {dev}")
    out = torch.empty_like(a)
    common.launch("probe_primitive", dev, PRIMITIVES[name][0], a.data_ptr(),
                  b.data_ptr(), table.data_ptr(), out.data_ptr(), n, reps)
    probe_primitive.launches += 1
    return out


probe_primitive.launches = 0


def _smoke_kernels(path):
    """{name: entry} of the last ``{"kernels": ...}`` line in a
    chip_smoke.py log."""
    entries = {}
    with open(path) as f:
        for line in f:
            if line.startswith('{"kernels"'):
                entries = {k["name"]: k for k in json.loads(line)["kernels"]}
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vgen_tpu_torch.probes.roofline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=None, metavar="FILE",
                    help="a chip_smoke.py log: print each kernel's time and "
                    "bound_ms beside its composed cost")
    args = ap.parse_args(argv)
    card = timing.Card()
    n = common.TIMED_N
    a, b = (t.to(card.device) for t in common.inputs(n, seed=162))
    table = dfa_table().to(card.device)
    tag = card.tag()
    print(f"# roofline: probe_primitive at N={n}, cost (t(2R) - t(R)) / R "
          f"{tag}", flush=True)
    ns_per_lane, errors = {}, []
    with timing.ClockSampler() as clocks:
        for name in PRIMITIVES:
            res = timing.measure(
                lambda reps: probe_primitive(name, a, b, table, reps), R0,
                MAX_REPS, clocks)
            if "error" in res:
                errors.append(name)
                print(f"{name}: MEASUREMENT ERROR {res} {tag}", flush=True)
                continue
            per_lane_s = res["delta_ms"] * 1e-3 / (res["reps"] * n)
            ns_per_lane[name] = per_lane_s * 1e9
            count = PRIMITIVES[name][1]
            clk = per_lane_s * res["mhz"] * 1e6 * card.sm_count
            print(f"{name}: R={res['reps']} t(R)={res['t1_ms']:.4f} ms "
                  f"t(2R)={res['t2_ms']:.4f} ms delta={res['delta_ms']:.4f} ms"
                  f" (floor {res['floor_ms']:.4f}) at {res['mhz']:.0f} MHz: "
                  f"{clk:.2f} SM clocks per lane, {ns_per_lane[name]:.4f} ns; "
                  f"model (multiplies {count[0]}, ALU-only {count[1]}, "
                  f"instructions {count[2]}) = {bm.sm_clocks(count):.2f} "
                  f"clocks, share {bm.sm_clocks(count) / clk:.2f} {tag}",
                  flush=True)
    if "empty" in ns_per_lane:
        empty = ns_per_lane["empty"]
        print(f"# net of empty ({empty:.4f} ns per lane, the fold): " + ", ".join(
            f"{k} {v - empty:.4f} ns" for k, v in ns_per_lane.items()
            if k != "empty") + f" {tag}", flush=True)
        smoke = _smoke_kernels(args.kernels) if args.kernels else {}
        for kname, recipe in KERNEL_RECIPES.items():
            if not all(p in ns_per_lane for p in recipe):
                continue
            ms = sum(c * (ns_per_lane[p] - empty) for p, c in recipe.items()) \
                * KERNEL_LANES * 1e-6
            seen = smoke.get(kname)
            beside = (f"; chip_smoke: {seen['ms']:.3f} ms, bound_ms "
                      f"{seen['bound_ms']:.3f}" if seen else "")
            print(f"{kname}: composed {ms:.3f} ms at K=8 B={common.TIMED_N} "
                  f"from {recipe}{beside} {tag}", flush=True)
    if errors:
        print(f"error: no cost cleared its noise floor for {errors}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
