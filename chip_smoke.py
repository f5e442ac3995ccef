#!/usr/bin/env python3
"""Smoke run of vgen_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises and exits non-zero):

1. a CUDA card is visible; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from vgen_tpu_torch/csrc (nvcc, sm_90a);
3. kernel A (batch_inverse_dx) against its plain PyTorch version: random
   canonical inputs from a numpy seed, K = 2, B = 8192, one forced zero-dx
   lane; bit-equal, and x * inv = 1 (mod p) on 64 sampled lanes;
4. kernel B (range_glv_match) and the pack tail against the plain versions
   on CPU: real i*G table and base points, pattern ^1C, K = 2, B = 8192;
   masks and packed rows bit-equal;
5. the main path at full width through the CLI: ``generate -p ^1C -c 3``
   (P2PKH, B = 524288, k_sub = 8); every match re-derived by the
   vgen_tpu_torch.crypto oracle; both kernels' launch counters > 0 in that run;
6. kernels A and B and their plain versions timed at the main path's shape
   (K = 8, B = 524288) with CUDA events, outputs compared again;
7. a timed benchmark_device run (^1BenchNeverMatches, about 10 s);
8. kernel C (range_match) and the pack against the plain versions on CPU:
   K = 2, B = 8192, one window based below B (it holds the doubling lane),
   a partial window, an exact-address pattern whose key's lane must be set;
9. kernels D (dfa_match) and E (glv_dfa_match) and the pack against the
   plain versions on CPU, P2PKH and P2WPKH, patterns c[a4]t and a.{8}$
   (more than 256 DFA states); masks and rows bit-equal, matches > 0;
10. the random DFA path at full width through the CLI: ``generate -p Cat$
    -c 3`` and ``generate -f p2wpkh -p zzz$ -c 3``; oracle-confirmed;
    kernels A and E launched, B not;
11. the puzzle range at full width: ``range -p boha:b1000:34 -c 1`` returns
    key 0x34A65911D (oracle-confirmed) through kernels A and C; keys/s;
12. checkpoint resume on puzzle 30: leg 1 stops after a few super-steps,
    leg 2 (through the CLI) starts at the saved next_key and returns
    0x3D94CD64, its operations the total since the range's start;
13. a full-width DFA range of two windows (1048576 keys, [Cc]at, -c 0)
    through kernels A and D: the match set equals the native CPU
    scanner's over the same range, key for key;
14. kernels C, D and E and their plain versions timed at K = 8,
    B = 524288 on patterns that hit often (^1C, [Cc]at, Cat$), outputs
    compared again, matching lanes > 0 for each;
15. a timed benchmark_device run on a DFA pattern that never matches
    (BenchNeverMatches$, P2PKH, GLV, about 5 s) through kernel E;
16. the P2TR kernels F (p2tr_ladder, finish=True, and its finish=False
    form on affine points), G (batch_inverse_chain, with a forced zero-Z
    lane), H (p2tr_finish_range, ^bc1pq) and I (p2tr_finish_match, q$)
    against their plain versions on CPU: real tables and base points,
    K = 2, B = 8192, one window based below B; bit-equal, matching lanes
    > 0;
17. ``generate -f p2tr -p ^bc1pqq -c 3`` at full width: oracle-confirmed;
    kernels A, F, G and H launched, I not;
18. ``generate -f p2tr -p qq$ -c 3``: kernels A, F, G and I, H not;
19. a full-width P2TR DFA range of two windows (1048576 keys, qq$, -c 0):
    the match set equals the native CPU scanner's, key for key;
20. kernels F, G, H and I and their plain versions timed at K = 8,
    B = 524288 with CUDA events, outputs compared again (the plain ladder
    at K = 1 when K = 8 would take over 60 s, judged from one window),
    and F's finish=False form at N = 524288;
21. timed benchmark_device runs (about 5 s each) on P2TR patterns that
    never match: an interval pattern through kernels A, F, G and H, and a
    suffix through A, F, G and I.

Each path's launch counters are set to 0 just before it runs and read just
after.  Tolerance everywhere: exact (the values are integers).  The line
before the last is the kernels' JSON summary, the last line the device
JSON.

Each kernel's ``bound_ms`` is the larger of the time its 32-bit integer
instructions need (the model below, over the SMs at the maximum SM clock
nvidia-smi reports) and its bytes (each input read once, each output
written once) over 3.35 TB/s.  Instructions are counted per lane from the
algorithm (a model, not a measurement); the ladder's adds are counted from
this run's tweak digits.  A kernel timed below its bound fails the run: the
model would then count more than the work needs.
"""

import contextlib
import io
import json
import os
import random
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds per call of fn() over reps calls, by CUDA events
    (one warm-up call first unless warm is False)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# The model behind bound_ms: 32-bit integer instructions per lane, as
# (multiplies, all instructions), the fewest the algorithm needs, with one
# instruction per 32x32->64 multiply-add.  An SM issues one warp
# instruction per scheduler per clock (4 x 32 = 128 lane results) and runs
# integer multiply-adds at 64 per clock, so a kernel needs at least
# max(multiplies / 64, instructions / 128) clocks on every SM.
# - field multiply: 64 partial products (a multiply-add and a carry add
#   each), the fold of the high half by 977 (8 more), the fold's one-limb
#   shift (8 adds) and a 16-op conditional subtract of p;
# - field squaring: 36 distinct partial products, the 28 cross products
#   doubled by a 16-op shift, then the same fold and subtract;
# - modular add or subtract: 8 carrying adds and 8 for the fix-up;
# - SHA-256 compression: 64 rounds of 14 (per sigma three funnel-shift
#   rotates and one three-input XOR, one LOP3 each for Ch and Maj, four
#   three-input adds) and 48 schedule words of 10, less 60 where the
#   initial state and the zero padding words are constants;
# - RIPEMD-160: 160 steps of 6 (a LOP3, two rotates, three adds), one add
#   fewer in the 80 steps on constant padding words, 10 for the final
#   combination and 8 byte swaps;
# - inversion: 255 squarings and 15 multiplies;
# - a DFA step: the index's multiply-add and the load;
# - an interval compare of W words against S slots: a subtract with borrow
#   per word against lo and against hi, and one combine, per slot.
FE_MUL = np.array([64 + 8, 2 * 64 + 2 * 8 + 8 + 16])
FE_SQR = np.array([36 + 8, 2 * 36 + 16 + 2 * 8 + 8 + 16])
FE_ADD = np.array([0, 16])
SHA256 = np.array([0, 64 * 14 + 48 * 10 - 60])
RIPEMD160 = np.array([0, 160 * 6 - 80 + 10 + 8])
HASH160 = SHA256 + RIPEMD160
INV = 255 * FE_SQR + 15 * FE_MUL
DFA_STEP = np.array([1, 2])
MULS_PER_SM_CLOCK, INSTRUCTIONS_PER_SM_CLOCK = 64, 128
HBM_BYTES_PER_S = 3.35e12


def compare(slots, words):
    return np.array([0, slots * (2 * words + 1)])


def bound(ops, nbytes, sm_clocks_per_s):
    """(bound_ms, bound_by): the larger of the instructions' time on the
    SMs (``sm_clocks_per_s``: SMs x clock) and bytes over the memory
    rate."""
    t_ops = max(ops[0] / MULS_PER_SM_CLOCK,
                ops[1] / INSTRUCTIONS_PER_SM_CLOCK) / sm_clocks_per_s
    t_mem = nbytes / HBM_BYTES_PER_S
    return float(max(t_ops, t_mem) * 1e3), ("operations" if t_ops >= t_mem
                                            else "bytes")


def max_abs_err(a, b):
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def main():
    import torch

    # -- 1. the card ----------------------------------------------------
    require(torch.cuda.is_available(), "no CUDA device is visible")
    sys.path.insert(0, HERE)
    import vgen_tpu_torch

    require(os.path.dirname(os.path.abspath(vgen_tpu_torch.__file__))
            == os.path.join(HERE, "vgen_tpu_torch"),
            "vgen_tpu_torch is not in this checkout")
    from vgen_tpu_torch import cli, native
    from vgen_tpu_torch.cli import resolve_range_params
    from vgen_tpu_torch.crypto import secp256k1 as ec
    from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
    from vgen_tpu_torch.pattern import Pattern
    from vgen_tpu_torch.scan.checkpoint import CheckpointManager
    from vgen_tpu_torch.scan.host import ScanConfig, StopFlag, _scan_cpu
    from vgen_tpu_torch.csrc import build
    from vgen_tpu_torch.ops import curve, fused, pipeline, sha256, u256
    from vgen_tpu_torch.scan import scanner as sc
    from vgen_tpu_torch.scan import tables

    def smi_query(fields):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]

    smi = smi_query("name,power.limit")
    name = torch.cuda.get_device_name(0)
    log(smi)
    dev = torch.device("cuda", 0)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    sm_mhz = float(smi_query("clocks.max.sm").split()[0])
    sm_clocks_per_s = sm_count * sm_mhz * 1e6
    log(f"[1] card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | python {sys.version.split()[0]} | devices {torch.cuda.device_count()}"
        f" | {sm_count} SMs, max SM clock {sm_mhz:.0f} MHz: "
        f"{sm_clocks_per_s * INSTRUCTIONS_PER_SM_CLOCK / 1e12:.2f} T instructions/s, "
        f"{sm_clocks_per_s * MULS_PER_SM_CLOCK / 1e12:.2f} T multiply-adds/s")

    wrappers = {"batch_inverse_dx": fused.batch_inverse_dx,
                "range_glv_match": fused.range_glv_match,
                "range_match": fused.range_match,
                "dfa_match": fused.dfa_match,
                "glv_dfa_match": fused.glv_dfa_match,
                "p2tr_ladder": fused.p2tr_ladder,
                "batch_inverse_chain": fused.batch_inverse_chain,
                "p2tr_finish_range": fused.p2tr_finish_range,
                "p2tr_finish_match": fused.p2tr_finish_match}
    sources = {k: "vgen_tpu_torch/csrc/kernels.cu" for k in list(wrappers)[:5]}
    sources.update({k: "vgen_tpu_torch/csrc/p2tr.cu" for k in list(wrappers)[5:]})

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def read_launches():
        return {n: w.launches for n, w in wrappers.items()}

    def run_cli(argv, quiet=True):
        """cli.run_from_args with jsonl output -> (rows, stderr, seconds)."""
        out, err = io.StringIO(), io.StringIO()
        argv = argv + ["--no-tui", "-o", "jsonl"] + (["--quiet"] if quiet else [])
        t0 = time.time()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.run_from_args(argv)
        secs = time.time() - t0
        require(rc == 0, f"{argv} returned {rc}")
        rows = [json.loads(line) for line in out.getvalue().splitlines() if line]
        return rows, err.getvalue(), secs

    def confirm(rows, fmt, pat):
        """Re-derive every reported key with the oracle -> its keys."""
        gen = AddressGenerator(fmt)
        keys = []
        for r in rows:
            key = int(r["private_key_hex"], 16)
            addr = gen.generate(key.to_bytes(32, "big")).address
            require(addr == r["address"] and pat.matches(addr),
                    f"match not confirmed by the oracle: {r}")
            keys.append(key)
        return keys

    def lo_hi(pat, fmt):
        ivs = pat.match_intervals(fmt) or pat.prefilter_intervals(fmt)[0]
        lo_np, hi_np = pipeline.intervals_to_words(
            ivs, n_words=pipeline.INTERVAL_WORDS[fmt],
            n_slots=pipeline.interval_slot_count(len(ivs)))
        return u256.as_i32(lo_np), u256.as_i32(hi_np)

    def dfa_tensors(pat, fmt):
        dfa = pat.device_dfa(fmt)
        return (torch.from_numpy(dfa.table.astype(np.int32)),
                torch.from_numpy(dfa.accept.astype(np.int32)), int(dfa.start))

    kernels = []

    def time_kernel(kname, run, plain, ref, replaces, launches, err_small,
                    shape, ops, nbytes, reps=10):
        """Hold the plain version against the kernel's output ``ref`` at the
        timed shape, time both, and add the kernel's JSON entry (bound from
        ``ops``, (multiplies, instructions), and ``nbytes`` bytes; the kernel
        may not beat it).  The plain version's first call is its timed
        one."""
        ms = cuda_ms(run, reps)
        plain_ms = cuda_ms(lambda: plain_out.append(plain()), 1, warm=False)
        outs = (plain_out[0] if isinstance(plain_out[0], tuple)
                else (plain_out[0],))
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max(max_abs_err(p, r) for p, r in zip(outs, refs))
        require(err == 0, f"{kname} differs from its plain version at {shape}")
        plain_out.clear()
        torch.cuda.empty_cache()
        bound_ms, bound_by = bound(ops, nbytes, sm_clocks_per_s)
        require(ms >= bound_ms, f"{kname}: {ms:.3f} ms beats its bound "
                f"{bound_ms:.3f} ms: the model counts more than the work needs")
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(err, err_small), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
        return ms, plain_ms, bound_ms, bound_by

    plain_out = []

    # -- 2. build -------------------------------------------------------
    t0 = time.time()
    build.load()
    log(f"[2] kernels built+loaded in {time.time() - t0:.1f} s: "
        f"{', '.join(build.library_path(u).name for u in build.UNITS)}")
    for line in build.build_log().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            log(f"    {line.strip()}")

    # -- 3. kernel A vs plain --------------------------------------------
    rng = np.random.default_rng(20261016)
    K, B = 2, 8192

    def rand_fe(n):
        return [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(n)]

    bx_i = rand_fe(K)
    tx_i = rand_fe(B)
    tx_i[4321] = bx_i[1]  # dx == 0 at flat lane 1*B + 4321
    bx = u256.as_i32(u256.from_ints(bx_i).T)
    tx = u256.as_i32(u256.from_ints(tx_i))
    inv_plain = fused.batch_inverse_dx(bx, tx)
    inv_dev = fused.batch_inverse_dx(bx.to(dev), tx.to(dev))
    torch.cuda.synchronize()
    err_a = max_abs_err(inv_dev.cpu(), inv_plain)
    require(err_a == 0, f"kernel A differs from its plain version ({err_a})")
    got = u256.to_ints(inv_dev.cpu())
    lanes = random.Random(7).sample(range(K * B), 64)
    for e in lanes:
        dx = (tx_i[e % B] - bx_i[e // B]) % ec.P
        if dx:
            require(dx * got[e] % ec.P == 1, f"kernel A: bad inverse at {e}")
    require(got[B + 4321] == 1, "kernel A: zero dx not guarded to 1")
    log(f"[3] kernel A == plain on K={K} B={B} (bit-equal, zero lane guarded,"
        f" 64 lanes x*inv=1)")

    # -- 4. kernel B + pack vs plain --------------------------------------
    fmt = AddressFormat.P2PKH
    pat = Pattern("^1C")
    lo, hi = lo_hi(pat, fmt)
    txs, tys = tables.ig_table(B, "cpu")

    def base_points(scalars):
        pts = [ec.scalar_mult(s) for s in scalars]
        return (u256.as_i32(u256.from_ints([p[0] for p in pts]).T),
                u256.as_i32(u256.from_ints([p[1] for p in pts]).T))

    bxs, bys = base_points([0x5EED5EED5EED5EED, 3 + B // 2])  # 2nd: zero-dx lane
    rem = torch.tensor([B, B - 100], dtype=torch.int32)
    cpu_args = (bxs, bys, txs, tys)
    inv_c = fused.batch_inverse_dx(bxs, txs)
    mask_c = fused.range_glv_match(*cpu_args, inv_c, lo, hi, rem)
    row_c = fused.pack_tail(mask_c, rem, fused.GLV_KEYS)
    d = [t.to(dev) for t in (*cpu_args, lo, hi, rem)]
    inv_d = fused.batch_inverse_dx(d[0], d[2])
    mask_d = fused.range_glv_match(*d[:4], inv_d, d[4], d[5], d[6])
    row_d = fused.pack_tail(mask_d, d[6], fused.GLV_KEYS)
    torch.cuda.synchronize()
    err_b = max_abs_err(mask_d.cpu(), mask_c)
    require(err_b == 0, f"kernel B differs from its plain version ({err_b})")
    require(torch.equal(row_d.cpu(), row_c), "packed rows differ")
    require(int((mask_c > 0).sum()) > 0, "^1C matched nothing in 2 windows")
    log(f"[4] kernel B + pack == plain on K={K} B={B}: "
        f"{int((mask_c > 0).sum())} matching lanes, rows {row_c[:, :2].tolist()}")

    # -- 5. main path through the CLI --------------------------------------
    reset_launches()
    rows, _, secs = run_cli(["generate", "-p", "^1C", "-c", "3"])
    path_launches = {"random interval": read_launches()}
    launches = path_launches["random interval"]
    require(len(rows) == 3, f"expected 3 matches, got {len(rows)}")
    confirm(rows, fmt, pat)
    require(launches["batch_inverse_dx"] > 0 and launches["range_glv_match"] > 0,
            f"a kernel was not launched on the main path: {launches}")
    log(f"[5] generate -p ^1C -c 3 (B=524288, k_sub=8) in {secs:.1f} s: "
        f"{[r['address'] for r in rows]} oracle-confirmed; launches {launches}")

    # -- 6. kernels vs plain at the main path's shape ----------------------
    K, B = sc.DEFAULT_K_SUB, sc.DEFAULT_DEVICE_BATCH
    txf, tyf = tables.ig_table(B, dev)
    bases = [2 + random.Random(11).randrange(ec.N // 2) + k * B for k in range(K)]
    pts = [ec.scalar_mult_base_fast(s) for s in bases]
    bxf = u256.as_i32(u256.from_ints([p[0] for p in pts]).T).to(dev)
    byf = u256.as_i32(u256.from_ints([p[1] for p in pts]).T).to(dev)
    remf = torch.full((K,), B, dtype=torch.int32, device=dev)
    lof, hif = lo.to(dev), hi.to(dev)
    inv_f = fused.batch_inverse_dx(bxf, txf)
    mask_f = fused.range_glv_match(bxf, byf, txf, tyf, inv_f, lof, hif, remf)
    N = K * B
    M = fused._chain_len(N)
    S = lo.shape[0]
    # bytes of the per-window bases, the table and the inverses, read once
    lane_in = 64 * K + 64 * B + 32 * N + 4 * K
    chain_ops = N * (3 * FE_MUL + INV / M + FE_ADD)
    # the x-only finish and beta x, beta^2 x of kernels B and E
    finish_x_glv = 3 * FE_MUL + FE_SQR + 4 * FE_ADD
    for kname, run, plain, ref, replaces, err_small, ops, nbytes in (
        ("batch_inverse_dx",
         lambda: fused.batch_inverse_dx(bxf, txf),
         lambda: fused.batch_inverse_dx_plain(bxf, txf),
         inv_f, "vgen_tpu/ops/pallas_fused.py:502", err_a,
         chain_ops, 32 * K + 32 * B + 32 * N),
        ("range_glv_match",
         lambda: fused.range_glv_match(bxf, byf, txf, tyf, inv_f, lof, hif, remf),
         lambda: fused.range_glv_match_plain(bxf, byf, txf, tyf, inv_f, lof, hif, remf),
         mask_f, "vgen_tpu/ops/pallas_fused.py:1271", err_b,
         N * (finish_x_glv + 6 * (HASH160 + compare(S, 5))),
         lane_in + 40 * S + 4 * N),
    ):
        ms, plain_ms, bms, bby = time_kernel(
            kname, run, plain, ref, replaces, launches[kname], err_small,
            f"K={K} B={B}", ops, nbytes)
        log(f"[6] {kname} at K={K} B={B}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bms:.3f} ms ({bby}), bit-equal ({smi})")

    # -- 7. timed scan -----------------------------------------------------
    stats = sc.benchmark_device(min_seconds=10.0)
    require(stats["keys_per_sec"] > 0, "benchmark measured no keys")
    log(f"[7] benchmark_device ^1BenchNeverMatches: "
        f"{stats['keys_per_sec']:,.0f} keys/s ({stats['operations']:,} keys "
        f"in {stats['elapsed']:.2f} s) on {smi}")

    # -- 8. kernel C + pack vs plain ---------------------------------------
    K, B = 2, 8192
    bases8 = [1 + B // 2, 0x5EED5EED5EED]  # window 0: doubling lane at B/2
    key8 = bases8[0] + 1 + 1234
    pat8 = Pattern("^" + AddressGenerator(fmt).generate(
        key8.to_bytes(32, "big")).address + "$")
    lo8, hi8 = lo_hi(pat8, fmt)
    bx8, by8 = base_points(bases8)
    rem8 = torch.tensor([B, B - 100], dtype=torch.int32)
    inv8 = fused.batch_inverse_dx(bx8, txs)
    cpu8 = (bx8, by8, txs, tys, inv8)
    dev8 = tuple(t.to(dev) for t in cpu8)
    rem8_d = rem8.to(dev)
    mask_c = fused.range_match(*cpu8, lo8, hi8, rem8)
    mask_d = fused.range_match(*dev8, lo8.to(dev), hi8.to(dev), rem8_d)
    rows_d = fused.pack_tail(mask_d, rem8_d, 1)
    torch.cuda.synchronize()
    err_c = max_abs_err(mask_d.cpu(), mask_c)
    require(err_c == 0, f"kernel C differs from its plain version ({err_c})")
    require(torch.equal(rows_d.cpu(), fused.pack_tail(mask_c, rem8, 1)),
            "kernel C: packed rows differ")
    require(int(mask_c[0, 1234]) == 1 and int(mask_c.sum()) == 1,
            "kernel C: the exact key's lane is not the only one set")
    require(int(mask_c[0, bases8[0] - 1]) == 0, "kernel C: doubling lane set")
    log(f"[8] kernel C + pack == plain on K={K} B={B} (doubling-lane window, "
        f"remaining {rem8.tolist()}): key {hex(key8)} at lane 1234, rows "
        f"{rows_d[:, :3].tolist()}")

    # -- 9. kernels D, E + pack vs plain -----------------------------------
    err_de = {"dfa_match": 0, "glv_dfa_match": 0}
    for fmt9 in (AddressFormat.P2PKH, AddressFormat.P2WPKH):
        for src in ("c[a4]t", "a.{8}$"):
            table, accept, start = dfa_tensors(Pattern(src), fmt9)
            for kname, mult in (("dfa_match", 1),
                                ("glv_dfa_match", fused.GLV_KEYS)):
                kern = wrappers[kname]
                t0 = time.time()
                m_c = kern(fmt9, *cpu8, table, accept, start, rem8)
                plain_s = time.time() - t0
                m_d = kern(fmt9, *dev8, table.to(dev), accept.to(dev), start,
                           rem8_d)
                r_d = fused.pack_tail(m_d, rem8_d, mult)
                torch.cuda.synchronize()
                err = max_abs_err(m_d.cpu(), m_c)
                err_de[kname] = max(err_de[kname], err)
                require(err == 0, f"{kname} {fmt9.value} {src}: differs ({err})")
                require(torch.equal(r_d.cpu(), fused.pack_tail(m_c, rem8, mult)),
                        f"{kname} {fmt9.value} {src}: packed rows differ")
                hits = int((m_c > 0).sum())
                require(hits > 0, f"{kname} {fmt9.value} {src}: no match")
                log(f"[9] {kname} {fmt9.value} {src!r} ({table.shape[0]} "
                    f"states) == plain on K={K} B={B}: {hits} matching lanes "
                    f"(plain on CPU {plain_s:.1f} s)")

    # -- 10. random DFA path at full width ---------------------------------
    for argv, fmt10, src in (
            (["generate", "-p", "Cat$", "-c", "3"], AddressFormat.P2PKH, "Cat$"),
            (["generate", "-f", "p2wpkh", "-p", "zzz$", "-c", "3"],
             AddressFormat.P2WPKH, "zzz$")):
        reset_launches()
        rows, _, secs = run_cli(argv)
        got = read_launches()
        path_launches[f"random dfa {fmt10.value}"] = got
        require(len(rows) == 3, f"{argv}: expected 3 matches, got {len(rows)}")
        confirm(rows, fmt10, Pattern(src))
        require(got["batch_inverse_dx"] > 0 and got["glv_dfa_match"] > 0
                and got["range_glv_match"] == 0,
                f"{argv}: launches {got}, expected kernels A and E and not B")
        log(f"[10] {' '.join(argv)} (B=524288, k_sub=8) in {secs:.1f} s: "
            f"{[r['address'] for r in rows]} oracle-confirmed; launches {got}")

    # -- 11. puzzle range at full width ------------------------------------
    key34 = 0x34A65911D
    reset_launches()
    rows, _, secs = run_cli(["range", "-p", "boha:b1000:34", "-c", "1"])
    got = path_launches["range interval"] = read_launches()
    _, _, resolved34, _ = resolve_range_params(
        "boha:b1000:34", None, fmt, None, None)
    pat34 = Pattern(resolved34)
    require(confirm(rows, fmt, pat34) == [key34],
            f"puzzle 34: expected [{hex(key34)}], got {rows}")
    require(got["batch_inverse_dx"] > 0 and got["range_match"] > 0
            and got["glv_dfa_match"] == 0 and got["dfa_match"] == 0,
            f"puzzle 34: launches {got}, expected kernels A and C only")
    ops34 = rows[0]["operations"]
    log(f"[11] range -p boha:b1000:34 -c 1: {hex(key34)} oracle-confirmed in "
        f"{secs:.1f} s; {ops34:,} keys in {rows[0]['elapsed_secs']:.3f} s = "
        f"{ops34 / rows[0]['elapsed_secs']:,.0f} range keys/s on {smi}; "
        f"launches {got}")

    # -- 12. checkpoint resume ---------------------------------------------
    key30 = 0x3D94CD64
    start30, end30, resolved30, _ = resolve_range_params(
        "boha:b1000:30", None, fmt, None, None)
    step_keys = sc.DEFAULT_K_SUB * sc.DEFAULT_DEVICE_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "puzzle30.json")
        ckpt = CheckpointManager(path, pattern=resolved30, fmt=fmt.value,
                                 start=start30, end=end30)
        scanner = sc.DeviceScanner(fmt)
        stop = StopFlag()

        def stop_after_three(ops):
            if ops >= 3 * step_keys:
                stop.set()

        leg1 = scanner.scan(Pattern(resolved30),
                            ScanConfig(format=fmt, start=start30, end=end30,
                                       checkpoint=ckpt),
                            stop_after_three, stop)
        with open(path) as f:
            saved = json.load(f)
        next30 = int(saved["next_key"], 16)
        require(not leg1.matches and saved["operations"] == leg1.operations
                and next30 == start30 + leg1.operations < key30,
                f"leg 1: {leg1.operations} ops, saved {saved}")
        first_base = []
        base_points_fn = sc.DeviceScanner._base_points

        def recording(self, scalars):
            first_base.append(scalars[0])
            return base_points_fn(self, scalars)

        sc.DeviceScanner._base_points = recording
        try:
            rows, err, secs = run_cli(["range", "-p", "boha:b1000:30", "-c", "1",
                                       "--checkpoint", path], quiet=False)
        finally:
            sc.DeviceScanner._base_points = base_points_fn
    require(f"Resuming from checkpoint: next key {hex(next30)}" in err,
            "leg 2 did not report the resume")
    require(first_base and first_base[0] + 1 == next30,
            f"leg 2's first window starts at {hex(first_base[0] + 1)}, "
            f"saved next_key {hex(next30)}")
    require(confirm(rows, fmt, Pattern(resolved30)) == [key30],
            f"puzzle 30 resumed: expected [{hex(key30)}], got {rows}")
    offset = key30 - start30 + 1
    ops30 = rows[0]["operations"]
    require(offset <= ops30 <= offset + step_keys,
            f"leg 2: operations {ops30} outside [{offset}, {offset + step_keys}]")
    log(f"[12] puzzle 30: leg 1 stopped at next_key {hex(next30)} "
        f"({leg1.operations:,} ops); leg 2 resumed there and found "
        f"{hex(key30)} in {secs:.1f} s, operations {ops30:,} (key offset "
        f"{offset:,})")

    # -- 13. full-width DFA range against the native scanner ----------------
    require(native.available(), "the native CPU scanner did not build")
    src13 = "[Cc]at"
    start13 = 0xC0FFEE000000
    end13 = start13 + 2 * sc.DEFAULT_DEVICE_BATCH - 1
    reset_launches()
    rows, _, secs = run_cli(["range", "-r", f"{start13:x}:{end13:x}", "-p",
                             src13, "-c", "0"])
    got = path_launches["range dfa"] = read_launches()
    keys13 = sorted(confirm(rows, fmt, Pattern(src13)))
    t0 = time.time()
    ref13 = _scan_cpu(Pattern(src13), ScanConfig(
        format=fmt, start=start13, end=end13, count=0, use_device=False),
        None, None)
    native_s = time.time() - t0
    want13 = sorted(int(m.hex, 16) for m in ref13.matches)
    require(keys13 == want13 and len(keys13) > 2 * pipeline.TOP_K,
            f"DFA range: {len(keys13)} matches, native {len(want13)}")
    require(rows[0]["operations"] == ref13.operations == end13 - start13 + 1,
            f"DFA range: operations {rows[0]['operations']}, native "
            f"{ref13.operations}")
    require(got["batch_inverse_dx"] > 0 and got["dfa_match"] > 0
            and got["range_match"] == 0 and got["glv_dfa_match"] == 0,
            f"DFA range: launches {got}, expected kernels A and D only")
    log(f"[13] range {start13:x}:{end13:x} -p {src13} -c 0: {len(keys13)} "
        f"matches in {secs:.1f} s == native scanner's ({native_s:.1f} s); "
        f"launches {got}")

    # -- 14. kernels C, D, E vs plain at the main shape --------------------
    # patterns that hit often, so that a wrong parity or hash shows: kernel
    # C takes the ^1C intervals of phase 6 (one key per lane)
    K, B = sc.DEFAULT_K_SUB, sc.DEFAULT_DEVICE_BATCH
    shape = f"K={K} B={B}"
    tab_d, acc_d, st_d = (t.to(dev) if torch.is_tensor(t) else t
                          for t in dfa_tensors(Pattern(src13), fmt))
    tab_e, acc_e, st_e = (t.to(dev) if torch.is_tensor(t) else t
                          for t in dfa_tensors(Pattern("Cat$"), fmt))
    lanes_f = (bxf, byf, txf, tyf, inv_f)
    # Base58Check of a P2PKH address: two more SHA-256 compressions, 49
    # 64-bit divisions by 58^5 (8 each), 35 digit splits (5) and the
    # 35-step walk
    b58_walk = 2 * SHA256 + np.array([0, 49 * 8 + 35 * 5]) + 35 * DFA_STEP
    finish_xy = 2 * FE_MUL + FE_SQR + 6 * FE_ADD
    for kname, run, plain, replaces, path, err_small, ops, nbytes in (
        ("range_match",
         lambda: fused.range_match(*lanes_f, lof, hif, remf),
         lambda: fused.range_match_plain(*lanes_f, lof, hif, remf),
         "vgen_tpu/ops/pallas_fused.py:1243", "range interval", err_c,
         N * (finish_xy + HASH160 + compare(S, 5)), lane_in + 40 * S + 4 * N),
        ("dfa_match",
         lambda: fused.dfa_match(fmt, *lanes_f, tab_d, acc_d, st_d, remf),
         lambda: fused.dfa_match_plain(fmt, *lanes_f, tab_d, acc_d, st_d, remf),
         "vgen_tpu/ops/pallas_fused.py:165", "range dfa", err_de["dfa_match"],
         N * (finish_xy + HASH160 + b58_walk),
         lane_in + 4 * (tab_d.numel() + acc_d.numel()) + 4 * N),
        ("glv_dfa_match",
         lambda: fused.glv_dfa_match(fmt, *lanes_f, tab_e, acc_e, st_e, remf),
         lambda: fused.glv_dfa_match_plain(fmt, *lanes_f, tab_e, acc_e, st_e,
                                           remf),
         "vgen_tpu/ops/pallas_fused.py:190", "random dfa p2pkh",
         err_de["glv_dfa_match"],
         N * (finish_x_glv + 6 * (HASH160 + b58_walk)),
         lane_in + 4 * (tab_e.numel() + acc_e.numel()) + 4 * N),
    ):
        ref = run()
        hits = int((ref > 0).sum())
        require(hits > 0, f"{kname} at {shape}: no matching lane")
        ms, plain_ms, bms, bby = time_kernel(
            kname, run, plain, ref, replaces, path_launches[path][kname],
            err_small, shape, ops, nbytes)
        log(f"[14] {kname} at {shape}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bms:.3f} ms ({bby}), bit-equal, "
            f"{hits} matching lanes ({smi})")
        del ref

    # -- 15. timed DFA scan -------------------------------------------------
    reset_launches()
    stats = sc.benchmark_device(AddressFormat.P2PKH, "BenchNeverMatches$",
                                min_seconds=5.0)
    got = read_launches()
    require(stats["keys_per_sec"] > 0, "DFA benchmark measured no keys")
    require(got["glv_dfa_match"] > 0 and got["range_glv_match"] == 0,
            f"DFA benchmark: launches {got}, expected kernel E and not B")
    log(f"[15] benchmark_device BenchNeverMatches$ (P2PKH, GLV DFA): "
        f"{stats['keys_per_sec']:,.0f} keys/s ({stats['operations']:,} keys "
        f"in {stats['elapsed']:.2f} s) on {smi}")

    # -- 16. kernels F, G, H, I vs plain ------------------------------------
    p2tr = AddressFormat.P2TR
    K, B = 2, 8192
    wt_c = tables.window_table("cpu")
    wt_d = wt_c.to(dev)
    bases16 = [1 + B // 2, 0x5EED5EED5EED]  # window 0: doubling lane at B/2
    bx16, by16 = base_points(bases16)
    rem16 = torch.tensor([B, B - 100], dtype=torch.int32)
    inv16 = fused.batch_inverse_dx(bx16, txs)
    cpu16 = (bx16, by16, txs, tys, inv16)
    dev16 = tuple(t.to(dev) for t in cpu16)
    err16 = {}

    def same(kname, got, want, what=""):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(g.cpu(), w) for g, w in zip(got, want))
        err16[kname] = max(err16.get(kname, 0), err)
        require(err == 0, f"{kname}{what} differs from its plain version "
                f"({err})")

    t0 = time.time()
    F_c = fused.p2tr_ladder(*cpu16, wt_c)
    plain_s = time.time() - t0
    F_d = fused.p2tr_ladder(*dev16, wt_d)
    torch.cuda.synchronize()
    same("p2tr_ladder", F_d, F_c)
    require(int(F_c[2].sum()) == K * B - 1 and int(F_c[2][bases16[0] - 1]) == 0,
            "kernel F: ok is not 1 on every lane but the doubling lane")
    xa, ya = (t[:, :4096].contiguous() for t in (txs, tys))
    Fa_c = fused.p2tr_ladder_affine(xa, ya, wt_c)
    Fa_d = fused.p2tr_ladder_affine(xa.to(dev), ya.to(dev), wt_d)
    torch.cuda.synchronize()
    same("p2tr_ladder", Fa_d, Fa_c, " (finish=False)")
    Zg = F_c[1].clone()
    Zg[:, 77] = 0  # a dead lane's Z
    G_c = fused.batch_inverse_chain(Zg)
    same("batch_inverse_chain", fused.batch_inverse_chain(Zg.to(dev)), G_c)
    require(u256.to_ints(G_c[:, 77:78]) == [1], "kernel G: zero not guarded to 1")
    X_c, Z_c, ok_c = F_c
    zi_c = fused.batch_inverse_chain(Z_c)
    X_d, Z_d, ok_d = F_d
    zi_d = fused.batch_inverse_chain(Z_d)
    same("batch_inverse_chain", zi_d, zi_c)
    lo16, hi16 = lo_hi(Pattern("^bc1pq"), p2tr)
    H_c = fused.p2tr_finish_range(X_c, Z_c, zi_c, ok_c, lo16, hi16, rem16)
    H_d = fused.p2tr_finish_range(X_d, Z_d, zi_d, ok_d, lo16.to(dev),
                                  hi16.to(dev), rem16.to(dev))
    tab16, acc16, st16 = dfa_tensors(Pattern("q$"), p2tr)
    I_c = fused.p2tr_finish_match(X_c, Z_c, zi_c, ok_c, tab16, acc16, st16,
                                  rem16)
    I_d = fused.p2tr_finish_match(X_d, Z_d, zi_d, ok_d, tab16.to(dev),
                                  acc16.to(dev), st16, rem16.to(dev))
    torch.cuda.synchronize()
    same("p2tr_finish_range", H_d, H_c)
    same("p2tr_finish_match", I_d, I_c)
    require(int(H_c.sum()) > 0 and int(I_c.sum()) > 0,
            "kernels H, I: no matching lane")
    require(int(H_c[0, bases16[0] - 1]) == 0 and int(H_c[1, B - 100:].sum()) == 0,
            "kernel H: a dead or out-of-window lane is set")
    log(f"[16] kernels F (both flags), G (zero lane 77 -> 1), H (^bc1pq, "
        f"{int(H_c.sum())} lanes), I (q$, {int(I_c.sum())} lanes) == plain on "
        f"K={K} B={B} (plain ladder on CPU {plain_s:.1f} s)")
    del F_d, Fa_d, X_d, Z_d, ok_d, zi_d

    # -- 17, 18. random P2TR paths at full width through the CLI -------------
    for argv, src, path, on, off in (
            (["generate", "-f", "p2tr", "-p", "^bc1pqq", "-c", "3"], "^bc1pqq",
             "random interval p2tr", "p2tr_finish_range", "p2tr_finish_match"),
            (["generate", "-f", "p2tr", "-p", "qq$", "-c", "3"], "qq$",
             "random dfa p2tr", "p2tr_finish_match", "p2tr_finish_range")):
        reset_launches()
        rows, _, secs = run_cli(argv)
        got = path_launches[path] = read_launches()
        require(len(rows) == 3, f"{argv}: expected 3 matches, got {len(rows)}")
        confirm(rows, p2tr, Pattern(src))
        require(all(got[k] > 0 for k in ("batch_inverse_dx", "p2tr_ladder",
                                         "batch_inverse_chain", on))
                and got[off] == 0,
                f"{argv}: launches {got}, expected A, F, G, {on} and not {off}")
        phase = 17 if on == "p2tr_finish_range" else 18
        log(f"[{phase}] {' '.join(argv)} (B=524288, k_sub=8) in {secs:.1f} s: "
            f"{[r['address'] for r in rows]} oracle-confirmed; launches {got}")

    # -- 19. full-width P2TR DFA range against the native scanner -----------
    src19 = "qq$"
    start19 = 0xBEEF00000000
    end19 = start19 + 2 * sc.DEFAULT_DEVICE_BATCH - 1
    reset_launches()
    rows, _, secs = run_cli(["range", "-f", "p2tr", "-r",
                             f"{start19:x}:{end19:x}", "-p", src19, "-c", "0"])
    got = path_launches["range dfa p2tr"] = read_launches()
    # the Python oracle takes tens of ms per P2TR key: it re-derives a
    # sample, and the whole set is held against the native scanner's
    keys19 = sorted(int(r["private_key_hex"], 16) for r in rows)
    confirm(random.Random(19).sample(rows, min(32, len(rows))), p2tr,
            Pattern(src19))
    t0 = time.time()
    ref19 = _scan_cpu(Pattern(src19), ScanConfig(
        format=p2tr, start=start19, end=end19, count=0, use_device=False),
        None, None)
    native_s = time.time() - t0
    want19 = sorted(int(m.hex, 16) for m in ref19.matches)
    require(keys19 == want19 and len(keys19) > 2 * pipeline.TOP_K,
            f"P2TR DFA range: {len(keys19)} matches, native {len(want19)}")
    require(rows[0]["operations"] == ref19.operations == end19 - start19 + 1,
            f"P2TR DFA range: operations {rows[0]['operations']}, native "
            f"{ref19.operations}")
    require(got["p2tr_finish_match"] > 0 and got["p2tr_finish_range"] == 0,
            f"P2TR DFA range: launches {got}, expected kernel I and not H")
    log(f"[19] range -f p2tr {start19:x}:{end19:x} -p {src19} -c 0: "
        f"{len(keys19)} matches in {secs:.1f} s == native scanner's "
        f"({native_s:.1f} s); launches {got}")

    # -- 20. kernels F, G, H, I vs plain at the main shape --------------------
    K, B = sc.DEFAULT_K_SUB, sc.DEFAULT_DEVICE_BATCH
    N = K * B
    shape = f"K={K} B={B}"
    lanes20 = (bxf, byf, txf, tyf, inv_f)
    X_f, Z_f, ok_f = ref_f = fused.p2tr_ladder(*lanes20, wt_d)
    zi_f = fused.batch_inverse_chain(Z_f)
    lo20, hi20 = lo16.to(dev), hi16.to(dev)
    S20 = lo20.shape[0]
    tab20, acc20 = tab16.to(dev), acc16.to(dev)

    def ladder_adds(x):
        """The nonzero digits of the tweaks of x ((8, n) int64): the
        ladder's adds on this run's data."""
        t = sha256.tagged_hash_32(fused.TAPTWEAK_MIDSTATE, x)
        return int(sum(((t[w // 4] >> (8 * (w % 4))) & 255).ne(0).sum()
                       for w in range(32)))

    x3, _, _ = curve.ec_finish(*fused._lanes(*lanes20))
    adds = ladder_adds(x3.reshape(8, N))
    del x3
    # the plain ladder on one window first: K = 8 only if it fits in 60 s
    inv_1 = inv_f[:, :B].contiguous()
    plain_1 = lambda: fused.p2tr_ladder_plain(bxf[:1], byf[:1], txf, tyf,
                                              inv_1, wt_d)
    plain_k8_s = cuda_ms(plain_1, 1, warm=False) * K / 1e3
    if plain_k8_s <= 60:
        plain_f = lambda: fused.p2tr_ladder_plain(*lanes20, wt_d)
        ref_plain, plain_shape = ref_f, shape
    else:
        plain_f = plain_1
        ref_plain = (X_f[:, :B], Z_f[:, :B], ok_f[:B])
        plain_shape = f"K=1 B={B} (K=8 estimated at {plain_k8_s:.0f} s)"
    # per lane: the even-Y negation, the tweak's compression and t < n;
    # per add (8M + 3S): six subtractions and 2V as an addition
    tweak_ops = FE_ADD + SHA256 + np.array([0, 16])
    add_ops = 8 * FE_MUL + 3 * FE_SQR + 7 * FE_ADD
    ladder_ops = N * (finish_xy + tweak_ops) + adds * add_ops
    finish_ops = N * (FE_MUL + FE_SQR)
    finish_in = 100 * N + 4 * K
    # bech32m: 58 five-bit groups (2 each: the witness program's 52 and the
    # checksum's 6) and 58 polymod steps on them (12 each: shift, mask,
    # the symbol's XOR and five conditional XORs of 2; the human-readable
    # part and the witness version fold to constants); the 60-step walk
    bech32m_walk = np.array([0, 58 * (2 + 12)]) + 60 * DFA_STEP
    for kname, run, plain, ref, replaces, path, ops, nbytes, pshape in (
        ("p2tr_ladder",
         lambda: fused.p2tr_ladder(*lanes20, wt_d), plain_f, ref_plain,
         "vgen_tpu/ops/pallas_fused.py:931", "random interval p2tr",
         ladder_ops, lane_in + 32 * 256 * 2 * 8 * 4 + 68 * N, plain_shape),
        ("batch_inverse_chain",
         lambda: fused.batch_inverse_chain(Z_f),
         lambda: fused.batch_inverse_chain_plain(Z_f), zi_f,
         "vgen_tpu/ops/pallas_fused.py:441", "random interval p2tr",
         N * (3 * FE_MUL + INV / fused._chain_len(N) + np.array([0, 8])),
         64 * N, shape),
        ("p2tr_finish_range",
         lambda: fused.p2tr_finish_range(X_f, Z_f, zi_f, ok_f, lo20, hi20, remf),
         lambda: fused.p2tr_finish_range_plain(X_f, Z_f, zi_f, ok_f, lo20, hi20,
                                               remf), None,
         "vgen_tpu/ops/pallas_fused.py:1074", "random interval p2tr",
         finish_ops + N * compare(S20, 8), finish_in + 64 * S20 + 4 * N,
         shape),
        ("p2tr_finish_match",
         lambda: fused.p2tr_finish_match(X_f, Z_f, zi_f, ok_f, tab20, acc20,
                                         st16, remf),
         lambda: fused.p2tr_finish_match_plain(X_f, Z_f, zi_f, ok_f, tab20,
                                               acc20, st16, remf), None,
         "vgen_tpu/ops/pallas_fused.py:1028", "random dfa p2tr",
         finish_ops + N * bech32m_walk,
         finish_in + 4 * (tab20.numel() + acc20.numel()) + 4 * N, shape),
    ):
        if ref is None:
            ref = run()
        hits = int((ok_f if kname == "p2tr_ladder" else ref).ne(0).sum())
        require(hits > 0, f"{kname} at {shape}: no live or matching lane")
        ms, plain_ms, bms, bby = time_kernel(
            kname, run, plain, ref, replaces, path_launches[path][kname],
            err16[kname], pshape, ops, nbytes, reps=3)
        log(f"[20] {kname} at {shape}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms at {pshape}, bound {bms:.3f} ms ({bby}), "
            f"bit-equal, {hits} live/matching lanes ({smi})")
        del ref
    xa_f, ya_f = txf[:, :B].contiguous(), tyf[:, :B].contiguous()
    aff_ms = cuda_ms(lambda: fused.p2tr_ladder_affine(xa_f, ya_f, wt_d), 3)
    aff_plain_ms = cuda_ms(lambda: plain_out.append(
        fused.p2tr_ladder_affine_plain(xa_f, ya_f, wt_d)), 1, warm=False)
    same("p2tr_ladder", fused.p2tr_ladder_affine(xa_f, ya_f, wt_d),
         tuple(t.cpu() for t in plain_out.pop()), f" (finish=False) at N={B}")
    adds_aff = ladder_adds(u256.to_i64(xa_f))
    aff_bound, aff_by = bound(B * tweak_ops + adds_aff * add_ops,
                              (64 + 68) * B + 32 * 256 * 2 * 8 * 4,
                              sm_clocks_per_s)
    require(aff_ms >= aff_bound, f"p2tr_ladder (finish=False): {aff_ms:.3f} "
            f"ms beats its bound {aff_bound:.3f} ms")
    log(f"[20] p2tr_ladder (finish=False) at N={B}: kernel {aff_ms:.3f} ms, "
        f"plain {aff_plain_ms:.1f} ms, bound {aff_bound:.3f} ms ({aff_by}), "
        f"bit-equal, {adds_aff:,} adds; the "
        f"finish=True ladder did {adds:,} adds on {N:,} lanes ({smi})")
    del X_f, Z_f, ok_f, ref_f, zi_f, ref_plain
    torch.cuda.empty_cache()

    # -- 21. timed P2TR scans, both routes -----------------------------------
    for src, route, on, off in (
            ("^bc1p" + "q" * 26, "interval", "p2tr_finish_range",
             "p2tr_finish_match"),
            ("z" * 20 + "$", "DFA", "p2tr_finish_match", "p2tr_finish_range")):
        reset_launches()
        stats = sc.benchmark_device(p2tr, src, min_seconds=5.0,
                                    warmup_batches=1)
        got = read_launches()
        require(stats["keys_per_sec"] > 0, f"P2TR {route} benchmark: no keys")
        require(got[on] > 0 and got[off] == 0,
                f"P2TR {route} benchmark: launches {got}, expected {on} and "
                f"not {off}")
        log(f"[21] benchmark_device {src[:8]}... (P2TR {route}, one key per "
            f"position): {stats['keys_per_sec']:,.0f} keys/s "
            f"({stats['operations']:,} keys in {stats['elapsed']:.2f} s) on "
            f"{smi}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
