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
   vgen_tpu.crypto oracle; both kernels' launch counters > 0 in that run;
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
    (BenchNeverMatches$, P2PKH, GLV, about 5 s) through kernel E.

Each path's launch counters are set to 0 just before it runs and read just
after.  Tolerance everywhere: exact (the values are integers).  The line
before the last is the kernels' JSON summary, the last line the device
JSON.
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

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() over reps calls, by CUDA events
    (one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def main():
    import numpy as np
    import torch

    # -- 1. the card ----------------------------------------------------
    require(torch.cuda.is_available(), "no CUDA device is visible")
    sys.path.insert(0, HERE)
    import vgen_tpu_torch

    require(os.path.dirname(os.path.abspath(vgen_tpu_torch.__file__))
            == os.path.join(HERE, "vgen_tpu_torch"),
            "vgen_tpu_torch is not in this checkout")
    from vgen_tpu import native
    from vgen_tpu.cli import resolve_range_params
    from vgen_tpu.crypto import secp256k1 as ec
    from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
    from vgen_tpu.pattern import Pattern
    from vgen_tpu.scan.checkpoint import CheckpointManager
    from vgen_tpu.scan.scanner import ScanConfig, StopFlag, _scan_cpu
    from vgen_tpu_torch import cli
    from vgen_tpu_torch.csrc import build
    from vgen_tpu_torch.ops import fused, pipeline, u256
    from vgen_tpu_torch.scan import scanner as sc
    from vgen_tpu_torch.scan import tables

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[1] card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | python {sys.version.split()[0]} | devices {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    wrappers = {"batch_inverse_dx": fused.batch_inverse_dx,
                "range_glv_match": fused.range_glv_match,
                "range_match": fused.range_match,
                "dfa_match": fused.dfa_match,
                "glv_dfa_match": fused.glv_dfa_match}

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
            ivs, n_slots=pipeline.interval_slot_count(len(ivs)))
        return u256.as_i32(lo_np), u256.as_i32(hi_np)

    def dfa_tensors(pat, fmt):
        dfa = pat.device_dfa(fmt)
        return (torch.from_numpy(dfa.table.astype(np.int32)),
                torch.from_numpy(dfa.accept.astype(np.int32)), int(dfa.start))

    kernels = []

    def time_kernel(kname, run, plain, ref, replaces, launches, err_small,
                    shape):
        """Hold the plain version against the kernel's output ``ref`` at the
        timed shape, time both, and add the kernel's JSON entry."""
        plain_out = plain()
        err = max_abs_err(plain_out, ref)
        require(err == 0, f"{kname} differs from its plain version at {shape}")
        del plain_out
        ms = cuda_ms(run, 10)
        plain_ms = cuda_ms(plain, 1)
        torch.cuda.empty_cache()
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "vgen_tpu_torch/csrc/kernels.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": max(err, err_small),
            "ms": ms, "plain_ms": plain_ms,
        })
        return ms, plain_ms

    # -- 2. build -------------------------------------------------------
    t0 = time.time()
    build.load()
    log(f"[2] kernels built+loaded in {time.time() - t0:.1f} s: "
        f"{build.library_path().name}")
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
    for kname, run, plain, ref, replaces, err_small in (
        ("batch_inverse_dx",
         lambda: fused.batch_inverse_dx(bxf, txf),
         lambda: fused.batch_inverse_dx_plain(bxf, txf),
         inv_f, "vgen_tpu/ops/pallas_fused.py:502", err_a),
        ("range_glv_match",
         lambda: fused.range_glv_match(bxf, byf, txf, tyf, inv_f, lof, hif, remf),
         lambda: fused.range_glv_match_plain(bxf, byf, txf, tyf, inv_f, lof, hif, remf),
         mask_f, "vgen_tpu/ops/pallas_fused.py:1271", err_b),
    ):
        ms, plain_ms = time_kernel(kname, run, plain, ref, replaces,
                                   launches[kname], err_small, f"K={K} B={B}")
        log(f"[6] {kname} at K={K} B={B}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bit-equal ({smi})")

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
    for kname, run, plain, replaces, path, err_small in (
        ("range_match",
         lambda: fused.range_match(*lanes_f, lof, hif, remf),
         lambda: fused.range_match_plain(*lanes_f, lof, hif, remf),
         "vgen_tpu/ops/pallas_fused.py:1243", "range interval", err_c),
        ("dfa_match",
         lambda: fused.dfa_match(fmt, *lanes_f, tab_d, acc_d, st_d, remf),
         lambda: fused.dfa_match_plain(fmt, *lanes_f, tab_d, acc_d, st_d, remf),
         "vgen_tpu/ops/pallas_fused.py:165", "range dfa", err_de["dfa_match"]),
        ("glv_dfa_match",
         lambda: fused.glv_dfa_match(fmt, *lanes_f, tab_e, acc_e, st_e, remf),
         lambda: fused.glv_dfa_match_plain(fmt, *lanes_f, tab_e, acc_e, st_e,
                                           remf),
         "vgen_tpu/ops/pallas_fused.py:190", "random dfa p2pkh",
         err_de["glv_dfa_match"]),
    ):
        ref = run()
        hits = int((ref > 0).sum())
        require(hits > 0, f"{kname} at {shape}: no matching lane")
        ms, plain_ms = time_kernel(kname, run, plain, ref, replaces,
                                   path_launches[path][kname], err_small, shape)
        log(f"[14] {kname} at {shape}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bit-equal, {hits} matching lanes ({smi})")
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

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
