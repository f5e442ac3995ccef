#!/usr/bin/env python3
"""Smoke run of vgen_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises and exits non-zero):

1. a CUDA card is visible; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from vgen_tpu_torch/csrc (nvcc, sm_90a; the
   units kernels, p2tr and tables and the probe unit, one nvcc each,
   started together);
3. kernel A (batch_inverse_dx) against its plain PyTorch version: random
   canonical inputs from a numpy seed, K = 2, B = 8192, one forced zero-dx
   lane; bit-equal at the product's geometry (chains of M, groups of G
   threads sharing an inversion, ``fused.INV_GEOMETRY``) and at (64, 1),
   one inversion per thread; x * inv = 1 (mod p) on 64 sampled lanes;
4. kernel B (range_glv_match) and the pack tail against the plain versions
   on CPU: real i*G table and base points, pattern ^1C, K = 2, B = 8192;
   masks and packed rows bit-equal;
5. the first scanner's i*G table (524288 points) built on the card
   (kernels T1, G, T2: ``scan/tables.py`` ``build_multiples``) as a stage
   of its own: wall milliseconds with the host's base points, each
   kernel's by CUDA events, the table bit-equal to the host build
   (``build_ig_table_limbs``, the oracle, timed beside it); then the main
   path at full width through the CLI: ``generate -p ^1C -c 3`` (P2PKH,
   B = 524288, k_sub = 8); every match re-derived by the
   vgen_tpu_torch.crypto oracle; kernels A, B, T1, G and T2 launched in
   that run; then a cold ``generate -p ^1C -c 1 --no-tui`` in a new
   process, its time to the first match, with the table's npz removed
   before and still absent after (the card path reads and writes none),
   beside the time of a process that only imports, opens the card and
   loads the kernels;
6. kernels A and B and their plain versions timed at the main path's shape
   (K = 8, B = 524288) with CUDA events, outputs compared again; kernel A
   also at (M, G) = (64, 1), once, beside the product's geometry; T1 and
   T2 bit-equal to their plain versions at two rows of 1000 columns (T2
   in both layouts), then timed at the i*G table (a T1 call is all its
   launches);
7. a timed benchmark_device run (^1BenchNeverMatches, about 10 s);
8. kernel C (range_match) and the pack against the plain versions on CPU,
   P2PKH and P2WPKH: K = 2, B = 8192, one window based below B (it holds
   the doubling lane), a partial window, an exact-address pattern whose
   key's lane must be set;
9. kernels D (dfa_match) and E (glv_dfa_match) and the pack against the
   plain versions on CPU, P2PKH and P2WPKH, patterns c[a4]t and a.{8}$
   (514 DFA states, over D's shared-memory budget: D takes it in the
   global form and refuses the shared one); D in both table forms where
   the table fits; masks and rows bit-equal, matches > 0;
10. the random DFA path at full width through the CLI: ``generate -p Cat$
    -c 3`` and ``generate -f p2wpkh -p zzz$ -c 3``; oracle-confirmed;
    kernels A and E launched, B not;
11. the puzzle range at full width: ``range -p boha:b1000:34 -c 1`` returns
    key 0x34A65911D (oracle-confirmed) through kernels A and C; keys/s;
12. checkpoint resume on puzzle 30: leg 1 stops after a few super-steps,
    leg 2 (through the CLI) starts at the saved next_key and returns
    0x3D94CD64, its operations the total since the range's start;
13. a full-width DFA range of two windows (1048576 keys, [Cc]at, -c 0)
    through kernels A and D (the shared form): the match set equals the
    native CPU scanner's over the same range, key for key; the same range
    on a.{8}$ -c 1 through D's global form, and P2WPKH's DFA range ([Cc]at,
    -c 0) and interval range (^bc1qq, -c 1), each equal to the native
    scanner's;
14. kernels C, D and E and their plain versions timed at K = 8,
    B = 524288 on patterns that hit often (^1C, [Cc]at, Cat$; P2WPKH
    ^bc1qq and [Cc]at), outputs compared again, matching lanes > 0 for
    each: C and D for P2PKH and P2WPKH, D in both table forms (the rows
    ``dfa_match[global]``, ``range_match[p2wpkh]``, ``dfa_match[p2wpkh]``);
    C and D on the per-lane grid (the probe unit's ``c_lane``, ``d_lane``)
    timed once beside, their outputs held to the product's;
15. a timed benchmark_device run on a DFA pattern that never matches
    (BenchNeverMatches$, P2PKH, GLV, about 5 s) through kernel E;
16. the ladder table of the product's window schedule
    (``fused.LADDER_WINDOW``, 17 windows of 32769 entries) built on the
    card (T1, G, T2, the ladder layout) as a stage of its own, bit-equal to
    the host build (``ladder_table_limbs``, timed beside it); the P2TR
    kernels F (p2tr_ladder, finish=True, and its
    finish=False form on affine points, with the product's table and with
    the JAX package's 8-bit one), G (batch_inverse_chain at the product's
    geometry and at (64, 1), with a forced zero-Z lane), H
    (p2tr_finish_range, ^bc1pq) and I (p2tr_finish_match, q$) against
    their plain versions on CPU: real tables and base points, K = 2, B =
    8192, one window based below B (the doubling lane; and key 10286,
    whose first add at 16 signed bits meets its own point, its output key
    held to the oracle's); bit-equal, matching lanes > 0; I also in both
    table forms on q$ and on a.{7}$ (258 states, over the shared-memory
    budget D and I share, within the shared form's cap: the global form by
    default), and on a.{8}$ (514, over the cap) in the global form, the
    shared one refused, each form's launch counted; then a cold
    ``generate -f p2tr -p ^bc1pqq -c 1 --no-tui`` in a new process, its
    time to the first match, with both tables' npz files removed before
    (the oracle above wrote the ladder table's) and still absent after;
17. ``generate -f p2tr -p ^bc1pqq -c 3`` at full width: oracle-confirmed;
    kernels A, F, G, H, T1 and T2 launched, I not;
18. ``generate -f p2tr -p qq$ -c 3``: kernels A, F, G and I (its shared
    form, ``fused.p2tr_finish_match.forms``), H not;
19. a full-width P2TR DFA range of two windows (1048576 keys, qq$, -c 0)
    through I's shared form: the match set equals the native CPU
    scanner's, key for key; the same range on a.{8}$ -c 1 through I's
    global form returns the native scanner's lowest key;
20. kernels F, G, H and I and their plain versions timed at K = 8,
    B = 524288 with CUDA events, outputs compared again (the plain ladder
    at K = 1 when K = 8 would take over 60 s, judged from one window),
    I in both table forms (the row ``p2tr_finish_match[global]``), and
    F's finish=False form at N = 524288; F on the 8-bit table, G at (64,
    1) and I on the per-lane grid (the probe unit's ``i_lane``) timed once
    beside them, their outputs (F's output key x and ok) held to the
    product's;
21. timed benchmark_device runs (about 5 s each) on P2TR patterns that
    never match: an interval pattern through kernels A, F, G and H, and a
    suffix through A, F, G and I.
22. kernels B, C, D and E for P2SH-P2WPKH, uncompressed P2PKH and
    Ethereum (csrc/kernels.cu) against their plain versions on CPU: real
    tables and base points, K = 2, B = 8192, one window based below B;
    interval patterns ^3A, ^1A, ^0x1, ^0xab and DFA patterns c[a4]t, Ab$
    and a.{8}$, D also on a.{10}$ for Ethereum (over the shared form's
    cap there);
    D in each table form a table takes; masks and packed rows bit-equal,
    matching lanes > 0;
23. ``generate -f <fmt> -c 3`` at full width for each of the three formats
    on an interval pattern (^3Ab, ^1Ab, ^0xabc: kernels A and B, not E) and
    a DFA pattern (Cat$, Cat$, Abc$: A and E, not B), oracle-confirmed; and
    ``generate -f ethereum -i -p ^0xabcd -c 3``, whose case-insensitive
    interval route is exact (^0xabc's is a prefilter);
24. full-width range scans of the three formats: a DFA range of two
    windows (1048576 keys, -c 0) through kernels A and D whose match set
    equals the native scanner's, and an interval range (-c 1: ^0xab, ^3Ab,
    ^1Ab) through A and C that returns the native scanner's lowest key;
25. kernels B, C, D and E of the three formats and their plain versions
    timed at K = 8, B = 524288 with CUDA events, outputs compared again,
    matching lanes > 0;
26. timed benchmark_device runs (about 5 s each) of the three formats on a
    never-matching DFA suffix, and of P2SH-P2WPKH and uncompressed P2PKH on
    a never-matching interval pattern (Ethereum's interval route is timed
    by the benchmark's cell ``eth-vanity.zeros``);
27. the probe kernels of the measurement tools (``vgen_tpu_torch/probes``,
    built in phase 2 beside the product's units): every instance of
    probe_primitive, probe_issue and probe_fieldmul bit-equal to its plain
    version on the CPU at N = 4096; then each timed once at N = 524288 as
    the tools time it, t(R) and t(2R) (R gives a delta of about 1-2 ms,
    the tools' noise floor), with its launches counted, compared with its
    plain version on the card at R = 16, and its launch of 2R repetitions
    held against its bound (2R x N x the model's count at the published
    rates, or its bytes): a probe below its bound means the model's rate
    is wrong, and fails the run;
28. the stage and geometry probes (the same unit, nothing new to build):
    every instance of probe_glv_stage (seven modes), probe_vtile (V = 1,
    2, 4 keys per thread x T = 64-512 threads), probe_rows (three row
    shapes, with and without the multiply) and probe_layout (four
    layouts) bit-equal to its plain version on the CPU at N = 4096 (the
    rows at 256 steps, the stage inputs with their forced ec lanes), the
    tile instances and full also to production kernel B on the card; then
    each timed once at its tool's shape with CUDA events (one window of
    524288 lanes; 1024 x 128 lanes of 8192 steps; 2^20 lanes at R = 8),
    its launches counted, held bit-equal to its plain version on the card
    (and the tiles to kernel B) and against its bound, with the new
    kernels' ptxas figures; probe_single_key's 11 modes (kernel D
    cut by stage; C and D over the persistent tile loop, D with symbol
    arrays, and both on the per-lane grid) the same way at two windows of
    4096 lanes and at profile_dfa's K = 8 windows of 524288; and
    probe_p2tr_match's 7 modes (kernel I cut after qx and after the
    bech32m checksum by table lookups and by the polymod; I with the
    polymod, under a minimum of 4 blocks per SM and with symbol arrays;
    the per-lane I) at two windows of 4096 lanes and at profile_p2tr_match's
    shape;
29. the range DFA rate per format: 64 whole super-steps (268,435,456
    keys) of a never-matching suffix through kernels A and D (in the form
    its table takes), after one warm-up super-step;
30. the mesh (``parallel/mesh.py`` ``MeshScanner``, B = 8192, k_sub = 2)
    on one device slot (``["cuda:0"]``) and on two (``["cuda:0",
    "cuda:0"]``: the card holds both devices of the mesh) against
    DeviceScanner over the same windows and base scalars: the ^1C
    interval route with GLV (A, B), a random DFA route (c[a4]t: A, E) and a
    range DFA route ([Cc][a4]t, the last window partial: A, D), two
    super-batches each (the second replays every slot's CUDA graph, and
    the two slots on one card share one graph output); packed rows equal,
    matches > 0, each kernel launched once per device slot and
    super-batch;
31. an NCCL process group at world size 1 (tcp://127.0.0.1, the card
    machine has one card), then ``scan_with_progress(mesh=True)``: ^1C
    -c 1 (A, B), P2TR ^bc1pqq -c 1 (A, F, G, H) and qq$ -c 1 (A, F, G,
    I), each match re-derived by the oracle, phase 13's 1,048,576-key DFA
    range with a checkpoint (A, D), whose matches equal the native
    scanner's, and that range on ^1C -c 1 (A, C), the native scanner's
    lowest key;
32. the mesh's random scan of ^1BenchNeverMatches at world size 1 (B =
    524288, k_sub = 8) under the NCCL group (an all_gather every
    super-step) and without a group (built before phase 31: no
    collective) against DeviceScanner's, in turns (2 s each), keys/s and
    their ratios on one line, with the collective's share of a
    super-step (from the two mesh rates) and the all_gather's time;
33. ``tui.run_tui`` on the card (^1C -c 1) with a screen that records what
    is drawn: the frames show "Device search...", "MATCH #1" and the
    oracle-confirmed address;
34. kernel J (base_advance) at the product's K = 8 windows, ADVANCE_AHEAD
    super-steps ahead and stride D = 8 x 524288: one launch held to (k +
    (m + 1) D) G of the native code and to its plain version on the card,
    then timed with CUDA events (a launch, and a launch over the
    super-steps it serves: the budget is 50 us a super-step); its launches
    are those of phase 11's range scan.

Each path's launch counters are set to 0 just before it runs and read just
after.  Tolerance everywhere: exact (the values are integers).  The line
before the last is the kernels' JSON summary, the last line the device
JSON.

The JSON line names the instances of kernels B to E for the three formats
of phases 22-26 ``<kernel>[<format>]``; their launches are those of the
format's path run (phases 23 and 24).  Phase 14 adds P2WPKH's C and D
(launches from phase 13's P2WPKH ranges) and ``dfa_match[global]``, D's
int32 form, whose launches are those of the a.{8}$ range; D's launches
are counted per form (``fused.dfa_match.forms``), and so are kernel I's
(``fused.p2tr_finish_match.forms``): phase 20's
``p2tr_finish_match[global]`` takes its launches from phase 19's a.{8}$
range.  The probes' rows are
``<kernel>[<instance>]`` with ``ms`` the time of one launch of 2R
repetitions (best of five), and their launches those of that timing; the
log gives t(2R) - t(R) beside it, the tools' cost of R repetitions, which
is not held against the bound: a difference of two timings carries the
noise of both.  Phase 28's rows are ``probe_glv_stage[<mode>]``,
``probe_vtile[<V>x<T>]``, ``probe_rows[<shape>]`` (``_mul`` with the
multiply) and ``probe_layout[<layout>]``, ``ms`` the mean of its timed
launches.  The table kernels' rows ``table_grow`` (T1; ``ms`` one call,
all of its launches for the 524288-point i*G table) and ``table_affine``
(T2) take their launches from phase 5's main-path run, which built the
scanner's table.

Each kernel's ``bound_ms`` is the larger of the time its 32-bit integer
instructions need (the model of ``vgen_tpu_torch/probes/bound_model.py``,
over the SMs at the maximum SM clock nvidia-smi reports) and its bytes
(each input read once, each output written once) over 3.35 TB/s.
Instructions are counted per lane from the algorithm; the model's rates
are the card's published ones (128 instructions, 64 ALU-only and 32
32x32 -> 64 multiply-adds per SM per clock), which phase 27's probes
check.  The counts follow the work of the configuration that ran: the
ladder's adds and negations are the nonzero and negative digits of this
run's tweaks in its schedule (``probes/sweep_ladder_window.py``
``ladder_count``), kernels A and G share one inversion and a product
tree per group (``probes/sweep_inv_chain.py`` ``chain_count``), kernel D
walks Base58Check in its register form (``bound_model.B58_WALK``) and
kernel I bech32m in its (``BECH32M_WALK``), each reading its table once
in the form it takes (the narrow form's 2 bytes an entry and 1 a state
in shared memory, or the int32 table); T1 counts a lean add per column
it builds, and T2 its bytes (X, Y and zi read, x and y written).  A
kernel timed below its bound fails the run: the model would then count
more than the work needs.
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
    from vgen_tpu_torch.crypto.address import (
        AddressFormat, AddressGenerator, taproot_output_x)
    from vgen_tpu_torch.pattern import Pattern
    from vgen_tpu_torch.scan.checkpoint import CheckpointManager
    from vgen_tpu_torch.scan.host import ScanConfig, StopFlag, _scan_cpu
    from vgen_tpu_torch.csrc import build
    from vgen_tpu_torch.ops import curve, fused, pipeline, u256
    from vgen_tpu_torch.probes.bound_model import (
        B58_SYMBOLS, B58_WALK, BECH32, BECH32M_WALK, DFA_STEP, EIP55_SYMBOLS,
        FE_ADD, FE_MUL, FE_SQR, FINISH_XY, LEAN_ADD,
        HASH160, KECCAK, KECCAK_X_ONLY, RIPEMD160, SCRIPT_HASH, SHA256_X65,
        SHA256_X65_PAIR, bound, compare)
    from vgen_tpu_torch.probes import bound_model
    from vgen_tpu_torch.probes import sweep_inv_chain as sic
    from vgen_tpu_torch.probes import sweep_ladder_window as slw
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
        f"{sm_clocks_per_s * bound_model.INSTRUCTIONS_PER_SM_CLOCK / 1e12:.2f}"
        f" T instructions/s, "
        f"{sm_clocks_per_s * bound_model.ALU_PER_SM_CLOCK / 1e12:.2f} T "
        f"ALU-only/s, "
        f"{sm_clocks_per_s * bound_model.MULS_PER_SM_CLOCK / 1e12:.2f} T "
        "multiply-adds/s")

    wrappers = {"batch_inverse_dx": fused.batch_inverse_dx,
                "range_glv_match": fused.range_glv_match,
                "range_match": fused.range_match,
                "dfa_match": fused.dfa_match,
                "glv_dfa_match": fused.glv_dfa_match,
                "p2tr_ladder": fused.p2tr_ladder,
                "batch_inverse_chain": fused.batch_inverse_chain,
                "p2tr_finish_range": fused.p2tr_finish_range,
                "p2tr_finish_match": fused.p2tr_finish_match,
                "table_grow": fused.table_grow,
                "table_affine": fused.table_affine}
    sources = {k: "vgen_tpu_torch/csrc/kernels.cu" for k in list(wrappers)[:5]}
    sources.update({k: "vgen_tpu_torch/csrc/p2tr.cu"
                    for k in list(wrappers)[5:9]})
    sources.update({k: "vgen_tpu_torch/csrc/tables.cu"
                    for k in list(wrappers)[9:]})
    wrappers["base_advance"] = fused.base_advance
    sources["base_advance"] = "vgen_tpu_torch/csrc/kernels.cu"

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0
        for form in fused.DFA_FORMS:
            fused.dfa_match.forms[form] = 0
            fused.p2tr_finish_match.forms[form] = 0

    def read_launches():
        got = {n: w.launches for n, w in wrappers.items()}
        got.update({f"dfa_match[{form}]": n
                    for form, n in fused.dfa_match.forms.items()})
        got.update({f"p2tr_finish_match[{form}]": n
                    for form, n in fused.p2tr_finish_match.forms.items()})
        return got

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

    def card_table(points, count, ladder):
        """tables.build_multiples of ``points`` on the card -> (table, wall
        seconds, the host's base points included)."""
        torch.cuda.synchronize()
        t0 = time.time()
        out = tables.build_multiples(points, count, dev, ladder)
        torch.cuda.synchronize()
        return out, time.time() - t0

    def small_tables():
        """T1 and T2 against their plain versions at a small size: rows of
        G and 7G, 1000 columns (T1's one-block launch and a single step),
        T2 in both layouts -> {kernel: max_abs_err}."""
        bs = u256.as_i32(tables._point_limbs(
            [tables._doubling_chain(p, fused.table_steps(1000))
             for p in (ec.G, ec.scalar_mult(7))]))
        got = fused.table_grow(bs.to(dev), 1000)
        want = fused.table_grow_plain(bs, 1000)
        err = {"table_grow": max(max_abs_err(g.cpu(), w)
                                 for g, w in zip(got, want))}
        zi = fused.batch_inverse_chain_plain(want[2])
        lad = fused.table_affine(got[0], got[1], zi.to(dev), 2, True)
        one = [t[:, :1000].contiguous() for t in (want[0], want[1], zi)]
        ig = fused.table_affine(*(t.to(dev) for t in one), 1, False)
        err["table_affine"] = max(
            [max_abs_err(lad.cpu(), fused.table_affine_plain(
                *want[:2], zi, 2, True))]
            + [max_abs_err(g.cpu(), w) for g, w in zip(
                ig, fused.table_affine_plain(*one, 1, False))])
        require(not any(err.values()), f"T1, T2 differ from their plain "
                f"versions at 2 x 1000: {err}")
        return err

    def cold_first_match(argv, absent):
        """``python -m vgen_tpu_torch <argv> --no-tui`` in a new process,
        with the table npz files ``absent`` removed first and required
        absent after -> (seconds to its first match row, seconds to its
        exit, the row)."""
        for path in absent:
            if os.path.exists(path):
                os.remove(path)
        cmd = [sys.executable, "-m", "vgen_tpu_torch", *argv, "--no-tui",
               "-o", "jsonl", "--quiet"]
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        first, rows = None, []
        with tempfile.TemporaryFile("w+") as err:
            t0 = time.time()
            proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                                    stderr=err, text=True, env=env)
            try:
                for line in proc.stdout:
                    if line.strip():
                        first = first or time.time() - t0
                        rows.append(json.loads(line))
                rc = proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            total = time.time() - t0
            err.seek(0)
            require(rc == 0 and len(rows) == 1,
                    f"{cmd}: exit {rc}, {len(rows)} rows\n{err.read()[-2000:]}")
        left = [p for p in absent if os.path.exists(p)]
        require(not left, f"{cmd} wrote {left}: the card path reads and "
                "writes no table npz")
        return first, total, rows[0]

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
            "name": kname, "route": "cuda",
            "source": sources[kname.split("[")[0]],  # <kernel>[<format>]
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(err, err_small), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
        return ms, plain_ms, bound_ms, bound_by

    plain_out = []

    def time_old(kname, what, run, ref, ops, nbytes, reps, view=None):
        """Time the earlier configuration ``what`` of a redesigned kernel
        once beside the product's, hold its output (through ``view``, if
        given) to the product's ``ref`` and its time to its own bound ->
        (ms, bound_ms)."""
        ms = cuda_ms(run, reps)
        out = run() if view is None else view(*run())
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        require(all(torch.equal(o, r) for o, r in zip(outs, refs)),
                f"{kname} at {what} differs from the product's output")
        del out, outs
        bms = bound(ops, nbytes, sm_clocks_per_s)[0]
        require(ms >= bms, f"{kname} at {what}: {ms:.3f} ms beats its bound "
                f"{bms:.3f} ms")
        return ms, bms

    # -- 2. build -------------------------------------------------------
    # the product's units and the probe unit, one nvcc each, all at once
    t0 = time.time()
    all_units = build.UNITS + build.PROBE_UNITS
    build.build(all_units)
    build.load()
    build.load("probes")
    log(f"[2] kernels built+loaded in {time.time() - t0:.1f} s: "
        f"{', '.join(build.library_path(u).name for u in all_units)}")
    for unit in all_units:  # each unit's nvcc and seconds, the product's
        for line in build.build_log((unit,)).splitlines():  # ptxas figures
            if line.startswith("# ") or unit in build.UNITS and any(
                    k in line for k in ("entry function", "registers",
                                        "spill")):
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
    inv_old = fused.batch_inverse_dx(bx.to(dev), tx.to(dev), chain=64, group=1)
    torch.cuda.synchronize()
    err_a = max(max_abs_err(inv_dev.cpu(), inv_plain),
                max_abs_err(inv_old.cpu(), inv_plain))
    require(err_a == 0, f"kernel A differs from its plain version ({err_a})")
    got = u256.to_ints(inv_dev.cpu())
    lanes = random.Random(7).sample(range(K * B), 64)
    for e in lanes:
        dx = (tx_i[e % B] - bx_i[e // B]) % ec.P
        if dx:
            require(dx * got[e] % ec.P == 1, f"kernel A: bad inverse at {e}")
    require(got[B + 4321] == 1, "kernel A: zero dx not guarded to 1")
    log(f"[3] kernel A == plain on K={K} B={B} at (M, G) = "
        f"{fused.INV_GEOMETRY} and (64, 1) (bit-equal, zero lane guarded, 64 "
        f"lanes x*inv=1)")

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
    mask_c = fused.range_glv_match(fmt, *cpu_args, inv_c, lo, hi, rem)
    row_c = fused.pack_tail(mask_c, rem, fused.GLV_KEYS)
    d = [t.to(dev) for t in (*cpu_args, lo, hi, rem)]
    inv_d = fused.batch_inverse_dx(d[0], d[2])
    mask_d = fused.range_glv_match(fmt, *d[:4], inv_d, d[4], d[5], d[6])
    row_d = fused.pack_tail(mask_d, d[6], fused.GLV_KEYS)
    torch.cuda.synchronize()
    err_b = max_abs_err(mask_d.cpu(), mask_c)
    require(err_b == 0, f"kernel B differs from its plain version ({err_b})")
    require(torch.equal(row_d.cpu(), row_c), "packed rows differ")
    require(int((mask_c > 0).sum()) > 0, "^1C matched nothing in 2 windows")
    log(f"[4] kernel B + pack == plain on K={K} B={B}: "
        f"{int((mask_c > 0).sum())} matching lanes, rows {row_c[:, :2].tolist()}")

    # -- 5. main path through the CLI --------------------------------------
    # the first scanner's i*G table, built on the card (kernels T1, G, T2)
    # as a stage of its own, held bit-equal to the host build, the oracle
    B5 = sc.DEFAULT_DEVICE_BATCH
    t0 = time.time()
    tx16, ty16 = tables.build_ig_table_limbs(B5)
    host5 = time.time() - t0
    want5 = tables.upload_ig_table(tx16, ty16, "cpu")
    (tx5, ty5), wall5 = card_table([ec.G], B5, False)
    require(torch.equal(tx5.cpu(), want5[0]) and torch.equal(ty5.cpu(),
                                                             want5[1]),
            "the i*G table built on the card differs from the host build")
    log(f"[5] i*G table of {B5:,} points "
        f"({2 * tx5.numel() * 4 / 2**20:.0f} MiB) built on the card in "
        f"{wall5 * 1e3:.2f} ms wall (the host's base points included; "
        f"T1, G and T2 by CUDA events in [6]), bit-equal to the host build, "
        f"{host5:.2f} s, on {smi}")
    del tx5, ty5, tx16, ty16, want5
    reset_launches()
    rows, _, secs = run_cli(["generate", "-p", "^1C", "-c", "3"])
    path_launches = {"random interval": read_launches()}
    launches = path_launches["random interval"]
    require(len(rows) == 3, f"expected 3 matches, got {len(rows)}")
    confirm(rows, fmt, pat)
    require(all(launches[k] > 0 for k in ("batch_inverse_dx",
                                          "range_glv_match", "table_grow",
                                          "batch_inverse_chain",
                                          "table_affine")),
            f"a kernel was not launched on the main path: {launches}")
    log(f"[5] generate -p ^1C -c 3 (B=524288, k_sub=8) in {secs:.1f} s: "
        f"{[r['address'] for r in rows]} oracle-confirmed; launches {launches}")
    first5, total5, row5 = cold_first_match(
        ["generate", "-p", "^1C", "-c", "1"], [tables.ig_table_path(B5)])
    confirm([row5], fmt, pat)
    # what a new process takes before it scans: the imports, the card's
    # context and the kernel libraries' load
    t0 = time.time()
    subprocess.run([sys.executable, "-c", (
        "import torch, vgen_tpu_torch.cli; "
        "from vgen_tpu_torch.csrc import build; build.load(); "
        "torch.zeros(1, device='cuda'); torch.cuda.synchronize()")],
        cwd=HERE, check=True, timeout=600)
    start5 = time.time() - t0
    log(f"[5] cold generate -p ^1C -c 1 --no-tui (a new process, no table "
        f"npz before or after): first match {row5['address']} at "
        f"{first5:.2f} s, exit at {total5:.2f} s; a process that only "
        f"imports, opens the card and loads the kernels exits at "
        f"{start5:.2f} s, on {smi}")

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
    mask_f = fused.range_glv_match(fmt, bxf, byf, txf, tyf, inv_f, lof, hif,
                                   remf)
    N = K * B
    M, G = fused._chain_len(N, fused.INV_GEOMETRY[0]), fused.INV_GEOMETRY[1]
    S = lo.shape[0]
    # bytes of the per-window bases, the table and the inverses, read once
    lane_in = 64 * K + 64 * B + 32 * N + 4 * K
    # per element: three multiplies, the subtraction, the group's inversion
    # and product tree (probes/sweep_inv_chain.py chain_count)
    chain_ops = N * sic.chain_count(M, G, sic.A_INPUT)
    # the x-only finish and beta x, beta^2 x of kernels B and E
    finish_x_glv = 3 * FE_MUL + FE_SQR + 4 * FE_ADD
    for kname, run, plain, ref, replaces, err_small, ops, nbytes in (
        ("batch_inverse_dx",
         lambda: fused.batch_inverse_dx(bxf, txf),
         lambda: fused.batch_inverse_dx_plain(bxf, txf),
         inv_f, "vgen_tpu/ops/pallas_fused.py:502", err_a,
         chain_ops, 32 * K + 32 * B + 32 * N),
        ("range_glv_match",
         lambda: fused.range_glv_match(fmt, bxf, byf, txf, tyf, inv_f, lof,
                                       hif, remf),
         lambda: fused.range_glv_match_plain(fmt, bxf, byf, txf, tyf, inv_f,
                                             lof, hif, remf),
         mask_f, "vgen_tpu/ops/pallas_fused.py:1271", err_b,
         N * (finish_x_glv + 6 * (HASH160 + compare(S, 5))),
         lane_in + 40 * S + 4 * N),
    ):
        ms, plain_ms, bms, bby = time_kernel(
            kname, run, plain, ref, replaces, launches[kname], err_small,
            f"K={K} B={B}", ops, nbytes)
        log(f"[6] {kname} at K={K} B={B}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bms:.3f} ms ({bby}), bit-equal ({smi})")
    # the table kernels at the main path's table (one row of B columns):
    # T1 (a call is all its launches), T2; each first held against its
    # plain version at a small size
    err_t = small_tables()
    b6 = u256.as_i32(tables._point_limbs(
        [tables._doubling_chain(ec.G, fused.table_steps(B))])).to(dev)
    X6, Y6, Z6 = fused.table_grow(b6, B)
    zi6 = fused.batch_inverse_chain(Z6, *fused.TABLE_INV_GEOMETRY)
    t2_6 = fused.table_affine(X6, Y6, zi6, 1, False)
    for kname, run, plain, ref, replaces, ops, nbytes in (
        ("table_grow", lambda: fused.table_grow(b6, B),
         lambda: fused.table_grow_plain(b6, B), (X6, Y6, Z6),
         "vgen_tpu/scan/tables.py:54", (B - 1) * LEAN_ADD,
         192 * B + 4 * b6.numel()),
        ("table_affine", lambda: fused.table_affine(X6, Y6, zi6, 1, False),
         lambda: fused.table_affine_plain(X6, Y6, zi6, 1, False), t2_6,
         "vgen_tpu/scan/tables.py:101", B * (3 * FE_MUL + FE_SQR), 160 * B),
    ):
        ms, plain_ms, bms, bby = time_kernel(
            kname, run, plain, ref, replaces, launches[kname], err_t[kname],
            f"count={B}", ops, nbytes)
        log(f"[6] {kname} at count={B} ({launches[kname]} launches on the "
            f"main path): kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{bms:.4f} ms ({bby}), bit-equal ({smi})")
    # kernel G on the table's Z at the tables' geometry and the scan's
    g6 = {}
    for geo in (fused.TABLE_INV_GEOMETRY, fused.INV_GEOMETRY):
        require(torch.equal(fused.batch_inverse_chain(Z6, *geo), zi6),
                f"kernel G at {geo} differs on the table's Z")
        g6[geo] = cuda_ms(lambda geo=geo: fused.batch_inverse_chain(Z6, *geo),
                          10)
    log(f"[6] batch_inverse_chain on the table's Z (8, {B}): "
        + ", ".join(f"{ms:.3f} ms at (M, G) = {geo}" for geo, ms in g6.items())
        + f" ({smi})")
    del X6, Y6, Z6, zi6, t2_6
    row_a = next(k for k in kernels if k["name"] == "batch_inverse_dx")
    old_ms, old_bms = time_old(
        "batch_inverse_dx", "(64, 1)",
        lambda: fused.batch_inverse_dx(bxf, txf, chain=64, group=1), inv_f,
        N * sic.chain_count(64, 1, sic.A_INPUT), 32 * K + 32 * B + 32 * N, 10)
    log(f"[6] batch_inverse_dx at (M, G) = (64, 1), one inversion per thread:"
        f" {old_ms:.3f} ms, bound {old_bms:.3f} ms; (M, G) = ({M}, {G}) "
        f"{row_a['ms']:.3f} ms, bound {row_a['bound_ms']:.3f} ms, "
        f"bit-equal ({smi})")

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
    bx8, by8 = base_points(bases8)
    rem8 = torch.tensor([B, B - 100], dtype=torch.int32)
    inv8 = fused.batch_inverse_dx(bx8, txs)
    cpu8 = (bx8, by8, txs, tys, inv8)
    dev8 = tuple(t.to(dev) for t in cpu8)
    rem8_d = rem8.to(dev)
    err_c = {}
    for fmt8 in (AddressFormat.P2PKH, AddressFormat.P2WPKH):
        pat8 = Pattern("^" + AddressGenerator(fmt8).generate(
            key8.to_bytes(32, "big")).address + "$")
        lo8, hi8 = lo_hi(pat8, fmt8)
        mask_c = fused.range_match(fmt8, *cpu8, lo8, hi8, rem8)
        mask_d = fused.range_match(fmt8, *dev8, lo8.to(dev), hi8.to(dev),
                                   rem8_d)
        rows_d = fused.pack_tail(mask_d, rem8_d, 1)
        torch.cuda.synchronize()
        err_c[fmt8] = max_abs_err(mask_d.cpu(), mask_c)
        require(err_c[fmt8] == 0, f"kernel C {fmt8.value} differs from its "
                f"plain version ({err_c[fmt8]})")
        require(torch.equal(rows_d.cpu(), fused.pack_tail(mask_c, rem8, 1)),
                f"kernel C {fmt8.value}: packed rows differ")
        require(int(mask_c[0, 1234]) == 1 and int(mask_c.sum()) == 1,
                f"kernel C {fmt8.value}: the exact key's lane is not the "
                "only one set")
        require(int(mask_c[0, bases8[0] - 1]) == 0,
                f"kernel C {fmt8.value}: doubling lane set")
        log(f"[8] kernel C {fmt8.value} + pack == plain on K={K} B={B} "
            f"(doubling-lane window, remaining {rem8.tolist()}): key "
            f"{hex(key8)} at lane 1234, rows {rows_d[:, :3].tolist()}")

    # -- 9. kernels D, E + pack vs plain -----------------------------------
    err_de = {"dfa_match": 0, "glv_dfa_match": 0}

    def d_forms(fmt_, table, accept):
        """Kernel D's table forms to hold against the plain version: both
        where the narrow table fits the shared form's cap, else the global
        one (and the shared form refused)."""
        S_, W_ = table.shape
        if S_ * (2 * W_ + 1) <= fused.DFA_SHARED_MAX:
            return ("shared", "global")
        try:
            fused.dfa_match(fmt_, *dev8[:5], table.to(dev), accept.to(dev), 0,
                            rem8_d, form="shared")
        except ValueError as exc:
            require("over the shared form" in str(exc), str(exc))
            return ("global",)
        raise SystemExit("chip_smoke FAILED: kernel D took a table over the "
                         "shared form's cap in the shared form")

    for fmt9 in (AddressFormat.P2PKH, AddressFormat.P2WPKH):
        # a.{8}$: 514 states, over the shared form's cap at both widths
        for src in ("c[a4]t", "a.{8}$"):
            table, accept, start = dfa_tensors(Pattern(src), fmt9)
            forms = d_forms(fmt9, table, accept)
            require(src != "a.{8}$" or forms == ("global",),
                    f"{src} {fmt9.value} fits the shared form's cap")
            cases9 = [("dfa_match", 1, form) for form in forms]
            cases9.append(("glv_dfa_match", fused.GLV_KEYS, None))
            plain9 = {}  # each kernel's plain output, once for its forms
            for kname, mult, form in cases9:
                kern = wrappers[kname]
                kw = {} if form is None else {"form": form}
                t0 = time.time()
                if kname not in plain9:
                    plain9[kname] = kern(fmt9, *cpu8, table, accept, start,
                                         rem8)
                m_c = plain9[kname]
                plain_s = time.time() - t0
                m_d = kern(fmt9, *dev8, table.to(dev), accept.to(dev), start,
                           rem8_d, **kw)
                r_d = fused.pack_tail(m_d, rem8_d, mult)
                torch.cuda.synchronize()
                what = f"{kname} {fmt9.value} {src}" + (f" ({form})"
                                                       if form else "")
                err = max_abs_err(m_d.cpu(), m_c)
                err_de[kname] = max(err_de[kname], err)
                require(err == 0, f"{what}: differs ({err})")
                require(torch.equal(r_d.cpu(), fused.pack_tail(m_c, rem8, mult)),
                        f"{what}: packed rows differ")
                hits = int((m_c > 0).sum())
                require(hits > 0, f"{what}: no match")
                log(f"[9] {what} ({table.shape[0]} states) == plain on K={K} "
                    f"B={B}: {hits} matching lanes (plain on CPU "
                    f"{plain_s:.1f} s)")

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
    form13 = fused.dfa_form(*Pattern(src13).device_dfa(fmt).table.shape)
    require(got["batch_inverse_dx"] > 0 and got["dfa_match"] > 0
            and got[f"dfa_match[{form13}]"] == got["dfa_match"]
            and got["range_match"] == 0 and got["glv_dfa_match"] == 0,
            f"DFA range: launches {got}, expected kernels A and D ({form13} "
            "form) only")
    log(f"[13] range {start13:x}:{end13:x} -p {src13} -c 0: {len(keys13)} "
        f"matches in {secs:.1f} s == native scanner's ({native_s:.1f} s); "
        f"launches {got}")
    # a table over the shared budget: kernel D's global form, -c 1
    src13g = "a.{8}$"
    reset_launches()
    rows, _, secs = run_cli(["range", "-r", f"{start13:x}:{end13:x}", "-p",
                             src13g, "-c", "1"])
    got = path_launches["range dfa global"] = read_launches()
    ref13g = _scan_cpu(Pattern(src13g), ScanConfig(
        format=fmt, start=start13, end=end13, count=1, use_device=False),
        None, None)
    want13g = [int(m.hex, 16) for m in ref13g.matches]
    require(confirm(rows, fmt, Pattern(src13g)) == want13g and want13g,
            f"{src13g} -c 1: {rows}, native {want13g}")
    require(got["dfa_match[global]"] > 0 and got["dfa_match[shared]"] == 0,
            f"{src13g} range: launches {got}, expected kernel D's global form")
    log(f"[13] range -p {src13g} -c 1 ({Pattern(src13g).device_dfa(fmt).table.shape[0]}"
        f" states, over the shared budget): {hex(want13g[0])}, the native "
        f"scanner's lowest, in {secs:.1f} s; launches {got}")
    # P2WPKH's range paths: a DFA range against the native scanner (kernels
    # A and D) and an interval range -c 1 (A and C)
    W2 = AddressFormat.P2WPKH
    reset_launches()
    rows, _, secs = run_cli(["range", "-f", W2.value, "-r",
                             f"{start13:x}:{end13:x}", "-p", src13, "-c", "0"])
    got = path_launches["range dfa p2wpkh"] = read_launches()
    keys13 = sorted(confirm(rows, W2, Pattern(src13)))
    ref13w = _scan_cpu(Pattern(src13), ScanConfig(
        format=W2, start=start13, end=end13, count=0, use_device=False),
        None, None)
    want13w = sorted(int(m.hex, 16) for m in ref13w.matches)
    require(keys13 == want13w and len(keys13) > 2 * pipeline.TOP_K,
            f"P2WPKH DFA range: {len(keys13)} matches, native {len(want13w)}")
    require(got["dfa_match"] > 0 and got["range_match"] == 0
            and got["glv_dfa_match"] == 0,
            f"P2WPKH DFA range: launches {got}, expected A and D")
    log(f"[13] range -f p2wpkh -p {src13} -c 0: {len(keys13)} matches in "
        f"{secs:.1f} s == native scanner's; launches {got}")
    reset_launches()
    rows, _, secs = run_cli(["range", "-f", W2.value, "-r",
                             f"{start13:x}:{end13:x}", "-p", "^bc1qq", "-c",
                             "1"])
    got = path_launches["range interval p2wpkh"] = read_launches()
    ref13w = _scan_cpu(Pattern("^bc1qq"), ScanConfig(
        format=W2, start=start13, end=end13, count=1, use_device=False),
        None, None)
    want13w = [int(m.hex, 16) for m in ref13w.matches]
    require(confirm(rows, W2, Pattern("^bc1qq")) == want13w and want13w,
            f"P2WPKH ^bc1qq -c 1: {rows}, native {want13w}")
    require(got["range_match"] > 0 and got["dfa_match"] == 0,
            f"P2WPKH interval range: launches {got}, expected A and C")
    log(f"[13] range -f p2wpkh -p ^bc1qq -c 1: {hex(want13w[0])}, the native "
        f"scanner's lowest, in {secs:.1f} s; launches {got}")

    # -- 14. kernels C, D, E vs plain at the main shape --------------------
    # patterns that hit often, so that a wrong parity or hash shows: kernel
    # C takes the ^1C intervals of phase 6 (one key per lane), P2WPKH's
    # ^bc1qq; D takes [Cc]at, in the form the product takes for it and, for
    # P2PKH, in the global one
    K, B = sc.DEFAULT_K_SUB, sc.DEFAULT_DEVICE_BATCH
    shape = f"K={K} B={B}"

    def on_dev(args):
        return tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)

    def d_bytes(table, form):
        """Kernel D's table bytes, read once: the narrow form's, or the
        int32 table and accept flags."""
        S_, W_ = table.shape
        return S_ * (2 * W_ + 1) if form == "shared" else 4 * S_ * (W_ + 1)

    W2 = AddressFormat.P2WPKH
    dfa_d = on_dev(dfa_tensors(Pattern(src13), fmt))
    dfa_w = on_dev(dfa_tensors(Pattern(src13), W2))
    tab_e, acc_e, st_e = on_dev(dfa_tensors(Pattern("Cat$"), fmt))
    lo_w, hi_w = (t.to(dev) for t in lo_hi(Pattern("^bc1qq"), W2))
    form_w = fused.dfa_form(*dfa_w[0].shape)
    # the narrow tables, once per pattern, as the scanner builds them
    nar_d, nar_w = (fused.narrow_dfa(*d[:2]) for d in (dfa_d, dfa_w))
    lanes_f = (bxf, byf, txf, tyf, inv_f)
    # Base58Check of a P2PKH address: kernel E's symbols (the checksum's two
    # compressions, 49 64-bit divisions by 58^5, 35 digit splits) and
    # 35-step walk; kernel D's register form of them (B58_WALK); bech32's
    # 38 groups and polymod steps and D's 40-step walk
    b58_walk = B58_SYMBOLS + 35 * DFA_STEP
    bech32_walk = BECH32 + 40 * DFA_STEP
    finish_xy = FINISH_XY
    rows14 = {}
    for kname, f, run, plain, replaces, path, err_small, ops, nbytes in (
        ("range_match", fmt,
         lambda: fused.range_match(fmt, *lanes_f, lof, hif, remf),
         lambda: fused.range_match_plain(fmt, *lanes_f, lof, hif, remf),
         "vgen_tpu/ops/pallas_fused.py:1243", ("range interval",
                                                "range_match"),
         err_c[fmt], N * (finish_xy + HASH160 + compare(S, 5)),
         lane_in + 40 * S + 4 * N),
        ("dfa_match", fmt,
         lambda: fused.dfa_match(fmt, *lanes_f, *dfa_d, remf, narrow=nar_d),
         lambda: fused.dfa_match_plain(fmt, *lanes_f, *dfa_d, remf),
         "vgen_tpu/ops/pallas_fused.py:165", ("range dfa", "dfa_match"),
         err_de["dfa_match"], N * (finish_xy + HASH160 + B58_WALK),
         lane_in + d_bytes(dfa_d[0], form13) + 4 * N),
        ("dfa_match[global]", fmt,
         lambda: fused.dfa_match(fmt, *lanes_f, *dfa_d, remf, form="global"),
         lambda: fused.dfa_match_plain(fmt, *lanes_f, *dfa_d, remf),
         "vgen_tpu/ops/pallas_fused.py:165",
         ("range dfa global", "dfa_match[global]"), err_de["dfa_match"],
         N * (finish_xy + HASH160 + B58_WALK),
         lane_in + d_bytes(dfa_d[0], "global") + 4 * N),
        ("range_match[p2wpkh]", W2,
         lambda: fused.range_match(W2, *lanes_f, lo_w, hi_w, remf),
         lambda: fused.range_match_plain(W2, *lanes_f, lo_w, hi_w, remf),
         "vgen_tpu/ops/pallas_fused.py:1243",
         ("range interval p2wpkh", "range_match"), err_c[W2],
         N * (finish_xy + HASH160 + compare(lo_w.shape[0], 5)),
         lane_in + 40 * lo_w.shape[0] + 4 * N),
        ("dfa_match[p2wpkh]", W2,
         lambda: fused.dfa_match(W2, *lanes_f, *dfa_w, remf, narrow=nar_w),
         lambda: fused.dfa_match_plain(W2, *lanes_f, *dfa_w, remf),
         "vgen_tpu/ops/pallas_fused.py:165", ("range dfa p2wpkh",
                                               "dfa_match"),
         err_de["dfa_match"], N * (finish_xy + HASH160 + bech32_walk),
         lane_in + d_bytes(dfa_w[0], form_w) + 4 * N),
        ("glv_dfa_match", fmt,
         lambda: fused.glv_dfa_match(fmt, *lanes_f, tab_e, acc_e, st_e, remf),
         lambda: fused.glv_dfa_match_plain(fmt, *lanes_f, tab_e, acc_e, st_e,
                                           remf),
         "vgen_tpu/ops/pallas_fused.py:190", ("random dfa p2pkh",
                                               "glv_dfa_match"),
         err_de["glv_dfa_match"],
         N * (finish_x_glv + 6 * (HASH160 + b58_walk)),
         lane_in + 4 * (tab_e.numel() + acc_e.numel()) + 4 * N),
    ):
        ref = rows14[kname] = run()
        hits = int((ref > 0).sum())
        require(hits > 0, f"{kname} at {shape}: no matching lane")
        ms, plain_ms, bms, bby = time_kernel(
            kname, run, plain, ref, replaces, path_launches[path[0]][path[1]],
            err_small, shape, ops, nbytes)
        log(f"[14] {kname} at {shape}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bms:.3f} ms ({bby}), bit-equal, "
            f"{hits} matching lanes ({smi})")
    require(torch.equal(rows14["dfa_match"], rows14["dfa_match[global]"]),
            "kernel D's two table forms differ")
    # C and D on the per-lane grid (one thread per lane over N / 256 blocks, D's
    # symbols in a per-thread array, the int32 table through the read-only
    # cache; the probe unit keeps them), timed once beside the product's
    from vgen_tpu_torch.probes import profile_dfa as pdfa

    bech32_arrays = BECH32 + 40 * DFA_STEP  # the per-lane grid's symbols and walk
    for old, kname, f, margs, ops in (
            ("c_lane", "range_match", fmt, (lof, hif) + dfa_d,
             N * (finish_xy + HASH160 + compare(S, 5))),
            ("d_lane", "dfa_match", fmt, (lof, hif) + dfa_d,
             N * (finish_xy + HASH160 + b58_walk)),
            ("c_lane", "range_match[p2wpkh]", W2, (lo_w, hi_w) + dfa_w,
             N * (finish_xy + HASH160 + compare(lo_w.shape[0], 5))),
            ("d_lane", "dfa_match[p2wpkh]", W2, (lo_w, hi_w) + dfa_w,
             N * (finish_xy + HASH160 + bech32_arrays))):
        row = next(k for k in kernels if k["name"] == kname)
        old_ms, old_bms = time_old(
            kname, "the per-lane grid",
            lambda o=old, f=f, m=margs: pdfa.probe_single_key(
                o, *lanes_f, *m, remf, fmt=f), rows14[kname], ops,
            lane_in + 4 * N + (40 * margs[0].shape[0] if old == "c_lane"
                               else d_bytes(margs[2], "global")), 10)
        log(f"[14] {kname} on the per-lane grid ({old}): {old_ms:.3f} ms, bound "
            f"{old_bms:.3f} ms; the tile loop {row['ms']:.3f} ms "
            f"({row['ms'] / old_ms:.3f} of it), bit-equal ({smi})")
    del rows14

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
    # the ladder table of the product's schedule, built from scratch (the
    # card machine's checkout holds no table cache): a stage of its own
    bits, signed = fused.LADDER_WINDOW
    t0 = time.time()
    wtp_np = tables.ladder_table_limbs(bits, signed, refresh=True)
    table_s = time.time() - t0
    wtp_c = u256.as_i32(wtp_np)
    wtp_d, wall16 = card_table(
        tables.ladder_bases(bits, signed),
        fused.ladder_shape(bits, signed)[1] - 1, True)
    require(torch.equal(wtp_d.cpu(), wtp_c),
            "the ladder table built on the card differs from the host build")
    log(f"[16] ladder table {slw.schedule_name(bits, signed)}: "
        f"{fused.ladder_shape(bits, signed)[0]} windows of "
        f"{fused.ladder_shape(bits, signed)[1]} entries, "
        f"{slw.table_bytes(bits, signed) / 2**20:.2f} MiB, built on the card "
        f"in {wall16 * 1e3:.2f} ms wall (the host's base points included), "
        f"bit-equal to the host build, {table_s:.2f} s, on {smi}")
    # the JAX package's 8-bit table: the ladder's earlier schedule
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

    xa, ya = (t[:, :4096].contiguous() for t in (txs, tys))
    plain_s = {}
    for sched, w_c, w_d in (("product", wtp_c, wtp_d), ("8u", wt_c, wt_d)):
        t0 = time.time()
        F_c = fused.p2tr_ladder(*cpu16, w_c)
        plain_s[sched] = time.time() - t0
        F_d = fused.p2tr_ladder(*dev16, w_d)
        torch.cuda.synchronize()
        same("p2tr_ladder", F_d, F_c, f" ({sched} schedule)")
        require(int(F_c[2].sum()) == K * B - 1
                and int(F_c[2][bases16[0] - 1]) == 0,
                "kernel F: ok is not 1 on every lane but the doubling lane")
        Fa_c = fused.p2tr_ladder_affine(xa, ya, w_c)
        Fa_d = fused.p2tr_ladder_affine(xa.to(dev), ya.to(dev), w_d)
        torch.cuda.synchronize()
        same("p2tr_ladder", Fa_d, Fa_c, f" (finish=False, {sched} schedule)")
        if sched == "product":
            F_prod_c, F_prod_d = F_c, F_d
    F_c, F_d = F_prod_c, F_prod_d
    # window 0 holds keys 4098..12289; at 16 signed bits the first add of
    # key 10286 meets its own point (a doubling): its output key x is the
    # oracle's
    lane = 10286 - bases16[0] - 1
    Xl, Zl = (u256.to_ints(t[:, lane:lane + 1].cpu())[0] for t in F_d[:2])
    require(int(F_d[2][lane]) == 1 and Xl * pow(Zl, -2, ec.P) % ec.P
            == taproot_output_x(ec.xonly(ec.scalar_mult(10286))[0]),
            "kernel F: key 10286's output key is not the oracle's")
    Zg = F_c[1].clone()
    Zg[:, 77] = 0  # a dead lane's Z
    G_c = fused.batch_inverse_chain(Zg)
    same("batch_inverse_chain", fused.batch_inverse_chain(Zg.to(dev)), G_c)
    same("batch_inverse_chain",
         fused.batch_inverse_chain(Zg.to(dev), chain=64, group=1), G_c,
         " at (64, 1)")
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
    # kernel I in each table form a table takes: q$ (4 states, the shared
    # form by default) and a.{7}$ (258, over the budget, within the shared
    # form's cap: the global form by default) in both; a.{8}$ (514, over
    # the cap) in the global one, the shared one refused
    forms16 = {}
    for src in ("q$", "a.{7}$", "a.{8}$"):
        tab, acc, st = dfa_tensors(Pattern(src), p2tr)
        S_ = tab.shape[0]
        want = I_c if src == "q$" else fused.p2tr_finish_match(
            X_c, Z_c, zi_c, ok_c, tab, acc, st, rem16)
        require(int(want.sum()) > 0, f"kernel I {src}: no matching lane")
        fits = S_ * (2 * tab.shape[1] + 1) <= fused.DFA_SHARED_MAX
        tab_d, acc_d = tab.to(dev), acc.to(dev)
        for form in (None,) + (fused.DFA_FORMS if fits else ("global",)):
            used = form or fused.dfa_form(*tab.shape)
            before = fused.p2tr_finish_match.forms[used]
            got16 = fused.p2tr_finish_match(X_d, Z_d, zi_d, ok_d, tab_d,
                                            acc_d, st, rem16.to(dev),
                                            form=form)
            torch.cuda.synchronize()
            require(fused.p2tr_finish_match.forms[used] == before + 1,
                    f"kernel I {src}: the {used} form was not counted")
            same("p2tr_finish_match", got16, want, f" ({src}, {used} form)")
        if not fits:
            try:
                fused.p2tr_finish_match(X_d, Z_d, zi_d, ok_d, tab_d, acc_d,
                                        st, rem16.to(dev), form="shared")
            except ValueError as exc:
                require("over the shared form" in str(exc), str(exc))
            else:
                raise SystemExit("chip_smoke FAILED: kernel I took a table "
                                 "over the shared form's cap in the shared "
                                 "form")
        forms16[src] = (S_, fused.dfa_form(*tab.shape), int(want.sum()))
    require([f for _, f, _ in forms16.values()] == ["shared", "global",
                                                     "global"],
            f"kernel I's default forms: {forms16}")
    log(f"[16] kernel I (states, default form, matching lanes) {forms16}: "
        f"each form == plain on K={K} B={B}; the shared form refused over "
        f"its cap")
    require(int(H_c[0, bases16[0] - 1]) == 0 and int(H_c[1, B - 100:].sum()) == 0,
            "kernel H: a dead or out-of-window lane is set")
    log(f"[16] kernels F (both flags, schedules "
        f"{slw.schedule_name(bits, signed)} and 8u), G (at (M, G) = "
        f"{fused.INV_GEOMETRY} and (64, 1), zero lane 77 -> 1; key 10286's "
        f"output key the oracle's), H (^bc1pq, "
        f"{int(H_c.sum())} lanes), I (q$, {int(I_c.sum())} lanes) == plain on "
        f"K={K} B={B} (plain ladder on CPU {plain_s['product']:.1f} s, 8u "
        f"{plain_s['8u']:.1f} s)")
    del F_d, Fa_d, X_d, Z_d, ok_d, zi_d, F_prod_d
    # a cold P2TR scan: the oracle above wrote the ladder table's npz
    first16, total16, row16 = cold_first_match(
        ["generate", "-f", "p2tr", "-p", "^bc1pqq", "-c", "1"],
        [tables.ig_table_path(sc.DEFAULT_DEVICE_BATCH),
         tables.ladder_table_path(bits, signed)])
    confirm([row16], p2tr, Pattern("^bc1pqq"))
    log(f"[16] cold generate -f p2tr -p ^bc1pqq -c 1 --no-tui (a new "
        f"process, no table npz before or after): first match "
        f"{row16['address']} at {first16:.2f} s, exit at {total16:.2f} s on "
        f"{smi}")

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
        # the first P2TR scanner builds both tables; the CLI's scanner
        # cache (scanner._scanner_cache) serves the second run
        built = (("table_grow", "table_affine")
                 if on == "p2tr_finish_range" else ())
        require(all(got[k] > 0 for k in ("batch_inverse_dx", "p2tr_ladder",
                                         "batch_inverse_chain", on) + built)
                and got[off] == 0,
                f"{argv}: launches {got}, expected A, F, G, {on} and not {off}")
        # qq$ (5 states): kernel I's shared form, every launch
        require(on != "p2tr_finish_match" or got["p2tr_finish_match[shared]"]
                == got["p2tr_finish_match"],
                f"{argv}: launches {got}, expected kernel I's shared form")
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
    require(got["p2tr_finish_match"] > 0 and got["p2tr_finish_range"] == 0
            and got["p2tr_finish_match[shared]"] == got["p2tr_finish_match"],
            f"P2TR DFA range: launches {got}, expected kernel I (its shared "
            "form) and not H")
    log(f"[19] range -f p2tr {start19:x}:{end19:x} -p {src19} -c 0: "
        f"{len(keys19)} matches in {secs:.1f} s == native scanner's "
        f"({native_s:.1f} s); launches {got}")
    # a table over the shared form's cap: kernel I's global form, -c 1
    src19g = "a.{8}$"
    reset_launches()
    rows, _, secs = run_cli(["range", "-f", "p2tr", "-r",
                             f"{start19:x}:{end19:x}", "-p", src19g, "-c",
                             "1"])
    got = path_launches["range dfa p2tr global"] = read_launches()
    ref19g = _scan_cpu(Pattern(src19g), ScanConfig(
        format=p2tr, start=start19, end=end19, count=1, use_device=False),
        None, None)
    want19g = [int(m.hex, 16) for m in ref19g.matches]
    require(confirm(rows, p2tr, Pattern(src19g)) == want19g and want19g,
            f"P2TR {src19g} -c 1: {rows}, native {want19g}")
    require(got["p2tr_finish_match[global]"] > 0
            and got["p2tr_finish_match[shared]"] == 0,
            f"P2TR {src19g} range: launches {got}, expected kernel I's "
            "global form")
    log(f"[19] range -f p2tr -p {src19g} -c 1 "
        f"({Pattern(src19g).device_dfa(p2tr).table.shape[0]} states, over "
        f"the shared form's cap): {hex(want19g[0])}, the native scanner's "
        f"lowest, in {secs:.1f} s; launches {got}")

    # -- 20. kernels F, G, H, I vs plain at the main shape --------------------
    K, B = sc.DEFAULT_K_SUB, sc.DEFAULT_DEVICE_BATCH
    N = K * B
    shape = f"K={K} B={B}"
    lanes20 = (bxf, byf, txf, tyf, inv_f)
    X_f, Z_f, ok_f = ref_f = fused.p2tr_ladder(*lanes20, wtp_d)
    zi_f = fused.batch_inverse_chain(Z_f)
    lo20, hi20 = lo16.to(dev), hi16.to(dev)
    S20 = lo20.shape[0]
    tab20, acc20 = tab16.to(dev), acc16.to(dev)
    # kernel I's narrow table, built once, as the scanner builds it
    nar20 = fused.narrow_dfa(tab20, acc20)

    # the ladder's adds and negations on this run's tweaks, for each
    # schedule timed (probes/sweep_ladder_window.py ladder_work)
    x3, _, _ = curve.ec_finish(*fused._lanes(*lanes20))
    t20 = slw.tweaks(x3.reshape(8, N))
    del x3
    adds, negs = slw.ladder_work(t20, bits, signed)
    adds8, _ = slw.ladder_work(t20, 8, False)
    del t20
    # the plain ladder on one window first: K = 8 only if it fits in 60 s
    inv_1 = inv_f[:, :B].contiguous()
    plain_1 = lambda: fused.p2tr_ladder_plain(bxf[:1], byf[:1], txf, tyf,
                                              inv_1, wtp_d)
    plain_k8_s = cuda_ms(plain_1, 1, warm=False) * K / 1e3
    if plain_k8_s <= 60:
        plain_f = lambda: fused.p2tr_ladder_plain(*lanes20, wtp_d)
        ref_plain, plain_shape = ref_f, shape
    else:
        plain_f = plain_1
        ref_plain = (X_f[:, :B], Z_f[:, :B], ok_f[:B])
        plain_shape = f"K=1 B={B} (K=8 estimated at {plain_k8_s:.0f} s)"
    # per lane: the full finish, the even-Y negation, the tweak's
    # compression of x from the tag's midstate and t < n; per add (8M +
    # 3S): six subtractions and 2V as an addition; per negative digit a
    # negation (sweep_ladder_window.ladder_count)
    ladder_ops = slw.ladder_count(N, adds, negs)
    ladder_bytes = lane_in + 68 * N
    finish_ops = N * (FE_MUL + FE_SQR)
    finish_in = 100 * N + 4 * K
    # kernel I's register walk (bound_model.BECH32M_WALK): the checksum as
    # 52 table lookups of the program's five-bit groups, the checksum's 6
    # groups and the 60 steps; its table read once in the form it takes
    i_ops = finish_ops + N * BECH32M_WALK
    Mz = fused._chain_len(N, fused.INV_GEOMETRY[0])
    for kname, run, plain, ref, replaces, path, ops, nbytes, pshape in (
        ("p2tr_ladder",
         lambda: fused.p2tr_ladder(*lanes20, wtp_d), plain_f, ref_plain,
         "vgen_tpu/ops/pallas_fused.py:931", "random interval p2tr",
         ladder_ops, ladder_bytes + slw.table_bytes(bits, signed),
         plain_shape),
        ("batch_inverse_chain",
         lambda: fused.batch_inverse_chain(Z_f),
         lambda: fused.batch_inverse_chain_plain(Z_f), zi_f,
         "vgen_tpu/ops/pallas_fused.py:441", "random interval p2tr",
         N * sic.chain_count(Mz, fused.INV_GEOMETRY[1], sic.G_INPUT),
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
                                         st16, remf, narrow=nar20),
         lambda: fused.p2tr_finish_match_plain(X_f, Z_f, zi_f, ok_f, tab20,
                                               acc20, st16, remf), None,
         "vgen_tpu/ops/pallas_fused.py:1028", "random dfa p2tr", i_ops,
         finish_in + d_bytes(tab20, "shared") + 4 * N, shape),
        ("p2tr_finish_match[global]",
         lambda: fused.p2tr_finish_match(X_f, Z_f, zi_f, ok_f, tab20, acc20,
                                         st16, remf, form="global"),
         lambda: fused.p2tr_finish_match_plain(X_f, Z_f, zi_f, ok_f, tab20,
                                               acc20, st16, remf), None,
         "vgen_tpu/ops/pallas_fused.py:1028", "range dfa p2tr global", i_ops,
         finish_in + d_bytes(tab20, "global") + 4 * N, shape),
    ):
        if ref is None:
            ref = run()
        hits = int((ok_f if kname == "p2tr_ladder" else ref).ne(0).sum())
        require(hits > 0, f"{kname} at {shape}: no live or matching lane")
        if kname == "p2tr_finish_match":
            ref_i = ref
        # ten launches of the finishes (about 0.2-0.3 ms each), three of
        # the ladder and the chain
        ms, plain_ms, bms, bby = time_kernel(
            kname, run, plain, ref, replaces, path_launches[path][kname],
            err16[kname.split("[")[0]], pshape, ops, nbytes,
            reps=10 if kname.startswith("p2tr_finish") else 3)
        log(f"[20] {kname} at {shape}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms at {pshape}, bound {bms:.3f} ms ({bby}), "
            f"bit-equal, {hits} live/matching lanes ({smi})")
        del ref
    # the earlier configurations, timed once beside the product's: the
    # ladder on the 8-bit table (its output key x and ok held to the
    # product's), the chain with one inversion per thread
    qx_f = slw.output_x(X_f, Z_f)
    old_f, old_f_bms = time_old(
        "p2tr_ladder", "the 8u schedule",
        lambda: fused.p2tr_ladder(*lanes20, wt_d),
        (qx_f[:, ok_f != 0], ok_f), slw.ladder_count(N, adds8, 0),
        ladder_bytes + slw.table_bytes(8, False), 3,
        view=lambda X, Z, ok: (slw.output_x(X, Z)[:, ok_f != 0], ok))
    del qx_f
    old_g, old_g_bms = time_old(
        "batch_inverse_chain", "(64, 1)",
        lambda: fused.batch_inverse_chain(Z_f, chain=64, group=1), zi_f,
        N * sic.chain_count(64, 1, sic.G_INPUT), 64 * N, 10)
    # kernel I on the per-lane grid (the probe unit's i_lane: one thread
    # per lane, the symbol array, the int32 table)
    from vgen_tpu_torch.probes import profile_p2tr_match as ppm

    old_i, old_i_bms = time_old(
        "p2tr_finish_match", "the per-lane grid (i_lane)",
        lambda: ppm.probe_p2tr_match("i_lane", X_f, Z_f, zi_f, ok_f, tab20,
                                     acc20, st16, remf), ref_i, i_ops,
        finish_in + d_bytes(tab20, "global") + 4 * N, 10)
    del ref_i
    rows20 = {k["name"]: k for k in kernels}
    log(f"[20] p2tr_finish_match on the per-lane grid (i_lane): "
        f"{old_i:.3f} ms, "
        f"bound {old_i_bms:.3f} ms; the product (tiles, register walk) "
        f"{rows20['p2tr_finish_match']['ms']:.3f} ms in the shared form "
        f"({rows20['p2tr_finish_match']['ms'] / old_i:.3f} of it), "
        f"{rows20['p2tr_finish_match[global]']['ms']:.3f} ms in the global "
        f"one; outputs equal ({smi})")
    log(f"[20] p2tr_ladder on the 8u table ({adds8 / N:.3f} adds a lane, "
        f"the {slw.schedule_name(bits, signed)} schedule {adds / N:.3f} and "
        f"{negs / N:.3f} negations): {old_f:.3f} ms, bound {old_f_bms:.3f} "
        f"ms, against {rows20['p2tr_ladder']['ms']:.3f} ms, bound "
        f"{rows20['p2tr_ladder']['bound_ms']:.3f} ms; batch_inverse_chain at "
        f"(64, 1): {old_g:.3f} ms, bound {old_g_bms:.3f} ms, against "
        f"{rows20['batch_inverse_chain']['ms']:.3f} ms, bound "
        f"{rows20['batch_inverse_chain']['bound_ms']:.3f} ms; outputs equal "
        f"({smi})")
    xa_f, ya_f = txf[:, :B].contiguous(), tyf[:, :B].contiguous()
    aff_ms = cuda_ms(lambda: fused.p2tr_ladder_affine(xa_f, ya_f, wtp_d), 3)
    aff_plain_ms = cuda_ms(lambda: plain_out.append(
        fused.p2tr_ladder_affine_plain(xa_f, ya_f, wtp_d)), 1, warm=False)
    same("p2tr_ladder", fused.p2tr_ladder_affine(xa_f, ya_f, wtp_d),
         tuple(t.cpu() for t in plain_out.pop()), f" (finish=False) at N={B}")
    adds_aff, negs_aff = slw.ladder_work(slw.tweaks(u256.to_i64(xa_f)), bits,
                                         signed)
    aff_bound, aff_by = bound(
        slw.ladder_count(B, adds_aff, negs_aff, finish=False),
        (64 + 68) * B + slw.table_bytes(bits, signed), sm_clocks_per_s)
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

    # -- 22. kernels B, C, D, E of the other formats vs plain ----------------
    P2SH, UNC, ETH = (AddressFormat.P2SH_P2WPKH,
                      AddressFormat.P2PKH_UNCOMPRESSED, AddressFormat.ETHEREUM)
    new_formats = {
        # format: (interval patterns, DFA patterns); a.{8}$ has more than 256
        # DFA states, over kernel D's shared-form cap at width 60 (not at
        # Ethereum's 24, where a.{10}$, for D alone, is)
        P2SH: (("^3A",), ("c[a4]t", "a.{8}$")),
        UNC: (("^1A",), ("c[a4]t", "a.{8}$")),
        ETH: (("^0x1", "^0xab"), ("Ab$", "a.{8}$")),
    }
    over_cap = {P2SH: "a.{8}$", UNC: "a.{8}$", ETH: "a.{10}$"}
    K, B = 2, 8192
    bases22 = [1 + B // 2, 0x5EED5EED5EED]  # window 0: doubling lane at B/2
    bx22, by22 = base_points(bases22)
    rem22 = torch.tensor([B, B - 100], dtype=torch.int32)
    inv22 = fused.batch_inverse_dx(bx22, txs)
    cpu22 = (bx22, by22, txs, tys, inv22)
    dev22 = tuple(t.to(dev) for t in cpu22)
    rem22_d = rem22.to(dev)
    err22 = {}

    for fmt22, (iv_srcs, dfa_srcs) in new_formats.items():
        ivs = [(s_, lo_hi(Pattern(s_), fmt22), None) for s_ in iv_srcs]
        dfas = [(s_, dfa_tensors(Pattern(s_), fmt22), None)
                for s_ in dfa_srcs]
        # kernel D in each table form the table takes
        d_cases = []
        for s_ in dfa_srcs + ((over_cap[fmt22],) if over_cap[fmt22]
                              not in dfa_srcs else ()):
            margs = dfa_tensors(Pattern(s_), fmt22)
            forms = d_forms(fmt22, margs[0], margs[1])
            require(s_ != over_cap[fmt22] or forms == ("global",),
                    f"{s_} {fmt22.value} fits the shared form's cap")
            d_cases += [(s_, margs, form)
                        for form in forms]
        plain22 = {}  # each kernel's plain output, once for its forms
        for kname, mult, cases in (("range_match", 1, ivs),
                                   ("range_glv_match", fused.GLV_KEYS, ivs),
                                   ("dfa_match", 1, d_cases),
                                   ("glv_dfa_match", fused.GLV_KEYS, dfas)):
            kern = wrappers[kname]
            for src, margs, form in cases:
                kw = {} if form is None else {"form": form}
                t0 = time.time()
                if (kname, src) not in plain22:
                    plain22[kname, src] = kern(fmt22, *cpu22, *margs, rem22)
                m_c = plain22[kname, src]
                plain_s = time.time() - t0
                m_d = kern(fmt22, *dev22, *on_dev(margs), rem22_d, **kw)
                r_d = fused.pack_tail(m_d, rem22_d, mult)
                torch.cuda.synchronize()
                what = f"{kname} {fmt22.value} {src}" + (
                    f" ({form})" if form else "")
                err = max_abs_err(m_d.cpu(), m_c)
                err22[kname, fmt22] = max(err22.get((kname, fmt22), 0), err)
                require(err == 0, f"{what}: differs from its plain version "
                        f"({err})")
                require(torch.equal(r_d.cpu(), fused.pack_tail(m_c, rem22, mult)),
                        f"{what}: packed rows differ")
                hits = int((m_c > 0).sum())
                require(hits > 0, f"{what}: no matching lane")
                require(int(m_c[0, bases22[0] - 1]) == 0
                        and int(m_c[1, B - 100:].abs().sum()) == 0,
                        f"{what}: a dead or out-of-window lane is set")
                log(f"[22] {what} == plain on K={K} B={B}: {hits} matching "
                    f"lanes (plain on CPU {plain_s:.1f} s)")

    # -- 23. random scans of the other formats at full width -----------------
    for fmt23, iv_src, dfa_src in ((P2SH, "^3Ab", "Cat$"), (UNC, "^1Ab", "Cat$"),
                                   (ETH, "^0xabc", "Abc$")):
        for route, src, on, off in (
                ("interval", iv_src, "range_glv_match", "glv_dfa_match"),
                ("dfa", dfa_src, "glv_dfa_match", "range_glv_match")):
            argv = ["generate", "-f", fmt23.value, "-p", src, "-c", "3"]
            reset_launches()
            rows, _, secs = run_cli(argv)
            got = path_launches[f"random {route} {fmt23.value}"] = read_launches()
            require(len(rows) == 3, f"{argv}: expected 3 matches, got {len(rows)}")
            confirm(rows, fmt23, Pattern(src))
            require(got["batch_inverse_dx"] > 0 and got[on] > 0 and got[off] == 0,
                    f"{argv}: launches {got}, expected A, {on} and not {off}")
            log(f"[23] {' '.join(argv)} (B=524288, k_sub=8) in {secs:.1f} s: "
                f"{[r['address'] for r in rows]} oracle-confirmed; launches {got}")
    # case-insensitive: the Ethereum intervals are exact, so hits count as
    # matches; a case-sensitive letter prefix (^0xabc above) is a prefilter
    require(Pattern("^0xabcd", True).exact_match_intervals(ETH) is not None
            and Pattern("^0xabc").exact_match_intervals(ETH) is None,
            "the Ethereum interval route's exactness rule")
    argv = ["generate", "-f", "ethereum", "-i", "-p", "^0xabcd", "-c", "3"]
    reset_launches()
    rows, _, secs = run_cli(argv)
    got = read_launches()
    require(len(rows) == 3, f"{argv}: expected 3 matches, got {len(rows)}")
    confirm(rows, ETH, Pattern("^0xabcd", True))
    require(got["batch_inverse_dx"] > 0 and got["range_glv_match"] > 0
            and got["glv_dfa_match"] == 0, f"{argv}: launches {got}")
    log(f"[23] {' '.join(argv)} (exact interval route) in {secs:.1f} s: "
        f"{[r['address'] for r in rows]} oracle-confirmed; launches {got}")

    # -- 24. full-width range scans of the other formats vs native ------------
    start24 = 0xC0FFEE000000
    end24 = start24 + 2 * sc.DEFAULT_DEVICE_BATCH - 1
    for fmt24, src in ((P2SH, "[Cc]at"), (UNC, "[Cc]at"),
                       (ETH, "[Dd][Ee][Aa][Dd]")):
        reset_launches()
        rows, _, secs = run_cli(["range", "-f", fmt24.value, "-r",
                                 f"{start24:x}:{end24:x}", "-p", src, "-c", "0"])
        got = path_launches[f"range dfa {fmt24.value}"] = read_launches()
        keys24 = sorted(confirm(rows, fmt24, Pattern(src)))
        t0 = time.time()
        ref24 = _scan_cpu(Pattern(src), ScanConfig(
            format=fmt24, start=start24, end=end24, count=0, use_device=False),
            None, None)
        native_s = time.time() - t0
        want24 = sorted(int(m.hex, 16) for m in ref24.matches)
        require(keys24 == want24 and len(keys24) > 2 * pipeline.TOP_K,
                f"{fmt24.value} DFA range: {len(keys24)} matches, native "
                f"{len(want24)}")
        require(rows[0]["operations"] == ref24.operations == end24 - start24 + 1,
                f"{fmt24.value} DFA range: operations {rows[0]['operations']}")
        require(got["batch_inverse_dx"] > 0 and got["dfa_match"] > 0
                and got["range_match"] == 0 and got["glv_dfa_match"] == 0,
                f"{fmt24.value} DFA range: launches {got}, expected A and D")
        log(f"[24] range -f {fmt24.value} {start24:x}:{end24:x} -p {src} -c 0: "
            f"{len(keys24)} matches in {secs:.1f} s == native scanner's "
            f"({native_s:.1f} s); launches {got}")
    for fmt24, src in ((ETH, "^0xab"), (P2SH, "^3Ab"), (UNC, "^1Ab")):
        reset_launches()
        rows, _, secs = run_cli(["range", "-f", fmt24.value, "-r",
                                 f"{start24:x}:{end24:x}", "-p", src, "-c", "1"])
        got = path_launches[f"range interval {fmt24.value}"] = read_launches()
        ref24 = _scan_cpu(Pattern(src), ScanConfig(
            format=fmt24, start=start24, end=end24, count=1, use_device=False),
            None, None)
        want24 = [int(m.hex, 16) for m in ref24.matches]
        require(confirm(rows, fmt24, Pattern(src)) == want24 and want24,
                f"{fmt24.value} {src} -c 1: {rows}, native {want24}")
        require(got["batch_inverse_dx"] > 0 and got["range_match"] > 0
                and got["dfa_match"] == 0,
                f"{fmt24.value} interval range: launches {got}, expected A, C")
        log(f"[24] range -f {fmt24.value} -p {src} -c 1 over {start24:x}:"
            f"{end24:x}: {hex(want24[0])}, the native scanner's lowest, in "
            f"{secs:.1f} s; launches {got}")

    # -- 25. kernels B, C, D, E of the other formats timed at the main shape --
    K, B = sc.DEFAULT_K_SUB, sc.DEFAULT_DEVICE_BATCH
    N = K * B
    shape = f"K={K} B={B}"
    lanes_f = (bxf, byf, txf, tyf, inv_f)
    # per key: the value's hashes; per lane of B and E: those of the six
    # variants (uncompressed: three pairs of +y and -y keys); for the DFA
    # the symbols and the walk (EIP-55: the nibbles' ASCII (4 each), the
    # second Keccak-f, the casing (3 each) and a 41-step walk)
    value_ops = {P2SH: HASH160 + SCRIPT_HASH, UNC: SHA256_X65 + RIPEMD160,
                 ETH: KECCAK}
    glv_value_ops = {P2SH: 6 * value_ops[P2SH],
                     UNC: 3 * (SHA256_X65_PAIR + 2 * RIPEMD160),
                     ETH: 6 * KECCAK - 3 * KECCAK_X_ONLY}
    eip55_walk = EIP55_SYMBOLS + 41 * DFA_STEP
    # the full finish, beta x, beta^2 x and one negation of y
    finish_xy_glv = finish_xy + 2 * FE_MUL + FE_ADD
    for fmt25, iv_src, d_src, e_src in (
            (P2SH, "^3A", "[Cc]at", "Cat$"), (UNC, "^1A", "[Cc]at", "Cat$"),
            (ETH, "^0x1", "[Dd][Ee][Aa][Dd]", "Abc$")):
        lo25, hi25 = (t.to(dev) for t in lo_hi(Pattern(iv_src), fmt25))
        S25 = lo25.shape[0]
        dfa_d = on_dev(dfa_tensors(Pattern(d_src), fmt25))
        dfa_e = on_dev(dfa_tensors(Pattern(e_src), fmt25))
        value, glv_value = value_ops[fmt25], glv_value_ops[fmt25]
        walk = eip55_walk if fmt25 == ETH else b58_walk  # kernel E's
        d_walk = eip55_walk if fmt25 == ETH else B58_WALK  # kernel D's
        glv_finish = (finish_xy_glv if fmt25 in pipeline.GLV_EXACT_Y
                      else finish_x_glv)
        dfa_bytes = [d_bytes(dfa_d[0], fused.dfa_form(*dfa_d[0].shape)),
                     4 * (dfa_e[0].numel() + dfa_e[1].numel())]
        iv_args, f = (lo25, hi25, remf), fmt25
        for kname, margs, path, replaces, ops, nbytes in (
            ("range_glv_match", iv_args, f"random interval {f.value}",
             "vgen_tpu/ops/pallas_fused.py:1271",
             N * (glv_finish + glv_value + 6 * compare(S25, 5)),
             lane_in + 40 * S25 + 4 * N),
            ("range_match", iv_args, f"range interval {f.value}",
             "vgen_tpu/ops/pallas_fused.py:1243",
             N * (finish_xy + value + compare(S25, 5)),
             lane_in + 40 * S25 + 4 * N),
            ("dfa_match", dfa_d + (remf,), f"range dfa {f.value}",
             "vgen_tpu/ops/pallas_fused.py:165",
             N * (finish_xy + value + d_walk), lane_in + dfa_bytes[0] + 4 * N),
            ("glv_dfa_match", dfa_e + (remf,), f"random dfa {f.value}",
             "vgen_tpu/ops/pallas_fused.py:190",
             N * (glv_finish + glv_value + 6 * walk),
             lane_in + dfa_bytes[1] + 4 * N),
        ):
            kern = wrappers[kname]
            plain_fn = getattr(fused, f"{kname}_plain")
            # kernel D's narrow table, once, as the scanner builds it
            kw = ({"narrow": fused.narrow_dfa(*dfa_d[:2])}
                  if kname == "dfa_match" else {})

            def run(kern=kern, margs=margs, kw=kw):
                return kern(f, *lanes_f, *margs, **kw)

            def plain(plain_fn=plain_fn, margs=margs):
                return plain_fn(f, *lanes_f, *margs)

            ref = run()
            hits = int((ref > 0).sum())
            require(hits > 0, f"{kname} {f.value} at {shape}: no matching lane")
            iname = f"{kname}[{f.value}]"
            ms, plain_ms, bms, bby = time_kernel(
                iname, run, plain, ref, replaces, path_launches[path][kname],
                err22[kname, f], shape, ops, nbytes, reps=5)
            log(f"[25] {iname} at {shape}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.1f} ms, bound {bms:.3f} ms ({bby}), bit-equal, "
                f"{hits} matching lanes ({smi})")
            if kname in ("range_match", "dfa_match"):
                # the per-lane grid; its D walks kernel E's symbol arrays
                old = "c_lane" if kname == "range_match" else "d_lane"
                old_ops = ops if old == "c_lane" else N * (
                    finish_xy + value + walk)
                old_ms, _ = time_old(
                    iname, "the per-lane grid",
                    lambda o=old: pdfa.probe_single_key(
                        o, *lanes_f, lo25, hi25, *dfa_d, remf, fmt=f), ref,
                    old_ops, nbytes, 5)
                log(f"[25] {iname} on the per-lane grid ({old}): {old_ms:.3f} ms; "
                    f"the tiles {ms:.3f} ms ({ms / old_ms:.3f} of it), "
                    f"bit-equal ({smi})")
            del ref
        torch.cuda.empty_cache()

    # -- 26. timed scans of the other formats, both routes --------------------
    for fmt26, src, on, off in (
            (P2SH, "^3BenchNeverMatches", "range_glv_match", "glv_dfa_match"),
            (P2SH, "BenchNeverMatches$", "glv_dfa_match", "range_glv_match"),
            (UNC, "^1BenchNeverMatches", "range_glv_match", "glv_dfa_match"),
            (UNC, "BenchNeverMatches$", "glv_dfa_match", "range_glv_match"),
            (ETH, "deadbeefcafe0123$", "glv_dfa_match", "range_glv_match")):
        reset_launches()
        stats = sc.benchmark_device(fmt26, src, min_seconds=5.0,
                                    warmup_batches=1)
        got = read_launches()
        route = "interval" if on == "range_glv_match" else "DFA"
        require(stats["keys_per_sec"] > 0, f"{fmt26.value} {route}: no keys")
        require(got[on] > 0 and got[off] == 0,
                f"{fmt26.value} {route} benchmark: launches {got}")
        log(f"[26] benchmark_device {src} ({fmt26.value} {route}, GLV): "
            f"{stats['keys_per_sec']:,.0f} keys/s ({stats['operations']:,} "
            f"keys in {stats['elapsed']:.2f} s) on {smi}")

    # -- 27. the probe kernels (the measurement tools' path) ------------------
    from vgen_tpu_torch.probes import common as pcommon
    from vgen_tpu_torch.probes import microbench_fieldmul as pfm
    from vgen_tpu_torch.probes import microbench_vpu as pvpu
    from vgen_tpu_torch.probes import roofline as proof
    from vgen_tpu_torch.probes import timing as ptiming

    table_c = proof.dfa_table()
    table_d = table_c.to(dev)

    def prim(name, plain=False):
        def run(a, b, reps):
            t = table_d if a.is_cuda else table_c
            return (proof.probe_primitive_plain if plain
                    else proof.probe_primitive)(name, a, b, t, reps)
        return run

    # (kernel, instance, wrapper, run, plain, the model's count of one
    # repetition, R of the timed launches: enough for about a millisecond)
    probes = [("probe_primitive", name, proof.probe_primitive, prim(name),
               prim(name, True), count, 16 if count[2] > 500 else 128)
              for name, (_, count) in proof.PRIMITIVES.items()]
    probes += [("probe_issue", pvpu.instance_name(op, c), pvpu.probe_issue,
                lambda a, b, r, op=op, c=c: pvpu.probe_issue(op, c, a, b, r),
                lambda a, b, r, op=op, c=c: pvpu.probe_issue_plain(op, c, a, b,
                                                                  r),
                pvpu.model_count(op, c), 4096 * 8 // c)
               for op, c in pvpu.instances()]
    probes += [("probe_fieldmul", mode, pfm.probe_fieldmul,
                lambda a, b, r, m=mode: pfm.probe_fieldmul(m, a, b, r),
                lambda a, b, r, m=mode: pfm.probe_fieldmul_plain(m, a, b, r),
                count, 64 if count[2] > 100 else 256)
               for mode, (_, count) in pfm.MODES.items()]
    replaces27 = {"probe_primitive": "scripts/roofline.py:162",
                  "probe_issue": "scripts/microbench_vpu.py:66",
                  "probe_fieldmul": "scripts/microbench_fieldmul.py:120"}
    n_small, r_plain = 4096, 16
    a_s, b_s = pcommon.inputs(n_small, seed=27)
    a_sd, b_sd = a_s.to(dev), b_s.to(dev)
    err27 = {}
    t0 = time.time()
    for kname, iname, _, run, _, _, _ in probes:
        r_small = 8 if kname == "probe_issue" else 2
        want = run(a_s, b_s, r_small)
        got = run(a_sd, b_sd, r_small)
        torch.cuda.synchronize()
        err27[iname] = max_abs_err(got.cpu(), want)
        require(err27[iname] == 0, f"{kname}[{iname}] differs from its plain "
                f"version at N={n_small} ({err27[iname]})")
        require(not torch.equal(want, a_s), f"{kname}[{iname}] left its "
                "input unchanged")
    log(f"[27] {len(probes)} probe instances == plain (on the CPU) at "
        f"N={n_small}, R = 2 (probe_issue 8) in {time.time() - t0:.1f} s")
    n27 = pcommon.TIMED_N
    a_f, b_f = (t.to(dev) for t in pcommon.inputs(n27, seed=28))
    t0 = time.time()
    for kname, iname, wrapper, run, plain, count, R in probes:
        # this instance's path: its two-point timing, the tools' own
        wrapper.launches = 0
        t1, t2, delta = ptiming.delta_ms(lambda r: run(a_f, b_f, r), R)
        launches27 = wrapper.launches
        require(launches27 > 0, f"{kname}[{iname}] was not launched")
        ref = run(a_f, b_f, r_plain)
        plain_ms = cuda_ms(lambda: plain_out.append(plain(a_f, b_f, r_plain)),
                           1, warm=False)
        err = max_abs_err(plain_out.pop(), ref)
        require(err == 0, f"{kname}[{iname}] differs from its plain version "
                f"at N={n27}")
        # a, b read and out written once, the DFA table read once
        nbytes = 3 * a_f.numel() * 4 + (table_d.numel() * 4
                                        if iname.startswith("dfachar") else 0)
        bms, bby = bound(2 * R * n27 * count, nbytes, sm_clocks_per_s)
        require(t2 >= bms, f"{kname}[{iname}]: {t2:.4f} ms for 2R={2 * R} "
                f"beats its bound {bms:.4f} ms: the model's rate is wrong")
        kernels.append({
            "name": f"{kname}[{iname}]", "route": "cuda",
            "source": "vgen_tpu_torch/probes/probes.cu",
            "replaces": replaces27[kname], "launches": launches27,
            "max_abs_err": max(err, err27[iname]), "ms": t2,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
            "library_ms": None,
        })
        bms_r = bound(R * n27 * count, 0, sm_clocks_per_s)[0]
        log(f"[27] {kname}[{iname}] at N={n27}: R={R} t(R) {t1:.4f} ms, "
            f"t(2R) {t2:.4f} ms, bound of 2R {bms:.4f} ms ({bby}, share "
            f"{bms / t2:.2f}); delta {delta:.4f} ms, share "
            f"{bms_r / max(delta, 1e-9):.2f}; plain {plain_ms:.1f} ms at "
            f"R={r_plain}, bit-equal ({smi})")
    log(f"[27] timed {len(probes)} instances in {time.time() - t0:.1f} s")

    # -- 28. the stage and geometry probes (the tools' path) -----------------
    from vgen_tpu_torch.probes import microbench_layout as playout
    from vgen_tpu_torch.probes import microbench_rows as prows
    from vgen_tpu_torch.probes import profile_glv as pstage
    from vgen_tpu_torch.probes import proto_vtile as pvtile

    t0 = time.time()
    probe_log = build.build_log(("probes",))
    for kname in ("probe_glv_stage", "probe_vtile", "probe_rows",
                  "probe_layout", "probe_single_key", "probe_p2tr_match",
                  "probe_p2tr_match_lane"):
        figs = ptiming.ptxas_figures(probe_log, kname)
        log(f"[28] ptxas {kname}: " + "; ".join(
            f"{args} {ptiming.ptxas_text(f)}" for args, f in sorted(
                figs.items())))
    n28 = 4096
    row_steps, row_small = prows.CH_LEN, 256
    lay_r = playout.R
    # the inputs of each kind (and of each layout): (on the CPU at N = n28,
    # on the card at the tool's shape)
    inputs28 = {
        "stage": (pstage.stage_inputs(n28, "cpu", force=True),
                  pstage.stage_inputs(pcommon.TIMED_N, dev)),
        "vtile": (pvtile.vtile_inputs(n28),
                  tuple(t.to(dev) for t in
                        pvtile.vtile_inputs(pcommon.TIMED_N))),
        "rows": ((prows.rows_inputs(n28),),
                 (prows.rows_inputs(prows.LANES * prows.GRID).to(dev),)),
    }
    lay_small = playout.layout_inputs(n28)
    lay_timed = tuple(t.to(dev) for t in playout.layout_inputs(playout.LANES))
    for lay in playout.LAYOUTS:  # each layout's operands, laid out once
        inputs28[lay] = tuple(tuple(playout.to_layout(t, lay) for t in ab)
                              for ab in (lay_small, lay_timed))
    # probe_single_key: two windows of n28 lanes (the second partial) with
    # a DFA that hits often, then the tool's K = 8 windows of 524288 lanes
    sk_lo, sk_hi = pdfa.intervals("cpu")
    inputs28["single"] = (
        pdfa.window_inputs([0x5EED5EED, 0xC0FFEE0123], [n28, n28 - 100], n28,
                           "cpu")[:5]
        + (sk_lo, sk_hi) + pdfa.pattern_dfa("[a-k]$")
        + (torch.tensor([n28, n28 - 100], dtype=torch.int32),),
        pdfa.inputs(dev)[:5] + (sk_lo.to(dev), sk_hi.to(dev))
        + pdfa.pattern_dfa(pdfa.DFA_PATTERN, device=dev)
        + (torch.full((pdfa.K,), pdfa.B, dtype=torch.int32, device=dev),))
    # probe_p2tr_match: two windows of n28 lanes (the second partial) on q$,
    # then the tool's K = 8 windows of 524288 lanes on its pattern
    inputs28["p2tr"] = (
        ppm.inputs("cpu", 2, n28, remaining=[n28, n28 - 100])[:4]
        + ppm.pattern_dfa("q$")
        + (torch.tensor([n28, n28 - 100], dtype=torch.int32),),
        ppm.inputs(dev)[:4] + ppm.pattern_dfa(ppm.PATTERN, dev)
        + (torch.full((ppm.K,), ppm.B, dtype=torch.int32, device=dev),))
    kernel_b = {kind: fused.range_glv_match(AddressFormat.P2PKH,
                                            *inputs28[kind][1])
                for kind in ("stage", "vtile")}

    def stage28(mode, plain=False):
        fn = pstage.glv_stage_plain if plain else pstage.probe_glv_stage
        return lambda args: fn(mode, *args)

    def vtile28(v, t, plain=False):
        return ((lambda args: pvtile.probe_vtile_plain(*args)) if plain else
                (lambda args: pvtile.probe_vtile(v, t, *args)))

    def rows28(shape, mul, plain=False):
        fn = prows.probe_rows_plain if plain else prows.probe_rows
        return lambda args, steps=row_steps: fn(shape, mul, args[0], steps)

    def layout28(lay, plain=False):
        fn = playout.probe_layout_plain if plain else playout.probe_layout
        return lambda args: fn(lay, args[0], args[1], lay_r)

    stage_slots = inputs28["stage"][1][5].shape[0]
    vtile_slots = inputs28["vtile"][1][5].shape[0]
    stage_bytes = pstage.stage_nbytes(1, pcommon.TIMED_N, stage_slots)
    row_lanes = prows.LANES * prows.GRID
    # (row name, wrapper, kind, run, plain, count, bytes, replaces, whether
    # its output is kernel B's)
    probes28 = [
        (f"probe_glv_stage[{m}]", pstage.probe_glv_stage, "stage",
         stage28(m), stage28(m, True),
         pcommon.TIMED_N * pstage.stage_count(m, stage_slots), stage_bytes,
         "scripts/profile_glv.py:165", m in ("full", "fullr"))
        for m in pstage.MODES]
    probes28 += [
        (f"probe_vtile[{pvtile.instance_name(v, t)}]", pvtile.probe_vtile,
         "vtile", vtile28(v, t), vtile28(v, t, True),
         pcommon.TIMED_N * pstage.stage_count("full", vtile_slots),
         pstage.stage_nbytes(1, pcommon.TIMED_N, vtile_slots),
         "scripts/proto_vtile.py:65", True) for v, t in pvtile.instances()]
    probes28 += [
        (f"probe_rows[{prows.instance_name(sh, mul)}]", prows.probe_rows,
         "rows", rows28(sh, mul), rows28(sh, mul, True),
         row_lanes * prows.rows_count(mul, row_steps),
         (16 + (16 if sh == "full2d" else 1)) * 4 * row_lanes,
         "scripts/microbench_rows.py:"
         + {"row1d": "51", "row2d": "69", "full2d": "92"}[sh], False)
        for sh, mul in prows.instances()]
    probes28 += [
        (f"probe_layout[{lay}]", playout.probe_layout, lay,
         layout28(lay), layout28(lay, True),
         playout.LANES * playout.layout_count(lay_r),
         playout.BYTES_PER_LANE * playout.LANES,
         "scripts/microbench_layout.py:75", False)
        for lay in playout.LAYOUTS]
    sk_tab = inputs28["single"][1][7]
    # the timed table's narrow form, built once, as the scanner builds it
    sk_nar = fused.narrow_dfa(*inputs28["single"][1][7:9])
    sk_bytes = {m: pdfa.stage_nbytes(m, sk_lo.shape[0], d_bytes(
        sk_tab, "global" if m == "d_lane" else "shared"))
        for m in pdfa.MODES}
    probes28 += [
        (f"probe_single_key[{m}]", pdfa.probe_single_key, "single",
         lambda args, m=m: pdfa.probe_single_key(
             m, *args, narrow=sk_nar if args[7] is sk_tab else None),
         lambda args, m=m: pdfa.single_key_plain(m, *args),
         pdfa.K * pdfa.B * pdfa.stage_count(m, sk_lo.shape[0]), sk_bytes[m],
         "vgen_tpu/ops/pallas_fused.py:"
         + ("1243" if m in pdfa.C_MODES else "165"), False)
        for m in pdfa.MODES]
    pm_tab = inputs28["p2tr"][1][4]
    pm_nar = fused.narrow_dfa(*inputs28["p2tr"][1][4:6])
    probes28 += [
        (f"probe_p2tr_match[{m}]", ppm.probe_p2tr_match, "p2tr",
         lambda args, m=m: ppm.probe_p2tr_match(
             m, *args, narrow=pm_nar if args[4] is pm_tab else None),
         lambda args, m=m: ppm.match_plain(m, *args),
         ppm.K * ppm.B * ppm.stage_count(m), ppm.stage_nbytes(
             m, ppm.table_bytes(pm_tab, "global" if m == "i_lane" else
                                fused.dfa_form(*pm_tab.shape))),
         "vgen_tpu/ops/pallas_fused.py:1028", False)
        for m in ppm.MODES]
    err28 = {}
    small_plain = {}  # the vtile instances share one plain output
    for rname, _, kind, run, plain, _, _, _, is_b in probes28:
        small = inputs28[kind][0]
        if kind == "rows":
            want = plain(small, row_small)
            got = run(tuple(t.to(dev) for t in small), row_small)
        else:
            key = kind if kind == "vtile" else rname
            if key not in small_plain:
                small_plain[key] = plain(small)
            want = small_plain[key]
            got = run(on_dev(small))
        torch.cuda.synchronize()
        err28[rname] = max_abs_err(got.cpu(), want)
        require(err28[rname] == 0, f"{rname} differs from its plain version "
                f"at N={n28} ({err28[rname]})")
        require(int((want != 0).sum()) > 0, f"{rname}: an all-zero output "
                f"at N={n28} checks nothing")
        if is_b:
            got_b = fused.range_glv_match(
                AddressFormat.P2PKH, *(t.to(dev) for t in small)).cpu()
            require(torch.equal(got_b, want), f"{rname}: kernel B differs "
                    f"at N={n28}")
    log(f"[28] inputs built, {len(probes28)} instances == plain (on the "
        f"CPU) at N={n28} (rows {row_small} steps; the tiles == kernel B) in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    for (rname, wrapper, kind, run, plain, count, nbytes, replaces,
         is_b) in probes28:
        args = inputs28[kind][1]
        wrapper.launches = 0
        ms = cuda_ms(lambda: run(args), 10)
        launches28 = wrapper.launches
        require(launches28 > 0, f"{rname} was not launched")
        ref = run(args)
        plain_ms = cuda_ms(lambda: plain_out.append(plain(args)), 1,
                           warm=False)
        err = max_abs_err(plain_out.pop(), ref)
        require(err == 0, f"{rname} differs from its plain version at its "
                "timed shape")
        require(not is_b or torch.equal(ref, kernel_b[kind]),
                f"{rname} differs from kernel B at its timed shape")
        bms, bby = bound(count, nbytes, sm_clocks_per_s)
        require(ms >= bms, f"{rname}: {ms:.4f} ms beats its bound "
                f"{bms:.4f} ms: the model counts more than the work needs")
        kernels.append({
            "name": rname, "route": "cuda",
            "source": "vgen_tpu_torch/probes/probes.cu",
            "replaces": replaces, "launches": launches28,
            "max_abs_err": max(err, err28[rname]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
            "library_ms": None,
        })
        torch.cuda.empty_cache()
        log(f"[28] {rname}: {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
            f"{bms:.4f} ms ({bby}, share {bms / ms:.2f}), bit-equal ({smi})")
    log(f"[28] timed {len(probes28)} instances in {time.time() - t0:.1f} s")

    # -- 29. the range DFA rate per format ------------------------------------
    # whole windows of a never-matching suffix through kernels A and D (in
    # the form its table takes), after one warm-up super-step
    steps29 = 64
    K, B = sc.DEFAULT_K_SUB, sc.DEFAULT_DEVICE_BATCH
    for fmt29, src in ((AddressFormat.P2PKH, "BenchNeverMatches$"),
                       (AddressFormat.P2WPKH, "q" * 16 + "$"),
                       (P2SH, "BenchNeverMatches$"),
                       (UNC, "BenchNeverMatches$"),
                       (ETH, "deadbeefcafe0123$")):
        pat29 = Pattern(src)
        start29 = 0x5EED00000000
        scanner = sc.DeviceScanner(fmt29)
        scanner.scan(pat29, ScanConfig(format=fmt29, start=start29,
                                       end=start29 + K * B - 1, count=0))
        end29 = start29 + steps29 * K * B - 1
        reset_launches()
        res = scanner.scan(pat29, ScanConfig(format=fmt29, start=start29,
                                             end=end29, count=0))
        got = read_launches()
        require(not res.matches and res.operations == end29 - start29 + 1,
                f"{fmt29.value} {src}: {len(res.matches)} matches, "
                f"{res.operations} operations")
        form29 = fused.dfa_form(*pat29.device_dfa(fmt29).table.shape)
        require(got["batch_inverse_dx"] > 0 and got[f"dfa_match[{form29}]"] > 0
                and got["range_match"] == 0 and got["glv_dfa_match"] == 0,
                f"{fmt29.value} range DFA rate: launches {got}")
        log(f"[29] range DFA rate {fmt29.value} {src}: "
            f"{res.operations / res.elapsed_secs:,.0f} range keys/s "
            f"({res.operations:,} keys in {res.elapsed_secs:.3f} s, "
            f"{res.elapsed_secs / steps29 * 1e3:.3f} ms per super-step of "
            f"{K * B:,} keys; launches {got}) on {smi}")
        del scanner
        torch.cuda.empty_cache()

    # -- 30. mesh rows against DeviceScanner --------------------------------
    import socket

    import torch.distributed as dist

    from vgen_tpu_torch import tui
    from vgen_tpu_torch.parallel import distributed
    from vgen_tpu_torch.parallel.mesh import MeshScanner

    B30, K30 = 8192, 2
    base30 = 0x5EED5EED5EED
    for devs30 in (["cuda:0"], ["cuda:0", "cuda:0"]):
        mesh30 = MeshScanner(fmt, B30, devs30, k_sub=K30)
        W30 = mesh30.windows
        ref30 = sc.DeviceScanner(fmt, B30, dev, k_sub=W30)
        # (pattern, random scan: six GLV keys a position, the kernels)
        for src, allow_glv, kern30, rem30 in (
                ("^1C", True, ("range_glv_match",), None),
                ("c[a4]t", True, ("glv_dfa_match",), None),
                ("[Cc][a4]t", False, ("dfa_match",), W30 * B30 - 1000)):
            pat30 = Pattern(src)
            cfg30 = ScanConfig(format=fmt, start=None if allow_glv else 1)
            step30 = ref30._plan(pat30, cfg30, glv=allow_glv).step
            rems30 = ([B30] * W30 if rem30 is None else
                      [max(0, min(B30, rem30 - j * B30)) for j in range(W30)])
            # two super-batches: the first runs each device's route eagerly
            # (or replays it, on the second entry of a repeated device), the
            # second replays every device's graph; a repeated device's
            # entries share one graph output
            bases30 = [base30 + i * W30 * B30 for i in range(2)]
            wants30 = [step30(*ref30._base_points(
                [b + j * B30 for j in range(W30)]),
                ref30._remaining(rems30)).cpu().numpy() for b in bases30]
            reset_launches()
            for i30, (b30, want30) in enumerate(zip(bases30, wants30)):
                got30 = mesh30.drain_packed(mesh30.submit_super_batch(
                    pat30, b30, rem30, allow_glv=allow_glv))
                require(got30.shape == want30.shape
                        and np.array_equal(got30, want30),
                        f"mesh {devs30} {src} super-batch {i30}: rows "
                        "differ from DeviceScanner's")
                require(int(got30[:, 0].sum()) > 0, f"mesh {devs30} {src}: "
                        "no matching lane checks nothing")
            got = read_launches()
            require(got["batch_inverse_dx"] == 2 * len(devs30) and all(
                got[k] == 2 * len(devs30) for k in kern30),
                f"mesh {devs30} {src}: launches {got}")
            log(f"[30] mesh on {devs30}, k_sub={K30}, B={B30}: {src} "
                f"({'random' if allow_glv else 'range'}) rows == "
                f"DeviceScanner's over 2 x {W30} windows "
                f"({int(got30[:, 0].sum())} matching positions in the "
                f"second); launches {got}")
        del mesh30, ref30
    torch.cuda.empty_cache()

    # -- 31. NCCL at world size 1: the mesh through scan_with_progress --------
    # phase 32's mesh without a process group (so without a collective),
    # built before the group forms
    solo32 = MeshScanner(fmt)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port31 = sock.getsockname()[1]
    t0 = time.time()
    require(distributed.initialize(f"127.0.0.1:{port31}", 1, 0,
                                   device="cuda") is False
            and dist.get_backend() == "nccl" and distributed.world_size() == 1,
            "NCCL process group at world size 1 did not form")
    log(f"[31] NCCL process group (tcp://127.0.0.1:{port31}, world size 1) in "
        f"{time.time() - t0:.2f} s")
    try:
        for fmt31, src, count31, kern31 in (
                (fmt, "^1C", 1, ("range_glv_match",)),
                (p2tr, "^bc1pqq", 1, ("p2tr_ladder", "batch_inverse_chain",
                                      "p2tr_finish_range")),
                (p2tr, "qq$", 1, ("p2tr_ladder", "batch_inverse_chain",
                                  "p2tr_finish_match"))):
            reset_launches()
            t0 = time.time()
            res = sc.scan_with_progress(Pattern(src), ScanConfig(
                format=fmt31, count=count31, mesh=True))
            secs = time.time() - t0
            got = read_launches()
            gen31 = AddressGenerator(fmt31)
            require(len(res.matches) == count31 and all(
                gen31.generate(bytes.fromhex(m.hex)).address == m.address
                and Pattern(src).matches(m.address) for m in res.matches),
                f"mesh {fmt31.value} {src}: {res.matches}")
            require(got["batch_inverse_dx"] > 0 and all(
                got[k] > 0 for k in kern31), f"mesh {src}: launches {got}")
            log(f"[31] mesh scan_with_progress {fmt31.value} {src} -c "
                f"{count31}: {[m.address for m in res.matches]} "
                f"oracle-confirmed in {secs:.1f} s ({res.operations:,} keys); "
                f"launches {got}")
        # the DFA range of phase 13 with a checkpoint: the native scanner's
        # match set, key for key
        with tempfile.TemporaryDirectory() as tmp:
            path31 = os.path.join(tmp, "mesh_range.json")
            ckpt31 = CheckpointManager(path31, pattern=src13, fmt=fmt.value,
                                       start=start13, end=end13)
            reset_launches()
            t0 = time.time()
            res = sc.scan_with_progress(Pattern(src13), ScanConfig(
                format=fmt, start=start13, end=end13, count=0,
                checkpoint=ckpt31, mesh=True))
            secs = time.time() - t0
            got = read_launches()
            with open(path31) as f:
                saved31 = json.load(f)
        keys31 = sorted(int(m.hex, 16) for m in res.matches)
        want31 = sorted(int(m.hex, 16) for m in ref13.matches)
        require(keys31 == want31 and res.operations == end13 - start13 + 1,
                f"mesh DFA range: {len(keys31)} matches, native "
                f"{len(want31)}; {res.operations} operations")
        require(all(Pattern(src13).matches(m.address) for m in res.matches),
                "mesh DFA range: a match fails the regex")
        require(int(saved31["next_key"], 16) == end13 + 1
                and saved31["operations"] == res.operations,
                f"mesh DFA range: checkpoint {saved31}")
        require(got["batch_inverse_dx"] > 0 and got["dfa_match"] > 0
                and got["glv_dfa_match"] == 0 and got["range_match"] == 0,
                f"mesh DFA range: launches {got}")
        log(f"[31] mesh range {start13:x}:{end13:x} -p {src13} -c 0 with a "
            f"checkpoint: {len(keys31)} matches in {secs:.1f} s == native "
            f"scanner's; checkpoint next_key {saved31['next_key']}; "
            f"launches {got}")
        # the same range on an interval pattern, -c 1: the native scanner's
        # lowest key, through kernel C
        reset_launches()
        res = sc.scan_with_progress(Pattern("^1C"), ScanConfig(
            format=fmt, start=start13, end=end13, count=1, mesh=True))
        got = read_launches()
        want31 = [int(m.hex, 16) for m in _scan_cpu(Pattern("^1C"), ScanConfig(
            format=fmt, start=start13, end=end13, count=1, use_device=False),
            None, None).matches]
        require([int(m.hex, 16) for m in res.matches] == want31 and want31,
                f"mesh interval range -c 1: {res.matches}, native {want31}")
        require(got["range_match"] > 0 and got["range_glv_match"] == 0,
                f"mesh interval range: launches {got}")
        log(f"[31] mesh range {start13:x}:{end13:x} -p ^1C -c 1: "
            f"{hex(want31[0])}, the native scanner's lowest; launches {got}")

        # -- 32. the mesh against DeviceScanner, world size 1 ----------------
        # in turns: DeviceScanner, the mesh under the NCCL group (an
        # all_gather every super-step), the mesh without a group
        pat32 = Pattern("^1BenchNeverMatches")
        mesh32 = MeshScanner(fmt)
        dev32 = sc.DeviceScanner(fmt)
        cfg32 = ScanConfig(format=fmt, count=0, in_flight=4)

        def rate32(which, secs):
            stop = StopFlag()
            t_0 = time.time()

            def cb(ops):
                if time.time() - t_0 >= secs:
                    stop.set()

            if which == "device":
                res32 = dev32.scan(pat32, cfg32, cb, stop,
                                   recover_overflow=False)
            else:
                res32 = (mesh32 if which == "mesh" else solo32).scan(
                    pat32, count=0, progress_callback=cb, stop_flag=stop,
                    in_flight=4)
            return res32.rate()

        order32 = ("device", "mesh", "solo", "solo", "mesh", "device")
        for which in order32[:3]:
            rate32(which, 1.0)  # warm-up: routes, tables, the first gathers
        rates32 = {which: [] for which in order32[:3]}
        for which in order32:
            rates32[which].append(rate32(which, 2.0))
        mean32 = {k: sum(v) / len(v) for k, v in rates32.items()}
        step_ms = {k: mesh32.windows * mesh32.batch * fused.GLV_KEYS / r * 1e3
                   for k, r in mean32.items()}
        rows32 = torch.zeros((mesh32.windows, 34), dtype=torch.int32,
                             device=dev)
        gather_ms = cuda_ms(lambda: mesh32._gather(rows32), 50)
        log(f"[32] random ^1BenchNeverMatches, B=524288, k_sub=8, world size "
            f"1, in turns {order32}, 2.0 s each: DeviceScanner "
            f"{mean32['device']:,.0f} keys/s {[round(r) for r in rates32['device']]}, "
            f"mesh (NCCL all_gather every super-step) {mean32['mesh']:,.0f} "
            f"{[round(r) for r in rates32['mesh']]}, mesh without a group "
            f"{mean32['solo']:,.0f} {[round(r) for r in rates32['solo']]}; "
            f"mesh / DeviceScanner {mean32['mesh'] / mean32['device']:.4f}, "
            f"without a group {mean32['solo'] / mean32['device']:.4f}; the "
            f"collective's share of a super-step "
            f"{1 - step_ms['solo'] / step_ms['mesh']:.4f} ({step_ms['mesh']:.3f}"
            f" against {step_ms['solo']:.3f} ms); 50 all_gathers of the (8, "
            f"34) rows in a row {gather_ms:.4f} ms each; {smi}")
        del mesh32, dev32, solo32
        torch.cuda.empty_cache()

        # -- 33. the TUI on the card ----------------------------------------
        class Screen:
            """A curses screen that records what is drawn."""

            def __init__(self):
                self.drawn, self.calls = [], 0

            def nodelay(self, flag):
                pass

            def erase(self):
                pass

            def getmaxyx(self):
                return (40, 120)

            def addnstr(self, y, x, text, n, attr=0):
                self.drawn.append(text)

            def refresh(self):
                pass

            def getch(self):
                self.calls += 1
                return ord("q") if self.calls > 3000 else -1

        screen = Screen()
        saved33 = {k: getattr(tui.curses, k) for k in (
            "wrapper", "curs_set", "start_color", "use_default_colors",
            "init_pair", "color_pair")}
        tui.curses.wrapper = lambda f: f(screen)
        for k in ("curs_set", "start_color", "use_default_colors",
                  "init_pair"):
            setattr(tui.curses, k, lambda *a: None)
        tui.curses.color_pair = lambda *a: 0
        reset_launches()
        t0 = time.time()
        try:
            res = tui.run_tui(Pattern("^1C"), ScanConfig(format=fmt, count=1),
                              StopFlag(), device="cuda")
        finally:
            for k, v in saved33.items():
                setattr(tui.curses, k, v)
        secs = time.time() - t0
        got = read_launches()
        text33 = "\n".join(screen.drawn)
        require(len(res.matches) == 1 and "MATCH #1" in text33
                and res.matches[0].address in text33
                and "Device search..." in text33, "TUI frames lack the match")
        require(AddressGenerator(fmt).generate(bytes.fromhex(
            res.matches[0].hex)).address == res.matches[0].address,
            "TUI match not confirmed by the oracle")
        require(got["range_glv_match"] > 0, f"TUI scan: launches {got}")
        log(f"[33] run_tui ^1C -c 1 on the card: MATCH #1 "
            f"{res.matches[0].address} drawn and oracle-confirmed in "
            f"{secs:.1f} s ({len(screen.drawn)} strings drawn); launches {got}")
    finally:
        dist.destroy_process_group()

    # -- 34. kernel J vs plain, timed -----------------------------------------
    K34, R34 = sc.DEFAULT_K_SUB, sc.ADVANCE_AHEAD
    D34 = K34 * sc.DEFAULT_DEVICE_BATCH
    rng34 = random.Random(34)
    ks34 = [2 + rng34.randrange(ec.N - 2 - R34 * D34) for _ in range(K34)]

    def limbs34(points):
        return torch.stack([u256.as_i32(u256.from_ints(
            [p[i] for p in points]).T) for i in (0, 1)]).to(dev)

    bxy34 = limbs34([ec.scalar_mult_base_fast(k) for k in ks34])
    qs34 = limbs34([ec.scalar_mult_base_fast((m + 1) * D34)
                    for m in range(R34)]).transpose(0, 1).contiguous()
    ref34 = torch.zeros((R34, 2, K34, 8), dtype=torch.int32, device=dev)
    fused.base_advance(bxy34[0], bxy34[1], qs34, ref34)
    torch.cuda.synchronize()
    want34 = torch.stack([limbs34([ec.scalar_mult_base_fast(k + (m + 1) * D34)
                                   for k in ks34]) for m in range(R34)])
    require(torch.equal(ref34, want34),
            "kernel J: its rows are not (k + (m + 1) D) G")
    launches34 = path_launches["range interval"]["base_advance"]
    require(launches34 > 0, "kernel J: no launch on phase 11's range scan")
    out34 = torch.empty_like(ref34)

    def plain34():
        out = torch.empty_like(ref34)
        fused.base_advance_plain(bxy34[0], bxy34[1], qs34, out)
        return out

    ms, plain_ms, bms, bby = time_kernel(
        "base_advance",
        lambda: fused.base_advance(bxy34[0], bxy34[1], qs34, out34), plain34,
        ref34, "none: vgen_tpu/scan/scanner.py:428 (host)", launches34, 0,
        f"K={K34} R={R34}",
        R34 * K34 * (256 * FE_SQR + 17 * FE_MUL + 6 * FE_ADD),
        K34 * 64 + R34 * 64 + R34 * K34 * 64, reps=100)
    log(f"[34] base_advance at K={K34}, R={R34} super-steps ahead, D={D34}: "
        f"kernel {ms * 1e3:.1f} us a launch, {ms * 1e3 / R34:.1f} us a "
        f"super-step (budget 50 us), plain {plain_ms:.1f} ms, bound "
        f"{bms:.5f} ms ({bby}), == (k + (m + 1) D) G and plain; "
        f"{launches34} launches on phase 11's range scan ({smi})")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
