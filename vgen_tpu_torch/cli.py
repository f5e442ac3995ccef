"""Command line of the port: generate / estimate / range / verify /
list-devices (alias list-gpus).

``generate`` and ``range`` scan on the card (``--backend cuda``, the
default; with no visible card they exit with an error), on CPU tensors
through the kernels' plain versions (``--backend cpu``), or with
the port's copy of the native C++ scanner (``--no-device``).  Nothing falls back
from one to another.  In a terminal they run under the terminal UI
(``tui.py``) unless ``--no-tui`` is given; only a terminal that fails
falls back to console output.  ``estimate`` calibrates on the card only
when one is visible.
"""

from __future__ import annotations

import argparse
import contextlib
import curses
import json
import os
import signal
import sys
import time
from typing import List, Optional, Tuple

import torch

from vgen_tpu_torch import provider as provider_mod
from vgen_tpu_torch import tracing
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import (
    AddressFormat,
    derive_all,
    parse_private_key,
)
from vgen_tpu_torch.output import (
    VanityResult,
    format_duration,
    format_with_commas,
    write_results,
)
from vgen_tpu_torch.pattern import Pattern, RegexError
from vgen_tpu_torch.scan.checkpoint import CheckpointManager
from vgen_tpu_torch.scan.host import ScanConfig, ScanResult, StopFlag

# the JAX package's five choices, and uncompressed P2PKH, which its CLI
# reaches only through a puzzle provider's address
FORMATS = ["p2pkh", "p2wpkh", "p2sh-p2wpkh", "p2tr", "ethereum",
           "p2pkh-uncompressed"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vgen-tpu-torch",
        description="Bitcoin vanity address generator on an NVIDIA GPU "
        "(PyTorch + CUDA)",
    )
    # the metavar leaves the hidden alias list-gpus out of the usage line
    sub = p.add_subparsers(
        dest="command", required=True,
        metavar="{generate,estimate,range,verify,list-devices}")

    def add_search_args(sp, pattern_required: bool):
        sp.add_argument("-p", "--pattern", required=pattern_required,
                        help="Regex pattern (e.g. '^1Cat') or provider "
                        "reference (e.g. 'boha:b1000:66')")
        sp.add_argument("-l", "--prefix-length", type=int, default=None,
                        help="For provider patterns: match on first N "
                        "address chars")
        sp.add_argument("-f", "--format", default="p2pkh", choices=FORMATS)
        sp.add_argument("-t", "--threads", type=int, default=None,
                        help="CPU threads for the native scanner "
                        "(--no-device)")
        sp.add_argument("--no-device", "--no-gpu", dest="no_device",
                        action="store_true",
                        help="Scan with the native C++ CPU scanner")
        sp.add_argument("--backend", default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the CUDA kernels (a card is required); "
                        "cpu: the same scan on CPU tensors through the "
                        "plain versions")
        sp.add_argument("--device-batch-size", "--gpu-batch-size",
                        dest="device_batch_size", type=int, default=None,
                        help="Keys per window (default 524288)")
        sp.add_argument("--no-tui", action="store_true",
                        help="Console output instead of the terminal UI")
        sp.add_argument("-o", "--output", default="text",
                        choices=["text", "json", "jsonl", "csv", "minimal"])
        sp.add_argument("--file", default=None,
                        help="Write output to file instead of stdout")
        sp.add_argument("--repeat", type=int, default=1,
                        help="Repeat the search N times")
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="Write a torch.profiler trace of the scan into "
                        "DIR (a Chrome trace: chrome://tracing or Perfetto)")
        sp.add_argument("-q", "--quiet", action="store_true")

    g = sub.add_parser("generate", help="Generate vanity address matching a pattern")
    add_search_args(g, pattern_required=True)
    g.add_argument("-i", "--ignore-case", action="store_true")
    g.add_argument("-c", "--count", type=int, default=1,
                   help="Stop after finding N matches")
    g.add_argument("--cpu-batch-size", type=int, default=10000)
    g.add_argument("--tui", action="store_true",
                   help="(deprecated; the TUI is the default in terminals)")

    e = sub.add_parser("estimate", help="Estimate difficulty of a pattern (dry run)")
    e.add_argument("-p", "--pattern", required=True)
    e.add_argument("-l", "--prefix-length", type=int, default=None)
    e.add_argument("-f", "--format", default="p2pkh", choices=FORMATS)
    e.add_argument("-i", "--ignore-case", action="store_true")

    r = sub.add_parser("range", help="Scan a specific key range (Bitcoin Puzzles)")
    add_search_args(r, pattern_required=False)
    r.add_argument("-r", "--range", dest="range_", default=None,
                   help="START:END hex keys (e.g. 2000:3FFF)")
    r.add_argument("--puzzle", type=int, default=None,
                   help="Puzzle number (sets range to [2^(n-1), 2^n-1])")
    r.add_argument("-c", "--count", type=int, default=1,
                   help="Stop after N matches (0 = scan entire range)")
    r.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="Persist scan position to FILE and resume from it")

    v = sub.add_parser("verify", help="Verify a private key produces expected address")
    v.add_argument("-k", "--key", required=True, help="Private key (WIF or hex)")
    v.add_argument("-a", "--address", default=None, help="Expected address")

    ld = sub.add_parser("list-devices", help="List visible CUDA devices")
    ld.add_argument("--json", action="store_true")
    # the reference's hidden alias: a parser with no help text is not listed
    lg = sub.add_parser("list-gpus")
    lg.add_argument("--json", action="store_true")
    return p


# The helpers below are the port's copies of vgen_tpu/cli.py's.


def resolve_pattern_and_format(
    pattern: str, prefix_length: Optional[int], default_format: AddressFormat
) -> Tuple[str, AddressFormat]:
    """lib.rs:563-590 parity."""
    res = provider_mod.resolve(pattern)
    if res is not None:
        if prefix_length is not None:
            if prefix_length == 0:
                raise SystemExit(
                    "error: --prefix-length must be at least 1 for provider patterns"
                )
            resolved = provider_mod.build_pattern(res, prefix_length)
        else:
            resolved = provider_mod.build_exact_pattern(res)
        print(
            f"Provider: {pattern} → {res.address} → pattern '{resolved}'",
            file=sys.stderr,
        )
        return resolved, res.format
    if prefix_length is not None:
        print("Warning: --prefix-length is ignored for regex patterns",
              file=sys.stderr)
    return pattern, default_format


def resolve_range_params(
    pattern: str,
    prefix_length: Optional[int],
    default_format: AddressFormat,
    range_str: Optional[str],
    puzzle: Optional[int],
) -> Tuple[int, int, str, AddressFormat]:
    """lib.rs:592-663 parity."""
    res = provider_mod.resolve(pattern)
    if res is not None:
        if prefix_length is not None:
            if prefix_length == 0:
                raise SystemExit(
                    "error: --prefix-length must be at least 1 for provider patterns"
                )
            resolved = provider_mod.build_pattern(res, prefix_length)
        else:
            resolved = provider_mod.build_exact_pattern(res)
        print(f"Provider: {pattern} → {res.address}", file=sys.stderr)
        if range_str is not None or puzzle is not None:
            start, end = parse_explicit_range(range_str, puzzle)
        elif res.key_range is not None:
            start, end = res.key_range
        else:
            raise SystemExit(
                f"error: provider '{pattern}' has no key range; use --range or --puzzle"
            )
        return start, end, resolved, res.format
    start, end = parse_explicit_range(range_str, puzzle)
    return start, end, pattern, default_format


def parse_explicit_range(
    range_str: Optional[str], puzzle: Optional[int]
) -> Tuple[int, int]:
    if puzzle is not None:
        if not 1 <= puzzle <= 160:
            raise SystemExit("error: puzzle number must be between 1 and 160")
        return 1 << (puzzle - 1), (1 << puzzle) - 1
    if range_str is not None:
        parts = range_str.split(":")
        if len(parts) != 2:
            raise SystemExit("error: range must be in format START:END")
        try:
            return int(parts[0], 16), int(parts[1], 16)
        except ValueError:
            raise SystemExit("error: invalid hex in range")
    raise SystemExit(
        "error: either --range, --puzzle, or a provider pattern with a key "
        "range must be specified"
    )


class _TwoStageInterrupt:
    """Ctrl+C: first press requests stop, second force-exits (lib.rs:1088-1097)."""

    def __init__(self, stop_flag):
        self.stop = stop_flag
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            if self.stop.is_set():
                sys.exit(1)
            print("\nStopping... (press Ctrl+C again to force)", file=sys.stderr)
            self.stop.set()

        try:
            self._prev = signal.signal(signal.SIGINT, handler)
        except ValueError:  # not main thread (tests)
            self._prev = None
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGINT, self._prev)


def _to_vanity_results(result, pattern_str, fmt) -> List[VanityResult]:
    rate = result.operations / result.elapsed_secs if result.elapsed_secs > 0 else 0.0
    return [
        VanityResult(
            address=m.address,
            wif=m.wif,
            private_key_hex=m.hex,
            format=fmt.display_name,
            pattern=pattern_str,
            operations=result.operations,
            elapsed_secs=result.elapsed_secs,
            rate=rate,
        )
        for m in result.matches
    ]


def _emit(results, output, file, quiet, result):
    if file:
        with open(file, "w") as f:
            write_results(results, output, f, quiet)
        if results and not quiet:
            print(f"Wrote {len(results)} result(s) to {file}", file=sys.stderr)
    else:
        write_results(results, output, sys.stdout, quiet)
    if not results and not quiet:
        print(
            f"No match found after {format_with_commas(result.operations)} "
            f"operations ({format_duration(result.elapsed_secs)})",
            file=sys.stderr,
        )


def cmd_verify(args) -> int:
    """lib.rs:377-494 parity."""
    try:
        secret = parse_private_key(args.key)
    except (ValueError, Exception) as e:
        print(f"error: invalid key format (not WIF or hex): {e}", file=sys.stderr)
        return 2
    d = derive_all(secret)
    is_wif = not set(args.key.lower()).issubset(set("0123456789abcdefx"))
    print(f"Private key: {args.key if is_wif else d['wif']}")
    print(f"WIF (uncompr.):     {d['wif_uncompressed']}")
    print(f"Hex: {d['hex']}")
    print()
    print(f"P2PKH address:      {d['p2pkh']}")
    print(f"P2PKH (uncompr.):   {d['p2pkh_uncompressed']}")
    print(f"P2WPKH address:     {d['p2wpkh']}")
    print(f"P2SH-P2WPKH addr:  {d['p2sh_p2wpkh']}")
    print(f"P2TR address:       {d['p2tr']}")
    print(f"Ethereum address:   {d['ethereum']}")

    if args.address:
        expected = args.address
        # BIP173: bech32 allows all-lower or all-upper; normalize single-case
        is_bech32 = expected[:3].lower() == "bc1"
        alpha = [c for c in expected if c.isalpha()]
        single_case = all(c.islower() for c in alpha) or all(
            c.isupper() for c in alpha
        )
        normalized = expected.lower() if (is_bech32 and single_case) else expected

        candidates = [
            d["p2pkh"], d["p2pkh_uncompressed"], d["p2wpkh"],
            d["p2sh_p2wpkh"], d["p2tr"], d["ethereum"],
        ]
        is_raw_eth = len(normalized) == 40 and all(
            c in "0123456789abcdefABCDEF" for c in normalized
        )
        eth_normalized = "0x" + normalized if is_raw_eth else normalized

        if normalized in candidates:
            print("\nMATCH!")
        elif eth_normalized[:2].lower() == "0x" and d[
            "ethereum"
        ].lower() == eth_normalized.lower():
            print("\nMATCH! (Ethereum, case-insensitive)")
        else:
            print(f"\nMISMATCH! Expected: {expected}")
    return 0


def resolve_device(backend: str, no_device: bool) -> Optional[str]:
    """The torch device to scan on, or None for the native CPU scanner.
    A scan on the card first joins the process group of a multi-process
    scan when the environment names one (``parallel/distributed.py``; it
    raises when the group cannot form); the CPU backends never do, as in
    the reference (``vgen_tpu/cli.py`` ``resolve_use_device``)."""
    from vgen_tpu_torch.parallel import distributed

    if no_device:
        return None
    if backend == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        print("error: --backend cuda requested but no CUDA device is "
              "visible (use --backend cpu or --no-device)", file=sys.stderr)
        raise SystemExit(2)
    distributed.initialize(device="cuda")
    return "cuda"


def run_search(pattern_str: str, ignore_case: bool, fmt: AddressFormat,
               count: int, device: Optional[str], args,
               start: Optional[int] = None, end: Optional[int] = None,
               checkpoint_path: Optional[str] = None) -> int:
    from vgen_tpu_torch.scan import scanner as sc

    try:
        pat = Pattern(pattern_str, ignore_case)
    except RegexError as e:
        print(f"error: failed to compile pattern: {e}", file=sys.stderr)
        return 2
    ckpt = None
    if checkpoint_path and start is not None:
        ckpt = CheckpointManager(
            checkpoint_path, pattern=pattern_str, fmt=fmt.value, start=start,
            end=end if end is not None else ec.N - 1)
        state = ckpt.load()
        if state is not None and not args.quiet:
            print(f"Resuming from checkpoint: next key "
                  f"{hex(state['next_key'])}, "
                  f"{format_with_commas(state['operations'])} ops, "
                  f"{len(state['match_keys'])} match(es)", file=sys.stderr)
    invalid = pat.validate_charset(fmt)
    if invalid:
        name = fmt.charset_name
        print(f"Warning: Pattern contains characters not valid in {name} "
              f"addresses: '{''.join(invalid)}'", file=sys.stderr)
        print(f"  {name} alphabet excludes these characters - pattern will "
              "NEVER match!", file=sys.stderr)
        if name == "Base58":
            print("  Base58 excludes: 0 (zero), O (uppercase o), I (uppercase"
                  " i), l (lowercase L)", file=sys.stderr)
    config = ScanConfig(
        format=fmt, count=count, threads=args.threads,
        device_batch_size=args.device_batch_size,
        cpu_batch_size=getattr(args, "cpu_batch_size", None),
        start=start, end=end, use_device=device is not None, checkpoint=ckpt,
    )
    stop = StopFlag()
    if _use_tui(args):
        from vgen_tpu_torch.tui import run_tui

        try:
            result = run_tui(pat, config, stop, device=device or "cpu")
        except curses.error as e:  # the terminal failed (lib.rs:760-763)
            print(f"TUI failed ({e}); falling back to console.",
                  file=sys.stderr)
            stop = StopFlag()
        else:
            # as the reference does, the results go through the output
            # writers once the alternate screen has closed (lib.rs:766+)
            _emit(_to_vanity_results(result, pattern_str, fmt), args.output,
                  args.file, args.quiet, result)
            return 0
    t0 = time.time()
    total = ScanResult()
    last_print = [0.0]

    def progress(ops):
        # at most one line every 0.5 s, as the reference prints
        if args.quiet:
            return
        now = time.time()
        if now - last_print[0] <= 0.5:
            return
        last_print[0] = now
        elapsed = now - t0
        done = total.operations + ops
        rate = done / elapsed if elapsed > 0 else 0.0
        print(f"\r[{format_duration(elapsed)}] checked "
              f"{format_with_commas(done)} keys ({rate:,.0f}/s)   ",
              end="", file=sys.stderr)

    with _TwoStageInterrupt(stop), _profiled(args.profile, device,
                                             args.quiet):
        for _ in range(max(1, args.repeat)):
            res = sc.scan_with_progress(pat, config, progress, stop,
                                        device=device or "cpu")
            total.operations += res.operations
            total.matches.extend(res.matches)
            if stop.is_set():
                break
    if not args.quiet:
        print("", file=sys.stderr)
    total.elapsed_secs = time.time() - t0
    _emit(_to_vanity_results(total, pattern_str, fmt), args.output,
          args.file, args.quiet, total)
    return 0


@contextlib.contextmanager
def _profiled(trace_dir: Optional[str], device: Optional[str], quiet: bool):
    """With ``trace_dir``, a torch.profiler trace of the scan (CPU and CUDA
    activity on the card, CPU activity otherwise), written into the
    directory as a Chrome trace, and beside it the spans, counters and
    start stages of ``tracing.snapshot()`` as JSON; the counterpart of the
    reference's ``--profile`` (a JAX profiler trace)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()  # a profiler that cannot start raises here, as itself
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"vgen_tpu_torch_scan_{os.getpid()}.json"))
        with open(os.path.join(trace_dir, "vgen_tpu_torch_spans_"
                               f"{os.getpid()}.json"), "w") as f:
            json.dump(tracing.snapshot(), f, indent=1)
        if not quiet:
            print(f"\nProfiler trace written to {trace_dir}", file=sys.stderr)


def _use_tui(args) -> bool:
    return not args.no_tui and sys.stdout.isatty()


def _refuse_repeat_under_tui(args) -> bool:
    """The TUI runs one search (vgen_tpu/cli.py:539-542)."""
    if _use_tui(args) and args.repeat > 1:
        print("error: TUI mode supports a single run; use --no-tui",
              file=sys.stderr)
        return True
    return False


def cmd_generate(args) -> int:
    fmt = AddressFormat.from_str(args.format)
    pattern_str, fmt = resolve_pattern_and_format(
        args.pattern, args.prefix_length, fmt)
    if args.tui:
        print("Warning: --tui is deprecated. TUI is now enabled by default in "
              "interactive terminals.", file=sys.stderr)
    if args.ignore_case and fmt in (AddressFormat.P2WPKH,
                                    AddressFormat.ETHEREUM):
        print("Warning: Bech32/Ethereum addresses case sensitivity handling is "
              "specific. -i flag might be redundant.", file=sys.stderr)
    device = resolve_device(args.backend, args.no_device)
    if _refuse_repeat_under_tui(args):
        return 2
    return run_search(pattern_str, args.ignore_case, fmt, args.count,
                      device, args)


def cmd_range(args) -> int:
    fmt = AddressFormat.from_str(args.format)
    pattern_str = args.pattern if args.pattern is not None else "."
    start, end, resolved, fmt = resolve_range_params(
        pattern_str, args.prefix_length, fmt, args.range_, args.puzzle)
    device = resolve_device(args.backend, args.no_device)
    if _refuse_repeat_under_tui(args):
        return 2
    return run_search(resolved, False, fmt, args.count, device, args,
                      start=start, end=end, checkpoint_path=args.checkpoint)


def cmd_estimate(args) -> int:
    """Difficulty and the native CPU scanner's rate; with a visible card,
    about 2 s of the port's device scan on the pattern's own route."""
    from vgen_tpu_torch import native
    from vgen_tpu_torch.scan.host import benchmark
    from vgen_tpu_torch.scan import scanner as sc

    fmt = AddressFormat.from_str(args.format)
    pattern_str, fmt = resolve_pattern_and_format(
        args.pattern, args.prefix_length, fmt)
    try:
        pat = Pattern(pattern_str, args.ignore_case)
    except RegexError as e:
        print(f"error: failed to compile pattern: {e}", file=sys.stderr)
        return 2
    difficulty = pat.estimate_difficulty(fmt)
    rate = benchmark(fmt, 10_000)
    expected = difficulty / rate if rate > 0 else float("inf")
    print(f"Pattern: {pattern_str}")
    print(f"Format: {fmt.display_name}")
    print(f"Case insensitive: {str(args.ignore_case).lower()}")
    print()
    print(f"Estimated difficulty: 1 in {format_with_commas(difficulty)}")
    source = ("native CPU scanner" if native.available()
              else "CPU single thread")
    print(f"Benchmark rate: {rate:.0f} addr/sec ({source})")
    print(f"Expected time: {format_duration(expected)} (CPU)")
    if not torch.cuda.is_available():
        print("Note: no CUDA card is visible; no device calibration.")
        return 0
    print("Calibrating on the card...", file=sys.stderr)
    stats = sc.benchmark_device(fmt, pattern_str, min_seconds=2.0,
                                warmup_batches=1,
                                ignore_case=args.ignore_case)
    drate = stats["keys_per_sec"]
    dexpected = difficulty / drate if drate > 0 else float("inf")
    print(f"Device rate: {drate:,.0f} keys/sec ({stats['device']})")
    print(f"Expected time: {format_duration(dexpected)} (device)")
    return 0


def cmd_list_devices(args) -> int:
    devices = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        devices.append({
            "id": i,
            "name": props.name,
            "capability": f"{props.major}.{props.minor}",
            "sm_count": props.multi_processor_count,
            "memory_bytes": props.total_memory,
        })
    if args.json:
        print(json.dumps(devices, indent=2))
        return 0
    print("Available devices:")
    if not devices:
        print("  (none)")
    for d in devices:
        print(f"  {d['id']}. {d['name']} (sm_{d['capability'].replace('.', '')}"
              f", {d['sm_count']} SMs, {d['memory_bytes'] / 2**30:.1f} GiB)")
    return 0


def run_from_args(argv: List[str]) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "generate":
        return cmd_generate(args)
    if args.command == "range":
        return cmd_range(args)
    if args.command == "estimate":
        return cmd_estimate(args)
    if args.command == "verify":
        return cmd_verify(args)
    return cmd_list_devices(args)


def main() -> None:  # pragma: no cover
    sys.exit(run_from_args(sys.argv[1:]))
