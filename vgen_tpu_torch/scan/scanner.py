"""Device scan loop: random and range scans, interval and DFA routes.

The counterpart of ``vgen_tpu/scan/scanner.py`` ``DeviceScanner`` for all
six address formats.  A pattern that compiles to intervals of the format's
value (a hash160, the P2SH-P2WPKH script hash, the Ethereum account, or the
P2TR output key's x: an anchored literal, or a selective literal prefix
whose survivors the host checks against the full regex) takes the interval
step; any other regex takes the DFA step.  Random scans of the hash formats
check six GLV keys per table position; P2TR checks one (the tweak rebinds
the key).  Range scans (``config.start`` set) check each key of
[start, end] once, report matches in key order, and keep a checkpoint when
``config.checkpoint`` is set.

The host computes one base point per window, keeps a few super-steps in
flight (each packed result is copied into pinned host memory behind a CUDA
event), and re-derives every reported key with the native code before it
counts as a match.  ``SuperStepScan`` holds that loop, which
``parallel/mesh.py`` ``MeshScanner`` shares; ``scan_with_progress`` takes
the mesh where ``ScanConfig.mesh`` or the auto rule says so.  A device
failure raises: nothing falls back to the CPU scanner.
"""

from __future__ import annotations

import secrets
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator, GeneratedAddress
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan.host import (
    ProgressCallback,
    ScanConfig,
    ScanResult,
    StopFlag,
    _derive_checked,
    _derive_checked_bulk,
    _scan_cpu,
)
from vgen_tpu_torch.ops import fused, pipeline, u256
from vgen_tpu_torch.scan import tables

DEFAULT_DEVICE_BATCH = 524_288
DEFAULT_K_SUB = 8
GLV_KEYS = fused.GLV_KEYS


class SuperStepScan:
    """The scan loop of ``DeviceScanner`` and ``parallel.mesh.MeshScanner``.

    One super-step covers ``self.windows`` consecutive windows of
    ``self.batch`` keys; window j covers keys base+1 .. base+B with base =
    next_key - 1 + j*B.  A subclass places the windows on its devices:
    ``_plan`` (the pattern's route and whether a device hit is a match of
    the full pattern), ``_submit`` (launch one super-step and start its
    (windows, 34) packed rows' copy to the host: ``_copy_to_host``),
    ``_window_indices`` (every match of one window, for overflow
    recovery), ``_random_start``, ``_checkpoint`` and ``_synchronize``.
    """

    fmt: AddressFormat
    batch: int
    windows: int

    def _scan(self, pattern: Pattern, config: ScanConfig,
              progress_callback: Optional[ProgressCallback],
              stop_flag: Optional[StopFlag], recover_overflow: bool,
              max_super_steps: Optional[int] = None) -> ScanResult:
        if config.format != self.fmt:
            raise ValueError(f"scanner built for {self.fmt.value}, config "
                             f"asks for {config.format.value}")
        is_range = config.start is not None
        # GLV variants only on random scans: a range scan reports keys
        # inside [start, end]
        glv = not is_range and self.fmt in pipeline.GLV_FORMATS
        mult = GLV_KEYS if glv else 1
        route, exact = self._plan(pattern, config, glv)
        B, W = self.batch, self.windows

        gen = AddressGenerator(self.fmt)
        matches: List[GeneratedAddress] = []
        total_ops = 0
        ckpt = None
        if is_range:
            next_key = max(config.start, 1)
            end_key = min(config.end if config.end is not None else ec.N - 1,
                          ec.N - 1)
            ckpt, state = self._checkpoint(config.checkpoint)
            if state is not None:
                next_key = max(next_key, state["next_key"])
                total_ops = state["operations"]
                for key in state["match_keys"]:
                    ga = _derive_checked(key, self.fmt, gen)
                    if ga is not None:
                        matches.append(ga)
        else:
            # one random start per scan, then consecutive windows
            next_key = self._random_start(ec.N - 3)
            end_key = None

        t0 = time.time()
        inflight = deque()
        stop = stop_flag or StopFlag()
        target = config.count if config.count > 0 else float("inf")
        steps = 0

        # a window covers keys base+1 .. base+B with base = next_key - 1, so
        # key 1 (base 0, the point at infinity) is checked on the host
        if is_range and next_key == 1:
            ga = gen.generate((1).to_bytes(32, "big"))
            total_ops += 1
            if ga is not None and pattern.matches(ga.address):
                matches.append(ga)
            next_key = 2

        def submit() -> bool:
            nonlocal next_key, steps
            if is_range and next_key > end_key:
                return False
            if max_super_steps is not None and steps >= max_super_steps:
                return False
            base_scalars = [next_key - 1 + j * B for j in range(W)]
            # None: every window full (random scans)
            rems = ([max(0, min(B, end_key - base)) for base in base_scalars]
                    if is_range else None)
            inflight.append((base_scalars, rems,
                             self._submit(route, base_scalars, rems)))
            steps += 1
            nk = next_key + B * W
            if not is_range and nk + B * (W + 1) >= ec.N:
                # wrap: restart uniformly over the key space, leaving
                # headroom for the next super-step
                nk = self._random_start(ec.N - 2 - B * (W + 1))
            next_key = nk
            return True

        def drain_one():
            nonlocal total_ops
            base_scalars, rems, handle = inflight.popleft()
            arr = _host_rows(handle)
            top_k = pipeline.TOP_K
            cand_keys: List[int] = []
            # device-confirmed indices so far in this super-step: each
            # derives to at least one real match when the route is exact
            guaranteed = 0
            for k, base_scalar in enumerate(base_scalars):
                count = int(arr[k, 0])
                total_ops += int(arr[k, 1])
                pairs = {
                    int(i): int(b)
                    for i, b in zip(arr[k, 2:2 + top_k],
                                    arr[k, 2 + top_k:2 + 2 * top_k])
                    if i >= 0
                }
                # the packed row holds TOP_K indices.  A range scan must
                # report every key, so it always fetches the full window;
                # a random scan only when the reported ones cannot reach a
                # finite requested count (otherwise fresh windows are
                # cheaper)
                if count > len(pairs) and recover_overflow and (
                        is_range or (
                            target != float("inf")
                            and len(matches) + len(cand_keys)
                            + len(pairs) * mult < target)):
                    pairs = self._window_indices(
                        route, base_scalar, rems[k] if is_range else B)
                # the device masks the doubling lane (key 2*base, where the
                # table point equals the base point; its ops are already in
                # the row's count): check that key here
                if 1 <= base_scalar <= B and (
                        not is_range or 2 * base_scalar <= end_key):
                    pairs.setdefault(base_scalar - 1, 0)  # 0: all variants
                # collect in key order while the confirmed ones cannot yet
                # reach the target (range scans report the lowest keys)
                if pairs and len(matches) + guaranteed < target:
                    for idx in sorted(pairs):
                        key0 = base_scalar + 1 + idx
                        cand_keys.extend(
                            ec.glv_bit_variant_keys(
                                key0, pairs[idx], parity_exact=(
                                    self.fmt in pipeline.GLV_EXACT_Y))
                            if glv else [key0])
                    if exact:
                        guaranteed += sum(1 for b in pairs.values() if b)
            for key, ga in _derive_checked_bulk(cand_keys, self.fmt, gen):
                if len(matches) >= target:
                    break
                if ga is not None and pattern.matches(ga.address):
                    matches.append(ga)
            if ckpt is not None:
                # keys up to the end of this super-step's last window are done
                ckpt.advance(min(base_scalars[-1] + B + 1, end_key + 1),
                             total_ops, [int(m.hex, 16) for m in matches])
            if progress_callback:
                progress_callback(total_ops)

        while not stop.is_set() and len(matches) < target:
            while len(inflight) < max(1, config.in_flight):
                if not submit():
                    break
            if not inflight:
                break  # range exhausted, or the super-step budget spent
            drain_one()
        # drain what is in flight: its matches still count
        while inflight and len(matches) < target:
            drain_one()
        self._synchronize()
        if ckpt is not None:
            ckpt.finalize()
        return ScanResult(
            matches=matches[:config.count if config.count > 0 else None],
            operations=total_ops,
            elapsed_secs=time.time() - t0,
        )


def _copy_to_host(packed: torch.Tensor):
    """(host rows, event): a CUDA tensor's copy into pinned host memory,
    behind an event recorded on the current stream; a CPU tensor as it is,
    with no event."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_rows(handle) -> np.ndarray:
    host, done = handle
    if done is not None:
        done.synchronize()
    return host.numpy()


class DeviceScanner(SuperStepScan):
    """The i*G table on one device, and the scan loop over it."""

    # expected prefilter survivors per window above which an unanchored
    # pattern is not worth the host regex check per survivor
    PREFILTER_MAX_SURVIVORS = 8.0

    def __init__(self, fmt: AddressFormat,
                 batch_size: int = DEFAULT_DEVICE_BATCH, device="cuda",
                 k_sub: int = DEFAULT_K_SUB):
        fused.check_format(fmt)
        self.fmt = fmt
        self.batch = batch_size
        self.device = torch.device(device)
        self.k_sub = self.windows = k_sub
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceScanner: no CUDA device is visible")
        # the i*G table and the P2TR ladder's window table, built once per
        # scanner: on a card by the table kernels, on the CPU from npz
        self.tx, self.ty = tables.ig_table(batch_size, self.device)
        self.wt = (tables.ladder_table(self.device)
                   if fmt == AddressFormat.P2TR else None)
        self._full_remaining = self._remaining([batch_size] * k_sub)

    def _plan_intervals(self, pattern: Pattern, config: ScanConfig):
        """Exact intervals for an anchored literal; else the longest-prefix
        over-approximation when its expected survivors per window (six keys
        per position on random GLV scans, one on range scans and on P2TR)
        stay within PREFILTER_MAX_SURVIVORS (the drain applies the full regex
        to survivors); else None, the DFA route."""
        ivs = pattern.match_intervals(self.fmt)
        if ivs is not None:
            return ivs
        pf = pattern.prefilter_intervals(self.fmt)
        if pf is None:
            return None
        pf_ivs, p = pf
        glv_mult = (GLV_KEYS if config.start is None
                    and self.fmt in pipeline.GLV_FORMATS else 1)
        if p * self.batch * glv_mult <= self.PREFILTER_MAX_SURVIVORS:
            return pf_ivs
        return None

    def _base_points(self, scalars: List[int]):
        """(bx, by) (K, 8) int32 of scalar * G on the device."""
        pts = [ec.scalar_mult_base_fast(s) for s in scalars]
        bx = u256.from_ints([p[0] for p in pts]).T
        by = u256.from_ints([p[1] for p in pts]).T
        return (u256.as_i32(bx).to(self.device, non_blocking=True),
                u256.as_i32(by).to(self.device, non_blocking=True))

    def _remaining(self, values: List[int]) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32).to(
            self.device, non_blocking=True)

    def _route(self, pattern: Pattern, config: ScanConfig, glv: bool):
        """(packed step, mask step, exact) for the pattern's route, each
        step taking (bx, by, remaining).  exact: a device hit is a match
        of the full pattern (False for prefilter intervals)."""
        dev = self.device
        ivs = self._plan_intervals(pattern, config)
        if ivs is not None:
            n_slots = pipeline.interval_slot_count(len(ivs))
            lo_np, hi_np = pipeline.intervals_to_words(
                ivs, n_words=pipeline.INTERVAL_WORDS[self.fmt],
                n_slots=n_slots)
            lo, hi = u256.as_i32(lo_np).to(dev), u256.as_i32(hi_np).to(dev)

            def step(bx, by, rem):
                return fused.fused_range_scan_step(
                    self.fmt, bx, by, self.tx, self.ty, lo, hi, rem, glv,
                    self.wt)

            def mask_step(bx, by, rem):
                return fused.fused_range_mask_step(
                    self.fmt, bx, by, self.tx, self.ty, lo, hi, rem, glv,
                    self.wt)

            return (step, mask_step,
                    pattern.exact_match_intervals(self.fmt) is not None)
        dfa = pattern.device_dfa(self.fmt)
        table = torch.from_numpy(dfa.table.astype(np.int32)).to(dev)
        accept = torch.from_numpy(dfa.accept.astype(np.int32)).to(dev)
        start = int(dfa.start)
        # the narrow table of kernel D (range scans of the hash formats)
        # or I (P2TR, which takes no GLV keys), once per pattern, where the
        # kernel takes the shared form; kernel E reads the int32 table
        narrow = (fused.narrow_dfa(table, accept)
                  if not glv and fused.dfa_form(*table.shape) == "shared"
                  else None)

        def step(bx, by, rem):
            return fused.fused_scan_step(self.fmt, bx, by, self.tx, self.ty,
                                         table, accept, start, rem, glv,
                                         self.wt, narrow)

        def mask_step(bx, by, rem):
            return fused.fused_scan_mask_step(
                self.fmt, bx, by, self.tx, self.ty, table, accept, start, rem,
                glv, self.wt, narrow)

        return step, mask_step, True

    def _plan(self, pattern: Pattern, config: ScanConfig, glv: bool):
        step, mask_step, exact = self._route(pattern, config, glv)
        return (step, mask_step), exact

    def _submit(self, route, base_scalars: List[int],
                rems: Optional[List[int]]):
        remaining = (self._full_remaining if rems is None
                     else self._remaining(rems))
        bx, by = self._base_points(base_scalars)
        return _copy_to_host(route[0](bx, by, remaining))

    def _window_indices(self, route, base_scalar: int, rem: int):
        """{index: mask} of every match in one window: the packed row holds
        only TOP_K indices."""
        bx, by = self._base_points([base_scalar])
        mask = route[1](bx, by, self._remaining([rem]))
        mask = mask[0].cpu().numpy()
        return {int(i): int(mask[i]) for i in np.nonzero(mask)[0]}

    def _random_start(self, n: int) -> int:
        return 2 + secrets.randbelow(n)

    def _checkpoint(self, ckpt):
        """(the checkpoint this scan writes, the state it resumes from)."""
        return ckpt, (ckpt.load() if ckpt is not None else None)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def scan(self, pattern: Pattern, config: ScanConfig,
             progress_callback: Optional[ProgressCallback] = None,
             stop_flag: Optional[StopFlag] = None,
             recover_overflow: bool = True) -> ScanResult:
        return self._scan(pattern, config, progress_callback, stop_flag,
                          recover_overflow)


# Scanners by (format, batch, device), and ("mesh", format, batch, device):
# each holds its tables, so repeated scans (``--repeat``, the calls of one
# process) build them once (vgen_tpu/scan/scanner.py
# ``_scanner_cache``)
_scanner_cache = {}


def _use_mesh(config: ScanConfig, device) -> bool:
    """``config.mesh``; auto (None) takes the mesh only on the card, and
    only when this process sees more than one card or torch.distributed
    spans more than one process (vgen_tpu/scan/scanner.py ``_use_mesh``)."""
    if config.mesh is not None:
        return config.mesh
    if torch.device(device).type != "cuda":
        return False
    from vgen_tpu_torch.parallel import distributed

    return torch.cuda.device_count() > 1 or distributed.world_size() > 1


def _scan_mesh(pattern: Pattern, config: ScanConfig,
               progress_callback: Optional[ProgressCallback],
               stop_flag: Optional[StopFlag], device) -> ScanResult:
    from vgen_tpu_torch.parallel.mesh import MeshScanner

    dev = torch.device(device)
    batch = config.device_batch_size or DEFAULT_DEVICE_BATCH
    key = ("mesh", config.format, batch, dev)
    if key not in _scanner_cache:
        # "cuda": every card of this process; else the one device named
        devices = None if dev == torch.device("cuda") else [dev]
        _scanner_cache[key] = MeshScanner(config.format, batch, devices)
    return _scanner_cache[key].scan(
        pattern, count=config.count, start=config.start, end=config.end,
        progress_callback=progress_callback, stop_flag=stop_flag,
        checkpoint=config.checkpoint, in_flight=max(1, config.in_flight))


def scan_with_progress(pattern: Pattern, config: ScanConfig,
                       progress_callback: Optional[ProgressCallback] = None,
                       stop_flag: Optional[StopFlag] = None,
                       device="cuda") -> ScanResult:
    """Scan on ``device`` ("cuda", or "cpu" for the plain versions), over
    the mesh of ``parallel/mesh.py`` where ``_use_mesh`` says so, or with
    the port's native CPU scanner when ``config.use_device`` is False."""
    if not config.use_device:
        return _scan_cpu(pattern, config, progress_callback, stop_flag)
    if _use_mesh(config, device):
        return _scan_mesh(pattern, config, progress_callback, stop_flag,
                          device)
    batch = config.device_batch_size or DEFAULT_DEVICE_BATCH
    key = (config.format, batch, torch.device(device))
    if key not in _scanner_cache:
        _scanner_cache[key] = DeviceScanner(config.format, batch, device)
    return _scanner_cache[key].scan(pattern, config, progress_callback,
                                    stop_flag)


def benchmark_device(fmt: AddressFormat = AddressFormat.P2PKH,
                     pattern_str: str = "^1BenchNeverMatches",
                     batch_size: int = DEFAULT_DEVICE_BATCH,
                     min_seconds: float = 5.0, warmup_batches: int = 2,
                     k_sub: int = DEFAULT_K_SUB, device="cuda",
                     ignore_case: bool = False) -> dict:
    """Timed random scan (table build and warm-up excluded) -> keys/s, on
    whatever route the pattern takes (interval or DFA).

    recover_overflow=False: count=10**9 is a never-stop sentinel, and
    recovering every overflowing window of an easy pattern would time the
    host, not the device."""
    pat = Pattern(pattern_str, ignore_case)
    cfg = ScanConfig(format=fmt, count=10**9, device_batch_size=batch_size)
    scanner = DeviceScanner(fmt, batch_size, device, k_sub)

    warm = StopFlag()

    def cb_warm(ops):
        if ops >= warmup_batches * batch_size:
            warm.set()

    scanner.scan(pat, cfg, cb_warm, warm, recover_overflow=False)

    timed = StopFlag()
    t0 = time.time()

    def cb_timed(ops):
        if time.time() - t0 >= min_seconds:
            timed.set()

    res = scanner.scan(pat, cfg, cb_timed, timed, recover_overflow=False)
    return {
        "keys_per_sec": res.rate(),
        "operations": res.operations,
        "elapsed": res.elapsed_secs,
        "batch_size": batch_size,
        "k_sub": scanner.k_sub,
        "format": fmt.value,
        "device": (torch.cuda.get_device_name(scanner.device)
                   if scanner.device.type == "cuda" else "cpu"),
    }
