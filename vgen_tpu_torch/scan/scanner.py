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

A pattern's route on a card is one ``_Route``, which owns its CUDA graph.
``DeviceScanner._rows`` runs a card's windows of a super-step: the first
takes one base point per window from the host, every later one moves them
on by kernel J on the card and replays the route's kernels and pack tail
as one graph over the same static inputs.  The loop keeps a few
super-steps in flight (each packed result is copied into pinned host
memory behind a CUDA event), and re-derives every reported key with the
native code before it counts as a match.  ``SuperStepScan`` holds that
loop, which ``parallel/mesh.py`` ``MeshScanner`` shares, each of its
devices through its own ``_rows``; ``scan_with_progress`` takes the mesh
where ``ScanConfig.mesh`` or the auto rule says so.  A device failure
raises: nothing falls back to the CPU scanner.
"""

from __future__ import annotations

import hashlib
import secrets
import time
from collections import OrderedDict, deque
from typing import List, Optional

import numpy as np
import torch

from vgen_tpu_torch import tracing
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator, GeneratedAddress
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan.host import (
    ProgressCallback,
    ScanConfig,
    ScanResult,
    StopFlag,
    _derive_checked_bulk,
    _scan_cpu,
)
from vgen_tpu_torch.ops import fused, pipeline, u256
from vgen_tpu_torch.scan import tables

DEFAULT_DEVICE_BATCH = 524_288
DEFAULT_K_SUB = 8
GLV_KEYS = fused.GLV_KEYS
# super-steps of base points one launch of kernel J computes ahead: a
# lane's inversion chain takes about 0.1 ms on an H100, so one launch a
# super-step would add that to each (PERF.md)
ADVANCE_AHEAD = 16
# routes (with their graphs) and strides D (with their points (m + 1) D G)
# a scanner keeps; the least recently used goes first
ROUTE_CACHE = 4
Q_CACHE = 4


def _keep(cache: OrderedDict, key, value, size: int):
    """Put ``value`` last in the LRU ``cache``, dropping the oldest beyond
    ``size``; -> value."""
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > size:
        cache.popitem(last=False)
    return value


class SuperStepScan:
    """The scan loop of ``DeviceScanner`` and ``parallel.mesh.MeshScanner``.

    One super-step covers ``self.windows`` consecutive windows of
    ``self.batch`` keys; window j covers keys base+1 .. base+B with base =
    next_key - 1 + j*B.  A subclass places the windows on its devices:
    ``_plan`` (the pattern's route, whose ``kind`` names it and whose
    ``exact`` says whether a device hit is a match of the full pattern),
    ``_submit`` (launch one super-step and start its (windows, 34) packed
    rows' copy to the host: ``_copy_to_host``), ``_window_indices`` (every
    match of one window, for overflow recovery), ``_random_start``,
    ``_checkpoint`` and ``_synchronize``.
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
        with tracing.stage("start.route"):
            route = self._plan(pattern, config, glv)
        B, W = self.batch, self.windows
        # the keys each super-step counted, by format and by the route
        # (the kernel instance) that checked them
        keys_counter = f"keys.{self.fmt.value}.{route.kind}"

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
                matches.extend(ga for _, ga in _derive_checked_bulk(
                    state["match_keys"], self.fmt, gen) if ga is not None)
        else:
            # one random start per scan, then consecutive windows
            next_key = self._random_start(ec.N - 3)
            end_key = None

        t0 = time.time()
        inflight = deque()
        stop = stop_flag or StopFlag()
        target = config.count if config.count > 0 else float("inf")
        steps = 0
        # a process's first super-step, from its submit to its rows
        first_step = tracing.stage("start.first_step")

        # a window covers keys base+1 .. base+B with base = next_key - 1, so
        # key 1 (base 0, the point at infinity) is checked on the host
        if is_range and next_key == 1:
            ga = gen.generate((1).to_bytes(32, "big"))
            total_ops += 1
            if ga is not None and pattern.matches(ga.address):
                matches.append(ga)
            next_key = 2
        if ckpt is not None:
            # each drain appends its own matches to these: the resumed ones
            # that still derive, and key 1's
            ckpt.set_matches([int(m.hex, 16) for m in matches])

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
            first_step.begin()
            with tracing.span("vgen.submit") as traced:
                n0 = fused.launch_count() if traced else 0
                handle = self._submit(route, base_scalars, rems)
                if traced:
                    tracing.count("launches", fused.launch_count() - n0)
            inflight.append((base_scalars, rems, handle))
            steps += 1
            nk = next_key + B * W
            if not is_range and nk + B * (W + 1) >= ec.N:
                # wrap: restart uniformly over the key space, leaving
                # headroom for the next super-step
                nk = self._random_start(ec.N - 2 - B * (W + 1))
            next_key = nk
            return True

        def drain_one():
            with tracing.span("vgen.drain"):
                _drain_one()
            if progress_callback:
                progress_callback(total_ops)

        def _drain_one():
            nonlocal total_ops
            base_scalars, rems, handle = inflight.popleft()
            arr = _host_rows(handle)
            first_step.end()
            tracing.count("super_steps")
            top_k = pipeline.TOP_K
            cand_keys: List[int] = []
            # device-confirmed indices so far in this super-step: each
            # derives to at least one real match when the route is exact
            guaranteed = 0
            ops0 = total_ops
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
                    with tracing.span("vgen.drain.recover"):
                        pairs = self._window_indices(
                            route, base_scalar, rems[k] if is_range else B)
                    tracing.count("overflow_recoveries")
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
                    if route.exact:
                        guaranteed += sum(1 for b in pairs.values() if b)
            tracing.count(keys_counter, total_ops - ops0)
            n_matches = len(matches)
            with tracing.span("vgen.drain.derive"):
                for key, ga in _derive_checked_bulk(cand_keys, self.fmt, gen):
                    if len(matches) >= target:
                        break
                    if ga is not None and pattern.matches(ga.address):
                        matches.append(ga)
            tracing.count("candidates", len(cand_keys))
            tracing.count("matches", len(matches) - n_matches)
            if ckpt is not None:
                # keys up to the end of this super-step's last window are done
                with tracing.span("vgen.drain.checkpoint"):
                    ckpt.advance(min(base_scalars[-1] + B + 1, end_key + 1),
                                 total_ops,
                                 [int(m.hex, 16) for m in matches[n_matches:]])

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


def _affine_limbs(points):
    """Affine points -> (x, y) (len, 8) int32."""
    return (u256.as_i32(u256.from_ints([p[0] for p in points]).T),
            u256.as_i32(u256.from_ints([p[1] for p in points]).T))


class _Route:
    """A pattern's route on one scanner's device: its packed ``step`` and
    ``mask_step`` (overflow recovery), each taking (bx, by, remaining); its
    ``kind``: "intervals" (exact), "prefilter" (intervals whose hits the
    host checks against the full pattern) or "dfa"; and ``exact``: a device
    hit is a match of the full pattern (False for the prefilter).
    ``rows`` runs the step eagerly once over the scanner's static inputs
    (the same tensors at every call), then on a card captures it as a CUDA
    graph that later calls replay into one output; on the CPU each call
    runs it again.  The capture runs nothing, so each replay adds to
    ``fused``'s launch counters what it counted."""

    def __init__(self, step, mask_step, kind: str):
        self.step, self.mask_step, self.kind = step, mask_step, kind
        self.exact = kind != "prefilter"
        self.graph = None
        self._first = True

    def rows(self, bx, by, rem) -> torch.Tensor:
        if self._first:
            out = self.step(bx, by, rem)
            if bx.device.type == "cuda":
                self._capture(bx, by, rem)
            self._first = False
            return out
        tracing.count("graph_replays")
        if self.graph is None:
            return self.step(bx, by, rem)
        with torch.cuda.device(self.out.device):
            self.graph.replay()
        fused.add_launches(self.launches)
        return self.out

    def _capture(self, bx, by, rem) -> None:
        before = fused.launch_counters()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(bx.device), torch.cuda.graph(
                graph, capture_error_mode="relaxed"):
            self.out = self.step(bx, by, rem)
        after = fused.launch_counters()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        fused.add_launches({k: -n for k, n in self.launches.items()})
        self.graph = graph


def _host_rows(handle) -> np.ndarray:
    host, done = handle
    with tracing.span("vgen.drain.wait"):
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
        with tracing.stage("start.tables"):
            self.tx, self.ty = tables.ig_table(batch_size, self.device)
            self.wt = None
            if fmt == AddressFormat.P2TR:
                # the ladder table's build as a stage of its own: on a card
                # it starts once the i*G table is built and ends once it is
                self._synchronize()
                with tracing.stage("start.tables.ladder"):
                    self.wt = tables.ladder_table(self.device)
                    self._synchronize()
        self._full_remaining = self._remaining([batch_size] * k_sub)
        # the static inputs of the routes' graphs: the windows' base points
        # (x, y) and their remaining keys
        self._bxy = torch.zeros((2, k_sub, 8), dtype=torch.int32,
                                device=self.device)
        self._bx, self._by = self._bxy
        self._rem = self._full_remaining.clone()
        self._rem_full = True
        # kernel J's output: the bases of the next ADVANCE_AHEAD super-steps
        self._ahead = torch.zeros((ADVANCE_AHEAD, 2, k_sub, 8),
                                  dtype=torch.int32, device=self.device)
        self._q = OrderedDict()       # D -> (m + 1) D G, (ADVANCE_AHEAD, 2, 8)
        self._routes = OrderedDict()  # what a route checks -> its _Route
        self._forget()

    def _forget(self) -> None:
        """Seed the next super-step's bases on the host: _held, the scalars
        whose points _bx, _by hold once the work queued so far has run;
        _d, the stride of their last advance on the card; _ahead_next, the
        row of _ahead that follows them at that stride (ADVANCE_AHEAD:
        none)."""
        self._held = self._d = None
        self._ahead_next = ADVANCE_AHEAD

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

    @staticmethod
    def _host_limbs(scalars: List[int]):
        """(bx, by) (len, 8) int32 of scalar * G on the host (native)."""
        return _affine_limbs([ec.scalar_mult_base_fast(s) for s in scalars])

    def _base_points(self, scalars: List[int]):
        """(bx, by) (K, 8) int32 of scalar * G on the device.

        A call of ``self.windows`` scalars returns the routes' static
        inputs.  Where each scalar is the one they hold plus one D, D is
        the stride of their last advance (any D after a host seed) and not
        0 mod n, the card supplies them: kernel J computes the next
        ADVANCE_AHEAD super-steps' bases at once (from the native (m + 1) D
        G, cached per D), and each super-step copies its row.  Else, or
        where a lane of J would meet the doubling or the point at infinity
        (a held k = 0 or +-(m + 1) D mod n), the host computes them into
        the buffers: a scan's first super-step, a random scan's wrap, a
        jump.  A call of another length (overflow recovery) gets fresh
        tensors from the host and leaves the buffers alone."""
        with tracing.span("vgen.submit.base_points"):
            if len(scalars) != self.windows:
                bx, by = self._host_limbs(scalars)
                return (bx.to(self.device, non_blocking=True),
                        by.to(self.device, non_blocking=True))
            d = self._stride(scalars)
            if d is None:
                bx, by = self._host_limbs(scalars)
                self._bx.copy_(bx, non_blocking=True)
                self._by.copy_(by, non_blocking=True)
                self._ahead_next = ADVANCE_AHEAD
                tracing.count("base_points_host")
            else:
                if self._ahead_next == ADVANCE_AHEAD:
                    fused.base_advance(self._bx, self._by,
                                       self._q_points(d % ec.N), self._ahead)
                    self._ahead_next = 0
                self._bxy.copy_(self._ahead[self._ahead_next],
                                non_blocking=True)
                self._ahead_next += 1
                tracing.count("base_points_card")
            self._held, self._d = list(scalars), d
            return self._bx, self._by

    def _stride(self, scalars: List[int]) -> Optional[int]:
        """The D of ``_base_points``' bases from the card, or None."""
        held = self._held
        if held is None:
            return None
        d = scalars[0] - held[0]
        if (d % ec.N == 0 or self._d not in (None, d)
                or any(s - h != d for s, h in zip(scalars, held))):
            return None
        if self._ahead_next < ADVANCE_AHEAD:
            return d  # J's lanes were checked when it computed them
        bad = {m * d % ec.N for m in range(-ADVANCE_AHEAD, ADVANCE_AHEAD + 1)}
        return None if any(h % ec.N in bad for h in held) else d

    def _q_points(self, d: int) -> torch.Tensor:
        """(m + 1) d G for m < ADVANCE_AHEAD as (ADVANCE_AHEAD, 2, 8) int32
        (x, then y) on the device, cached."""
        q = self._q.get(d)
        if q is None:
            pts = [ec.scalar_mult_base_fast((m + 1) * d)
                   for m in range(ADVANCE_AHEAD)]
            q = torch.stack(_affine_limbs(pts), dim=1).to(
                self.device, non_blocking=True)
        return _keep(self._q, d, q, Q_CACHE)

    def _remaining(self, values: List[int]) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32).to(
            self.device, non_blocking=True)

    def _plan(self, pattern: Pattern, config: ScanConfig,
              glv: bool) -> _Route:
        """The pattern's ``_Route``, kept (with its graph) by what it checks:
        the intervals or the DFA, glv, exact.  A new route starts its scan's
        bases from the host."""
        self._forget()
        ivs = self._plan_intervals(pattern, config)
        if ivs is not None:
            n_slots = pipeline.interval_slot_count(len(ivs))
            lo_np, hi_np = pipeline.intervals_to_words(
                ivs, n_words=pipeline.INTERVAL_WORDS[self.fmt],
                n_slots=n_slots)
            exact = pattern.exact_match_intervals(self.fmt) is not None
            key = ("intervals", glv, exact, lo_np.tobytes(), hi_np.tobytes())
            route = self._routes.get(key) or self._interval_route(
                lo_np, hi_np, glv, exact)
            return _keep(self._routes, key, route, ROUTE_CACHE)
        dfa = pattern.device_dfa(self.fmt)
        table_np = dfa.table.astype(np.int32)
        accept_np = dfa.accept.astype(np.int32)
        key = ("dfa", glv, table_np.shape, int(dfa.start), hashlib.sha256(
            table_np.tobytes() + accept_np.tobytes()).hexdigest())
        route = self._routes.get(key) or self._dfa_route(
            table_np, accept_np, int(dfa.start), glv)
        return _keep(self._routes, key, route, ROUTE_CACHE)

    def _interval_route(self, lo_np, hi_np, glv: bool, exact: bool):
        dev = self.device
        lo, hi = u256.as_i32(lo_np).to(dev), u256.as_i32(hi_np).to(dev)

        def step(bx, by, rem):
            return fused.fused_range_scan_step(
                self.fmt, bx, by, self.tx, self.ty, lo, hi, rem, glv, self.wt)

        def mask_step(bx, by, rem):
            return fused.fused_range_mask_step(
                self.fmt, bx, by, self.tx, self.ty, lo, hi, rem, glv, self.wt)

        return _Route(step, mask_step, "intervals" if exact else "prefilter")

    def _dfa_route(self, table_np, accept_np, start: int, glv: bool):
        dev = self.device
        table = torch.from_numpy(table_np).to(dev)
        accept = torch.from_numpy(accept_np).to(dev)
        narrow = fused.step_narrow(self.fmt, glv, table, accept)

        def step(bx, by, rem):
            return fused.fused_scan_step(self.fmt, bx, by, self.tx, self.ty,
                                         table, accept, start, rem, glv,
                                         self.wt, narrow)

        def mask_step(bx, by, rem):
            return fused.fused_scan_mask_step(
                self.fmt, bx, by, self.tx, self.ty, table, accept, start, rem,
                glv, self.wt, narrow)

        return _Route(step, mask_step, "dfa")

    def _rows(self, route: _Route, base_scalars: List[int],
              rems: Optional[List[int]]) -> torch.Tensor:
        """One super-step's (windows, 34) packed rows on the device: the
        static inputs fed (``_base_points``; the remaining keys copied only
        where they differ, rems None: all full), then ``route.rows``."""
        bx, by = self._base_points(base_scalars)
        full = rems is None or all(r == self.batch for r in rems)
        if not (full and self._rem_full):
            self._rem.copy_(self._full_remaining if full
                            else self._remaining(rems), non_blocking=True)
        self._rem_full = full
        return route.rows(bx, by, self._rem)

    def _submit(self, route: _Route, base_scalars: List[int],
                rems: Optional[List[int]]):
        return _copy_to_host(self._rows(route, base_scalars, rems))

    def _window_indices(self, route: _Route, base_scalar: int, rem: int):
        """{index: mask} of every match in one window: the packed row holds
        only TOP_K indices."""
        bx, by = self._base_points([base_scalar])
        mask = route.mask_step(bx, by, self._remaining([rem]))
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
