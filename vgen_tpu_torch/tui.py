"""Terminal UI: live hashrate, sparkline, luck indicator, match list.

The counterpart of ``vgen_tpu/tui.py`` (a curses port of the reference's
ratatui TUI, lib.rs:1099-1556):
  * top bar: pattern / format / difficulty / the device scanned on
  * stats: status, hashrate (green above 500K, yellow above 100K keys/s,
    lib.rs:1348-1354), checked count, elapsed, luck = ops / difficulty
    (lib.rs:1391-1423)
  * 100-point rate sparkline (lib.rs:1442-1446)
  * found matches with WIF
  * q / Esc quits (stop flag -> graceful shutdown)

The scan runs in a worker thread that updates a shared state, as the
reference's search thread does (lib.rs:1149-1226).  The thread starts once
the screen is set up, so a terminal that fails there leaves no scan
behind.  An exception of the scan ends the UI and is raised again by
``run_tui``; a curses error (the terminal's) stops the scan first and is
raised as it is.
"""

from __future__ import annotations

import curses
import threading
import time
from dataclasses import dataclass, field
from typing import List

import torch

from vgen_tpu_torch.output import format_duration, format_with_commas
from vgen_tpu_torch.scan.host import ScanResult

_SPARK_CHARS = " ▁▂▃▄▅▆▇█"
_TITLE = " VGEN-TPU-TORCH "


@dataclass
class TuiState:
    pattern: str = ""
    format: str = ""
    difficulty: int = 0
    operations: int = 0
    elapsed: float = 0.0
    rate: float = 0.0
    matches: List = field(default_factory=list)
    done: bool = False
    device_enabled: bool = True
    status: str = "Initializing..."
    device_name: str = ""


def _sparkline(values: List[float], width: int) -> str:
    if not values:
        return ""
    vals = values[-width:]
    hi = max(vals) or 1.0
    return "".join(
        _SPARK_CHARS[min(8, int(v / hi * 8))] for v in vals
    )


def run_tui(pattern, config, stop_flag, device="cuda") -> ScanResult:
    """Run the search under a curses UI -> its ScanResult.  ``device`` is
    scan_with_progress's: "cuda", or "cpu" for the plain versions."""
    from vgen_tpu_torch.scan import scanner as sc

    on_card = config.use_device and torch.device(device).type == "cuda"
    state = TuiState(
        pattern=pattern.original,
        format=config.format.display_name,
        difficulty=(
            0 if config.start is not None
            else pattern.estimate_difficulty(config.format)
        ),
        device_enabled=config.use_device,
        device_name=(torch.cuda.get_device_name(torch.device(device))
                     if on_card else "CPU"),
    )
    lock = threading.Lock()
    result_holder = {}
    t0 = time.time()

    def progress(ops: int):
        with lock:
            state.operations = ops
            state.elapsed = time.time() - t0
            state.rate = ops / state.elapsed if state.elapsed > 0 else 0.0

    def worker():
        try:
            with lock:
                state.status = "Device search..." if on_card else "CPU search..."
            res = sc.scan_with_progress(pattern, config, progress, stop_flag,
                                        device=device)
            result_holder["result"] = res
            with lock:
                state.matches = list(res.matches)
                state.operations = res.operations
                state.elapsed = res.elapsed_secs
                state.rate = res.rate()
                state.done = True
                state.status = "Search complete."
        except Exception as e:  # raised again by run_tui
            result_holder["error"] = e
            with lock:
                state.done = True
                state.status = f"Error: {e}"

    thread = threading.Thread(target=worker, daemon=True)
    rate_history: List[float] = []

    def ui(stdscr):
        curses.curs_set(0)
        stdscr.nodelay(True)
        curses.start_color()
        curses.use_default_colors()
        curses.init_pair(1, curses.COLOR_GREEN, -1)
        curses.init_pair(2, curses.COLOR_YELLOW, -1)
        curses.init_pair(3, curses.COLOR_RED, -1)
        curses.init_pair(4, curses.COLOR_CYAN, -1)
        curses.init_pair(5, curses.COLOR_MAGENTA, -1)
        thread.start()

        while True:
            with lock:
                snap_rate = state.rate
                snap_ops = state.operations
                snap_elapsed = state.elapsed
                snap_matches = list(state.matches)
                snap_done = state.done
                snap_status = state.status
            rate_history.append(snap_rate)
            if len(rate_history) > 100:
                rate_history.pop(0)

            stdscr.erase()
            h, w = stdscr.getmaxyx()

            def put(y, x, s, attr=0):
                if 0 <= y < h and x < w - 1:
                    stdscr.addnstr(y, x, s, w - x - 1, attr)

            put(0, 1, _TITLE, curses.color_pair(5) | curses.A_BOLD)
            put(
                0, len(_TITLE) + 3,
                f"Pattern: {state.pattern}  │  Format: {state.format}  │  "
                f"Difficulty: 1 in {format_with_commas(state.difficulty)}  │  "
                + (f"CUDA: {state.device_name}" if on_card
                   else "CPU (plain versions)" if state.device_enabled
                   else "CPU"),
                curses.color_pair(4),
            )
            put(2, 2, f"Status:   {snap_status}", curses.A_BOLD)
            rate_attr = curses.color_pair(
                1 if snap_rate > 500_000 else 2 if snap_rate > 100_000 else 3
            )
            put(3, 2, f"Hashrate: {snap_rate:,.0f} keys/s", rate_attr)
            put(4, 2, f"Checked:  {format_with_commas(snap_ops)}")
            put(5, 2, f"Elapsed:  {format_duration(snap_elapsed)}")
            if state.difficulty > 0 and snap_ops > 0:
                factor = snap_ops / state.difficulty
                if factor < 1.0:
                    luck = f"Lucky ({1.0 / max(factor, 1e-4):.1f}x faster)"
                    luck_attr = curses.color_pair(1)
                else:
                    luck = f"Unlucky ({factor:.1f}x slower)"
                    luck_attr = curses.color_pair(3 if factor > 3 else 2)
                put(6, 2, f"Luck:     {luck}", luck_attr)

            put(8, 2, _sparkline(rate_history, w - 4), curses.color_pair(5))

            put(10, 2, "Found Matches:", curses.A_BOLD)
            if not snap_matches:
                put(11, 4, "Waiting for matches...", curses.A_DIM)
            for i, m in enumerate(snap_matches[: max(0, (h - 13) // 2)]):
                put(11 + 2 * i, 4, f"MATCH #{i + 1}  {m.address}",
                    curses.color_pair(1) | curses.A_BOLD)
                put(12 + 2 * i, 8, f"WIF: {m.wif}")

            put(h - 1, 2, "Q: quit", curses.A_DIM)
            stdscr.refresh()

            try:
                ch = stdscr.getch()
            except curses.error:
                ch = -1
            if ch in (ord("q"), ord("Q"), 27):
                stop_flag.set()
                if snap_done:
                    break
                # wait for the worker to notice, keep drawing
            if snap_done and (stop_flag.is_set() or not thread.is_alive()):
                break
            time.sleep(0.1)

    try:
        curses.wrapper(ui)
    except curses.error:
        # the terminal failed: stop a scan that started before raising
        if thread.is_alive():
            stop_flag.set()
            thread.join()
        raise
    thread.join(timeout=60)
    if "error" in result_holder:
        raise result_holder["error"]
    return result_holder.get(
        "result",
        ScanResult(matches=[], operations=state.operations,
                   elapsed_secs=state.elapsed),
    )
