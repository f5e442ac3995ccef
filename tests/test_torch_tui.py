"""The port's terminal UI: tests/test_tui.py's four cases on the port's
``tui`` with the same fake screen, one scan on CPU tensors through
DeviceScanner's plain versions, the terminal's failure and the scan's, and
the CLI in a pseudo-terminal, where the TUI is the default."""

import curses
import os
import pathlib
import pty
import re
import select
import subprocess
import sys
import time

import pytest

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from test_tui import FakeScreen, fake_curses  # noqa: F401 (fixture)
from vgen_tpu_torch import cli, tui
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan.host import ScanConfig, StopFlag

ROOT = pathlib.Path(__file__).resolve().parents[1]
P2PKH = AddressFormat.P2PKH


def _native_config(batch):
    return ScanConfig(format=P2PKH, count=1, use_device=False,
                      cpu_batch_size=batch)


def test_tui_renders_stats_and_match(fake_curses):
    screen = fake_curses(FakeScreen())
    res = tui.run_tui(Pattern("^1"), _native_config(512), StopFlag())
    assert len(res.matches) == 1
    text = screen.text()
    for part in ("VGEN-TPU", "Pattern: ^1", "Hashrate:", "Search complete.",
                 "CPU search...", "MATCH #1", res.matches[0].address,
                 res.matches[0].wif):
        assert part in text


def test_tui_quit_key_stops_search(fake_curses):
    screen = fake_curses(FakeScreen(keys=[-1, ord("q")]))
    stop = StopFlag()
    res = tui.run_tui(Pattern("^1ZZZZZZZZZZZZZZ"), _native_config(256), stop)
    assert stop.is_set()
    assert res.matches == []
    assert "Q: quit" in screen.text()


def test_tui_luck_indicator(fake_curses):
    screen = fake_curses(FakeScreen())
    tui.run_tui(Pattern("^1"), _native_config(512), StopFlag())
    assert "Luck:" in screen.text()


def test_sparkline_shape():
    assert tui._sparkline([], 10) == ""
    s = tui._sparkline([0.0, 0.5, 1.0], 10)
    assert len(s) == 3
    assert s[-1] == "█"
    assert tui._sparkline([0.0, 0.0], 5) == "  "


def test_tui_device_scan_on_cpu_tensors(fake_curses):
    """``device="cpu"``: DeviceScanner on CPU tensors (the plain versions),
    a device batch of 256."""
    screen = fake_curses(FakeScreen())
    config = ScanConfig(format=P2PKH, count=1, device_batch_size=256)
    res = tui.run_tui(Pattern("^1"), config, StopFlag(), device="cpu")
    assert len(res.matches) == 1
    text = screen.text()
    assert "CPU (plain versions)" in text and "Search complete." in text
    assert f"MATCH #1  {res.matches[0].address}" in text


def test_terminal_failure_at_setup_starts_no_scan(fake_curses, monkeypatch):
    fake_curses(FakeScreen())

    def no_colors():
        raise curses.error("start_color() returned ERR")

    def scan(*args, **kwargs):
        raise AssertionError("the scan started")

    monkeypatch.setattr(tui.curses, "start_color", no_colors)
    monkeypatch.setattr(sc, "scan_with_progress", scan)
    with pytest.raises(curses.error):
        tui.run_tui(Pattern("^1"), _native_config(256), StopFlag())


def test_scan_error_is_raised_again(fake_curses, monkeypatch):
    screen = fake_curses(FakeScreen())

    def scan(*args, **kwargs):
        raise RuntimeError("the card is gone")

    monkeypatch.setattr(sc, "scan_with_progress", scan)
    with pytest.raises(RuntimeError, match="the card is gone"):
        tui.run_tui(Pattern("^1"), _native_config(256), StopFlag())
    assert "Error: the card is gone" in screen.text()


class _Terminal:
    """sys.stdout as a terminal: the CLI's test for the TUI."""

    def isatty(self):
        return True

    def write(self, s):
        return len(s)

    def flush(self):
        pass


def test_cli_scan_error_under_the_tui_propagates(fake_curses, monkeypatch):
    """A scan that raises in the TUI's worker ends the command with that
    error: no console rerun (the reference reruns on any exception)."""
    fake_curses(FakeScreen())
    calls = []

    def scan(*args, **kwargs):
        calls.append(args)
        raise RuntimeError("the card is gone")

    monkeypatch.setattr(sc, "scan_with_progress", scan)
    monkeypatch.setattr(sys, "stdout", _Terminal())
    with pytest.raises(RuntimeError, match="the card is gone"):
        cli.run_from_args(["generate", "-p", "^1", "--no-device", "-q"])
    assert len(calls) == 1


def test_cli_terminal_failure_falls_back_to_console(fake_curses, monkeypatch,
                                                    capsys):
    fake_curses(FakeScreen())

    def broken_terminal(f):
        raise curses.error("setupterm: could not find terminal")

    calls = []

    def scan(pattern, config, progress_callback=None, stop_flag=None,
             device="cuda"):
        calls.append(device)
        return sc.ScanResult(operations=7, elapsed_secs=0.1)

    monkeypatch.setattr(tui.curses, "wrapper", broken_terminal)
    monkeypatch.setattr(sc, "scan_with_progress", scan)
    monkeypatch.setattr(sys, "stdout", _Terminal())
    assert cli.run_from_args(["generate", "-p", "^1", "--no-device"]) == 0
    assert calls == ["cpu"]
    assert "TUI failed (setupterm" in capsys.readouterr().err


def _run_in_pty(argv, timeout=120):
    """The port's CLI with a pseudo-terminal as stdin, stdout and stderr
    (TERM=xterm) -> (exit code, everything it wrote)."""
    master, slave = pty.openpty()
    env = dict(os.environ, TERM="xterm", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-m", "vgen_tpu_torch", *argv],
                            stdin=slave, stdout=slave, stderr=slave,
                            cwd=ROOT, env=env, close_fds=True)
    os.close(slave)
    out = b""
    deadline = time.time() + timeout
    try:
        while time.time() < deadline:
            ready, _, _ = select.select([master], [], [], 0.5)
            if ready:
                try:
                    chunk = os.read(master, 65536)
                except OSError:  # the child closed the terminal
                    break
                if not chunk:
                    break
                out += chunk
            elif proc.poll() is not None:
                break
        rc = proc.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        proc.kill()
        os.close(master)
    return rc, out.decode(errors="replace")


def test_cli_generate_runs_the_tui_in_a_terminal():
    """``generate -p ^1 -c 1 --no-device`` without --no-tui, in a
    terminal: the TUI runs, the command exits 0 and prints the match once
    the screen has closed."""
    rc, out = _run_in_pty(["generate", "-p", "^1", "-c", "1", "--no-device"])
    assert rc == 0, out[-2000:]
    assert "VGEN-TPU-TORCH" in out
    tail = out[out.rindex("VGEN-TPU-TORCH"):]
    match = re.search(r"Address : (1\w+)", tail)
    assert match and "=== Match 1 of 1 ===" in tail, out[-2000:]


@pytest.mark.parametrize("argv", [["generate", "-p", "^1"],
                                  ["range", "-p", "^1", "-r", "1:FFFF"]],
                         ids=["generate", "range"])
def test_cli_repeat_under_the_tui_exits_2(argv):
    """As the reference's ``generate`` does; the port's ``range`` too,
    where the reference ran once."""
    rc, out = _run_in_pty([*argv, "--repeat", "2", "--no-device"])
    assert rc == 2
    assert "error: TUI mode supports a single run; use --no-tui" in out
