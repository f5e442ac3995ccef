"""The port's CLI against the reference's behaviour: the charset warning,
the options ``list-gpus``, ``--profile``, ``generate --tui`` and the ``-i``
warning, the progress line's 0.5 s throttle, the ``--cpu-batch-size``
default, and one DeviceScanner per (format, batch, device) across scans.
Most cases replace the scan with a stub that reports progress, so they
test the CLI and not the kernels."""

import json
import shutil

import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch import cli
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan import tables
from vgen_tpu_torch.scan.host import ScanConfig, ScanResult

CPU_SCAN = ["--no-tui", "--backend", "cpu", "--device-batch-size", "256"]


class FakeClock:
    """time.time() stand-in: each call advances by ``step`` seconds."""

    def __init__(self, step):
        self.now, self.step = 1000.0, step

    def time(self):
        self.now += self.step
        return self.now


@pytest.fixture
def stub_scan(monkeypatch):
    """Replace the scan with one that calls progress 20 times (a small
    torch op each, so a profiler has something to record) and finds
    nothing; returns the configs it was called with."""
    calls = []

    def scan(pattern, config, progress_callback=None, stop_flag=None,
             device="cuda"):
        calls.append((config, device))
        for i in range(1, 21):
            torch.ones(8).sum()
            if progress_callback:
                progress_callback(1000 * i)
        return ScanResult(operations=20000, elapsed_secs=0.1)

    monkeypatch.setattr(sc, "scan_with_progress", scan)
    return calls


def test_charset_warning_prints_the_references_three_lines(capsys):
    """The call of tests/test_cli.py test_charset_warning, through the
    port's CLI and its native scanner."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) for the native scanner")
    rc = cli.run_from_args(
        ["range", "-p", "^1OO", "--range", "100:110", "--no-tui", "--no-gpu"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "NEVER match" in err
    assert "Base58 excludes" in err
    assert "Base58 alphabet excludes these characters" in err


def test_list_gpus_is_a_hidden_alias(capsys):
    assert cli.run_from_args(["list-gpus", "--json"]) == 0
    devices = json.loads(capsys.readouterr().out)
    assert len(devices) == torch.cuda.device_count()
    assert "list-gpus" not in cli.build_parser().format_help()


@pytest.mark.parametrize("argv,warning", [
    (["generate", "-p", "^1A", "--tui"], "--tui is deprecated"),
    (["generate", "-f", "p2wpkh", "-p", "^bc1qq", "-i"],
     "-i flag might be redundant"),
    (["generate", "-f", "ethereum", "-p", "^0xab", "-i"],
     "-i flag might be redundant"),
], ids=["tui", "i-p2wpkh", "i-ethereum"])
def test_generate_warnings(capsys, stub_scan, argv, warning):
    assert cli.run_from_args(argv + CPU_SCAN) == 0
    assert warning in capsys.readouterr().err


def test_no_i_warning_for_p2pkh(capsys, stub_scan):
    assert cli.run_from_args(["generate", "-p", "^1a", "-i"] + CPU_SCAN) == 0
    assert "-i flag" not in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["generate", "-p", "^1A"] + CPU_SCAN,
    ["range", "-p", "^1A", "--range", "1:FFFF"] + CPU_SCAN,
    ["generate", "-p", "^1A", "--no-tui", "--no-device"],
], ids=["generate-cpu-tensors", "range-cpu-tensors", "native"])
def test_profile_writes_a_chrome_trace(capsys, stub_scan, tmp_path, argv):
    out = tmp_path / "trace"
    assert cli.run_from_args(argv + ["--profile", str(out)]) == 0
    assert f"Profiler trace written to {out}" in capsys.readouterr().err
    traces = list(out.glob("vgen_tpu_torch_scan_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_profile_that_cannot_start_raises_its_own_error(stub_scan, tmp_path,
                                                        monkeypatch):
    """A profiler that fails on start (no CUPTI, say) surfaces its own
    error, the scan does not run, and no trace is written."""
    import torch.profiler

    def fail(self):
        raise RuntimeError("profiler cannot start")

    monkeypatch.setattr(torch.profiler.profile, "start", fail)
    out = tmp_path / "trace"
    with pytest.raises(RuntimeError, match="profiler cannot start"):
        cli.run_from_args(["generate", "-p", "^1A"] + CPU_SCAN
                          + ["--profile", str(out)])
    assert stub_scan == [] and not out.exists()


@pytest.mark.parametrize("step,lines", [(0.125, 4), (0.75, 20)],
                         ids=["0.125s-per-call", "0.75s-per-call"])
def test_progress_line_is_throttled(capsys, stub_scan, monkeypatch, step,
                                    lines):
    """20 progress calls on a clock that advances ``step`` seconds per
    reading: a line at most every 0.5 s (the first call prints)."""
    monkeypatch.setattr(cli, "time", FakeClock(step))
    assert cli.run_from_args(["generate", "-p", "^1A"] + CPU_SCAN) == 0
    err = capsys.readouterr().err
    assert err.count("\r[") == lines


def test_generate_cpu_batch_size_defaults_to_10000(stub_scan):
    assert cli.build_parser().parse_args(
        ["generate", "-p", "^1A"]).cpu_batch_size == 10000
    assert cli.run_from_args(["generate", "-p", "^1A", "--no-tui",
                              "--no-device", "-q"]) == 0
    (config, _), = stub_scan
    assert config.cpu_batch_size == 10000 and not config.use_device


def test_scan_with_progress_keeps_one_scanner(monkeypatch):
    """Two range scans on CPU tensors build one DeviceScanner (one i*G
    table); another batch size builds another."""
    monkeypatch.setattr(sc, "_scanner_cache", {}, raising=False)
    built = []
    ig_table = tables.ig_table

    def counting(count, device):
        built.append((count, str(device)))
        return ig_table(count, device)

    monkeypatch.setattr(tables, "ig_table", counting)
    pat = Pattern("^1BenchNeverMatches")
    for batch in (256, 256, 128):
        cfg = ScanConfig(format=AddressFormat.P2PKH, start=2, end=9,
                         count=0, device_batch_size=batch)
        res = sc.scan_with_progress(pat, cfg, device="cpu")
        assert res.operations == 8 and not res.matches
    assert built == [(256, "cpu"), (128, "cpu")]
    assert len(sc._scanner_cache) == 2
