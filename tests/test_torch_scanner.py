"""The port's scan loop and CLI on CPU tensors (the kernels' plain
versions), its host helpers against the JAX package's, and the rule that
the port never loads jax."""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu_torch import cli
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.ops import pipeline
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan.host import ScanConfig

B = 256
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _assert_oracle(matches, pat, fmt):
    gen = AddressGenerator(fmt)
    for m in matches:
        ga = gen.generate(bytes.fromhex(m.hex))
        assert ga.address == m.address and pat.matches(m.address)


@pytest.fixture(scope="module")
def p2pkh_scanner():
    return sc.DeviceScanner(AddressFormat.P2PKH, B, "cpu", k_sub=2)


def test_device_scanner_cpu_finds_verified_matches(p2pkh_scanner):
    pat = Pattern("^1C")
    cfg = ScanConfig(format=AddressFormat.P2PKH, count=2, in_flight=1)
    seen = []
    res = p2pkh_scanner.scan(pat, cfg, seen.append)
    assert len(res.matches) == 2
    _assert_oracle(res.matches, pat, AddressFormat.P2PKH)
    # one super-step is 2 windows x B positions x 6 GLV keys
    assert res.operations > 0 and res.operations % (2 * B * 6) == 0
    assert seen and seen[-1] == res.operations


def test_device_scanner_p2wpkh():
    pat = Pattern("^bc1qq")
    res = sc.scan_with_progress(
        pat, ScanConfig(format=AddressFormat.P2WPKH, count=1, in_flight=1,
                        device_batch_size=B), device="cpu")
    assert len(res.matches) == 1
    _assert_oracle(res.matches, pat, AddressFormat.P2WPKH)


def test_overflow_recovery_reports_all_window_matches(p2pkh_scanner,
                                                     monkeypatch):
    """^1 matches every key: each window overflows the 16 index slots
    (16 x 6 keys), and a count above them triggers the full-mask step."""
    from vgen_tpu_torch.ops import fused

    calls = []
    mask_step = fused.fused_range_mask_step

    def spy(*args):
        calls.append(args[1].shape[0])
        return mask_step(*args)

    monkeypatch.setattr(fused, "fused_range_mask_step", spy)
    pat = Pattern("^1")
    res = p2pkh_scanner.scan(
        pat, ScanConfig(format=AddressFormat.P2PKH, count=200, in_flight=1))
    assert calls and calls[0] == 1  # one window re-run at full width
    assert len(res.matches) == 200
    _assert_oracle(res.matches[:5], pat, AddressFormat.P2PKH)


def test_endless_scan_skips_overflow_recovery(p2pkh_scanner, monkeypatch):
    """count=0 (no limit): overflowing windows are not re-run."""
    from vgen_tpu_torch.ops import fused

    def fail(*args):
        raise AssertionError("recovery step called")

    monkeypatch.setattr(fused, "fused_range_mask_step", fail)
    stop = sc.StopFlag()
    res = p2pkh_scanner.scan(
        Pattern("^1"), ScanConfig(format=AddressFormat.P2PKH, count=0,
                                  in_flight=1),
        lambda ops: stop.set(), stop)
    assert len(res.matches) > 0


def test_stop_flag_ends_scan(p2pkh_scanner):
    stop = sc.StopFlag()
    res = p2pkh_scanner.scan(
        Pattern("^1ZZZZZZZZZZ"),
        ScanConfig(format=AddressFormat.P2PKH, count=1, in_flight=1),
        lambda ops: stop.set(), stop)
    assert res.matches == [] and res.operations == 2 * B * 6


@pytest.mark.parametrize("kind", ["range", "dfa"])
def test_range_and_dfa_paths_scan(p2pkh_scanner, kind):
    """The range route (interval step, kernel C's plain version) and the
    random DFA route (kernel E's): every match confirmed by the oracle."""
    if kind == "range":
        pat, cfg = Pattern("^1C"), ScanConfig(start=1, end=1000, count=0)
    else:
        pat, cfg = Pattern("q$"), ScanConfig(count=3, in_flight=1)
    res = p2pkh_scanner.scan(pat, cfg)
    _assert_oracle(res.matches, pat, AddressFormat.P2PKH)
    if kind == "range":
        gen = AddressGenerator(AddressFormat.P2PKH)
        want = [k for k in range(1, 1001)
                if pat.matches(gen.generate(k.to_bytes(32, "big")).address)]
        assert [int(m.hex, 16) for m in res.matches] == want
        assert res.operations == 1000
    else:
        assert len(res.matches) == 3


@pytest.mark.parametrize("fmt", [AddressFormat.ETHEREUM,
                                 AddressFormat.P2SH_P2WPKH,
                                 AddressFormat.P2PKH_UNCOMPRESSED])
def test_unported_formats_raise(fmt):
    """The formats ported last build a scanner; a name that is not an
    address format raises."""
    assert sc.DeviceScanner(fmt, B, "cpu").fmt == fmt
    with pytest.raises(ValueError, match="scan kernels cover"):
        sc.DeviceScanner(fmt.value, B, "cpu")


@pytest.mark.parametrize("n_ivs", [0, 1, 2, 3, 5, 8, 9])
def test_interval_helpers_equal_reference(n_ivs):
    assert pipeline.interval_slot_count(n_ivs) == \
        jpipeline.interval_slot_count(n_ivs)
    rng = np.random.default_rng(n_ivs)
    ivs = sorted((int.from_bytes(rng.bytes(20), "big"),
                  int.from_bytes(rng.bytes(20), "big")) for _ in range(min(n_ivs, 8)))
    slots = pipeline.interval_slot_count(len(ivs))
    for got, want in zip(pipeline.intervals_to_words(ivs, n_slots=slots),
                         jpipeline.intervals_to_words(ivs, n_slots=slots)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_constants_equal_reference():
    assert pipeline.TOP_K == jpipeline.TOP_K
    assert pipeline.PACKED_WIDTH == jpipeline.PACKED_WIDTH
    assert [f.value for f in pipeline.GLV_FORMATS] == \
        [f.value for f in jpipeline.GLV_FORMATS]
    assert pipeline.MAX_INTERVALS == jpipeline.MAX_INTERVALS
    assert [f.value for f in pipeline.GLV_EXACT_Y] == \
        [f.value for f in jpipeline.GLV_EXACT_Y]
    for name in ("FORMAT_DFA_WIDTH", "INTERVAL_WORDS"):
        assert ({f.value: v for f, v in getattr(pipeline, name).items()}
                == {f.value: v for f, v in getattr(jpipeline, name).items()})


def test_cli_generate_cpu_backend(capsys):
    rc = cli.run_from_args(["generate", "-p", "^1C", "--no-tui", "-c", "1",
                            "--backend", "cpu", "--device-batch-size",
                            str(B), "-o", "jsonl", "-q"])
    assert rc == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == 1 and rows[0]["address"].startswith("1C")
    gen = AddressGenerator(AddressFormat.P2PKH)
    assert gen.generate(bytes.fromhex(rows[0]["private_key_hex"])).address \
        == rows[0]["address"]


def test_cli_cuda_backend_without_card_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli.run_from_args(["generate", "-p", "^1C", "--no-tui"])
    assert exc.value.code == 2


def test_cli_verify(capsys):
    assert cli.run_from_args(["verify", "-k", "01" * 32]) == 0
    assert "P2PKH address:" in capsys.readouterr().out


def test_cli_list_devices_json(capsys):
    assert cli.run_from_args(["list-devices", "--json"]) == 0
    assert capsys.readouterr().out.strip().startswith("[")


def test_port_never_loads_jax():
    code = (
        "import sys\n"
        "import vgen_tpu_torch, vgen_tpu_torch.cli, vgen_tpu_torch.__main__\n"
        "import vgen_tpu_torch.scan.scanner, vgen_tpu_torch.ops.fused\n"
        "import vgen_tpu_torch.csrc.build\n"
        "print(sorted(m for m in sys.modules if re.match(r'jax(lib)?\\b', m)))\n"
    )
    out = subprocess.run([sys.executable, "-c", "import re\n" + code],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_port_sources_do_not_import_jax():
    files = list((ROOT / "vgen_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        assert not re.search(r"^\s*(import jax|from jax)", f.read_text(), re.M), f
