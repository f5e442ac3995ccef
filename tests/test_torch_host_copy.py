"""The port's own copies of the JAX package's host modules (the crypto
oracle, patterns and intervals, the native scanner, the CLI helpers)
against the originals, and the rule that the port imports nothing of
``vgen_tpu``: no source line imports it, and running the port's CLI loads
none of its modules.  Exact comparisons throughout."""

import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from vgen_tpu import cli as jcli
from vgen_tpu import native as jnative
from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.crypto.address import AddressGenerator as JAddressGenerator
from vgen_tpu.pattern import Pattern as JPattern
from vgen_tpu_torch import cli, native
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.pattern import Pattern

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORMATS = list(AddressFormat)
fmt_ids = pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.value)
PATTERNS = {
    AddressFormat.P2PKH: ["^1Cat", "q$", "(?i)^1lov", "^1[A-H]"],
    AddressFormat.P2WPKH: ["^bc1qq", "[ad][02-9]", "^bc1q[q-z]"],
    AddressFormat.P2TR: ["^bc1pqq", "qq$", "^bc1p[q-z]", "^bc1pq.*x$"],
}
PATTERN_CASES = [(f, src) for f, srcs in PATTERNS.items() for src in srcs]


def _keys(n=32):
    rng = np.random.default_rng(2026)
    keys = [int.from_bytes(rng.bytes(32), "big") for _ in range(n)]
    keys[:3] = [1, 2, 0xDEADBEEF]
    return keys


@fmt_ids
def test_address_generator_equals_original(fmt):
    """32 seeded keys: the port's oracle gives the original's address, WIF
    and hex in every format."""
    gen, jgen = AddressGenerator(fmt), JAddressGenerator(JAddressFormat(fmt.value))
    for k in _keys():
        secret = k.to_bytes(32, "big")
        got, want = gen.generate(secret), jgen.generate(secret)
        if want is None:
            assert got is None
            continue
        assert (got.address, got.wif, got.hex) == (want.address, want.wif,
                                                    want.hex)


@pytest.mark.parametrize("fmt,src", PATTERN_CASES,
                         ids=[f"{f.value}-{s}" for f, s in PATTERN_CASES])
def test_pattern_compilation_equals_original(fmt, src):
    """The device DFA tables, the exact intervals and the prefilter
    intervals of the port's Pattern equal the original's."""
    pat, jpat = Pattern(src), JPattern(src)
    jfmt = JAddressFormat(fmt.value)
    got, want = pat.device_dfa(fmt), jpat.device_dfa(jfmt)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.accept, want.accept)
    assert (got.start, got.n_digits) == (want.start, want.n_digits)
    assert pat.match_intervals(fmt) == jpat.match_intervals(jfmt)
    assert pat.prefilter_intervals(fmt) == jpat.prefilter_intervals(jfmt)
    assert pat.estimate_difficulty(fmt) == jpat.estimate_difficulty(jfmt)


@fmt_ids
def test_native_derive_addresses_equals_original(fmt):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) for the native code")
    keys = _keys()
    got = native.derive_addresses(keys, fmt.value)
    assert got is not None, native.build_error()
    assert got == jnative.derive_addresses(keys, fmt.value)
    assert native.pubkey_point(keys[5]) == jnative.pubkey_point(keys[5])
    assert pathlib.Path(native._cache_dir()).is_relative_to(ROOT / "build")


def test_resolve_range_params_equals_original():
    got = cli.resolve_range_params("boha:b1000:34", None, AddressFormat.P2PKH,
                                   None, None)
    want = jcli.resolve_range_params("boha:b1000:34", None,
                                     JAddressFormat.P2PKH, None, None)
    assert got[:3] == want[:3] and got[3].value == want[3].value
    assert cli.resolve_range_params(".", None, AddressFormat.P2TR,
                                    "2000:3FFF", None)[:2] == (0x2000, 0x3FFF)


IMPORT_OF_JAX_PACKAGE = re.compile(r"^\s*(from|import)\s+vgen_tpu(\.|\s|$)",
                                   re.M)


def test_port_sources_do_not_import_the_jax_package():
    files = sorted((ROOT / "vgen_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [str(f.relative_to(ROOT)) for f in files
           if IMPORT_OF_JAX_PACKAGE.search(f.read_text())]
    assert bad == []


def test_port_cli_loads_no_module_of_the_jax_package():
    """``verify`` on a hex key, then a CPU ``generate -f p2tr``: afterwards
    no module named vgen_tpu or vgen_tpu.* is loaded."""
    code = (
        "import re, sys\n"
        "from vgen_tpu_torch import cli\n"
        "assert cli.run_from_args(['verify', '-k', '01' * 32]) == 0\n"
        "assert cli.run_from_args(['generate', '-f', 'p2tr', '-p', 'q$',\n"
        "    '--no-tui', '--backend', 'cpu', '--device-batch-size', '256',\n"
        "    '-c', '1', '-o', 'jsonl', '-q']) == 0\n"
        "print(sorted(m for m in sys.modules\n"
        "             if re.match(r'vgen_tpu(\\.|$)', m)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT, timeout=600)
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    assert any(line.startswith('{"address": "bc1p') for line in lines)
