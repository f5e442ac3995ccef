"""The port's address symbols (``vgen_tpu_torch/ops/encode.py``, the plain
versions of ``csrc/encode.cuh``) against the JAX reference's encoders,
called eagerly on CPU: ``base58check_checksum_word``,
``base58check_symbols_words`` and ``segwit_symbols``; and against the host
encoders of ``vgen_tpu.crypto.encode`` through the alphabets.  Exact: the
symbols are integers.  Inputs: 256 hash160s from a numpy seed, with
leading zero bytes forced into some."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgen_tpu.crypto import encode as henc
from vgen_tpu.ops import encode as jencode
from vgen_tpu.pattern.pattern import DIGITS_BASE58, DIGITS_BECH32
from vgen_tpu_torch.ops import encode

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 256


@pytest.fixture(scope="module")
def hashes():
    rng = np.random.default_rng(20261016)
    hs = [rng.bytes(20) for _ in range(N)]
    for j in range(12):  # 1..12 leading zero bytes, then an all-zero hash
        hs[j] = b"\0" * (j + 1) + hs[j][j + 1:]
    hs[12] = b"\0" * 20
    words = np.array([[int.from_bytes(h[4 * i:4 * i + 4], "big")
                       for h in hs] for i in range(5)], dtype=np.uint32)
    return hs, words


def _port_words(words):
    return [torch.from_numpy(words[i].astype(np.int64)) for i in range(5)]


def _jax_words(words):
    return [jnp.asarray(words[i]) for i in range(5)]


def test_checksum_word_equals_reference(hashes):
    _, words = hashes
    got = encode.base58check_checksum_word(0, _port_words(words))
    want = np.asarray(jencode.base58check_checksum_word(0, _jax_words(words)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_base58check_symbols_equal_reference(hashes):
    """Symbols (all 34 rows, the zero padding after ``length`` included)
    and lengths equal the reference's, bit for bit."""
    _, words = hashes
    syms, length = encode.base58check_symbols(0, _port_words(words))
    jsyms, jlength = jencode.base58check_symbols_words(0, _jax_words(words))
    assert syms.shape == (34, N)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jsyms))
    np.testing.assert_array_equal(length.numpy(), np.asarray(jlength))
    assert {33, 34} <= set(length.tolist())
    assert min(length.tolist()) < 33  # the forced leading zero bytes


def test_base58check_symbols_equal_host_encoder(hashes):
    hs, words = hashes
    syms, length = encode.base58check_symbols(0, _port_words(words))
    for j, h in enumerate(hs):
        got = "".join(DIGITS_BASE58[int(syms[i, j])]
                      for i in range(int(length[j])))
        assert got == henc.base58check_encode(b"\0" + h), j


def test_bech32_symbols_equal_reference(hashes):
    hs, words = hashes
    syms, length = encode.bech32_p2wpkh_symbols(_port_words(words))
    prog = jnp.asarray(np.frombuffer(b"".join(hs), dtype=np.uint8)
                       .reshape(N, 20).T.astype(np.uint32))
    jsyms, jlength = jencode.segwit_symbols(prog, 0)
    assert syms.shape == (39, N)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jsyms))
    np.testing.assert_array_equal(length.numpy(), np.asarray(jlength))


def test_bech32_symbols_equal_host_encoder(hashes):
    hs, words = hashes
    syms, _ = encode.bech32_p2wpkh_symbols(_port_words(words))
    for j, h in enumerate(hs):
        got = "bc1" + "".join(DIGITS_BECH32[int(syms[i, j])]
                              for i in range(39))
        assert got == henc.segwit_addr_encode("bc", 0, h), j


def test_bech32_init_constant_equals_reference_and_header():
    """The polymod state after "bc" and witness version 0: the port's host
    value, the reference's, and the constant in csrc/encode.cuh agree."""
    assert encode.BECH32_INIT_BC_V0 == jencode._polymod_init("bc", 0)
    src = (ROOT / "vgen_tpu_torch" / "csrc" / "encode.cuh").read_text()
    m = re.search(r"kBech32InitBcV0 = (0x[0-9A-Fa-f]+)u;", src)
    assert m and int(m.group(1), 16) == encode.BECH32_INIT_BC_V0
