"""The port's DFA walk (``pipeline.dfa_walk`` / ``dfa_matches``, the plain
versions of ``csrc/dfa.cuh``) against the JAX reference's
``pipeline.match_symbols_gather`` and against ``Pattern.matches`` on the
oracle's addresses of 256 keys from a numpy seed.  Exact: booleans.

The reference walks its padded table (``pad_device_dfa``); the port walks
the unpadded ``DeviceDFA`` table, with no cap on the state count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu.crypto.encode import base58check_decode
from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu.pattern import Pattern
from vgen_tpu_torch.ops import pipeline

N = 256
FORMATS = (AddressFormat.P2PKH, AddressFormat.P2WPKH)
# (pattern, case-insensitive): a suffix, an unanchored class, a
# case-insensitive prefix, an alternation, and one with more than 256
# states
PATTERNS = {
    AddressFormat.P2PKH: [("[a-k]$", False), ("[xyz][1-5]", False),
                          ("^1a", True), ("^1(A|B)|Z$", False),
                          ("a.{8}$", False)],
    AddressFormat.P2WPKH: [("[q-z]$", False), ("[ad][02-9]", False),
                           ("^BC1QA", True), ("^bc1q(a|c)|x$", False),
                           ("a.{8}$", False)],
}


@pytest.fixture(scope="module")
def addresses():
    """{fmt: addresses} of N keys and their hash160s as 5 word tensors."""
    rng = np.random.default_rng(7)
    keys = [int.from_bytes(rng.bytes(32), "big") % (1 << 255) + 1
            for _ in range(N)]
    out = {fmt: [AddressGenerator(fmt).generate(k.to_bytes(32, "big")).address
                 for k in keys] for fmt in FORMATS}
    h160 = [base58check_decode(a)[1:] for a in out[AddressFormat.P2PKH]]
    words = [torch.tensor([int.from_bytes(h[4 * i:4 * i + 4], "big")
                           for h in h160], dtype=torch.int64)
             for i in range(5)]
    return out, words


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.value)
@pytest.mark.parametrize("case", range(5))
def test_dfa_walk_equals_gather_reference_and_regex(addresses, fmt, case):
    addrs, words = addresses
    src, icase = PATTERNS[fmt][case]
    pat = Pattern(src, icase)
    dfa = pat.device_dfa(fmt)
    syms, length = pipeline.address_symbols(fmt, words)
    got = pipeline.dfa_walk(torch.from_numpy(dfa.table),
                            torch.from_numpy(dfa.accept), dfa.start, syms,
                            length).numpy()

    flat, accept = jpipeline.pad_device_dfa(dfa)
    want = np.asarray(jpipeline.match_symbols_gather(
        jnp.asarray(flat), jnp.asarray(accept), dfa.start,
        jpipeline.FORMAT_DFA_WIDTH[fmt], jnp.asarray(syms.numpy(),
                                                     dtype=jnp.int32),
        jnp.asarray(length.numpy(), dtype=jnp.int32))).astype(bool)
    np.testing.assert_array_equal(got, want)
    regex = np.array([pat.matches(a) for a in addrs[fmt]])
    np.testing.assert_array_equal(got, regex)
    assert 0 < got.sum() < N  # both outcomes occur
    if src == "a.{8}$":
        assert dfa.table.shape[0] > 256


def test_dfa_matches_with_more_than_1024_states(addresses):
    """``a.{9}$`` compiles to more than 1024 states for both formats."""
    addrs, words = addresses
    pat = Pattern("a.{9}$")
    for fmt in FORMATS:
        dfa = pat.device_dfa(fmt)
        assert dfa.table.shape[0] > 1024
        got = pipeline.dfa_matches(fmt, words, torch.from_numpy(dfa.table),
                                   torch.from_numpy(dfa.accept), dfa.start)
        np.testing.assert_array_equal(
            got.numpy(), np.array([pat.matches(a) for a in addrs[fmt]]))
