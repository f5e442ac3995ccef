"""P2SH-P2WPKH, uncompressed P2PKH and Ethereum on CPU tensors (the plain
versions) against the JAX reference, one case per format: the value
(the redeem script's hash160, hash160 of 04 || x || y, the Ethereum
account) against the reference's byte path or ``keccak.py``, its symbols
(Base58Check with version 5 or 0, EIP-55) against
``pipeline.symbols_p2sh_p2wpkh``, ``symbols_p2pkh_uncompressed`` or
``symbols_ethereum`` and the oracle's address; then kernels B to E per
window against the reference's per-key functions on the same points:
``glv_interval_mask`` (B), ``interval_value_words`` with ``in_intervals``
(C), the format's symbols and ``match_symbols_gather`` (D), and
``glv_variant_symbols`` per variant (E), assembled into bit 2v+pi as
``make_format_mask(glv=True)`` does.  Exact: every value is an integer;
masks are compared with their variant bits (pi = 0 is the prefix 2 or +y,
pi = 1 the prefix 3 or -y).

The points of each window, (base + 1 + i) * G for i < B, come from the
Python oracle, and the variants' (beta^v x, +-y) from integer arithmetic,
so no reference curve code is compiled.  Each format's jitted reference
functions are built once, at B = 256."""

import functools
import hashlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.ops import encode as jencode
from vgen_tpu.ops import keccak as jkeccak
from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.ops import encode, fused, keccak, pipeline, sha256, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.pattern.pattern import DIGITS_BASE58, DIGITS_ETH
from vgen_tpu_torch.scan import tables

P2SH = AddressFormat.P2SH_P2WPKH
UNC = AddressFormat.P2PKH_UNCOMPRESSED
ETH = AddressFormat.ETHEREUM
K, B = 2, 256
BASES = [0x5EED5EED5EED, 0xC0FFEE123456789]  # both > B
REMAINING = [B, B - 37]


def _script_hash(x16, y16):
    h = jencode.hash160_33(jpipeline.compressed_pubkey_bytes(x16, y16))
    return jpipeline.bytes_be_words(jpipeline.script_hash(h))


def _hash160_65(x16, y16):
    return jpipeline.bytes_be_words(jencode.hash160_65(
        jpipeline.uncompressed_pubkey_bytes(x16, y16)))


# Per format: the reference value (the byte path or keccak.py), symbols,
# the address text of symbols, and the patterns of kernels B/C, D and E
# (a.{8}$ has more than 256 DFA states).
CASES = {
    P2SH: types.SimpleNamespace(
        value=_script_hash, symbols=jpipeline.symbols_p2sh_p2wpkh,
        text=lambda s: "".join(DIGITS_BASE58[int(d)] for d in s),
        intervals=["^3A", "^3[A-H]"], d=["c[a4]", "a.{8}$"],
        e=["c[a4]", "a.{8}$"]),
    UNC: types.SimpleNamespace(
        value=_hash160_65, symbols=jpipeline.symbols_p2pkh_uncompressed,
        text=lambda s: "".join(DIGITS_BASE58[int(d)] for d in s),
        intervals=["^1A", "^1[A-H]"], d=["c[a4]", "a.{8}$"],
        e=["c[a4]", "a.{8}$"]),
    ETH: types.SimpleNamespace(
        value=jkeccak.eth_account_words_from_xy,
        symbols=jpipeline.symbols_ethereum,
        text=lambda s: "0x" + "".join(DIGITS_ETH[int(d)] for d in s),
        intervals=["^0x1", "^0xab"], d=["Ab", "a.{8}$"],
        e=["Ab$", "a.{8}$"]),
}


def _cases(kind):
    return [pytest.param(f, s, id=f"{f.value}-{s}")
            for f, case in CASES.items() for s in getattr(case, kind)]


@functools.cache
def _ref(fmt):
    """The jitted reference functions of ``fmt``."""
    jfmt = JAddressFormat(fmt.value)
    return types.SimpleNamespace(
        jfmt=jfmt,
        glv_mask=jax.jit(lambda x, y, lo, hi: jpipeline.glv_interval_mask(
            jfmt, x, y, lo, hi, unroll=False)),
        value=jax.jit(lambda x, y: jpipeline.interval_value_words(
            jfmt, x, y, unroll=False)[0]),
        symbols=jax.jit(functools.partial(CASES[fmt].symbols, unroll=False)),
        variant=jax.jit(lambda x, y, pi: jpipeline.glv_variant_symbols(
            jfmt, x, y, pi, unroll=False)),
        walk=jax.jit(jpipeline.match_symbols_gather, static_argnums=3),
    )


def _l16(vals):
    """Ints -> (16, n) reference limbs."""
    return jnp.asarray(u256.limbs32_to_16(u256.from_ints(vals)))


def _t64(vals):
    """Ints -> (8, n) int64 limbs of the plain versions."""
    return torch.from_numpy(u256.from_ints(vals).astype(np.int64))


@pytest.fixture(scope="module")
def lanes():
    """(bx, by, tx, ty, inv, remaining) int32 tensors of the two windows."""
    tx, ty = tables.ig_table(B, "cpu")
    pts = [ec.scalar_mult(s) for s in BASES]
    bx = u256.as_i32(u256.from_ints([p[0] for p in pts]).T.copy())
    by = u256.as_i32(u256.from_ints([p[1] for p in pts]).T.copy())
    inv = fused.batch_inverse_dx(bx, tx)
    return bx, by, tx, ty, inv, torch.tensor(REMAINING, dtype=torch.int32)


@pytest.fixture(scope="module")
def points():
    """[(xs, ys)] per window: the oracle's (base + 1 + i) * G, i < B."""
    out = []
    for base in BASES:
        bpt = ec.scalar_mult(base)
        pts = [ec.point_add(bpt, t) for t in ec.ig_table(B, start=1)]
        out.append(([p[0] for p in pts], [p[1] for p in pts]))
    return out


def _variants(xs, ys):
    """(v, pi, xv, yv) ints of the six GLV variants (beta^v x, +-y); the
    parity formats hash the prefix 2 + pi of beta^v x."""
    for v in range(3):
        b = pow(ec.BETA, v, ec.P)
        xv = [x * b % ec.P for x in xs]
        for pi in range(2):
            yield v, pi, xv, ys if pi == 0 else [(ec.P - y) % ec.P for y in ys]


def _same_window(got_row, want_row, rem):
    np.testing.assert_array_equal(got_row[:rem], np.asarray(want_row)[:rem])
    assert not got_row[rem:].any()


def _interval_words(fmt, src):
    pat = Pattern(src)
    ivs = pat.match_intervals(fmt) or pat.prefilter_intervals(fmt)[0]
    lo, hi = pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs)))
    return lo, hi


def _walk(ref, dfa, syms, length):
    flat, accept = jpipeline.pad_device_dfa(dfa)
    return np.asarray(ref.walk(jnp.asarray(flat), jnp.asarray(accept),
                               jnp.int32(dfa.start),
                               jpipeline.FORMAT_DFA_WIDTH[ref.jfmt], syms,
                               length))


def _dfa_tensors(dfa):
    return (torch.from_numpy(dfa.table.astype(np.int32)),
            torch.from_numpy(dfa.accept.astype(np.int32)), dfa.start)


@pytest.mark.parametrize("fmt", list(CASES), ids=lambda f: f.value)
def test_value_and_symbols_equal_reference_and_oracle(points, fmt):
    """The value words against the reference's byte path (Ethereum:
    ``eth_account_words_from_xy``), the symbols against the reference's
    and the oracle's address, for the B points of window 0: P2SH-P2WPKH
    always 34 symbols, Ethereum with upper-case letters among its 40."""
    xs, ys = points[0]
    value = pipeline.interval_value_words(fmt, _t64(xs), _t64(ys))
    want = jax.jit(CASES[fmt].value)(_l16(xs), _l16(ys))
    for g, w in zip(value, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    syms, length = pipeline.address_symbols(fmt, value)
    jsyms, jlength = _ref(fmt).symbols(_l16(xs), _l16(ys))
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jsyms))
    np.testing.assert_array_equal(length.numpy(), np.asarray(jlength))
    gen = AddressGenerator(fmt)
    for i in range(B):
        addr = CASES[fmt].text(syms[:int(length[i]), i])
        key = BASES[0] + 1 + i
        assert addr == gen.generate(key.to_bytes(32, "big")).address
    if fmt == P2SH:
        assert length.tolist() == [34] * B
    if fmt == ETH:
        assert int((syms >= 16).sum()) > 0  # upper-case letters occur


def test_script_hash_is_hash160_of_the_redeem_script(points):
    """P2SH-P2WPKH's value is ``script_hash_words`` of the compressed
    key's hash160."""
    xs, ys = points[0]
    x, y = _t64(xs), _t64(ys)
    h160 = encode.hash160_33_words_from_x(x, 2 + (y[0] & 1))
    for g, w in zip(pipeline.interval_value_words(P2SH, x, y),
                    encode.script_hash_words(h160)):
        assert torch.equal(g, w)


def test_sha256_x65_state_equals_hashlib(points):
    """SHA-256 of 04 || x || y (two compressions) against hashlib."""
    xs, ys = points[0]
    st = torch.stack(sha256.sha256_x65_state(_t64(xs), _t64(ys))).numpy()
    for i in range(B):
        digest = hashlib.sha256(b"\x04" + xs[i].to_bytes(32, "big")
                                + ys[i].to_bytes(32, "big")).digest()
        assert b"".join(int(w).to_bytes(4, "big") for w in st[:, i]) == digest


def test_keccak_f1600_equals_reference():
    rng = np.random.default_rng(4)
    hi = rng.integers(0, 1 << 32, size=(25, 64), dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, size=(25, 64), dtype=np.uint32)
    got = keccak.keccak_f1600(torch.from_numpy(hi.astype(np.int64)),
                              torch.from_numpy(lo.astype(np.int64)))
    want = jax.jit(jkeccak.keccak_f1600)(jnp.asarray(hi), jnp.asarray(lo))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("fmt, src", _cases("intervals"))
def test_kernel_b_plain_equals_glv_interval_mask(lanes, points, fmt, src):
    lo, hi = _interval_words(fmt, src)
    mask = fused.range_glv_match_plain(fmt, *lanes[:5], u256.as_i32(lo),
                                       u256.as_i32(hi), lanes[5]).numpy()
    ref = _ref(fmt)
    for k, (xs, ys) in enumerate(points):
        _same_window(mask[k], ref.glv_mask(_l16(xs), _l16(ys), jnp.asarray(lo),
                                           jnp.asarray(hi)), REMAINING[k])
    assert int((mask > 0).sum()) > 0


@pytest.mark.parametrize("fmt, src", _cases("intervals"))
def test_kernel_c_plain_equals_interval_value_words(lanes, points, fmt, src):
    lo, hi = _interval_words(fmt, src)
    mask = fused.range_match_plain(fmt, *lanes[:5], u256.as_i32(lo),
                                   u256.as_i32(hi), lanes[5]).numpy()
    for k, (xs, ys) in enumerate(points):
        words = _ref(fmt).value(_l16(xs), _l16(ys))
        want = jpipeline.in_intervals(words, jnp.asarray(lo), jnp.asarray(hi))
        _same_window(mask[k], np.asarray(want).astype(np.int32), REMAINING[k])
    assert int(mask.sum()) > 0


@pytest.mark.parametrize("fmt, src", _cases("d"))
def test_kernel_d_plain_equals_symbols_and_walk(lanes, points, fmt, src):
    dfa = Pattern(src).device_dfa(fmt)
    mask = fused.dfa_match_plain(fmt, *lanes[:5], *_dfa_tensors(dfa),
                                 lanes[5]).numpy()
    ref = _ref(fmt)
    for k, (xs, ys) in enumerate(points):
        syms, length = ref.symbols(_l16(xs), _l16(ys))
        want = _walk(ref, dfa, syms, length).astype(np.int32)
        _same_window(mask[k], want, REMAINING[k])
    assert int(mask.sum()) > 0
    if src == "a.{8}$":
        assert dfa.table.shape[0] > 256


@pytest.mark.parametrize("fmt, src", _cases("e"))
def test_kernel_e_plain_equals_glv_variant_symbols(lanes, points, fmt, src):
    dfa = Pattern(src).device_dfa(fmt)
    mask = fused.glv_dfa_match_plain(fmt, *lanes[:5], *_dfa_tensors(dfa),
                                     lanes[5]).numpy()
    ref = _ref(fmt)
    for k, (xs, ys) in enumerate(points):
        want = np.zeros(B, np.int32)
        for v, pi, xv, yv in _variants(xs, ys):
            syms, length = ref.variant(_l16(xv), _l16(yv), jnp.int32(pi))
            want |= _walk(ref, dfa, syms, length).astype(np.int32) << (2 * v + pi)
        _same_window(mask[k], want, REMAINING[k])
    assert int((mask > 0).sum()) > 0
