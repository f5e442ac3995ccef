"""The P2TR slice on CPU tensors (the plain versions of kernels F to I)
against the JAX package: the field and curve pieces, the tagged hash, the
window table, the ladder, the guarded chain and both finishes against their
XLA counterparts, then whole steps row for row against the jitted
``pipeline.packed_xla_scan_step(P2TR, ...)``, and the scan loop against the
oracle and the native scanner.  Inputs come from numpy seeds or the
oracle; every comparison is exact (integers).

The Pallas kernels themselves are not run (``tests/test_pallas_fused.py``:
the interpreter takes hours); their XLA counterparts are the reference.

``ops``: the port counts clamp(remaining) per window, as the fused
reference's ``_pack_tail`` does; ``packed_xla_scan_step`` counts the lanes
whose finish and tweak are valid (``mask_to_result``), so on a window that
holds the doubling lane (base <= B) it counts one less.  The whole-step
tests compare count, indices and vbits, and ops by that rule."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.ops import curve as jcurve
from vgen_tpu.ops import field as jfield
from vgen_tpu.ops import pallas_fused as jpallas
from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu.ops import sha256 as jsha256
from vgen_tpu.ops import u256 as ju256
from vgen_tpu.scan import tables as jtables
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import (
    AddressFormat,
    AddressGenerator,
    taproot_output_x,
)
from vgen_tpu_torch.crypto.encode import BECH32_CHARSET
from vgen_tpu_torch.ops import curve, encode, field, fused, pipeline, sha256, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan import tables
from vgen_tpu_torch.scan.host import ScanConfig, _scan_cpu

P2TR = AddressFormat.P2TR
JP2TR = JAddressFormat.P2TR
K, B = 2, 256
# window 0 is based below B: it holds the doubling lane (key 2 * base)
BASES = [B // 2 + 1, 0xC0FFEE123456789]
REMAINING = [B, 200]
INTERVAL_SRC, DFA_SRC = "^bc1pq", "q$"
CHAIN = 16


def _fe(rng, n, edge=()):
    vals = [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(n)]
    vals[:len(edge)] = edge
    return vals


def _port(vals):
    """ints -> (8, n) int64 port limbs."""
    return u256.to_i64(u256.as_i32(u256.from_ints(vals)))


def _jax(t):
    """(8, ...) port limbs (int32 or int64) -> (16, ...) reference limbs."""
    a = (t.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)
    return jnp.asarray(u256.limbs32_to_16(a))


def _from_jax(a):
    """(16, ...) reference limbs -> (8, ...) int64 port limbs."""
    return torch.from_numpy(u256.limbs16_to_32(np.asarray(a)).astype(np.int64))


EDGE = (0, 1, ec.P - 1, ec.P - 2, 1 << 255, ec.P - (1 << 32))


@pytest.mark.parametrize("op", ["add", "neg", "mul_small"])
def test_field_ops_equal_reference(op):
    rng = np.random.default_rng(41)
    a_i, b_i = _fe(rng, 256, EDGE), _fe(rng, 256, EDGE[::-1])
    a, b = _port(a_i), _port(b_i)
    if op == "add":
        got, want = field.add(a, b), jfield.add(_jax(a), _jax(b))
        ints = [(x + y) % ec.P for x, y in zip(a_i, b_i)]
    elif op == "neg":
        got, want = field.neg(a), jfield.neg(_jax(a))
        ints = [-x % ec.P for x in a_i]
    else:
        got, want = field.mul_small(a, 2), jfield.mul_small(_jax(a), 2)
        ints = [2 * x % ec.P for x in a_i]
    assert torch.equal(got, _from_jax(want))
    assert u256.to_ints(got) == ints


def test_lean_add_equals_reference():
    rng = np.random.default_rng(42)
    ks = [int.from_bytes(rng.bytes(32), "big") % ec.N for _ in range(64)]
    # Jacobian P with a random Z, affine Q; the first 4 lanes have Q == P
    pts = [ec.scalar_mult(k) for k in ks]
    qs = [ec.scalar_mult(k + 7) for k in ks]
    qs[:4] = pts[:4]
    zs = _fe(rng, 64)
    zs = [z or 1 for z in zs]
    X = [p[0] * z * z % ec.P for p, z in zip(pts, zs)]
    Y = [p[1] * z * z * z % ec.P for p, z in zip(pts, zs)]
    args = [_port(v) for v in (X, Y, zs, [q[0] for q in qs], [q[1] for q in qs])]
    got = curve.jacobian_add_affine_lean(*args)
    want = jcurve.jacobian_add_affine_lean(*(_jax(a) for a in args))
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, _from_jax(w))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].tolist()[:4] == [False] * 4 and all(got[3].tolist()[4:])
    # and the sum is the oracle's on the live lanes
    Xs, Ys, Zs = (u256.to_ints(t) for t in got[:3])
    for i in range(4, 64):
        zi = pow(Zs[i], -1, ec.P)
        want_pt = ec.point_add(pts[i], qs[i])
        assert (Xs[i] * zi * zi % ec.P, Ys[i] * zi ** 3 % ec.P) == want_pt


def test_tagged_hash_equals_reference_and_hashlib():
    mid = sha256.tagged_midstate("TapTweak")
    assert list(mid) == [int(v) for v in jsha256.tagged_midstate("TapTweak")]
    rng = np.random.default_rng(43)
    xs = _fe(rng, 128, (0, ec.P - 1))
    got = u256.to_ints(sha256.tagged_hash_32(mid, _port(xs)))
    data = ju256.to_bytes_be(_jax(_port(xs)))
    want = u256.to_ints(_from_jax(ju256.from_bytes_be(
        jsha256.tagged_hash_32(np.asarray(jsha256.tagged_midstate("TapTweak")),
                               data))))
    tag = hashlib.sha256(b"TapTweak").digest()
    ref = [int.from_bytes(hashlib.sha256(tag + tag + x.to_bytes(32, "big"))
                          .digest(), "big") for x in xs]
    assert got == want == ref


def test_window_table_equals_reference():
    got = tables.window_table("cpu")
    want = jtables.window_table_u32(8)  # (32, 256, 2, 16)
    assert got.shape == (32, 256, 2, 8) and got.dtype == torch.int32
    want32 = np.moveaxis(u256.limbs16_to_32(np.moveaxis(want, 3, 0)), 0, 3)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want32)


@pytest.fixture(scope="module")
def wt():
    return tables.window_table("cpu")


@pytest.fixture(scope="module")
def internal_keys():
    """64 oracle points of seeded keys: (keys, x, y) with x, y (8, 64)."""
    rng = np.random.default_rng(44)
    keys = [int.from_bytes(rng.bytes(32), "big") % ec.N for _ in range(64)]
    pts = [ec.scalar_mult(k) for k in keys]
    return (keys, u256.as_i32(u256.from_ints([p[0] for p in pts])),
            u256.as_i32(u256.from_ints([p[1] for p in pts])))


def test_plain_ladder_equals_reference_and_oracle(internal_keys, wt):
    """qx = X * Z^-2 and ok of the plain ladder (kernel F, finish=False)
    against ``pipeline.p2tr_output_key(x, y, wt, unroll=False)``, and the
    bech32m addresses of qx against the oracle's."""
    keys, x, y = internal_keys
    X, Z, ok = fused.p2tr_ladder_affine(x, y, wt)
    zi = fused.batch_inverse_chain(Z)
    qx = field.mul(u256.to_i64(X), field.square(u256.to_i64(zi)))
    want_qx, want_ok = jpipeline.p2tr_output_key(
        _jax(x), _jax(y), jnp.asarray(jtables.window_table_u32(8)),
        unroll=False)
    assert torch.equal(qx, _from_jax(want_qx))
    np.testing.assert_array_equal(ok.numpy() != 0, np.asarray(want_ok))
    assert ok.all()
    syms, _ = encode.bech32m_p2tr_symbols(qx)
    gen = AddressGenerator(P2TR)
    for i, k in enumerate(keys):
        assert u256.to_ints(qx)[i] == taproot_output_x(
            ec.xonly(ec.scalar_mult(k))[0])
        addr = "bc1" + "".join(BECH32_CHARSET[int(s)] for s in syms[:, i])
        assert addr == gen.generate(k.to_bytes(32, "big")).address


def test_plain_chain_guard_zero_equals_reference():
    """Kernel G's plain version with zeros at lanes 0, 17 and 95 (the case
    of tests/test_inv_pallas.py): equal to the reference's guarded chain,
    and each dead lane's inverse is exactly 1."""
    rng = np.random.default_rng(45)
    vals = _fe(rng, 96)
    for dead in (0, 17, 95):
        vals[dead] = 0
    v = u256.as_i32(u256.from_ints(vals))
    got = fused.batch_inverse_chain(v)
    want = jpallas.batch_inverse_chain_pallas(_jax(v), guard_zero=True)
    assert torch.equal(u256.to_i64(got), _from_jax(want))
    inv = u256.to_ints(got)
    for val, g in zip(vals, inv):
        assert (val * g % ec.P == 1) if val else g == 1


def _points(bases):
    pts = [ec.scalar_mult(s) for s in bases]
    return (u256.as_i32(u256.from_ints([p[0] for p in pts]).T.copy()),
            u256.as_i32(u256.from_ints([p[1] for p in pts]).T.copy()))


@pytest.fixture(scope="module")
def step_inputs(wt):
    """(bx, by, tx, ty, remaining) and the ladder lanes (X, Z, zi, ok)."""
    tx, ty = tables.ig_table(B, "cpu")
    bx, by = _points(BASES)
    rem = torch.tensor(REMAINING, dtype=torch.int32)
    lanes = fused._p2tr_ladder_zi(bx, by, tx, ty, wt)
    return (bx, by, tx, ty, rem), lanes


@pytest.fixture(scope="module")
def oracle_points():
    """(x3, y3) (16, B) reference limbs of (base + 1 + i) * G per window."""
    out = []
    for base in BASES:
        bpt = ec.scalar_mult(base)
        pts = [ec.point_add(bpt, t) for t in ec.ig_table(B, start=1)]
        # the doubling lane has no affine-add result: any point will do
        pts = [p if p is not None else ec.G for p in pts]
        out.append(tuple(
            jnp.asarray(u256.limbs32_to_16(u256.from_ints([p[c] for p in pts])))
            for c in (0, 1)))
    return out


def _live(k):
    """(B,) bool: lanes of window k with a valid finish (not the doubling
    lane)."""
    live = np.ones(B, bool)
    if 1 <= BASES[k] <= B:
        live[BASES[k] - 1] = False
    return live


def _lo_hi(src):
    ivs = Pattern(src).match_intervals(P2TR)
    return pipeline.intervals_to_words(
        ivs, n_words=8, n_slots=pipeline.interval_slot_count(len(ivs)))


def test_plain_finish_range_equals_reference(step_inputs, oracle_points):
    """Kernel H's plain version against ``interval_value_words(P2TR)`` and
    ``in_intervals``, masked by the reference's validity and remaining."""
    _, (X, Z, zi, ok) = step_inputs
    lo, hi = _lo_hi(INTERVAL_SRC)
    rem = torch.tensor(REMAINING, dtype=torch.int32)
    got = fused.p2tr_finish_range(X, Z, zi, ok, u256.as_i32(lo),
                                  u256.as_i32(hi), rem).numpy()
    wtj = jnp.asarray(jtables.window_table_u32(8))
    for k, (x3, y3) in enumerate(oracle_points):
        words, tok = jpipeline.interval_value_words(JP2TR, x3, y3, wtj)
        hit = np.asarray(jpipeline.in_intervals(words, jnp.asarray(lo),
                                                jnp.asarray(hi)))
        want = hit & np.asarray(tok) & _live(k) & (np.arange(B) < REMAINING[k])
        np.testing.assert_array_equal(got[k], want.astype(np.int32))
    assert got.sum() > 0


def test_plain_finish_match_equals_reference(step_inputs, oracle_points):
    """Kernel I's plain version against ``symbols_p2tr`` and
    ``match_symbols_gather`` (59 symbols, T + 1 steps, EOS at 59)."""
    _, (X, Z, zi, ok) = step_inputs
    dfa = Pattern(DFA_SRC).device_dfa(P2TR)
    rem = torch.tensor(REMAINING, dtype=torch.int32)
    got = fused.p2tr_finish_match(
        X, Z, zi, ok, torch.from_numpy(dfa.table),
        torch.from_numpy(dfa.accept.astype(np.int32)), dfa.start, rem).numpy()
    flat, accept = jpipeline.pad_device_dfa(dfa)
    wtj = jnp.asarray(jtables.window_table_u32(8))
    for k, (x3, y3) in enumerate(oracle_points):
        syms, length, tok = jpipeline.symbols_p2tr(x3, y3, wtj,
                                                   jnp.ones(B, dtype=bool))
        assert int(length[0]) == encode.BECH32M_SYMS
        m = np.asarray(jpipeline.match_symbols_gather(
            jnp.asarray(flat), jnp.asarray(accept), dfa.start,
            jpipeline.FORMAT_DFA_WIDTH[JP2TR], syms, length)) != 0
        want = m & np.asarray(tok) & _live(k) & (np.arange(B) < REMAINING[k])
        np.testing.assert_array_equal(got[k], want.astype(np.int32))
    assert got.sum() > 0


def _to16(t):
    """(K, 8) int32 port limbs -> (K, 16) reference limbs."""
    return jnp.asarray(u256.limbs32_to_16(t.numpy().view(np.uint32).T).T)


def reference_rows(kind, bx, by):
    """The rows of the jitted ``packed_xla_scan_step(P2TR, kind, False, 16,
    2, False, n_extras=1)`` (about 40 s of XLA:CPU compile per kind)."""
    tx16, ty16 = jtables.ig_table_limbs(B)
    if kind == "range":
        lo, hi = _lo_hi(INTERVAL_SRC)
        margs = (jnp.asarray(lo), jnp.asarray(hi))
    else:
        dfa = Pattern(DFA_SRC).device_dfa(P2TR)
        flat, accept = jpipeline.pad_device_dfa(dfa)
        margs = (jnp.asarray(flat), jnp.asarray(accept), jnp.int32(dfa.start))
    step = jpipeline.packed_xla_scan_step(JP2TR, kind, False, CHAIN, K, False,
                                          n_extras=1)
    return np.asarray(step(
        _to16(bx), _to16(by), jnp.asarray(tx16), jnp.asarray(ty16),
        jnp.asarray(REMAINING, dtype=jnp.int32), *margs,
        jnp.asarray(jtables.window_table_u32(8))))


def port_rows(kind, bx, by, tx, ty, rem, wt):
    """The port's packed rows of one super-step on CPU tensors."""
    if kind == "range":
        lo, hi = _lo_hi(INTERVAL_SRC)
        return fused.fused_p2tr_range_scan_step(
            bx, by, tx, ty, u256.as_i32(lo), u256.as_i32(hi), rem, wt)
    dfa = Pattern(DFA_SRC).device_dfa(P2TR)
    return fused.fused_p2tr_scan_step(
        bx, by, tx, ty, torch.from_numpy(dfa.table),
        torch.from_numpy(dfa.accept.astype(np.int32)), dfa.start, rem, wt)


def check_rows(rows, ref):
    """count, indices and vbits equal; ops = clamp(remaining), one more
    than the reference's on the window that holds the doubling lane."""
    assert rows.shape == ref.shape == (K, pipeline.PACKED_WIDTH)
    cols = [0] + list(range(2, pipeline.PACKED_WIDTH))
    np.testing.assert_array_equal(rows[:, cols], ref[:, cols])
    assert rows[:, 1].tolist() == REMAINING
    assert ref[:, 1].tolist() == [REMAINING[0] - 1, REMAINING[1]]
    assert rows[:, 0].sum() > 0


def test_whole_range_step_rows_match_packed_xla_scan_step(step_inputs, wt):
    """Kernels A, F, G, H and the pack, row for row (the DFA route's step:
    ``tests/test_torch_p2tr_dfa_step.py``)."""
    bx, by, tx, ty, rem = step_inputs[0]
    check_rows(port_rows("range", bx, by, tx, ty, rem, wt).numpy(),
               reference_rows("range", bx, by))


def test_p2tr_wrappers_never_run_plain_for_device_tensors(wt):
    """A tensor that is not on the CPU goes to the kernel path, which checks
    it and raises here."""
    m = torch.zeros((8, 512), dtype=torch.int32, device="meta")
    ok, rem = m[0], torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fused.p2tr_ladder(m[:2, :8], m[:2, :8], m[:, :256], m[:, :256], m,
                          wt.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        fused.batch_inverse_chain(m)
    with pytest.raises(ValueError, match="meta"):
        fused.p2tr_finish_range(m, m, m, ok, m[:1, :8], m[:1, :8], rem)
    with pytest.raises(ValueError, match="width"):
        fused.p2tr_finish_match(m, m, m, ok, m[:4, :60], m[0, :4], 0, rem)


def test_random_p2tr_scan_finds_oracle_matches():
    """``generate -f p2tr -c 2`` on CPU tensors: both matches re-derived by
    the oracle; one key per position."""
    pat = Pattern("^bc1pq")
    scanner = sc.DeviceScanner(P2TR, B, "cpu", k_sub=K)
    res = scanner.scan(pat, ScanConfig(format=P2TR, count=2, in_flight=1))
    assert len(res.matches) == 2
    gen = AddressGenerator(P2TR)
    for m in res.matches:
        assert gen.generate(bytes.fromhex(m.hex)).address == m.address
        assert pat.matches(m.address)
    assert res.operations % (K * B) == 0


def test_range_p2tr_dfa_scan_equals_native_scanner():
    """``range -f p2tr --range 2000:3FFF -p q$ -c 0`` on CPU tensors: the
    match set equals the port's native scanner's, key for key."""
    pat = Pattern(DFA_SRC)
    cfg = ScanConfig(format=P2TR, start=0x2000, end=0x3FFF, count=0)
    res = sc.DeviceScanner(P2TR, B, "cpu", k_sub=4).scan(pat, cfg)
    ref = _scan_cpu(pat, ScanConfig(format=P2TR, start=0x2000, end=0x3FFF,
                                    count=0, use_device=False), None, None)
    keys = sorted(int(m.hex, 16) for m in res.matches)
    assert keys == sorted(int(m.hex, 16) for m in ref.matches)
    assert len(keys) > 100
    assert res.operations == ref.operations == 0x2000


def test_estimate_p2tr_calibrates_on_the_card(capsys, monkeypatch):
    """``estimate -f p2tr`` runs the device calibration when a card is
    visible (faked here), on the pattern's own format."""
    from vgen_tpu_torch import cli

    calls = []

    def fake_benchmark(fmt, pattern_str, **kw):
        calls.append((fmt, pattern_str))
        return {"keys_per_sec": 1e8, "device": "card"}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(sc, "benchmark_device", fake_benchmark)
    assert cli.run_from_args(["estimate", "-f", "p2tr", "-p", "^bc1pqq"]) == 0
    assert calls == [(P2TR, "^bc1pqq")]
    assert "Device rate: 100,000,000 keys/sec (card)" in capsys.readouterr().out
