"""Kernel F's window schedules and kernels A and G's inversion geometry on
CPU tensors (the plain versions), against the oracle and the JAX package:
the ladder table builder at a width that does not divide 256 and with
signed digits, the schedule read from a table's shape, the plain ladder at
the product's schedule against the JAX ladder at 8 bits on the output
key's x and ``ok`` (the doubling lane, and the small keys whose first add
of the port's own schedule meets H == 0, which the port computes exactly),
the
scanner's table, and the counts the card tools hold the kernels to (the
whole step at the product's schedule: ``test_torch_ladder_window_step.py``).
Exact: every value is an integer."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_p2tr import _from_jax, _jax
from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu.scan import tables as jtables
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat, taproot_output_x
from vgen_tpu_torch.ops import field, fused, u256
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import roofline, sweep_inv_chain, sweep_ladder_window
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan import tables

P2TR = AddressFormat.P2TR
TAG = hashlib.sha256(b"TapTweak").digest()


def _ints(a: np.ndarray):
    """(..., 8) uint32 limbs -> ints."""
    return int.from_bytes(a.astype("<u4").tobytes(), "little")


@pytest.mark.parametrize("schedule", [(13, False), (16, True)],
                         ids=["13u", "16s"])
def test_ladder_table_entries_equal_oracle(schedule):
    """13 bits do not divide 256: 20 windows cover t's top bits (a floored
    count of 19 would drop them); 16 signed bits hold |d| <= 2^15 in 17
    windows, the last for the recoding's carry.  Sampled entries equal
    d * 2^(bits w) * G of the oracle; the d = 0 rows are zero."""
    bits, signed = schedule
    tbl = tables.ladder_table_limbs(bits, signed)
    windows, entries = fused.ladder_shape(bits, signed)
    assert tbl.shape == (windows, entries, 2, 8) and tbl.dtype == np.uint32
    assert bits * windows >= 256 + (1 if signed else 0)
    assert not tbl[:, 0].any()
    rng = np.random.default_rng(91)
    samples = [(0, 1), (windows - 1, 1), (windows - 1, entries - 1),
               (windows // 2, entries - 1)]
    samples += [(int(rng.integers(windows)), int(rng.integers(1, entries)))
                for _ in range(8)]
    for w, d in samples:
        want = ec.scalar_mult(d << (bits * w))
        assert (_ints(tbl[w, d, 0]), _ints(tbl[w, d, 1])) == want, (w, d)


def test_schedule_is_read_from_the_table_shape():
    assert fused.ladder_schedule(tables.ladder_table("cpu")) == \
        fused.LADDER_WINDOW
    assert fused.ladder_schedule(tables.window_table("cpu")) == (8, False)
    for bits, signed in fused.LADDER_WINDOWS:
        windows, entries = fused.ladder_shape(bits, signed)
        meta = torch.empty((windows, entries, 2, 8), device="meta")
        assert fused.ladder_schedule(meta) == (bits, signed)
    for shape in [(31, 256, 2, 8), (17, 32768, 2, 8), (32, 256, 8),
                  (17, 32769, 2, 16)]:
        with pytest.raises(ValueError):
            fused.ladder_schedule(torch.empty(shape, device="meta"))


def test_wrappers_refuse_what_no_kernel_takes():
    """A schedule csrc/p2tr.cu does not instance (11 bits) and a group
    that is not a power of two up to 512 raise before any launch."""
    m = torch.zeros((8, 512), dtype=torch.int32, device="meta")
    windows, entries = fused.ladder_shape(11, False)
    wt11 = torch.zeros((windows, entries, 2, 8), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="no kernel instance"):
        fused.p2tr_ladder(m[:2, :8], m[:2, :8], m[:, :256], m[:, :256], m,
                          wt11)
    with pytest.raises(ValueError, match="no kernel instance"):
        fused.p2tr_ladder_affine(m, m, wt11)
    for group in (0, 3, 1024):
        with pytest.raises(ValueError, match="group"):
            fused.batch_inverse_chain(m, group=group)
        with pytest.raises(ValueError, match="group"):
            fused.batch_inverse_dx(m[:2, :8], m[:, :256], group=group)


def _h_zero_keys(bits: int, signed: bool):
    """The keys d <= 2^(bits-1) whose point meets the table entry of its own
    first digit, |digit 0 of TapTweak(x(d G))| = d, with the kind of the
    first add: "double" where the even-Y key and the signed entry are the
    same point, "infinity" where they are opposite."""
    out = []
    for d, (x, y) in enumerate(ec.multiples_table(ec.G, 1 << (bits - 1)),
                               start=1):
        t = int.from_bytes(hashlib.sha256(TAG + TAG + x.to_bytes(32, "big"))
                           .digest(), "big")
        digit = t & ((1 << bits) - 1)
        negative = signed and digit > 1 << (bits - 1)
        if negative:
            digit = (1 << bits) - digit
        if digit == d:
            # the ladder adds to the even-Y key: -d G where y is odd
            out.append((d, "double" if (y & 1 == 1) == negative
                        else "infinity"))
    return out


def test_plain_ladder_product_schedule_equals_jax_8bit():
    """The plain ladder (finish=False) with the product's table against
    ``pipeline.p2tr_output_key`` with the JAX package's 8-bit table: qx =
    X * Z^-2 and ok equal, and equal to the oracle's output key, on 64
    random keys and on the small keys whose first add of the port's
    schedule meets H == 0 (at 16 signed bits: 10286, whose first add is a
    doubling, and 19463 and 23277, whose first add reaches the point at
    infinity): the port's ladder computes those adds exactly.  The
    reference's 8-bit schedule reaches infinity on 23277 (-0x5AED G +
    0xED G + 0x5A00 G) and drops it (ok 0), the standing departure of
    ROADMAP.md section 3: the port's ok is 1 on every lane."""
    small = _h_zero_keys(*fused.LADDER_WINDOW)
    assert {kind for _, kind in small} == {"double", "infinity"}
    rng = np.random.default_rng(92)
    keys = [int.from_bytes(rng.bytes(32), "big") % ec.N
            for _ in range(64 - len(small))] + [d for d, _ in small]
    pts = [ec.scalar_mult(k) for k in keys]
    x = u256.as_i32(u256.from_ints([p[0] for p in pts]))
    y = u256.as_i32(u256.from_ints([p[1] for p in pts]))
    X, Z, ok = fused.p2tr_ladder_affine(x, y, tables.ladder_table("cpu"))
    zi = fused.batch_inverse_chain(Z)
    qx = field.mul(u256.to_i64(X), field.square(u256.to_i64(zi)))
    want_qx, want_ok = jpipeline.p2tr_output_key(
        _jax(x), _jax(y), jnp.asarray(jtables.window_table_u32(8)),
        unroll=False)
    want_ok = torch.from_numpy(np.array(want_ok))
    assert [k for k, w in zip(keys, want_ok.tolist()) if not w] == [23277]
    assert torch.equal(qx[:, want_ok], _from_jax(want_qx)[:, want_ok])
    assert ok.all()
    assert u256.to_ints(qx) == [taproot_output_x(ec.xonly(p)[0]) for p in pts]


def test_plain_finish_ladder_product_schedule_with_doubling_lane():
    """The plain ladder (finish=True) with the product's table on two
    windows, window 0 holding the doubling lane: qx equal to the JAX
    ladder's at 8 bits on the oracle's points of the live lanes, ok 1
    there and 0 on the doubling lane (64 lanes, as the finish=False test,
    so the reference's loops compile once)."""
    K, B, bases = 2, 32, [17, 0xC0FFEE123456789]
    tx, ty = tables.ig_table(B, "cpu")
    pts = [ec.scalar_mult(s) for s in bases]
    bx = u256.as_i32(u256.from_ints([p[0] for p in pts]).T.copy())
    by = u256.as_i32(u256.from_ints([p[1] for p in pts]).T.copy())
    inv = fused.batch_inverse_dx(bx, tx)
    X, Z, ok = fused.p2tr_ladder(bx, by, tx, ty, inv, tables.ladder_table("cpu"))
    zi = fused.batch_inverse_chain(Z)
    qx = field.mul(u256.to_i64(X), field.square(u256.to_i64(zi)))
    live = np.ones(K * B, bool)
    live[bases[0] - 1] = False  # (17 + 16 + 1) G = 2 * 17 G: the doubling
    sums = [ec.point_add(pts[k], ec.scalar_mult(b + 1)) for k in range(K)
            for b in range(B)]
    sums = [s if lv else ec.G for s, lv in zip(sums, live)]
    x3 = u256.as_i32(u256.from_ints([s[0] for s in sums]))
    y3 = u256.as_i32(u256.from_ints([s[1] for s in sums]))
    want_qx, want_ok = jpipeline.p2tr_output_key(
        _jax(x3), _jax(y3), jnp.asarray(jtables.window_table_u32(8)),
        unroll=False)
    want_qx = _from_jax(want_qx)
    np.testing.assert_array_equal(ok.numpy() != 0, live)
    assert np.asarray(want_ok).all()
    assert torch.equal(qx[:, live], want_qx[:, live])


def test_scanner_uploads_the_product_table():
    scanner = sc.DeviceScanner(P2TR, 256, "cpu", k_sub=2)
    assert fused.ladder_schedule(scanner.wt) == fused.LADDER_WINDOW
    assert sc.DeviceScanner(AddressFormat.P2PKH, 256, "cpu").wt is None


def test_tool_counts_follow_the_work():
    """The restated bounds: one inversion per chain is the earlier count
    (three multiplies, the subtraction, an inversion by divsteps per 64); a
    group of 256 shares the inversion and adds its tree's 3 (g - 1)
    multiplies.
    The ladder's count adds a lean add per nonzero digit and a negation
    per negative one; ``roofline.expected_adds`` is the mean of the
    digits' count on random tweaks."""
    old = 3 * bm.FE_MUL + bm.FE_ADD + bm.INV_DIVSTEPS / 64
    np.testing.assert_allclose(sweep_inv_chain.chain_count(64), old)
    new = sweep_inv_chain.chain_count(64, 256)
    np.testing.assert_allclose(
        new, 3 * bm.FE_MUL + bm.FE_ADD + bm.INV_DIVSTEPS / 16384
        + 3 * bm.FE_MUL * 255 / 16384)
    assert new[0] < old[0]
    rng = np.random.default_rng(93)
    vals = [int.from_bytes(rng.bytes(32), "big") for _ in range(4096)]
    t = torch.from_numpy(np.stack([np.frombuffer(v.to_bytes(32, "little"),
                                                 "<u4") for v in vals], 1)
                         .astype(np.int64))
    for bits, signed in fused.LADDER_WINDOWS:
        adds, negs = sweep_ladder_window.ladder_work(t, bits, signed)
        assert abs(adds / 4096 - roofline.expected_adds(bits, signed)) < 0.05
        assert (negs > 0) == signed
        count = sweep_ladder_window.ladder_count(4096, adds, negs)
        np.testing.assert_allclose(
            count, 4096 * (sweep_ladder_window.FINISH_XY
                           + sweep_ladder_window.TWEAK)
            + adds * bm.LEAN_ADD + negs * bm.FE_ADD)


def test_ladder_sweep_exits_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        sweep_ladder_window.main([])
    assert exc.value.code not in (0, None)


def test_ladder_profile_exits_without_a_card(monkeypatch):
    from vgen_tpu_torch.probes import profile_ladder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        profile_ladder.main([])
    assert exc.value.code not in (0, None)
