"""Kernel B (``fused.range_glv_match``), the pack tail and the whole step on
CPU tensors (plain versions) against the JAX reference's XLA path:
``pipeline.make_range_mask(fmt, glv=True)`` + ``mask_to_result`` and
``pipeline.packed_xla_scan_step``.  Exact: masks and rows are integers.

Small shapes (B = 256, chain 16, byte-path hashes) keep the XLA:CPU
compiles short, as in tests/test_range_tail.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.ops import curve as jcurve
from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu.scan import tables as jtables
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.ops import fused, pipeline, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import tables

B = 256
CHAIN = 16
BASES = [0x5EED5EED5EED, 0xC0FFEE123456789]  # both > B
PATTERNS = {AddressFormat.P2PKH: "^1C", AddressFormat.P2WPKH: "^bc1qq"}


def _points(bases):
    pts = [ec.scalar_mult(s) for s in bases]
    bx = u256.from_ints([p[0] for p in pts]).T.copy()
    by = u256.from_ints([p[1] for p in pts]).T.copy()
    return bx, by


def _intervals(fmt):
    ivs = Pattern(PATTERNS[fmt]).match_intervals(fmt)
    return pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs)))


def _to16(a32):
    """(K, 8) port limbs -> (K, 16) reference limbs."""
    return jnp.asarray(u256.limbs32_to_16(a32.T).T)


@pytest.fixture(scope="module")
def table():
    tx16, ty16 = jtables.ig_table_limbs(B)
    tx, ty = tables.ig_table(B, "cpu")
    return tx16, ty16, tx, ty


def _port_step(table, fmt, bases, remaining):
    _, _, tx, ty = table
    bx, by = _points(bases)
    lo, hi = _intervals(fmt)
    args = [u256.as_i32(a) for a in (bx, by)] + [tx, ty]
    lo_t, hi_t = u256.as_i32(lo), u256.as_i32(hi)
    rem = torch.tensor(remaining, dtype=torch.int32)
    inv = fused.batch_inverse_dx(args[0], tx)
    mask = fused.range_glv_match(*args, inv, lo_t, hi_t, rem)
    rows = fused.fused_range_scan_step(fmt, *args, lo_t, hi_t, rem)
    return mask, rows


@pytest.fixture(scope="module")
def ref_mask_fn():
    def fn(x3, y3, valid, lo, hi, rem):
        m, mvalid = jpipeline.make_range_mask(JAddressFormat.P2PKH, glv=True)(
            x3, y3, valid, lo, hi, rem)
        return m, jpipeline.mask_to_result(m, mvalid, 6)

    return jax.jit(fn)


def _oracle_points(base):
    """(x3, y3) (16, B) reference limbs of (base + 1 + i) * G, i < B, from
    the Python oracle, so the reference mask needs no curve compile."""
    bpt = ec.scalar_mult(base)
    pts = [ec.point_add(bpt, t) for t in ec.ig_table(B, start=1)]
    return (jnp.asarray(u256.limbs32_to_16(u256.from_ints([p[0] for p in pts]))),
            jnp.asarray(u256.limbs32_to_16(u256.from_ints([p[1] for p in pts]))))


def test_range_glv_match_vs_make_range_mask(table, ref_mask_fn):
    fmt = AddressFormat.P2PKH
    remaining = [B, B - 37]
    mask, rows = _port_step(table, fmt, BASES, remaining)
    lo, hi = _intervals(fmt)
    for k, base in enumerate(BASES):
        x3, y3 = _oracle_points(base)
        m, res = ref_mask_fn(x3, y3, jnp.ones(B, dtype=bool),
                             jnp.asarray(lo), jnp.asarray(hi),
                             jnp.int32(remaining[k]))
        np.testing.assert_array_equal(mask[k].numpy(), np.asarray(m))
        row = rows[k].numpy()
        assert row[0] == int(res.count)
        assert row[1] == int(res.ops)  # bases > B: no doubling lane
        np.testing.assert_array_equal(row[2:18], np.asarray(res.indices))
        np.testing.assert_array_equal(row[18:34], np.asarray(res.vbits))
    assert int((mask > 0).sum()) > 0


@pytest.fixture(scope="module")
def ref_step():
    return jpipeline.packed_xla_scan_step(
        JAddressFormat.P2PKH, "range", True, CHAIN, 2, False)


def _ref_rows(ref_step, table, bases, remaining):
    tx16, ty16, _, _ = table
    bx, by = _points(bases)
    lo, hi = _intervals(AddressFormat.P2PKH)
    return np.asarray(ref_step(
        _to16(bx), _to16(by), jnp.asarray(tx16), jnp.asarray(ty16),
        jnp.asarray(remaining, dtype=jnp.int32), jnp.asarray(lo),
        jnp.asarray(hi)))


def test_fused_range_scan_step_rows_match_reference(table, ref_step):
    remaining = [B, 200]
    _, rows = _port_step(table, AddressFormat.P2PKH, BASES, remaining)
    ref = _ref_rows(ref_step, table, BASES, remaining)
    assert rows.shape == (2, pipeline.PACKED_WIDTH)
    np.testing.assert_array_equal(rows.numpy(), ref)  # row for row, exact


def test_ops_field_at_base_below_batch(table, ref_step):
    """A window whose base is <= B holds the doubling lane (dx == 0).  The
    port counts ops as clamp(remaining, 0, B) * 6 like the device path's
    _pack_tail; the XLA reference counts valid lanes * 6.  Every other
    field agrees."""
    bases = [B // 2, BASES[0]]
    _, rows = _port_step(table, AddressFormat.P2PKH, bases, [B, B])
    ref = _ref_rows(ref_step, table, bases, [B, B]).copy()
    assert rows[0, 1] == 6 * B and ref[0, 1] == 6 * (B - 1)
    ref[0, 1] = rows[0, 1]
    np.testing.assert_array_equal(rows.numpy(), ref)


@pytest.mark.parametrize("fmt", list(PATTERNS))
def test_reported_variants_derive_to_matches(table, fmt):
    """Each reported (index, variant bits) resolves through
    glv_bit_variant_keys to at least one key whose address matches the
    pattern (P2WPKH hashes what P2PKH hashes, with bech32 intervals)."""
    _, rows = _port_step(table, fmt, BASES, [B, B])
    assert int(rows[:, 0].sum()) > 0
    pat = Pattern(PATTERNS[fmt])
    gen = AddressGenerator(fmt)
    for k, base in enumerate(BASES):
        row = rows[k].numpy()
        for idx, bits in zip(row[2:18], row[18:34]):
            if idx < 0:
                continue
            keys = ec.glv_bit_variant_keys(base + 1 + int(idx), int(bits))
            assert any(pat.matches(gen.generate(c.to_bytes(32, "big")).address)
                       for c in keys)


def test_pack_tail_orders_and_pads():
    mask = torch.zeros((2, 64), dtype=torch.int32)
    mask[0, [3, 40, 7]] = torch.tensor([1, 32, 6], dtype=torch.int32)
    rows = fused.pack_tail(mask, torch.tensor([64, -5], dtype=torch.int32), 6)
    assert rows[0, :2].tolist() == [3, 64 * 6]
    assert rows[0, 2:6].tolist() == [40, 7, 3, -1]  # descending, -1 padded
    assert rows[0, 18:22].tolist() == [32, 6, 1, 0]
    assert rows[1].tolist() == [0, 0] + [-1] * 16 + [0] * 16


def test_unported_format_raises():
    z = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused.fused_range_scan_step(AddressFormat.ETHEREUM, z, z, z.T, z.T,
                                    z[:, :5], z[:, :5], z[:, 0])


def test_wrappers_never_run_plain_for_device_tensors():
    """A tensor that is not on the CPU goes to the kernel path, which
    checks it and raises here: there is no fallback to the plain version."""
    bx = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    tx = torch.zeros((8, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fused.batch_inverse_dx(bx, tx)
    with pytest.raises(ValueError, match="meta"):
        fused.range_glv_match(bx, bx, tx, tx, tx, bx[:, :5], bx[:, :5],
                              bx[:, 0])
