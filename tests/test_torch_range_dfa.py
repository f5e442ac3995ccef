"""Kernels C (``range_match``), D (``dfa_match``) and E (``glv_dfa_match``)
and the interval and DFA steps on CPU tensors (plain versions) against the
JAX reference on oracle points (the i*G window sums from the Python
oracle): the mask stages ``pipeline.make_range_mask(fmt, glv=False)`` and
``make_format_mask(fmt, glv)``, and the packed rows of their tails
(``make_range_tail`` / ``make_format_tail``: mask + ``mask_to_result``,
the tail ``packed_xla_scan_step`` runs per window).  Exact: masks and rows
are integers.

The mask and tail comparisons run the reference eagerly on its word path
(``unroll=True``, the form the Pallas kernels trace through
``pallas_fused._symbols_for``), for every format and route.  The whole
steps, curve stage included, are held row for row against
``packed_xla_scan_step(fmt, kind, glv, 16, 2, False)`` jitted on XLA:CPU,
whose first call compiles for 15-40 s per step at B = 256: so one
format per route, kernel C on P2PKH and D on P2WPKH here, E on P2PKH in
``tests/test_torch_glv_dfa_step.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu.scan import tables as jtables
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.ops import fused, pipeline, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import tables

B = 256
BASES = [0x5EED5EED5EED, 0xC0FFEE123456789]  # both > B
REMAINING = [B, 200]
FORMATS = (AddressFormat.P2PKH, AddressFormat.P2WPKH)
INTERVAL = {AddressFormat.P2PKH: "^1C", AddressFormat.P2WPKH: "^bc1qq"}
DFA = {AddressFormat.P2PKH: "q$", AddressFormat.P2WPKH: "[ad][02-9]"}
fmt_ids = pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.value)


def _j(fmt):
    """The JAX package's AddressFormat of the port's ``fmt``."""
    return JAddressFormat(fmt.value)


def _points(bases):
    pts = [ec.scalar_mult(s) for s in bases]
    return (u256.as_i32(u256.from_ints([p[0] for p in pts]).T.copy()),
            u256.as_i32(u256.from_ints([p[1] for p in pts]).T.copy()))


def _intervals(fmt):
    ivs = Pattern(INTERVAL[fmt]).match_intervals(fmt)
    return pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs)))


def _dfa(fmt):
    return Pattern(DFA[fmt]).device_dfa(fmt)


@pytest.fixture(scope="module")
def port_inputs():
    tx, ty = tables.ig_table(B, "cpu")
    bx, by = _points(BASES)
    inv = fused.batch_inverse_dx(bx, tx)
    return bx, by, tx, ty, inv, torch.tensor(REMAINING, dtype=torch.int32)


@pytest.fixture(scope="module")
def oracle_points():
    """(x3, y3) (16, B) reference limbs of (base + 1 + i) * G, i < B, per
    base, from the Python oracle (no curve compile on the JAX side)."""
    out = []
    for base in BASES:
        bpt = ec.scalar_mult(base)
        pts = [ec.point_add(bpt, t) for t in ec.ig_table(B, start=1)]
        out.append(tuple(
            jnp.asarray(u256.limbs32_to_16(u256.from_ints([p[c] for p in pts])))
            for c in (0, 1)))
    return out


def _oracle_keys_matching(fmt, pat, base, remaining):
    gen = AddressGenerator(fmt)
    return [i for i in range(remaining) if pat.matches(
        gen.generate((base + 1 + i).to_bytes(32, "big")).address)]


@fmt_ids
def test_range_match_vs_make_range_mask(fmt, port_inputs, oracle_points):
    lo, hi = _intervals(fmt)
    mask = fused.range_match(*port_inputs[:5], u256.as_i32(lo),
                             u256.as_i32(hi), port_inputs[5])
    ref = jpipeline.make_range_mask(_j(fmt), glv=False, unroll=True)
    for k, (x3, y3) in enumerate(oracle_points):
        m, _ = ref(x3, y3, jnp.ones(B, dtype=bool), jnp.asarray(lo),
                   jnp.asarray(hi), jnp.int32(REMAINING[k]))
        np.testing.assert_array_equal(mask[k].numpy(), np.asarray(m))
    assert int(mask.sum()) > 0


@pytest.mark.parametrize("glv", [False, True], ids=["D", "E"])
@fmt_ids
def test_dfa_match_vs_make_format_mask(fmt, glv, port_inputs, oracle_points):
    dfa = _dfa(fmt)
    kernel = fused.glv_dfa_match if glv else fused.dfa_match
    mask = kernel(fmt, *port_inputs[:5], torch.from_numpy(dfa.table),
                  torch.from_numpy(dfa.accept.astype(np.int32)), dfa.start,
                  port_inputs[5])
    flat, accept = jpipeline.pad_device_dfa(dfa)
    ref = jpipeline.make_format_mask(_j(fmt), unroll=True, glv=glv)
    for k, (x3, y3) in enumerate(oracle_points):
        m, _ = ref(x3, y3, jnp.ones(B, dtype=bool), jnp.asarray(flat),
                   jnp.asarray(accept), jnp.int32(dfa.start),
                   jnp.int32(REMAINING[k]))
        np.testing.assert_array_equal(mask[k].numpy(), np.asarray(m))
    assert int((mask > 0).sum()) > 0
    if not glv:  # and against the oracle's addresses, key for key
        pat = Pattern(DFA[fmt])
        for k, base in enumerate(BASES):
            assert np.nonzero(mask[k].numpy())[0].tolist() == \
                _oracle_keys_matching(fmt, pat, base, REMAINING[k])


def _ref_rows(tail, oracle_points, margs):
    """The reference's packed rows [count, ops, idx x16, vbits x16] of its
    tail on the oracle points of each window."""
    rows = []
    for k, (x3, y3) in enumerate(oracle_points):
        res = tail(x3, y3, jnp.ones(B, dtype=bool), *margs,
                   jnp.int32(REMAINING[k]))
        rows.append(np.concatenate([[int(res.count), int(res.ops)],
                                    np.asarray(res.indices),
                                    np.asarray(res.vbits)]))
    return np.stack(rows)


@fmt_ids
def test_range_scan_step_rows_match_reference(fmt, port_inputs,
                                              oracle_points):
    """glv=False: kernel C and ops x 1, row for row."""
    bx, by, tx, ty, _, rem = port_inputs
    lo, hi = _intervals(fmt)
    rows = fused.fused_range_scan_step(fmt, bx, by, tx, ty, u256.as_i32(lo),
                                       u256.as_i32(hi), rem, glv=False)
    ref = _ref_rows(jpipeline.make_range_tail(_j(fmt), glv=False, unroll=True),
                    oracle_points, (jnp.asarray(lo), jnp.asarray(hi)))
    assert rows.shape == (2, pipeline.PACKED_WIDTH)
    np.testing.assert_array_equal(rows.numpy(), ref)
    assert rows[:, 1].tolist() == REMAINING


@pytest.mark.parametrize("glv", [False, True], ids=["D", "E"])
@fmt_ids
def test_dfa_scan_step_rows_match_reference(fmt, glv, port_inputs,
                                            oracle_points):
    """Kernel D (ops x 1) or E (ops x 6), row for row."""
    bx, by, tx, ty, _, rem = port_inputs
    dfa = _dfa(fmt)
    rows = fused.fused_scan_step(fmt, bx, by, tx, ty,
                                 torch.from_numpy(dfa.table),
                                 torch.from_numpy(dfa.accept.astype(np.int32)),
                                 dfa.start, rem, glv=glv)
    flat, accept = jpipeline.pad_device_dfa(dfa)
    ref = _ref_rows(jpipeline.make_format_tail(_j(fmt), unroll=True, glv=glv),
                    oracle_points,
                    (jnp.asarray(flat), jnp.asarray(accept),
                     jnp.int32(dfa.start)))
    np.testing.assert_array_equal(rows.numpy(), ref)
    assert int(rows[:, 0].sum()) > 0


def _to16(t):
    """(K, 8) int32 port limbs -> (K, 16) reference limbs."""
    return jnp.asarray(u256.limbs32_to_16(t.numpy().view(np.uint32).T).T)


@pytest.mark.parametrize("fmt,kind", [
    (AddressFormat.P2PKH, "range"), (AddressFormat.P2WPKH, "dfa")],
    ids=["C-p2pkh", "D-p2wpkh"])
def test_whole_step_rows_match_packed_xla_scan_step(fmt, kind, port_inputs):
    """Kernel A + C or D + pack, row for row against the reference's whole
    packed step (curve stage, tail and pack) at bases > B."""
    bx, by, tx, ty, _, rem = port_inputs
    tx16, ty16 = jtables.ig_table_limbs(B)
    if kind == "range":
        lo, hi = _intervals(fmt)
        rows = fused.fused_range_scan_step(
            fmt, bx, by, tx, ty, u256.as_i32(lo), u256.as_i32(hi), rem,
            glv=False)
        margs = (jnp.asarray(lo), jnp.asarray(hi))
    else:
        dfa = _dfa(fmt)
        rows = fused.fused_scan_step(
            fmt, bx, by, tx, ty, torch.from_numpy(dfa.table),
            torch.from_numpy(dfa.accept.astype(np.int32)), dfa.start, rem,
            glv=False)
        flat, accept = jpipeline.pad_device_dfa(dfa)
        margs = (jnp.asarray(flat), jnp.asarray(accept), jnp.int32(dfa.start))
    step = jpipeline.packed_xla_scan_step(_j(fmt), kind, False, 16, 2, False)
    ref = step(_to16(bx), _to16(by), jnp.asarray(tx16), jnp.asarray(ty16),
               jnp.asarray(REMAINING, dtype=jnp.int32), *margs)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref))
    assert int(rows[:, 0].sum()) > 0


@fmt_ids
def test_glv_dfa_bits_derive_to_matches(fmt, port_inputs):
    """Each bit of kernel E's mask resolves through glv_bit_variant_keys to
    a key whose address the pattern accepts, for a DFA of more than 256
    states too."""
    gen = AddressGenerator(fmt)
    for src in (DFA[fmt], "a.{8}$"):
        pat = Pattern(src)
        dfa = pat.device_dfa(fmt)
        mask = fused.glv_dfa_match(
            fmt, *port_inputs[:5], torch.from_numpy(dfa.table),
            torch.from_numpy(dfa.accept.astype(np.int32)), dfa.start,
            port_inputs[5])
        hits = 0
        for k, base in enumerate(BASES):
            for idx in np.nonzero(mask[k].numpy())[0]:
                bits = int(mask[k, idx])
                for bit in range(6):
                    if bits >> bit & 1:
                        keys = ec.glv_bit_variant_keys(
                            base + 1 + int(idx), 1 << bit, parity_exact=False)
                        assert any(pat.matches(gen.generate(
                            c.to_bytes(32, "big")).address) for c in keys)
                        hits += 1
        assert hits > 0


def test_dfa_wrappers_never_run_plain_for_device_tensors():
    """Kernels C, D and E: a tensor that is not on the CPU goes to the
    kernel path, which checks it and raises here."""
    bx = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    tx = torch.zeros((8, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fused.range_match(bx, bx, tx, tx, tx, bx[:, :5], bx[:, :5], bx[:, 0])
    table = torch.zeros((4, 60), dtype=torch.int32, device="meta")
    for kernel in (fused.dfa_match, fused.glv_dfa_match):
        with pytest.raises(ValueError, match="meta"):
            kernel(AddressFormat.P2PKH, bx, bx, tx, tx, tx, table,
                   table[:, 0], 0, bx[:, 0])
        with pytest.raises(ValueError, match="width"):
            kernel(AddressFormat.P2WPKH, bx, bx, tx, tx, tx, table,
                   table[:, 0], 0, bx[:, 0])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            kernel(AddressFormat.ETHEREUM, bx, bx, tx, tx, tx, table,
                   table[:, 0], 0, bx[:, 0])
