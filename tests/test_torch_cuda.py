"""The CUDA kernels against their plain versions on a card.  Marked
``cuda``; each test skips where no CUDA card is visible.  On the card
(where jax, which tests/conftest.py imports, may be missing):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.  Exact comparisons: the
values are integers."""

import numpy as np
import pytest
import torch

from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.crypto.address import AddressFormat
from vgen_tpu.pattern import Pattern
from vgen_tpu_torch.ops import fused, pipeline, u256
from vgen_tpu_torch.scan import tables

pytestmark = pytest.mark.cuda

K, B = 2, 4096


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)


def _points(bases):
    pts = [ec.scalar_mult_base_fast(s) for s in bases]
    return (u256.as_i32(u256.from_ints([p[0] for p in pts]).T),
            u256.as_i32(u256.from_ints([p[1] for p in pts]).T))


def test_batch_inverse_dx_kernel_equals_plain(dev):
    rng = np.random.default_rng(505)
    bx_i = [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(K)]
    tx_i = [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(B)]
    tx_i[17] = bx_i[0]  # a zero-dx lane
    bx = u256.as_i32(u256.from_ints(bx_i).T)
    tx = u256.as_i32(u256.from_ints(tx_i))
    before = fused.batch_inverse_dx.launches
    got = fused.batch_inverse_dx(bx.to(dev), tx.to(dev))
    torch.cuda.synchronize()
    assert fused.batch_inverse_dx.launches == before + 1
    assert torch.equal(got.cpu(), fused.batch_inverse_dx_plain(bx, tx))


def test_range_glv_step_kernel_equals_plain(dev):
    fmt = AddressFormat.P2PKH
    ivs = Pattern("^1C").match_intervals(fmt)
    lo, hi = (u256.as_i32(a) for a in pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs))))
    tx, ty = tables.ig_table(B, "cpu")
    bx, by = _points([0xABCDEF0123456789, 5])  # window 1 has a zero-dx lane
    rem = torch.tensor([B, B - 9], dtype=torch.int32)
    args = (bx, by, tx, ty, lo, hi, rem)
    got = fused.fused_range_scan_step(fmt, *(a.to(dev) for a in args))
    want = fused.fused_range_scan_step(fmt, *args)
    assert torch.equal(got.cpu(), want)
    assert int(want[:, 0].sum()) > 0


def _step_inputs():
    """The real table, one window based above B and one based at 5 (it
    holds the doubling lane), and a partial second window."""
    tx, ty = tables.ig_table(B, "cpu")
    bx, by = _points([0xABCDEF0123456789, 5])
    rem = torch.tensor([B, B - 9], dtype=torch.int32)
    return bx, by, tx, ty, rem


@pytest.mark.parametrize("fmt", [AddressFormat.P2PKH, AddressFormat.P2WPKH],
                         ids=lambda f: f.value)
def test_range_step_kernel_c_equals_plain(dev, fmt):
    src = {AddressFormat.P2PKH: "^1C", AddressFormat.P2WPKH: "^bc1qq"}[fmt]
    ivs = Pattern(src).match_intervals(fmt)
    lo, hi = (u256.as_i32(a) for a in pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs))))
    bx, by, tx, ty, rem = _step_inputs()
    args = (bx, by, tx, ty, lo, hi, rem)
    before = fused.range_match.launches
    got = fused.fused_range_mask_step(fmt, *(a.to(dev) for a in args),
                                      glv=False)
    torch.cuda.synchronize()
    assert fused.range_match.launches == before + 1
    want = fused.fused_range_mask_step(fmt, *args, glv=False)
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) > 0


@pytest.mark.parametrize("src", ["c[a4]t", "a.{8}$"])
@pytest.mark.parametrize("glv", [False, True], ids=["D", "E"])
@pytest.mark.parametrize("fmt", [AddressFormat.P2PKH, AddressFormat.P2WPKH],
                         ids=lambda f: f.value)
def test_dfa_step_kernels_d_e_equal_plain(dev, fmt, glv, src):
    """Masks and packed rows bit-equal; a.{8}$ has more than 256 states."""
    dfa = Pattern(src).device_dfa(fmt)
    table = torch.from_numpy(dfa.table.astype(np.int32))
    accept = torch.from_numpy(dfa.accept.astype(np.int32))
    bx, by, tx, ty, rem = _step_inputs()
    cpu = (bx, by, tx, ty, table, accept)
    gpu = tuple(a.to(dev) for a in cpu)
    kernel = fused.glv_dfa_match if glv else fused.dfa_match
    before = kernel.launches
    got = fused.fused_scan_mask_step(fmt, *gpu, dfa.start, rem.to(dev), glv)
    rows = fused.fused_scan_step(fmt, *gpu, dfa.start, rem.to(dev), glv)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got.cpu(),
                       fused.fused_scan_mask_step(fmt, *cpu, dfa.start, rem,
                                                  glv))
    assert torch.equal(rows.cpu(),
                       fused.fused_scan_step(fmt, *cpu, dfa.start, rem, glv))


def test_wrapper_rejects_bad_input(dev):
    bx = torch.zeros((K, 8), dtype=torch.int64, device=dev)
    tx = torch.zeros((8, B), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fused.batch_inverse_dx(bx, tx)
    with pytest.raises(ValueError):
        fused.batch_inverse_dx(bx.to(torch.int32), tx[:, ::2])
