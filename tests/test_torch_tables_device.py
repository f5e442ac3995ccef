"""The i*G and ladder tables' build for the card (``scan/tables.py``
``build_multiples``: kernel T1's log-doubling steps, kernel G, kernel T2)
through the kernels' plain versions on the CPU, against the JAX package:
its curve helpers (run eagerly, without ``jax.jit``), its host tables
(``vgen_tpu.scan.tables.ig_table_limbs``, which its own
``tests/test_tables_device.py`` pins its device build to, and
``window_table_u32``) and, slow-marked as the reference marks its own, its
device build ``ig_table_jax``.  Exact: the values are integers, compared mod
p through the 16/32-bit limb converter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu.ops import curve as jcurve
from vgen_tpu.scan import tables as jtables
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.ops import curve, fused, u256
from vgen_tpu_torch.scan import tables


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(n)]


def _port(ints):
    """(8, n) int64 limbs of the port's plain versions."""
    return u256.to_i64(u256.as_i32(u256.from_ints(ints)))


def _jax(ints):
    """(16, n) uint32 16-bit limbs of the JAX package."""
    return jnp.asarray(u256.limbs32_to_16(u256.from_ints(ints)))


def _jax_ints(a):
    return [v % ec.P for v in u256.to_ints(u256.limbs16_to_32(np.asarray(a)))]


def _jacobian(pt, z):
    """A Jacobian representative (x z^2, y z^3, z) of the affine pt."""
    return pt[0] * z * z % ec.P, pt[1] * z ** 3 % ec.P, z


def _add_lanes():
    """(X1, Y1, Z1, x2, y2) as int lists: 64 random lanes, then 8 doubling
    lanes (P == Q) and 8 inverse lanes (P == -Q)."""
    rng = np.random.default_rng(1201)
    cols = [_rand(rng, 64) for _ in range(5)]
    for kind in ("double", "inverse"):
        for j in range(8):
            q = ec.scalar_mult(int(rng.integers(1, 1 << 62)))
            p = q if kind == "double" else (q[0], ec.P - q[1])
            X, Y, Z = _jacobian(p, _rand(rng, 1)[0] or 1)
            for c, v in zip(cols, (X, Y, Z, q[0], q[1])):
                c.append(v)
    return cols


def test_jacobian_add_affine_equals_jax():
    """The branch-free mixed add, its doubling and its infinity lanes."""
    cols = _add_lanes()
    got = curve.jacobian_add_affine(*(_port(c) for c in cols))
    want = jcurve.jacobian_add_affine(*(_jax(c) for c in cols))
    for g, w in zip(got, want):
        assert u256.to_ints(g) == _jax_ints(w)
    Z3 = u256.to_ints(got[2])
    assert Z3[72:80] == [0] * 8 and all(Z3[:72])
    # the doubling lanes hold 2Q
    for j in range(64, 72):
        X, Y, Z = (u256.to_ints(t[:, j:j + 1])[0] for t in got)
        zi = pow(Z, -1, ec.P)
        assert (X * zi * zi % ec.P, Y * zi ** 3 % ec.P) == ec.point_double(
            (cols[3][j], cols[4][j]))


def test_jacobian_double_equals_jax():
    rng = np.random.default_rng(1202)
    cols = [_rand(rng, 64) for _ in range(3)]
    got = curve.jacobian_double(*(_port(c) for c in cols))
    want = jcurve.jacobian_double(*(_jax(c) for c in cols))
    for g, w in zip(got, want):
        assert u256.to_ints(g) == _jax_ints(w)


def test_batch_jacobian_to_affine_equals_jax():
    """The tables' normalization as the CPU path runs it (kernel G's and
    T2's plain versions) against the JAX build's, B = 512 in chains of
    256."""
    rng = np.random.default_rng(1203)
    X, Y, Z = (_rand(rng, 512) for _ in range(3))
    Z = [z or 1 for z in Z]
    i32 = [u256.as_i32(u256.from_ints(c)) for c in (X, Y, Z)]
    got = fused.table_affine_plain(
        i32[0], i32[1], fused.batch_inverse_chain_plain(i32[2]), 1, False)
    want = jcurve.batch_jacobian_to_affine(_jax(X), _jax(Y), _jax(Z), 256)
    for g, w in zip(got, want):
        assert u256.to_ints(g) == _jax_ints(w)


def _limbs32(a16):
    return u256.as_i32(u256.limbs16_to_32(np.asarray(a16)))


@pytest.mark.parametrize("count", [1, 100, 256, 512, 4096])
def test_ig_build_equals_jax_host_table(count):
    """``build_multiples`` for P = G (T1, G, T2 through their plain
    versions): one column, a count that is no power of two, one that
    crosses a chain of 256, and the tests' largest batch."""
    tx, ty = tables.build_multiples([ec.G], count, "cpu")
    tx16, ty16 = jtables.ig_table_limbs(count)
    assert torch.equal(tx, _limbs32(tx16)) and torch.equal(ty, _limbs32(ty16))


@pytest.mark.slow
def test_ig_build_equals_jax_device_build():
    """The JAX package's own device build, ``ig_table_jax`` (its XLA:CPU
    compile takes minutes)."""
    tx, ty = tables.build_multiples([ec.G], 256, "cpu")
    jx, jy = jtables.ig_table_jax(256)
    assert torch.equal(tx, _limbs32(jx)) and torch.equal(ty, _limbs32(jy))


def test_ladder_build_8u_equals_jax_window_table():
    """The JAX package's 8-bit window table (32 windows of 256 entries,
    built on its host), from the card's builder in the ladder layout."""
    windows, entries = fused.ladder_shape(8, False)
    got = tables.build_multiples(tables.ladder_bases(8, False), entries - 1,
                                 "cpu", ladder=True)
    want16 = jtables.window_table_u32(8)  # (32, 256, 2, 16)
    want = u256.limbs16_to_32(np.moveaxis(want16, 3, 0))  # (8, 32, 256, 2)
    assert got.shape == (windows, entries, 2, 8)
    assert torch.equal(got, u256.as_i32(np.moveaxis(want, 0, 3)))


@pytest.mark.parametrize("schedule", [(6, True), (4, True)],
                         ids=["6s", "4s"])
def test_ladder_build_signed_equals_host_table(schedule):
    """Signed digits: 2^(bits-1) + 1 entries a window, the last window for
    the recoding's carry, against the port's host builder."""
    got = tables.build_multiples(tables.ladder_bases(*schedule),
                                 fused.ladder_shape(*schedule)[1] - 1, "cpu",
                                 ladder=True)
    assert torch.equal(got, u256.as_i32(tables.ladder_table_limbs(*schedule)))
    assert not got[:, 0].any()


def test_table_grow_counts_infinity_and_raises():
    """A base that is not 2^s P of its row: at step 1, G + (-G) is the point
    at infinity, which kernel G's zero guard would hide."""
    bases = [ec.G, (ec.G[0], ec.P - ec.G[1])]
    b = u256.as_i32(tables._point_limbs([bases]))
    with pytest.raises(ValueError, match="1 lanes met the point at infinity"):
        fused.table_grow(b, 4)


def test_table_launches():
    """At most ceil(log2 count) launches: the steps of up to 256 columns
    in one block per row, then one a step."""
    assert fused.table_launches(1) == [(0, 1)]
    assert fused.table_launches(100) == [(0, 7)]
    assert fused.table_launches(524288) == [(0, 9)] + [
        (s, s + 1) for s in range(9, 19)]
    assert len(fused.table_launches(32768)) == 7


def test_table_affine_layouts():
    """T2's plain version on two rows of the ladder layout equals one row
    each of the i*G layout, with the d = 0 entries zero."""
    X, Y, Z = fused.table_grow(u256.as_i32(tables._point_limbs(
        [tables._doubling_chain(p, 3) for p in (ec.G, ec.scalar_mult(7))])),
        5)
    zi = fused.batch_inverse_chain(Z)
    tbl = fused.table_affine(X, Y, zi, 2, ladder=True)
    assert tbl.shape == (2, 6, 2, 8) and not tbl[:, 0].any()
    for r, k in enumerate((1, 7)):
        tx, ty = fused.table_affine(X[:, 5 * r:5 * r + 5].contiguous(),
                                    Y[:, 5 * r:5 * r + 5].contiguous(),
                                    zi[:, 5 * r:5 * r + 5].contiguous(), 1,
                                    ladder=False)
        assert torch.equal(tbl[r, 1:, 0], tx.T) and torch.equal(
            tbl[r, 1:, 1], ty.T)
        assert u256.to_ints(tx) == [ec.scalar_mult(k * d)[0]
                                    for d in range(1, 6)]
    with pytest.raises(ValueError, match="one row"):
        fused.table_affine(X, Y, zi, 2, ladder=False)


def test_ig_table_on_the_cpu_takes_the_host_npz(tmp_path, monkeypatch):
    """On the CPU the table is the host build, written to and read from its
    npz; the card's build path writes none."""
    monkeypatch.setattr(tables, "CACHE_DIR", str(tmp_path))
    tx, ty = tables.ig_table(64, "cpu")
    path = tables.ig_table_path(64)
    assert path.startswith(str(tmp_path))
    with np.load(path) as z:
        assert torch.equal(tx, _limbs32(z["tx"]))
    tables.build_multiples([ec.G], 64, "cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "torch_ig_table_64.npz"]
    tx16, _ = jtables.ig_table_limbs(64)
    assert torch.equal(tx, _limbs32(tx16))


def test_cuda_device_without_a_card_raises(monkeypatch):
    """No fallback: a CUDA device with no card visible raises before any
    build, for both tables."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tables.ig_table(16, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tables.ladder_table("cuda:0")
