"""The probe kernels' plain versions (``vgen_tpu_torch/probes``) against the
JAX package on the same numpy-seeded inputs: one repetition's output words
of each primitive and each field-multiply part against the JAX function it
stands for (called eagerly on the CPU, 16-bit limbs through
``u256.limbs32_to_16``), and each ``probe_issue`` chain against the same
expressions in ``jnp``.  Also: each tool exits non-zero without a card, a
wrapper raises for tensors off the CPU that are not CUDA tensors, and the
probe unit builds apart from the product's.  Exact: every value is an
integer (or an f32 bit pattern)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu.ops import curve as jcurve
from vgen_tpu.ops import encode as jencode
from vgen_tpu.ops import field as jfield
from vgen_tpu.ops import keccak as jkeccak
from vgen_tpu.ops import ripemd160 as jripemd
from vgen_tpu.ops import sha256 as jsha
from vgen_tpu.ops import u256 as ju256
from vgen_tpu_torch.crypto.secp256k1 import P
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import u256
from vgen_tpu_torch.probes import common
from vgen_tpu_torch.probes import microbench_fieldmul as fm
from vgen_tpu_torch.probes import microbench_vpu as vpu
from vgen_tpu_torch.probes import roofline

N = 64


@pytest.fixture(scope="module")
def ab():
    """a, b: (8, N) int32 field elements from a numpy seed, p - 1, 0 and 1
    among them."""
    a, b = common.inputs(N, seed=2026)
    for j, (x, y) in enumerate([(P - 1, P - 1), (0, 1), (1, P - 1)]):
        a[:, j] = u256.as_i32(u256.from_ints([x]))[:, 0]
        b[:, j] = u256.as_i32(u256.from_ints([y]))[:, 0]
    return a, b


def _np(t):
    return (t.to(torch.int64) & common.M32).numpy().astype(np.uint32)


def _j16(limbs32):
    """(8, N) uint32 32-bit limbs -> the JAX package's (16, N) limbs."""
    return jnp.asarray(u256.limbs32_to_16(limbs32))


def _ints32(rows):
    """A list or array of (N,) 32-bit word rows -> (n, N) int64."""
    return np.stack([np.asarray(r).astype(np.int64) for r in rows])


def _ints_mod_p(limbs16):
    """JAX (16, N) 16-bit limbs -> Python ints mod p."""
    return [v % P for v in u256.to_ints(u256.limbs16_to_32(np.asarray(limbs16)))]


def _port_out(name, a, b):
    out = roofline.primitive_out(name, u256.to_i64(a), u256.to_i64(b),
                                 roofline.dfa_table().to(torch.int64).reshape(-1))
    return np.stack([o.numpy() for o in out])


def _bytes_to_words(rows):
    """(4k, N) big-endian byte rows -> (k, N) words."""
    rows = np.asarray(rows).astype(np.int64)
    return np.stack([(rows[4 * i] << 24) | (rows[4 * i + 1] << 16)
                     | (rows[4 * i + 2] << 8) | rows[4 * i + 3]
                     for i in range(len(rows) // 4)])


def _reference(name, a, b):
    """The JAX package's output words of one repetition of primitive or
    field-multiply part ``name`` (None for a field element compared mod
    p, see ``_reference_mod_p``)."""
    an, bn = _np(a), _np(b)
    x, y = _j16(an), _j16(bn)
    parity = jnp.asarray(2 + (bn[0] & 1))
    words = [jnp.asarray(an[i]) for i in range(5)]
    if name == "hash160c":
        return _ints32(jencode.hash160_33_words_from_x(x, parity))
    if name == "scripthash":
        return _ints32(jencode.script_hash_words(words))
    if name == "hash160u":
        return _ints32(jencode.hash160_65_words_from_xy(x, y))
    if name == "keccak":
        return _ints32(jkeccak.eth_account_words_from_xy(x, y))
    if name == "tagged":
        data = np.stack([(an[7 - i // 4] >> (24 - 8 * (i % 4))) & 0xFF
                         for i in range(32)])
        st = _bytes_to_words(jsha.tagged_hash_32(
            jsha.tagged_midstate("TapTweak"), jnp.asarray(data)))
        return st[::-1]  # big-endian number, little-endian limbs
    if name == "b58syms":
        syms, length = jencode.base58check_symbols_words(0, words)
        return np.concatenate([np.asarray(syms).astype(np.int64),
                               np.asarray(length).astype(np.int64)[None]])
    if name == "ethsyms":
        acct = np.stack([(an[i // 4] >> (24 - 8 * (i % 4))) & 0xFF
                         for i in range(20)])
        return np.asarray(jencode.eth_symbols(jnp.asarray(acct))[0]).astype(
            np.int64)
    if name in roofline.DFA_PRIMITIVES:
        width = roofline.DFA_PRIMITIVES[name]
        flat = jnp.asarray(roofline.dfa_table().numpy().reshape(-1))
        idx = (jnp.asarray(bn[0]) % 64) * width + jnp.asarray(an[0]) % width
        return np.asarray(jnp.take(flat, idx.astype(jnp.int32)))[None]
    if name == "sha256":
        return _ints32(jsha.sha256_x33_state(x, parity))
    if name == "ripemd160":
        return _ints32(jripemd.ripemd160_sha_state_words(
            [jnp.asarray(an[i]) for i in range(8)]))
    if name == "mul_wide":
        return _ints32(u256.limbs16_to_32(np.asarray(ju256.mul_wide(x, y))))
    return None


def _reference_mod_p(name, a, b):
    """Field results as Python ints mod p."""
    an, bn = _np(a), _np(b)
    x, y = _j16(an), _j16(bn)
    if name in ("fe_mul", "ptx_mul"):
        return _ints_mod_p(jfield.mul_weak(x, y))
    if name in ("fe_sqr", "fe_sqr_dedicated"):
        return _ints_mod_p(jfield.square(x))
    if name == "fold":
        return _ints_mod_p(jfield._fold512(jnp.concatenate([x, y])))
    if name == "leanadd":
        X, Y, Z, ok = jcurve.jacobian_add_affine_lean(x, y, x, y, x)
        return [_ints_mod_p(v) for v in (X, Y, Z)] + [
            np.asarray(ok).astype(np.int64).tolist()]
    raise ValueError(name)


FIELD_RESULTS = ("fe_mul", "ptx_mul", "fe_sqr", "fe_sqr_dedicated", "fold")


@pytest.mark.parametrize("name", [p for p in roofline.PRIMITIVES
                                  if p != "empty"])
def test_primitive_equals_jax(ab, name):
    a, b = ab
    got = _port_out(name, a, b)
    if name in FIELD_RESULTS:
        assert u256.to_ints(got) == _reference_mod_p(name, a, b)
    elif name == "leanadd":
        want = _reference_mod_p(name, a, b)
        for i in range(3):
            assert u256.to_ints(got[8 * i:8 * i + 8]) == want[i]
        assert got[24].tolist() == want[3] and sum(want[3]) > N // 2
    else:
        want = _reference(name, a, b)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", list(fm.MODES))
def test_fieldmul_part_equals_jax(ab, mode):
    a, b = ab
    out = fm.fieldmul_out(mode, u256.to_i64(a), u256.to_i64(b))
    got = np.stack([o.numpy() for o in out])
    an, bn = _np(a).astype(object), _np(b).astype(object)
    if mode in FIELD_RESULTS:
        assert u256.to_ints(got) == _reference_mod_p(mode, a, b)
    elif mode == "nocarry":
        # column sums of the products' 32-bit halves, in Python ints
        cols = np.zeros((16, N), dtype=object)
        for i in range(8):
            for j in range(8):
                prod = an[i] * bn[j]
                cols[i + j] += prod & common.M32
                cols[i + j + 1] += prod >> 32
        np.testing.assert_array_equal(got[0::2] + (got[1::2] << 32),
                                      cols.astype(np.int64))
    elif mode == "carry":
        value = [sum(int(an[k % 8][e] + (bn[k % 8][e] << 4)) << (32 * k)
                     for k in range(16)) for e in range(N)]
        got_v = [sum(int(got[k][e]) << (32 * k) for k in range(17))
                 for e in range(N)]
        assert got_v == value
    else:
        np.testing.assert_array_equal(got, _reference(mode, a, b))


def _jnp_issue(op, chains, an, bn, reps):
    """The chains of ``probe_lanes.cuh`` issue_lane in jnp on uint32 (the
    FFMA chain in f64, where it is exact, then rounded to f32)."""
    r = [jnp.asarray(an[i]) for i in range(8)]
    if op == "ffma":
        with jax.enable_x64(True):
            m = 0.5 + jnp.asarray(bn[0] & 0xFFFF, jnp.float64) * 2.0 ** -18
            k = 0.25 + jnp.asarray(an[0] >> 16, jnp.float64) * 2.0 ** -18
            for c in range(chains):
                x = (0.25 + jnp.asarray(an[c] & 0xFFFF, jnp.float64) * 2.0 ** -18
                     ).astype(jnp.float32)
                for _ in range(2 * reps):
                    x = (x.astype(jnp.float64) * m + k).astype(jnp.float32)
                r[c] = jax.lax.bitcast_convert_type(x, jnp.uint32)
        return np.stack([np.asarray(v) for v in r])
    if op == "imad_wide":
        with jax.enable_x64(True):
            k = jnp.asarray(an[1] ^ bn[3], jnp.uint64)
            K = (k << 32) | (k ^ 0xFFFFFFFF)
            for c in range(chains):
                lo, hi = (jnp.asarray(v, jnp.uint64) for v in (an[c], bn[c]))
                x, y = lo | (hi << 32), hi | (lo << 32)
                for _ in range(reps):
                    x = (x & 0xFFFFFFFF) * (y >> 32) + K
                    y = (y & 0xFFFFFFFF) * (x >> 32) + K
                r[c] = ((x ^ (x >> 32) ^ y ^ (y >> 32)) & 0xFFFFFFFF).astype(
                    jnp.uint32)
        return np.stack([np.asarray(v) for v in r])

    def mulhi(x, y):
        xl, xh = x & 0xFFFF, x >> 16
        yl, yh = y & 0xFFFF, y >> 16
        mid = (xl * yl >> 16) + (xh * yl & 0xFFFF) + (xl * yh & 0xFFFF)
        return xh * yh + (xh * yl >> 16) + (xl * yh >> 16) + (mid >> 16)

    step = {"iadd3": lambda x, y, k: x + y + k,
            "lop3": lambda x, y, k: (x | y) ^ k,
            "shf": lambda x, y, k: (x << (k & 31)) | (y >> (32 - (k & 31))),
            "imad": lambda x, y, k: x * y + k,
            "imad_hi": lambda x, y, k: mulhi(x, y) + k}
    s0, s1 = {"lop3_imad": ("lop3", "imad"),
              "iadd3_lop3_shf": ("iadd3", "lop3")}.get(op, (op, op))
    k = jnp.asarray(an[1] ^ bn[3])  # one constant for every chain
    for c in range(chains):
        x, y = jnp.asarray(an[c]), jnp.asarray(bn[c])
        for _ in range(reps):
            x = step[s0](x, y, k)
            y = step[s1](y, x, k)
            if op == "iadd3_lop3_shf":
                x = step["shf"](x, y, k)
        r[c] = x ^ y
    return np.stack([np.asarray(v) for v in r])


@pytest.mark.parametrize("op,chains", vpu.instances(),
                         ids=[vpu.instance_name(*i) for i in vpu.instances()])
def test_issue_chains_equal_jnp(ab, op, chains):
    a, b = ab
    reps = 16
    got = _np(vpu.probe_issue(op, chains, a, b, reps))
    np.testing.assert_array_equal(got, _jnp_issue(op, chains, _np(a), _np(b),
                                                  reps))


@pytest.mark.parametrize("op", list(vpu.OPS))
def test_issue_chains_share_one_constant(ab, op):
    """Every chain folds in the same constant (FFMA: the same multiplier
    and addend), so that the card reads it from the operand reuse cache:
    two chains that start equal end equal (an FFMA chain starts from its
    limb of a's low half alone)."""
    a, b = (t.clone() for t in ab)
    if op == "ffma":
        a[1] = (a[0] & 0xFFFF) | (~a[0] & -0x10000)
        b[1] = ~b[0]
    else:
        a[1], b[1] = a[0], b[0]
    got = vpu.probe_issue(op, 2, a, b, 16)
    assert torch.equal(got[1], got[0])
    assert not torch.equal(got[0], a[0])


@pytest.mark.parametrize("tool", [roofline, vpu, fm],
                         ids=["roofline", "microbench_vpu",
                              "microbench_fieldmul"])
def test_tool_exits_without_a_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tool.main([])
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("call", [
    lambda a, b: roofline.probe_primitive("fe_mul", a, b,
                                          roofline.dfa_table().to("meta"), 8),
    lambda a, b: vpu.probe_issue("iadd3", 1, a, b, 8),
    lambda a, b: fm.probe_fieldmul("mul_wide", a, b, 8),
], ids=["probe_primitive", "probe_issue", "probe_fieldmul"])
def test_wrapper_raises_for_tensors_off_the_cpu(ab, call):
    """A tensor that is neither on the CPU nor on a card: no plain
    version, no launch, an error."""
    a, b = (t.to("meta") for t in ab)
    with pytest.raises(ValueError):
        call(a, b)


def test_probe_unit_builds_apart_from_the_product(tmp_path, monkeypatch):
    """The product's units stay kernels, p2tr and tables, and a probe
    source edit changes the probe library's name but not the product's."""
    assert build.UNITS == ("kernels", "p2tr", "tables")
    assert "probes" in build.PROBE_UNITS
    before = {u: build.library_path(u) for u in build.UNITS + ("probes",)}
    copy = tmp_path / "probes"
    copy.mkdir()
    for f in build.PROBES.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (copy / f.name).write_bytes(f.read_bytes())
    (copy / "probe_lanes.cuh").write_text(
        (copy / "probe_lanes.cuh").read_text() + "\n// edited\n")
    monkeypatch.setattr(build, "PROBES", copy)
    assert build.library_path("probes") != before["probes"]
    assert all(build.library_path(u) == before[u] for u in build.UNITS)
