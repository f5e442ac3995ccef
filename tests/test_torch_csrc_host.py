"""The CUDA kernels' per-thread code, compiled for the host: the headers in
``vgen_tpu_torch/csrc`` also build as plain C++, so the bodies of kernels B
to E (``scan_lanes.cuh``) and the address encoders (``encode.cuh``) run
here through a small ctypes harness, one loop iteration per lane, and are
held against the plain PyTorch versions (which the other test files hold
against the JAX reference).  Exact: every value is an integer.  Needs a
host C++ compiler (``g++``), as the native scanner does."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import encode, fused, pipeline, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import tables

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler (g++)")

HARNESS = r"""
#include "p2tr_lanes.cuh"
extern "C" {
// per element e < n of (8, n) limb-major arrays
void h_field(int op, const uint32_t* a, const uint32_t* b, uint32_t* r, int n) {
  for (long e = 0; e < n; e++) {
    uint32_t x[8], y[8], z[8];
    vg::fe_load(x, a, n, e);
    vg::fe_load(y, b, n, e);
    if (op == 0) vg::fe_add(z, x, y);
    else if (op == 1) vg::fe_neg(z, x);
    else vg::fe_mul_small(z, x, (uint32_t)op);
    vg::fe_store(r, n, e, z);
  }
}
void h_lean_add(uint32_t* X, uint32_t* Y, uint32_t* Z, const uint32_t* x2,
                const uint32_t* y2, int32_t* ok, int n) {
  for (long e = 0; e < n; e++) {
    uint32_t a[8], b[8], c[8], u[8], v[8];
    vg::fe_load(a, X, n, e);
    vg::fe_load(b, Y, n, e);
    vg::fe_load(c, Z, n, e);
    vg::fe_load(u, x2, n, e);
    vg::fe_load(v, y2, n, e);
    ok[e] = vg::jacobian_add_affine_lean(a, b, c, u, v) ? 1 : 0;
    vg::fe_store(X, n, e, a);
    vg::fe_store(Y, n, e, b);
    vg::fe_store(Z, n, e, c);
  }
}
void h_taptweak(const uint32_t* x, uint32_t* t, int n) {
  for (long e = 0; e < n; e++) {
    uint32_t a[8], b[8];
    vg::fe_load(a, x, n, e);
    vg::taptweak_hash(b, a);
    vg::fe_store(t, n, e, b);
  }
}
void h_bech32m(const uint32_t* x, uint8_t* syms, int n) {
  for (long e = 0; e < n; e++) {
    uint32_t a[8];
    vg::fe_load(a, x, n, e);
    vg::bech32m_p2tr_symbols(syms + 59 * e, a);
  }
}
void h_ladder(const uint32_t* bx, const uint32_t* by, const uint32_t* tx,
              const uint32_t* ty, const uint32_t* inv, const uint32_t* table,
              uint32_t* X, uint32_t* Z, int32_t* ok, int K, int B) {
  const long N = (long)K * B;
  for (long e = 0; e < N; e++)
    ok[e] = vg::p2tr_ladder_lane(bx, by, tx, ty, inv, table, X, Z, B, N, e);
}
void h_ladder_affine(const uint32_t* x, const uint32_t* y,
                     const uint32_t* table, uint32_t* X, uint32_t* Z,
                     int32_t* ok, int N) {
  for (long e = 0; e < N; e++)
    ok[e] = vg::p2tr_ladder_affine_lane(x, y, table, X, Z, N, e);
}
void h_chain(const uint32_t* v, uint32_t* out, uint32_t* scratch, int N,
             int M) {
  const long T = N / M;
  for (long t = 0; t < T; t++)
    vg::inv_chain_thread(vg::GuardedInput{v, N}, out, scratch, N, T, M, t);
}
void h_p2tr_finish(int dfa_route, const uint32_t* X, const uint32_t* Z,
                   const uint32_t* zi, const int32_t* ok, const uint32_t* lo,
                   const uint32_t* hi, int n_slots, const int32_t* table,
                   const int32_t* accept, int width, int start,
                   const int32_t* rem, int32_t* out, int K, int B) {
  const long N = (long)K * B;
  const vg::Dfa dfa{table, accept, width, start};
  for (long e = 0; e < N; e++)
    out[e] = dfa_route
        ? vg::p2tr_dfa_lane(X, Z, zi, ok, dfa, rem, B, N, e)
        : vg::p2tr_range_lane(X, Z, zi, ok, lo, hi, n_slots, rem, B, N, e);
}
int h_base58(const uint32_t* h, uint8_t* syms) {
  return vg::base58check_symbols(syms, 0u, h);
}
void h_bech32(const uint32_t* h, uint8_t* syms) {
  vg::bech32_p2wpkh_symbols(syms, h);
}
void h_interval(int glv, const uint32_t* bx, const uint32_t* by,
                const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
                const uint32_t* lo, const uint32_t* hi, int n_slots,
                const int32_t* rem, int32_t* out, int K, int B) {
  const long N = (long)K * B;
  for (long e = 0; e < N; e++)
    out[e] = glv ? vg::range_glv_lane(bx, by, tx, ty, inv, lo, hi, n_slots,
                                      rem, B, N, e)
                 : vg::range_lane(bx, by, tx, ty, inv, lo, hi, n_slots, rem,
                                  B, N, e);
}
void h_dfa(int fmt, int glv, const uint32_t* bx, const uint32_t* by,
           const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
           const int32_t* table, const int32_t* accept, int width, int start,
           const int32_t* rem, int32_t* out, int K, int B) {
  const long N = (long)K * B;
  const vg::Dfa dfa{table, accept, width, start};
  for (long e = 0; e < N; e++) {
    if (fmt == vg::kFmtP2PKH)
      out[e] = glv ? vg::glv_dfa_lane<vg::kFmtP2PKH>(bx, by, tx, ty, inv, dfa,
                                                     rem, B, N, e)
                   : vg::dfa_lane<vg::kFmtP2PKH>(bx, by, tx, ty, inv, dfa,
                                                 rem, B, N, e);
    else
      out[e] = glv ? vg::glv_dfa_lane<vg::kFmtP2WPKH>(bx, by, tx, ty, inv,
                                                      dfa, rem, B, N, e)
                   : vg::dfa_lane<vg::kFmtP2WPKH>(bx, by, tx, ty, inv, dfa,
                                                  rem, B, N, e);
  }
}
}
"""

K, B = 2, 256
FORMATS = (AddressFormat.P2PKH, AddressFormat.P2WPKH)
fmt_ids = pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.value)
# window 0 is based below B, so it holds the doubling lane; window 1 is
# partial
BASES, REMAINING = [B // 2 + 1, 0xC0FFEE123456789], [B, B - 37]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("csrc_host")
    src, so = d / "harness.cc", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{build.CSRC}", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.h_base58.argtypes, lib.h_base58.restype = [p, p], i
    lib.h_bech32.argtypes, lib.h_bech32.restype = [p, p], None
    lib.h_interval.argtypes = [i] + [p] * 7 + [i, p, p, i, i]
    lib.h_interval.restype = None
    lib.h_dfa.argtypes = [i, i] + [p] * 7 + [i, i, p, p, i, i]
    lib.h_dfa.restype = None
    for name, args in (("h_field", [i, p, p, p, i]),
                       ("h_lean_add", [p] * 6 + [i]),
                       ("h_taptweak", [p, p, i]), ("h_bech32m", [p, p, i]),
                       ("h_ladder", [p] * 9 + [i, i]),
                       ("h_ladder_affine", [p] * 6 + [i]),
                       ("h_chain", [p, p, p, i, i]),
                       ("h_p2tr_finish", [i] + [p] * 6 + [i, p, p, i, i, p, p,
                                                          i, i])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy().view(np.uint32))


@pytest.fixture(scope="module")
def lanes():
    """(bx, by, tx, ty, inv, remaining) int32 tensors of the two windows."""
    tx, ty = tables.ig_table(B, "cpu")
    pts = [ec.scalar_mult(s) for s in BASES]
    bx = u256.as_i32(u256.from_ints([p[0] for p in pts]).T.copy())
    by = u256.as_i32(u256.from_ints([p[1] for p in pts]).T.copy())
    inv = fused.batch_inverse_dx(bx, tx)
    return bx, by, tx, ty, inv, torch.tensor(REMAINING, dtype=torch.int32)


def test_encoders_equal_plain(lib):
    """Base58Check symbols and length, and bech32 symbols, of 512 hash160s
    (with 1..12 leading zero bytes and an all-zero one among them)."""
    rng = np.random.default_rng(99)
    hs = [rng.bytes(20) for _ in range(512)]
    for j in range(12):
        hs[j] = b"\0" * (j + 1) + hs[j][j + 1:]
    hs[12] = b"\0" * 20
    w = np.array([[int.from_bytes(h[4 * i:4 * i + 4], "big") for i in range(5)]
                  for h in hs], dtype=np.uint32)
    words = [torch.from_numpy(w[:, i].astype(np.int64)) for i in range(5)]
    syms58, len58 = encode.base58check_symbols(0, words)
    syms32, _ = encode.bech32_p2wpkh_symbols(words)
    for j in range(len(hs)):
        row = np.ascontiguousarray(w[j])
        out = np.zeros(34, np.uint8)
        assert lib.h_base58(_ptr(row), _ptr(out)) == int(len58[j])
        np.testing.assert_array_equal(out, syms58[:, j].numpy())
        out = np.zeros(39, np.uint8)
        lib.h_bech32(_ptr(row), _ptr(out))
        np.testing.assert_array_equal(out, syms32[:, j].numpy())
    assert min(len58.tolist()) < 33


@pytest.mark.parametrize("glv", [False, True], ids=["C", "B"])
@fmt_ids
def test_interval_lanes_equal_plain(lib, lanes, fmt, glv):
    pat = Pattern({AddressFormat.P2PKH: "^1[A-H]",
                   AddressFormat.P2WPKH: "^bc1q[q-z]"}[fmt])
    ivs = pat.prefilter_intervals(fmt)[0]
    n_slots = pipeline.interval_slot_count(len(ivs))
    lo, hi = pipeline.intervals_to_words(ivs, n_slots=n_slots)
    bx, by, tx, ty, inv, rem = lanes
    plain = fused.range_glv_match_plain if glv else fused.range_match_plain
    want = plain(bx, by, tx, ty, inv, u256.as_i32(lo), u256.as_i32(hi),
                 rem).numpy()
    out = np.zeros((K, B), np.int32)
    lib.h_interval(int(glv), *(_ptr(_u32(t)) for t in (bx, by, tx, ty, inv)),
                   _ptr(lo), _ptr(hi), n_slots, _ptr(rem.numpy()), _ptr(out),
                   K, B)
    np.testing.assert_array_equal(out, want)
    assert int((want > 0).sum()) > 0


@pytest.mark.parametrize("src", ["c[a4]t", "q$", "(?i)^1lov", "a.{8}$"])
@pytest.mark.parametrize("glv", [False, True], ids=["D", "E"])
@fmt_ids
def test_dfa_lanes_equal_plain(lib, lanes, fmt, glv, src):
    """a.{8}$ has more than 256 states."""
    dfa = Pattern(src).device_dfa(fmt)
    table = np.ascontiguousarray(dfa.table.astype(np.int32))
    accept = np.ascontiguousarray(dfa.accept.astype(np.int32))
    bx, by, tx, ty, inv, rem = lanes
    plain = fused.glv_dfa_match_plain if glv else fused.dfa_match_plain
    want = plain(fmt, bx, by, tx, ty, inv, torch.from_numpy(table),
                 torch.from_numpy(accept), dfa.start, rem).numpy()
    out = np.zeros((K, B), np.int32)
    lib.h_dfa(fused._DFA_FMT_CODE[fmt], int(glv),
              *(_ptr(_u32(t)) for t in (bx, by, tx, ty, inv)),
              _ptr(table), _ptr(accept), table.shape[1], dfa.start,
              _ptr(rem.numpy()), _ptr(out), K, B)
    np.testing.assert_array_equal(out, want)


# -- P2TR: kernels F to I ----------------------------------------------------


def _rand_fe(rng, n, edge=()):
    vals = [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(n)]
    vals[:len(edge)] = edge
    return u256.as_i32(u256.from_ints(vals))


def _out_like(t: torch.Tensor) -> np.ndarray:
    return np.zeros(tuple(t.shape), np.uint32)


@pytest.mark.parametrize("op", ["add", "neg", "mul_small2", "mul_small977"])
def test_field_add_neg_mul_small_equal_plain(lib, op):
    from vgen_tpu_torch.ops import field

    rng = np.random.default_rng(31)
    edge = (0, 1, ec.P - 1, ec.P - 2, (1 << 255), ec.P - (1 << 32))
    a = _rand_fe(rng, 128, edge)
    b = _rand_fe(rng, 128, edge[::-1])
    a64, b64 = u256.to_i64(a), u256.to_i64(b)
    code, want = {
        "add": (0, lambda: field.add(a64, b64)),
        "neg": (1, lambda: field.neg(a64)),
        "mul_small2": (2, lambda: field.mul_small(a64, 2)),
        "mul_small977": (977, lambda: field.mul_small(a64, 977)),
    }[op]
    out = _out_like(a)
    lib.h_field(code, _ptr(_u32(a)), _ptr(_u32(b)), _ptr(out), 128)
    np.testing.assert_array_equal(out.astype(np.int64), want().numpy())


def test_lean_add_equal_plain(lib):
    """Random limbs, and lanes with H == 0 (x2 == X1 / Z1^2)."""
    from vgen_tpu_torch.ops import curve

    rng = np.random.default_rng(32)
    X, Y, Z, x2, y2 = (_rand_fe(rng, 64) for _ in range(5))
    Z[:, :4] = u256.as_i32(u256.from_ints([1] * 4))
    x2[:, :4] = X[:, :4]
    want = curve.jacobian_add_affine_lean(
        *(u256.to_i64(t) for t in (X, Y, Z, x2, y2)))
    io = [_u32(t).copy() for t in (X, Y, Z)]
    ok = np.zeros(64, np.int32)
    lib.h_lean_add(*(_ptr(a) for a in io), _ptr(_u32(x2)), _ptr(_u32(y2)),
                   _ptr(ok), 64)
    for got, w in zip(io, want[:3]):
        np.testing.assert_array_equal(got.astype(np.int64), w.numpy())
    np.testing.assert_array_equal(ok, want[3].numpy().astype(np.int32))
    assert ok[:4].tolist() == [0] * 4 and ok[4:].all()


def test_taptweak_and_bech32m_equal_plain(lib):
    from vgen_tpu_torch.ops import sha256

    rng = np.random.default_rng(33)
    x = _rand_fe(rng, 256, (0, ec.P - 1))
    t = _out_like(x)
    lib.h_taptweak(_ptr(_u32(x)), _ptr(t), 256)
    want = sha256.tagged_hash_32(fused.TAPTWEAK_MIDSTATE, u256.to_i64(x))
    np.testing.assert_array_equal(t.astype(np.int64), want.numpy())
    syms = np.zeros((256, 59), np.uint8)
    lib.h_bech32m(_ptr(_u32(x)), _ptr(syms), 256)
    want, length = encode.bech32m_p2tr_symbols(u256.to_i64(x))
    np.testing.assert_array_equal(syms.T, want.numpy())
    assert length.tolist() == [59] * 256


@pytest.fixture(scope="module")
def window_table():
    return tables.window_table("cpu")


def test_ladder_lanes_equal_plain(lib, lanes, window_table):
    """Kernel F (finish=True) on both windows, the doubling lane included."""
    bx, by, tx, ty, inv, _ = lanes
    X, Z, ok = fused.p2tr_ladder_plain(bx, by, tx, ty, inv, window_table)
    gX, gZ = _out_like(X), _out_like(Z)
    gok = np.zeros(K * B, np.int32)
    lib.h_ladder(*(_ptr(_u32(t)) for t in (bx, by, tx, ty, inv,
                                           window_table)),
                 _ptr(gX), _ptr(gZ), _ptr(gok), K, B)
    np.testing.assert_array_equal(gX, _u32(X))
    np.testing.assert_array_equal(gZ, _u32(Z))
    np.testing.assert_array_equal(gok, ok.numpy())
    assert gok[BASES[0] - 1] == 0 and gok.sum() == K * B - 1


def test_ladder_affine_lanes_equal_plain(lib, window_table):
    """Kernel F (finish=False) on 64 affine points of the oracle."""
    pts = [ec.scalar_mult(k) for k in range(1000, 1064)]
    x = u256.as_i32(u256.from_ints([p[0] for p in pts]))
    y = u256.as_i32(u256.from_ints([p[1] for p in pts]))
    X, Z, ok = fused.p2tr_ladder_affine_plain(x, y, window_table)
    gX, gZ, gok = _out_like(X), _out_like(Z), np.zeros(64, np.int32)
    lib.h_ladder_affine(_ptr(_u32(x)), _ptr(_u32(y)),
                        _ptr(_u32(window_table)), _ptr(gX), _ptr(gZ),
                        _ptr(gok), 64)
    np.testing.assert_array_equal(gX, _u32(X))
    np.testing.assert_array_equal(gZ, _u32(Z))
    np.testing.assert_array_equal(gok, ok.numpy())


def test_chain_equal_plain(lib):
    """Kernel G with zeros at lanes 0, 17 and 95: their inverses are 1."""
    rng = np.random.default_rng(34)
    v = _rand_fe(rng, 512)
    v[:, [0, 17, 95]] = 0
    want = fused.batch_inverse_chain_plain(v)
    out, scratch = _out_like(v), _out_like(v)
    lib.h_chain(_ptr(_u32(v)), _ptr(out), _ptr(scratch), 512,
                fused._chain_len(512))
    np.testing.assert_array_equal(out, _u32(want))
    got = u256.to_ints(out)
    assert [got[i] for i in (0, 17, 95)] == [1, 1, 1]


@pytest.fixture(scope="module")
def p2tr_lanes(lanes, window_table):
    """(X, Z, zi, ok, remaining) of the two windows, with ok and Z zeroed on
    a few extra lanes."""
    bx, by, tx, ty, inv, rem = lanes
    X, Z, ok = fused.p2tr_ladder_plain(bx, by, tx, ty, inv, window_table)
    ok[5] = 0
    Z[:, 6] = 0
    return X, Z, fused.batch_inverse_chain_plain(Z), ok, rem


@pytest.mark.parametrize("route", ["range", "dfa"], ids=["H", "I"])
def test_p2tr_finish_lanes_equal_plain(lib, p2tr_lanes, route):
    fmt = AddressFormat.P2TR
    X, Z, zi, ok, rem = p2tr_lanes
    if route == "range":
        ivs = Pattern("^bc1p[q-z]").prefilter_intervals(fmt)[0]
        lo, hi = pipeline.intervals_to_words(
            ivs, n_words=8, n_slots=pipeline.interval_slot_count(len(ivs)))
        want = fused.p2tr_finish_range_plain(
            X, Z, zi, ok, u256.as_i32(lo), u256.as_i32(hi), rem)
        table = accept = np.zeros(1, np.int32)
        width = start = 0
    else:
        lo = hi = np.zeros((1, 8), np.uint32)
        dfa = Pattern("q$").device_dfa(fmt)
        table = np.ascontiguousarray(dfa.table.astype(np.int32))
        accept = np.ascontiguousarray(dfa.accept.astype(np.int32))
        width, start = table.shape[1], dfa.start
        want = fused.p2tr_finish_match_plain(
            X, Z, zi, ok, torch.from_numpy(table), torch.from_numpy(accept),
            start, rem)
    out = np.zeros((K, B), np.int32)
    lib.h_p2tr_finish(int(route == "dfa"),
                      *(_ptr(_u32(t)) for t in (X, Z, zi)),
                      _ptr(ok.numpy()), _ptr(lo), _ptr(hi), lo.shape[0],
                      _ptr(table), _ptr(accept), width, start,
                      _ptr(rem.numpy()), _ptr(out), K, B)
    np.testing.assert_array_equal(out, want.numpy())
    assert 0 < int(want.sum())
    assert out.reshape(-1)[[5, 6, BASES[0] - 1]].tolist() == [0, 0, 0]
