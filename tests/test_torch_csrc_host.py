"""The CUDA kernels' per-thread code, compiled for the host: the headers in
``vgen_tpu_torch/csrc`` also build as plain C++, so the bodies of kernels B
to E (``scan_lanes.cuh``) for all five hash formats, the hashes
(``sha256.cuh``, ``keccak.cuh``) and the address encoders (``encode.cuh``)
run here through a small ctypes harness, one loop iteration per lane, and
are held against the plain PyTorch versions (which the other test files
hold against the JAX reference).  Exact: every value is an integer.  Needs
a host C++ compiler (``g++``), as the native scanner does."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
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
#include "p2tr_match_lanes.cuh"
#include "table_lanes.cuh"
extern "C" {
// per lane e < n: the table build's full mixed add (kind: what it met) and
// the Jacobian doubling, in place
void h_full_add(uint32_t* X, uint32_t* Y, uint32_t* Z, const uint32_t* x2,
                const uint32_t* y2, int32_t* kind, int n) {
  for (long e = 0; e < n; e++) {
    uint32_t a[8], b[8], c[8], u[8], v[8];
    vg::fe_load(a, X, n, e);
    vg::fe_load(b, Y, n, e);
    vg::fe_load(c, Z, n, e);
    vg::fe_load(u, x2, n, e);
    vg::fe_load(v, y2, n, e);
    kind[e] = (int32_t)vg::jacobian_add_affine_full(a, b, c, u, v);
    vg::fe_store(X, n, e, a);
    vg::fe_store(Y, n, e, b);
    vg::fe_store(Z, n, e, c);
  }
}
void h_double(uint32_t* X, uint32_t* Y, uint32_t* Z, int n) {
  for (long e = 0; e < n; e++) {
    uint32_t a[8], b[8], c[8];
    vg::fe_load(a, X, n, e);
    vg::fe_load(b, Y, n, e);
    vg::fe_load(c, Z, n, e);
    vg::jacobian_double(a, b, c);
    vg::fe_store(X, n, e, a);
    vg::fe_store(Y, n, e, b);
    vg::fe_store(Z, n, e, c);
  }
}
// kernel T1 over all steps, lane by lane as tables.cu orders them; returns
// the lanes that met infinity
int h_table_grow(uint32_t* X, uint32_t* Y, uint32_t* Z, const uint32_t* bases,
                 int R, int count, int steps) {
  const long NT = (long)R * count;
  int infinities = 0;
  for (long r = 0; r < R; r++)
    vg::table_first_column(X, Y, Z, bases, NT, count, steps, r);
  for (int s = 0; s < steps; s++) {
    const long n = 1L << s, width = n < count - n ? n : count - n;
    for (long r = 0; r < R; r++)
      for (long i = 0; i < width; i++)
        infinities += vg::table_grow_lane(X, Y, Z, bases, NT, count, steps, s,
                                          r, i) == vg::kInfinity;
  }
  return infinities;
}
void h_table_affine(const uint32_t* X, const uint32_t* Y, const uint32_t* zi,
                    uint32_t* out_x, uint32_t* out_y, int R, int count,
                    int ladder) {
  for (long r = 0; r < R; r++)
    for (long i = 0; i < count; i++)
      vg::table_affine_lane(X, Y, zi, out_x, out_y, (long)R * count, count,
                            ladder, r, i);
}
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
    ok[e] = vg::p2tr_ladder_lane<8, false>(bx, by, tx, ty, inv, table, X, Z, B,
                                           N, e);
}
void h_ladder_affine(const uint32_t* x, const uint32_t* y,
                     const uint32_t* table, uint32_t* X, uint32_t* Z,
                     int32_t* ok, int N) {
  for (long e = 0; e < N; e++)
    ok[e] = vg::p2tr_ladder_affine_lane<8, false>(x, y, table, X, Z, N, e);
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
        ? vg::probe::p2tr_dfa_lane(X, Z, zi, ok, dfa, rem, B, N, e)
        : vg::p2tr_range_lane(X, Z, zi, ok, lo, hi, n_slots, rem, B, N, e);
}
int h_base58(uint32_t version, const uint32_t* h, uint8_t* syms) {
  return vg::base58check_symbols(syms, version, h);
}
void h_bech32(const uint32_t* h, uint8_t* syms) {
  vg::bech32_p2wpkh_symbols(syms, h);
}
// per value e < n of (n, 5) words: the EIP-55 symbols and the script hash
void h_eip55(const uint32_t* h, uint8_t* syms, int n) {
  for (long e = 0; e < n; e++) vg::eip55_symbols(syms + 40 * e, h + 5 * e);
}
void h_script_hash(const uint32_t* h, uint32_t* out, int n) {
  for (long e = 0; e < n; e++) vg::script_hash(out + 5 * e, h + 5 * e);
}
// Keccak-f[1600] of n (n, 25) lane states in place
void h_keccak(uint64_t* a, int n) {
  for (long e = 0; e < n; e++) vg::keccak_f1600(a + 25 * e);
}
// per point e < n of (8, n) limb-major x, y: SHA-256 of 04 || x || y (8
// words) and the Ethereum account (5 words), (n, 8) and (n, 5)
void h_xy(const uint32_t* x, const uint32_t* y, uint32_t* st, uint32_t* acct,
          int n) {
  for (long e = 0; e < n; e++) {
    uint32_t a[8], b[8];
    vg::fe_load(a, x, n, e);
    vg::fe_load(b, y, n, e);
    vg::sha256_x65(st + 8 * e, a, b);
    vg::eth_account(acct + 5 * e, a, b);
  }
}
}  // extern "C"
template <int kFmt>
void interval_lanes(int glv, const uint32_t* bx, const uint32_t* by,
                    const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
                    const uint32_t* lo, const uint32_t* hi, int n_slots,
                    const int32_t* rem, int32_t* out, int K, int B) {
  const long N = (long)K * B;
  for (long e = 0; e < N; e++)
    out[e] = glv ? vg::range_glv_lane<kFmt>(bx, by, tx, ty, inv, lo, hi,
                                            n_slots, rem, B, N, e)
                 : vg::range_lane<kFmt>(bx, by, tx, ty, inv, lo, hi, n_slots,
                                        rem, B, N, e);
}
template <int kFmt>
void dfa_lanes(int glv, const uint32_t* bx, const uint32_t* by,
               const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
               const int32_t* table, const int32_t* accept, int width,
               int start, const int32_t* rem, int32_t* out, int K, int B) {
  const long N = (long)K * B;
  const vg::Dfa dfa{table, accept, width, start};
  for (long e = 0; e < N; e++)
    out[e] = glv ? vg::glv_dfa_lane<kFmt>(bx, by, tx, ty, inv, dfa, rem, B, N,
                                          e)
                 : vg::dfa_lane<kFmt>(bx, by, tx, ty, inv, dfa, rem, B, N, e);
}
extern "C" {
#define VG_FMT_SWITCH(fn, ...)                                              \
  switch (fmt) {                                                            \
    case vg::kFmtP2PKH: fn<vg::kFmtP2PKH>(__VA_ARGS__); break;              \
    case vg::kFmtP2WPKH: fn<vg::kFmtP2WPKH>(__VA_ARGS__); break;            \
    case vg::kFmtP2SHP2WPKH: fn<vg::kFmtP2SHP2WPKH>(__VA_ARGS__); break;    \
    case vg::kFmtP2PKHUncompressed:                                         \
      fn<vg::kFmtP2PKHUncompressed>(__VA_ARGS__); break;                    \
    case vg::kFmtEthereum: fn<vg::kFmtEthereum>(__VA_ARGS__); break;        \
  }
void h_interval(int fmt, int glv, const uint32_t* bx, const uint32_t* by,
                const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
                const uint32_t* lo, const uint32_t* hi, int n_slots,
                const int32_t* rem, int32_t* out, int K, int B) {
  VG_FMT_SWITCH(interval_lanes, glv, bx, by, tx, ty, inv, lo, hi, n_slots,
                rem, out, K, B)
}
void h_dfa(int fmt, int glv, const uint32_t* bx, const uint32_t* by,
           const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
           const int32_t* table, const int32_t* accept, int width, int start,
           const int32_t* rem, int32_t* out, int K, int B) {
  VG_FMT_SWITCH(dfa_lanes, glv, bx, by, tx, ty, inv, table, accept, width,
                start, rem, out, K, B)
}
}
"""

K, B = 2, 256
FORMATS = tuple(fused.FMT_CODE)
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
                    f"-I{build.CSRC}", f"-I{build.PROBES}", "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.h_base58.argtypes, lib.h_base58.restype = [ctypes.c_uint32, p, p], i
    lib.h_bech32.argtypes, lib.h_bech32.restype = [p, p], None
    lib.h_interval.argtypes = [i, i] + [p] * 7 + [i, p, p, i, i]
    lib.h_interval.restype = None
    lib.h_dfa.argtypes = [i, i] + [p] * 7 + [i, i, p, p, i, i]
    lib.h_dfa.restype = None
    lib.h_table_grow.argtypes = [p] * 4 + [i, i, i]
    lib.h_table_grow.restype = i
    for name, args in (("h_field", [i, p, p, p, i]),
                       ("h_full_add", [p] * 6 + [i]), ("h_double", [p] * 3 + [i]),
                       ("h_table_affine", [p] * 5 + [i, i, i]),
                       ("h_lean_add", [p] * 6 + [i]),
                       ("h_taptweak", [p, p, i]), ("h_bech32m", [p, p, i]),
                       ("h_ladder", [p] * 9 + [i, i]),
                       ("h_ladder_affine", [p] * 6 + [i]),
                       ("h_chain", [p, p, p, i, i]),
                       ("h_eip55", [p, p, i]), ("h_script_hash", [p, p, i]),
                       ("h_keccak", [p, i]), ("h_xy", [p, p, p, p, i]),
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


def _values():
    """(w (512, 5) uint32, the 5 word tensors): 512 random 20-byte values
    with 1..12 leading zero bytes and an all-zero one among them."""
    rng = np.random.default_rng(99)
    hs = [rng.bytes(20) for _ in range(512)]
    for j in range(12):
        hs[j] = b"\0" * (j + 1) + hs[j][j + 1:]
    hs[12] = b"\0" * 20
    w = np.array([[int.from_bytes(h[4 * i:4 * i + 4], "big") for i in range(5)]
                  for h in hs], dtype=np.uint32)
    return w, [torch.from_numpy(w[:, i].astype(np.int64)) for i in range(5)]


@pytest.mark.parametrize("version", [0, 5])
def test_encoders_equal_plain(lib, version):
    """Base58Check symbols and length (version 0: P2PKH and uncompressed,
    5: P2SH-P2WPKH, always 34 symbols), and bech32 symbols."""
    w, words = _values()
    syms58, len58 = encode.base58check_symbols(version, words)
    syms32, _ = encode.bech32_p2wpkh_symbols(words)
    for j in range(len(w)):
        row = np.ascontiguousarray(w[j])
        out = np.zeros(34, np.uint8)
        assert lib.h_base58(version, _ptr(row), _ptr(out)) == int(len58[j])
        np.testing.assert_array_equal(out, syms58[:, j].numpy())
        out = np.zeros(39, np.uint8)
        lib.h_bech32(_ptr(row), _ptr(out))
        np.testing.assert_array_equal(out, syms32[:, j].numpy())
    if version == 0:
        assert min(len58.tolist()) < 33
    else:
        assert len58.tolist() == [34] * len(w)


def test_eip55_and_script_hash_equal_plain(lib):
    """EIP-55 symbols (a second Keccak-f over the lowercase hex) and the
    P2SH-P2WPKH script hash of 512 values."""
    w, words = _values()
    n = len(w)
    syms = np.zeros((n, 40), np.uint8)
    lib.h_eip55(_ptr(w), _ptr(syms), n)
    want, length = encode.eth_symbols(words)
    np.testing.assert_array_equal(syms.T, want.numpy())
    assert length.tolist() == [40] * n and int((want >= 16).sum()) > 0
    out = np.zeros((n, 5), np.uint32)
    lib.h_script_hash(_ptr(w), _ptr(out), n)
    want = encode.script_hash_words(words)
    np.testing.assert_array_equal(out.T.astype(np.int64),
                                  torch.stack(want).numpy())


def test_keccak_f1600_equals_plain(lib):
    """64 random states, and the zero state, through the permutation."""
    from vgen_tpu_torch.ops import keccak

    rng = np.random.default_rng(98)
    a = rng.integers(0, 1 << 64, size=(65, 25), dtype=np.uint64)
    a[0] = 0
    hi = torch.from_numpy((a >> np.uint64(32)).astype(np.int64).T.copy())
    lo = torch.from_numpy((a & np.uint64(0xFFFFFFFF)).astype(np.int64).T.copy())
    want_hi, want_lo = keccak.keccak_f1600(hi, lo)
    got = np.ascontiguousarray(a)
    lib.h_keccak(_ptr(got), 65)
    np.testing.assert_array_equal((got >> np.uint64(32)).astype(np.int64).T,
                                  want_hi.numpy())
    np.testing.assert_array_equal(
        (got & np.uint64(0xFFFFFFFF)).astype(np.int64).T, want_lo.numpy())


def test_sha256_x65_and_eth_account_equal_plain(lib):
    """SHA-256 of 04 || x || y and the Ethereum account of 128 points."""
    from vgen_tpu_torch.ops import keccak, sha256

    pts = [ec.scalar_mult(k) for k in range(7, 7 + 128 * 977, 977)]
    x = u256.as_i32(u256.from_ints([p[0] for p in pts]))
    y = u256.as_i32(u256.from_ints([p[1] for p in pts]))
    st = np.zeros((128, 8), np.uint32)
    acct = np.zeros((128, 5), np.uint32)
    lib.h_xy(_ptr(_u32(x)), _ptr(_u32(y)), _ptr(st), _ptr(acct), 128)
    x64, y64 = u256.to_i64(x), u256.to_i64(y)
    np.testing.assert_array_equal(
        st.T.astype(np.int64), torch.stack(sha256.sha256_x65_state(x64, y64)).numpy())
    np.testing.assert_array_equal(
        acct.T.astype(np.int64),
        torch.stack(keccak.eth_account_words_from_xy(x64, y64)).numpy())


@pytest.mark.parametrize("glv", [False, True], ids=["C", "B"])
@fmt_ids
def test_interval_lanes_equal_plain(lib, lanes, fmt, glv):
    pat = Pattern({AddressFormat.P2PKH: "^1[A-H]",
                   AddressFormat.P2WPKH: "^bc1q[q-z]",
                   AddressFormat.P2SH_P2WPKH: "^3[A-H]",
                   AddressFormat.P2PKH_UNCOMPRESSED: "^1[A-H]",
                   AddressFormat.ETHEREUM: "^0x[0-3]"}[fmt])
    ivs = pat.prefilter_intervals(fmt)[0]
    n_slots = pipeline.interval_slot_count(len(ivs))
    lo, hi = pipeline.intervals_to_words(ivs, n_slots=n_slots)
    bx, by, tx, ty, inv, rem = lanes
    plain = fused.range_glv_match_plain if glv else fused.range_match_plain
    want = plain(fmt, bx, by, tx, ty, inv, u256.as_i32(lo), u256.as_i32(hi),
                 rem).numpy()
    out = np.zeros((K, B), np.int32)
    lib.h_interval(fused.FMT_CODE[fmt], int(glv),
                   *(_ptr(_u32(t)) for t in (bx, by, tx, ty, inv)),
                   _ptr(lo), _ptr(hi), n_slots, _ptr(rem.numpy()), _ptr(out),
                   K, B)
    np.testing.assert_array_equal(out, want)
    assert int((want > 0).sum()) > 0


# (format, pattern): four patterns for P2PKH and P2WPKH, two for each
# format whose lanes cost more on the CPU; a.{8}$ has more than 256 states
DFA_CASES = [(f, src) for f in FORMATS[:2]
             for src in ("c[a4]t", "q$", "(?i)^1lov", "a.{8}$")] + [
    (AddressFormat.P2SH_P2WPKH, "c[a4]"), (AddressFormat.P2SH_P2WPKH, "a.{8}$"),
    (AddressFormat.P2PKH_UNCOMPRESSED, "(?i)^1lov"),
    (AddressFormat.P2PKH_UNCOMPRESSED, "a.{8}$"),
    (AddressFormat.ETHEREUM, "Ab$"), (AddressFormat.ETHEREUM, "(?i)^0xa.{6}$")]


@pytest.mark.parametrize("glv", [False, True], ids=["D", "E"])
@pytest.mark.parametrize("fmt,src", DFA_CASES,
                         ids=[f"{f.value}-{s}" for f, s in DFA_CASES])
def test_dfa_lanes_equal_plain(lib, lanes, fmt, glv, src):
    dfa = Pattern(src).device_dfa(fmt)
    table = np.ascontiguousarray(dfa.table.astype(np.int32))
    accept = np.ascontiguousarray(dfa.accept.astype(np.int32))
    bx, by, tx, ty, inv, rem = lanes
    plain = fused.glv_dfa_match_plain if glv else fused.dfa_match_plain
    want = plain(fmt, bx, by, tx, ty, inv, torch.from_numpy(table),
                 torch.from_numpy(accept), dfa.start, rem).numpy()
    out = np.zeros((K, B), np.int32)
    lib.h_dfa(fused.FMT_CODE[fmt], int(glv),
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


def test_full_add_and_double_equal_plain(lib):
    """The table build's mixed add (``table_lanes.cuh``) against
    ``curve.jacobian_add_affine`` on 64 random lanes, four doubling lanes
    (P == Q: the branch to the doubling) and four infinity lanes (P == -Q:
    Z3 = 0), with what each met; the Jacobian doubling on random lanes."""
    from vgen_tpu_torch.ops import curve

    rng = np.random.default_rng(35)
    cols = [u256.to_ints(_rand_fe(rng, 64)) for _ in range(5)]
    for j in range(8):
        q = ec.scalar_mult(1000 + 77 * j)
        pt = q if j < 4 else (q[0], ec.P - q[1])
        z = u256.to_ints(_rand_fe(rng, 1))[0] or 1
        for c, v in zip(cols, (pt[0] * z * z % ec.P, pt[1] * z ** 3 % ec.P,
                               z, q[0], q[1])):
            c.append(v)
    X, Y, Z, x2, y2 = (u256.as_i32(u256.from_ints(c)) for c in cols)
    want = curve.jacobian_add_affine(
        *(u256.to_i64(t) for t in (X, Y, Z, x2, y2)))
    io = [_u32(t).copy() for t in (X, Y, Z)]
    kind = np.zeros(72, np.int32)
    lib.h_full_add(*(_ptr(a) for a in io), _ptr(_u32(x2)), _ptr(_u32(y2)),
                   _ptr(kind), 72)
    for got, w in zip(io, want):
        np.testing.assert_array_equal(got.astype(np.int64), w.numpy())
    assert kind.tolist() == [0] * 64 + [1] * 4 + [2] * 4
    assert not io[2][:, 68:].any() and io[2][:, :68].any(axis=0).all()
    want = curve.jacobian_double(*(u256.to_i64(t) for t in (X, Y, Z)))
    io = [_u32(t).copy() for t in (X, Y, Z)]
    lib.h_double(*(_ptr(a) for a in io), 72)
    for got, w in zip(io, want):
        np.testing.assert_array_equal(got.astype(np.int64), w.numpy())


@pytest.mark.parametrize("count", [1, 100, 256])
def test_table_build_lanes_equal_plain(lib, count):
    """Kernels T1 (every step, lane by lane, from column 0) and T2 in both
    layouts on two rows (G and 7G), against their plain versions; and a
    base that is not 2^s G counted once as infinity."""
    chains = [tables._doubling_chain(p, fused.table_steps(count))
              for p in (ec.G, ec.scalar_mult(7))]
    b = u256.as_i32(tables._point_limbs(chains))
    R, steps = b.shape[:2]
    want = fused.table_grow_plain(b, count)
    io = [np.zeros((8, R * count), np.uint32) for _ in range(3)]
    assert lib.h_table_grow(*(_ptr(a) for a in io), _ptr(_u32(b)), R, count,
                            steps) == 0
    for got, w in zip(io, want):
        np.testing.assert_array_equal(got, _u32(w))
    X, Y, zi = want[0], want[1], fused.batch_inverse_chain_plain(want[2])
    tbl = np.zeros((R, count + 1, 2, 8), np.uint32)
    tbl[:, 0] = 7  # the filler rows are written to zero
    lib.h_table_affine(_ptr(_u32(X)), _ptr(_u32(Y)), _ptr(_u32(zi)),
                       _ptr(tbl), None, R, count, 1)
    np.testing.assert_array_equal(
        tbl, _u32(fused.table_affine_plain(X, Y, zi, R, True)))
    tx, ty = (np.zeros((8, count), np.uint32) for _ in range(2))
    row0 = [_u32(t[:, :count].contiguous()) for t in (X, Y, zi)]
    lib.h_table_affine(*(_ptr(a) for a in row0), _ptr(tx), _ptr(ty), 1, count,
                       0)
    wx, wy = fused.table_affine_plain(
        *(t[:, :count].contiguous() for t in (X, Y, zi)), 1, False)
    np.testing.assert_array_equal(tx, _u32(wx))
    np.testing.assert_array_equal(ty, _u32(wy))
    if count >= 4:  # G + (-G) at step 1
        bad = b.clone()
        bad[0, 1] = u256.as_i32(tables._point_limbs(
            [[(ec.G[0], ec.P - ec.G[1])]]))[0, 0]
        assert lib.h_table_grow(*(_ptr(a) for a in io), _ptr(_u32(bad)), R,
                                count, steps) == 1


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
