"""The redesigned per-thread code of kernels A, F and G, compiled for the
host: the dedicated squaring ``fe_sqr`` (``csrc/field.cuh``), the ladder's
digit recoding and lanes at every window schedule ``csrc/p2tr.cu``
instances (``csrc/p2tr_lanes.cuh``), and the batch inversion's chain and
product tree (``csrc/scan_lanes.cuh``) driven by a host emulation of
``csrc/inv_block.cuh``'s block: each phase between two barriers runs for
every thread of the block before the next phase starts.  Held against the
plain PyTorch versions and the oracle's integers.  Exact: every value is an
integer.  Needs a host C++ compiler (``g++``), as the native scanner does."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import field, fused, u256
from vgen_tpu_torch.scan import tables

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler (g++)")

HARNESS = r"""
#include <vector>
#include "p2tr_lanes.cuh"
#define VG_WINDOWS(X)                                                      \
  X(8, false) X(12, false) X(13, false) X(14, false) X(13, true)         \
      X(14, true) X(15, true) X(16, true)
extern "C" {
// per element e < n of (8, n) limb-major arrays
void h_sqr(const uint32_t* a, uint32_t* r, int n) {
  for (long e = 0; e < n; e++) {
    uint32_t x[8];
    vg::fe_load(x, a, n, e);
    vg::fe_sqr(x, x);
    vg::fe_store(r, n, e, x);
  }
}
// the digits of t ((8, n)) of schedule (bits, sgn): |d| and neg (windows, n);
// -1 for a schedule that is not instanced
int h_digits(int bits, int sgn, const uint32_t* t, uint32_t* d, uint8_t* neg,
             int n) {
#define H_DIGITS(kBits, kSigned)                                          \
  if (bits == kBits && (sgn != 0) == kSigned) {                           \
    using W = vg::LadderWindows<kBits, kSigned>;                          \
    for (long e = 0; e < n; e++) {                                        \
      uint32_t a[8], carry = 0u;                                          \
      vg::fe_load(a, t, n, e);                                            \
      for (int w = 0; w < W::kWindows; w++) {                             \
        bool ng;                                                          \
        d[w * n + e] = vg::ladder_digit<kBits, kSigned>(a, carry, ng);    \
        neg[w * n + e] = ng ? 1 : 0;                                      \
      }                                                                   \
    }                                                                     \
    return W::kWindows;                                                   \
  }
  VG_WINDOWS(H_DIGITS)
  return -1;
}
int h_ladder_affine(int bits, int sgn, const uint32_t* x, const uint32_t* y,
                    const uint32_t* table, uint32_t* X, uint32_t* Z,
                    int32_t* ok, int n) {
#define H_AFFINE(kBits, kSigned)                                          \
  if (bits == kBits && (sgn != 0) == kSigned) {                           \
    for (long e = 0; e < n; e++)                                          \
      ok[e] = vg::p2tr_ladder_affine_lane<kBits, kSigned>(x, y, table, X, \
                                                          Z, n, e);       \
    return 0;                                                             \
  }
  VG_WINDOWS(H_AFFINE)
  return -1;
}
int h_ladder(int bits, int sgn, const uint32_t* bx, const uint32_t* by,
             const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
             const uint32_t* table, uint32_t* X, uint32_t* Z, int32_t* ok,
             int K, int B) {
  const long N = (long)K * B;
#define H_LADDER(kBits, kSigned)                                          \
  if (bits == kBits && (sgn != 0) == kSigned) {                           \
    for (long e = 0; e < N; e++)                                          \
      ok[e] = vg::p2tr_ladder_lane<kBits, kSigned>(bx, by, tx, ty, inv,   \
                                                   table, X, Z, B, N, e); \
    return 0;                                                             \
  }
  VG_WINDOWS(H_LADDER)
  return -1;
}
}  // extern "C"

// inv_block.cuh's blocks, one after another: each block's rounds of
// `round` chains (those inv_schedule gives a card of `sms` SMs) in turn,
// each round's forward chains, then its trees (the tree warp's round, on
// one lane), then its backward chains
template <class Input>
void inv_blocks(const Input& in, uint32_t* out, uint32_t* scratch, long N,
                int M, int G, int round, int sms) {
  const long T = N / M;
  const vg::Scratch prefixes{scratch};
  const vg::InvSchedule sched = vg::inv_schedule(T, round, sms);
  std::vector<uint32_t> leaf(8 * round), inner(8 * round);
  for (int b = 0; b < sched.blocks; b++)
    for (long r = b; r < sched.rounds; r += sched.blocks) {
      const long t0 = r * round;
      if (G == 1) {
        for (int x = 0; x < round && t0 + x < T; x++)
          vg::inv_chain_thread(in, out, N, prefixes, M, t0 + x);
        continue;
      }
      for (int x = 0; x < round; x++) {
        uint32_t acc[8];
        if (t0 + x < T) vg::inv_chain_forward(in, acc, prefixes, M, t0 + x);
        else vg::fe_set_one(acc);
        vg::fe_store(leaf.data(), round, x, acc);
      }
      vg::InvTree{leaf.data(), inner.data(), round, G}.round(round / G, 0, 1,
                                                             [] {});
      for (int x = 0; x < round && t0 + x < T; x++) {
        uint32_t acc[8];
        vg::fe_load(acc, leaf.data(), round, x);
        vg::inv_chain_backward(in, acc, out, N, prefixes, M, t0 + x);
      }
    }
}
extern "C" {
// kernel G's blocks (v (8, N)) or, with bx non-null, kernel A's (dx of
// bx (K, 8), tx = v (8, B), N = K * B) in rounds of `round` chains on a
// card of sms SMs
void h_inv_block(const uint32_t* bx, const uint32_t* v, uint32_t* out,
                 uint32_t* scratch, int N, int B, int M, int G, int round,
                 int sms) {
  const long T = N / M;
  if (bx) inv_blocks(vg::DxInput(bx, v, B, T), out, scratch, N, M, G, round, sms);
  else inv_blocks(vg::GuardedInput{v, N, T}, out, scratch, N, M, G, round, sms);
}
}  // extern "C"
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("ladder_tree_host")
    src, so = d / "harness.cc", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{build.CSRC}", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args, res in (
            ("h_sqr", [p, p, i], None),
            ("h_digits", [i, i, p, p, p, i], i),
            ("h_ladder_affine", [i, i] + [p] * 6 + [i], i),
            ("h_ladder", [i, i] + [p] * 9 + [i, i], i),
            ("h_inv_block", [p] * 4 + [i] * 6, None)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy().view(np.uint32))


def _limbs(vals) -> np.ndarray:
    """ints < 2^256 -> (8, n) uint32 limbs."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.ascontiguousarray(
        np.frombuffer(buf, dtype="<u4").reshape(len(vals), 8).T)


def _ints(a: np.ndarray):
    return [int.from_bytes(a[:, e].astype("<u4").tobytes(), "little")
            for e in range(a.shape[1])]


def _rand(rng, n, mod):
    return [int.from_bytes(rng.bytes(32), "big") % mod for _ in range(n)]


def test_fe_sqr_equals_square_on_edge_values(lib):
    """The dedicated squaring against ``field.square`` on canonical values
    (0, 1, p - 1, p - 2, 2^255, ...), and against the integers also on
    values at or above p, up to 2^256 - 1: its fold takes any 512-bit
    product and returns canonical limbs."""
    rng = np.random.default_rng(81)
    canon = [0, 1, 2, ec.P - 1, ec.P - 2, 1 << 255, ec.P - (1 << 32),
             (1 << 224) - 1, 0xFFFFFFFF] + _rand(rng, 119, ec.P)
    a = _limbs(canon)
    out = np.zeros_like(a)
    lib.h_sqr(_ptr(a), _ptr(out), a.shape[1])
    want = field.square(torch.from_numpy(a.astype(np.int64)))
    np.testing.assert_array_equal(out.astype(np.int64), want.numpy())
    assert _ints(out) == [v * v % ec.P for v in canon]
    wide = [ec.P, ec.P + 1, (1 << 256) - 1, (1 << 256) - 2, (1 << 256) - 977,
            (1 << 256) - (1 << 32)]
    a = _limbs(wide)
    out = np.zeros_like(a)
    lib.h_sqr(_ptr(a), _ptr(out), a.shape[1])
    assert _ints(out) == [v * v % ec.P for v in wide]


@pytest.mark.parametrize("schedule", fused.LADDER_WINDOWS,
                         ids=lambda s: f"{s[0]}{'s' if s[1] else 'u'}")
def test_digits_rebuild_t_and_equal_plain(lib, schedule):
    """``ladder_digit`` of every instanced schedule on random and extreme
    t: equal to ``fused.ladder_digits``; sum(+-|d| 2^(bits w)) = t; signed
    digits within 2^(bits-1), unsigned ones below 2^bits."""
    bits, signed = schedule
    rng = np.random.default_rng(82)
    ts = [0, 1, (1 << 256) - 1, ec.N - 1, int("80" * 32, 16),
          int("7f" * 32, 16)] + _rand(rng, 58, 1 << 256)
    t = _limbs(ts)
    windows, _ = fused.ladder_shape(bits, signed)
    d = np.zeros((windows, len(ts)), np.uint32)
    neg = np.zeros((windows, len(ts)), np.uint8)
    assert lib.h_digits(bits, int(signed), _ptr(t), _ptr(d), _ptr(neg),
                        len(ts)) == windows
    plain = fused.ladder_digits(torch.from_numpy(t.astype(np.int64)), bits,
                                signed)
    assert len(plain) == windows
    for w, (pd, pn) in enumerate(plain):
        np.testing.assert_array_equal(d[w].astype(np.int64), pd.numpy())
        np.testing.assert_array_equal(neg[w] != 0, pn.numpy())
    limit = (1 << (bits - 1)) if signed else (1 << bits) - 1
    assert int(d.max()) <= limit and (signed or not neg.any())
    for e, want in enumerate(ts):
        got = sum((-1 if neg[w, e] else 1) * int(d[w, e]) << (bits * w)
                  for w in range(windows))
        assert got == want


@pytest.fixture(scope="module")
def points():
    """64 oracle points, x and y (8, 64) int32: seeded keys, and three
    small keys whose first add meets H == 0 at 16 signed bits (10286: a
    doubling; 19463, 23277: the point at infinity)."""
    rng = np.random.default_rng(83)
    pts = [ec.scalar_mult(k) for k in _rand(rng, 61, ec.N)
           + [10286, 19463, 23277]]
    return (u256.as_i32(u256.from_ints([p[0] for p in pts])),
            u256.as_i32(u256.from_ints([p[1] for p in pts])))


@pytest.mark.parametrize("schedule", fused.LADDER_WINDOWS,
                         ids=lambda s: f"{s[0]}{'s' if s[1] else 'u'}")
def test_affine_ladder_lane_equals_plain(lib, points, schedule):
    """Kernel F's finish=False lane at every instanced schedule, bit-equal
    to ``p2tr_ladder_affine_plain`` with that schedule's table."""
    bits, signed = schedule
    wt = torch.from_numpy(tables.ladder_table_limbs(bits, signed)
                          .view(np.int32))
    x, y = points
    n = x.shape[1]
    X, Z = np.zeros((8, n), np.uint32), np.zeros((8, n), np.uint32)
    ok = np.zeros(n, np.int32)
    assert lib.h_ladder_affine(bits, int(signed), _ptr(_u32(x)), _ptr(_u32(y)),
                               _ptr(_u32(wt)), _ptr(X), _ptr(Z), _ptr(ok),
                               n) == 0
    want = fused.p2tr_ladder_affine_plain(x, y, wt)
    np.testing.assert_array_equal(X, _u32(want[0]))
    np.testing.assert_array_equal(Z, _u32(want[1]))
    np.testing.assert_array_equal(ok, want[2].numpy())
    assert ok.all()


def test_finish_ladder_lane_at_product_schedule_equals_plain(lib):
    """Kernel F's finish=True lane at the product's schedule on two windows
    of 64 lanes, window 0 holding the doubling lane (ok 0 there)."""
    bits, signed = fused.LADDER_WINDOW
    wt = tables.ladder_table("cpu")
    K, B, bases = 2, 64, [33, 0xC0FFEE123456789]
    tx, ty = tables.ig_table(B, "cpu")
    pts = [ec.scalar_mult(s) for s in bases]
    bx = u256.as_i32(u256.from_ints([p[0] for p in pts]).T.copy())
    by = u256.as_i32(u256.from_ints([p[1] for p in pts]).T.copy())
    inv = fused.batch_inverse_dx(bx, tx)
    X, Z = np.zeros((8, K * B), np.uint32), np.zeros((8, K * B), np.uint32)
    ok = np.zeros(K * B, np.int32)
    assert lib.h_ladder(bits, int(signed), *(
        _ptr(_u32(t)) for t in (bx, by, tx, ty, inv, wt)), _ptr(X), _ptr(Z),
        _ptr(ok), K, B) == 0
    want = fused.p2tr_ladder_plain(bx, by, tx, ty, inv, wt)
    np.testing.assert_array_equal(X, _u32(want[0]))
    np.testing.assert_array_equal(Z, _u32(want[1]))
    np.testing.assert_array_equal(ok, want[2].numpy())
    assert ok[bases[0] - 1] == 0 and ok.sum() == K * B - 1


def test_unknown_schedule_is_refused(lib, points):
    x, _ = points
    buf = np.zeros((8, 1), np.uint32)
    assert lib.h_digits(11, 0, _ptr(buf), _ptr(buf), _ptr(buf), 1) == -1
    assert lib.h_ladder_affine(8, 1, *(_ptr(buf) for _ in range(6)), 1) == -1


# (M, G, round, N): one inversion per chain; a warp; rounds of 256 and of
# 512; groups of 4; a chain of 1; and N = 512 at M = 64: 8 live chains of a
# round of 256 in a group of 256, the other 248 joining with a total of 1.
# On a card of one SM, so that a block walks up to 8 rounds.
GEOMETRIES = [(64, 1, 256, 4096), (16, 32, 256, 4096), (16, 256, 256, 4096),
              (8, 512, 512, 4096), (4, 4, 256, 4096), (1, 256, 256, 4096),
              (64, 256, 256, 512)]


def _block_equals_plain(lib, M, G, block, N, sms, seed=84):
    rng = np.random.default_rng(seed)
    vals = _rand(rng, N, ec.P)
    for dead in (0, 17, N - 1):
        vals[dead] = 0
    v = u256.as_i32(u256.from_ints(vals))
    out, scratch = np.zeros((8, N), np.uint32), np.zeros((8, N), np.uint32)
    lib.h_inv_block(None, _ptr(_u32(v)), _ptr(out), _ptr(scratch), N, N, M, G,
                    block, sms)
    np.testing.assert_array_equal(out, _u32(fused.batch_inverse_chain_plain(v)))
    got = _ints(out)
    assert [got[i] for i in (0, 17, N - 1)] == [1, 1, 1]
    assert all(a * g % ec.P == 1 for a, g in zip(vals, got) if a)
    K, B = 2, N // 2
    bx_i, tx_i = _rand(rng, K, ec.P), _rand(rng, B, ec.P)
    tx_i[5] = bx_i[1]  # dx == 0 at lane B + 5
    bx = u256.as_i32(u256.from_ints(bx_i).T.copy())
    tx = u256.as_i32(u256.from_ints(tx_i))
    out[:] = 0
    lib.h_inv_block(_ptr(_u32(bx)), _ptr(_u32(tx)), _ptr(out), _ptr(scratch),
                    N, B, M, G, block, sms)
    np.testing.assert_array_equal(out, _u32(fused.batch_inverse_dx_plain(bx,
                                                                         tx)))
    assert _ints(out)[B + 5] == 1


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=lambda g: "m{}g{}b{}n{}".format(*g))
def test_block_tree_equals_plain_with_zero_lanes(lib, geometry):
    """The blocks' rounds, emulated one after another (each round's
    forward chains, its product trees on one lane, its backward chains):
    kernel G's input with zeros at lanes 0, 17 and N - 1 (their inverses
    exactly 1) and kernel A's dx with a zero-dx lane, bit-equal to the
    plain versions at every geometry."""
    _block_equals_plain(lib, *geometry, sms=1)


# (M, G, round, N, sms): blocks of one round, of two, of three with the
# last two blocks a round short (10 rounds on 4 slots), of eight, of two
# rounds of 512 with the last block a round short, and of three with the
# last round partly past the last chain (T = 1380); kernel A's B = N / 2 is
# no power of two in the last three
ROUND_SHAPES = [(1, 8, 256, 4096, 8), (1, 32, 256, 4096, 4),
                (1, 256, 256, 2560, 2), (2, 16, 256, 8192, 1),
                (1, 512, 512, 5632, 7), (2, 64, 256, 2760, 1)]


@pytest.mark.parametrize("shape", ROUND_SHAPES,
                         ids=lambda g: "m{}g{}b{}n{}sms{}".format(*g))
def test_blocks_walking_rounds_equal_plain(lib, shape):
    """Blocks that walk one, two and more rounds, and last blocks a round
    short, through the schedule a card of so few SMs gives: bit-equal to
    the plain versions."""
    M, G, block, N, sms = shape
    _block_equals_plain(lib, M, G, block, N, sms, seed=86)


def test_tree_of_single_elements_inverts_each(lib):
    """A block of 8 threads of one element each in one group of 8: the
    tree alone does the work, and each output is its element's inverse."""
    rng = np.random.default_rng(85)
    vals = _rand(rng, 8, ec.P)
    v = u256.as_i32(u256.from_ints(vals))
    out, scratch = np.zeros((8, 8), np.uint32), np.zeros((8, 8), np.uint32)
    lib.h_inv_block(None, _ptr(_u32(v)), _ptr(out), _ptr(scratch), 8, 8, 1, 8,
                    8, 1)
    assert _ints(out) == [pow(a, -1, ec.P) for a in vals]
