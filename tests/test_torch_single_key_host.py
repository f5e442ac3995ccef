"""Kernels C and D as the H100 runs them, compiled for the host: the
register walks of ``csrc/dfa.cuh`` (``base58check_walk``,
``bech32_p2wpkh_walk``, ``eip55_walk``) in both table forms, the product's
one tile per block (``csrc/scan_lanes.cuh`` ``single_key_tile``) and the
probe unit's persistent tile loop (``probes/single_key_lanes.cuh``
``single_key_tiles``) driven block by block and thread by thread as a
grid would run them, and kernel C's and D's lanes over them, held
against the plain PyTorch versions and against the
array-and-walk form that kernel E keeps (``base58check_symbols`` +
``dfa_walk``).  Also the narrow table (``fused.narrow_dfa``), the stage
bodies of ``probe_single_key`` and the wrappers' refusals.  On the host
``cp.async`` is a plain copy.  Exact: every value is an integer.  Needs a
host C++ compiler (``g++``), as the native scanner does."""

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
from vgen_tpu_torch.ops import fused, pipeline, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.probes import profile_dfa

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler (g++)")

HARNESS = r"""
#include "single_key_lanes.cuh"
using namespace vg;
using namespace vg::probe;
template <int kFmt, class D>
int walk_fmt(const D& dfa, const uint32_t* h) {
  return address_walk<kFmt>(dfa, h) ? 1 : 0;
}
template <class D>
int walk(int fmt, const D& dfa, const uint32_t* h) {
  switch (fmt) {
    case kFmtP2PKH: return walk_fmt<kFmtP2PKH>(dfa, h);
    case kFmtP2WPKH: return walk_fmt<kFmtP2WPKH>(dfa, h);
    case kFmtP2SHP2WPKH: return walk_fmt<kFmtP2SHP2WPKH>(dfa, h);
    case kFmtP2PKHUncompressed: return walk_fmt<kFmtP2PKHUncompressed>(dfa, h);
    default: return walk_fmt<kFmtEthereum>(dfa, h);
  }
}
// records every call: lane (k, b) must get its own rows
struct Recorder {
  const uint32_t* tx; const uint32_t* ty; const uint32_t* inv;
  long B; long N; int* calls; int* bad;
  template <class Then>
  int32_t operator()(int k, const LaneRows& rows, const Then& rows_read) const {
    // the lane's b from its tx word 0, which the test makes unique
    long b = -1;
    for (long j = 0; j < B; j++) if (tx[j] == rows.tx[0]) { b = j; break; }
    if (b < 0) { (*bad)++; rows_read(); return 0; }
    for (int i = 0; i < 8; i++)
      if (rows.tx[i * rows.stride] != tx[i * B + b] ||
          rows.ty[i * rows.stride] != ty[i * B + b] ||
          rows.inv[i * rows.inv_stride] != inv[i * N + k * B + b]) (*bad)++;
    rows_read();
    calls[k * B + b]++;
    return 1;
  }
};
// schedule 0: one tile per block over the (tiles per window, K) grid;
// 1, 2: the persistent loop over ``grid`` blocks, each thread of each in
// turn (2 with the prefetch through one stage buffer per block)
template <int kSchedule, class Lane>
void grid_run(const Lane& lane, const uint32_t* tx, const uint32_t* ty,
              const uint32_t* inv, const int32_t* rem, int32_t* out, int K,
              int B, int grid) {
  static uint32_t stage[kRowWords * kTileLanes];
  if (kSchedule == 0) {
    for (int k = 0; k < K; k++)
      for (int i = 0; i * kTileLanes < B; i++)
        for (int t = 0; t < kTileLanes; t++)
          single_key_tile(lane, tx, ty, inv, rem, out, K, B, k, i, t);
    return;
  }
  for (int block = 0; block < grid; block++)
    for (int t = 0; t < kTileLanes; t++)
      single_key_tiles<kSchedule == 2>(lane, tx, ty, inv, rem, out, K, B,
                                       block, grid, t, stage);
}
template <int kFmt>
void lanes_fmt(int kind, const uint32_t* bx, const uint32_t* by,
               const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
               const uint32_t* lo, const uint32_t* hi, int n_slots,
               const void* table, const void* accept, int width, int start,
               const int32_t* rem, int32_t* out, int K, int B, int grid) {
  if (kind == 0) {
    const SingleKeyLane<kFmt, IntervalHit> lane{bx, by, {lo, hi, n_slots}};
    grid_run<2>(lane, tx, ty, inv, rem, out, K, B, grid);
  } else if (kind == 1) {
    const DfaPlain<uint16_t, uint8_t> dfa{(const uint16_t*)table,
                                          (const uint8_t*)accept, width, start};
    const SingleKeyLane<kFmt, WalkHit<kFmt, DfaPlain<uint16_t, uint8_t>>>
        lane{bx, by, {dfa}};
    grid_run<0>(lane, tx, ty, inv, rem, out, K, B, grid);
  } else if (kind == 2) {
    const Dfa dfa{(const int32_t*)table, (const int32_t*)accept, width, start};
    const SingleKeyLane<kFmt, WalkHit<kFmt, Dfa>> lane{bx, by, {dfa}};
    grid_run<1>(lane, tx, ty, inv, rem, out, K, B, grid);
  } else {
    const DfaPlain<uint16_t, uint8_t> dfa{(const uint16_t*)table,
                                          (const uint8_t*)accept, width, start};
    const SingleKeyLane<kFmt, ArrayHit<kFmt, DfaPlain<uint16_t, uint8_t>>>
        lane{bx, by, {dfa}};
    grid_run<0>(lane, tx, ty, inv, rem, out, K, B, grid);
  }
}
template <int kStage>
void stage_run(int stage, const uint32_t* bx, const uint32_t* by,
               const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
               const int32_t* rem, int32_t* out, int K, int B, int grid) {
  if constexpr (kStage < kNumSingleKeyStages) {
    if (stage != kStage)
      return stage_run<kStage + 1>(stage, bx, by, tx, ty, inv, rem, out, K, B,
                                   grid);
    grid_run<0>(StageLane<kStage>{bx, by}, tx, ty, inv, rem, out, K, B, grid);
  }
}
extern "C" {
// values e < n of (n, 5) words: the register walk in the narrow form
// (narrow = 1) or the int32 one, and kernel E's form (symbols + dfa_walk)
void h_walks(int fmt, int narrow, const void* table, const void* accept,
             int width, int start, const uint32_t* h, int32_t* out, int n) {
  for (long e = 0; e < n; e++) {
    if (narrow) {
      const DfaPlain<uint16_t, uint8_t> d{(const uint16_t*)table,
                                          (const uint8_t*)accept, width, start};
      out[e] = walk(fmt, d, h + 5 * e);
    } else {
      const Dfa d{(const int32_t*)table, (const int32_t*)accept, width, start};
      out[e] = walk(fmt, d, h + 5 * e);
    }
  }
}
void h_symbols_walk(int fmt, const int32_t* table, const int32_t* accept,
                    int width, int start, const uint32_t* h, int32_t* out,
                    int n) {
  const Dfa d{table, accept, width, start};
  for (long e = 0; e < n; e++) {
    switch (fmt) {
      case kFmtP2WPKH: out[e] = address_matches<kFmtP2WPKH>(d, h + 5 * e); break;
      case kFmtEthereum: out[e] = address_matches<kFmtEthereum>(d, h + 5 * e); break;
      case kFmtP2SHP2WPKH: out[e] = address_matches<kFmtP2SHP2WPKH>(d, h + 5 * e); break;
      default: out[e] = address_matches<kFmtP2PKH>(d, h + 5 * e);
    }
  }
}
// the tile loop with the recording lane -> out, calls per lane, bad rows
void h_cover(int schedule, const uint32_t* tx, const uint32_t* ty,
             const uint32_t* inv, const int32_t* rem, int32_t* out,
             int* calls, int* bad, int K, int B, int grid) {
  const Recorder lane{tx, ty, inv, B, (long)K * B, calls, bad};
  if (schedule == 0) grid_run<0>(lane, tx, ty, inv, rem, out, K, B, grid);
  else if (schedule == 1) grid_run<1>(lane, tx, ty, inv, rem, out, K, B, grid);
  else grid_run<2>(lane, tx, ty, inv, rem, out, K, B, grid);
}
// kind 0: kernel C (persistent, prefetch); 1: kernel D, narrow table (one
// tile per block); 2: kernel D, int32 table (persistent); 3: kernel D,
// narrow table, the symbols in an array (one tile per block)
void h_lanes(int fmt, int kind, const uint32_t* bx, const uint32_t* by,
             const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
             const uint32_t* lo, const uint32_t* hi, int n_slots,
             const void* table, const void* accept, int width, int start,
             const int32_t* rem, int32_t* out, int K, int B, int grid) {
#define VG_LANES(F) lanes_fmt<F>(kind, bx, by, tx, ty, inv, lo, hi, n_slots, \
                                 table, accept, width, start, rem, out, K, B, \
                                 grid)
  switch (fmt) {
    case kFmtP2PKH: VG_LANES(kFmtP2PKH); break;
    case kFmtP2WPKH: VG_LANES(kFmtP2WPKH); break;
    case kFmtP2SHP2WPKH: VG_LANES(kFmtP2SHP2WPKH); break;
    case kFmtP2PKHUncompressed: VG_LANES(kFmtP2PKHUncompressed); break;
    case kFmtEthereum: VG_LANES(kFmtEthereum); break;
  }
}
void h_stage(int stage, const uint32_t* bx, const uint32_t* by,
             const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
             const int32_t* rem, int32_t* out, int K, int B, int grid) {
  stage_run<0>(stage, bx, by, tx, ty, inv, rem, out, K, B, grid);
}
}
"""

P2PKH, P2WPKH, P2SH, UNC, ETH = (
    AddressFormat.P2PKH, AddressFormat.P2WPKH, AddressFormat.P2SH_P2WPKH,
    AddressFormat.P2PKH_UNCOMPRESSED, AddressFormat.ETHEREUM)
FORMATS = tuple(fused.FMT_CODE)
fmt_ids = pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.value)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("single_key_host")
    src, so = d / "harness.cc", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{build.CSRC}", f"-I{build.PROBES}", "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("h_walks", [i, i, p, p, i, i, p, p, i]),
                       ("h_symbols_walk", [i, p, p, i, i, p, p, i]),
                       ("h_cover", [i] + [p] * 7 + [i, i, i]),
                       ("h_lanes", [i, i] + [p] * 7 + [i, p, p, i, i, p, p,
                                                       i, i, i]),
                       ("h_stage", [i] + [p] * 7 + [i, i, i])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, None
    return lib


def _ptr(a):
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy().view(np.uint32))


def _values(n=384, seed=77):
    """(n, 5) uint32 hash values with 0, 1, 2 and 3 leading zero bytes
    (version 0 then has 1-4 leading zero bytes of payload), and an all-zero
    one; and their 5 (n,) int64 word tensors."""
    rng = np.random.default_rng(seed)
    hs = [bytearray(rng.bytes(20)) for _ in range(n)]
    for j in range(n // 2):
        z = j % 4
        hs[j][:z] = b"\0" * z
        if z < 20 and hs[j][z] == 0:
            hs[j][z] = 1 + j % 255
    hs[-1] = bytearray(20)
    w = np.array([[int.from_bytes(bytes(h[4 * i:4 * i + 4]), "big")
                   for i in range(5)] for h in hs], dtype=np.uint32)
    return w, [torch.from_numpy(w[:, i].astype(np.int64)) for i in range(5)]


def counting_dfa(width, n_states=61, seed=5):
    """A hand-built DFA that counts: a digit d adds d % 3 + 1 to the state
    (mod n_states), the end-of-string column 7 and the padding column 11,
    so the number of each step shows in the state; accept a random half.
    Neither the end nor the padding column is a self-loop."""
    s = np.arange(n_states)[:, None]
    add = np.array([d % 3 + 1 for d in range(width - 2)] + [7, 11])
    table = ((s + add[None, :]) % n_states).astype(np.int32)
    accept = np.random.default_rng(seed).integers(0, 2, n_states)
    return table, accept.astype(np.int32), 3


def random_dfa(width, n_states, seed=6):
    """Every entry uniform over the states, end and padding columns too."""
    rng = np.random.default_rng(seed + n_states)
    table = rng.integers(0, n_states, size=(n_states, width), dtype=np.int32)
    return table, rng.integers(0, 2, n_states).astype(np.int32), 1


def pattern_dfa(src, fmt):
    dfa = Pattern(src).device_dfa(fmt)
    return (dfa.table.astype(np.int32), dfa.accept.astype(np.int32),
            int(dfa.start))


WALK_CASES = {
    P2PKH: ("counting", "random", "[Cc]at", "q$", "(?i)^1lov", "a.{7}$"),
    P2SH: ("counting", "random", "c[a4]"),
    UNC: ("counting", "random"),
    P2WPKH: ("counting", "random", "q$", "a.{6}$"),
    ETH: ("counting", "random", "Ab$", "(?i)^0xa.{6}$"),
}


def _dfa_case(fmt, src):
    width = pipeline.FORMAT_DFA_WIDTH[fmt]
    if src == "counting":
        return counting_dfa(width)
    if src == "random":
        return random_dfa(width, 97)
    return pattern_dfa(src, fmt)


def _walks(lib, fmt, dfa, w):
    """(register walk, narrow; register walk, int32; kernel E's form) of
    the values w on the host."""
    table, accept, start = dfa
    width, n = table.shape[1], len(w)
    ntab, nacc = (t.numpy() for t in fused.narrow_dfa(
        torch.from_numpy(table), torch.from_numpy(accept)))
    code = fused.FMT_CODE[fmt]
    outs = []
    for narrow, tab, acc in ((1, ntab, nacc), (0, table, accept)):
        out = np.zeros(n, np.int32)
        lib.h_walks(code, narrow, _ptr(np.ascontiguousarray(tab)),
                    _ptr(np.ascontiguousarray(acc)), width, start, _ptr(w),
                    _ptr(out), n)
        outs.append(out)
    out = np.zeros(n, np.int32)
    lib.h_symbols_walk(code, _ptr(table), _ptr(accept), width, start, _ptr(w),
                       _ptr(out), n)
    return outs + [out]


@pytest.mark.parametrize("fmt,src", [(f, s) for f, ss in WALK_CASES.items()
                                     for s in ss],
                         ids=[f"{f.value}-{s}" for f, ss in WALK_CASES.items()
                              for s in ss])
def test_register_walk_equals_symbols_and_walk(lib, fmt, src):
    """The register walk, narrow and int32, against base58check_symbols /
    bech32 / EIP-55 symbols + dfa_walk on the host and against the plain
    ``pipeline.dfa_matches``, on values with 0-3 leading zero bytes."""
    w, words = _values()
    dfa = _dfa_case(fmt, src)
    narrow, wide, arrays = _walks(lib, fmt, dfa, w)
    want = pipeline.dfa_matches(fmt, words, torch.from_numpy(dfa[0]),
                                torch.from_numpy(dfa[1]), dfa[2])
    np.testing.assert_array_equal(arrays, want.numpy().astype(np.int32))
    np.testing.assert_array_equal(wide, arrays)
    np.testing.assert_array_equal(narrow, arrays)
    if src in ("counting", "random"):
        assert 0 < int(want.sum()) < len(w)


def test_base58_shift_and_lengths_are_covered():
    """The values of the walk tests reach lengths 34 and 33 for version 0
    (a shift of 0 and 1: the predicate and a padding step) and only 34 for
    version 5."""
    _, words = _values()
    from vgen_tpu_torch.ops import encode

    len0 = set(encode.base58check_symbols(0, words)[1].tolist())
    len5 = set(encode.base58check_symbols(5, words)[1].tolist())
    assert {33, 34} <= len0 and len5 == {34}


@pytest.mark.parametrize("n_states", [1, 256, 257, 65536])
def test_narrow_table_equals_int32(n_states):
    """The narrow form holds every state number of an S-state table
    (uint16 bits in int16) and the accept flags as 0/1 bytes."""
    width = 60
    rng = np.random.default_rng(n_states)
    table = rng.integers(0, n_states, size=(n_states, width), dtype=np.int32)
    table[0, :2] = [0, n_states - 1]
    accept = rng.integers(0, 3, n_states).astype(np.int32)
    nt, na = fused.narrow_dfa(torch.from_numpy(table), torch.from_numpy(accept))
    assert nt.dtype == torch.int16 and na.dtype == torch.uint8
    np.testing.assert_array_equal(nt.numpy().view(np.uint16).astype(np.int32),
                                  table)
    np.testing.assert_array_equal(na.numpy(), (accept != 0).astype(np.uint8))
    for w in (60, 34, 24):
        want = ("shared" if n_states * (2 * w + 1) <= fused.DFA_SHARED_BUDGET
                else "global")
        assert fused.dfa_form(n_states, w) == want


def test_narrow_table_over_65536_states_raises():
    table = torch.zeros((65537, 24), dtype=torch.int32)
    with pytest.raises(ValueError, match="65536"):
        fused.narrow_dfa(table, torch.zeros(65537, dtype=torch.int32))
    assert fused.dfa_form(65537, 2) == "global"


@pytest.mark.parametrize("n_states", [257, 65536])
def test_large_tables_walk_alike(lib, n_states):
    """The register walk on random tables of 257 and 65,536 states: the
    narrow form, the int32 form and kernel E's form agree."""
    w, words = _values(n=64, seed=n_states)
    dfa = random_dfa(60, n_states)
    narrow, wide, arrays = _walks(lib, P2PKH, dfa, w)
    np.testing.assert_array_equal(wide, arrays)
    np.testing.assert_array_equal(narrow, arrays)


def _cover_inputs(K, B):
    """tx with a distinct word 0 per lane (the recorder finds b by it),
    random ty and inv."""
    rng = np.random.default_rng(K * 1000 + B)
    tx = rng.integers(0, 1 << 32, size=(8, B), dtype=np.uint32)
    tx[0] = rng.permutation(1 << 20)[:B].astype(np.uint32)
    ty = rng.integers(0, 1 << 32, size=(8, B), dtype=np.uint32)
    inv = rng.integers(0, 1 << 32, size=(8, K * B), dtype=np.uint32)
    return tx, ty, inv


@pytest.mark.parametrize("schedule", [0, 1, 2],
                         ids=["grid", "persistent", "prefetch"])
@pytest.mark.parametrize("K", range(1, 9))
def test_tile_loop_covers_every_lane_once(lib, K, schedule):
    """Under each schedule every lane b < min(remaining[k], B) of every
    window gets its own rows exactly once, every other lane b < B a 0, and
    a tile at or past remaining[k] no call: B = 700 (not a multiple of
    256), remaining 0, partial (inside a tile and on a tile's edge) and B,
    the persistent loop over grids of 1, 3 and 64 blocks (more than the
    tiles)."""
    B = 700
    tx, ty, inv = _cover_inputs(K, B)
    rem = np.array([[0, 300, B, 256, 1, B + 5, 511, 699][k % 8]
                    for k in range(K)], np.int32)
    for grid in (1, 3, 64):
        out = np.full((K, B), -1, np.int32)
        calls = np.zeros((K, B), np.int32)
        bad = np.zeros(1, np.int32)
        lib.h_cover(schedule, _ptr(tx), _ptr(ty), _ptr(inv), _ptr(rem),
                    _ptr(out), _ptr(calls), _ptr(bad), K, B, grid)
        live = np.arange(B)[None, :] < np.minimum(rem, B)[:, None]
        assert int(bad[0]) == 0
        np.testing.assert_array_equal(calls, live.astype(np.int32))
        np.testing.assert_array_equal(out, live.astype(np.int32))


# window 0 is based below B, so it holds the doubling lane; window 1 is
# partial
K_L, B_L = 2, 300
BASES, REMAINING = [B_L // 2 + 1, 0xC0FFEE123456789], [B_L, B_L - 37]


@pytest.fixture(scope="module")
def lanes():
    return profile_dfa.window_inputs(BASES, REMAINING, B_L, "cpu")


LANE_CASES = {P2PKH: ("^1[A-H]", "[a-k]$"), P2WPKH: ("^bc1q[q-z]", "q$"),
              P2SH: ("^3[A-H]", "c|[a-k]$"), UNC: ("^1[A-H]", "(?i)^1[a-c]"),
              ETH: ("^0x[0-3]", "[A-F]$")}


def _run_lanes(lib, fmt, kind, lanes, lo=None, hi=None, dfa=None, grid=5):
    bx, by, tx, ty, inv, rem = lanes
    out = np.full((K_L, B_L), -1, np.int32)
    none = np.zeros(1, np.uint32)
    table, accept, start = dfa if dfa is not None else (none, none, 0)
    width = table.shape[1] if dfa is not None else 0
    lib.h_lanes(fused.FMT_CODE[fmt], kind,
                *(_ptr(_u32(t)) for t in (bx, by, tx, ty, inv)),
                _ptr(lo if lo is not None else none),
                _ptr(hi if hi is not None else none),
                lo.shape[0] if lo is not None else 0,
                _ptr(np.ascontiguousarray(table)),
                _ptr(np.ascontiguousarray(accept)), width, start,
                _ptr(rem.numpy()), _ptr(out), K_L, B_L, grid)
    return out


@fmt_ids
def test_kernel_c_lanes_equal_plain(lib, lanes, fmt):
    """Kernel C's lane over the tile loop (with the prefetch) against
    ``range_match_plain``, doubling and out-of-window lanes included."""
    ivs = Pattern(LANE_CASES[fmt][0]).prefilter_intervals(fmt)[0]
    lo, hi = pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs)))
    want = fused.range_match_plain(fmt, *lanes[:5], u256.as_i32(lo),
                                   u256.as_i32(hi), lanes[5]).numpy()
    got = _run_lanes(lib, fmt, 0, lanes, lo=lo, hi=hi)
    np.testing.assert_array_equal(got, want)
    assert 0 < int(want.sum())
    assert int(want[0, BASES[0] - 1]) == 0 and not want[1, REMAINING[1]:].any()


@pytest.mark.parametrize("form", ["shared", "global", "shared-arrays"])
@fmt_ids
def test_kernel_d_lanes_equal_plain(lib, lanes, fmt, form):
    """Kernel D's lane in both table forms (the shared form one tile per
    block, the global one over the persistent loop) and with the symbols
    in a per-thread array, against ``dfa_match_plain``."""
    table, accept, start = pattern_dfa(LANE_CASES[fmt][1], fmt)
    want = fused.dfa_match_plain(fmt, *lanes[:5], torch.from_numpy(table),
                                 torch.from_numpy(accept), start,
                                 lanes[5]).numpy()
    if form.startswith("shared"):
        nt, na = fused.narrow_dfa(torch.from_numpy(table),
                                  torch.from_numpy(accept))
        dfa = (nt.numpy(), na.numpy(), start)
    else:
        dfa = (table, accept, start)
    kind = {"shared": 1, "global": 2, "shared-arrays": 3}[form]
    got = _run_lanes(lib, fmt, kind, lanes, dfa=dfa)
    np.testing.assert_array_equal(got, want)
    assert 0 < int(want.sum())


@pytest.mark.parametrize("mode", profile_dfa.STAGES)
def test_stage_bodies_equal_plain(lib, lanes, mode):
    """probe_single_key's stage bodies over the tile loop against
    ``profile_dfa.single_key_plain``."""
    want = profile_dfa.single_key_plain(mode, *lanes[:5], None, None, None,
                                        None, 0, lanes[5]).numpy()
    out = np.full((K_L, B_L), -1, np.int32)
    bx, by, tx, ty, inv, rem = lanes
    lib.h_stage(profile_dfa.MODES[mode],
                *(_ptr(_u32(t)) for t in (bx, by, tx, ty, inv)),
                _ptr(rem.numpy()), _ptr(out), K_L, B_L, 3)
    np.testing.assert_array_equal(out, want)
    assert int((want != 0).sum()) > B_L


def test_single_key_modes_follow_the_header():
    """profile_dfa.MODES are the header's SingleKeyMode codes, in order."""
    text = (build.PROBES / "single_key_lanes.cuh").read_text()
    body = text[text.index("enum SingleKeyMode {"):]
    names = [n.strip() for n in body[body.index("{") + 1:body.index("}")]
             .replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "kNumSingleKeyModes"
    assert len(names) - 1 == len(profile_dfa.MODES)
    assert list(profile_dfa.MODES.values()) == list(range(len(names) - 1))


def test_wrappers_refuse_what_they_do_not_take():
    """A tensor off the CPU that is no CUDA tensor never reaches a plain
    version; a table over the budget cannot take the shared form."""
    bx = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    tx = torch.zeros((8, 256), dtype=torch.int32, device="meta")
    table = torch.zeros((600, 60), dtype=torch.int32, device="meta")
    for form in (None, "shared", "global"):
        with pytest.raises(ValueError, match="meta"):
            fused.dfa_match(P2PKH, bx, bx, tx, tx, tx, table, table[:, 0], 0,
                            bx[:, 0], form=form)
    with pytest.raises(ValueError, match="meta"):
        profile_dfa.probe_single_key("finish", bx, bx, tx, tx, tx, bx[:, :5],
                                     bx[:, :5], table, table[:, 0], 0,
                                     bx[:, 0])
    with pytest.raises(ValueError, match="takes P2PKH"):
        profile_dfa.probe_single_key("finish", bx, bx, tx, tx, tx, bx[:, :5],
                                     bx[:, :5], table, table[:, 0], 0,
                                     bx[:, 0], fmt=ETH)
    with pytest.raises(ValueError, match="unknown mode"):
        profile_dfa.probe_single_key("walk", bx, bx, tx, tx, tx, bx[:, :5],
                                     bx[:, :5], table, table[:, 0], 0,
                                     bx[:, 0])
    assert fused.dfa_form(600, 60) == "global"
    assert fused.dfa_form(*Pattern("[Cc]at").device_dfa(P2PKH).table.shape) \
        == "shared"


def test_tool_exits_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        profile_dfa.main([])
    assert exc.value.code not in (0, None)


def test_scanner_builds_the_narrow_table_once(monkeypatch):
    """A range scan's DFA route builds the narrow table once per pattern
    (where the table takes the shared form), not per launch; a random
    scan (kernel E) and a table over the budget build none."""
    from vgen_tpu_torch.scan import scanner as sc
    from vgen_tpu_torch.scan.host import ScanConfig

    built = []
    real = fused.narrow_dfa
    monkeypatch.setattr(fused, "narrow_dfa",
                        lambda *a: built.append(a[0].shape) or real(*a))
    scn = sc.DeviceScanner(P2PKH, 256, "cpu", k_sub=2)
    for src, start, want in (("[Cc]at", 0x1000, 1), ("a.{8}$", 0x1000, 0),
                             ("Cat$", None, 0)):
        built.clear()
        cfg = ScanConfig(format=P2PKH, start=start,
                         end=None if start is None else start + 2047,
                         count=1 if start is None else 0)
        step = scn._plan(Pattern(src), cfg, glv=start is None).step
        assert len(built) == want
        bx = torch.zeros((2, 8), dtype=torch.int32)
        if start is not None:
            ec_pts = [ec.scalar_mult(s) for s in (start - 1, start + 255)]
            bx = u256.as_i32(u256.from_ints([p[0] for p in ec_pts]).T.copy())
            by = u256.as_i32(u256.from_ints([p[1] for p in ec_pts]).T.copy())
            step(bx, by, torch.tensor([256, 256], dtype=torch.int32))
            step(bx, by, torch.tensor([256, 100], dtype=torch.int32))
            assert len(built) == want
