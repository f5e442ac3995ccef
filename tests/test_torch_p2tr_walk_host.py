"""Kernel I as the H100 runs it, compiled for the host: the bech32m walk in
registers (``csrc/dfa.cuh`` ``bech32m_p2tr_walk``) in both table forms,
the P2TR tile driver (``csrc/p2tr_lanes.cuh`` ``p2tr_finish_tile``) run
block by block and thread by thread as the grid runs it, and kernel I's
lanes over it, held against the array-and-walk form of the per-lane kernel
(``bech32m_p2tr_symbols`` + ``dfa_walk``) and against the plain PyTorch
versions (``fused.p2tr_finish_match_plain``, which the other test files
hold against the JAX reference).  Also the narrow table at width 34, the
scanner's one narrow table per P2TR pattern, the wrapper's refusals and
the bodies of ``probe_p2tr_match``'s modes.  Exact: every value is an
integer.  Needs a host C++ compiler (``g++``), as the native scanner
does."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import encode, fused, pipeline, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.probes import profile_p2tr_match as ppm

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler (g++)")

HARNESS = r"""
#include "p2tr_match_lanes.cuh"
using namespace vg;
using namespace vg::probe;
// records every call: the test makes qx[0] the lane's flat index e
struct Recorder {
  int* calls;
  int32_t operator()(const uint32_t qx[8]) const {
    calls[qx[0]]++;
    return 1;
  }
};
// the (tiles per window, K) grid, each block's threads in turn
template <class Match>
void grid_run(const Match& match, const uint32_t* X, const uint32_t* Z,
              const uint32_t* zi, const int32_t* ok, const int32_t* rem,
              int32_t* out, int K, int B) {
  for (int k = 0; k < K; k++)
    for (int i = 0; i * kTileLanes < B; i++)
      for (int t = 0; t < kTileLanes; t++)
        p2tr_finish_tile(match, X, Z, zi, ok, rem, out, K, B, k, i, t);
}
// the walks over the tile driver: kPmPolymodWalk, kPmArrays, or else the
// product's (kPmBounded's body too)
template <class D>
void tile_walk(int mode, const D& dfa, const uint32_t* X, const uint32_t* Z,
               const uint32_t* zi, const int32_t* ok, const int32_t* rem,
               int32_t* out, int K, int B) {
  if (mode == kPmPolymodWalk)
    grid_run(Bech32mPolymodWalk<D>{dfa}, X, Z, zi, ok, rem, out, K, B);
  else if (mode == kPmArrays)
    grid_run(Bech32mArrays<D>{dfa}, X, Z, zi, ok, rem, out, K, B);
  else
    grid_run(Bech32mWalk<D>{dfa}, X, Z, zi, ok, rem, out, K, B);
}
extern "C" {
// x (8, n) limb-major: the register walk in the narrow form (narrow = 1) or
// the int32 one, and the array form (symbols + dfa_walk on the int32 table)
void h_walk(int narrow, const void* table, const void* accept, int width,
            int start, const uint32_t* x, int32_t* out, int n) {
  for (long e = 0; e < n; e++) {
    uint32_t a[8];
    fe_load(a, x, n, e);
    if (narrow) {
      const DfaPlain<uint16_t, uint8_t> d{(const uint16_t*)table,
                                          (const uint8_t*)accept, width, start};
      out[e] = bech32m_p2tr_walk(d, a) ? 1 : 0;
    } else {
      const Dfa d{(const int32_t*)table, (const int32_t*)accept, width, start};
      out[e] = bech32m_p2tr_walk(d, a) ? 1 : 0;
    }
  }
}
void h_symbols_walk(const int32_t* table, const int32_t* accept, int width,
                    int start, const uint32_t* x, int32_t* out, int n) {
  const Dfa d{table, accept, width, start};
  for (long e = 0; e < n; e++) {
    uint32_t a[8];
    uint8_t syms[kBech32mSyms];
    fe_load(a, x, n, e);
    bech32m_p2tr_symbols(syms, a);
    out[e] = dfa_walk(d, syms, kBech32mSyms, kBech32mSyms) ? 1 : 0;
  }
}
// the tile driver with the recording match -> out, calls per lane
void h_cover(const uint32_t* X, const uint32_t* Z, const uint32_t* zi,
             const int32_t* ok, const int32_t* rem, int32_t* out, int* calls,
             int K, int B) {
  grid_run(Recorder{calls}, X, Z, zi, ok, rem, out, K, B);
}
// kernel I's lanes over the tile driver.  mode: probe_p2tr_match's
// (p2tr_match_lanes.cuh P2trMatchMode) or -1, the product's register
// walk; narrow: the table form of the walks
void h_lanes(int mode, int narrow, const uint32_t* X, const uint32_t* Z,
             const uint32_t* zi, const int32_t* ok, const void* table,
             const void* accept, int width, int start, const int32_t* rem,
             int32_t* out, int K, int B) {
  if (mode == kPmQx) {
    grid_run(P2trStage<kPmQx>{}, X, Z, zi, ok, rem, out, K, B);
  } else if (mode == kPmChecksum) {
    grid_run(P2trStage<kPmChecksum>{}, X, Z, zi, ok, rem, out, K, B);
  } else if (mode == kPmPolymod) {
    grid_run(P2trStage<kPmPolymod>{}, X, Z, zi, ok, rem, out, K, B);
  } else if (mode == kPmLane) {
    const Dfa d{(const int32_t*)table, (const int32_t*)accept, width, start};
    const long N = (long)K * B;
    for (long e = 0; e < N; e++)
      out[e] = p2tr_dfa_lane(X, Z, zi, ok, d, rem, B, N, e);
  } else if (narrow) {
    const DfaPlain<uint16_t, uint8_t> d{(const uint16_t*)table,
                                        (const uint8_t*)accept, width, start};
    tile_walk(mode, d, X, Z, zi, ok, rem, out, K, B);
  } else {
    const Dfa d{(const int32_t*)table, (const int32_t*)accept, width, start};
    tile_walk(mode, d, X, Z, zi, ok, rem, out, K, B);
  }
}
}
"""

P2TR = AddressFormat.P2TR
WIDTH = pipeline.FORMAT_DFA_WIDTH[P2TR]
WALK_MODE = -1  # h_lanes: the product's register walk


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("p2tr_walk_host")
    src, so = d / "harness.cc", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{build.CSRC}", f"-I{build.PROBES}", "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("h_walk", [i, p, p, i, i, p, p, i]),
                       ("h_symbols_walk", [p, p, i, i, p, p, i]),
                       ("h_cover", [p] * 7 + [i, i]),
                       ("h_lanes", [i, i] + [p] * 6 + [i, i, p, p, i, i])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, None
    return lib


def _ptr(a):
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy().view(np.uint32))


def _xs(n=320, seed=34):
    """(8, n) uint32 limbs of n output keys' x: random below p, with 0,
    1, p - 1 and values whose top or bottom groups are all zero or all
    one."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    x[7] %= 0xFFFFFFFF  # below 2^256 - 2^224 < p
    x = x.astype(np.uint32)
    x[:, 0] = 0
    x[:, 1] = [1] + [0] * 7
    x[:, 2] = [0xFFFFFC2E] + [0xFFFFFFFF] * 7  # p - 1
    x[:, 2][1] = 0xFFFFFFFE
    x[7, 3], x[0, 4], x[7, 5] = 0, 0, 0xF8000000
    return x


def counting_dfa(width=WIDTH, n_states=61, seed=5):
    """A hand-built DFA that counts: a digit d adds d % 3 + 1 to the state
    (mod n_states), the end-of-string column 7 and the padding column 11,
    so the number of each step shows in the state; accept a random half.
    Neither the end nor the padding column is a self-loop."""
    s = np.arange(n_states)[:, None]
    add = np.array([d % 3 + 1 for d in range(width - 2)] + [7, 11])
    table = ((s + add[None, :]) % n_states).astype(np.int32)
    accept = np.random.default_rng(seed).integers(0, 2, n_states)
    return table, accept.astype(np.int32), 3


def random_dfa(n_states, width=WIDTH, seed=6):
    """Every entry uniform over the states, end and padding columns too."""
    rng = np.random.default_rng(seed + n_states)
    table = rng.integers(0, n_states, size=(n_states, width), dtype=np.int32)
    return table, rng.integers(0, 2, n_states).astype(np.int32), 1


def pattern_dfa(src):
    dfa = Pattern(src).device_dfa(P2TR)
    return (dfa.table.astype(np.int32), dfa.accept.astype(np.int32),
            int(dfa.start))


def _dfa_case(src):
    if src == "counting":
        return counting_dfa()
    if src.startswith("random"):
        return random_dfa(int(src.split()[1]))
    return pattern_dfa(src)


def _narrow(table, accept):
    nt, na = fused.narrow_dfa(torch.from_numpy(table), torch.from_numpy(accept))
    return nt.numpy(), na.numpy()


WALK_CASES = ("counting", "random 97", "random 300", "qq$", "q$", "^bc1pq",
              "a.{6}$", "[ac-h]d")


@pytest.mark.parametrize("src", WALK_CASES)
def test_bech32m_walk_equals_symbols_and_walk(lib, src):
    """The register walk, narrow and int32, against bech32m_p2tr_symbols +
    dfa_walk on the host and against the plain ``pipeline.dfa_walk`` of
    ``encode.bech32m_p2tr_symbols``."""
    x = _xs()
    table, accept, start = _dfa_case(src)
    n = x.shape[1]
    ntab, nacc = _narrow(table, accept)
    got = {}
    for narrow, tab, acc in ((1, ntab, nacc), (0, table, accept)):
        got[narrow] = np.zeros(n, np.int32)
        lib.h_walk(narrow, _ptr(np.ascontiguousarray(tab)),
                   _ptr(np.ascontiguousarray(acc)), WIDTH, start,
                   _ptr(np.ascontiguousarray(x)), _ptr(got[narrow]), n)
    arrays = np.zeros(n, np.int32)
    lib.h_symbols_walk(_ptr(table), _ptr(accept), WIDTH, start,
                       _ptr(np.ascontiguousarray(x)), _ptr(arrays), n)
    syms, length = encode.bech32m_p2tr_symbols(
        torch.from_numpy(x.astype(np.int64)))
    want = pipeline.dfa_walk(torch.from_numpy(table), torch.from_numpy(accept),
                             start, syms, length).numpy().astype(np.int32)
    np.testing.assert_array_equal(arrays, want)
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)
    if src in ("counting", "random 97", "q$"):
        assert 0 < int(want.sum()) < n


def test_counting_dfa_sees_sixty_steps_and_one_end(lib):
    """On the counting DFA the walk's final state is start + the digits'
    steps + 7 (one end-of-string step) and no padding step: the state
    count is prime and larger than any step, so a missing, extra or
    padding step moves it."""
    n_states = 1009
    table, accept, start = counting_dfa(n_states=n_states)
    accept = np.zeros(n_states, np.int32)
    x = _xs(n=64)
    syms, _ = encode.bech32m_p2tr_symbols(torch.from_numpy(x.astype(np.int64)))
    final = (start + (syms.numpy() % 3 + 1).sum(axis=0) + 7) % n_states
    for e in range(8):
        acc = accept.copy()
        acc[final[e]] = 1
        out = np.zeros(64, np.int32)
        lib.h_walk(0, _ptr(table), _ptr(acc), WIDTH, start,
                   _ptr(np.ascontiguousarray(x)), _ptr(out), 64)
        assert out[e] == 1
        assert int(out.sum()) == int((final == final[e]).sum())


@pytest.mark.parametrize("K", [1, 2, 3, 8])
def test_tile_driver_covers_every_lane_once(lib, K):
    """Block by block, every lane b < min(remaining[k], B) of every window
    with ok and Z != 0 gets one match call, every other lane b < B a 0
    and no call: B = 700 (not a multiple of 256), remaining 0, inside a
    tile, on a tile's edge, B and more than B."""
    B = 700
    N = K * B
    X = np.zeros((8, N), np.uint32)
    X[0] = np.arange(N, dtype=np.uint32)  # qx[0] = e, as Z = zi = 1
    Z = np.zeros((8, N), np.uint32)
    Z[0] = 1
    zi = Z.copy()
    ok = np.ones(N, np.int32)
    ok[5] = 0
    Z[0, min(9, N - 1)] = 0  # Z == 0: no call
    rem = np.array([[0, 300, B, 256, 1, B + 5, 511, 699][k % 8]
                    for k in range(K)], np.int32)
    out = np.full((K, B), -1, np.int32)
    calls = np.zeros(N, np.int32)
    lib.h_cover(_ptr(X), _ptr(Z), _ptr(zi), _ptr(ok), _ptr(rem), _ptr(out),
                _ptr(calls), K, B)
    live = np.arange(B)[None, :] < np.minimum(rem, B)[:, None]
    live = live.reshape(-1) & (ok != 0) & (Z[0] != 0)
    np.testing.assert_array_equal(calls, live.astype(np.int32))
    np.testing.assert_array_equal(out.reshape(-1), live.astype(np.int32))


K_L, B_L = 2, 300
REMAINING = [B_L, B_L - 37]


@pytest.fixture(scope="module")
def lanes():
    X, Z, zi, ok, rem = ppm.inputs("cpu", K_L, B_L, remaining=REMAINING)
    Z = Z.clone()
    Z[:, 17] = 0  # a lane with Z == 0
    return X, Z, zi, ok, rem


LANE_CASES = ("q$", "[ac-h]d", "counting", "random 97")


def _run_lanes(lib, mode, narrow, lanes, dfa):
    X, Z, zi, ok, rem = lanes
    table, accept, start = dfa
    if narrow:
        table, accept = _narrow(table, accept)
    out = np.full((K_L, B_L), -1, np.int32)
    lib.h_lanes(mode, narrow, *(_ptr(_u32(t)) for t in (X, Z, zi)),
                _ptr(ok.numpy()), _ptr(np.ascontiguousarray(table)),
                _ptr(np.ascontiguousarray(accept)), WIDTH, start,
                _ptr(rem.numpy()), _ptr(out), K_L, B_L)
    return out


@pytest.mark.parametrize("form", ["shared", "global"])
@pytest.mark.parametrize("src", LANE_CASES)
def test_kernel_i_lanes_equal_plain(lib, lanes, src, form):
    """Kernel I's lane over the tile driver, the register walk in both
    table forms, against ``p2tr_finish_match_plain``: a lane with ok 0, one
    with Z 0 and a partial window included."""
    dfa = _dfa_case(src)
    want = fused.p2tr_finish_match_plain(
        *lanes[:4], torch.from_numpy(dfa[0]), torch.from_numpy(dfa[1]),
        dfa[2], lanes[4]).numpy()
    got = _run_lanes(lib, WALK_MODE, int(form == "shared"), lanes, dfa)
    np.testing.assert_array_equal(got, want)
    assert 0 < int(want.sum())
    assert want[0, 0] == 0 and want[0, 17] == 0  # ok 0, Z 0
    assert not want[1, REMAINING[1]:].any()


PROBE_CASES = list(ppm.STAGES) + [f"{m}-{f}" for m in ppm.FORM_WALKS
                                  for f in fused.DFA_FORMS] + ["i_lane"]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_modes_equal_plain(lib, lanes, case):
    """probe_p2tr_match's bodies (the stages over the tile driver, the
    checksum by table lookups and by the polymod; the walks in both forms;
    the per-lane kernel I) against ``profile_p2tr_match.match_plain``;
    the wrapper takes the plain version for CPU tensors."""
    mode = case.split("-")[0]
    dfa = pattern_dfa("q$")
    dfa_t = (torch.from_numpy(dfa[0]), torch.from_numpy(dfa[1]), dfa[2])
    want = ppm.match_plain(mode, *lanes[:4], *dfa_t, lanes[4]).numpy()
    got = _run_lanes(lib, ppm.MODES[mode], int(case.endswith("shared")),
                     lanes, dfa)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(ppm.probe_p2tr_match(mode, *lanes[:4], *dfa_t,
                                            lanes[4]), torch.from_numpy(want))
    assert int((want != 0).sum()) > (0 if mode in ppm.WALKS else B_L)


def test_probe_modes_follow_the_header():
    """profile_p2tr_match.MODES are the header's P2trMatchMode codes, in
    order."""
    text = (build.PROBES / "p2tr_match_lanes.cuh").read_text()
    body = text[text.index("enum P2trMatchMode {"):]
    names = [n.strip() for n in body[body.index("{") + 1:body.index("}")]
             .replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "kNumP2trMatchModes"
    assert len(names) - 1 == len(ppm.MODES)
    assert list(ppm.MODES.values()) == list(range(len(names) - 1))


@pytest.mark.parametrize("n_states", [1, 236, 237, 238, 474, 475])
def test_narrow_table_at_width_34(lib, n_states):
    """At P2TR's width the narrow form walks as the int32 table does;
    kernel I takes the shared form up to kernel D's 16 KB budget (237
    states) and global above; the shared form may be forced up to its
    32 KB cap (474 states)."""
    table, accept, start = random_dfa(n_states)
    x = _xs(n=48, seed=n_states)
    outs = []
    for narrow, (tab, acc) in ((1, _narrow(table, accept)), (0, (table,
                                                                 accept))):
        out = np.zeros(48, np.int32)
        lib.h_walk(narrow, _ptr(np.ascontiguousarray(tab)),
                   _ptr(np.ascontiguousarray(acc)), WIDTH, 0,
                   _ptr(np.ascontiguousarray(x)), _ptr(out), 48)
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert fused.dfa_form(n_states, WIDTH) == (
        "shared" if n_states <= ppm.BUDGET_STATES else "global")
    fits = fused._narrow_bytes(n_states, WIDTH) <= fused.DFA_SHARED_MAX
    assert fits == (n_states <= ppm.CAP_STATES)
    assert ppm.BUDGET_STATES == 237 and ppm.CAP_STATES == 474


def test_scanner_builds_the_narrow_table_once_for_p2tr(monkeypatch):
    """The P2TR DFA route (random and range scans) builds the narrow table
    once per pattern where kernel I takes the shared form (up to kernel
    D's budget), and every step passes it to kernel I; a table over the
    budget builds none."""
    from vgen_tpu_torch.scan import scanner as sc
    from vgen_tpu_torch.scan.host import ScanConfig

    built, passed = [], []
    real = fused.narrow_dfa
    monkeypatch.setattr(fused, "narrow_dfa",
                        lambda *a: built.append(a[0].shape) or real(*a))
    monkeypatch.setattr(sc.tables, "ladder_table",
                        lambda dev, *a: torch.zeros(1, dtype=torch.int32))
    # kernels A, F, G stubbed: the steps reach kernel I's wrapper at once

    def ladder_zi(bx, by, tx, ty, wt):
        n = bx.shape[0] * tx.shape[1]
        z = torch.zeros((8, n), dtype=torch.int32)
        return z, z, z, torch.zeros(n, dtype=torch.int32)

    def finish_match(X, Z, zi, ok, table, accept, start, rem, narrow=None,
                     form=None):
        passed.append(narrow)
        return torch.zeros((rem.shape[0], X.shape[1] // rem.shape[0]),
                           dtype=torch.int32)

    monkeypatch.setattr(fused, "_p2tr_ladder_zi", ladder_zi)
    monkeypatch.setattr(fused, "p2tr_finish_match", finish_match)
    scn = sc.DeviceScanner(P2TR, 256, "cpu", k_sub=2)
    # a.{7}$: 258 states, over the budget, within the shared form's cap;
    # a.{8}$: 514, over both
    for src, start, want in (("qq$", 0x1000, 1), ("qq$", None, 1),
                             ("a.{7}$", 0x1000, 0), ("a.{8}$", 0x1000, 0)):
        built.clear()
        passed.clear()
        scn._routes.clear()  # plan afresh: the scanner keeps its routes
        cfg = ScanConfig(format=P2TR, start=start,
                         end=None if start is None else start + 2047,
                         count=1 if start is None else 0)
        route = scn._plan(Pattern(src), cfg, glv=False)
        assert len(built) == want
        bx = torch.zeros((2, 8), dtype=torch.int32)
        for rem in ([256, 256], [256, 100]):
            route.rows(bx, bx, torch.tensor(rem, dtype=torch.int32))
        route.mask_step(bx, bx, torch.tensor([256, 256], dtype=torch.int32))
        assert len(built) == want and len(passed) == 3
        assert all((n is None) == (want == 0) for n in passed)
        if want:
            assert all(n is passed[0] for n in passed)


def test_wrapper_refuses_what_it_does_not_take():
    """Kernel I's wrapper: a tensor off the CPU that is no CUDA tensor never
    reaches the plain version, in any form; the table-form choice it
    shares with kernel D refuses an unknown form, a shared form over the
    cap and a narrow table of the wrong type or shape."""
    X = torch.zeros((8, 512), dtype=torch.int32, device="meta")
    table = torch.zeros((3, WIDTH), dtype=torch.int32, device="meta")
    rem = torch.zeros(2, dtype=torch.int32, device="meta")
    for form in (None, "shared", "global", "texture"):
        with pytest.raises(ValueError, match="meta"):
            fused.p2tr_finish_match(X, X, X, X[0], table, table[:, 0], 0, rem,
                                    form=form)
    with pytest.raises(ValueError, match="meta"):
        ppm.probe_p2tr_match("qx", X, X, X, X[0], table, table[:, 0], 0, rem)
    with pytest.raises(ValueError, match="unknown mode"):
        ppm.probe_p2tr_match("walk", X, X, X, X[0], table, table[:, 0], 0, rem)
    t, a, _ = (torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for v in random_dfa(10))
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="table form 'texture'"):
        fused._table_form("p2tr_finish_match", t, a, None, "texture", cpu)
    big = torch.zeros((ppm.CAP_STATES + 1, WIDTH), dtype=torch.int32)
    with pytest.raises(ValueError, match="over the shared form"):
        fused._table_form("p2tr_finish_match", big, big[:, 0], None,
                          "shared", cpu)
    nt, na = fused.narrow_dfa(t, a)
    for bad in ((nt.to(torch.int32), na), (nt, na.to(torch.int32)),
                (nt[:5], na), (nt, na[:5])):
        with pytest.raises(ValueError, match="narrow"):
            fused._table_form("p2tr_finish_match", t, a, bad, "shared", cpu)
    got = fused._table_form("p2tr_finish_match", t, a, (nt, na), None, cpu)
    assert got[2] == "shared" and got[0] is nt
    got = fused._table_form("p2tr_finish_match", big, big[:, 0], None, None,
                            cpu)
    assert got[2] == "global" and got[0] is big
    big = torch.zeros((ppm.CAP_STATES, WIDTH), dtype=torch.int32)
    assert fused._table_form("p2tr_finish_match", big, big[:, 0], None,
                             None, cpu)[2] == "global"
    assert fused._table_form("p2tr_finish_match", big, big[:, 0], None,
                             "shared", cpu)[2] == "shared"


def test_tool_exits_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        ppm.main([])
    assert exc.value.code not in (0, None)
