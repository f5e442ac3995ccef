"""The probe kernels' per-thread bodies (``vgen_tpu_torch/probes/
probe_lanes.cuh`` and ``geometry_lanes.cuh``, which call the production
functions of ``csrc/``), compiled for the host with g++ as
``tests/test_torch_csrc_host.py`` does, against the plain versions, for
every instance of ``probe_primitive``, ``probe_issue`` and
``probe_fieldmul`` (over R repetitions), ``probe_glv_stage``,
``probe_vtile`` (over its grid of blocks), ``probe_rows`` and
``probe_layout``.  On the host
the carry chains of ``csrc/field.cuh`` keep their flag in a variable; the
card's PTX is held against the plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Exact: every value is an integer (or an f32 bit
pattern)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import fused, u256
from vgen_tpu_torch.probes import common
from vgen_tpu_torch.probes import microbench_fieldmul as fm
from vgen_tpu_torch.probes import microbench_layout as ml
from vgen_tpu_torch.probes import microbench_rows as mr
from vgen_tpu_torch.probes import microbench_vpu as vpu
from vgen_tpu_torch.probes import profile_glv as pg
from vgen_tpu_torch.probes import profile_ladder as pl
from vgen_tpu_torch.probes import proto_vtile as pv
from vgen_tpu_torch.probes import roofline
from vgen_tpu_torch.scan import tables

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler (g++)")

HARNESS = r"""
#include "geometry_lanes.cuh"
#include "ladder_stages.cuh"
using namespace vg;
using namespace vg::probe;
// kernel F's lane cut after stage, at 8-bit unsigned digits (the probe's
// instance on the card takes the product's 16-bit signed ones)
template <int S>
void ladder_stage(int s, const uint32_t* bx, const uint32_t* by,
                  const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
                  const uint32_t* table, uint32_t* X, uint32_t* Z, int32_t* ok,
                  long B, long N) {
  if constexpr (S < kNumLadderStages) {
    if (s != S) return ladder_stage<S + 1>(s, bx, by, tx, ty, inv, table, X, Z,
                                           ok, B, N);
    for (long e = 0; e < N; e++)
      ok[e] = ladder_stage_lane<S, 8, false>(bx, by, tx, ty, inv, table, X, Z,
                                             B, N, e);
  }
}
// per lane e < n of (8, n) limb-major a, b
template <class Body>
void lanes(const uint32_t* a, const uint32_t* b, uint32_t* out, long n,
           Body body) {
  for (long e = 0; e < n; e++) {
    uint32_t x[8], y[8], r[8];
    fe_load(x, a, n, e);
    fe_load(y, b, n, e);
    body(r, x, y);
    fe_store(out, n, e, r);
  }
}
template <int P>
void primitive(int p, const uint32_t* a, const uint32_t* b,
               const int32_t* table, uint32_t* out, int n, int reps) {
  if constexpr (P < kNumPrimitives) {
    if (p != P) return primitive<P + 1>(p, a, b, table, out, n, reps);
    lanes(a, b, out, n, [&](uint32_t* r, const uint32_t* x, const uint32_t* y) {
      primitive_lane<P>(r, x, y, table, reps);
    });
  }
}
template <int O, int C>
void issue_chains(int c, const uint32_t* a, const uint32_t* b, uint32_t* out,
                  int n, int reps) {
  if constexpr (C <= 8) {
    if (c != C) return issue_chains<O, 2 * C>(c, a, b, out, n, reps);
    lanes(a, b, out, n, [&](uint32_t* r, const uint32_t* x, const uint32_t* y) {
      issue_lane<O, C>(r, x, y, reps);
    });
  }
}
template <int O>
void issue(int op, int c, const uint32_t* a, const uint32_t* b, uint32_t* out,
           int n, int reps) {
  if constexpr (O < kNumIssueOps) {
    if (op != O) return issue<O + 1>(op, c, a, b, out, n, reps);
    issue_chains<O, 1>(c, a, b, out, n, reps);
  }
}
template <int M>
void fieldmul(int m, const uint32_t* a, const uint32_t* b, uint32_t* out,
              int n, int reps) {
  if constexpr (M < kNumFieldMulModes) {
    if (m != M) return fieldmul<M + 1>(m, a, b, out, n, reps);
    lanes(a, b, out, n, [&](uint32_t* r, const uint32_t* x, const uint32_t* y) {
      fieldmul_lane<M>(r, x, y, reps);
    });
  }
}
template <int M>
void stage(int m, const uint32_t* bx, const uint32_t* by, const uint32_t* tx,
           const uint32_t* ty, const uint32_t* inv, const uint32_t* lo,
           const uint32_t* hi, int n_slots, const int32_t* rem, int32_t* out,
           int K, int B) {
  if constexpr (M < kNumGlvStages) {
    if (m != M)
      return stage<M + 1>(m, bx, by, tx, ty, inv, lo, hi, n_slots, rem, out,
                          K, B);
    const long N = (long)K * B;
    for (long t = 0; t < N / kStageLanesPerThread<M>; t++)
      glv_stage_thread<M>(bx, by, tx, ty, inv, lo, hi, n_slots, rem, out, B, N,
                          t);
  }
}
// the grid of probe_vtile: blocks of T threads, V keys each
template <int C>
void vtile(int v, int T, const uint32_t* bx, const uint32_t* by,
           const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
           const uint32_t* lo, const uint32_t* hi, int n_slots,
           const int32_t* rem, int32_t* out, int K, int B) {
  if constexpr (C < 3) {
    constexpr int V = 1 << C;
    if (v != V)
      return vtile<C + 1>(v, T, bx, by, tx, ty, inv, lo, hi, n_slots, rem, out,
                          K, B);
    const long N = (long)K * B;
    for (long block = 0; block * V * T < N; block++)
      for (int t = 0; t < T; t++)
        vtile_thread<V>(bx, by, tx, ty, inv, lo, hi, n_slots, rem, out, B, N,
                        block, T, t);
  }
}
template <int S, int Mu>
void rows(int s, int mu, const uint32_t* x, uint32_t* out, long lanes,
          int steps) {
  if constexpr (S < kNumRowShapes) {
    if constexpr (Mu > 1) {
      return rows<S + 1, 0>(s, mu, x, out, lanes, steps);
    } else {
      if (s != S || mu != Mu)
        return rows<S, Mu + 1>(s, mu, x, out, lanes, steps);
      for (long e = 0; e < lanes; e++) {
        uint32_t xs[16], r[16];
        for (int i = 0; i < 16; i++) xs[i] = x[i * lanes + e];
        rows_lane<S, Mu>(r, xs, steps);
        for (int i = 0; i < (S == kFull2d ? 16 : 1); i++)
          out[i * lanes + e] = r[i];
      }
    }
  }
}
template <int L>
void layout(int l, const uint32_t* a, const uint32_t* b, uint32_t* out,
            long n, int reps) {
  if constexpr (L < kNumLayouts) {
    if (l != L) return layout<L + 1>(l, a, b, out, n, reps);
    for (long e = 0; e < n; e++) layout_lane<L>(out, a, b, n, e, reps);
  }
}
extern "C" {
void h_stage(int m, const uint32_t* bx, const uint32_t* by, const uint32_t* tx,
             const uint32_t* ty, const uint32_t* inv, const uint32_t* lo,
             const uint32_t* hi, int n_slots, const int32_t* rem, int32_t* out,
             int K, int B) {
  stage<0>(m, bx, by, tx, ty, inv, lo, hi, n_slots, rem, out, K, B);
}
void h_vtile(int v, int T, const uint32_t* bx, const uint32_t* by,
             const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
             const uint32_t* lo, const uint32_t* hi, int n_slots,
             const int32_t* rem, int32_t* out, int K, int B) {
  vtile<0>(v, T, bx, by, tx, ty, inv, lo, hi, n_slots, rem, out, K, B);
}
void h_rows(int s, int mu, const uint32_t* x, uint32_t* out, int lanes,
            int steps) {
  rows<0, 0>(s, mu, x, out, lanes, steps);
}
void h_layout(int l, const uint32_t* a, const uint32_t* b, uint32_t* out,
              int n, int reps) {
  layout<0>(l, a, b, out, n, reps);
}
void h_primitive(int p, const uint32_t* a, const uint32_t* b,
                 const int32_t* table, uint32_t* out, int n, int reps) {
  primitive<0>(p, a, b, table, out, n, reps);
}
void h_issue(int op, int c, const uint32_t* a, const uint32_t* b,
             uint32_t* out, int n, int reps) {
  issue<0>(op, c, a, b, out, n, reps);
}
void h_fieldmul(int m, const uint32_t* a, const uint32_t* b, uint32_t* out,
                int n, int reps) {
  fieldmul<0>(m, a, b, out, n, reps);
}
void h_ladder_stage(int s, const uint32_t* bx, const uint32_t* by,
                    const uint32_t* tx, const uint32_t* ty,
                    const uint32_t* inv, const uint32_t* table, uint32_t* X,
                    uint32_t* Z, int32_t* ok, int K, int B) {
  ladder_stage<0>(s, bx, by, tx, ty, inv, table, X, Z, ok, B, (long)K * B);
}
}
"""

N = 128


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("probes_host")
    src, so = d / "harness.cc", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{build.CSRC}", f"-I{build.PROBES}", "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("h_primitive", [i, p, p, p, p, i, i]),
                       ("h_issue", [i, i, p, p, p, i, i]),
                       ("h_fieldmul", [i, p, p, p, i, i]),
                       ("h_stage", [i, p, p, p, p, p, p, p, i, p, p, i, i]),
                       ("h_vtile", [i, i, p, p, p, p, p, p, p, i, p, p, i, i]),
                       ("h_rows", [i, i, p, p, i, i]),
                       ("h_layout", [i, p, p, p, i, i]),
                       ("h_ladder_stage", [i] + [p] * 9 + [i, i])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, None
    return lib


@pytest.fixture(scope="module")
def ab():
    return common.inputs(N, seed=120)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _check(call, plain):
    out = torch.empty((8, N), dtype=torch.int32)
    call(out)
    want = plain()
    assert torch.equal(out, want)
    return want


@pytest.mark.parametrize("name", list(roofline.PRIMITIVES))
def test_primitive_body_equals_plain(lib, ab, name):
    a, b = ab
    table = roofline.dfa_table()
    reps = 3
    got = _check(lambda out: lib.h_primitive(
        roofline.PRIMITIVES[name][0], _ptr(a), _ptr(b), _ptr(table),
        _ptr(out), N, reps),
        lambda: roofline.probe_primitive(name, a, b, table, reps))
    assert not torch.equal(got, a)


@pytest.mark.parametrize("op,chains", vpu.instances(),
                         ids=[vpu.instance_name(*i) for i in vpu.instances()])
def test_issue_body_equals_plain(lib, ab, op, chains):
    a, b = ab
    reps = 2 * vpu.UNROLL
    got = _check(lambda out: lib.h_issue(
        vpu.OPS[op][0], chains, _ptr(a), _ptr(b), _ptr(out), N, reps),
        lambda: vpu.probe_issue(op, chains, a, b, reps))
    assert torch.equal(got[chains:], a[chains:])
    assert not torch.equal(got[:chains], a[:chains])


@pytest.mark.parametrize("mode", list(fm.MODES))
def test_fieldmul_body_equals_plain(lib, ab, mode):
    a, b = ab
    reps = 3
    got = _check(lambda out: lib.h_fieldmul(
        fm.MODES[mode][0], _ptr(a), _ptr(b), _ptr(out), N, reps),
        lambda: fm.probe_fieldmul(mode, a, b, reps))
    assert not torch.equal(got, a)


def test_instance_codes_follow_the_header():
    """The Python tables' template codes are the enums' order in
    probe_lanes.cuh."""
    src = (build.PROBES / "probe_lanes.cuh").read_text()

    def enum(name):
        body = src.split(f"enum {name} {{")[1].split("}")[0]
        return [w.strip() for w in body.replace("\n", " ").split(",")
                if w.strip()][:-1]

    assert len(enum("Primitive")) == len(roofline.PRIMITIVES)
    assert [c for c, _ in roofline.PRIMITIVES.values()] == list(
        range(len(roofline.PRIMITIVES)))
    assert [c for c, _, _ in vpu.OPS.values()] == list(
        range(len(enum("IssueOp"))))
    assert [c for c, _ in fm.MODES.values()] == list(
        range(len(enum("FieldMulMode"))))
    assert f"kIssueUnroll = {vpu.UNROLL};" in src
    assert f"kDfaStates = {roofline.DFA_STATES};" in src
    assert np.all(roofline.dfa_table().numpy() < roofline.DFA_STATES)


def _interval_call(fn, codes, args):
    """Call a host body with kernel B's arguments -> the (K, B) mask."""
    bx, by, tx, ty, inv, lo, hi, rem = args
    K, B = bx.shape[0], tx.shape[1]
    out = torch.empty((K, B), dtype=torch.int32)
    fn(*codes, *(_ptr(t) for t in (bx, by, tx, ty, inv, lo, hi)), lo.shape[0],
       _ptr(rem), _ptr(out), K, B)
    return out


@pytest.fixture(scope="module")
def stage_args():
    return pg.stage_inputs(N, "cpu", force=True)


@pytest.mark.parametrize("mode", list(pg.MODES))
def test_stage_body_equals_plain(lib, stage_args, mode):
    got = _interval_call(lib.h_stage, (pg.MODES[mode],), stage_args)
    want = pg.probe_glv_stage(mode, *stage_args)
    assert torch.equal(got, want)
    assert int((want != 0).sum()) > 0


@pytest.fixture(scope="module")
def vtile_case():
    args = pv.vtile_inputs(N)
    return args, pv.probe_vtile_plain(*args)


@pytest.mark.parametrize("v,t", pv.instances(),
                         ids=[pv.instance_name(*i) for i in pv.instances()])
def test_vtile_body_equals_plain(lib, vtile_case, v, t):
    """The grid of V keys per thread over blocks of T threads covers each
    lane once, partial tiles included (N = 128 < V T for most)."""
    args, want = vtile_case
    got = _interval_call(lib.h_vtile, (v, t), args)
    assert torch.equal(got, want)
    assert int((want != 0).sum()) > 0


@pytest.mark.parametrize("shape,mul", mr.instances(),
                         ids=[mr.instance_name(*i) for i in mr.instances()])
def test_rows_body_equals_plain(lib, shape, mul):
    x, steps = mr.rows_inputs(N), 2 * mr.UNROLL
    want = mr.probe_rows(shape, mul, x, steps)
    got = torch.empty_like(want)
    lib.h_rows(mr.SHAPES[shape], int(mul), _ptr(x), _ptr(got), N, steps)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lay", list(ml.LAYOUTS))
def test_layout_body_equals_plain(lib, lay):
    a, b = (ml.to_layout(t, lay) for t in ml.layout_inputs(N))
    reps = 3
    want = ml.probe_layout(lay, a, b, reps)
    got = torch.empty_like(a)
    lib.h_layout(ml.LAYOUTS[lay], _ptr(a), _ptr(b), _ptr(got), N, reps)
    assert torch.equal(got, want)
    assert not torch.equal(got, a)


def test_geometry_codes_follow_the_header():
    """The stage, row and layout tables' template codes are the enums'
    order in geometry_lanes.cuh."""
    src = (build.PROBES / "geometry_lanes.cuh").read_text()

    def enum(name):
        body = src.split(f"enum {name} {{")[1].split("}")[0]
        return [w.strip() for w in body.replace("\n", " ").split(",")
                if w.strip()][:-1]

    for name, table in (("GlvStage", pg.MODES), ("RowShape", mr.SHAPES),
                        ("Layout", ml.LAYOUTS)):
        assert list(table.values()) == list(range(len(enum(name)))), name
    assert f"kRowUnroll = {mr.UNROLL};" in src


@pytest.fixture(scope="module")
def ladder_args():
    """Kernel F's inputs at K = 2, B = 64 on the 8-bit window table: window
    0 based below B, so it holds the doubling lane (dx == 0)."""
    K, B = 2, 64
    tx, ty = tables.ig_table(B, "cpu")
    pts = [ec.scalar_mult(s) for s in (B // 2 + 1, 0xC0FFEE123456789)]
    bx = u256.as_i32(u256.from_ints([p[0] for p in pts]).T.copy())
    by = u256.as_i32(u256.from_ints([p[1] for p in pts]).T.copy())
    inv = fused.batch_inverse_dx(bx, tx)
    return bx, by, tx, ty, inv, tables.window_table("cpu")


@pytest.mark.parametrize("stage", list(pl.STAGES))
def test_ladder_stage_body_equals_plain(lib, ladder_args, stage):
    """Kernel F's lane cut after each stage (``ladder_stages.cuh``), the
    codes of ``profile_ladder.STAGES`` in the enum's order, and the
    schedule the card's instance takes (``p2tr_lanes.cuh``) the product's."""
    src = (build.PROBES / "ladder_stages.cuh").read_text()
    body = src.split("enum LadderStage {")[1].split("}")[0]
    assert len(body.split(",")) - 1 == len(pl.STAGES)
    lanes = (build.CSRC / "p2tr_lanes.cuh").read_text()
    bits, signed = fused.LADDER_WINDOW
    assert f"kLadderBits = {bits};" in lanes
    assert f"kLadderSigned = {str(signed).lower()};" in lanes
    bx, tx = ladder_args[0], ladder_args[2]
    K, B = bx.shape[0], tx.shape[1]
    X = torch.empty((8, K * B), dtype=torch.int32)
    Z, ok = torch.empty_like(X), torch.empty((K * B,), dtype=torch.int32)
    lib.h_ladder_stage(pl.STAGES[stage], *(_ptr(t) for t in ladder_args),
                       _ptr(X), _ptr(Z), _ptr(ok), K, B)
    want = pl.probe_ladder_stage(stage, *ladder_args)
    for got, w in zip((X, Z, ok), want):
        assert torch.equal(got, w)
    assert 0 < int(ok.sum()) < K * B
