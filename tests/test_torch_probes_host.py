"""The probe kernels' per-thread bodies (``vgen_tpu_torch/probes/
probe_lanes.cuh``, which call the production functions of ``csrc/``),
compiled for the host with g++ as ``tests/test_torch_csrc_host.py`` does,
against the plain versions over R repetitions, for every instance of
``probe_primitive``, ``probe_issue`` and ``probe_fieldmul``.  On the host
the PTX product of ``candidates.cuh`` is the production one; the card's
PTX is held against the plain version by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Exact: every value is an integer (or an f32 bit
pattern)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.probes import common
from vgen_tpu_torch.probes import microbench_fieldmul as fm
from vgen_tpu_torch.probes import microbench_vpu as vpu
from vgen_tpu_torch.probes import roofline

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler (g++)")

HARNESS = r"""
#include "probe_lanes.cuh"
using namespace vg;
using namespace vg::probe;
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
extern "C" {
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
                       ("h_fieldmul", [i, p, p, p, i, i])):
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
