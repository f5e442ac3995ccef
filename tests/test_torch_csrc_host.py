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

from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.crypto.address import AddressFormat
from vgen_tpu.pattern import Pattern
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import encode, fused, pipeline, u256
from vgen_tpu_torch.scan import tables

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler (g++)")

HARNESS = r"""
#include "scan_lanes.cuh"
extern "C" {
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
