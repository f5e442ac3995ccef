"""Kernel J (``fused.base_advance``), which moves a super-step's window
bases on by Q = D G on the card, and the scan loop around it: the
``_base_points`` seam choosing the card or the host, its counters, and the
route's step replayed over static inputs (a CUDA graph on a card; called
again on the CPU).  Exact comparisons: the values are integers.  The
``cuda``-marked cases skip without a card; on a card, where jax is
missing, ``python -m pytest --noconftest -m cuda
tests/test_torch_base_advance.py``."""

import collections
import ctypes
import json
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

try:  # the card machine has no jax; its cases here need none
    from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
except ImportError:
    pass
from vgen_tpu_torch import tracing
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import fused, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan.checkpoint import CheckpointManager
from vgen_tpu_torch.scan.host import ScanConfig

B, K = 256, 4
FMT = AddressFormat.P2PKH
# strides: a product super-step (K 8, B 524288), a small one, and a
# four-card mesh's per-card stride (32 windows of 4096)
STRIDES = [8 * 524288, 8 * 4096, 32 * 4096]


def _limbs(points):
    return (u256.as_i32(u256.from_ints([p[0] for p in points]).T),
            u256.as_i32(u256.from_ints([p[1] for p in points]).T))


def _qs(d: int, rows: int) -> torch.Tensor:
    """(m + 1) D G for m < rows, (rows, 2, 8) int32."""
    return torch.stack(_limbs([ec.scalar_mult((m + 1) * d)
                               for m in range(rows)]), dim=1)


def _scalars(d: int, seed: int):
    """Eight seeded scalars, the last three within D of n (k + D wraps)."""
    rng = random.Random(seed)
    ks = [rng.randrange(1, ec.N) for _ in range(5)]
    ks += [ec.N - d + r for r in (1, 2, d - 1)]
    return ks


def _ahead(ks, d, rows):
    """The oracle's (k + (m + 1) D) G as kernel J's (rows, 2, K, 8)."""
    return torch.stack([torch.stack(_limbs([ec.scalar_mult(k + (m + 1) * d)
                                            for k in ks]))
                        for m in range(rows)])


@pytest.mark.parametrize("d", STRIDES)
def test_plain_equals_the_oracles(d):
    from vgen_tpu.crypto import secp256k1 as jec  # the JAX package's oracle

    ks = _scalars(d, 1700 + d)
    bx, by = _limbs([ec.scalar_mult(k) for k in ks])
    out = torch.zeros((3, 2, len(ks), 8), dtype=torch.int32)
    fused.base_advance_plain(bx, by, _qs(d, 3), out)
    assert torch.equal(out, _ahead(ks, d, 3))
    got = list(zip(u256.to_ints(out[0, 0].T), u256.to_ints(out[0, 1].T)))
    assert got == [jec.scalar_mult((k + d) % jec.N) for k in ks]


HARNESS = r"""
#include "scan_lanes.cuh"
extern "C" void h_base_advance(const uint32_t* bx, const uint32_t* by,
                               const uint32_t* qs, uint32_t* out, int K,
                               int R) {
  for (long m = 0; m < R; m++)
    for (long j = 0; j < K; j++)
      vg::base_advance_lane(bx, by, qs, out, K, m, j);
}
"""


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no host C++ compiler (g++)")
def test_lane_body_equals_plain(tmp_path):
    """``scan_lanes.cuh`` ``base_advance_lane`` built for the host."""
    src, so = tmp_path / "harness.cc", tmp_path / "harness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{build.CSRC}", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.h_base_advance.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int]
    d = STRIDES[0]
    ks = _scalars(d, 5)
    bx, by = _limbs([ec.scalar_mult(k) for k in ks])
    qs = _qs(d, 3)
    out = torch.zeros((3, 2, len(ks), 8), dtype=torch.int32)
    lib.h_base_advance(bx.data_ptr(), by.data_ptr(), qs.data_ptr(),
                       out.data_ptr(), len(ks), 3)
    assert torch.equal(out, _ahead(ks, d, 3))


@pytest.fixture
def counts(monkeypatch):
    """What the scan loop counts through ``tracing.count``, recorded with no
    profiler (which counts the same calls, and slows the plain versions'
    many small ops fivefold)."""
    seen = collections.Counter()
    monkeypatch.setattr(tracing, "count",
                        lambda name, n=1: seen.update({name: n}))
    return seen


def _windows(base: int):
    return [base + j * B for j in range(K)]


@pytest.fixture(scope="module")
def scanner():
    return sc.DeviceScanner(FMT, B, "cpu", k_sub=K)


def test_seam_chooses_card_or_host(scanner, counts):
    """Each call of K scalars leaves the static buffers holding their
    points, bit-equal to the native ``scalar_mult_base_fast``; the card
    advances only a scan's steady stride."""
    stride = K * B
    base = 0x123456789ABCDEF
    calls = [  # (what, base scalars, "card" or "host")
        ("first", base, "host"),
        ("successor", base + stride, "card"),
        ("successor", base + 2 * stride, "card"),
        ("jump", base + 50 * stride, "host"),
        ("successor of the jump", base + 51 * stride, "card"),
        ("wrap to a low start", 10 ** 6, "host"),
        ("successor", 10 ** 6 + stride, "card"),
    ]
    scanner._plan(Pattern("^1C"), ScanConfig(start=1), glv=False)
    for what, b, where in calls:
        scalars = _windows(b)
        counts.clear()
        bx, by = scanner._base_points(scalars)
        assert bx is scanner._bx and by is scanner._by, what
        assert counts == {f"base_points_{where}": 1}, what
        want = _limbs([ec.scalar_mult_base_fast(s) for s in scalars])
        assert torch.equal(bx, want[0]) and torch.equal(by, want[1]), what

    # another length (overflow recovery): fresh tensors, buffers untouched
    held = scanner._bx.clone()
    counts.clear()
    ox, oy = scanner._base_points([b + 7])
    assert ox is not scanner._bx and not counts
    assert torch.equal(scanner._bx, held)
    assert u256.to_ints(ox.T)[0] == ec.scalar_mult(b + 7)[0]
    scanner._base_points(_windows(b + stride))
    assert counts == {"base_points_card": 1}

    # a lane of kernel J on the doubling (a held k = (m + 1) D), and a
    # stride of 0, go to the host
    scanner._base_points(_windows(5 * stride - 2 * B))  # lane 2: k = 5 D
    for b, what in ((6 * stride - 2 * B, "held k = 5 D"),
                    (6 * stride - 2 * B, "D = 0")):
        counts.clear()
        bx, _ = scanner._base_points(_windows(b))
        assert counts == {"base_points_host": 1}, what
        assert u256.to_ints(bx.T) == [ec.scalar_mult(s)[0]
                                      for s in _windows(b)], what


def test_a_new_route_seeds_on_the_host(scanner, counts):
    scanner._base_points(_windows(5000))
    scanner._plan(Pattern("^1C"), ScanConfig(start=1), glv=False)
    counts.clear()
    scanner._base_points(_windows(5000 + K * B))
    assert counts == {"base_points_host": 1}


def test_chain_of_super_steps_bit_equal(scanner, counts, monkeypatch):
    """24 super-steps of a product-like stride, each advanced on the card,
    equal to the native points at every step: kernel J computes the bases
    of ADVANCE_AHEAD of them a launch."""
    launches = []
    monkeypatch.setattr(fused, "base_advance",
                        lambda *a, _f=fused.base_advance: launches.append(
                            _f(*a)))
    scanner._plan(Pattern("^1C"), ScanConfig(start=1), glv=False)
    base = ec.N // 3
    counts.clear()
    for step in range(24):
        scalars = _windows(base + step * K * B)
        bx, by = scanner._base_points(scalars)
        want = _limbs([ec.scalar_mult_base_fast(s) for s in scalars])
        assert torch.equal(bx, want[0]) and torch.equal(by, want[1]), step
    assert counts == {"base_points_host": 1, "base_points_card": 23}
    assert len(launches) == -(-23 // sc.ADVANCE_AHEAD)


class EagerScanner(sc.DeviceScanner):
    """The scan loop as it was: every super-step's bases from the host, the
    route's step called on fresh tensors."""

    def _submit(self, route, base_scalars, rems):
        bx, by = (t.to(self.device) for t in self._host_limbs(base_scalars))
        rem = self._remaining(rems if rems is not None
                              else [self.batch] * self.windows)
        return sc._copy_to_host(route.step(bx, by, rem))


class FixedStart:
    """Random starts from a list, so two scanners scan the same keys."""

    def __init__(self, starts):
        self.starts = list(starts)

    def __call__(self, n):
        return self.starts.pop(0)


def _range(scn, path, pattern, start, end):
    ckpt = CheckpointManager(str(path), pattern=pattern, fmt=FMT.value,
                             start=start, end=end)
    res = scn.scan(Pattern(pattern), ScanConfig(start=start, end=end,
                                                count=0, checkpoint=ckpt))
    state = json.loads(path.read_text())
    del state["saved_at"]
    return res, state


@pytest.mark.parametrize("pattern", ["^1C", "[Cc]at"],
                         ids=["interval", "dfa"])
def test_range_scan_equals_eager(scanner, tmp_path, counts, pattern):
    """A range scan of 5.5 super-steps (the last partial, one window with
    over TOP_K matches on ^1C) through the replayed step, twice on one
    scanner (the second replays the first's graph), against the eager
    loop: matches, operations and checkpoint equal."""
    start, end = 2, 2 + int(5.5 * K * B)
    eager = EagerScanner(FMT, B, "cpu", k_sub=K)
    want, want_ck = _range(eager, tmp_path / "eager.ckpt", pattern, start,
                           end)
    for leg in range(2):
        counts.clear()
        got, got_ck = _range(scanner, tmp_path / f"{leg}.ckpt", pattern,
                             start, end)
        assert [m.hex for m in got.matches] == [m.hex for m in want.matches]
        assert got.operations == want.operations == end - start + 1
        assert got_ck == want_ck
        assert counts["super_steps"] == 6
        assert counts["base_points_host"] == 1
        assert counts["base_points_card"] == 5
        # the route's first super-step of the first scan runs eagerly
        assert counts["graph_replays"] == 5 + leg
    assert want.matches


@pytest.mark.parametrize("pattern", ["^1C", "c[a4]t"],
                         ids=["interval", "dfa"])
def test_random_scan_over_a_wrap_equals_eager(scanner, counts, pattern):
    """A random scan that starts two super-steps below the top of the key
    space wraps to a low start: the host seeds the first super-step and the
    wrap's, the card the others; rows as the eager loop's."""
    # the wrap follows the second super-step; the odd offset keeps every
    # lane of kernel J off n (no lane of the rows ahead is degenerate)
    top = ec.N + 8 - 3 * K * B - B
    results = []
    for scn in (EagerScanner(FMT, B, "cpu", k_sub=K), scanner):
        scn._random_start = FixedStart([top, 10 ** 9])
        counts.clear()
        res = scn._scan(Pattern(pattern), ScanConfig(count=0), None, None,
                        True, max_super_steps=4)
        results.append((sorted(m.hex for m in res.matches), res.operations,
                        dict(counts)))
        del scn._random_start
    (want, want_ops, _), (got, got_ops, c) = results
    assert got == want and want
    assert got_ops == want_ops == 4 * K * B * sc.GLV_KEYS
    assert c["base_points_host"] == 2 and c["base_points_card"] == 2


def test_partial_windows_feed_the_remaining_keys(scanner):
    """A super-step with partial windows copies its remaining keys into the
    static input; the next full one restores the shared full ones."""
    scanner._plan(Pattern("^1C"), ScanConfig(start=1), glv=False)
    route = sc._Route(lambda bx, by, rem: rem.clone(), None, "intervals")
    rows = [scanner._submit(route, _windows(10 ** 7 + i * K * B), rems)[0]
            for i, rems in enumerate((None, [B, B, 9, 0], None,
                                      [B] * K))]
    assert [r.tolist() for r in rows] == [[B] * K, [B, B, 9, 0], [B] * K,
                                         [B] * K]


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", STRIDES)
def test_kernel_equals_plain(dev, d):
    ks = _scalars(d, 9)
    bx, by = _limbs([ec.scalar_mult(k) for k in ks])
    qs = _qs(d, sc.ADVANCE_AHEAD)
    out = torch.zeros((sc.ADVANCE_AHEAD, 2, len(ks), 8), dtype=torch.int32)
    got = out.to(dev)
    before = fused.base_advance.launches
    fused.base_advance(bx.to(dev), by.to(dev), qs.to(dev), got)
    torch.cuda.synchronize()
    assert fused.base_advance.launches == before + 1
    fused.base_advance_plain(bx, by, qs, out)
    assert torch.equal(got.cpu(), out)
    assert torch.equal(out[:2], _ahead(ks, d, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,start", [("^1C", None), ("c[a4]t", None),
                                           ("^1C", 2), ("[Cc]at", 2)],
                         ids=["interval-random", "dfa-random",
                              "interval-range", "dfa-range"])
def test_graph_rows_equal_eager_rows(dev, pattern, start):
    """Super-steps of a route through kernel J and the graph's replays,
    each row equal to the eager step's on the host's bases."""
    Bc = 4096
    scn = sc.DeviceScanner(FMT, Bc, dev, k_sub=K)
    glv = start is None
    route = scn._plan(Pattern(pattern), ScanConfig(start=start), glv)
    launches = fused.launch_count()
    matches = 0
    for i in range(4):
        scalars = [0xABCDEF + (i * K + j) * Bc for j in range(K)]
        rems = None if i < 3 else [Bc, Bc, 1000, 0]
        host, done = scn._submit(route, scalars, rems)
        done.synchronize()
        bx, by = (t.to(dev) for t in scn._host_limbs(scalars))
        rem = torch.tensor(rems or [Bc] * K, dtype=torch.int32, device=dev)
        want = route.step(bx, by, rem).cpu().numpy()
        assert np.array_equal(host.numpy(), want), i
        matches += int(want[:, 0].sum())
    assert matches > 0
    # one cached route, which holds its graph
    assert list(scn._routes.values()) == [route] and route.graph is not None
    # one kernel J launch, and every super-step's A and match kernel
    # counted, the replays' included (plus the four eager checks')
    assert fused.launch_count() - launches == 1 + 2 * 4 + 2 * 4
