"""The port's MeshScanner against the reference's on the virtual 8-device
CPU mesh (tests/conftest.py): the (W, 34) packed rows of one super-batch,
[count, ops, 16 indices, 16 variant-bit slots] per window, for the same
base scalar.  The reference runs its XLA tails on the CPU, one window per
device, so the port runs k_sub = 1 on ``["cpu"] * 8``.  Exact: the rows
are integers.  Each reference step compiles once per process (about 40 s
on XLA:CPU), so the file keeps to the interval step's two (the DFA step's
is in ``test_torch_mesh_dfa.py``); ``mesh_pair`` and ``check_rows`` are
shared with it."""

import re

import numpy as np
import pytest

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.parallel.mesh import MeshScanner as JMeshScanner
from vgen_tpu.pattern import Pattern as JPattern
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.ops import pipeline
from vgen_tpu_torch.parallel.mesh import MeshScanner
from vgen_tpu_torch.pattern import Pattern

BATCH = 256
P2PKH = AddressFormat.P2PKH
BASE = 50_000  # > BATCH: no window holds the doubling lane


def mesh_pair():
    ref = JMeshScanner(JAddressFormat.P2PKH, BATCH)
    assert ref.n_devices == 8 and ref.k_sub == 1
    return MeshScanner(P2PKH, BATCH, ["cpu"] * 8, k_sub=1), ref


@pytest.fixture(scope="module")
def scanners():
    return mesh_pair()


def check_rows(scanners, src, allow_glv, base=BASE):
    """The two scanners' rows of one super-batch, held equal -> the port's."""
    port, ref = scanners
    got = port.drain_packed(port.submit_super_batch(
        Pattern(src), base, allow_glv=allow_glv))
    want = ref.drain_packed(ref.submit_super_batch(
        JPattern(src), base, allow_glv=allow_glv))
    assert got.shape == (8, 2 + 2 * pipeline.TOP_K)
    np.testing.assert_array_equal(got, want)
    return got


def _address(key):
    return AddressGenerator(P2PKH).generate(key.to_bytes(32, "big")).address


@pytest.mark.parametrize("allow_glv", [False, True], ids=["range", "glv"])
def test_interval_rows_equal_reference(scanners, allow_glv):
    """^1 (every key) on the interval step: kernel C's plain version, or
    B's with six GLV keys per position."""
    rows = check_rows(scanners, "^1", allow_glv)
    assert rows[:, 0].tolist() == [BATCH] * 8
    assert rows[:, 1].tolist() == [BATCH * (6 if allow_glv else 1)] * 8


def test_planted_address_rows_equal_reference(scanners):
    """A key's exact address: its match on device 5, index 37, in both
    scanners' rows (the reference's key-to-device mapping)."""
    dev, idx = 5, 37
    key = BASE + dev * BATCH + 1 + idx
    rows = check_rows(scanners, f"^{re.escape(_address(key))}$", False)
    assert rows[:, 0].tolist() == [int(d == dev) for d in range(8)]
    assert rows[dev, 2] == idx
