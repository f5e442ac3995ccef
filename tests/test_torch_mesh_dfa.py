"""The port's MeshScanner on the DFA route against the reference's on the
virtual 8-device CPU mesh (as ``test_torch_mesh.py`` does for the
interval route, exact), and a P2TR mesh on two CPU devices, each with its
own copy of the ladder table, finding a planted key."""

import re

from test_torch_mesh import check_rows, mesh_pair
from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.parallel.mesh import MeshScanner
from vgen_tpu_torch.pattern import Pattern


def test_dfa_rows_equal_reference():
    """A suffix on the GLV DFA step (kernel E's plain version)."""
    rows = check_rows(mesh_pair(), "q$", True)
    assert int(rows[:, 0].sum()) > 0


def test_p2tr_mesh_range_finds_planted_key():
    """^bc1p and the next six symbols of a key's address over a range
    around it: kernels A, F, G, H's plain versions on each device, the
    ladder table uploaded once per distinct device."""
    p2tr = AddressFormat.P2TR
    key = 0x1234567
    addr = AddressGenerator(p2tr).generate(key.to_bytes(32, "big")).address
    sc = MeshScanner(p2tr, 256, ["cpu"] * 2, k_sub=1)
    assert len(sc._scanners) == 1 and sc.windows == 2
    assert sc._scanners[sc.devices[0]].wt is not None
    res = sc.scan(Pattern(f"^{re.escape(addr[:10])}"), count=0,
                  start=key - 300, end=key + 200)
    assert [m.hex for m in res.matches] == [key.to_bytes(32, "big").hex()]
    assert res.operations == 501
