"""A whole P2TR step with kernel F at the product's window schedule on CPU
tensors (the plain versions), row for row against the JAX reference with
its 8-bit table.  A file of its own: the jitted reference compiles for
about 45 s on XLA:CPU, and pytest-xdist (``--dist loadfile``) then runs it
beside ``test_torch_ladder_window.py``.  Exact: rows are integers."""

import torch

from test_torch_p2tr import (B, BASES, REMAINING, _points, check_rows,
                             port_rows, reference_rows)
from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch.scan import tables


def test_whole_range_step_at_product_schedule_matches_reference():
    """Kernels A, F (the product's schedule), G, H and the pack, row for
    row against ``packed_xla_scan_step`` with the JAX package's 8-bit
    table (``tests/test_torch_p2tr.py``'s rule for ``ops``)."""
    tx, ty = tables.ig_table(B, "cpu")
    bx, by = _points(BASES)
    rem = torch.tensor(REMAINING, dtype=torch.int32)
    rows = port_rows("range", bx, by, tx, ty, rem, tables.ladder_table("cpu"))
    check_rows(rows.numpy(), reference_rows("range", bx, by))
