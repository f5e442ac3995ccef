"""The P2TR DFA route's whole step (kernels A, F, G, I and the pack on CPU
tensors) row for row against the jitted ``packed_xla_scan_step(P2TR,
"dfa", ...)``; apart from ``tests/test_torch_p2tr.py``, whose range step
compiles its own reference, so the two compiles (about 40 s each on
XLA:CPU) run on separate test workers.  The ``ops`` rule is stated
there."""

import torch

from test_torch_p2tr import BASES, REMAINING, B, _points, check_rows, \
    port_rows, reference_rows
from vgen_tpu_torch.scan import tables


def test_whole_dfa_step_rows_match_packed_xla_scan_step():
    tx, ty = tables.ig_table(B, "cpu")
    bx, by = _points(BASES)
    rem = torch.tensor(REMAINING, dtype=torch.int32)
    rows = port_rows("dfa", bx, by, tx, ty, rem, tables.window_table("cpu"))
    check_rows(rows.numpy(), reference_rows("dfa", bx, by))
