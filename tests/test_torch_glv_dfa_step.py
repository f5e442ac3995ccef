"""The random DFA step (kernel A + E ``glv_dfa_match`` + the pack, plain
versions on CPU tensors) row for row against the JAX reference's whole
packed step ``pipeline.packed_xla_scan_step(P2PKH, "dfa", True, 16, 2,
False)``: curve stage, six GLV variants through Base58Check and the DFA,
and the pack.  Exact: rows are integers.  B = 256, bases > B; the jitted
reference compiles for about 40 s on XLA:CPU, so it stands in a file of
its own (pytest-xdist runs it beside tests/test_torch_range_dfa.py)."""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu.scan import tables as jtables
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.ops import fused, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import tables

B = 256
BASES = [0x5EED5EED5EED, 0xC0FFEE123456789]  # both > B
REMAINING = [B, 200]
P2PKH = AddressFormat.P2PKH


def test_glv_dfa_step_rows_match_packed_xla_scan_step():
    pts = [ec.scalar_mult(s) for s in BASES]
    bx = u256.from_ints([p[0] for p in pts]).T.copy()  # (K, 8) uint32
    by = u256.from_ints([p[1] for p in pts]).T.copy()
    tx, ty = tables.ig_table(B, "cpu")
    dfa = Pattern("q$").device_dfa(P2PKH)
    rows = fused.fused_scan_step(
        P2PKH, u256.as_i32(bx), u256.as_i32(by), tx, ty,
        torch.from_numpy(dfa.table),
        torch.from_numpy(dfa.accept.astype(np.int32)), dfa.start,
        torch.tensor(REMAINING, dtype=torch.int32), glv=True)

    tx16, ty16 = jtables.ig_table_limbs(B)
    flat, accept = jpipeline.pad_device_dfa(dfa)
    step = jpipeline.packed_xla_scan_step(JAddressFormat.P2PKH, "dfa", True, 16, 2, False)
    ref = step(jnp.asarray(u256.limbs32_to_16(bx.T).T),
               jnp.asarray(u256.limbs32_to_16(by.T).T),
               jnp.asarray(tx16), jnp.asarray(ty16),
               jnp.asarray(REMAINING, dtype=jnp.int32), jnp.asarray(flat),
               jnp.asarray(accept), jnp.int32(dfa.start))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref))
    assert rows[:, 1].tolist() == [6 * r for r in REMAINING]
    assert int(rows[:, 0].sum()) > 0
