"""Shared pieces of the port's CPU tests; this module holds no test.

``one_torch_thread`` is an autouse fixture: a module takes it by importing
it.  ``check_glv_interval_step`` holds the random interval step of a hash
format against the JAX reference's whole packed step; each format's call
stands in a file of its own, because each jitted reference compiles for
about a minute on XLA:CPU and pytest-xdist (``--dist loadfile``) then runs
them on separate workers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu.scan import tables as jtables
from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.ops import fused, pipeline, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import tables


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and the plain versions' many small ops would otherwise contend for the
    cores (six processes of eight threads each ran 60 times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP_B = 256
STEP_BASES = [0x5EED5EED5EED, 0xC0FFEE123456789]  # both > STEP_B
STEP_REMAINING = [STEP_B, 200]


def check_glv_interval_step(fmt, src: str) -> None:
    """Kernel A + B ``range_glv_match`` + the pack (plain versions on CPU
    tensors) at K = 2, B = 256 on the interval pattern ``src``, row for row
    against ``pipeline.packed_xla_scan_step(fmt, "range", True, 16, 2,
    False)``.  Exact: rows are integers.  The bases hold no doubling lane,
    so the ``ops`` fields agree too."""
    pts = [ec.scalar_mult(s) for s in STEP_BASES]
    bx = u256.from_ints([p[0] for p in pts]).T.copy()  # (K, 8) uint32
    by = u256.from_ints([p[1] for p in pts]).T.copy()
    tx, ty = tables.ig_table(STEP_B, "cpu")
    ivs = Pattern(src).match_intervals(fmt)
    lo, hi = pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs)))
    rows = fused.fused_range_scan_step(
        fmt, u256.as_i32(bx), u256.as_i32(by), tx, ty, u256.as_i32(lo),
        u256.as_i32(hi), torch.tensor(STEP_REMAINING, dtype=torch.int32),
        glv=True)

    tx16, ty16 = jtables.ig_table_limbs(STEP_B)
    step = jpipeline.packed_xla_scan_step(JAddressFormat(fmt.value), "range",
                                          True, 16, 2, False)
    ref = step(jnp.asarray(u256.limbs32_to_16(bx.T).T),
               jnp.asarray(u256.limbs32_to_16(by.T).T),
               jnp.asarray(tx16), jnp.asarray(ty16),
               jnp.asarray(STEP_REMAINING, dtype=jnp.int32), jnp.asarray(lo),
               jnp.asarray(hi))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref))
    assert rows[:, 1].tolist() == [6 * r for r in STEP_REMAINING]
    assert int(rows[:, 0].sum()) > 0
