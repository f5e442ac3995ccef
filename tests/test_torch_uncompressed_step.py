"""The random interval step of uncompressed P2PKH (kernel A + B
``range_glv_match`` + the pack) row for row against the JAX reference's
whole packed step: curve stage, six GLV variants (beta^v x, +-y) through
hash160 of 04 || x || y, the interval compare on
``^1A`` and the pack (``test_torch_support.check_glv_interval_step``).
In a file of its own: the jitted reference compiles for about a minute on
XLA:CPU."""

from test_torch_support import check_glv_interval_step, \
    one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch.crypto.address import AddressFormat


def test_uncompressed_glv_interval_step_rows_match_packed_xla_scan_step():
    check_glv_interval_step(AddressFormat.P2PKH_UNCOMPRESSED, "^1A")
