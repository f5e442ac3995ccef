"""The random interval step of P2SH-P2WPKH (kernel A + B
``range_glv_match`` + the pack) row for row against the JAX reference's
whole packed step: curve stage, six GLV variants (prefix 2 + pi of beta^v x)
through hash160 and the redeem script's hash160, the interval compare on
``^3A`` and the pack (``test_torch_support.check_glv_interval_step``).
In a file of its own: the jitted reference compiles for about a minute on
XLA:CPU."""

from test_torch_support import check_glv_interval_step, \
    one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch.crypto.address import AddressFormat


def test_p2sh_glv_interval_step_rows_match_packed_xla_scan_step():
    check_glv_interval_step(AddressFormat.P2SH_P2WPKH, "^3A")
