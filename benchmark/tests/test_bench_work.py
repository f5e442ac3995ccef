"""The frozen work model against the program's bound model as it counts
today, and the roofline arithmetic."""

import pytest

from benchmark import work


def test_rounds_equal_the_bound_model():
    from vgen_tpu_torch.probes import bound_model as bm

    # a SHA-256 compression whose state is data and whose message words are
    # constants counts its 64 rounds alone
    rounds = bm.sha256_ops(range(16), const_state=False)
    assert list(rounds) == [0, work.SHA256_ROUNDS * work.SHA256_ROUND[0],
                            work.SHA256_ROUNDS * work.SHA256_ROUND[1]]
    # RIPEMD-160 of a digest: 160 steps of (3, 6), one add fewer in the 80
    # steps on padding words, then 10 for the combination and 8 byte swaps
    steps = work.RIPEMD160_STEPS
    assert bm.RIPEMD160[1] == steps * work.RIPEMD160_STEP[0]
    assert bm.RIPEMD160[2] == steps * work.RIPEMD160_STEP[1] - 80 + 10 + 8
    assert work.ALU_PER_SM_CLOCK == bm.ALU_PER_SM_CLOCK
    assert work.INSTRUCTIONS_PER_SM_CLOCK == bm.INSTRUCTIONS_PER_SM_CLOCK


def test_clocks_and_peak():
    assert work.clocks_per_key("p2pkh") == 17.5
    assert work.peak_keys_per_s("p2pkh") == pytest.approx(14.934857e9,
                                                          rel=1e-6)
    assert work.clocks_per_key("p2tr") is None
    assert work.roofline_percent("p2tr", 10, 1.0) is None


def test_roofline_percent():
    peak = work.peak_keys_per_s("p2pkh")
    assert work.roofline_percent("p2pkh", int(peak), 2.0) == pytest.approx(
        50.0)
    assert work.roofline_percent("p2pkh", 1, 0.0) is None
