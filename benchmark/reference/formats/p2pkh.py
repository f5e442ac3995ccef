"""Compressed P2PKH: the address and WIF of ``address.py``, the share of
``density.py``."""

from __future__ import annotations

from typing import List, Tuple

from benchmark.reference import address
from benchmark.reference.density import p2pkh_share as share  # noqa: F401


def derive_many(keys: List[int]) -> List[Tuple[str, str]]:
    return list(zip(address.p2pkh_many(keys),
                    map(address.wif_compressed, keys)))
