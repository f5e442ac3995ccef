"""Milliseconds to build the scanner (the i*G table on the card: kernels
T1, G and T2), by the host clock up to a synchronize."""

KIND = "per_layer"
UNIT = "ms"


def read(record):
    return record["scanner_build_s"] * 1e3
