"""The kernels' share of their roofline in a random Ethereum scan: the keys
counted in the traced part of the window, at the frozen per-key work of
``benchmark/work_eth.py`` (one Keccak-f[1600] a key), over the summed time
of every kernel traced."""

from benchmark import work_eth

KIND = "per_layer"
UNIT = "%"


def read(record):
    if (record["scan"] != "random" or record.get("format") != "ethereum"
            or record["device"] is None):
        return None
    dev = record["device"]
    return work_eth.roofline_percent(dev["keys"], dev["kernel_s"])
