"""The kernels' share of their roofline in a random P2TR scan: the keys
counted in the traced part of the window, at the frozen per-key work of
``benchmark/work_p2tr.py`` (kernel F's tagged hash and ladder), over the
summed time of every kernel traced."""

from benchmark import work_p2tr

KIND = "per_layer"
UNIT = "%"


def read(record):
    if (record["scan"] != "random" or record.get("format") != "p2tr"
            or record["device"] is None):
        return None
    dev = record["device"]
    return work_p2tr.roofline_percent(dev["keys"], dev["kernel_s"])
