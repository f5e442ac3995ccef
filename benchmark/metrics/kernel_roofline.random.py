"""The kernels' share of their roofline in a random scan: the keys counted
in the traced part of the window, at the frozen hash work of
``benchmark/work.py``, over the summed time of every kernel traced."""

from benchmark import work

KIND = "per_layer"
UNIT = "%"


def read(record):
    if record["scan"] != "random" or record["device"] is None:
        return None
    dev = record["device"]
    return work.roofline_percent(record["format"], dev["keys"],
                                 dev["kernel_s"])
