"""The device's idle share of the traced window of a random scan: one less
the union of its kernels, copies and memsets over the window."""

KIND = "per_layer"
UNIT = "%"


def read(record):
    if record["scan"] != "random" or record["device"] is None:
        return None
    dev = record["device"]
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
