"""Keys of the range covered per second by a range scan, each once: all
the keys the window counted, over all its time, by the host clock."""

KIND = "end_to_end"
UNIT = "keys/s"


def read(record):
    if record["scan"] != "range":
        return None
    return record["operations"] / record["window_s"]
