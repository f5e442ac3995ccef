"""Keys checked per second by a random scan (six GLV keys a position):
all the keys the window counted, over all its time, by the host clock."""

KIND = "end_to_end"
UNIT = "keys/s"


def read(record):
    if record["scan"] != "random":
        return None
    return record["operations"] / record["window_s"]
