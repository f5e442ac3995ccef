"""Seconds from the process's start to the window's: imports, the card's
context, the kernels' load, the tables, the native library, warm-up."""

KIND = "end_to_end"
UNIT = "s"


def read(record):
    return record["setup_s"]
