"""The share of a range scan's traced window in which the device sat idle
while the host was inside the drain: idle seconds whose innermost host
event is one of the program's ``vgen.drain`` spans (the wait, overflow
recovery, the derivation of candidates, the checkpoint), over the
window."""

from benchmark import idle_split

KIND = "per_layer"
UNIT = "%"


def read(record):
    return idle_split.share(record, "vgen.drain")
