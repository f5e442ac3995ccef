"""The share of a range scan's traced window in which the device sat idle
while the host was inside the submit of a super-step: idle seconds whose
innermost host event is one of the program's ``vgen.submit`` spans (the
base points, the launches), over the window."""

from benchmark import idle_split

KIND = "per_layer"
UNIT = "%"


def read(record):
    return idle_split.share(record, "vgen.submit")
