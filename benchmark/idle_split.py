"""The device's idle time in a range scan's traced window, put down to the
program's spans: the breakdown labels each idle gap by the innermost host
event at its middle, and the scan loop names its own (``vgen.submit``,
``vgen.drain`` and the spans inside them, ``vgen_tpu_torch/tracing.py``).
"""

SPAN_PREFIX = "vgen."


def share(record, prefix: str):
    """100 x the idle seconds whose label starts with ``prefix``, over the
    traced window; a label outside the breakdown's top ten reads 0.  None
    for a random scan, an untraced run, or a program that names no span
    of its own at any idle gap."""
    if record["scan"] != "range" or record["device"] is None:
        return None
    dev = record["device"]
    gaps = dev.get("idle_gaps", [])
    if gaps and not any(label.startswith(SPAN_PREFIX) for label, _ in gaps):
        return None
    idle = sum(s for label, s in gaps if label.startswith(prefix))
    return 100.0 * idle / dev["window_s"]
