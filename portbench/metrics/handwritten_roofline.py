"""handwritten_roofline: the hand-written kernels' share of their roofline
over the traced pass, in %: the sum of their bounds (portbench/roofline.py,
from the chunk shapes and each chunk's match table) over the sum of their
device times. Nothing where the launches differ from the path's count or
the profiler saw none of them."""

from portbench.trace import hand_written


def read(rec):
    t = rec["traced"]
    if t is None or t["launches"] != t["launches_expected"]:
        return None
    dev_ms = sum(b - a for name, a, b, cat in t["trace"]["device_ops"]
                 if cat == "kernel" and hand_written(name)) / 1e3
    if dev_ms <= 0:
        return None
    return 100.0 * sum(t["bounds_ms"].values()) / dev_ms
