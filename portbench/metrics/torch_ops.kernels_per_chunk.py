"""torch_ops.kernels_per_chunk: how many kernels that are not hand-written
the traced pass launched, per chunk (a count; copies and sets left out)."""

from portbench.trace import hand_written


def read(rec):
    t = rec["traced"]
    if t is None:
        return None
    n = sum(1 for name, _a, _b, cat in t["trace"]["device_ops"]
            if cat == "kernel" and not hand_written(name))
    return n / t["chunks"] if n else None
