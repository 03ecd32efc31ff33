"""fivept_models_roofline: K6 (`fivept_models`, the five-point model
generator) alone, its bound over its device time in the traced pass, in %.
Nothing on a path without it."""

from portbench.trace import hand_written


def read(rec):
    t = rec["traced"]
    if (t is None or "fivept_models" not in t["bounds_ms"]
            or t["launches"] != t["launches_expected"]):
        return None
    dev_ms = sum(b - a for name, a, b, cat in t["trace"]["device_ops"]
                 if cat == "kernel" and hand_written(name)
                 and "fivept_kernel" in name) / 1e3
    if dev_ms <= 0:
        return None
    return 100.0 * t["bounds_ms"]["fivept_models"] / dev_ms
