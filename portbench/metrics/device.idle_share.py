"""device.idle_share: the share of the traced window in which no device
operation (kernel, copy, set) ran, in %."""


def read(rec):
    t = rec["traced"]
    if t is None or t["trace"]["window_s"] <= 0:
        return None
    tr = t["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
