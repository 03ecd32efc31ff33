"""torch_ops.device_ms_per_chunk: device time of the kernels that are not
hand-written (PyTorch's own, launched by the RANSAC glue), per chunk of
the traced pass, in ms."""

from portbench.trace import hand_written


def read(rec):
    t = rec["traced"]
    if t is None:
        return None
    ks = [(a, b) for name, a, b, cat in t["trace"]["device_ops"]
          if cat == "kernel" and not hand_written(name)]
    if not ks:
        return None
    return sum(b - a for a, b in ks) / 1e3 / t["chunks"]
