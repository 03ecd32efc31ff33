"""Chip phase (i) of chip_smoke.py, the sequential front-end against the
batched one, alone and at other depths: `python tools/sequential_depth.py
128` runs `chip_smoke.sequential_phase(steps=128)` on the card (all of
its gates) and prints its stage entries as one JSON object per depth."""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from kimera_multi_tpu_torch.kernels import _build  # noqa: E402


def main(argv):
    _build.build_all()
    for steps in map(int, argv):
        t = time.time()
        res = chip_smoke.sequential_phase(torch.device("cuda"),
                                          chip_smoke.check, steps=steps)
        res["phase_s"] = time.time() - t
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
