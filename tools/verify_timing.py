"""Times `make_verifier`'s `verify_many` of the checkout at argv[1] on the
card: one chunk of 1,024 candidates (K = 704, 500 hypotheses, the
default 5-point and the 8-point mono gate) over 20 calls and one
candidate (C = 1) over 50 calls, by CUDA events and by the host clock.
Prints one JSON object. To compare two commits, unpack both and run them
alternately in one call on one card, e.g.

    for t in parent change change parent; do
        python tools/verify_timing.py "$(cd $t && pwd)"; done
"""
import json
import sys
import time

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402

from kimera_multi_tpu_torch import convert  # noqa: E402
from kimera_multi_tpu_torch.core import rng  # noqa: E402
from kimera_multi_tpu_torch.frontend.batched import make_verifier  # noqa
from kimera_multi_tpu_torch.frontend.dlc import FrontendConfig  # noqa
from kimera_multi_tpu_torch.io import synthetic  # noqa: E402
from kimera_multi_tpu_torch.kernels import _build  # noqa: E402

import kimera_multi_tpu_torch as pkg  # noqa: E402
assert pkg.__file__.startswith(sys.argv[1]), pkg.__file__
_build.build_all()
dev = torch.device("cuda")
S = synthetic.make_stores_np(6, 1024, 704, seed=0, n_false=1024,
                             invalid_tail=7)
st = convert.stores_from_numpy(S.desc, S.obs_valid, S.bearings, S.landmarks,
                               device=dev)
key = rng.base_key(0, device=dev)
out = {"tree": sys.argv[1]}
for name, cfg in (("5pt", FrontendConfig()),
                  ("8pt", FrontendConfig(use_5pt=False))):
    v = make_verifier(cfg, device=dev)
    for C in (1024, 1):
        idx = [torch.from_numpy(x[:C].astype(np.int64)).to(dev)
               for x in (S.qr, S.qf, S.tr, S.tm)]
        iters = 20 if C > 1 else 50
        for _ in range(3):
            v(key, *st, *idx)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        for _ in range(iters):
            v(key, *st, *idx)
        b.record()
        torch.cuda.synchronize()
        out[f"{name}_C{C}_event_ms"] = a.elapsed_time(b) / iters
        out[f"{name}_C{C}_host_ms"] = (time.perf_counter() - t) * 1e3 / iters
print(json.dumps(out), flush=True)
