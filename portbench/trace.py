"""The profiler's side of a traced run: a device-only torch.profiler
window (CUPTI kernel, copy and set records, and the CUDA runtime calls
that launched them; no host operator recording, which would slow the
host that paces this path), reduced from its Chrome trace to the records
the per-layer readers take.

Busy time is the union of the device operations' intervals, as the
port's `eval/profile.py` computes it; the traced window runs from the
first runtime call to the end of the last device operation.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA], acc_events=True)


def hand_written(name: str) -> bool:
    """A kernel of the port's csrc/*.cu: defined in an anonymous namespace
    at file scope (PyTorch's own sit in at::native and other namespaces),
    named *_kernel."""
    if "(anonymous namespace)::" not in name:
        return False
    head, tail = name.split("(anonymous namespace)::", 1)
    return "::" not in head and ("_kernel(" in tail or "_kernel<" in tail)


def short(name: str) -> str:
    """A kernel's name for the breakdown: a hand-written one's function
    name (template arguments kept), any other's first 96 characters."""
    if hand_written(name):
        return name.split("(anonymous namespace)::", 1)[1].split("(")[0]
    return name[:96]


def _union_us(iv) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(iv):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def read(prof) -> dict:
    """Reduce a finished profile: device ops (name, start, end in us),
    runtime calls, busy and window seconds."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    dev, rt = [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("cat") in _DEVICE:
            dev.append((e["name"], a, b, e["cat"]))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            rt.append((e["name"], a, b))
    if not dev:
        return {"device_ops": [], "runtime": rt, "busy_s": 0.0,
                "window_s": 0.0}
    start = min([a for _, a, _ in rt] + [a for _, a, _, _ in dev])
    end = max(b for _, _, b, _ in dev)
    busy = _union_us([(a, b) for _, a, b, _ in dev])
    return {"device_ops": dev, "runtime": rt, "busy_s": busy / 1e6,
            "window_s": (end - start) / 1e6}


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time
    between them summed by what the host was doing: the runtime call it
    was in at each gap's middle (a host in none was running Python and
    ATen between launches)."""
    by = defaultdict(float)
    for name, a, b, _ in tr["device_ops"]:
        by[short(name)] += (b - a) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    dev = sorted((a, b) for _, a, b, _ in tr["device_ops"])
    gaps, end = [], None
    for a, b in dev:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    rt = sorted((a, b, n) for n, a, b in tr["runtime"])
    starts = [a for a, _, _ in rt]
    named = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        what = "host between runtime calls"
        if i >= 0 and rt[i][1] >= mid:
            what = f"host in {rt[i][2]}"
        named[what] += (g1 - g0) / 1e6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
