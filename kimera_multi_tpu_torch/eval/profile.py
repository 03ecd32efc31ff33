"""Run-time profile of the distributed rounds and its op-level summary
(the role of the JAX package's `jax.profiler` trace plus
eval/xplane.py::summarize).

`trace(device)` is a torch.profiler context over the host and, on a CUDA
device, the card. `write(prof, trace_dir)` exports its Chrome trace
(`trace.json`) and writes `profile_summary.json` with the schema of the
JAX package's `xplane.summarize`:

    {"files": [...], "planes": [{"name", "total_event_ms",
     "busy_ms_by_line", "top_ops": [{"name", "total_ms", "count"}]}]}

with two planes: "host" (the aten and Python operations, one line per
thread) and "device" (kernels, copies and sets on the card, one line per
stream; no events on the CPU). `total_event_ms` sums event durations;
`busy_ms_by_line` is the union of each line's event intervals, so nested
host operations count once. Any failure raises: a profile that cannot be
summarised is an error, not a note.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def trace(device):
    """A torch.profiler context over the host and, for a CUDA `device`,
    the card."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, microseconds in,
    milliseconds out."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _plane(name: str, events, line_of, top: int) -> dict:
    op_tot, op_cnt = defaultdict(float), defaultdict(int)
    lines = defaultdict(list)
    for e in events:
        dur = float(e.get("dur", 0.0))
        op_tot[e["name"]] += dur
        op_cnt[e["name"]] += 1
        lines[line_of(e)].append((float(e["ts"]), float(e["ts"]) + dur))
    ranked = sorted(op_tot.items(), key=lambda kv: -kv[1])[:top]
    return {
        "name": name,
        "total_event_ms": round(sum(op_tot.values()) / 1e3, 3),
        "busy_ms_by_line": {k: round(_busy_ms(v), 3)
                            for k, v in sorted(lines.items())},
        "top_ops": [{"name": k, "total_ms": round(v / 1e3, 3),
                     "count": op_cnt[k]} for k, v in ranked],
    }


def summarize(trace_dir: str, top: int = 15) -> dict:
    """The summary of every `*.json` Chrome trace under `trace_dir`
    (`profile_summary.json` excluded). Raises if there is none or if no
    trace holds a host event."""
    files = sorted(f for f in os.listdir(trace_dir)
                   if f.endswith(".json") and f != "profile_summary.json")
    if not files:
        raise FileNotFoundError(f"no Chrome trace under {trace_dir}")
    host, device = [], []
    for f in files:
        with open(os.path.join(trace_dir, f)) as fh:
            evs = json.load(fh)["traceEvents"]
        for e in evs:
            if e.get("ph") != "X" or "name" not in e or "ts" not in e:
                continue
            if e.get("cat") in _DEVICE_CATS:
                device.append(e)
            elif e.get("cat") in _HOST_CATS:
                host.append(e)
    if not host:
        raise ValueError(f"the traces under {trace_dir} hold no host event")
    stream = lambda e: f"stream {e.get('args', {}).get('stream', e['tid'])}"
    return {"files": files,
            "planes": [_plane("host", host, lambda e: f"thread {e['tid']}",
                              top),
                       _plane("device", device, stream, top)]}


def write(prof, trace_dir: str, top: int = 10) -> dict:
    """Export `prof`'s Chrome trace to trace_dir/trace.json, summarise it
    into trace_dir/profile_summary.json; returns the summary."""
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    summary = summarize(trace_dir, top=top)
    with open(os.path.join(trace_dir, "profile_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary
