#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from kimera_multi_tpu_torch/kernels/csrc with nvcc
and holds each of the nine against its plain PyTorch version at the shapes
of its path (and at ragged shapes): eight by exact equality, the
five-point kernel K6 (built with FMA contraction) by its stated contract
(`check_fivept`). Then it drives three paths:

  * loop-closure verification, `make_verifier(FrontendConfig())` with the
    default 5-point mono gate, over keyframe stores of 6 robots x 1024
    keyframes x 704 features in chunks of 1024 candidates with 500 RANSAC
    hypotheses, and the 8-point mono gate (`use_5pt=False`) over two of
    the chunks; checked against the generator's ground truth and against
    the same call forced through the plain versions (all but K6: equal;
    all of them: gates, stereo counts and poses equal);
  * the DB-wide Hamming top-2 search `hamming_top2_pallas` (its own entry
    point): the 704 descriptors of one keyframe against every descriptor
    the fleet's stores hold (4,325,376 rows), checked against its plain
    version and for the self-match the database contains;
  * the whole front-end, `BatchedFrontend(6, 1024, vocab,
    FrontendConfig()).process_all`, on `make_world(6, 1024, 704, seed=0)`
    with a vocabulary built as the JAX package's `cli/run.py` builds it:
    BoW vectors, the detection loop, compaction, verification. Checked:
    no accepted loop joins keyframes of different ground-truth places, and
    the detection on the card equals the detection on the CPU for
    `make_world(6, 256, 704, seed=1)`.

K7, K8 and K9 are also held to their plain versions on inputs built so
that hundreds of residuals sit on the threshold or one ulp beside it (the
boundary phase).

Kernel counts are set to 0 just before each path and read just after;
kernels (device time) and stages (as the caller sees them) are timed with
CUDA events or the host clock around synchronised work.

Every phase is fatal: a kernel that does not build, launch or agree, a
wrong result, or no GPU ends the run with a non-zero exit code. The last
line of the output is {"ok": true, "device": {...}}; the two lines before
it are JSON objects {"kernels": [...]} and {"stages": {...}}.

    python3 chip_smoke.py --profile

also traces one verification chunk of the default configuration and a
window of detection steps with torch.profiler and prints {"profile": ...}
and {"profile_detect": ...} lines: device kernels launched per chunk (per
step), the device's busy time and idle share, and the kernels that take
most of the device time.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROBOTS, N_FRAMES, K_FEAT = 6, 1024, 704
CHUNK, N_HYP = 1024, 500
SUB = 64            # candidates per call of a plain version (memory)
SUB_PATH = 32       # candidates of the whole-path plain comparison
# ransac_essential_5pt's defaults
N_STARTS, GN_ITERS, PRESEL_PTS, PRESEL_MODELS = 8, 8, 64, 128

# Peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32 flop/s outside
# the tensor cores, dense int8 tensor-core operations/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12
# Integer pipes per SM and clock for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): 32-bit add and
# bitwise operations 64, population count 16; 132 SMs at the 1.98 GHz boost
# clock.
N_SM, CLOCK_HZ = 132, 1.98e9
INT_PER_CLK, POPC_PER_CLK = 64, 16
# f32 operations of one residual: rigid (R p + t, difference, squared
# norm, compare) and Sampson (E f1, two rows of E^T f2, numerator,
# denominator, division, compare)
OPS_RIGID, OPS_SAMPSON = 26, 40
# int8 pair search epilogue: one IMAD and three IMNMX per (query, target)
OPS_TOP2_EPILOGUE = 4
# K6's contract against its plain version (FMA contraction). Before the
# polish, on every clean hypothesis h: max abs difference at most
# FIVEPT_GN0_MAX + FIVEPT_COND_GAIN * cond_h * U32, where cond_h is the
# condition number of its 5 x 9 design, the factor by which a design's
# rounding (U32, float32's unit roundoff) can move its nullspace. After
# the polish, the share of entries within FIVEPT_TOL; and the kernel's own
# models solve clean samples.
U32 = 2.0 ** -24
FIVEPT_GN0_MAX, FIVEPT_COND_GAIN, FIVEPT_TOL = 3e-5, 16.0, 1e-3
FIVEPT_SHARE, FIVEPT_SOLVED = 0.98, 0.95
# residuals within one ulp of the threshold that each launch of the
# boundary phase must hold
BOUNDARY_MIN = 100
# accepted same-place loops of the front-end run (make_world(6, 1024, 704,
# seed=0), FrontendConfig()) with the unfused five-point kernel
FE_ACCEPTED_BEFORE = 22972


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one fn(): the calls are queued behind a spin kernel
    of ~10 ms, so the host's enqueue time (tens of microseconds per wrapper
    call, more than a short kernel runs) is hidden and they execute back
    to back between the two events."""
    fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def over_subbatches(fn, tensors, sub=SUB):
    """fn over slices of `sub` candidates, results concatenated."""
    C = tensors[0].shape[0]
    outs = [fn(*(t[i:i + sub] for t in tensors)) for i in range(0, C, sub)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def elementwise_ops(fn) -> int:
    """Arithmetic operations fn() performs, one per output element of each
    elementwise add/sub/mul/div/sqrt/clamp/neg/reciprocal it dispatches.
    Run on one-element tensors this is the work of one kernel thread."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "sqrt", "clamp", "neg",
             "reciprocal"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in arith:
                Count.n += out.numel()
            return out

    with Count():
        fn()
    return Count.n


def hamming_bound(pairs: int, n_bytes: int):
    """Least time of a Hamming search over `pairs` (query, target) pairs of
    256-bit rows, by two routes: packed words (per pair 8 XOR + 8 POPC + 8
    ADD on the integer pipes) and an int8 tensor-core product of the {0,1}
    bits (2 x 256 operations per pair, exact with int32 sums), each no
    faster than its bytes. The bound is the faster route. Returns
    (bound_ms, bound_by, ops of that route, routes)."""
    words = 8 * pairs
    popc_ms = words / (POPC_PER_CLK * N_SM * CLOCK_HZ) * 1e3
    xor_add_ms = 2 * words / (INT_PER_CLK * N_SM * CLOCK_HZ) * 1e3
    tc_ops = 2 * 256 * pairs
    tc_ms = tc_ops / PEAK_INT8 * 1e3
    epi_ops = OPS_TOP2_EPILOGUE * pairs
    epi_ms = epi_ops / (INT_PER_CLK * N_SM * CLOCK_HZ) * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    popc_route = max(popc_ms, xor_add_ms, bytes_ms)
    tc_route = max(tc_ms, bytes_ms)
    best = min(popc_route, tc_route)
    if tc_route <= popc_route:
        ops, by = tc_ops, "operations" if tc_ms >= bytes_ms else "bytes"
    else:
        ops, by = 3 * words, "operations" if popc_route > bytes_ms else "bytes"
    return best, by, ops, {
        "popc_ms": popc_ms, "xor_add_ms": xor_add_ms,
        "popc_route_ms": popc_route, "int8_tensor_core_ms": tc_ms,
        "int8_route_ms": tc_route, "bytes_ms": bytes_ms,
        # the int8 route's top-2 over the product (IMAD + 3 IMNMX per
        # element on the integer pipes); overlapped with the tensor cores
        # in the best case, so not part of the bound
        "int8_epilogue_ms": epi_ms, "int8_epilogue_ops": epi_ops,
        "popc_ops": words, "xor_add_ops": 2 * words, "int8_ops": tc_ops,
        "clock_hz": CLOCK_HZ, "sms": N_SM}


def f32_routes(n_bytes: int, n_ops: int) -> dict:
    """Both floors of an f32 kernel: every multiply-add pair fused into one
    FFMA (67e12 operations/s, the table's bound) and one instruction per
    operation (33.5e12/s, a build with -fmad=false), each no faster than
    the bytes."""
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return {"fused_ms": max(n_ops / PEAK_F32 * 1e3, bytes_ms),
            "one_instruction_per_operation_ms": max(
                n_ops / (PEAK_F32 / 2) * 1e3, bytes_ms),
            "bytes_ms": bytes_ms}


def profile_chunk(full, full_ms: float) -> dict:
    """One chunk of the main path under torch.profiler: how many device
    kernels it launches, how long the device is busy, which kernels take
    the time. `full_ms` is the chunk's time without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    full()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        full()
        torch.cuda.synchronize()
    return device_summary(prof, full_ms)


def profile_detect_steps(detect, step_ms: float, first: int,
                         n: int) -> dict:
    """`n` steps around step `first` of one whole detection run under
    torch.profiler. The loop's one call per step of
    `lcd.normalize_scores` marks the step boundaries (the profiler's
    schedule records only that window); the library is left as it is once
    the run ends. `step_ms` is a step's time without the profiler."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from kimera_multi_tpu_torch.frontend import lcd

    real = lcd.normalize_scores
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=first - 1, warmup=1, active=n,
                                   repeat=1)) as prof:
        def marked(*args, **kwargs):
            prof.step()
            return real(*args, **kwargs)

        lcd.normalize_scores = marked
        try:
            detect()
            torch.cuda.synchronize()
        finally:
            lcd.normalize_scores = real
    out = device_summary(prof, step_ms * n)
    if "device_kernels_per_chunk" in out:
        out = {"device_kernels_per_step":
               out.pop("device_kernels_per_chunk") / n,
               "device_busy_ms_per_step": out["device_busy_ms"] / n,
               "step_ms_unprofiled": step_ms, **out}
        out.pop("chunk_ms_unprofiled")
    # the window runs from one call of normalize_scores to the n-th after
    out["window_steps"] = (f"{n} steps, from the middle of step {first - 1} "
                           f"to the middle of step {first + n - 1}")
    return out


def device_summary(prof, wall_ms: float) -> dict:
    """Device kernels of a finished profile: their count, the device's busy
    time, the idle share against `wall_ms` (the same work's time without
    the profiler), which kernels take the time."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.events():
        # the schedule's own step ranges are annotations, not kernels
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith("ProfilerStep")):
            continue
        us = getattr(e, "device_time", None)
        if us is None:
            us = getattr(e, "cuda_time", 0.0)
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + float(us))
    busy_ms = sum(t for _, t in by_name.values()) / 1e3
    if busy_ms <= 0:
        return {"device_time": "not measured (the profiler reported no "
                               "device events)"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # this repo's kernels (in an anonymous namespace at file scope, unlike
    # PyTorch's at::native ones), template instances
    # (`presel_counts_kernel<true>`) included
    own = [(k, v) for k, v in by_name.items()
           if "(anonymous namespace)::" in k
           and "::" not in k.split("(anonymous namespace)::")[0]
           and ("_kernel(" in k or "_kernel<" in k)]
    return {
        "device_kernels_per_chunk": sum(n for n, _ in by_name.values()),
        "distinct_kernels": len(by_name),
        "device_busy_ms": busy_ms,
        "chunk_ms_unprofiled": wall_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top_kernels": [{"name": k[:80], "count": n, "ms": t / 1e3}
                        for k, (n, t) in top],
        "hand_written_kernels": [
            {"name": k.split("::")[1].split("(")[0], "count": n,
             "ms": t / 1e3} for k, (n, t) in own],
    }


def clean_fivept_samples(C: int, H: int, seed: int):
    """Clean minimal samples of rigid two-view scenes, (C, 15, H) per side
    (row 3 j + d = coordinate d of sample j), on the host."""
    rs = np.random.default_rng(seed)
    P = rs.uniform(-3, 3, (C, H, 5, 3))
    P[..., 2] = rs.uniform(3, 9, (C, H, 5))
    w = rs.normal(0, 0.3, (C, 3))
    th = np.linalg.norm(w, axis=1)[:, None, None]
    k = w / th[:, :, 0]
    Kx = np.zeros((C, 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2], Kx[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    Kx = Kx - Kx.transpose(0, 2, 1)
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = rs.uniform(-0.5, 0.5, (C, 3))
    P2 = np.einsum("chkj,cji->chki", P - t[:, None, None, :], R)
    out = []
    for X in (P, P2):
        f = X / np.linalg.norm(X, axis=-1, keepdims=True)
        out.append(torch.from_numpy(np.ascontiguousarray(
            f.transpose(0, 2, 3, 1).reshape(C, 15, H).astype(np.float32))))
    return out


# Boundary inputs of K8, K7 and K9: residuals placed on the threshold, or a
# few ulps beside it, in the plain versions' float32 operations (numpy float32
# replays them), by walking one or two inputs of a designated residual
# over a grid of ulps; a residual whose walk lands on no target keeps its
# nearest value. Some models hold NaN, +-inf or zeros; the last candidate
# but one has no valid point, the last one a single one.


def _rows32(M, x):
    """Rows of M x for M (..., 3, 3), x (..., 3), summed left to right."""
    return [(M[..., i, 0] * x[..., 0] + M[..., i, 1] * x[..., 1])
            + M[..., i, 2] * x[..., 2] for i in range(3)]


def _walk(x, steps):
    """float32 x moved by each of `steps` ulps: (*x.shape, len(steps))."""
    bits = (x.view(np.int32)[..., None]
            + np.sign(x).astype(np.int32)[..., None] * steps)
    return bits.astype(np.int32).view(np.float32)


def _land(vals, target, xs):
    """Move each x of `xs` ((x, steps) pairs, the grid axes of `vals` in
    order) to the first grid point whose value equals `target`."""
    hit = vals.reshape(*target.shape, -1) == target[..., None]
    j, ok = hit.argmax(-1), hit.any(-1)
    out = []
    for x, st in reversed(xs):
        j, k = np.divmod(j, len(st))
        moved = np.take_along_axis(_walk(x, st), k[..., None], -1)[..., 0]
        out.append(np.where(ok, moved, x))
    return out[::-1]


def _near(x, t):
    """x within one float32 ulp of t, on either side."""
    t = np.float32(t)
    return ((x >= np.nextafter(t, np.float32(0)))
            & (x <= np.nextafter(t, np.float32(np.inf))))


def _sampson32(E, a, b):
    """Squared Sampson error of E (..., 3, 3) at bearings a, b (..., 3)."""
    ef, et = _rows32(E, a), _rows32(np.swapaxes(E, -1, -2), b)
    num = (b[..., 0] * ef[0] + b[..., 1] * ef[1]) + b[..., 2] * ef[2]
    den = ((ef[0] * ef[0] + ef[1] * ef[1]) + et[0] * et[0]) + et[1] * et[1]
    return (num * num) / np.maximum(den, np.float32(1e-12))


def _valid(rs, C, K, share):
    v = rs.uniform(size=(C, K)) < share
    v[C - 2] = False
    v[C - 1] = False
    v[C - 1, 4] = True
    return v


def rigid_boundary(rs, C, H, K, thr, share):
    """K8's inputs (R, t, p, q, valid) with ||q_k - (R_h p_k + t_h)||^2 of
    h = k % H at float32(thr^2) or one ulp below or above it, and the
    number of residuals of valid points within one ulp of it."""
    from kimera_multi_tpu_torch.io.synthetic import _so3_exp_np

    T = np.float32(thr * thr)
    tg = np.array([np.nextafter(T, np.float32(0)), T,
                   np.nextafter(T, np.float32(np.inf))])[np.arange(K) % 3]
    s = np.sqrt(float(T))
    R = _so3_exp_np(rs.normal(0, 0.6, (C, H, 3)))
    t = rs.uniform(-s / 2, s / 2, (C, H, 3)).astype(np.float32)
    p = rs.uniform(-s, s, (C, 3, K)).astype(np.float32)
    h = np.arange(K) % H
    w = _rows32(R[:, h], np.moveaxis(p, 1, -1))
    w = [w[i] + t[:, h, i] for i in range(3)]
    u = rs.normal(size=(C, K, 3))
    u = (s * u / np.linalg.norm(u, axis=-1, keepdims=True)).astype(np.float32)
    q = np.stack([w[i] + u[..., i] for i in range(3)], 1)
    st = np.arange(-12, 13)
    r0 = _walk(q[:, 0], st)[..., :, None] - w[0][..., None, None]
    r1 = _walk(q[:, 1], st)[..., None, :] - w[1][..., None, None]
    r2 = (q[:, 2] - w[2])[..., None, None]
    q[:, 0], q[:, 1] = _land((r0 * r0 + r1 * r1) + r2 * r2,
                             np.broadcast_to(tg, (C, K)),
                             [(q[:, 0], st), (q[:, 1], st)])
    R[:, H - 1, 0, 0] = np.nan
    R[:, H - 2, 1, 2] = np.inf
    R[:, H - 3, 2, 1] = -np.inf
    t[:, H - 4, 0] = np.inf
    R[:, H - 5], t[:, H - 5] = 0, 0
    valid = _valid(rs, C, K, share)
    with np.errstate(invalid="ignore"):
        w = _rows32(R[:, :, None], np.moveaxis(p, 1, -1)[:, None])
        r = [q[:, None, i] - (w[i] + t[:, :, None, i]) for i in range(3)]
        d2 = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]
    return (R, t, p, np.ascontiguousarray(q), valid), int(
        (_near(d2, T) & valid[:, None]).sum())


# ulps from the threshold at which the Sampson boundary residuals (K7, K9)
# are placed: half within one ulp, the rest across the band where the
# kernels' rule divides (|n / d - thr| within about thr 2^-20: 4 - 16 ulps)
# and just outside it
SAMPSON_OFFSETS = np.array([-1, 0, 1, -1, 0, 1, -4, 4, -8, 8, -12, 12,
                           -16, 16])


def bearings_on_threshold(rs, Em, a, thr):
    """f2 bearings b (C, P, 3) with the squared Sampson error of model
    Em[:, p] (C, P, 3, 3) at (a_p, b_p) SAMPSON_OFFSETS[p % 14] ulps from
    float32(thr). The first two rows of each model are orthogonal to its
    a, so num = f2 . (E f1) is mostly b2 (E f1)_2 and moves by about an ulp
    per ulp of b2: b2 comes from bisection in float64, then b0 and b2 are
    walked over a grid of ulps."""
    C, P = a.shape[:2]
    t32 = np.float32(thr)
    tg = _walk(np.array([t32]), SAMPSON_OFFSETS)[0][
        np.arange(P) % len(SAMPSON_OFFSETS)]
    ef = np.stack(_rows32(Em, a), -1).astype(np.float64)
    c2 = rs.normal(size=(C, P, 2))
    c2 /= np.linalg.norm(c2, axis=-1, keepdims=True)

    def bearing(b2):
        r = np.sqrt(1 - b2 * b2)
        return np.stack([c2[..., 0] * r, c2[..., 1] * r, b2], -1)

    lo, hi = np.zeros((C, P)), np.ones((C, P))
    for _ in range(60):   # num^2 - thr den changes sign for b2 in [0, 1]
        mid = (lo + hi) / 2
        b = bearing(mid)
        et = np.einsum("cpji,cpj->cpi", Em.astype(np.float64), b)
        num = np.sum(b * ef, -1)
        neg = num * num < float(t32) * (ef[..., 0] ** 2 + ef[..., 1] ** 2
                                        + et[..., 0] ** 2 + et[..., 1] ** 2)
        lo, hi = np.where(neg, mid, lo), np.where(neg, hi, mid)
    b = bearing(lo).astype(np.float32)
    s0, s2 = np.arange(-4, 5), np.arange(-32, 33)
    grid = np.stack(np.broadcast_arrays(
        _walk(b[..., 0], s0)[..., :, None], b[..., 1, None, None],
        _walk(b[..., 2], s2)[..., None, :]), -1)
    b[..., 0], b[..., 2] = _land(
        _sampson32(Em[:, :, None, None], a[:, :, None, None], grid),
        np.broadcast_to(tg, (C, P)), [(b[..., 0], s0), (b[..., 2], s2)])
    return b


def presel_boundary(rs, C, H, S, P, thr, share):
    """K7's inputs (rows (C, 9 S, H), f1, f2 (C, 3, P), valid) with the
    squared Sampson error of model p (flat (h, s) order) at point p on the
    threshold (`bearings_on_threshold`), and the number of residuals of
    valid points within one ulp of it. Model p's first two rows are made
    orthogonal to a random f1_p."""
    a = rs.normal(size=(C, P, 3))
    a = (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    a64 = a.astype(np.float64)
    E = rs.normal(size=(C, H * S, 3, 3))   # model p scores point p
    Em = E[:, :P]
    for i in (0, 1):
        Em[..., i, :] -= np.sum(Em[..., i, :] * a64, -1, keepdims=True) * a64
    Em[..., 2, :] = a64 + 0.3 * Em[..., 2, :]
    E = E.astype(np.float32)
    b = bearings_on_threshold(rs, E[:, :P], a, thr)
    # all NaN: the models of a candidate without correspondences
    E[:, (H - 1) * S:] = np.nan
    E[:, (H - 2) * S, 0, 0] = np.inf
    E[:, (H - 2) * S + 1, 1, 2] = -np.inf
    E[:, (H - 2) * S + 2] = np.inf
    E[:, (H - 3) * S:(H - 2) * S] = 0
    valid = _valid(rs, C, P, share)
    with np.errstate(invalid="ignore"):
        err = _sampson32(E[:, :, None], a[:, None], b[:, None])
    rows = E.reshape(C, H, S, 9).transpose(0, 3, 2, 1).reshape(C, 9 * S, H)
    return (np.ascontiguousarray(rows), np.ascontiguousarray(
        np.moveaxis(a, -1, 1)), np.ascontiguousarray(np.moveaxis(b, -1, 1)),
        valid), int((_near(err, thr) & valid[:, None]).sum())


def essential_boundary(rs, C, H, K, thr, share):
    """K9's inputs (E (C, H, 3, 3), f1, f2 (C, 3, K), valid) with the
    squared Sampson error of model k % H at point k on the threshold
    (`bearings_on_threshold`), and the number of residuals of valid points
    within one ulp of it. Point k's f1 is the unit normal of its model's
    first two rows, of random sign. Some models hold NaN, +-inf or zeros;
    every model of candidate C - 2 (no valid point) is NaN, as
    `ransac_essential` passes them."""
    E = rs.normal(size=(C, H, 3, 3))
    n = np.cross(E[..., 0, :], E[..., 1, :])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    E[..., 2, :] = n + 0.3 * E[..., 2, :]
    E = E.astype(np.float32)
    h = np.arange(K) % H
    sign = np.where(rs.uniform(size=(C, K, 1)) < 0.5, -1.0, 1.0)
    a = (sign * n[:, h]).astype(np.float32)
    b = bearings_on_threshold(rs, E[:, h], a, thr)
    E[:, H - 1] = np.nan
    E[:, H - 2, 0, 0] = np.inf
    E[:, H - 3, 1, 2] = -np.inf
    E[:, H - 4] = np.inf
    E[:, H - 5] = 0
    E[C - 2] = np.nan
    valid = _valid(rs, C, K, share)
    with np.errstate(invalid="ignore"):
        err = _sampson32(E[:, :, None], a[:, None], b[:, None])
    return (E, np.ascontiguousarray(np.moveaxis(a, -1, 1)),
            np.ascontiguousarray(np.moveaxis(b, -1, 1)), valid), int(
        (_near(err, thr) & valid[:, None]).sum())


def boundary_phase(dev, check) -> dict:
    """Boundary counts: K8, K7 and K9 against their plain versions on
    inputs whose residuals sit on the threshold (`rigid_boundary`,
    `presel_boundary`, `essential_boundary`), for the path's, power-of-two
    and other thresholds, with every point valid or 60 % scattered. Fails
    unless the counts are equal and each launch has at least BOUNDARY_MIN
    residuals of valid points within one ulp of its threshold. Returns
    those numbers."""
    from kimera_multi_tpu_torch.kernels import fivept, score

    rs, rs9 = np.random.default_rng(11), np.random.default_rng(12)
    C, H, K, S, P = 6, 45, 1101, 8, 300
    out = {}
    for share in (1.0, 0.6):
        for thr in (0.3, 0.25):   # the path's stereo threshold; thr^2 2^-4
            inputs, near = rigid_boundary(rs, C, H, K, thr, share)
            args = [torch.from_numpy(x).to(dev) for x in inputs]
            what = f"C={C} K={K} H={H} thr={thr:g} valid {share:g}"
            check("rigid_counts", score.rigid_counts(*args, thr),
                  score.rigid_counts_ref(*args, thr), what)
            out[f"rigid_counts {what}"] = near
        for thr in (1e-6, 0.05, 0.0625):   # the path's; 0.05; 2^-4
            inputs, near = presel_boundary(rs, C, H, S, P, thr, share)
            args = [torch.from_numpy(x).to(dev) for x in inputs]
            what = f"C={C} H={H} S={S} P={P} thr={thr:g} valid {share:g}"
            check("presel_counts", fivept.presel_counts(*args, thr, S),
                  fivept.presel_counts_ref(*args, thr, S), what)
            out[f"presel_counts {what}"] = near
            inputs, near = essential_boundary(rs9, C, H, K, thr, share)
            args = [torch.from_numpy(x).to(dev) for x in inputs]
            what = f"C={C} K={K} H={H} thr={thr:g} valid {share:g}"
            check("essential_counts", score.essential_counts(*args, thr),
                  score.essential_counts_ref(*args, thr), what)
            out[f"essential_counts {what}"] = near
    log(f"  boundary counts: residuals of valid points within one ulp of "
        f"the threshold per launch {out} (limit: at least {BOUNDARY_MIN})")
    low = {k: n for k, n in out.items() if n < BOUNDARY_MIN}
    if low:
        fail(f"boundary counts: too few residuals on the threshold {low}")
    return out


def fivept_solved(rows, f1, f2, S: int) -> float:
    """Share of hypotheses with a start whose model fits its 5 sample
    constraints: max |f2^T E f1| over the sample below 5e-4."""
    from kimera_multi_tpu_torch.kernels import fivept

    C, _, H = rows.shape
    Et = fivept.models_to_flat(rows, S).reshape(C, H, S, 3, 3)
    a = f1.reshape(C, 5, 3, H).permute(0, 3, 1, 2)
    b = f2.reshape(C, 5, 3, H).permute(0, 3, 1, 2)
    resid = torch.einsum("chkj,chsji,chki->chsk", b, Et, a).abs().amax(-1)
    return float((resid.amin(-1) < 5e-4).float().mean())


def design_cond(f1, f2):
    """(C, H) condition number sigma_1 / sigma_5 of each hypothesis's
    5 x 9 epipolar design, in float64."""
    C, _, H = f1.shape
    a = f1.double().reshape(C, 5, 3, H).permute(0, 3, 1, 2)
    b = f2.double().reshape(C, 5, 3, H).permute(0, 3, 1, 2)
    sv = torch.linalg.svdvals(torch.einsum("nhkr,nhkq->nhkrq", b, a)
                              .reshape(C, H, 5, 9))
    return sv[..., 0] / sv[..., 4]


def fivept_limit_use(got, ref, cond) -> torch.Tensor:
    """(C, H) per hypothesis: max abs difference over the entries finite in
    both, over its limit FIVEPT_GN0_MAX + FIVEPT_COND_GAIN * cond * U32
    (at most 1 where it holds; 0 where no entry is finite)."""
    fin = torch.isfinite(got) & torch.isfinite(ref)
    err = torch.where(fin, (got.double() - ref.double()).abs(),
                      torch.zeros((), dtype=torch.float64,
                                  device=got.device)).amax(1)
    return err / (FIVEPT_GN0_MAX + FIVEPT_COND_GAIN * cond * U32)


def check_fivept(what: str, got, ref, gn_iters: int, gated: bool,
                 cond=None) -> dict:
    """K6 against its plain version by its contract: the NaN/finite pattern
    equal; over the entries finite in both, at gn_iters = 0 every
    hypothesis within its limit (`fivept_limit_use`), after the polish at
    least FIVEPT_SHARE of the entries within FIVEPT_TOL. `gated` False
    (samples that are not clean minimal samples) checks the pattern only
    and reports the rest."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"fivept_models ({what}): shape/dtype {got.shape} {got.dtype} "
             f"vs {ref.shape} {ref.dtype}")
    same = torch.equal(torch.isfinite(got), torch.isfinite(ref))
    fin = torch.isfinite(got) & torch.isfinite(ref)
    d = (got - ref).abs()[fin]
    err = float(d.max()) if d.numel() else 0.0
    share = float((d <= FIVEPT_TOL).float().mean()) if d.numel() else 1.0
    out = {"max_abs_err": err, "share_within_tol": share}
    if gn_iters == 0 and cond is not None:
        use = fivept_limit_use(got, ref, cond)
        out["max_limit_use"] = float(use.max())
        out["hypotheses_over_limit"] = int((use > 1).sum())
        limit = (f"max over hypotheses of difference / limit "
                 f"{out['max_limit_use']:.4f}, "
                 f"{out['hypotheses_over_limit']} over, limit 1")
    elif gn_iters == 0:
        limit = "limit per hypothesis from its design's condition number"
    else:
        limit = f"within {FIVEPT_TOL:g}: {share:.5f}, limit {FIVEPT_SHARE}"
    log(f"  {'fivept_models':22s} {what:34s} max_abs_err {err:g}  "
        f"NaN/finite pattern equal {same}  "
        f"({limit if gated else 'not gated: ' + limit})")
    if not same:
        fail(f"fivept_models ({what}): the kernel's NaN/finite pattern "
             f"differs from its plain version's")
    if gated and gn_iters == 0 and (
            cond is None or out["hypotheses_over_limit"]):
        fail(f"fivept_models ({what}): {out.get('hypotheses_over_limit')} "
             f"hypotheses beyond {FIVEPT_GN0_MAX:g} + {FIVEPT_COND_GAIN:g} "
             f"* cond * 2^-24 before the polish")
    if gated and gn_iters and share < FIVEPT_SHARE:
        fail(f"fivept_models ({what}): {share} of the entries within "
             f"{FIVEPT_TOL} (limit {FIVEPT_SHARE})")
    return out


def cond_scaled(got, ref, cond) -> dict:
    """Quantiles over hypotheses of max abs difference / (cond * U32)."""
    fin = torch.isfinite(got) & torch.isfinite(ref)
    err = torch.where(fin, (got.double() - ref.double()).abs(),
                      torch.zeros((), dtype=torch.float64,
                                  device=got.device)).amax(1)
    r = (err / (cond * U32)).flatten()
    q = torch.tensor([0.5, 0.99, 0.999], dtype=torch.float64,
                     device=r.device)
    return dict(zip(("p50", "p99", "p999"),
                    torch.quantile(r, q).tolist()), max=float(r.max()))


def db_top2_phase(desc_store, check) -> dict:
    """K2 through its own entry point at the DB-wide shape: the descriptors
    of keyframe (robot 0, frame 0) against every descriptor of the stores,
    then ragged shapes with ties. Returns the kernel's row."""
    from kimera_multi_tpu_torch.kernels import _build, hamming

    dev = desc_store.device
    K = desc_store.shape[2]
    flat = desc_store.reshape(-1, 32)
    Kt = flat.shape[0]
    bits_t = torch.empty((Kt, 256), dtype=torch.bfloat16, device=dev)
    step = 1 << 20
    for lo in range(0, Kt, step):
        bits_t[lo:lo + step] = hamming.unpack_bits(
            flat[lo:lo + step]).to(torch.bfloat16)
    bits_q = bits_t[:K].clone()
    Kq = K
    log(f"DB-wide top-2 (hamming_top2_pallas, tile_q=64, tile_t=512): "
        f"{Kq} queries against {Kt} rows, {bits_t.numel() * 2 / 1e9:.2f} GB "
        f"of bf16 bits on the card")
    _build.reset_launches()
    got = hamming.hamming_top2_pallas(bits_q, bits_t, tile_q=64, tile_t=512)
    torch.cuda.synchronize()
    launches = _build.launches["hamming_top2"]
    if launches != 1 or sum(_build.launches.values()) != 1:
        fail(f"hamming_top2_pallas launched {dict(_build.launches)}")
    ref = hamming._hamming_top2_ref(bits_q, bits_t)
    torch.cuda.synchronize()
    err = check("hamming_top2", got, ref, f"Kq={Kq} Kt={Kt} (DB-wide)")
    rows = torch.arange(Kq, device=dev, dtype=torch.int32)
    n_own = int((got[2] == rows).sum())
    if not (bool((got[0] == 0).all()) and bool((got[2] <= rows).all())):
        fail("DB-wide top-2: a query of the database did not find itself "
             "(or an equal earlier row) at distance 0")
    log(f"  hamming_top2 self-match: d1 == 0 for all {Kq} queries, i1 is "
        f"the query's own row for {n_own} (an equal earlier row otherwise)")

    # ragged sets: duplicated rows (ties), a query's exact copy on both
    # sides of a split boundary (query qs) and of a chunk boundary inside a
    # split (query qc); at Kq = 1500 those queries lie in the second and
    # in the third, ragged block of 704 queries
    rs = np.random.default_rng(5)
    cut = hamming._TOP2_TILE
    for Kq_, Kt_, n_splits, qs, qc in ((64, 512, None, 0, 1),
                                       (200, 3000, 7, 0, 1),
                                       (704, 8192, 5, 0, 1),
                                       (1500, 4000, 3, 1499, 705)):
        t = rs.integers(0, 256, (Kt_, 32), dtype=np.uint8)
        t[1::2] = t[0::2]
        q = t[rs.integers(0, Kt_, Kq_)].copy()
        q[:, 9] ^= rs.integers(1, 256, Kq_, dtype=np.uint8)
        split = hamming.top2_split_rows(Kq_, Kt_, n_splits, dev)
        t[split - 1] = t[split] = q[qs]
        if split > cut + 1:
            t[cut - 1] = t[cut] = q[qc]
        bq = hamming.unpack_bits(torch.from_numpy(q).to(dev)).to(
            torch.bfloat16)
        bt = hamming.unpack_bits(torch.from_numpy(t).to(dev)).to(
            torch.bfloat16)
        g = hamming._hamming_top2(bq, bt, n_splits)
        check("hamming_top2", g, hamming._hamming_top2_ref(bq, bt),
              f"Kq={Kq_} Kt={Kt_} split={split} (ties)")
        if int(g[2][qs]) != split - 1 or float(g[1][qs]) != 0.0:
            fail("hamming_top2: a tie across a split boundary did not keep "
                 "the first index")
        if split > cut + 1 and (int(g[2][qc]) != cut - 1
                                or float(g[1][qc]) != 0.0):
            fail("hamming_top2: a tie across a chunk boundary did not keep "
                 "the first index")

    n_bytes = (Kq + Kt) * 256 * 2 + Kq * 12
    b_ms, b_by, ops, routes = hamming_bound(Kq * Kt, n_bytes)
    ms = device_ms(lambda: hamming.hamming_top2_pallas(bits_q, bits_t, 64,
                                                       512), iters=10)
    plain_ms = time_ms(lambda: hamming._hamming_top2_ref(bits_q, bits_t),
                       iters=2, warmup=1)
    chunk = 65536

    def library():
        for lo in range(0, Kt, chunk):
            torch.mm(bits_q, bits_t[lo:lo + chunk].T)

    library_ms = device_ms(library, iters=5)
    rows = hamming.top2_split_rows(Kq, Kt, None, dev)
    blocks = -(-Kq // hamming._TOP2_QUERIES) * -(-Kt // rows)
    del bits_t
    torch.cuda.empty_cache()
    log(f"  hamming_top2           {ms:8.4f} ms  plain {plain_ms:9.3f} ms  "
        f"bound {b_ms:.4f} ms ({b_by}; popc route "
        f"{routes['popc_route_ms']:.3f}, int8 route "
        f"{routes['int8_route_ms']:.3f})  cuBLAS bf16 product {library_ms:.3f}")
    return {
        "name": "hamming_top2", "route": "cuda",
        "source": "kimera_multi_tpu_torch/kernels/csrc/hamming.cu",
        "replaces": "kimera_multi_tpu/kernels/hamming.py:308",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
        "library_call": "bits_q @ bits_t.T in bf16 over chunks of 65536 "
                        "targets (cuBLAS; no top-2)",
        "bytes": n_bytes, "ops": ops, "bound_routes": routes,
        "int8_route": "wgmma m64n176k32 s8 x s8 -> s32: queries as A "
                      "(2q - 1 bytes), database rows narrowed from bf16 "
                      "to -t bytes (0 / -1) as B",
        "layout": "all queries of a group of 704 in one block (11 tiles, "
                  "176 KB), one 176-row B stage, the next chunk loaded "
                  "through registers; one split of the database a block",
        "blocks": blocks, "rows_per_split": rows,
        "path": "its own entry point, hamming_top2_pallas; no path of the "
                "JAX package calls it",
        "shape": f"Kq={Kq} Kt={Kt} (one keyframe against the fleet's "
                 f"descriptors)"}


def frontend_phase(dev, profile: bool) -> dict:
    """The detection slice at full size: BatchedFrontend(6, 1024, vocab,
    FrontendConfig()).process_all on make_world(6, 1024, 704, seed=0),
    gated on ground-truth places; then the card's detection against the
    CPU's on make_world(6, 256, 704, seed=1). Returns the stage entries."""
    from kimera_multi_tpu_torch.frontend import batched, vocab as vocab_mod
    from kimera_multi_tpu_torch.frontend.dlc import FrontendConfig
    from kimera_multi_tpu_torch.io import sim_world
    from kimera_multi_tpu_torch.kernels import _build

    def world_and_vocab(R, T, seed):
        w = sim_world.make_world(n_robots=R, n_steps=T, features_per_kf=704,
                                 seed=seed)
        # the vocabulary as the JAX package's cli/run.py builds it
        corpus = w.descriptors[w.obs_valid].reshape(-1, 32)
        sub = corpus[:: max(1, len(corpus) // 4000)]
        return w, vocab_mod.build_vocabulary(sub, k=8, depth=3, seed=seed)

    t0 = time.time()
    world, voc = world_and_vocab(6, 1024, 0)
    host_s = time.time() - t0
    cfg = FrontendConfig()
    stores = tuple(torch.from_numpy(x).to(dev) for x in (
        world.descriptors, world.bearings_local, world.landmarks_local,
        world.obs_valid))
    R, T, K = world.obs_valid.shape
    log(f"front-end: world {R} x {T} x {K} and vocabulary (k=8, depth 3, "
        f"{int(voc.node_valid[-1].sum())} words) made on the host in "
        f"{host_s:.1f} s; FrontendConfig() (ransac_hyp={cfg.ransac_hyp}, "
        f"use_5pt={cfg.use_5pt})")

    def run():
        fe = batched.BatchedFrontend(R, T, voc, cfg, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = fe.process_all(*stores)
        torch.cuda.synchronize()
        return fe, dict(stats, t_process_all=time.perf_counter() - t)

    _build.reset_launches()
    fe, stats = run()
    launches = dict(_build.launches)
    log(f"front-end path: {stats['n_candidates']} candidates from "
        f"{stats['n_keyframes']} keyframes, {len(fe.loops)} accepted, "
        f"{stats['t_process_all']:.2f} s; kernel launches {launches}")
    if stats["n_candidates"] == 0:
        fail("the front-end detected no candidate")
    for name, n in launches.items():
        if name == "hamming_top2":
            if n:
                fail("process_all launched the DB-wide top-2 kernel")
        elif n == 0:
            fail(f"process_all never launched {name}")

    # gate (a): accepted loops join keyframes of one ground-truth place
    place = world.place_of_kf
    wrong = [lc for lc in fe.loops if place[lc.robot_a, lc.frame_a]
             != place[lc.robot_b, lc.frame_b]]
    n_intra = sum(lc.robot_a == lc.robot_b for lc in fe.loops)
    n_inter = len(fe.loops) - n_intra
    rot_err, t_err = [], []
    for lc in fe.loops:
        Ra, ta = world.R_gt[lc.robot_a, lc.frame_a], world.t_gt[
            lc.robot_a, lc.frame_a]
        Rb, tb = world.R_gt[lc.robot_b, lc.frame_b], world.t_gt[
            lc.robot_b, lc.frame_b]
        R_rel, t_rel = Ra.T @ Rb, Ra.T @ (tb - ta)
        c = (np.trace(R_rel.T @ np.asarray(lc.R, np.float64)) - 1) / 2
        rot_err.append(float(np.arccos(np.clip(c, -1.0, 1.0))))
        t_err.append(float(np.linalg.norm(np.asarray(lc.t) - t_rel)))
    status = np.bincount([lc.status for lc in fe.lcd_attempts], minlength=5)
    same = sum(place[lc.robot_a, lc.frame_a] == place[lc.robot_b, lc.frame_b]
               for lc in fe.lcd_attempts)
    log(f"front-end gates: accepted {len(fe.loops)} ({n_intra} intra-robot, "
        f"{n_inter} inter-robot), across different places {len(wrong)} "
        f"(limit 0); candidates within one place {same} of "
        f"{len(fe.lcd_attempts)}; attempts by status {status.tolist()}; "
        f"largest error "
        f"against the ground-truth relative pose: rotation "
        f"{max(rot_err):.3e} rad, translation {max(t_err):.3e} m")
    if wrong:
        fail(f"{len(wrong)} accepted loops join different places, e.g. "
             f"{wrong[0][:4]}")
    n_same = len(fe.loops)
    log(f"front-end: {n_same} accepted same-place loops; "
        f"{FE_ACCEPTED_BEFORE} with the unfused five-point kernel (limit: "
        f"no fewer than {FE_ACCEPTED_BEFORE * 0.999:.0f}, -0.1 %)")
    if n_same < FE_ACCEPTED_BEFORE * 0.999:
        fail(f"the front-end accepted {n_same} same-place loops, more than "
             f"0.1 % fewer than {FE_ACCEPTED_BEFORE}")
    if n_intra == 0 or n_inter == 0:
        fail("the front-end accepted no intra-robot or no inter-robot loop")
    if not (np.isfinite(rot_err).all() and np.isfinite(t_err).all()):
        fail("non-finite pose of an accepted loop")

    # the same run again, warm, for the times
    fe2, st = run()
    if [lc[:4] for lc in fe2.lcd_attempts] != [lc[:4] for lc in
                                                fe.lcd_attempts]:
        fail("a second process_all gave other candidates")
    out = {
        "fe_world": f"make_world({R}, {T}, {K}, seed=0)",
        "bow_ms": st["t_bow"] * 1e3, "detect_ms": st["t_scan"] * 1e3,
        "compact_ms": st["t_compact"] * 1e3,
        "fe_verify_ms": st["t_verify"] * 1e3,
        "process_all_ms": st["t_process_all"] * 1e3,
        "process_all_first_ms": stats["t_process_all"] * 1e3,
        "fe_keyframes_per_s": st["n_keyframes"] / st["t_process_all"],
        "fe_verifications_per_s": st["n_candidates"] / st["t_verify"],
        "fe_verify_chunks": st["verify_chunks"],
        "n_keyframes": st["n_keyframes"], "n_candidates": st["n_candidates"],
        "n_accepted": len(fe2.loops), "n_accepted_intra": n_intra,
        "n_accepted_same_place": n_same,
        "n_accepted_same_place_unfused_k6": FE_ACCEPTED_BEFORE,
        "n_accepted_inter": n_inter, "bow_overflow": fe2.bow_overflow,
        "fe_status_counts": status.tolist(),
        "fe_candidates_same_place": int(same),
        "fe_max_rot_err_rad": max(rot_err), "fe_max_t_err_m": max(t_err),
        "fe_launches": launches, "fe_host_world_s": host_s,
    }
    log(f"front-end times (warm): bow {out['bow_ms']:.1f} ms, detect "
        f"{out['detect_ms']:.1f} ms, compact {out['compact_ms']:.1f} ms, "
        f"verify {out['fe_verify_ms']:.1f} ms, process_all "
        f"{out['process_all_ms']:.1f} ms")

    if profile:
        ids, w, qi, qw, _ = fe2._bow_all(stores[0], stores[3])
        kfv = stores[3].any(-1)
        prof = profile_detect_steps(
            lambda: fe2._detect(ids, w, qi, qw, kfv),
            st["t_scan"] * 1e3 / T, first=T // 2, n=32)
        print(json.dumps({"profile_detect": prof}), flush=True)
    del fe, fe2, stores

    # gate (b): detection on the card equals detection on the CPU
    world_b, voc_b = world_and_vocab(6, 256, 1)
    Rb, Tb = world_b.obs_valid.shape[:2]
    res = []
    for d in (dev, torch.device("cpu")):
        fe = batched.BatchedFrontend(Rb, Tb, voc_b, cfg, device=d)
        ids, w, qi, qw, ovf = fe.compute_bows(world_b.descriptors,
                                              world_b.obs_valid)
        det, _ = batched.make_detector(Rb, Tb, cfg, device=d)(
            ids, w, qi, qw, world_b.obs_valid.any(-1))
        res.append((ids, w, ovf, [x.cpu() for x in det]))
    (ci, cw, co, cd), (hi, hw, ho, hd) = res
    same = (np.array_equal(ci, hi) and co == ho
            and torch.equal(cd[0], hd[0]) and torch.equal(cd[2], hd[2]))
    w_rel = float(np.max(np.abs(cw - hw) / np.maximum(np.abs(hw), 1e-30)))
    s_rel = float(((cd[1] - hd[1]).abs()
                   / hd[1].abs().clamp(min=1e-30)).max())
    log(f"front-end card vs CPU on make_world(6, 256, 704, seed=1): BoW ids, "
        f"overflow, detected and match equal: {same}; {int(hd[2].sum())} "
        f"detections; max relative difference of BoW weights {w_rel:.2e}, of "
        f"island scores {s_rel:.2e} (limit 1e-6)")
    if not same or w_rel > 1e-6 or s_rel > 1e-6:
        fail("the front-end's detection on the card differs from the CPU's")
    out["fe_card_equals_cpu_detections"] = int(hd[2].sum())
    return out


def main() -> None:
    t_start = time.time()
    # ------------------------------------------------------------------ 1
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    dev = torch.device("cuda")

    from kimera_multi_tpu_torch import convert
    from kimera_multi_tpu_torch.core import rng
    from kimera_multi_tpu_torch.frontend.batched import make_verifier
    from kimera_multi_tpu_torch.frontend.dlc import FrontendConfig
    from kimera_multi_tpu_torch.io import synthetic
    from kimera_multi_tpu_torch.kernels import (_build, fivept, gather,
                                                hamming, minimal, ransac,
                                                score)

    # ------------------------------------------------------------------ 2
    t0 = time.time()
    _build.build_all()
    for fns in _build.SOURCES.values():
        for fn in fns:
            _build.get_fn(fn)
    build_s = time.time() - t0
    log(f"built and loaded {len(_build.SOURCES)} CUDA sources in "
        f"{build_s:.1f} s")

    # ------------------------------------------------------- stores, inputs
    t0 = time.time()
    # frame i has its last i % 8 features unobserved, so validity masks
    # differ from candidate to candidate
    S = synthetic.make_stores_np(N_ROBOTS, N_FRAMES, K_FEAT, seed=0,
                                 n_false=CHUNK, invalid_tail=7)
    stores = convert.stores_from_numpy(S.desc, S.obs_valid, S.bearings,
                                       S.landmarks, device=dev)
    desc_store, obs_store, bear_store, lm_store = stores
    n_cand = len(S.qr)
    n_chunks = n_cand // CHUNK
    assert n_chunks * CHUNK == n_cand and n_chunks >= 3
    store_mb = sum(t.numel() * t.element_size() for t in stores) / 1e6
    log(f"stores {tuple(desc_store.shape)} on {dev}: {store_mb:.0f} MB, "
        f"{n_cand} candidates in {n_chunks} chunks of {CHUNK} "
        f"({time.time() - t0:.1f} s on the host)")
    cfg = FrontendConfig(ransac_hyp=N_HYP)                 # the default
    cfg8 = FrontendConfig(use_5pt=False, ransac_hyp=N_HYP)
    if not cfg.use_5pt:
        fail("the default FrontendConfig does not take the 5-point gate")
    verify_many = make_verifier(cfg, device=dev)
    verify_8pt = make_verifier(cfg8, device=dev)
    base_key = rng.base_key(cfg.base_seed, device=dev)
    thr = cfg.mono_threshold

    def chunk_idx(i):
        sl = slice(i * CHUNK, (i + 1) * CHUNK)
        return tuple(torch.from_numpy(x[sl].astype(np.int64)).to(dev)
                     for x in (S.qr, S.qf, S.tr, S.tm))

    # the tensors the main path hands to each kernel, for chunk 0
    qr, qf, tr, tm = chunk_idx(0)
    dq, vq = desc_store[qr, qf], obs_store[qr, qf]
    dm, vm = desc_store[tr, tm], obs_store[tr, tm]
    m, _ = hamming.knn2_lowe_match_pairs(dq, vq, dm, vm, cfg.lowe_ratio)
    matched, idx = m >= 0, torch.clamp(m, min=0)
    bq, lq = bear_store[qr, qf], lm_store[qr, qf]
    bm, lm = bear_store[tr, tm], lm_store[tr, tm]
    bm_m, lm_m = gather.permute_cols(bm, idx), gather.permute_cols(lm, idx)
    keys = rng.derive(base_key, qr, qf, tr, tm)
    kmono = rng.derive(keys, rng.Stream.RANSAC_MONO)
    kst = rng.derive(keys, rng.Stream.RANSAC_STEREO)
    picks5, order, inv_order = ransac._masked_sample_parts(
        kmono, matched, N_HYP, 5)
    picks8, _, _ = ransac._masked_sample_parts(kmono, matched, N_HYP, 8)
    picks3, _, _ = ransac._masked_sample_parts(kst, matched, N_HYP, 3)
    # 5-point path: samples -> raw models -> preselect counts -> survivors
    g1 = gather.sample_gather_perm_t(bq, picks5, order, inv_order)
    g2 = gather.sample_gather_perm_t(bm_m, picks5, order, inv_order)
    E_rows = fivept.fivept_models(g1, g2, N_STARTS, GN_ITERS, project=False)
    head = order[:, :PRESEL_PTS, None].contiguous()
    f1p = gather.sample_gather_t(bq, head)
    f2p = gather.sample_gather_t(bm_m, head)
    validp = (torch.arange(PRESEL_PTS, device=dev)[None, :]
              < matched.sum(1)[:, None])
    counts_hs = fivept.presel_counts(E_rows, f1p, f2p, validp, thr, N_STARTS)
    E_sel = minimal._project_essential(fivept.select_models(
        E_rows, counts_hs, PRESEL_MODELS, N_STARTS)[0])[0].contiguous()
    # 8-point and stereo hypotheses
    E_h, _ = ransac.solve_essential_hyps(bq, bm_m, picks8, order, inv_order)
    R_h, t_h, _ = ransac.solve_arun_hyps(lq, lm_m, picks3, order, inv_order)
    E_h, R_h, t_h = E_h.contiguous(), R_h.contiguous(), t_h.contiguous()
    torch.cuda.synchronize()

    # ------------------------------------------------------------------ 3
    # each kernel against its plain version: main-path shapes, then ragged
    C, K, H = CHUNK, K_FEAT, N_HYP
    kernels = []

    def check(name, got, ref, what):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err, bad = 0.0, 0
        for g, r in zip(got, ref):
            if g.shape != r.shape or g.dtype != r.dtype:
                fail(f"{name} ({what}): shape/dtype {g.shape} {g.dtype} vs "
                     f"{r.shape} {r.dtype}")
            d = (g.to(torch.float64) - r.to(torch.float64)).abs()
            err = max(err, float(d.max())) if d.numel() else err
            bad += int((d != 0).sum())
        log(f"  {name:22s} {what:34s} max_abs_err {err:g}  mismatches {bad}")
        if bad:
            fail(f"{name} ({what}) disagrees with its plain version: "
                 f"{bad} elements, max abs err {err} (limit: exact equality)")
        return err

    log("kernels against their plain versions (limit: exact equality, but "
        "for the five-point kernel; the Hamming, gather and scoring kernels "
        "are built with -fmad=false in the plain versions' operation order, "
        "so matches and counts must be equal, not merely close; the "
        "five-point kernel is built with FMA contraction and held to its "
        f"contract on clean minimal samples: on every hypothesis max abs "
        f"difference <= {FIVEPT_GN0_MAX:g} + {FIVEPT_COND_GAIN:g} * cond * "
        f"2^-24 before the polish (cond: its 5 x 9 design's condition "
        f"number), >= {FIVEPT_SHARE} of the "
        f"entries within {FIVEPT_TOL:g} after it, > {FIVEPT_SOLVED} of the "
        "hypotheses solved; NaN/finite pattern equal everywhere)")
    n_valid = int(matched.sum())
    n_validp = int(validp.sum())
    # f32 operations the five-point function needs per (candidate,
    # hypothesis): the plain version's elementwise arithmetic at one
    # hypothesis with all its starts, counted on the host. The design and
    # nullspace are counted once per hypothesis (the kernel recomputes them
    # in each start's thread; that is its choice, not needed work), the
    # polish once per start: split = ops(1 start) and ops(2) - ops(1).
    S5 = N_STARTS
    one = torch.rand(1, 15, 1)
    ops_5pt = {s: elementwise_ops(lambda: fivept._fivept_models_ref(
        one, one.flip(1), s, GN_ITERS, project=False)) for s in (1, 2, S5)}
    ops_per_start = ops_5pt[2] - ops_5pt[1]
    ops_shared = ops_5pt[1] - ops_per_start

    def touched(cols):
        """Distinct (candidate, column) pairs that the indices `cols`
        (C, ...) select from a (C, ., K) array: the columns a gather must
        read, counted from this run's indices."""
        z = torch.zeros(cols.shape[0], K, dtype=torch.bool, device=dev)
        z.scatter_(1, cols.reshape(cols.shape[0], -1).long().clamp(0, K - 1),
                   True)
        return int(z.sum())

    # the bytes of each gather count the columns its indices reach, not
    # the whole (C, 3, K) data array
    n_head = touched(head)
    n_perm = {k: (touched(torch.gather(order, 1, p.reshape(C, -1).long())),
                  touched(p)) for k, p in ((5, picks5), (3, picks3),
                                           (8, picks8))}

    def perm_bytes(k):
        cols, picked = n_perm[k]
        return (cols * 3 * 4 + C * H * k * 4 + picked * 4
                + C * 3 * k * H * 4)

    n_idx = touched(idx)
    specs = {
        "pair_top2": dict(
            args=(dq, dm, vm), fn=hamming._pair_top2,
            ref=hamming._pair_top2_ref,
            source="kimera_multi_tpu_torch/kernels/csrc/hamming.cu",
            replaces="kimera_multi_tpu/kernels/hamming.py:162",
            bytes=C * (K + K) * 32 + C * K + 3 * C * K * 4,
            pairs=C * K * K,
            shape=f"C={C} Kq=Kt={K}"),
        "sample_gather_t": dict(
            args=(bq, head), fn=gather.sample_gather_t,
            ref=gather.sample_gather_t_ref,
            source="kimera_multi_tpu_torch/kernels/csrc/gather.cu",
            replaces="kimera_multi_tpu/kernels/gather.py:93",
            bytes=n_head * 3 * 4 + C * PRESEL_PTS * 4
            + C * 3 * PRESEL_PTS * 4,
            ops=0, peak=PEAK_F32,
            shape=f"C={C} K={K} H={PRESEL_PTS} k=1 (preselect points)"),
        "sample_gather_perm_t": dict(
            args=(bq, picks5, order, inv_order),
            fn=gather.sample_gather_perm_t,
            ref=lambda d, p, o, i: gather.sample_gather_perm_t_ref(d, p, o),
            source="kimera_multi_tpu_torch/kernels/csrc/gather.cu",
            replaces="kimera_multi_tpu/kernels/gather.py:139",
            bytes=perm_bytes(5), ops=0, peak=PEAK_F32,
            shape=f"C={C} K={K} H={H} k=5"),
        "permute_cols": dict(
            args=(bm, idx), fn=gather.permute_cols,
            ref=gather.permute_cols_ref,
            source="kimera_multi_tpu_torch/kernels/csrc/gather.cu",
            replaces="kimera_multi_tpu/kernels/gather.py:188",
            bytes=n_idx * 3 * 4 + C * K * 4 + C * 3 * K * 4,
            ops=0, peak=PEAK_F32, shape=f"C={C} K={K}"),
        "fivept_models": dict(
            args=(g1, g2),
            fn=lambda a, b: fivept.fivept_models(a, b, S5, GN_ITERS,
                                                 project=False),
            ref=lambda a, b: fivept._fivept_models_ref(a, b, S5, GN_ITERS,
                                                       project=False),
            sub=C,  # the plain version fits the whole chunk
            source="kimera_multi_tpu_torch/kernels/csrc/fivept.cu",
            replaces="kimera_multi_tpu/kernels/fivept.py:183",
            bytes=2 * C * 15 * H * 4 + C * 9 * S5 * H * 4,
            ops=C * H * ops_5pt[S5], peak=PEAK_F32,
            shape=f"C={C} H={H} S={S5} gn_iters={GN_ITERS}"),
        "presel_counts": dict(
            args=(E_rows, f1p, f2p, validp),
            fn=lambda *a: fivept.presel_counts(*a, thr, S5),
            ref=lambda *a: fivept.presel_counts_ref(*a, thr, S5),
            source="kimera_multi_tpu_torch/kernels/csrc/score.cu",
            replaces="kimera_multi_tpu/kernels/fivept.py:313",
            bytes=C * 9 * S5 * H * 4 + 2 * C * 3 * PRESEL_PTS * 4
            + C * PRESEL_PTS + C * H * S5 * 4,
            ops=H * S5 * n_validp * OPS_SAMPSON, peak=PEAK_F32,
            valid_points=n_validp,
            shape=f"C={C} H={H} S={S5} P={PRESEL_PTS}"),
        "rigid_counts": dict(
            args=(R_h, t_h, lq, lm_m, matched),
            fn=lambda *a: score.rigid_counts(*a, cfg.stereo_threshold),
            ref=lambda *a: score.rigid_counts_ref(*a, cfg.stereo_threshold),
            source="kimera_multi_tpu_torch/kernels/csrc/score.cu",
            replaces="kimera_multi_tpu/kernels/score.py:116",
            bytes=C * H * 12 * 4 + 2 * n_valid * 3 * 4 + C * K + C * H * 4,
            ops=H * n_valid * OPS_RIGID, peak=PEAK_F32,
            valid_points=n_valid, shape=f"C={C} K={K} H={H}"),
        "essential_counts": dict(
            args=(E_sel, bq, bm_m, matched),
            fn=lambda *a: score.essential_counts(*a, thr),
            ref=lambda *a: score.essential_counts_ref(*a, thr),
            source="kimera_multi_tpu_torch/kernels/csrc/score.cu",
            replaces="kimera_multi_tpu/kernels/score.py:218",
            bytes=C * PRESEL_MODELS * 9 * 4 + 2 * n_valid * 3 * 4 + C * K
            + C * PRESEL_MODELS * 4,
            ops=PRESEL_MODELS * n_valid * OPS_SAMPSON, peak=PEAK_F32,
            valid_points=n_valid,
            shape=f"C={C} K={K} H={PRESEL_MODELS} (5-point rescore)"),
    }
    # second shapes of the same kernels: the stereo gather, and the 8-point
    # path's gather and scoring (use_5pt=False); the last number is how
    # many of a default chunk's launches of the kernel are at that shape
    # (the path's structure; the rest are at the row's own shape)
    extra = {
        "sample_gather_perm_t": [
            ("k=3 (stereo)", (lq, picks3, order, inv_order),
             perm_bytes(3), 0, 2),
            ("k=8 (use_5pt=False)", (bq, picks8, order, inv_order),
             perm_bytes(8), 0, 0)],
        "essential_counts": [
            (f"H={H} (use_5pt=False)", (E_h, bq, bm_m, matched),
             C * H * 9 * 4 + 2 * n_valid * 3 * 4 + C * K + C * H * 4,
             H * n_valid * OPS_SAMPSON, 0)],
    }
    errs, fivept_contract = {}, {}
    for name, s in specs.items():
        got = s["fn"](*s["args"])
        torch.cuda.synchronize()
        ref = over_subbatches(s["ref"], s["args"], s.get("sub", SUB))
        torch.cuda.synchronize()
        if name == "fivept_models":
            # the path's samples hold clutter: pattern gated, rest reported
            m = check_fivept(s["shape"], got, ref, GN_ITERS, gated=False)
            errs[name] = m["max_abs_err"]
            fivept_contract["path_share_within_tol"] = m["share_within_tol"]
            m0 = check_fivept(f"C={C} H={H} S={S5} gn_iters=0",
                              fivept.fivept_models(*s["args"], S5, 0,
                                                   project=False),
                              fivept._fivept_models_ref(*s["args"], S5, 0,
                                                        project=False),
                              0, gated=False, cond=design_cond(*s["args"]))
            fivept_contract["path_max_abs_err_gn_iters_0"] = m0["max_abs_err"]
            continue
        errs[name] = check(name, got, ref, s["shape"].split(" (")[0])
    for name, shapes in extra.items():
        for what, args, *_ in shapes:
            check(name, specs[name]["fn"](*args),
                  over_subbatches(specs[name]["ref"], args), what)

    # K6's contract at the main path's shape on clean minimal samples, and
    # the kernel solves its problem: nearly every hypothesis has a start
    # that fits its 5 constraints
    cf1, cf2 = (x.to(dev) for x in clean_fivept_samples(C, H, seed=1))
    ccond = design_cond(cf1, cf2)
    for it in (0, GN_ITERS):
        got = fivept.fivept_models(cf1, cf2, S5, it, project=False)
        ref = fivept._fivept_models_ref(cf1, cf2, S5, it, project=False)
        m = check_fivept(f"C={C} H={H} S={S5} gn_iters={it} (clean)",
                         got, ref, it, gated=True, cond=ccond)
        # both against the same algorithm in float64
        f64 = fivept._fivept_models_ref(cf1.double(), cf2.double(), S5, it,
                                        project=False)
        fin = torch.isfinite(f64) & torch.isfinite(got) & torch.isfinite(ref)
        m["kernel_vs_float64_max"] = float((got.double() - f64)[fin].abs()
                                           .max())
        m["plain_vs_float64_max"] = float((ref.double() - f64)[fin].abs()
                                          .max())
        log(f"    against the plain version in float64: kernel "
            f"{m['kernel_vs_float64_max']:g}, plain version "
            f"{m['plain_vs_float64_max']:g} (reported)")
        if it == 0:
            # per hypothesis, max abs difference / (cond * 2^-24): what
            # float32 does to the algorithm (plain vs float64), what the
            # fused build does (kernel vs float64), and what is gated
            # (kernel vs plain); the control, the plain version of inputs
            # moved by a relative 1e-5 (~170 roundings), must break the limit
            cs = torch.Generator(device="cpu").manual_seed(3)
            pf1, pf2 = (x * (1 + 1e-5 * torch.randn(
                x.shape, generator=cs)).to(dev) for x in (cf1, cf2))
            ctl = fivept._fivept_models_ref(pf1, pf2, S5, 0, project=False)
            use = fivept_limit_use(ctl, ref, ccond)
            m["cond_scaled"] = {
                "plain_vs_float64": cond_scaled(ref, f64, ccond),
                "kernel_vs_float64": cond_scaled(got, f64, ccond),
                "kernel_vs_plain": cond_scaled(got, ref, ccond),
                "control_vs_plain": cond_scaled(ctl, ref, ccond)}
            m["control_share_over_limit"] = float((use > 1).float().mean())
            for k, v in m["cond_scaled"].items():
                log(f"    {k:18s} difference / (cond * 2^-24): "
                    + "  ".join(f"{q} {x:.4g}" for q, x in v.items()))
            log(f"    control: {m['control_share_over_limit']:.4f} of the "
                f"hypotheses over the limit (limit: more than 0)")
            if not (use > 1).any():
                fail("fivept_models: the contract's limit does not reject "
                     "the models of perturbed inputs")
            del pf1, pf2, ctl, use
        fivept_contract[f"clean_gn_iters_{it}"] = m
        del got, ref, f64
    rows = fivept.fivept_models(cf1, cf2, S5, GN_ITERS, project=False)
    solved = fivept_solved(rows, cf1, cf2, S5)
    fivept_contract["clean_solved"] = solved
    log(f"  fivept_models on clean samples: best start's epipolar residual "
        f"< 5e-4 on {solved:.4f} of {C * H} hypotheses (limit "
        f"{FIVEPT_SOLVED})")
    if solved <= FIVEPT_SOLVED:
        fail("the five-point kernel does not solve clean minimal samples")
    del cf1, cf2, rows

    # ragged shapes: K not a multiple of 32, H not of the hypothesis tile,
    # Kq != Kt, more targets than one shared-memory tile, empty masks,
    # fewer than 5 valid matches, fewer than P valid preselect points
    g = torch.Generator(device="cpu").manual_seed(0)
    Cr, Kq, Kt, Hr = 7, 77, 1101, 45

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    rdt = torch.randint(0, 256, (Cr, Kt, 32), generator=g, dtype=torch.uint8)
    rdt[:, 1::2] = rdt[:, 0:Kt - 1:2]          # equal targets: ties
    rdq = rdt[:, torch.randint(0, Kt, (Kq,), generator=g)].clone()
    rdq[:, :, 5] ^= 9
    rvt = torch.rand(Cr, Kt, generator=g) < 0.7
    rvt[0] = False
    rvt[1] = False
    rvt[1, Kt - 1] = True
    rdq, rdt, rvt = rdq.to(dev), rdt.to(dev), rvt.to(dev)
    check("pair_top2", hamming._pair_top2(rdq, rdt, rvt),
          hamming._pair_top2_ref(rdq, rdt, rvt), f"C={Cr} Kq={Kq} Kt={Kt}")
    rdata = rnd(Cr, 3, Kt)
    for k in (1, 3, 5, 8):
        rp = torch.randint(0, Kt, (Cr, Hr, k), generator=g,
                           dtype=torch.int32).to(dev)
        rp[0, 0, 0], rp[1, 2, k - 1] = -3, Kt + 5   # clamped
        ro = torch.stack([torch.randperm(Kt, generator=g)
                          for _ in range(Cr)]).to(torch.int32).to(dev)
        ri = torch.argsort(ro, dim=1).to(torch.int32)
        check("sample_gather_perm_t",
              gather.sample_gather_perm_t(rdata, rp, ro, ri),
              gather.sample_gather_perm_t_ref(rdata, rp, ro),
              f"C={Cr} K={Kt} H={Hr} k={k}")
        check("sample_gather_t", gather.sample_gather_t(rdata, rp),
              gather.sample_gather_t_ref(rdata, rp),
              f"C={Cr} K={Kt} H={Hr} k={k}")
    # K3 with H off and over its block of 256 pairs, k over one pass of 8
    KG = 2500
    rdg = rnd(Cr, 3, KG)
    for Hg, kg in ((1, 9), (33, 3), (513, 9), (100, 8)):
        rpg = torch.randint(0, KG, (Cr, Hg, kg), generator=g,
                            dtype=torch.int32).to(dev)
        rpg[0, 0, 0], rpg[1, Hg - 1, kg - 1] = -2, KG + 9   # clamped
        check("sample_gather_t", gather.sample_gather_t(rdg, rpg),
              gather.sample_gather_t_ref(rdg, rpg),
              f"C={Cr} K={KG} H={Hg} k={kg}")
    # K3 with D != 3 (k = 1 too takes the staged kernel there), drawn from
    # its own generator so the later inputs stay as they were
    gd = torch.Generator().manual_seed(11)
    for Dg, Hg, kg in ((1, 64, 1), (6, 100, 1), (6, 33, 3)):
        rdd = torch.randn((Cr, Dg, KG), generator=gd).to(dev)
        rpg = torch.randint(0, KG, (Cr, Hg, kg), generator=gd,
                            dtype=torch.int32).to(dev)
        rpg[0, 0, 0], rpg[1, Hg - 1, kg - 1] = -2, KG + 9   # clamped
        check("sample_gather_t", gather.sample_gather_t(rdd, rpg),
              gather.sample_gather_t_ref(rdd, rpg),
              f"C={Cr} D={Dg} K={KG} H={Hg} k={kg}")
    # K4 at a K too large to stage `order` and `data` (the kernel's cached
    # path), `order` holding entries outside [0, K) (clamped)
    KL = 20000
    rdl = rnd(Cr, 3, KL)
    rpl = torch.randint(0, KL, (Cr, Hr, 5), generator=g,
                        dtype=torch.int32).to(dev)
    rol = torch.stack([torch.randperm(KL, generator=g)
                       for _ in range(Cr)]).to(torch.int32).to(dev)
    rol[0, :3] = torch.tensor([-4, KL, KL + 100], dtype=torch.int32)
    rpl[0, :3, 0] = torch.arange(3, dtype=torch.int32)
    check("sample_gather_perm_t",
          gather.sample_gather_perm_t(rdl, rpl, rol, torch.argsort(
              rol, dim=1).to(torch.int32)),
          gather.sample_gather_perm_t_ref(rdl, rpl, rol),
          f"C={Cr} K={KL} H={Hr} k=5 (not staged)")
    ridx = torch.randint(0, Kt, (Cr, Kq), generator=g,
                         dtype=torch.int32).to(dev)
    check("permute_cols", gather.permute_cols(rdata, ridx),
          gather.permute_cols_ref(rdata, ridx), f"C={Cr} Kin={Kt} Kout={Kq}")
    rp3, rq3 = 4 * rnd(Cr, 3, Kt), 4 * rnd(Cr, 3, Kt)
    rR, rt = rnd(Cr, Hr, 3, 3), rnd(Cr, Hr, 3)
    rvalid = (torch.rand(Cr, Kt, generator=g) < 0.8).to(dev)
    rvalid[0] = False
    # thresholds in the thick of the residual distribution
    check("rigid_counts", score.rigid_counts(rR, rt, rp3, rq3, rvalid, 8.0),
          score.rigid_counts_ref(rR, rt, rp3, rq3, rvalid, 8.0),
          f"C={Cr} K={Kt} H={Hr}")
    rf1 = rp3 / rp3.norm(dim=1, keepdim=True)
    rf2 = rq3 / rq3.norm(dim=1, keepdim=True)
    # 0.05 takes the rule of K7 and K9; 3.0 lies outside it (division)
    for rthr in (0.05, 3.0):
        check("essential_counts",
              score.essential_counts(rR, rf1, rf2, rvalid, rthr),
              score.essential_counts_ref(rR, rf1, rf2, rvalid, rthr),
              f"C={Cr} K={Kt} H={Hr} thr={rthr:g}")
    # five-point samples drawn the path's way from masks with 704, 40, 4
    # (fewer than 5: repeated indices, degenerate designs) and 0 valid
    rmask = torch.zeros(4, K, dtype=torch.bool, device=dev)
    rmask[0], rmask[1, 100:140], rmask[2, [5, 6, K // 2, K - 1]] = (
        True, True, True)
    rbear = rnd(4, 3, K)
    rbear = rbear / rbear.norm(dim=1, keepdim=True)
    rperm = rbear[:, [1, 2, 0]].contiguous()
    rpk, rord, rinv = ransac._masked_sample_parts(
        kmono[:4], rmask, Hr, 5)
    rg1 = gather.sample_gather_perm_t(rbear, rpk, rord, rinv)
    rg2 = gather.sample_gather_perm_t(rperm, rpk, rord, rinv)
    cg1, cg2 = (x.to(dev) for x in clean_fivept_samples(4, Hr, seed=2))
    gcond = design_cond(cg1, cg2)
    for S_, it in ((8, 3), (3, 0), (16, 8)):
        # random bearings, degenerate designs: NaN/finite pattern only
        check_fivept(f"C=4 H={Hr} S={S_} gn_iters={it} (drawn)",
                     fivept.fivept_models(rg1, rg2, S_, it, project=False),
                     fivept._fivept_models_ref(rg1, rg2, S_, it,
                                               project=False),
                     it, gated=False)
        check_fivept(f"C=4 H={Hr} S={S_} gn_iters={it} (clean)",
                     fivept.fivept_models(cg1, cg2, S_, it, project=False),
                     fivept._fivept_models_ref(cg1, cg2, S_, it,
                                               project=False),
                     it, gated=True, cond=gcond)
    rrows = rnd(Cr, 9 * 8, Hr)
    for P_ in (64, 300):
        rf1p = rnd(Cr, 3, P_)
        rf2p = rnd(Cr, 3, P_)
        rf1p, rf2p = (x / x.norm(dim=1, keepdim=True) for x in (rf1p, rf2p))
        # 0, 10, ..., 60 valid preselect points
        rvp = (torch.arange(P_, device=dev)[None, :]
               < (10 * torch.arange(Cr, device=dev))[:, None])
        # 0.05 takes K7's rule; 3.0 lies outside it (division throughout)
        for rthr in (0.05, 3.0):
            check("presel_counts",
                  fivept.presel_counts(rrows, rf1p, rf2p, rvp, rthr, 8),
                  fivept.presel_counts_ref(rrows, rf1p, rf2p, rvp, rthr, 8),
                  f"C={Cr} H={Hr} S=8 P={P_} thr={rthr:g}")
    boundary = boundary_phase(dev, check)
    torch.cuda.synchronize()

    # ------------------------------------------------------------------ 4
    true = torch.from_numpy(S.is_true)
    R_gt, t_gt = torch.from_numpy(S.R_gt), torch.from_numpy(S.t_gt)

    def drive(verify, chunks, expect, label):
        """The main path over `chunks`, kernel counts set to 0 just before
        and read just after; ground-truth gates on the result."""
        _build.reset_launches()
        outs = []
        t0 = time.time()
        for i in chunks:
            outs.append(verify(base_key, *stores, *chunk_idx(i)))
        torch.cuda.synchronize()
        run_s = time.time() - t0
        launches = dict(_build.launches)
        log(f"{label}: {len(chunks)} chunks in {run_s:.2f} s; kernel "
            f"launches {launches}")
        for name, n in launches.items():
            want = expect.get(name, 0) * len(chunks)
            if n != want:
                fail(f"{label} launched {name} {n} times, expected {want}")
        out = {k: torch.cat([o[k] for o in outs]).cpu() for k in outs[0]}
        sel = np.concatenate([np.arange(i * CHUNK, (i + 1) * CHUNK)
                              for i in chunks])
        tr_ = true[sel]
        for k, v in out.items():
            if v.shape[0] != len(sel):
                fail(f"{label}: output {k} has shape {tuple(v.shape)}")
        n_true = int(tr_.sum())
        if not (torch.isfinite(out["R"][tr_]).all()
                and torch.isfinite(out["t"][tr_]).all()):
            fail(f"{label}: non-finite pose for a true pair")
        st_acc = int(out["stereo_ok"][tr_].sum())
        mono_acc = int(out["mono_ok"][tr_].sum())
        R_err = float((out["R"][tr_] - R_gt[sel][tr_]).abs().max())
        t_err = float((out["t"][tr_] - t_gt[sel][tr_]).abs().max())
        false_acc = int((out["stereo_ok"] | out["mono_ok"])[~tr_].sum())
        log(f"{label}: true pairs {n_true}; stereo gate {st_acc}, mono gate "
            f"{mono_acc}; max |R - R_gt| {R_err:.2e}, max |t - t_gt| "
            f"{t_err:.2e} (limit 1e-3); unrelated pairs "
            f"{len(sel) - n_true}, accepted by either gate {false_acc} "
            f"(limit 0); mono inliers of true pairs median "
            f"{int(out['mono_inliers'][tr_].median())} min "
            f"{int(out['mono_inliers'][tr_].min())}, stereo median "
            f"{int(out['stereo_inliers'][tr_].median())}")
        if st_acc != n_true or R_err > 1e-3 or t_err > 1e-3:
            fail(f"{label}: a true pair was not recovered at the "
                 f"generator's pose")
        # the mono count is taken after a float32 8-point refit on
        # noise-free bearings, which loses inliers to rounding at the 1e-6
        # threshold (as in the reference); the gate needs 10 of ~420, so
        # allow 1% misses
        if mono_acc < 0.99 * n_true:
            fail(f"{label}: mono gate accepted only {mono_acc} of {n_true} "
                 f"true pairs")
        if false_acc:
            fail(f"{label}: a pair of unrelated frames was accepted")
        return out, launches

    common = {"pair_top2": 1, "permute_cols": 2, "rigid_counts": 1,
              "essential_counts": 1}
    expect5 = dict(common, sample_gather_perm_t=4, fivept_models=1,
                   sample_gather_t=2, presel_counts=1)
    expect8 = dict(common, sample_gather_perm_t=4)
    out5, launches5 = drive(verify_many, range(n_chunks), expect5,
                            "main path (use_5pt=True)")
    chunks8 = [0, n_chunks - 1]     # true pairs, and the unrelated pairs
    out8, launches8 = drive(verify_8pt, chunks8, expect8,
                            "8-point path (use_5pt=False)")

    # the same call forced through the plain versions, on a sub-batch made
    # of true and unrelated pairs; same shapes on both sides, so every
    # library routine takes the same path. Run (i) keeps K6's kernel (its
    # plain version agrees by a contract, not bit for bit) and must give
    # identical results; run (ii), all plain, must give the same gates,
    # stereo counts and poses, and its mono counts are reported (they
    # follow the five-point models through the refit).
    @contextlib.contextmanager
    def plain_versions(keep_fivept: bool):
        saved = (hamming.knn2_lowe_match_pairs, gather.sample_gather_t,
                 gather.sample_gather_perm_t, gather.permute_cols,
                 fivept.fivept_models, fivept.presel_counts,
                 score.rigid_counts, score.essential_counts)
        hamming.knn2_lowe_match_pairs = hamming.knn2_lowe_match
        gather.sample_gather_t = gather.sample_gather_t_ref
        gather.sample_gather_perm_t = \
            lambda d, p, o, i: gather.sample_gather_perm_t_ref(d, p, o)
        gather.permute_cols = gather.permute_cols_ref
        if not keep_fivept:
            fivept.fivept_models = fivept._fivept_models_ref
        fivept.presel_counts = fivept.presel_counts_ref
        score.rigid_counts = score.rigid_counts_ref
        score.essential_counts = score.essential_counts_ref
        try:
            yield
        finally:
            (hamming.knn2_lowe_match_pairs, gather.sample_gather_t,
             gather.sample_gather_perm_t, gather.permute_cols,
             fivept.fivept_models, fivept.presel_counts,
             score.rigid_counts, score.essential_counts) = saved

    n_true = int(true.sum())
    sel = np.concatenate([np.arange(SUB_PATH - 8), n_true + np.arange(8)])
    sub_idx = tuple(torch.from_numpy(x[sel].astype(np.int64)).to(dev)
                    for x in (S.qr, S.qf, S.tr, S.tm))
    path_compare = {}
    for label, verify, out, rows_of, runs in (
            ("use_5pt=True", verify_many, out5, sel,
             (("(i) plain but K6", True), ("(ii) all plain", False))),
            ("use_5pt=False", verify_8pt, out8,
             np.where(sel < CHUNK, sel, sel - n_true + CHUNK),
             (("all plain", False),))):
        kern = verify(base_key, *stores, *sub_idx)
        torch.cuda.synchronize()
        for run, keep in runs:
            before = dict(_build.launches)
            with plain_versions(keep):
                plain = verify(base_key, *stores, *sub_idx)
            torch.cuda.synchronize()
            added = {k: n - before[k] for k, n in _build.launches.items()
                     if n != before[k]}
            if added != ({"fivept_models": 1} if keep else {}):
                fail(f"{label} {run}: the plain-version run launched "
                     f"{added}")
            exact = keep or label == "use_5pt=False"
            keys = ("mono_ok", "stereo_ok", "stereo_inliers") + (
                ("mono_inliers",) if exact else ())
            for k in keys:
                if not torch.equal(kern[k], plain[k]):
                    fail(f"{label} {run}: kernel path and plain path "
                         f"disagree on {k}: {kern[k].tolist()} vs "
                         f"{plain[k].tolist()}")
            pose_diff = max(float((kern[k] - plain[k]).abs().max())
                            for k in ("R", "t"))
            if not pose_diff <= 1e-6:
                fail(f"{label} {run}: kernel path and plain path poses "
                     f"differ by {pose_diff}")
            mono_plain = int((kern["mono_inliers"]
                              - plain["mono_inliers"]).abs().max())
            path_compare[f"{label} {run}"] = {
                "pose_max_diff": pose_diff,
                "mono_inliers_max_diff": mono_plain}
            log(f"{label} {run}: kernel path vs plain path on {len(sel)} "
                f"candidates: {', '.join(keys)} equal, max pose diff "
                f"{pose_diff:g}; mono inlier count max diff {mono_plain}"
                f"{'' if exact else ' (reported)'}")
        # and the sub-batch gives what its candidates gave inside chunks
        for k in ("mono_ok", "stereo_ok", "stereo_inliers"):
            if not torch.equal(kern[k].cpu(), out[k][rows_of]):
                fail(f"{label}: {k} of a candidate depends on its batch")
        mono_diff = (kern["mono_inliers"].cpu()
                     - out["mono_inliers"][rows_of]).abs()
        log(f"{label}: mono inlier count sub-batch vs chunk max diff "
            f"{int(mono_diff.max())}")

    # ------------------------------------------------------------------ 5
    idx64 = idx.long()[:, None, :].expand(C, 3, K).contiguous()
    order64, picks64 = order.long(), picks5.long().reshape(C, H * 5)
    head64 = order[:, :PRESEL_PTS].long()[:, None, :].expand(
        C, 3, PRESEL_PTS).contiguous()
    lib = {
        "permute_cols": lambda: torch.gather(bm, 2, idx64),
        "sample_gather_perm_t": lambda: torch.gather(
            bq, 2, torch.gather(order64, 1, picks64)[:, None, :].expand(
                C, 3, H * 5)).reshape(C, 3, H, 5).permute(
                    0, 3, 1, 2).reshape(C, 15, H),
        "sample_gather_t": lambda: torch.gather(bq, 2, head64),
    }

    def bound(n_bytes, n_ops, peak):
        b_bytes = n_bytes / PEAK_BYTES * 1e3
        b_ops = n_ops / peak * 1e3
        return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else \
            "operations"

    # the launch floor: a kernel that does nothing, with K3's grid and
    # block at the path's shape, timed as the kernels are
    floor_ms = device_ms(lambda: gather.empty_launch(C, PRESEL_PTS, dev))
    floor = {"launch_floor_ms": floor_ms,
             "launch_floor_grid": f"sample_gather_t's at C={C} "
                                  f"H={PRESEL_PTS}: {-(-C * PRESEL_PTS // 256)}"
                                  f" blocks of 256 threads"}
    for name, s in specs.items():
        # launches per chunk as counted in the main path's run
        per_chunk, rest = divmod(launches5[name], n_chunks)
        if rest or per_chunk != expect5[name]:
            fail(f"{name}: {launches5[name]} launches in {n_chunks} chunks, "
                 f"expected {expect5[name]} per chunk")
        ms = device_ms(lambda: s["fn"](*s["args"]))
        host_ms = time_ms(lambda: s["fn"](*s["args"]))
        plain_ms = time_ms(
            lambda: over_subbatches(s["ref"], s["args"], s.get("sub", SUB)),
            iters=2, warmup=1)
        routes = None
        if "pairs" in s:
            b_ms, b_by, s["ops"], routes = hamming_bound(s["pairs"],
                                                         s["bytes"])
        else:
            b_ms, b_by = bound(s["bytes"], s["ops"], s["peak"])
            if s["ops"]:
                routes = f32_routes(s["bytes"], s["ops"])
        row = {
            "name": name, "route": "cuda", "source": s["source"],
            "replaces": s["replaces"], "launches": launches5[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(lib[name]) if name in lib else None,
            "bytes": s["bytes"], "ops": s["ops"],
            "ms_with_host_enqueue": host_ms,
            "launches_per_chunk": per_chunk,
            "launches_use_5pt_false": launches8[name],
            "shape": s["shape"],
        }
        if routes:
            row["bound_routes"] = routes
        if name in ("sample_gather_t", "permute_cols"):
            row.update(floor)
        if "valid_points" in s:
            # the correspondences the operation bound counts
            row["valid_points"] = s["valid_points"]
        if name == "fivept_models":
            row.update(ops_per_hypothesis=ops_5pt[S5],
                       ops_nullspace_per_hypothesis=ops_shared,
                       ops_per_start=ops_per_start,
                       max_abs_err_is="at the path's samples after the "
                       "polish; the contract is on clean samples",
                       contract=fivept_contract)
        if name in extra:
            row["other_shapes"] = []
            for what, args, n_bytes, n_ops, at_shape in extra[name]:
                o_ms, o_by = bound(n_bytes, n_ops, s["peak"])
                row["other_shapes"].append({
                    "shape": what,
                    "ms": device_ms(lambda: s["fn"](*args)),
                    "bound_ms": o_ms, "bound_by": o_by,
                    "bytes": n_bytes, "ops": n_ops,
                    "launches_per_chunk_at_shape": at_shape})
                if n_ops:
                    row["other_shapes"][-1]["bound_routes"] = f32_routes(
                        n_bytes, n_ops)
        kernels.append(row)
        log(f"  {name:22s} {ms:8.4f} ms  plain {plain_ms:9.3f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})"
            + (f"  launch floor {floor_ms:.4f} ms" if "launch_floor_ms" in row
               else ""))

    idx0 = chunk_idx(0)
    P, SK = PRESEL_PTS, PRESEL_MODELS

    def match_stage():
        return hamming.knn2_lowe_match_pairs(
            desc_store[qr, qf], obs_store[qr, qf], desc_store[tr, tm],
            obs_store[tr, tm], cfg.lowe_ratio)

    def mono5_stage():
        return ransac.ransac_essential_5pt(
            kmono, bq, gather.permute_cols(bm, idx), matched,
            threshold=thr, n_hyp=N_HYP, min_inliers=cfg.min_mono_inliers)

    def mono8_stage():
        return ransac.ransac_essential(
            kmono, bq, gather.permute_cols(bm, idx), matched,
            threshold=thr, n_hyp=N_HYP, min_inliers=cfg.min_mono_inliers)

    def stereo_stage():
        return ransac.ransac_arun(
            kst, lq, gather.permute_cols(lm, idx), matched,
            threshold=cfg.stereo_threshold, n_hyp=N_HYP,
            min_inliers=cfg.min_stereo_inliers)

    # the split of the 5-point mono stage, step by step on chunk 0's inputs
    def presel():
        f1p_ = gather.sample_gather_t(bq, head)
        f2p_ = gather.sample_gather_t(bm_m, head)
        vp = (torch.arange(P, device=dev)[None, :]
              < matched.sum(1)[:, None])
        return fivept.presel_counts(E_rows, f1p_, f2p_, vp, thr, S5)

    def select_project():
        E_raw, _ = fivept.select_models(E_rows, counts_hs, SK, S5)
        return minimal._project_essential(E_raw)[0].contiguous()

    def rescore():
        c = score.essential_counts(E_sel, bq, bm_m, matched, thr)
        return ransac._take_best(E_sel, score.first_argmax(c))

    E_b = rescore()

    def refit():
        return ransac._essential_result(E_b, bq, bm_m, matched, thr,
                                        cfg.min_mono_inliers)

    def full():
        return verify_many(base_key, *stores, *idx0)

    def full8():
        return verify_8pt(base_key, *stores, *idx0)

    def wall_ms(fn, n=5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    stages = {
        "match_ms": time_ms(match_stage, iters=5),
        "mono_5pt_ms": time_ms(mono5_stage, iters=3, warmup=1),
        "mono_5pt_split_ms": {
            "draws": time_ms(lambda: ransac._masked_sample_parts(
                kmono, matched, N_HYP, 5), iters=3, warmup=1),
            "gathers_K4": time_ms(lambda: (
                gather.sample_gather_perm_t(bq, picks5, order, inv_order),
                gather.sample_gather_perm_t(bm_m, picks5, order, inv_order)),
                iters=5),
            "fivept_K6": time_ms(lambda: fivept.fivept_models(
                g1, g2, S5, GN_ITERS, project=False), iters=5),
            "presel_K3_K7": time_ms(presel, iters=5),
            "select_project": time_ms(select_project, iters=5),
            "rescore_K9": time_ms(rescore, iters=5),
            "refit": time_ms(refit, iters=3, warmup=1),
        },
        "mono_8pt_ms": time_ms(mono8_stage, iters=3, warmup=1),
        "stereo_ransac_ms": time_ms(stereo_stage, iters=3, warmup=1),
        "full_ms": time_ms(full, iters=5, warmup=2),
        "full_ms_use_5pt_false": time_ms(full8, iters=5, warmup=2),
    }
    stages["full_host_ms"] = wall_ms(full)
    stages["full_host_ms_use_5pt_false"] = wall_ms(full8)
    stages["lc_verifications_per_s"] = CHUNK / stages["full_ms"] * 1e3
    stages["lc_verifications_per_s_use_5pt_false"] = (
        CHUNK / stages["full_ms_use_5pt_false"] * 1e3)
    profile = "--profile" in sys.argv[1:]
    if profile:
        print(json.dumps({"profile": profile_chunk(full, stages["full_ms"])}),
              flush=True)

    # ------------------------------------------------------------------ 6
    kernels.insert(1, db_top2_phase(desc_store, check))
    kernels[1]["launches_per_chunk"] = launches5["hamming_top2"] // n_chunks
    # ------------------------------------------------------------------ 7
    stages.update(frontend_phase(dev, profile))
    # each launch of a chunk at its own shape: the measured launches per
    # chunk, of which those named at another shape are timed there
    stages["kernels_ms_per_chunk"] = sum(
        k["ms"] * (k["launches_per_chunk"]
                   - sum(r["launches_per_chunk_at_shape"]
                         for r in k.get("other_shapes", [])))
        + sum(r["ms"] * r["launches_per_chunk_at_shape"]
              for r in k.get("other_shapes", []))
        for k in kernels)
    stages["path_vs_plain"] = path_compare
    stages["boundary_within_one_ulp"] = boundary
    stages.update(chunk=CHUNK, n_hyp=N_HYP, K=K_FEAT, card=card,
                  build_s=build_s,
                  peak_mem_mb=torch.cuda.max_memory_allocated() / 1e6,
                  total_s=time.time() - t_start)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"stages": stages}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
