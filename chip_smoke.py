#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from kimera_multi_tpu_torch/kernels/csrc with nvcc
and holds each of the nine against its plain PyTorch version at the shapes
of its path (and at ragged shapes): eight by exact equality, the
five-point kernel K6 (built with FMA contraction) by its stated contract
(`check_fivept`). Then it drives twelve paths:

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

  * the back-end: one bucketed RBCD round (`rbcd_round_reference`,
    `RbcdConfig()`) on bench.py's graphs, `multi_robot_graph(seed=2)` with
    6 robots x 256 poses (16 + 16 loop closures) and 6 x 2048 (64 + 64),
    timed warm; checked: two card runs at 6 x 2048 give the same bits, the
    card's round at 6 x 256 agrees with the CPU's (within 3 x the CPU
    float32 round's own distance from the float64 round), 20 rounds of
    `solve_rounds`
    lower the lifted cost; then the GNC schedule of dist/rounds.py at
    cli/run.py's cadence, 66 rounds at 6 x 256 on the card and on the CPU,
    held to the loop closures the JAX package's run leaves under 0.5
    (`GNC_UNDER_05`) and its ground-truth outliers under 0.1;
  * `entry()`'s fused SLAM step (verification through K1, K4, K8 and K9,
    then one RBCD round): launches counted, no plain version allowed to
    run, each kernel call of the counted step held exactly against its
    plain version on the tensors it was given, timed, and held against
    the same step on the CPU;
  * the `sim` run of the port's CLI, `cli.run.main(["--mode", "sim",
    "--robots", "6", "--steps", "1024", "--features", "704", "--seed",
    "0", ...])`: world, vocabulary, the front-end above, the pose graph
    (29,110 edges), PCM and 40 GNC rounds of Gauss-Newton, the
    reference-schema logs and APE; then again with submaps of 10
    keyframes. Checked: the log tree's rows and headers, every robot
    placed by PCM, APE below odometry's, the back-end rerun on the CPU
    from the same loops deciding the same (consensus, frame_ok, loop
    closures under 0.5; APE within 5 %), two card runs of the back-end
    bit-identical, the kernel launches inside main() equal to the
    front-end path's with no plain version run, and the submap run's APE
    below max(2 x the keyframe level's, 0.08 m). The first run also
    writes its observation streams (`--save-obs`), and the replay gate,
    `cli.replay.main`, re-verifies every attempt it logged on the card
    (accepted bit for bit, each robot's APE from the TUM files within
    1e-4 m of the run's own, every kernel of the path launched, no plain
    version); it also writes `--artifacts` (deformation graph, TSDF,
    surface, marching-tetrahedra mesh): the PLY and HTML files parse and
    hold the run's counts, vertices lie in the grid's box, a second card
    run of `write_artifacts` gives the same bits, and the CPU's run from
    the same poses gives the same grid within `ARTIFACT_GRID_SHARE`;
  * the `vio-sim` run of the port's CLI, `cli.run.main(["--mode",
    "vio-sim", "--robots", "6", "--steps", "30", "--vio-width", "640",
    "--vio-height", "480", "--vio-features", "300", "--vio-window", "25",
    ...])`: a rendered stereo + IMU sequence, one VIO pipeline per robot
    (reject steps on K4, K8, K9), the front-end, robust PGO, logs, APE.
    Checked (`vio_phase`): loops, APE, attitude, launches per reject
    step, no plain version, the kernel calls of one reject step and of
    the front-end inside main() against their plain versions, two card
    runs of a robot bit-identical, card vs CPU at the JAX e2e test's
    size, the BoW weight span, and the `--lc-images` evidence it wrote
    (one PNG per loop over the threshold, read back);
  * the `euroc` run of the port's CLI, `cli.run.main(["--mode", "euroc",
    "--euroc-roots", <PNG tree>, <PGM tree>, <bag>, "--steps", "40",
    ...])` on three sessions rendered at EuRoC's camera (752 x 480, its
    cam0 intrinsics, 0.110 m baseline, 20 Hz camera, 200 Hz IMU), 20
    frames apart on one arc: VIO on each session, the front-end, robust
    PGO, logs, APE. Checked (`euroc_phase`): 120 keyframes, inter-robot
    loops, APE, attitude, the log tree, launches per reject step, no
    plain version, the kernel calls of one reject step and of the
    front-end inside main() against their plain versions, the BoW
    weight span; then the converter on the card, `io.convert.main(
    ["--euroc", <PGM tree>, ...])`, whose obs_robot0.npz must equal the
    run's products of that session bit for bit; and a frame written as
    a PNG with libpng's adaptive row filters, decoded and timed;
  * the sequential front-end, `DistributedFrontend(6, 32, vocab,
    FrontendConfig()).process_all` on `make_world(6, 32, 704, seed=1)`
    (one keyframe at a time, each gated pair verified alone, C = 1).
    Checked (`sequential_phase`): the same attempts and loops as
    `BatchedFrontend.process_all` on that world, bit for bit (counts, R
    and t included); no plain version; every path kernel launched as
    often per pair as the recorded pair called it; the kernel calls of
    one verified pair against their plain versions;
  * the run tools: `cli.trials.main` (2 trials of the `sim` run at 2 x
    40 x 64) and one pass of `cli.monitor.monitor` over the last trial's
    logs (`tools_phase`: finite medians; the monitor reads each robot's
    newest dump and appends its APE);
  * the sharded back-end (`sharded_phase`): `cli.run.main(["--mode",
    "sim-sharded", ...])` on the `sim` run's world, 40 rounds over a
    one-rank NCCL group with `--profile` and `--chain-refine`, then 20
    rounds with `--checkpoint` and 20 with `--resume`. Checked: the
    resumed run == the straight one bit for bit, the 40 rounds ==
    `rbcd_round_reference` with GNC bit for bit, 2 rounds card vs CPU
    within `round_tolerance`, APE below odometry's, the log tree and
    dumps, `profile_summary.json`'s schema, the same kernel launches as
    the front-end path and no plain version; the split hypothesis table
    for 1, 2 and 4 slices == the unsplit `ransac_arun` bit for bit, K8
    at each slice's shape == its plain version; `--backend sharded` on
    vio-sim at 2 x 16;
  * the pod tier (`pods_phase`): two `python -m
    kimera_multi_tpu_torch.cli.pod` processes on the card (6 robots x
    64 keyframes x 704 features, 30 rounds) exchanging over the native
    TCP fabric. Checked: the hash barrier, APE below odometry's, bytes a
    round, every front-end kernel launched in each pod; then
    `entry.dryrun_multichip(1)`.

K7, K8 and K9 are also held to their plain versions on inputs built so
that hundreds of residuals sit on the threshold or one ulp beside it (the
boundary phase).

Kernel counts are set to 0 just before each path and read just after;
kernels (device time) and stages (as the caller sees them) are timed with
CUDA events or the host clock around synchronised work.

Every phase is fatal: a kernel that does not build, launch or agree, a
wrong result, or no GPU ends the run with a non-zero exit code. The last
line of the output is {"ok": true, "device": {...}}; the two lines before
it are JSON objects {"kernels": [...]} and {"stages": {...}}; each
phase's wall time is logged as it ends and kept in the stages'
`phase_s`.

    python3 chip_smoke.py --profile

also traces one verification chunk of the default configuration, a
window of detection steps, one RBCD round at 6 x 2048 and at 6 x 256, and
one `entry()` step and one Gauss-Newton call of the `sim` back-end at
full size (8 x 40 CG steps) with torch.profiler and prints {"profile":
...}, {"profile_detect": ...}, {"profile_rbcd": ...},
{"profile_rbcd_6x256": ...}, {"profile_slam_step": ...} and
{"profile_robust_pgo": ...}, {"profile_vio_keyframe": ...} lines: device
kernels launched per chunk
(per step, per round, per call; per CG step for the last), the device's
busy time and idle share, and the kernels that take most of the device
time; and {"profile_rbcd_parts":
...}: the parts of a round at 6 x 2048 (preconditioner, gradient, one CG
step, global step, its retraction), each with its kernels by name, host
time and the aten operations it runs.
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


def kernels_by_name(prof) -> dict:
    """Device kernels of a finished profile: name -> (count, device us)."""
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
    return by_name


def device_summary(prof, wall_ms: float) -> dict:
    """Device kernels of a finished profile: their count, the device's busy
    time, the idle share against `wall_ms` (the same work's time without
    the profiler), which kernels take the time."""
    by_name = kernels_by_name(prof)
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


# ------------------------------------------------------------- back-end
# bench.py's two RBCD graphs: (poses per robot, intra / inter loop
# closures a robot / a pair of robots); 6 robots, 20 % outliers
RBCD_GRAPHS = {"6x256": (256, 16), "6x2048": (2048, 64)}
# card vs CPU round at 6 x 256: limits are this many times the CPU float32
# round's distance from float64 (about 2e-4 max and 6e-7 mean there)
ROUND_TOL_K = 3.0
# the GNC schedule of dist/rounds.py at cli/run.py's cadence: gnc_init at
# Y0, gnc_update_weights after every 2nd round from round 8. Its length
# and outcome on the 6 x 256 graph come from the JAX package on the CPU
# (`gnc_schedule_reference` in tests/test_torch_rbcd.py): after 66 rounds
# mu has passed 1 and the loop closures under 0.5 no longer change; they
# are these edges (53 ground-truth outliers, every one under 0.1, and
# 4 inliers), and edge 1717 lies within 0.05 of 0.5
GNC_ROUNDS, GNC_EVERY, GNC_BURNIN = 66, 2, 8
GNC_UNDER_05 = (
    1532, 1537, 1542, 1548, 1550, 1553, 1554, 1556, 1557, 1563, 1566, 1575,
    1583, 1585, 1587, 1588, 1607, 1611, 1616, 1617, 1618, 1622, 1634, 1635,
    1653, 1657, 1664, 1667, 1668, 1670, 1673, 1674, 1676, 1680, 1681, 1690,
    1694, 1697, 1699, 1703, 1705, 1725, 1729, 1731, 1738, 1746, 1747, 1750,
    1754, 1759, 1760, 1762, 1764, 1769, 1772, 1773, 1776)
GNC_NEAR_05 = (1717,)
# entry()'s step: launches of each kernel (K4 twice in each gate)
ENTRY_LAUNCHES = {"pair_top2": 1, "sample_gather_perm_t": 4,
                  "rigid_counts": 1, "essential_counts": 1}


def rbcd_setup(n_poses: int, n_lc: int, dev):
    """bench.py's `prepare_rbcd` graph in the port: odometry
    initialization, lift with the LIFTING key, RbcdConfig(), buckets,
    unit weights."""
    from kimera_multi_tpu_torch.core import rng, stiefel
    from kimera_multi_tpu_torch.io import synthetic
    from kimera_multi_tpu_torch.solve import pgo, rbcd

    g = synthetic.multi_robot_graph(seed=2, n_robots=6, n_poses=n_poses,
                                    outlier_ratio=0.2, n_intra_lc=n_lc,
                                    n_inter_lc=n_lc, device=dev)
    p0 = pgo.init_from_odometry(g.edges, g.n_robots, g.poses_per_robot)
    ylift = stiefel.random_lifting_matrix(
        rng.derive(rng.base_key(0, device=dev), rng.Stream.LIFTING), 5, 3)
    Y0 = rbcd.lift_params(p0, ylift, g.n_robots, g.poses_per_robot)
    return dict(g=g, Y0=Y0, cfg=rbcd.RbcdConfig(),
                buckets=rbcd.bucket_edges(g.edges, g.n_robots, n_poses),
                w=torch.ones(g.edges.capacity, device=dev),
                act=torch.ones(g.n_robots, dtype=torch.bool, device=dev))


def rbcd_round(s, Y, w=None):
    from kimera_multi_tpu_torch.solve import rbcd

    return rbcd.rbcd_round_reference(
        Y, s["act"], s["g"].edges, s["w"] if w is None else w, s["cfg"],
        s["g"].poses_per_robot, s["buckets"])


def on_cpu(s, dtype=torch.float32):
    """The same problem on the CPU (float64: the exact round's stand-in)."""
    import dataclasses

    from kimera_multi_tpu_torch.solve import rbcd

    e = s["g"].edges.to("cpu")
    e = dataclasses.replace(e, **{f: getattr(e, f).to(dtype)
                                  for f in ("R", "t", "kappa", "tau")})
    return dict(s, g=s["g"]._replace(edges=e), Y0=s["Y0"].cpu().to(dtype),
                buckets=rbcd.bucket_edges(e, s["g"].n_robots,
                                          s["g"].poses_per_robot),
                w=torch.ones(e.capacity, dtype=dtype),
                act=s["act"].cpu())


def round_tolerance(got, ref32, ref64) -> dict:
    """A float32 round `got` against the CPU's float32 round `ref32` of
    the same input, the limits set by the CPU run alone (the rule of
    tests/test_torch_cuda_kernels.py): the largest and the mean difference
    each at most 3 times the CPU round's own distance (largest, mean) from
    the float64 round `ref64`. Since |got - ref32| <= |got - ref64| +
    |ref32 - ref64|, a round up to twice as far from the exact round as
    the CPU's passes; one computed in TF32 or with a wrong gather is
    orders of magnitude further."""
    d = (got - ref32).abs()
    e_ref = (ref32.double() - ref64).abs()
    e_got = (got.double() - ref64).abs()
    lim_max = ROUND_TOL_K * float(e_ref.max())
    lim_mean = ROUND_TOL_K * float(e_ref.mean())
    mx, mean = float(d.max()), float(d.mean())
    return dict(max=mx, mean=mean, limit_max=lim_max, limit_mean=lim_mean,
                card_vs_float64_max=float(e_got.max()),
                card_vs_float64_mean=float(e_got.mean()),
                ok=mx <= lim_max and mean <= lim_mean)


def backend_phase(dev, profile: bool) -> dict:
    """(a) one bucketed RBCD round on bench.py's 6 x 256 and 6 x 2048
    graphs, timed warm; checks: two card runs at 6 x 2048 give the same
    bits, the card's round at 6 x 256 agrees with the CPU's, 20 rounds of
    `solve_rounds` at 6 x 256 lower the lifted cost. (b) the GNC schedule
    at 6 x 256 on the card and on the CPU against the JAX package's
    recorded outcome. Returns the stage entries."""
    from kimera_multi_tpu_torch.solve import rbcd

    out = {}
    for name, (n_poses, n_lc) in RBCD_GRAPHS.items():
        t0 = time.time()
        s = rbcd_setup(n_poses, n_lc, dev)
        torch.cuda.synchronize()
        g = s["g"]
        n_edges = int(g.edges.valid.sum())
        log(f"back-end {name}: {n_edges} edges ({g.edges.capacity} slots), "
            f"buckets of {s['buckets'].idx.shape[1]} edges, incidence "
            f"table {tuple(s['buckets'].inc.shape)}; set up in "
            f"{time.time() - t0:.2f} s")
        Y1 = rbcd_round(s, s["Y0"])
        Y1b = rbcd_round(s, s["Y0"])
        torch.cuda.synchronize()
        if not torch.isfinite(Y1).all():
            fail(f"back-end {name}: a non-finite block after one round")
        n = 10 if n_poses <= 256 else 5
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            rbcd_round(s, s["Y0"])
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) / n * 1e3
        ev_ms = time_ms(lambda: rbcd_round(s, s["Y0"]), iters=n, warmup=1)
        flat = lambda Y: Y.reshape(-1, *Y.shape[2:])
        c0 = float(rbcd.lifted_cost(flat(s["Y0"]), g.edges, s["w"], n_poses))
        c1 = float(rbcd.lifted_cost(flat(Y1), g.edges, s["w"], n_poses))
        out[f"rbcd_round_ms_{name}"] = host_ms
        out[f"rbcd_rounds_per_s_{name}"] = 1e3 / host_ms
        out[f"rbcd_round_event_ms_{name}"] = ev_ms
        out[f"rbcd_edges_{name}"] = n_edges
        log(f"back-end {name}: one round {host_ms:.2f} ms on the host "
            f"clock ({1e3 / host_ms:.1f} rounds/s), {ev_ms:.2f} ms by CUDA "
            f"events; lifted cost {c0:.6g} -> {c1:.6g}")
        if not c1 < c0:
            fail(f"back-end {name}: one round did not lower the cost")
        if name == "6x2048":
            same = torch.equal(Y1, Y1b)
            log(f"back-end {name}: two card runs of one round bit-identical: "
                f"{same}")
            if not same:
                fail("two card runs of one RBCD round differ")
            out["rbcd_card_runs_identical_6x2048"] = True
            if profile:
                print(json.dumps({"profile_rbcd": profile_call(
                    lambda: rbcd_round(s, s["Y0"]), host_ms, "round")}),
                    flush=True)
                print(json.dumps({"profile_rbcd_parts": profile_rbcd_parts(
                    s)}), flush=True)
            continue
        if profile:
            print(json.dumps({"profile_rbcd_6x256": profile_call(
                lambda: rbcd_round(s, s["Y0"]), host_ms, "round")}),
                flush=True)
        # 6 x 256: the card against the CPU, float32 and float64
        s32, s64 = on_cpu(s), on_cpu(s, torch.float64)
        Yc = rbcd_round(s32, s32["Y0"])
        Y64 = rbcd_round(s64, s64["Y0"])
        tol = round_tolerance(Y1.cpu(), Yc, Y64)
        log(f"back-end {name}: card vs CPU, one round: max |diff| "
            f"{tol['max']:.3e} (limit {tol['limit_max']:.3e}), mean "
            f"{tol['mean']:.3e} (limit {tol['limit_mean']:.3e}); limits: "
            f"{ROUND_TOL_K:g} x the CPU float32 round's distance from the "
            f"float64 round; the card's own distance from it: max "
            f"{tol['card_vs_float64_max']:.3e}, mean "
            f"{tol['card_vs_float64_mean']:.3e}")
        if not tol.pop("ok"):
            fail("the card's RBCD round differs from the CPU's")
        out["rbcd_card_vs_cpu_6x256"] = tol
        Y20, costs = rbcd.solve_rounds(s["Y0"], s["act"], g.edges, n_poses,
                                       s["cfg"], n_rounds=20,
                                       buckets=s["buckets"])
        c20 = float(costs[-1])
        log(f"back-end {name}: solve_rounds, 20 rounds: lifted cost "
            f"{c0:.6g} -> {c20:.6g}")
        if not c20 < c0:
            fail("20 RBCD rounds did not lower the lifted cost")
        out["rbcd_cost_20_rounds_6x256"] = [c0, c20]
        out.update(gnc_phase(s, on_cpu(s)))
    return out


def gnc_phase(s_dev, s_cpu) -> dict:
    """(b) the GNC schedule at 6 x 256 on the card and on the CPU."""
    from kimera_multi_tpu_torch.solve import gnc, rbcd

    finals = []
    for s in (s_dev, s_cpu):
        e, ppr = s["g"].edges, s["g"].poses_per_robot
        sq = lambda Y: rbcd.lifted_edge_sq_errors(
            Y.reshape(-1, *Y.shape[2:]), e, ppr)
        Y = s["Y0"]
        state = gnc.gnc_init(sq(Y), e.etype, e.valid,
                             gnc.barc2_from_quantile(0.9, 6))
        t = time.perf_counter()
        for i in range(GNC_ROUNDS):
            Y = rbcd_round(s, Y, state.weights)
            if (i + 1) % GNC_EVERY == 0 and i + 1 >= GNC_BURNIN:
                state = gnc.gnc_update_weights(state, sq(Y), e.etype,
                                               e.valid)
        w = state.weights.cpu().numpy()
        finals.append((w, (time.perf_counter() - t) * 1e3))
    g = s_dev["g"]
    lc = (g.edges.valid & (g.edges.etype != 1)).cpu().numpy()
    out_gt = g.is_outlier.cpu().numpy()
    jax_set = np.zeros_like(lc)
    jax_set[list(GNC_UNDER_05)] = True
    free = np.zeros_like(lc)
    free[list(GNC_NEAR_05)] = True
    res = {}
    for (w, ms), where in zip(finals, ("card", "cpu")):
        under = lc & (w < 0.5)
        differ = under != jax_set
        res[where] = under
        log(f"GNC on the {where}: {GNC_ROUNDS} rounds in {ms:.0f} ms; "
            f"{int(under.sum())} loop closures under 0.5 "
            f"({int(jax_set.sum())} in the JAX run); differing "
            f"{int(differ.sum())}, of them within 0.05 of 0.5 in the JAX "
            f"run {int((differ & free).sum())}; ground-truth outliers under "
            f"0.1 {int((out_gt & (w < 0.1)).sum())} of {int(out_gt.sum())}")
        if (differ & ~free).any():
            fail(f"GNC on the {where}: loop closures "
                 f"{np.nonzero(differ & ~free)[0].tolist()} fall on the "
                 f"other side of 0.5 than in the JAX run")
        if not (w[out_gt] < 0.1).all():
            fail(f"GNC on the {where}: a ground-truth outlier weighs 0.1 or "
                 f"more")
    both = res["card"] != res["cpu"]
    if (both & ~free).any():
        fail("GNC: the card and the CPU put different loop closures under "
             "0.5")
    return {"gnc_rounds_6x256": GNC_ROUNDS,
            "gnc_ms_6x256": finals[0][1], "gnc_ms_6x256_cpu": finals[1][1],
            "gnc_under_05": int(res["card"].sum()),
            "gnc_near_05_allowed": len(GNC_NEAR_05)}


def profile_call(fn, wall_ms: float, unit: str) -> dict:
    """One warm call of fn() under torch.profiler: device kernels, busy
    time, idle share against `wall_ms` (its time without the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = device_summary(prof, wall_ms)
    if "device_kernels_per_chunk" in out:
        out[f"device_kernels_per_{unit}"] = out.pop("device_kernels_per_chunk")
        out[f"{unit}_ms_unprofiled"] = out.pop("chunk_ms_unprofiled")
    return out


# aten operations that only make a view (no kernel)
VIEW_OPS = {"view", "_unsafe_view", "unsqueeze", "squeeze", "select",
            "slice", "expand", "permute", "transpose", "t", "as_strided",
            "alias", "detach", "lift_fresh", "reshape", "unbind", "split",
            "split_with_sizes", "_reshape_alias", "diagonal"}


def aten_ops(fn) -> dict:
    """The aten operations fn() dispatches that compute (views left
    out), name -> count."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count: dict = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name not in VIEW_OPS:
                count[name] = count.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return count


def profile_rbcd_parts(s) -> dict:
    """The parts of one bucketed round, each run warm on its own at this
    graph: device kernels by name, busy ms, host ms a call and the aten
    operations that compute. A round is the preconditioner, then 3 cycles
    of (gradient, 8 CG steps, global step); a CG step is the difference of
    `_newton_cg` at 1 and at 0 CG iterations."""
    from torch.profiler import ProfilerActivity, profile

    from kimera_multi_tpu_torch.core import stiefel
    from kimera_multi_tpu_torch.solve import rbcd

    g, b, w, cfg, Y = s["g"], s["buckets"], s["w"], s["cfg"], s["Y0"]
    n = g.poses_per_robot
    robots = torch.arange(g.n_robots, device=Y.device)
    blk = rbcd._bucket_block(robots, b, w[b.idx])
    Minv = rbcd.bucket_precond(b, robots, w, n)
    D = rbcd._newton_cg(blk, Y, Y, cfg, Minv)
    cg = lambda k: lambda: rbcd._newton_cg(
        blk, Y, Y, cfg._replace(cg_iters=k), Minv)
    parts = {
        "round": lambda: rbcd.rbcd_round_reference(
            Y, s["act"], g.edges, w, cfg, n, b),
        "preconditioner": lambda: rbcd.bucket_precond(b, robots, w, n),
        "gradient": cg(0), "gradient_and_cg_step": cg(1),
        "global_step": lambda: rbcd._global_step(Y, D, g.edges, w, n, cfg),
        "retraction_of_5_trials": lambda: stiefel.lifted_retract(
            Y[None], 0.1 * D[None].expand(5, *D.shape), 3),
    }
    raw = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) / 5 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = kernels_by_name(prof)
        raw[name] = (host_ms, {k: c for k, (c, _) in by_name.items()},
                     {k: t for k, (_, t) in by_name.items()}, aten_ops(fn))

    def diff(a: dict, b: dict) -> dict:
        return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}

    one, zero = raw.pop("gradient_and_cg_step"), raw["gradient"]
    raw["cg_step"] = (one[0] - zero[0],) + tuple(
        diff(a, b) for a, b in zip(one[1:], zero[1:]))
    out = {}
    for name, (host_ms, counts, times, ops) in raw.items():
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
        out[name] = {
            "host_ms": host_ms,
            "device_kernels": sum(counts.values()),
            "device_busy_ms": sum(times.values()) / 1e3,
            "aten_ops_computing": sum(ops.values()),
            "top_ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:10]),
            "top_kernels": [{"name": k.replace("void ", "").replace(
                "at::native::", "")[:70], "count": c} for k, c in top],
        }
    return out


@contextlib.contextmanager
def plain_tripwire():
    """While open, every plain version of a kernel appends its name to the
    yielded list when it runs (the card paths must run none)."""
    from kimera_multi_tpu_torch.kernels import fivept, gather, hamming, score

    plain = [(hamming, "knn2_lowe_match"), (hamming, "_pair_top2_ref"),
             (gather, "sample_gather_perm_t_ref"),
             (gather, "sample_gather_t_ref"), (gather, "permute_cols_ref"),
             (fivept, "_fivept_models_ref"), (fivept, "presel_counts_ref"),
             (score, "rigid_counts_ref"), (score, "essential_counts_ref")]
    ran: list = []
    saved = [getattr(m, n) for m, n in plain]

    def tripwire(name, fn):
        def wrapped(*a, **k):
            ran.append(name)
            return fn(*a, **k)
        return wrapped

    try:
        for (m, n), fn in zip(plain, saved):
            setattr(m, n, tripwire(n, fn))
        yield ran
    finally:
        for (m, n), fn in zip(plain, saved):
            setattr(m, n, fn)


def entry_phase(dev, profile: bool, check) -> dict:
    """(c) entry()'s fused step on the card: launches counted, no plain
    version run, each kernel call of the counted step held exactly against
    its plain version on the tensors it was given (`check`), timed warm,
    and the step held against the step on the CPU."""
    from kimera_multi_tpu_torch import entry
    from kimera_multi_tpu_torch.kernels import _build, gather, hamming, score

    step, args = entry.entry()
    if not all(a.device.type == "cuda" for a in args):
        fail("entry() did not put its inputs on the card")
    step(*args)  # warm-up
    torch.cuda.synchronize()
    # the wrappers of the step's kernels, and each one's plain version
    wrappers = {
        "pair_top2": (hamming, "_pair_top2",
                      lambda *a: hamming._pair_top2_ref(*a)),
        "sample_gather_perm_t": (
            gather, "sample_gather_perm_t",
            lambda d, p, o, inv: gather.sample_gather_perm_t_ref(d, p, o)),
        "rigid_counts": (score, "rigid_counts",
                         lambda *a: score.rigid_counts_ref(*a)),
        "essential_counts": (score, "essential_counts",
                             lambda *a: score.essential_counts_ref(*a)),
    }
    calls = []
    saved_w = {k: getattr(m, n) for k, (m, n, _) in wrappers.items()}

    def recorder(name, fn):
        def wrapped(*a):
            got = fn(*a)
            calls.append((name, a, got))
            return got
        return wrapped

    try:
        for k, (m, n, _) in wrappers.items():
            setattr(m, n, recorder(k, saved_w[k]))
        with plain_tripwire() as ran:
            _build.reset_launches()
            out = step(*args)
            torch.cuda.synchronize()
            launches = dict(_build.launches)
    finally:
        for k, (m, n, _) in wrappers.items():
            setattr(m, n, saved_w[k])
    log(f"entry(): step launches {launches}; plain versions run: {ran}")
    if ran:
        fail(f"entry()'s step ran plain versions {ran}")
    for name, n in launches.items():
        if n != ENTRY_LAUNCHES.get(name, 0):
            fail(f"entry()'s step launched {name} {n} times, expected "
                 f"{ENTRY_LAUNCHES.get(name, 0)}")
    log("entry(): each kernel call of the step against its plain version "
        "on the same tensors (limit: exact equality)")
    for name, a, got in calls:
        check(name, got, wrappers[name][2](*a),
              f"entry() step, {'x'.join(map(str, a[0].shape))}")
    n_calls = {k: sum(c[0] == k for c in calls) for k in wrappers}
    if n_calls != ENTRY_LAUNCHES:
        fail(f"entry()'s step called the kernels' wrappers {n_calls} times, "
             f"expected {ENTRY_LAUNCHES}")
    n = 20
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        step(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) / n * 1e3
    ev_ms = time_ms(lambda: step(*args), iters=n)
    if profile:
        print(json.dumps({"profile_slam_step": profile_call(
            lambda: step(*args), host_ms, "step")}), flush=True)
    step_c, args_c = entry.entry(device="cpu")
    ref = step_c(*args_c)
    got = {k: v.cpu() for k, v in out.items()}
    errs = {k: float((got[k] - ref[k]).abs().max())
            for k in ("Y", "lc_R", "lc_t")}
    cost_rel = abs(float(got["cost"]) - float(ref["cost"])) / float(
        ref["cost"])
    log(f"entry(): slam_step {host_ms:.2f} ms host clock, {ev_ms:.2f} ms by "
        f"CUDA events; card vs CPU: lc_ok {got['lc_ok'].tolist()} / "
        f"{ref['lc_ok'].tolist()}, stereo inliers "
        f"{got['stereo_inliers'].tolist()} / {ref['stereo_inliers'].tolist()}"
        f", mono inliers {got['mono_inliers'].tolist()} / "
        f"{ref['mono_inliers'].tolist()}; max |diff| {errs} (limit 1e-5), "
        f"cost {float(got['cost']):.6g} (relative diff {cost_rel:.2e}, "
        f"limit 1e-5)")
    if not (torch.equal(got["lc_ok"], ref["lc_ok"])
            and torch.equal(got["stereo_inliers"], ref["stereo_inliers"])):
        fail("entry(): gates or stereo counts differ between card and CPU")
    if max(errs.values()) > 1e-5 or cost_rel > 1e-5:
        fail("entry(): the step on the card differs from the CPU's")
    if not got["lc_ok"].all():
        fail("entry(): a candidate pair of the step was rejected")
    return {"slam_step_ms": host_ms, "slam_step_event_ms": ev_ms,
            "slam_step_launches": launches,
            "slam_step_card_vs_cpu": dict(errs, cost_rel=cost_rel)}


# ------------------------------------------------------------- sim run
# the `sim` run of the port's CLI at the front-end run's size, nothing cut
SIM_ARGS = ["--mode", "sim", "--robots", str(N_ROBOTS), "--steps",
            str(N_FRAMES), "--features", str(K_FEAT), "--seed", "0"]
SIM_SUBMAP = 10
# gate (iv): each robot's APE translation RMSE, card against CPU
SIM_APE_REL, SIM_APE_ABS = 0.05, 1e-3


def sim_backend(edges, ppr: int, gnc_rounds: int):
    """The `sim` run's back-end on `edges`, through the CLI's own
    `_optimize_backend` (odometry initialization, then `robust_pgo`: PCM,
    GN under GNC). Returns (params, weights, info)."""
    import argparse

    from kimera_multi_tpu_torch.cli import run

    n_robots = int(edges.src_robot.max()) + 1
    params, weights, _, info = run._optimize_backend(
        argparse.Namespace(gnc_rounds=gnc_rounds), edges, n_robots, ppr,
        time.time())
    return params, weights, info


def sim_apes(params, world, device) -> list:
    """Each robot's APE (aligned, as the CLI's logs) of a keyframe-level
    solution."""
    from kimera_multi_tpu_torch.eval import ape

    T = world.t_gt.shape[1]
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return [ape.ape(params.t[r * T:(r + 1) * T].to(device),
                    params.R[r * T:(r + 1) * T].to(device), f(world.t_gt[r]),
                    f(world.R_gt[r])) for r in range(world.t_gt.shape[0])]


def check_log_tree(log_dir: str, n_robots: int, T: int, what: str,
                   final: int | None = None) -> None:
    """Every robot's TUM file holds T finite rows and every CSV of the
    reference schema carries the port's `io.logs` header. With `final`,
    a robot may hold several TUM files (the sharded back-end's dumps) and
    kimera_distributed_poses_tum_<final>.tum is the one checked."""
    import glob
    import os

    from kimera_multi_tpu_torch.io import logs

    headers = {"loop_closures.csv": logs.LOOP_CLOSURES_HEADER,
               "kimera_distributed_keyframes.csv": logs.KEYFRAMES_HEADER,
               "lcd_attempts.csv": logs.LCD_ATTEMPTS_HEADER,
               "dpgo_log_0.csv": logs.DPGO_LOG_HEADER,
               "output_lcd_status.csv": logs.LCD_STATUS_HEADER}
    for r in range(n_robots):
        tums = glob.glob(os.path.join(
            log_dir, f"robot{r}", "distributed",
            "kimera_distributed_poses_tum_"
            f"{'*' if final is None else final}.tum"))
        rows = logs.read_tum(tums[0])[1] if len(tums) == 1 else None
        if rows is None or len(rows) != T or not np.isfinite(rows).all():
            fail(f"{what}: robot {r}'s TUM files {tums} do not hold {T} "
                 f"finite rows")
        for name, h in headers.items():
            path = glob.glob(os.path.join(log_dir, f"robot{r}", "*", name))
            if len(path) != 1 or open(path[0]).readline().strip() != h:
                fail(f"{what}: robot {r}'s {name} lacks the header {h}")


# the kernels of the verification path (K2 is on no path)
PATH_KERNELS = ("pair_top2", "sample_gather_t", "sample_gather_perm_t",
                "permute_cols", "fivept_models", "presel_counts",
                "rigid_counts", "essential_counts")
# gate (viii): each robot's APE from the TUM files (rounded poses) against
# the run's own
REPLAY_APE_DIFF = 1e-4


def replay_gate(dev, out, world, log_dir: str, obs_dir: str,
                tmp: str) -> dict:
    """The replay acceptance gate on the card: `cli.replay.main` over a
    `sim` run's own logs and `--save-obs` streams, with ground-truth TUM
    files written from the world. Gates: accepted (every recorded
    attempt's status equal, mono and stereo counts exact), as many
    attempts as the run verified, each robot's APE within
    REPLAY_APE_DIFF of the run's own, every kernel of the verification
    path launched and no plain version run. Returns the stage entries."""
    import io
    import os

    from kimera_multi_tpu_torch.cli import replay as replay_cli
    from kimera_multi_tpu_torch.core import lie
    from kimera_multi_tpu_torch.io import logs, replay as replay_mod
    from kimera_multi_tpu_torch.kernels import _build

    n = world.t_gt.shape[0]
    gt = []
    for r in range(n):
        path = os.path.join(tmp, f"gt_robot{r}.tum")
        q = lie.rot_to_quat(torch.from_numpy(world.R_gt[r])).numpy()
        logs.write_tum(path, world.timestamps[r], world.t_gt[r], q)
        gt.append(f"robot{r}={path}")
    timing: dict = {}

    def timed(orig):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = orig(*a, **k)
            torch.cuda.synchronize()
            timing["verify_ms"] = (time.perf_counter() - t0) * 1e3
            return res
        return wrapped

    args = ["--log-dir", log_dir, "--obs-dir", obs_dir, "--robots", str(n),
            "--seed", "0", "--device", str(dev), "--gt", *gt]
    buf = io.StringIO()
    with patched(replay_mod, "replay_verify", timed), \
            plain_tripwire() as ran, contextlib.redirect_stdout(buf):
        _build.reset_launches()
        t = time.perf_counter()
        rc = replay_cli.main(args)
        torch.cuda.synchronize()
        cli_ms = (time.perf_counter() - t) * 1e3
        launches = dict(_build.launches)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    ape_diff = [abs(summary["ape"][str(r)]["rmse_trans"]
                    - out["ape"][r].rmse_trans) for r in range(n)]
    n_att = out["frontend"]["n_candidates"]
    log(f"replay: cli.replay.main({' '.join(args[:10])} ...) rc {rc} in "
        f"{cli_ms:.0f} ms (replay_verify {timing['verify_ms']:.0f} ms): "
        f"{ {k: v for k, v in summary.items() if k != 'ape'} }; APE "
        f"|replayed - run| {ape_diff} (limit {REPLAY_APE_DIFF}); launches "
        f"{launches}; plain versions run: {ran}")
    if rc != 0 or summary["accepted"] is not True:
        fail("replay: the gate rejects the run's own logs")
    if not (summary["n_candidates"] == summary["n_status_match"]
            == summary["n_mono_exact"] == summary["n_stereo_exact"]
            == n_att):
        fail(f"replay: not every one of the run's {n_att} attempts replays "
             f"bit for bit")
    if not all(d < REPLAY_APE_DIFF for d in ape_diff):
        fail("replay: a replayed APE is off the run's own")
    if ran:
        fail(f"replay: plain versions ran {ran}")
    idle = [k for k in PATH_KERNELS if launches.get(k, 0) == 0]
    if idle:
        fail(f"replay: kernels of the path never launched: {idle}")
    return {"replay_cli_ms": cli_ms,
            "replay_verify_ms": timing["verify_ms"],
            "replay_candidates": summary["n_candidates"],
            "replay_launches": launches,
            "replay_ape_diff_max": max(ape_diff)}


# ------------------------------------------------------------- artifacts
# `--artifacts` of the first `sim` run. Card against CPU, write_artifacts
# from the same optimized poses: the deformation's CG sums its dot
# products in another order on each device, so the corrected positions
# differ in their last bits, and a voxel whose pixel coordinate sits on a
# pixel edge may read the neighbouring pixel. Limits: at least this share
# of voxels with equal weights, equal histograms and TSDF values within
# ARTIFACT_TSDF_TOL of each other
ARTIFACT_GRID_SHARE = 0.999
ARTIFACT_TSDF_TOL = 1e-4
# every mesh vertex lies in the grid's box (an interpolation between voxel
# centres). A surface vertex moves -tsdf / |gradient| voxels from its
# voxel's centre, and the gradient wraps around the grid's faces (the JAX
# package's extraction, unchanged): where it is small the vertex leaves the
# box (9.4 % of them in this run on an H100, PERF.md). Its share inside
# the box is held to the CPU's from the same poses instead, within
ARTIFACT_SURFACE_SHARE_DIFF = 0.005


def read_ply(path: str):
    """(element counts, vertex rows (N, cols), faces (F, 4)) of an ASCII
    PLY; fails if the rows do not match the header's counts."""
    lines = open(path).read().splitlines()
    if not lines or lines[0] != "ply" or "end_header" not in lines:
        fail(f"artifacts: {path} has no PLY header")
    end = lines.index("end_header")
    counts = {ln.split()[1]: int(ln.split()[2]) for ln in lines[:end]
              if ln.startswith("element ")}
    body = lines[end + 1:]
    n_v, n_f = counts.get("vertex", 0), counts.get("face", 0)
    if len(body) != n_v + n_f:
        fail(f"artifacts: {path} holds {len(body)} rows for {n_v} vertices "
             f"and {n_f} faces")
    verts = np.asarray([[float(x) for x in r.split()] for r in body[:n_v]],
                       np.float64).reshape(n_v, -1)
    faces = np.asarray([[int(x) for x in r.split()] for r in body[n_v:]],
                       np.int64).reshape(-1, 4)
    return counts, verts, faces


def artifacts_gate(dev, out, world, params, tmp: str) -> dict:
    """Gates on the `--artifacts` outputs of a `sim` run: surface.ply,
    mesh.ply and run.html exist, the PLY headers parse and their counts
    match the rows and the run's counts; valid surface vertices and
    triangles > 0; every mesh vertex in the grid's box, every surface
    vertex finite; a second card run of `write_artifacts` from the same
    poses gives the same bits (grid, deformation states, PLY and HTML
    bytes); the CPU's run from the same poses gives a grid within
    ARTIFACT_GRID_SHARE / ARTIFACT_TSDF_TOL of the card's, and a share of
    surface vertices inside the box within ARTIFACT_SURFACE_SHARE_DIFF of
    the card's. Returns the stage entries."""
    import argparse
    import os

    from kimera_multi_tpu_torch.cli import run

    art = out["artifacts"]
    names = ("surface.ply", "mesh.ply", "run.html")
    if not all(os.path.exists(art["paths"][n]) for n in names):
        fail(f"artifacts: missing files among {art['paths']}")
    cs, vs, _ = read_ply(art["paths"]["surface.ply"])
    cm, vm, fm = read_ply(art["paths"]["mesh.ply"])
    if not (cs["vertex"] == art["n_vertices"] > 0
            and cm["face"] == art["n_triangles"] > 0
            and cm["vertex"] == 3 * cm["face"]
            and (fm[:, 0] == 3).all() and fm[:, 1:].max() < cm["vertex"]):
        fail(f"artifacts: PLY counts {cs} / {cm} against the run's "
             f"{art['n_vertices']} vertices, {art['n_triangles']} triangles")
    g = art["grid"]
    lo = g.origin.cpu().numpy().astype(np.float64)
    hi = lo + np.asarray(g.tsdf.shape) * g.voxel_size
    inside = lambda v: ((v >= lo - 1e-4) & (v <= hi + 1e-4)).all(1)  # noqa
    s_in = float(inside(vs[:, :3]).mean())
    log(f"artifacts: {art['n_vertices']} surface vertices ({s_in:.4f} in "
        f"the grid's box), {art['n_triangles']} triangles (all vertices in "
        f"the box: {bool(inside(vm).all())}); constraint residual after "
        f"the deformation (m) per robot {art['con_residual']}")
    if not (inside(vm).all() and np.isfinite(vs).all()):
        fail("artifacts: mesh vertices outside the grid's box, or surface "
             "vertices not finite")
    blobs = lambda paths: [open(paths[n], "rb").read()  # noqa: E731
                           for n in names]

    def again(d, p):
        ns = argparse.Namespace(steps=N_FRAMES, robots=N_ROBOTS,
                                log_dir=os.path.join(tmp, d))
        t = time.perf_counter()
        res = run.write_artifacts(ns, world, p)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    a2, ms2 = again("art_card", params)
    same = (all(torch.equal(getattr(art["grid"], f), getattr(a2["grid"], f))
                for f in ("tsdf", "weight", "sem_hist"))
            and all(torch.equal(x.R, y.R) and torch.equal(x.t, y.t)
                    for x, y in zip(art["states"], a2["states"]))
            and blobs(art["paths"]) == blobs(a2["paths"]))
    log(f"artifacts: a second card run of write_artifacts ({ms2:.0f} ms) "
        f"bit-identical (grid, deformation states, PLY and HTML bytes): "
        f"{same}")
    if not same:
        fail("artifacts: two card runs of write_artifacts differ")
    ac, msc = again("art_cpu", type(params)(R=params.R.cpu(),
                                            t=params.t.cpu()))
    gc = ac["grid"]
    w_eq = (g.weight.cpu() == gc.weight)
    h_eq = (g.sem_hist.cpu() == gc.sem_hist).all(-1)
    t_ok = (g.tsdf.cpu() - gc.tsdf).abs() <= ARTIFACT_TSDF_TOL
    share = float((w_eq & h_eq & t_ok).float().mean())
    tsdf_max = float((g.tsdf.cpu() - gc.tsdf).abs().max())
    s_in_cpu = float(inside(read_ply(
        ac["paths"]["surface.ply"])[1][:, :3]).mean())
    log(f"artifacts: the CPU's write_artifacts from the same poses "
        f"({msc:.0f} ms): voxels with equal weights "
        f"{float(w_eq.float().mean()):.6f}, "
        f"equal histograms {float(h_eq.float().mean()):.6f}, TSDF within "
        f"{ARTIFACT_TSDF_TOL:g} {float(t_ok.float().mean()):.6f} (all three "
        f"{share:.6f}, limit {ARTIFACT_GRID_SHARE}); TSDF max |card - CPU| "
        f"{tsdf_max:g}; CPU {ac['n_vertices']} vertices ({s_in_cpu:.4f} "
        f"in the box, limit |card - CPU| {ARTIFACT_SURFACE_SHARE_DIFF}), "
        f"{ac['n_triangles']} triangles")
    if share < ARTIFACT_GRID_SHARE or \
            abs(s_in - s_in_cpu) > ARTIFACT_SURFACE_SHARE_DIFF:
        fail("artifacts: the card's grid is off the CPU's")
    return {"artifacts_ms": out["stages"]["artifacts_s"] * 1e3,
            "artifacts_second_run_ms": ms2, "artifacts_cpu_ms": msc,
            "artifacts_surface_vertices": art["n_vertices"],
            "artifacts_triangles": art["n_triangles"],
            "artifacts_surface_inside_box": s_in,
            "artifacts_surface_inside_box_cpu": s_in_cpu,
            "artifacts_observed_voxels": int((g.weight > 0).sum()),
            "artifacts_con_residual_m": art["con_residual"],
            "artifacts_card_cpu_voxel_share": share,
            "artifacts_card_cpu_tsdf_max": tsdf_max}


def sim_phase(dev, profile: bool, fe_launches: dict) -> dict:
    """(f) the port's CLI, `cli.run.main(--mode sim)`, on make_world(6,
    1024, 704, seed=0) with the defaults (40 GNC rounds, 8 GN x 40 CG
    each), then once more with submaps of 10 keyframes. Gates: (i) every
    robot's TUM file has 1024 rows, every CSV header is the port's
    `io.logs` constant; (ii) PCM places every robot; (iii) each robot's
    APE below its odometry-only APE; (iv) the back-end rerun on the CPU
    from the same loops decides the same (consensus, frame_ok, loop
    closures under 0.5) and each APE within 5 % (or 1 mm); (v) two card
    runs of robust_pgo on the full graph give the same bits; (vi) the
    kernel launches inside main() equal the front-end phase's, and no
    plain version runs; (vii) with submaps, fewer optimized poses and
    each APE below max(2 x the keyframe-level value, 0.08); (viii) the
    first run's `--save-obs` streams and logs replayed by `cli.replay`
    (`replay_gate`); (ix) the first run's `--artifacts` outputs
    (`artifacts_gate`). Returns the stage entries."""
    import os
    import shutil
    import tempfile

    from kimera_multi_tpu_torch.cli import run
    from kimera_multi_tpu_torch.core.containers import EDGE_ODOMETRY
    from kimera_multi_tpu_torch.frontend.dlc import (
        FrontendConfig, build_pose_graph_from_loops)
    from kimera_multi_tpu_torch.io import sim_world
    from kimera_multi_tpu_torch.kernels import _build
    from kimera_multi_tpu_torch.solve import pgo

    tmp = tempfile.mkdtemp(prefix="kmt_sim_")
    try:
        log_dir = os.path.join(tmp, "keyframes")
        obs_dir = os.path.join(tmp, "obs")
        with plain_tripwire() as ran:
            _build.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run.main(SIM_ARGS + ["--log-dir", log_dir, "--save-obs",
                                       obs_dir, "--artifacts"])
            torch.cuda.synchronize()
            sim_ms = (time.perf_counter() - t) * 1e3
            launches = dict(_build.launches)
        st, be = out["stages"], out["backend"]
        edges, T = be["edges"], N_FRAMES
        n_edges = int(edges.valid.sum())
        n_loops = len(out["loops"])
        log(f"sim: main({' '.join(SIM_ARGS)}) in {sim_ms:.0f} ms: "
            f"{out['frontend']['n_candidates']} candidates, {n_loops} loops, "
            f"{n_edges} edges ({edges.capacity} slots); stages (s) {st}; "
            f"kernel launches {launches}; plain versions run: {ran}")
        # (vi)
        if ran:
            fail(f"sim: main() ran plain versions {ran}")
        if launches != fe_launches:
            fail(f"sim: main() launched {launches}, the front-end phase "
                 f"{fe_launches}")
        check_log_tree(log_dir, N_ROBOTS, T, "sim")                # (i)
        # (ii)
        if not bool(be["frame_ok"].all()):
            fail(f"sim: PCM left robots unplaced: {be['frame_ok'].tolist()}")
        # (iii)
        world = sim_world.make_world(n_robots=N_ROBOTS, n_steps=T,
                                     features_per_kf=K_FEAT, seed=0)
        R_kf, t_kf = run._odometry_poses(world)
        odo = sim_apes(pgo.PgoParams(
            R=torch.from_numpy(R_kf.reshape(-1, 3, 3)),
            t=torch.from_numpy(t_kf.reshape(-1, 3))), world, dev)
        ape = [out["ape"][r].rmse_trans for r in range(N_ROBOTS)]
        ape_odo = [a.rmse_trans for a in odo]
        log(f"sim: APE translation RMSE (m) per robot {ape}; odometry only "
            f"{ape_odo}")
        if not all(a < o for a, o in zip(ape, ape_odo)):
            fail("sim: a robot's APE is not below its odometry-only APE")
        # (ix) the artifacts of the run
        art_res = artifacts_gate(dev, out, world, be["params"], tmp)
        # (viii) the replay gate on the run's own logs and streams
        replay_res = replay_gate(dev, out, world, log_dir, obs_dir, tmp)
        # (v)
        torch.cuda.synchronize()
        t = time.perf_counter()
        p2, w2, i2 = sim_backend(edges, T, 40)
        torch.cuda.synchronize()
        backend_ms = (time.perf_counter() - t) * 1e3
        same = (torch.equal(p2.R, be["params"].R)
                and torch.equal(p2.t, be["params"].t)
                and torch.equal(w2, be["weights"]))
        log(f"sim: a second card run of the back-end ({backend_ms:.0f} ms) "
            f"bit-identical: {same}")
        if not same:
            fail("sim: two card runs of robust_pgo differ")
        # (iv)
        lc = (edges.valid & (edges.etype != EDGE_ODOMETRY)).cpu()
        t = time.perf_counter()
        e_cpu = build_pose_graph_from_loops(
            out["loops"], world.R_odo, world.t_odo, FrontendConfig(),
            device="cpu")
        pc, wc, ic = sim_backend(e_cpu, T, 40)
        cpu_ms = (time.perf_counter() - t) * 1e3
        ape_cpu = [a.rmse_trans for a in sim_apes(pc, world, "cpu")]
        under = lc & (be["weights"].cpu() < 0.5)
        under_cpu = lc & (wc < 0.5)
        cons_eq = torch.equal(be["consensus"].cpu(), ic["consensus"])
        ok_eq = torch.equal(be["frame_ok"].cpu(), ic["frame_ok"])
        ape_ok = all(abs(a - c) <= max(SIM_APE_REL * c, SIM_APE_ABS)
                     for a, c in zip(ape, ape_cpu))
        log(f"sim: the back-end on the CPU from the same loops in "
            f"{cpu_ms:.0f} ms: consensus equal {cons_eq} "
            f"({int(ic['consensus'].sum())} edges), frame_ok equal {ok_eq}, "
            f"loop closures under 0.5 {int(under.sum())} card / "
            f"{int(under_cpu.sum())} CPU (equal "
            f"{torch.equal(under, under_cpu)}); APE on the CPU {ape_cpu} "
            f"(limit {SIM_APE_REL:g} relative or {SIM_APE_ABS:g} m)")
        if not (cons_eq and ok_eq and torch.equal(under, under_cpu)
                and ape_ok):
            fail("sim: the card's back-end decides otherwise than the CPU's")
        res = {
            "sim_world": f"make_world({N_ROBOTS}, {T}, {K_FEAT}, seed=0)",
            "sim_ms": sim_ms, "sim_frontend_ms": st["frontend_s"] * 1e3,
            "build_pose_graph_ms": st["build_pose_graph_s"] * 1e3,
            "pcm_ms": st["pcm_s"] * 1e3,
            "robust_pgo_ms": st["robust_pgo_s"] * 1e3,
            "sim_logs_ms": st["logs_s"] * 1e3,
            "sim_backend_second_run_ms": backend_ms,
            "pcm_ms_second_run": i2["pcm_s"] * 1e3,
            "robust_pgo_ms_second_run": i2["robust_pgo_s"] * 1e3,
            "sim_backend_cpu_ms": cpu_ms,
            "sim_edges": n_edges, "sim_loops": n_loops,
            "sim_consensus": int(be["consensus"].sum()),
            "sim_under_05": int(under.sum()),
            "ape_rmse_trans": ape, "ape_rmse_trans_max": max(ape),
            "ape_rmse_trans_mean": float(np.mean(ape)),
            "ape_rmse_trans_cpu": ape_cpu,
            "odometry_ape_rmse_trans": ape_odo,
            "odometry_ape_rmse_trans_mean": float(np.mean(ape_odo)),
            "sim_launches": launches,
            "save_obs_ms": st["save_obs_s"] * 1e3,
        }
        res.update(replay_res)
        res.update(art_res)
        if profile:
            from kimera_multi_tpu_torch.solve.incidence import edge_incidence

            inc = edge_incidence(edges, T, N_ROBOTS * T)
            gn = lambda g, c: pgo.gauss_newton(
                be["params"], edges, be["weights"], T, gn_iters=g,
                cg_iters=c, inc=inc)
            gn(8, 40)
            torch.cuda.synchronize()
            t = time.perf_counter()
            gn(8, 40)
            torch.cuda.synchronize()
            gn_ms = (time.perf_counter() - t) * 1e3
            prof = profile_call(lambda: gn(8, 40), gn_ms, "call")
            k1 = profile_call(lambda: gn(1, 1), 1.0, "call")
            k2 = profile_call(lambda: gn(1, 2), 1.0, "call")
            prof["device_kernels_per_cg_step"] = (
                k2.get("device_kernels_per_call", 0)
                - k1.get("device_kernels_per_call", 0))
            prof["aten_ops_per_cg_step"] = (
                sum(aten_ops(lambda: gn(1, 2)).values())
                - sum(aten_ops(lambda: gn(1, 1)).values()))
            print(json.dumps({"profile_robust_pgo": prof}), flush=True)

        # (vii) submaps of SIM_SUBMAP keyframes
        out_s = run.main(SIM_ARGS + ["--submap-size", str(SIM_SUBMAP),
                                     "--log-dir", os.path.join(tmp, "sub")])
        ape_s = [out_s["ape"][r].rmse_trans for r in range(N_ROBOTS)]
        log(f"sim, submaps of {SIM_SUBMAP}: {out_s['n_opt_poses']} optimized "
            f"poses for {out_s['n_keyframes']} keyframes; robust_pgo "
            f"{out_s['stages']['robust_pgo_s'] * 1e3:.0f} ms; APE {ape_s} "
            f"(limit max(2 x keyframe level, 0.08))")
        if not out_s["n_opt_poses"] < out_s["n_keyframes"]:
            fail("sim: submaps did not reduce the optimized poses")
        if not all(a < max(2.0 * k, 0.08) for a, k in zip(ape_s, ape)):
            fail("sim: a robot's APE with submaps is out of the keyframe "
                 "level's class")
        res.update(robust_pgo_ms_submap10=out_s["stages"]["robust_pgo_s"]
                   * 1e3, sim_submap10_opt_poses=out_s["n_opt_poses"],
                   ape_rmse_trans_submap10=ape_s)
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------- vio-sim run
# the `vio-sim` run of the port's CLI at the reference envelope's widths
# (640 x 480, 300 features, a 25-keyframe window; params/D455) with 6
# robots; --steps (frames a robot processes: depth) is cut to fit the time
VIO_STEPS = 30
VIO_WIDTH, VIO_HEIGHT, VIO_FEATURES, VIO_WINDOW = 640, 480, 300, 25
VIO_ARGS = ["--mode", "vio-sim", "--robots", str(N_ROBOTS), "--steps",
            str(VIO_STEPS), "--vio-width", str(VIO_WIDTH), "--vio-height",
            str(VIO_HEIGHT), "--vio-features", str(VIO_FEATURES),
            "--vio-window", str(VIO_WINDOW), "--seed", "0"]
# gate 6: tests/test_vio_sim_e2e.py's run (its size, GNC rounds and the
# CLI's default widths), card against CPU; APE translation RMSE within the
# JAX package's own tolerance between two back-ends
VIO_SMALL_ARGS = ["--mode", "vio-sim", "--robots", "2", "--steps", "16",
                  "--seed", "0", "--gnc-rounds", "15"]
VIO_APE_DIFF = 0.15
# attitude: the largest angle (rad) between a relative rotation of
# consecutive keyframes and the ground truth's. The full-SE(3) APE is not
# gated: its position-only alignment leaves the roll about a short,
# nearly straight arc free, so it lands near 0.8 or near 2.0 from
# millimetre differences (at 2 x 16 on the CPU, the JAX package 0.81 /
# 0.89, the port with a float32 triangulation 0.81 / 1.99; VIO alone,
# robot 0: the JAX package 1.99, that port 1.01). A keyframe whose
# attitude misses the gravity
# alignment shows here as a ~1.5 rad step.
VIO_REL_ROT_MAX = 0.05
# gate 5: frames of one robot's pipeline, run twice; gate 4 records the
# reject step of this keyframe
VIO_DET_FRAMES, VIO_RECORD_KF = 20, 5
# `--lc-images` threshold of the run (metres of ground-truth distance a
# loop's keyframes must exceed): -1 selects every loop (robots on one arc
# revisit the very frames of the robot before, at distance 0)
VIO_LC_IMAGES = -1.0
# kernel launches of one keyframe's reject step (8-point mono gate:
# K4 at k = 8 twice, K9; Arun stereo gate: K4 at k = 3 twice, K8)
VIO_REJECT_LAUNCHES = {"sample_gather_perm_t": 4, "rigid_counts": 1,
                       "essential_counts": 1}


def vio_rel_rot_err(out) -> np.ndarray:
    """Each robot's largest angle (rad) between the relative rotation of
    two consecutive keyframes in the back-end's solution and in the
    ground truth."""
    G = np.asarray(out["gt"]["R"], np.float64)
    R = out["backend"]["params"].R.cpu().double().numpy().reshape(G.shape)
    rel = lambda M: np.einsum("rkji,rkjl->rkil", M[:, :-1], M[:, 1:])
    D = np.einsum("rkji,rkjl->rkil", rel(G), rel(R))
    # the angle from both the trace and the skew part (exact near 0)
    cos = (np.trace(D, axis1=-2, axis2=-1) - 1.0) / 2.0
    S = D - np.swapaxes(D, -1, -2)
    sin = 0.5 * np.linalg.norm(np.stack(
        [S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], -1), axis=-1)
    return np.arctan2(sin, cos).max(axis=1)


def vio_gate1(out, log_dir: str, n_robots: int, what: str) -> list:
    """tests/test_vio_sim_e2e.py's gates on one vio-sim run: loops (and
    inter-robot ones), each robot's APE translation RMSE under 0.5 m, the
    log tree; the attitude (VIO_REL_ROT_MAX); and the BoW weight span of
    gate 7. Returns (the APE results, the relative rotation errors)."""
    import os

    from kimera_multi_tpu_torch.io import logs

    ape = [out["ape"][r] for r in range(n_robots)]
    rot = vio_rel_rot_err(out)
    log(f"{what}: {out['n_keyframes']} keyframes, {out['n_loops']} "
        f"loops ({out['n_inter_loops']} inter-robot); APE trans "
        f"{[a.rmse_trans for a in ape]} full {[a.rmse_full for a in ape]}; "
        f"largest relative rotation error (rad) {rot.tolist()} (limit "
        f"{VIO_REL_ROT_MAX}); BoW weight span {out['bow_weight_span']:.4g} "
        f"(limit 2^22)")
    if out["n_loops"] < 1 or out["n_inter_loops"] < 1:
        fail(f"{what}: no (inter-robot) loop closure")
    if not all(a.rmse_trans < 0.5 for a in ape):
        fail(f"{what}: a robot's APE translation RMSE >= 0.5 m")
    if not (rot < VIO_REL_ROT_MAX).all():
        fail(f"{what}: a keyframe's attitude is off the ground "
             f"truth's by {VIO_REL_ROT_MAX} rad or more")
    if not out["bow_weight_span"] < 2.0 ** 22:
        fail(f"{what}: BoW weights span 2^22 or more: the float64 "
             f"sums of detection may round")
    lc = logs.read_csv(os.path.join(log_dir, "robot0", "distributed",
                                    "loop_closures.csv"))
    if "mono_inliers" not in lc:
        fail(f"{what}: loop_closures.csv lacks mono_inliers")
    for r in range(n_robots):
        if not os.path.isfile(os.path.join(log_dir, f"robot{r}", "single",
                                           "output_lcd_status.csv")):
            fail(f"{what}: robot {r} has no output_lcd_status.csv")
    return ape, rot


@contextlib.contextmanager
def patched(obj, name: str, make):
    """While open, obj.name is make(original)."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def vio_feed(vio, seq, k: int):
    """Frame k of `seq` into `vio`, after the IMU samples since frame k-1.
    Returns process_frame's result."""
    lo = seq.timestamps[k - 1] if k else -np.inf
    for i in np.nonzero((seq.imu_ts > lo)
                        & (seq.imu_ts <= seq.timestamps[k]))[0]:
        vio.add_imu(seq.imu_ts[i], seq.gyro[i], seq.accel[i])
    return vio.process_frame(seq.timestamps[k], seq.left[k], seq.right[k])


def vio_robot_run(dev, seq, cfg, frames: int, hooks=()):
    """One robot's VioPipeline over the first `frames` frames of `seq`,
    with `hooks` (context managers) open. Returns (pipeline, each
    keyframe-making frame's time in ms)."""
    from kimera_multi_tpu_torch.vio import pipeline

    with contextlib.ExitStack() as stack:
        for h in hooks:
            stack.enter_context(h)
        vio, ms = pipeline.VioPipeline(cfg, device=dev), []
        for k in range(frames):
            t = time.perf_counter()
            if vio_feed(vio, seq, k) is not None:
                ms.append((time.perf_counter() - t) * 1e3)
    return vio, ms


def path_wrappers() -> dict:
    """The kernel wrappers of the VIO and front-end paths: kernel ->
    (module, attribute, plain version called with the wrapper's arguments,
    looked up when called, after plain_tripwire has closed)."""
    from kimera_multi_tpu_torch.kernels import fivept, gather, hamming, score

    return {
        "pair_top2": (hamming, "_pair_top2",
                      lambda *a, **k: hamming._pair_top2_ref(*a, **k)),
        "sample_gather_t": (
            gather, "sample_gather_t",
            lambda *a, **k: gather.sample_gather_t_ref(*a, **k)),
        "sample_gather_perm_t": (
            gather, "sample_gather_perm_t",
            lambda d, p, o, inv: gather.sample_gather_perm_t_ref(d, p, o)),
        "permute_cols": (gather, "permute_cols",
                         lambda *a, **k: gather.permute_cols_ref(*a, **k)),
        "fivept_models": (
            fivept, "fivept_models",
            lambda *a, **k: fivept._fivept_models_ref(*a, **k)),
        "presel_counts": (
            fivept, "presel_counts",
            lambda *a, **k: fivept.presel_counts_ref(*a, **k)),
        "rigid_counts": (score, "rigid_counts",
                         lambda *a, **k: score.rigid_counts_ref(*a, **k)),
        "essential_counts": (
            score, "essential_counts",
            lambda *a, **k: score.essential_counts_ref(*a, **k)),
    }


def call_recorder(name: str, at: dict):
    """`patched`'s make for the kernel wrapper `name`: while at["list"] is
    a list, each call's arguments and result (tensors cloned) are appended
    to it as (name, args, kwargs, result)."""
    clone = lambda x: x.clone() if torch.is_tensor(x) else x  # noqa: E731

    def make(orig):
        def wrapped(*a, **k):
            calls = at["list"]
            if calls is None:
                return orig(*a, **k)
            args = tuple(clone(x) for x in a)
            got = orig(*a, **k)
            calls.append((name, args, dict(k), tuple(
                clone(g) for g in got) if isinstance(got, tuple)
                else clone(got)))
            return got
        return wrapped
    return make


@contextlib.contextmanager
def recorded_path(record_reject: int):
    """While open: every plain version tripwired, kernel launches counted
    from 0, those inside BatchedFrontend.process_all counted apart, and the
    kernel wrappers' calls, arguments and results cloned, recorded inside
    the `record_reject`-th VioPipeline._reject call of the run and inside
    process_all. Yields a dict: `ran` (plain versions run), `fe_launches`,
    `reject_calls` and `fe_calls` ((kernel, args, kwargs, result) each),
    and `launches`, filled when it closes."""
    from kimera_multi_tpu_torch.frontend import batched
    from kimera_multi_tpu_torch.kernels import _build
    from kimera_multi_tpu_torch.vio import pipeline

    box = {"fe_launches": {}, "reject_calls": [], "fe_calls": []}
    at = {"list": None, "n": 0}

    def count_fe(orig):
        def wrapped(self, *a, **k):
            before = dict(_build.launches)
            at["list"] = box["fe_calls"]
            try:
                return orig(self, *a, **k)
            finally:
                at["list"] = None
                for n, c in _build.launches.items():
                    box["fe_launches"][n] = (box["fe_launches"].get(n, 0)
                                             + c - before[n])
        return wrapped

    def in_reject(orig):
        def wrapped(*a, **k):
            if at["n"] == record_reject:
                at["list"] = box["reject_calls"]
            at["n"] += 1
            try:
                return orig(*a, **k)
            finally:
                at["list"] = None
        return wrapped

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(batched.BatchedFrontend, "process_all",
                                    count_fe))
        stack.enter_context(patched(pipeline.VioPipeline, "_reject",
                                    in_reject))
        for name, (m, attr, _) in path_wrappers().items():
            stack.enter_context(patched(m, attr, call_recorder(name, at)))
        box["ran"] = stack.enter_context(plain_tripwire())
        _build.reset_launches()
        yield box
        box["launches"] = dict(_build.launches)


def plain_over_subbatches(ref, a, k):
    """ref(*a, **k) over slices of SUB candidates (every tensor argument
    leads with the candidates), results concatenated."""
    C = a[0].shape[0]
    part = lambda i: ref(*(x[i:i + SUB] if torch.is_tensor(x) else x
                           for x in a), **k)
    outs = [part(i) for i in range(0, C, SUB)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def vio_path_gates(box, n_rej: int, path_kernels, what: str, check) -> dict:
    """Gates on a run recorded by `recorded_path`: (a) no plain version
    ran; (b) the VIO launched K4, K8 and K9 VIO_REJECT_LAUNCHES times per
    reject step (>= 8 correspondences) besides the front-end's launches,
    and every kernel of `path_kernels` launched; (c) the recorded reject
    step called each wrapper VIO_REJECT_LAUNCHES times and the front-end
    each as often as it launched, and every recorded call equals its
    plain version on the same tensors: exactly, K6 by its contract on the
    path's samples (`check_fivept`, NaN/finite pattern gated). Returns
    the VIO's launches."""
    launches, fe = box["launches"], box["fe_launches"]
    if box["ran"]:
        fail(f"{what}: main() ran plain versions {box['ran']}")
    vio_launches = {n: c - fe.get(n, 0) for n, c in launches.items()}
    want = {n: VIO_REJECT_LAUNCHES.get(n, 0) * n_rej for n in launches}
    if vio_launches != want:
        fail(f"{what}: VIO launched {vio_launches}, expected {want} for "
             f"{n_rej} reject steps")
    idle = [n for n in path_kernels if launches.get(n, 0) == 0]
    if idle:
        fail(f"{what}: kernels of the path never launched: {idle}")
    plain = path_wrappers()
    for key, label, expect in (
            ("reject_calls", "VIO reject", VIO_REJECT_LAUNCHES),
            ("fe_calls", "front-end", {n: c for n, c in fe.items() if c})):
        calls = box[key]
        n_calls = {n: sum(c[0] == n for c in calls) for n in expect}
        if n_calls != expect or len(calls) != sum(expect.values()):
            fail(f"{what}: the {label} calls recorded {n_calls}, expected "
                 f"{expect}")
        log(f"{what}: the {label} calls ({len(calls)}), each against its "
            f"plain version on the same tensors (limit: exact equality; "
            f"K6 its NaN/finite pattern, the rest reported)")
        for name, a, k, got in calls:
            where = f"{label}, {'x'.join(map(str, a[0].shape))}"
            ref = plain_over_subbatches(plain[name][2], a, k)
            if name == "fivept_models":
                check_fivept(where, got, ref, k["gn_iters"], gated=False)
            else:
                check(name, got, ref, where)
    return vio_launches


def vio_lc_images_gate(out, log_dir: str) -> dict:
    """Gate (8) of the `vio-sim` run: `--lc-images VIO_LC_IMAGES` wrote
    one PNG per loop whose keyframes' ground-truth distance exceeds the
    threshold, at least one, each a PNG that reads back at the pair's
    size (two frames, a 4-pixel divider, an 11-row caption), and a
    manifest of as many entries. Returns the stage entries."""
    import os

    from kimera_multi_tpu_torch.io.convert import load_image

    t_gt = out["gt"]["t"]
    dist = np.asarray([np.linalg.norm(t_gt[lc.robot_a, lc.frame_a]
                                      - t_gt[lc.robot_b, lc.frame_b])
                       for lc in out["loops"]])
    want = int((dist > VIO_LC_IMAGES).sum())
    paths = out["lc_images"] or []
    shapes = {load_image(p).shape for p in paths}
    manifest = json.load(open(os.path.join(log_dir, "lc_images",
                                           "lc_images.json")))
    log(f"vio-sim: --lc-images {VIO_LC_IMAGES:g}: {len(paths)} PNGs for "
        f"{want} loops over the threshold (of {len(dist)}; "
        f"{int((dist > 0).sum())} at a ground-truth distance > 0, the "
        f"largest {dist.max() if len(dist) else 0.0:.3f} m), image shapes "
        f"{shapes}, {out['stages']['lc_images_s'] * 1e3:.0f} ms")
    want_shape = (VIO_HEIGHT + 11, 2 * VIO_WIDTH + 4)
    if not (len(paths) == want >= 1 and len(manifest) == want
            and shapes == {want_shape}):
        fail(f"vio-sim: --lc-images wrote {len(paths)} pairs of shapes "
             f"{shapes}, expected {want} of {want_shape}")
    return {"vio_lc_images": len(paths),
            "vio_lc_images_threshold_m": VIO_LC_IMAGES,
            "vio_lc_images_ms": out["stages"]["lc_images_s"] * 1e3,
            "vio_loop_gt_distance_max_m": float(dist.max()),
            "vio_loops_at_distance_gt_0": int((dist > 0).sum())}


def vio_phase(dev, profile: bool, check) -> dict:
    """(g) the port's CLI, `cli.run.main(--mode vio-sim)`, at 640 x 480,
    300 features, window 25, 6 robots x VIO_STEPS frames. Gates: (1) loops
    and inter-robot loops, each robot's APE translation RMSE < 0.5 m, the
    log tree; (2) no plain version runs inside main(); (3) inside main(),
    K4, K8 and K9 launch 4, 1 and 1 times per keyframe whose reject step
    ran (>= 8 correspondences) besides the front-end's launches, and every
    kernel of the path launches; (4) the kernel calls of one keyframe's
    reject step and of the front-end, recorded inside main(), equal their
    plain versions on the same tensors (`vio_path_gates`); (5) two card
    runs of one robot's pipeline over 20 frames at full width give the
    same bits; (6) card and CPU at the JAX e2e test's size both pass (1),
    each robot's translation APE within 0.15 m of the other's; (7) BoW
    weight span under 2^22 in every run; (8) the run's `--lc-images`
    evidence (`vio_lc_images_gate`).
    (1) also bounds every relative rotation of consecutive keyframes
    against the ground truth's (VIO_REL_ROT_MAX). Returns the stage
    entries."""
    import os
    import shutil
    import tempfile

    from kimera_multi_tpu_torch.cli import run
    from kimera_multi_tpu_torch.io import render
    from kimera_multi_tpu_torch.vio import pipeline, tracking

    tmp = tempfile.mkdtemp(prefix="kmt_vio_")
    try:
        # ---- the run, launches counted apart for the front-end ---------
        log_dir = os.path.join(tmp, "full")
        with recorded_path(VIO_RECORD_KF) as box:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run.main(VIO_ARGS + ["--log-dir", log_dir, "--lc-images",
                                       str(VIO_LC_IMAGES)])
            torch.cuda.synchronize()
            vio_sim_ms = (time.perf_counter() - t) * 1e3
        launches, fe_launches = box["launches"], box["fe_launches"]
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        st = out["stages"]
        n_rej = sum(s.n_corresp >= 8 for rl in out["rejection_logs"]
                    for s in rl)
        kf_ms = np.asarray(st["vio_frame_s"]) * 1e3
        log(f"vio-sim: main({' '.join(VIO_ARGS)}) in {vio_sim_ms:.0f} ms; "
            f"stages (s) { {k: v for k, v in st.items() if k != 'vio_frame_s'} }"
            f"; keyframe ms mean {kf_ms.mean():.1f} p90 "
            f"{np.percentile(kf_ms, 90):.1f}; launches {launches} (front-end "
            f"{fe_launches}); {n_rej} reject steps; plain versions run: "
            f"{box['ran']}; peak {peak_mb:.0f} MB")
        ape, rot = vio_gate1(out, log_dir, N_ROBOTS,
                              "vio-sim full width")  # 1, 7
        vio_path_gates(box, n_rej, PATH_KERNELS, "vio-sim", check)  # 2 - 4
        del box
        lc_res = vio_lc_images_gate(out, log_dir)  # 8

        # ---- one robot at full width: stages, bits ---------------------
        cfg = run.vio_sim_config(VIO_WIDTH, VIO_HEIGHT, VIO_FEATURES,
                                 VIO_WINDOW)
        seq = render.render_sequence(
            render.make_scene(0, max(350, 4 * VIO_FEATURES)),
            render.StereoRig(cfg.cam, VIO_HEIGHT, VIO_WIDTH, cfg.baseline),
            n_frames=VIO_DET_FRAMES + 2, rate_hz=10.0, imu_rate_hz=100.0,
            speed=0.6, yaw_rate=0.1, device=dev)
        stage_s: dict = {}
        nested = []

        def timed(label):
            def make(orig):
                def wrapped(*a, **k):
                    lab = "stereo_klt" if nested and label == "klt" else label
                    nested.append(lab)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    try:
                        return orig(*a, **k)
                    finally:
                        torch.cuda.synchronize()
                        stage_s[lab] = stage_s.get(lab, 0.0) + (
                            time.perf_counter() - t0)
                        nested.pop()
                return wrapped
            return make

        P = pipeline.VioPipeline
        hooks = [patched(P, "_klt", timed("klt")),
                 patched(P, "_stereo", timed("stereo")),
                 patched(tracking, "gftt_detect", timed("gftt_refill")),
                 patched(P, "_refill", timed("gftt_refill")),
                 patched(pipeline.desc_mod, "describe", timed("describe")),
                 patched(P, "_reject", timed("reject")),
                 patched(P, "_preintegrate_buffer", timed("preintegrate")),
                 patched(P, "_optimize_window", timed("smooth"))]
        vio1, _ = vio_robot_run(dev, seq, cfg, VIO_DET_FRAMES, hooks)
        n_kf = len(vio1.keyframes)
        stage_ms = {k: v / n_kf * 1e3 for k, v in stage_s.items()}
        log(f"vio, one robot at full width: {n_kf} keyframes; ms a keyframe "
            f"by stage (synchronised) {stage_ms}")
        vio2, kf_ms2 = vio_robot_run(dev, seq, cfg, VIO_DET_FRAMES)
        same = {f: all(np.array_equal(getattr(a, f), getattr(b, f))
                       for a, b in zip(vio1.keyframes, vio2.keyframes))
                for f in ("R", "t", "v", "descriptors", "valid", "lm_valid")}
        log(f"vio: two card runs of one robot over {VIO_DET_FRAMES} frames, "
            f"fields bit-identical: {same}")
        if len(vio2.keyframes) != n_kf or not all(same.values()):  # 5
            fail("vio: two card runs of one robot's pipeline differ")

        res = {
            "vio_args": " ".join(VIO_ARGS), "vio_sim_ms": vio_sim_ms,
            "vio_render_ms": st["render_s"] * 1e3,
            "vio_ms": st["vio_s"] * 1e3, "vio_keyframes": out["n_keyframes"],
            "vio_keyframes_made": int(kf_ms.size),
            "vio_keyframe_ms_mean": float(kf_ms.mean()),
            "vio_keyframe_ms_p90": float(np.percentile(kf_ms, 90)),
            "vio_fe_ms": st["frontend_s"] * 1e3,
            "vio_build_pose_graph_ms": st["build_pose_graph_s"] * 1e3,
            "vio_pcm_ms": st["pcm_s"] * 1e3,
            "vio_robust_pgo_ms": st["robust_pgo_s"] * 1e3,
            "vio_logs_ms": st["logs_s"] * 1e3,
            "vio_n_loops": out["n_loops"],
            "vio_n_inter_loops": out["n_inter_loops"],
            "vio_bow_weight_span": out["bow_weight_span"],
            "vio_reject_steps": n_rej, "vio_launches": launches,
            "vio_fe_launches": fe_launches, "vio_peak_mem_mb": peak_mb,
            "vio_one_robot_keyframe_ms_by_stage": stage_ms,
            "vio_one_robot_keyframe_ms": kf_ms2,
        }
        for r, a in enumerate(ape):
            res[f"vio_ape_rmse_trans_{r}"] = a.rmse_trans
            res[f"vio_ape_rmse_full_{r}"] = a.rmse_full
        res["vio_rel_rot_max"] = rot.tolist()
        res.update(lc_res)

        if profile:
            # one more keyframe of the second run, traced; the aten
            # operations of each stage on the next one
            from torch.profiler import ProfilerActivity, profile as tprof

            k = VIO_DET_FRAMES
            with tprof(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                vio_feed(vio2, seq, k)
                torch.cuda.synchronize()
            summ = device_summary(prof, float(np.mean(kf_ms2[-3:])))
            ops: dict = {}

            def counted(label):
                def make(orig):
                    def wrapped(*a, **kw):
                        box = {}

                        def call():
                            box["r"] = orig(*a, **kw)
                        for n, c in aten_ops(call).items():
                            ops.setdefault(label, {})
                            ops[label][n] = ops[label].get(n, 0) + c
                        return box["r"]
                    return wrapped
                return make

            with contextlib.ExitStack() as stack:
                for lab, (obj, name) in {
                        "klt_and_stereo": (P, "_klt"),
                        "gftt": (tracking, "gftt_detect"),
                        "describe": (pipeline.desc_mod, "describe"),
                        "reject": (P, "_reject"),
                        "preintegrate": (P, "_preintegrate_buffer"),
                        "smooth": (P, "_optimize_window")}.items():
                    stack.enter_context(patched(obj, name, counted(lab)))
                vio_feed(vio2, seq, k + 1)
            summ["aten_ops_by_stage"] = {
                lab: sum(c.values()) for lab, c in ops.items()}
            summ["top_aten_ops_smooth"] = dict(sorted(
                ops.get("smooth", {}).items(), key=lambda kv: -kv[1])[:12])
            print(json.dumps({"profile_vio_keyframe": summ}), flush=True)

        # ---- card against CPU at the JAX e2e test's size (6, 7) ---------
        small = {}
        for d in (str(dev), "cpu"):
            ld = os.path.join(tmp, f"small_{d}")
            t = time.perf_counter()
            o = run.main(VIO_SMALL_ARGS + ["--device", d, "--log-dir", ld])
            ms = (time.perf_counter() - t) * 1e3
            small[d] = vio_gate1(o, ld, 2, f"vio-sim 2 x 16 on the {d}") + (
                ms, o)
        diff = [abs(a.rmse_trans - b.rmse_trans)
                for a, b in zip(small[str(dev)][0], small["cpu"][0])]
        log(f"vio-sim 2 x 16: card {small[str(dev)][2]:.0f} ms, CPU "
            f"{small['cpu'][2]:.0f} ms; APE trans |card - CPU| {diff} "
            f"(limit {VIO_APE_DIFF})")
        if not all(x < VIO_APE_DIFF for x in diff):
            fail("vio-sim 2 x 16: card and CPU APE differ by 0.15 m or more")
        res.update(
            vio_small_args=" ".join(VIO_SMALL_ARGS),
            vio_small_card_ms=small[str(dev)][2],
            vio_small_cpu_ms=small["cpu"][2],
            vio_small_ape_rmse_trans={d: [a.rmse_trans for a in v[0]]
                                      for d, v in small.items()},
            vio_small_ape_rmse_full={d: [a.rmse_full for a in v[0]]
                                     for d, v in small.items()},
            vio_small_rel_rot_max={d: v[1].tolist()
                                   for d, v in small.items()},
            vio_small_loops={d: v[3]["n_loops"] for d, v in small.items()})
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------- euroc run
# the `euroc` run of the port's CLI on three sessions rendered at EuRoC's
# published camera (cam0: 752 x 480, intrinsics 458.654, 457.296, 367.215,
# 248.375; stereo baseline 0.110 m; camera 20 Hz, IMU 200 Hz), staggered by
# 20 frames on one arc so later sessions revisit earlier places; depth is
# cut from a real session's 2,000 - 3,700 frames to 40 for the time limit
EUROC_W, EUROC_H = 752, 480
EUROC_INTR = (458.654, 457.296, 367.215, 248.375)
EUROC_BASELINE = 0.110
EUROC_CAM_HZ, EUROC_IMU_HZ = 20.0, 200.0
EUROC_STEPS, EUROC_STAGGER, EUROC_SESSIONS = 40, 20, 3
EUROC_ARGS = ["--mode", "euroc", "--steps", str(EUROC_STEPS), "--seed", "0"]
# the converter's 96 features are no more than twice the 5-point gate's 64
# preselect points, so the gate scores every hypothesis, as the JAX
# package's does (kernels/ransac.py, ransac_essential_5pt): K3 and K7 are
# not on this path
EUROC_PATH_KERNELS = tuple(k for k in PATH_KERNELS
                           if k not in ("sample_gather_t", "presel_counts"))


def euroc_sessions(dev, d: str) -> list:
    """Session 0 an ASL tree of PNG frames (the port's `png.write_png`),
    session 1 an ASL tree of PGM frames, session 2 a rosbag1 file (the
    port's `rosbag.BagWriter`), each EUROC_STEPS frames of one rendered
    arc, EUROC_STAGGER frames apart, with the true attitudes in the
    ground truth."""
    import os

    from kimera_multi_tpu_torch.io import record, render
    from kimera_multi_tpu_torch.vio.undistort import CameraModel

    fu, fv, cu, cv = EUROC_INTR
    rig = render.StereoRig(cam=CameraModel(fx=fu, fy=fv, cx=cu, cy=cv),
                           H=EUROC_H, W=EUROC_W, baseline=EUROC_BASELINE)
    n = EUROC_STAGGER * (EUROC_SESSIONS - 1) + EUROC_STEPS
    seq = render.render_sequence(
        render.make_scene(seed=0, n_points=1200), rig, n_frames=n,
        rate_hz=EUROC_CAM_HZ, imu_rate_hz=EUROC_IMU_HZ, speed=0.6,
        yaw_rate=0.1, device=dev)
    w = lambda k: dict(first=k * EUROC_STAGGER, n=EUROC_STEPS)
    return [
        record.write_asl_session(os.path.join(d, "session0"), seq,
                                 EUROC_INTR, EUROC_BASELINE,
                                 image_format="png", **w(0)),
        record.write_asl_session(os.path.join(d, "session1"), seq,
                                 EUROC_INTR, EUROC_BASELINE, **w(1)),
        record.write_bag_session(os.path.join(d, "session2.bag"), seq,
                                 EUROC_INTR, EUROC_BASELINE, **w(2))]


def png_adaptive(img: np.ndarray) -> tuple:
    """An 8-bit grayscale PNG of `img` (H, W) uint8 whose rows take
    libpng's adaptive filter choice: of the five filters, the one whose
    filtered bytes, read as signed, have the least sum of magnitudes.
    Returns (the file's bytes, rows per filter type)."""
    import struct
    import zlib

    x = img.astype(np.int16)
    h, w = x.shape
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = (np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
            & 255).astype(np.uint8)                              # (5, h, w)
    f = np.abs(cand.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
    rows = np.concatenate([f[:, None].astype(np.uint8),
                           cand[f, np.arange(h)]], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b"")), np.bincount(f, minlength=5).tolist()


def euroc_phase(dev, check) -> dict:
    """(h) the port's CLI, `cli.run.main(--mode euroc)`, over
    `euroc_sessions` (an ASL tree of PNG frames, one of PGM frames, a
    bag). Gates: (1) 120 keyframes (every frame is one), at least one
    inter-robot loop, each robot's APE translation RMSE < 0.5 m, the
    relative rotations of consecutive keyframes within VIO_REL_ROT_MAX of
    the ground truth's, the BoW weight span under 2^22, the log tree's
    files and headers; (2) no plain version runs inside main(); (3) K4,
    K8 and K9 launch 4, 1 and 1 times a reject step besides the
    front-end's launches, and every kernel of the path launches
    (EUROC_PATH_KERNELS); (4) the kernel calls of one reject step and of
    the front-end, recorded inside main(), equal their plain versions on
    the same tensors (`vio_path_gates`); (5) the converter on the card,
    `io.convert.main(["--euroc", session 1, ...])`, writes obs_robot0.npz
    equal bit for bit to the keyframe products session 1 gave inside
    main(); (6) a frame written as a PNG with libpng's adaptive row
    filters reads back equal, and its decode is timed beside the run's
    PGM and PNG. Returns the stage entries."""
    import os
    import shutil
    import tempfile

    from kimera_multi_tpu_torch.cli import run
    from kimera_multi_tpu_torch.io import convert, dataset, replay

    tmp = tempfile.mkdtemp(prefix="kmt_euroc_")
    try:
        t = time.perf_counter()
        roots = euroc_sessions(dev, tmp)
        write_ms = (time.perf_counter() - t) * 1e3
        log_dir = os.path.join(tmp, "logs")
        args = EUROC_ARGS + ["--euroc-roots", *roots, "--log-dir", log_dir,
                             "--device", str(dev)]
        with recorded_path(VIO_RECORD_KF) as box:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run.main(args)
            torch.cuda.synchronize()
            euroc_ms = (time.perf_counter() - t) * 1e3
        launches, fe_launches = box["launches"], box["fe_launches"]
        st = out["stages"]
        n_rej = sum(s.n_corresp >= 8 for rl in out["rejection_logs"]
                    for s in rl)
        kf_ms = np.asarray(st["vio_frame_s"]) * 1e3
        log(f"euroc: {EUROC_SESSIONS} sessions of {EUROC_STEPS} frames at "
            f"{EUROC_W} x {EUROC_H} written in {write_ms:.0f} ms; main("
            f"{' '.join(EUROC_ARGS)} --euroc-roots <png tree> <pgm tree> "
            f"<bag>) in {euroc_ms:.0f} ms; stages (s) "
            f"{ {k: v for k, v in st.items() if k != 'vio_frame_s'} }; "
            f"keyframe ms mean {kf_ms.mean():.1f} p90 "
            f"{np.percentile(kf_ms, 90):.1f}; launches {launches} "
            f"(front-end {fe_launches}); {n_rej} reject steps; plain "
            f"versions run: {box['ran']}")
        T = EUROC_STEPS
        if out["n_keyframes"] != EUROC_SESSIONS * T:                # 1
            fail(f"euroc: {out['n_keyframes']} keyframes, expected "
                 f"{EUROC_SESSIONS * T}")
        ape, rot = vio_gate1(out, log_dir, EUROC_SESSIONS, "euroc")
        check_log_tree(log_dir, EUROC_SESSIONS, T, "euroc")
        if not os.path.isdir(os.path.join(log_dir, "bags", "bag_robot2",
                                          "mav0")):
            fail("euroc: the bag was not extracted to an ASL tree")
        vio_path_gates(box, n_rej, EUROC_PATH_KERNELS, "euroc",
                       check)                                      # 2 - 4
        del box

        # (5) the converter on the card, on session 1
        conv_dir = os.path.join(tmp, "converted")
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = convert.main(["--euroc", roots[1], "--out", conv_dir,
                           "--max-frames", str(EUROC_STEPS), "--device",
                           str(dev)])
        torch.cuda.synchronize()
        convert_ms = (time.perf_counter() - t) * 1e3
        got = replay.load_observations(replay.obs_path(conv_dir, 0))
        ref = out["observations"][1]
        same = {f: np.array_equal(getattr(got, f), getattr(ref, f))
                for f in ref._fields}
        log(f"euroc: io.convert.main(--euroc session1) rc {rc} in "
            f"{convert_ms:.0f} ms; obs_robot0.npz equal to main()'s "
            f"products of session 1: {same}")
        if rc != 0 or not all(same.values()):                     # 5
            fail("euroc: the converter's products differ from the run's")

        # (6) image decode on the host, per 752 x 480 image: the run's
        # PGM and its RGB PNG (write_png: filter 0 on every row), and the
        # same frame as grayscale with libpng's adaptive row filters
        # (Sub, Up, Average, Paeth), as real EuRoC frames are written
        sess0, sess1 = (dataset.load_euroc(r) for r in roots[:2])
        img = convert.load_image(sess1.cam_files[0]).astype(np.uint8)
        adaptive = os.path.join(tmp, "adaptive.png")
        data, filters = png_adaptive(img)
        with open(adaptive, "wb") as f:
            f.write(data)
        if not np.array_equal(convert.load_image(adaptive), img):   # 6
            fail("euroc: a PNG with adaptive row filters decodes wrong")
        decode_ms = {}
        for name, path in (("pgm", sess1.cam_files[0]),
                           ("png_rgb_filter0", sess0.cam_files[0]),
                           ("png_gray_adaptive", adaptive)):
            ts = []
            for _ in range(11):
                t = time.perf_counter()
                convert.load_image(path)
                ts.append((time.perf_counter() - t) * 1e3)
            decode_ms[name] = float(np.median(ts))
        log(f"euroc: load_image of one {EUROC_W} x {EUROC_H} image, median "
            f"of 11 (ms): {decode_ms}; the adaptive PNG's rows per filter "
            f"type (None, Sub, Up, Average, Paeth) {filters}")

        res = {
            "euroc_args": " ".join(EUROC_ARGS),
            "euroc_camera": f"{EUROC_W}x{EUROC_H} {EUROC_INTR} baseline "
                            f"{EUROC_BASELINE} {EUROC_CAM_HZ:g} Hz / IMU "
                            f"{EUROC_IMU_HZ:g} Hz",
            "euroc_write_sessions_ms": write_ms, "euroc_ms": euroc_ms,
            "euroc_bags_ms": st["bags_s"] * 1e3,
            "euroc_io_ms": st["io_s"] * 1e3,
            "euroc_vio_ms": st["vio_s"] * 1e3,
            "euroc_keyframes": out["n_keyframes"],
            "euroc_keyframe_ms_mean": float(kf_ms.mean()),
            "euroc_keyframe_ms_p90": float(np.percentile(kf_ms, 90)),
            "euroc_fe_ms": st["frontend_s"] * 1e3,
            "euroc_build_pose_graph_ms": st["build_pose_graph_s"] * 1e3,
            "euroc_pcm_ms": st["pcm_s"] * 1e3,
            "euroc_robust_pgo_ms": st["robust_pgo_s"] * 1e3,
            "euroc_logs_ms": st["logs_s"] * 1e3,
            "euroc_n_loops": out["n_loops"],
            "euroc_n_inter_loops": out["n_inter_loops"],
            "euroc_bow_weight_span": out["bow_weight_span"],
            "euroc_reject_steps": n_rej, "euroc_launches": launches,
            "euroc_fe_launches": fe_launches,
            "euroc_ape_rmse_trans": [a.rmse_trans for a in ape],
            "euroc_rel_rot_max": rot.tolist(),
            "euroc_convert_ms": convert_ms,
            "euroc_load_image_ms": decode_ms,
            "euroc_png_adaptive_filters": filters,
        }
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------ sequential front-end
# the sequential front-end (`DistributedFrontend`, `--frontend sequential`)
# on make_world(6, SEQ_STEPS, 704, seed=1): its per-keyframe host loop
# verifies one pair at a time (about 60 ms a pair on an H100, launch-bound,
# PERF.md), so the depth is cut from the `sim` run's 1,024 keyframes a
# robot to 32 for the time limit (945 pairs; 128 keyframes a robot take
# about 300 s, PERF.md)
SEQ_STEPS = 32


@contextlib.contextmanager
def recorded_pair(record: int):
    """While open: every plain version tripwired, kernel launches counted
    from 0, and the kernel wrappers' calls (arguments and results cloned)
    recorded inside the `record`-th `DistributedFrontend._verify_pair`.
    Yields a dict: `ran`, `calls` ((kernel, args, kwargs, result) each),
    `launches` (filled when it closes)."""
    from kimera_multi_tpu_torch.frontend import dlc
    from kimera_multi_tpu_torch.kernels import _build

    box = {"calls": []}
    at = {"list": None, "n": 0}

    def in_pair(orig):
        def wrapped(*a, **k):
            if at["n"] == record:
                at["list"] = box["calls"]
            at["n"] += 1
            try:
                return orig(*a, **k)
            finally:
                at["list"] = None
        return wrapped

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(dlc.DistributedFrontend, "_verify_pair",
                                    in_pair))
        for name, (m, attr, _) in path_wrappers().items():
            stack.enter_context(patched(m, attr, call_recorder(name, at)))
        box["ran"] = stack.enter_context(plain_tripwire())
        _build.reset_launches()
        yield box
        box["launches"] = dict(_build.launches)


def sequential_phase(dev, check, steps: int = SEQ_STEPS) -> dict:
    """(i) `DistributedFrontend(6, steps, vocab,
    FrontendConfig()).process_all` on make_world(6, steps, 704, seed=1)
    on the card, against `BatchedFrontend.process_all` on the same world.
    Gates: (1) the same attempts and loops, in order and bit for bit:
    keys, status, acceptance, mono and stereo counts, BoW scores, R and t
    (the verifier sums in an order that does not follow the batch size,
    kernels/minimal.py); (2) no plain version runs; (3) every kernel of
    the verification path launches, each as many times per verified pair
    as the recorded pair called it; (4) each kernel call of one verified
    pair (the first), recorded inside the run, equals its plain version
    on the same tensors (K6 by its contract's NaN/finite pattern,
    `check_fivept`). Returns the stage entries."""
    from kimera_multi_tpu_torch.frontend import batched, dlc, vocab
    from kimera_multi_tpu_torch.frontend.dlc import FrontendConfig
    from kimera_multi_tpu_torch.io import sim_world

    world = sim_world.make_world(n_robots=N_ROBOTS, n_steps=steps,
                                 features_per_kf=K_FEAT, seed=1)
    corpus = world.descriptors[world.obs_valid].reshape(-1, 32)
    voc = vocab.build_vocabulary(corpus[:: max(1, len(corpus) // 4000)],
                                 k=8, depth=3, seed=0, device=dev)
    data = (world.descriptors, world.bearings_local, world.landmarks_local,
            world.obs_valid)
    bat = batched.BatchedFrontend(N_ROBOTS, steps, voc, FrontendConfig(),
                                  device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    bat.process_all(*data)
    torch.cuda.synchronize()
    bat_ms = (time.perf_counter() - t) * 1e3
    seq = dlc.DistributedFrontend(N_ROBOTS, steps, voc, FrontendConfig(),
                                  device=dev)
    with recorded_pair(0) as box:
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = seq.process_all(*data)
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t) * 1e3
    launches, n_att = box["launches"], len(seq.lcd_attempts)
    row = lambda lc: (lc.robot_a, lc.frame_a, lc.robot_b, lc.frame_b,  # noqa
                      lc.status, lc.accepted, lc.mono_inliers,
                      lc.stereo_inliers, lc.bow_score,
                      np.asarray(lc.R).tobytes(), np.asarray(lc.t).tobytes())
    same_att = [row(a) for a in seq.lcd_attempts] \
        == [row(a) for a in bat.lcd_attempts]
    pairs = list(zip(seq.lcd_attempts, bat.lcd_attempts))
    field_eq = {f: sum(getattr(a, f) == getattr(b, f) for a, b in pairs)
                for f in ("robot_a", "frame_a", "robot_b", "frame_b",
                          "status", "accepted", "mono_inliers",
                          "stereo_inliers", "bow_score")}
    rt_eq = sum(row(a)[-2:] == row(b)[-2:] for a, b in pairs)
    log(f"sequential vs batched, field by field (of {len(pairs)}): "
        f"{field_eq}; R, t bit-equal {rt_eq}")
    per_pair = {n: sum(c[0] == n for c in box["calls"])
                for n in PATH_KERNELS}
    log(f"sequential: DistributedFrontend on make_world({N_ROBOTS}, "
        f"{steps}, {K_FEAT}, seed=1) in {seq_ms:.0f} ms "
        f"({stats['n_keyframes']} keyframes, "
        f"{stats['n_keyframes'] / seq_ms * 1e3:.1f} keyframes/s; "
        f"{n_att} attempts, {len(seq.loops)} loops); batched "
        f"{bat_ms:.0f} ms ({len(bat.lcd_attempts)} attempts); attempts "
        f"bit-equal {same_att}; launches {launches}, "
        f"per verified pair (recorded) {per_pair}; plain versions run: "
        f"{box['ran']}")
    same_loops = list(map(row, seq.loops)) == list(map(row, bat.loops))
    if not (len(bat.lcd_attempts) == n_att > 0 and same_att
            and same_loops):  # 1
        fail("sequential: the sequential front-end's attempts or loops "
             "differ from the batched front-end's (limit: bit for bit)")
    if box["ran"]:  # 2
        fail(f"sequential: plain versions ran {box['ran']}")
    want = {n: per_pair[n] * n_att for n in PATH_KERNELS}
    got = {n: launches.get(n, 0) for n in PATH_KERNELS}
    if got != want or not all(per_pair.values()):  # 3
        fail(f"sequential: launches {got}, expected {want} ({per_pair} a "
             f"pair x {n_att} pairs)")
    log("sequential: the first verified pair's kernel calls "
        f"({len(box['calls'])}), each against its plain version on the same "
        "tensors (limit: exact equality; K6 its NaN/finite pattern, the "
        "rest reported)")
    plain = path_wrappers()
    for name, a, k, res in box["calls"]:  # 4
        where = f"sequential pair, {'x'.join(map(str, a[0].shape))}"
        ref = plain_over_subbatches(plain[name][2], a, k)
        if name == "fivept_models":
            check_fivept(where, res, ref, k["gn_iters"], gated=False)
        else:
            check(name, res, ref, where)
    return {"seq_world": f"make_world({N_ROBOTS}, {steps}, {K_FEAT}, "
                         "seed=1)",
            "seq_fe_ms": seq_ms,
            "seq_fe_keyframes_per_s": stats["n_keyframes"] / seq_ms * 1e3,
            "seq_fe_ms_per_pair": seq_ms / n_att,
            "seq_batched_ms": bat_ms, "seq_attempts": n_att,
            "seq_loops": len(seq.loops), "seq_launches": launches,
            "seq_launches_per_pair": per_pair,
            "seq_vs_batched_bit_equal": same_att,
            "seq_vs_batched_rt_bit_equal": rt_eq}


# ------------------------------------------------------------- tools
TOOLS_TRIALS = ["--trials", "2", "--robots", "2", "--steps", "40",
                "--features", "64"]


def tools_phase(dev) -> dict:
    """The run tools on the card: `cli.trials.main` (2 trials of the `sim`
    run at 2 x 40 x 64, seeds 1000 and 1001), then one pass of
    `cli.monitor.monitor` (max_iters=1) over the last trial's log
    directory against ground-truth TUM files written from its world.
    Gates: each robot's median over 2 trials, finite; the monitor reads
    each robot's newest trajectory dump and appends one APE row, within
    REPLAY_APE_DIFF of the trial's own (the dump holds rounded poses).
    Returns the stage entries."""
    import io
    import os
    import shutil
    import tempfile

    from kimera_multi_tpu_torch.cli import monitor, trials
    from kimera_multi_tpu_torch.core import lie
    from kimera_multi_tpu_torch.io import logs, sim_world

    tmp = tempfile.mkdtemp(prefix="kmt_tools_")
    try:
        root = os.path.join(tmp, "trials")
        buf = io.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            stats = trials.main(TOOLS_TRIALS + ["--log-root", root])
        trials_ms = (time.perf_counter() - t) * 1e3
        med = {r: s["median"] for r, s in stats.items()}
        log(f"tools: trials.main({' '.join(TOOLS_TRIALS)}) in "
            f"{trials_ms:.0f} ms: {stats}")
        if sorted(stats) != [0, 1] or not all(
                s["n_trials"] == 2 and np.isfinite(s["median"])
                for s in stats.values()):
            fail(f"tools: trial medians {stats}")
        last = os.path.join(root, "trial_001")
        world = sim_world.make_world(n_robots=2, n_steps=40,
                                     features_per_kf=64, seed=1001)
        gt, before, newest = {}, {}, {}
        for r in range(2):
            gt[r] = os.path.join(tmp, f"gt{r}.tum")
            q = lie.rot_to_quat(torch.from_numpy(world.R_gt[r])).numpy()
            logs.write_tum(gt[r], world.timestamps[r], world.t_gt[r], q)
            before[r] = np.atleast_1d(logs.read_csv(os.path.join(
                last, f"ape_robot{r}.csv"))["rmse_trans"])
            newest[r] = monitor.newest_tum(os.path.join(last,
                                                        f"robot{r}"))[-1]
        read = []

        def reading(orig):
            def wrapped(est, ref, *a, **k):
                read.append(est)
                return orig(est, ref, *a, **k)
            return wrapped

        t = time.perf_counter()
        with patched(monitor.ape_mod, "ape_from_tum", reading):
            monitor.monitor(last, gt, interval=0.0, idle_exit=60.0,
                            max_iters=1)
        torch.cuda.synchronize()
        monitor_ms = (time.perf_counter() - t) * 1e3
        after = {r: np.atleast_1d(logs.read_csv(os.path.join(
            last, f"ape_robot{r}.csv"))["rmse_trans"]) for r in range(2)}
        diff = [abs(float(after[r][-1]) - float(before[r][-1]))
                for r in range(2)]
        log(f"tools: monitor over {last} in {monitor_ms:.0f} ms read {read} "
            f"(newest {list(newest.values())}); APE rows before / after "
            f"{[len(before[r]) for r in range(2)]} / "
            f"{[len(after[r]) for r in range(2)]}; |monitor - trial| {diff} "
            f"(limit {REPLAY_APE_DIFF})")
        if read != [newest[0], newest[1]] or not all(
                len(after[r]) == len(before[r]) + 1 and diff[r]
                < REPLAY_APE_DIFF for r in range(2)):
            fail("tools: the monitor did not read each robot's newest dump "
                 "and append its APE")
        return {"tools_trials_ms": trials_ms, "tools_trial_median_ape": med,
                "tools_monitor_ms": monitor_ms,
                "tools_monitor_ape_diff_max": max(diff)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------ sharded back-end
# phase (j): the sharded back-end (`--mode sim-sharded`) on phase (f)'s
# world at full width, 40 rounds (the CLI default), a dump every 10; run B
# stops after 20 rounds with a checkpoint and run C resumes it for 20 more
SHARDED_ARGS = ["--mode", "sim-sharded"] + SIM_ARGS[2:] + ["--dump-every",
                                                           "10"]
SHARDED_ROUNDS, SHARDED_DUMP = 40, 10
# the split hypothesis table: shards, hypotheses and candidates at the
# front-end's stereo shape (K = 704 points a candidate)
SPLIT_SHARDS, SPLIT_HYP, SPLIT_C = (1, 2, 4), 512, 64
# `--backend sharded` on vio-sim at gate 6's configuration (2 x 16); the
# cut from phase (g)'s 6 x 30 is one of time
VIO_SHARDED_ARGS = VIO_SMALL_ARGS + ["--backend", "sharded"]


def split_table_inputs(dev, C: int, K: int):
    """3d-3d correspondences of C candidates at K points: uniform points,
    a random rigid motion each, 1 cm noise, 30 % outliers, the last
    c % 64 points of candidate c invalid; a key per candidate."""
    from kimera_multi_tpu_torch.core import lie, rng

    g = np.random.default_rng(11)
    p = g.uniform(-4, 4, (C, 3, K)).astype(np.float32)
    w = g.normal(0, 0.4, (C, 3)).astype(np.float32)
    R = lie.so3_exp(torch.from_numpy(w)).numpy()
    t = g.normal(0, 1, (C, 3)).astype(np.float32)
    q = np.einsum("cij,cjk->cik", R, p) + t[:, :, None]
    q += g.normal(0, 0.01, q.shape).astype(np.float32)
    out = g.random((C, K)) < 0.3
    q += np.where(out[:, None, :], g.uniform(2, 8, q.shape), 0).astype(
        np.float32)
    valid = np.arange(K)[None, :] < K - (np.arange(C) % 64)[:, None]
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    keys = rng.derive(rng.base_key(7, device=dev), rng.Stream.RANSAC_STEREO,
                      torch.arange(C, device=dev))
    return keys, on(p), on(q.astype(np.float32)), on(valid)


def split_table_gate(dev, check) -> dict:
    """The split hypothesis table (dist/sharded_verify.py) at the
    front-end's stereo shape: for S = 1, 2 and 4 each rank's slice on the
    card in turn, merged; the result equals the unsplit `ransac_arun`
    (512 hypotheses) bit for bit; K8 at each slice's H = 512 / S equals
    its plain version on the slice's models, timed against it."""
    from kimera_multi_tpu_torch.dist import sharded_verify
    from kimera_multi_tpu_torch.kernels import ransac, score

    key, p, q, valid = split_table_inputs(dev, SPLIT_C, K_FEAT)
    ref = ransac.ransac_arun(key, p, q, valid, n_hyp=SPLIT_HYP)
    picks, order, inv_order = ransac._masked_sample_parts(key, valid,
                                                          SPLIT_HYP, 3)
    n_valid = int(valid.sum())
    shapes = []
    for S in SPLIT_SHARDS:
        cands = torch.stack([sharded_verify.arun_slice(
            key, p, q, valid, r, S, SPLIT_HYP) for r in range(S)])
        got = sharded_verify.merge_slices(cands, p, q, valid)
        for k in ("R", "t", "inliers", "n_inliers", "ok"):
            if not torch.equal(got[k], ref[k]):
                fail(f"split table, S = {S}: {k} differs from the unsplit "
                     "ransac_arun")
        H = SPLIT_HYP // S
        R_h, t_h, ok_h = ransac.solve_arun_hyps(
            p, q, picks[:, :H].contiguous(), order, inv_order)
        args = (R_h.contiguous(), t_h.contiguous(), p, q, valid)
        err = check("rigid_counts", score.rigid_counts(*args, 0.3),
                    score.rigid_counts_ref(*args, 0.3),
                    f"C={SPLIT_C} K={K_FEAT} H={H} (split table, S={S})")
        nbytes = (SPLIT_C * H * 12 * 4 + 2 * n_valid * 3 * 4
                  + SPLIT_C * K_FEAT + SPLIT_C * H * 4)
        ops = H * n_valid * OPS_RIGID
        shapes.append(dict(
            shards=S, H=H, max_abs_err=err,
            ms=device_ms(lambda: score.rigid_counts(*args, 0.3)),
            plain_ms=device_ms(lambda: score.rigid_counts_ref(*args, 0.3),
                               iters=3),
            bound_ms=max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3,
            bound_by="bytes" if nbytes / PEAK_BYTES > ops / PEAK_F32
            else "operations", library_ms=None))
        log(f"split table S = {S}: merged == unsplit ransac_arun bit for "
            f"bit; K8 at H = {H}: {shapes[-1]['ms']:.4f} ms, plain "
            f"{shapes[-1]['plain_ms']:.4f} ms, bound "
            f"{shapes[-1]['bound_ms']:.4f} ms")
    return {"split_table_shapes": shapes, "split_table_C": SPLIT_C,
            "split_table_hyp": SPLIT_HYP}


def sharded_round_gates(dev, out) -> dict:
    """The rounds of run A against the reference: `rbcd_round_reference`
    over the buckets with the GNC schedule (every 2nd round from round 8)
    from the same start, 40 rounds, bit for bit against the one-rank NCCL
    rounds; then 2 rounds of `make_round_fn` on the card against the
    CPU's (a one-rank gloo group), within `round_tolerance`."""
    import dataclasses

    from kimera_multi_tpu_torch.cli import run
    from kimera_multi_tpu_torch.core.containers import GncState
    from kimera_multi_tpu_torch.dist import mesh, rounds
    from kimera_multi_tpu_torch.solve import gnc, pgo, rbcd

    edges, T = out["backend"]["edges"], N_FRAMES
    p0 = pgo.init_from_odometry(edges, N_ROBOTS, T)
    Y0, w0, _, _ = rounds.lifted_start(p0, edges, N_ROBOTS, T, 0)
    st0 = rounds.init_state(Y0, torch.ones(N_ROBOTS, dtype=torch.bool,
                                           device=dev),
                            edges, T, init_weights=w0)
    buckets = rbcd.bucket_edges(edges, N_ROBOTS, T)
    sq = lambda Y: rbcd.lifted_edge_sq_errors(Y.reshape(-1, *Y.shape[2:]),
                                              edges, T)
    Y, g = Y0, st0.gnc_state
    for i in range(SHARDED_ROUNDS):
        Y = rbcd.rbcd_round_reference(Y, st0.active, edges, g.weights,
                                      rbcd.RbcdConfig(), T, buckets)
        if ((i + 1) % run.SHARDED_GNC_EVERY == 0
                and i + 1 >= run.SHARDED_BURNIN):
            g = gnc.gnc_update_weights(g, sq(Y), edges.etype, edges.valid)
    same = torch.equal(Y, out["backend"]["Y"])
    log(f"sim-sharded: {SHARDED_ROUNDS} one-rank NCCL rounds == "
        f"rbcd_round_reference with GNC, bit for bit: {same}")
    if not same:
        fail("sim-sharded: the one-rank NCCL rounds differ from "
             "rbcd_round_reference with GNC on the same schedule")

    def two_rounds(device, dtype):
        e = edges.to(device)
        e = dataclasses.replace(e, **{f: getattr(e, f).to(dtype)
                                      for f in ("R", "t", "kappa", "tau")})
        gs = st0.gnc_state
        st = rounds.RoundState(
            Y=Y0.to(device, dtype), active=st0.active.to(device),
            gnc_state=GncState(mu=gs.mu.to(device, dtype),
                               weights=gs.weights.to(device, dtype),
                               barc2=gs.barc2.to(device, dtype),
                               outer_iter=gs.outer_iter.to(device)),
            round_idx=0)
        with mesh.robot_group(N_ROBOTS, device) as group:
            fn = rounds.make_round_fn(group, e, T, rbcd.RbcdConfig(),
                                      run.SHARDED_GNC_EVERY,
                                      burnin_rounds=run.SHARDED_BURNIN)
            for _ in range(2):
                st, _ = fn(st)
        return st.Y

    tol = round_tolerance(two_rounds(dev, torch.float32).cpu(),
                          two_rounds("cpu", torch.float32),
                          two_rounds("cpu", torch.float64))
    log(f"sim-sharded: 2 rounds, card (NCCL) vs CPU (gloo): max |diff| "
        f"{tol['max']:.3e} (limit {tol['limit_max']:.3e}), mean "
        f"{tol['mean']:.3e} (limit {tol['limit_mean']:.3e})")
    if not tol.pop("ok"):
        fail("sim-sharded: the card's rounds differ from the CPU's")
    return {"sharded_rounds_equal_reference": True,
            "sharded_card_vs_cpu_2_rounds": tol}


def sharded_phase(dev, fe_launches: dict, check) -> dict:
    """(j) the sharded back-end at full width: `cli.run.main(--mode
    sim-sharded)` on phase (f)'s world, run A (40 rounds, `--profile`,
    `--chain-refine`), run B (20 rounds, `--checkpoint`), run C
    (`--resume` B, 20 more rounds). Gates: no plain version runs and A's
    kernel launches equal the front-end phase's; C's final blocks equal
    A's (before the chain refine) bit for bit; each robot's APE below its
    odometry's; the log trees (dumps 0 - 3 and the final trajectory 5);
    `profile_summary.json`'s schema; `sharded_round_gates`;
    `split_table_gate`; `--backend sharded` on vio-sim at 2 x 16 (gate
    1 of phase (g), the log tree). Returns the stage entries."""
    import os
    import shutil
    import tempfile

    from kimera_multi_tpu_torch.cli import run
    from kimera_multi_tpu_torch.io import sim_world
    from kimera_multi_tpu_torch.kernels import _build
    from kimera_multi_tpu_torch.solve import pgo

    tmp = tempfile.mkdtemp(prefix="kmt_sharded_")
    try:
        dirs = {k: os.path.join(tmp, k) for k in "ABC"}
        prof = os.path.join(tmp, "profile")
        ckpt = os.path.join(tmp, "rounds.npz")
        with plain_tripwire() as ran:
            _build.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            outA = run.main(SHARDED_ARGS + ["--log-dir", dirs["A"],
                                            "--profile", prof,
                                            "--chain-refine"])
            torch.cuda.synchronize()
            a_ms = (time.perf_counter() - t) * 1e3
            launches = dict(_build.launches)
        be = outA["backend"]
        log(f"sim-sharded A: main({' '.join(SHARDED_ARGS)} --profile "
            f"--chain-refine) in {a_ms:.0f} ms; stages (s) "
            f"{outA['stages']}; comm bytes a round {be['comm_bytes']} "
            f"({be['comm_source']}); kernel launches {launches}; plain "
            f"versions run: {ran}")
        if ran:
            fail(f"sim-sharded: main() ran plain versions {ran}")
        if launches != fe_launches:
            fail(f"sim-sharded: main() launched {launches}, the front-end "
                 f"phase {fe_launches}")
        t = time.perf_counter()
        outB = run.main(SHARDED_ARGS + ["--log-dir", dirs["B"],
                                        "--gnc-rounds", "20",
                                        "--checkpoint", ckpt])
        outC = run.main(SHARDED_ARGS + ["--log-dir", dirs["C"],
                                        "--gnc-rounds", "20",
                                        "--resume", ckpt])
        bc_ms = (time.perf_counter() - t) * 1e3
        same = (outC["backend"]["round_idx"] == SHARDED_ROUNDS
                and torch.equal(outC["backend"]["Y"], be["Y"])
                and torch.equal(outC["backend"]["weights"], be["weights"]))
        log(f"sim-sharded B (20 rounds, checkpoint) + C (resumed, 20 more) "
            f"in {bc_ms:.0f} ms: final blocks and weights == run A's, bit "
            f"for bit: {same}")
        if not same:
            fail("sim-sharded: the resumed run differs from the straight "
                 "run")
        final = SHARDED_ROUNDS // SHARDED_DUMP + 1
        check_log_tree(dirs["A"], N_ROBOTS, N_FRAMES, "sim-sharded", final)
        for r in range(N_ROBOTS):
            for k in range(SHARDED_ROUNDS // SHARDED_DUMP):
                if not os.path.isfile(os.path.join(
                        dirs["A"], f"robot{r}", "distributed",
                        f"kimera_distributed_poses_tum_{k}.tum")):
                    fail(f"sim-sharded: robot {r} has no dump {k}")
        world = sim_world.make_world(n_robots=N_ROBOTS, n_steps=N_FRAMES,
                                     features_per_kf=K_FEAT, seed=0)
        R_kf, t_kf = run._odometry_poses(world)
        ape_odo = [a.rmse_trans for a in sim_apes(pgo.PgoParams(
            R=torch.from_numpy(R_kf.reshape(-1, 3, 3)),
            t=torch.from_numpy(t_kf.reshape(-1, 3))), world, dev)]
        ape = [outA["ape"][r].rmse_trans for r in range(N_ROBOTS)]
        ape_c = [outC["ape"][r].rmse_trans for r in range(N_ROBOTS)]
        log(f"sim-sharded: APE translation RMSE (m) per robot, A (chain "
            f"refine) {ape}, C {ape_c}; odometry only {ape_odo}")
        if not all(a < o for a, o in zip(ape, ape_odo)):
            fail("sim-sharded: a robot's APE is not below its odometry's")
        with open(os.path.join(prof, "profile_summary.json")) as f:
            summ = json.load(f)
        planes = {pl["name"]: pl for pl in summ["planes"]}
        if (set(summ) != {"files", "planes"} or set(planes) != {"host",
                                                                 "device"}
                or any(set(pl) != {"name", "total_event_ms",
                                   "busy_ms_by_line", "top_ops"}
                       for pl in summ["planes"])
                or not planes["host"]["top_ops"]):
            fail(f"sim-sharded: profile_summary.json lacks the schema: "
                 f"{list(summ)} {list(planes)}")
        dev_plane = planes["device"]
        log(f"sim-sharded: profile of {SHARDED_ROUNDS} rounds: host "
            f"{planes['host']['total_event_ms']} ms of events, device "
            f"{dev_plane['total_event_ms']} ms of kernels, busy "
            f"{dev_plane['busy_ms_by_line']}; top device ops "
            f"{dev_plane['top_ops'][:3]}")
        res = {"sim_sharded_ms": a_ms, "sim_sharded_resume_ms": bc_ms,
               "sim_sharded_stages_s": outA["stages"],
               "sim_sharded_comm_bytes": be["comm_bytes"],
               "sim_sharded_comm_source": be["comm_source"],
               "sim_sharded_ape_rmse_trans": ape,
               "sim_sharded_resumed_ape_rmse_trans": ape_c,
               "sim_sharded_odometry_ape_rmse_trans": ape_odo,
               "sim_sharded_profile_device_ms": dev_plane["total_event_ms"],
               "sim_sharded_profile_device_busy_ms":
                   dev_plane["busy_ms_by_line"],
               "sharded_launches": launches}
        res.update(sharded_round_gates(dev, outA))
        res.update(split_table_gate(dev, check))
        # --backend sharded on vio-sim (gate 6's configuration)
        ld = os.path.join(tmp, "vio")
        t = time.perf_counter()
        o = run.main(VIO_SHARDED_ARGS + ["--log-dir", ld])
        v_ms = (time.perf_counter() - t) * 1e3
        vio_gate1(o, ld, 2, "vio-sim 2 x 16 --backend sharded")
        check_log_tree(ld, 2, o["n_keyframes"] // 2,
                       "vio-sim --backend sharded",
                       o["backend"]["round_idx"] // SHARDED_DUMP + 1)
        res.update(vio_sharded_ms=v_ms, vio_sharded_ape_rmse_trans=[
            o["ape"][r].rmse_trans for r in range(2)])
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- pods
# phase (k): two `cli.pod` processes on the one card, 3 robots each, at
# full width (704 features), stream exchange, 30 rounds; the depth cut to
# 64 keyframes a robot (time)
POD_ARGS = ["--pods", "2", "--robots", str(N_ROBOTS), "--steps", "64",
            "--features", str(K_FEAT), "--rounds", "30"]
POD_TIMEOUT_S = 600


def free_port_pair() -> int:
    """A port p with p and p + 1 free on localhost."""
    import socket

    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
        try:
            with socket.socket() as a, socket.socket() as b:
                a.bind(("127.0.0.1", p))
                b.bind(("127.0.0.1", p + 1))
            return p
        except OSError:
            continue
    fail("no free pair of ports on localhost")


def pods_phase(dev) -> dict:
    """(k) two `python -m kimera_multi_tpu_torch.cli.pod` processes on the
    card (POD_ARGS): each senses 3 robots, the BoW vectors, VLC frames,
    edges and direction blocks cross the native TCP fabric. Gates: both
    exit 0; the hash barrier (the same digest on both); every robot's APE
    below its odometry's; bytes a dpgo round logged (> 0); every kernel of
    the front-end launched in each pod. Then `dryrun_multichip(1)` on the
    card. Returns the stage entries."""
    import os
    import shutil
    import tempfile

    from kimera_multi_tpu_torch.entry import dryrun_multichip

    tmp = tempfile.mkdtemp(prefix="kmt_pods_")
    procs = []
    try:
        base = free_port_pair()
        t = time.perf_counter()
        for rank in range(2):
            out_f = open(os.path.join(tmp, f"pod{rank}.out"), "w+")
            err_f = open(os.path.join(tmp, f"pod{rank}.err"), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "kimera_multi_tpu_torch.cli.pod",
                 "--rank", str(rank), *POD_ARGS, "--port-base", str(base),
                 "--log-dir", os.path.join(tmp, "logs")],
                stdout=out_f, stderr=err_f), out_f, err_f))
        outs = []
        for p, out_f, err_f in procs:
            try:
                rc = p.wait(timeout=POD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"pods: a pod ran past {POD_TIMEOUT_S} s")
            out_f.seek(0)
            err_f.seek(0)
            err = err_f.read()
            if rc != 0:
                fail(f"pods: a pod exited {rc}:\n{err[-3000:]}")
            outs.append(json.loads(out_f.read().strip().splitlines()[-1]))
            log("\n".join(ln for ln in err.splitlines()
                          if ln.startswith("[pod")))
        pods_ms = (time.perf_counter() - t) * 1e3
        for o in outs:
            log(f"pod {o['pod']}: robots {o['robots']}, agree {o['agree']}, "
                f"digest {o['digest']:#010x}, APE {o['ape_rmse']} (odometry "
                f"{o['ape_odometry']}), {o['n_loops']} loops, "
                f"{o['dpgo_bytes_per_round']:.0f} B received a dpgo round, "
                f"rounds {o['rounds_s']:.2f} s, wall {o['wall_s']:.1f} s, "
                f"kernel launches {o['kernel_launches']}")
        if not (outs[0]["agree"] and outs[1]["agree"]
                and outs[0]["digest"] == outs[1]["digest"]):
            fail("pods: the hash barrier failed")
        for o in outs:
            for r, a in o["ape_rmse"].items():
                if not a < o["ape_odometry"][r]:
                    fail(f"pods: robot {r}'s APE {a} is not below its "
                         f"odometry's {o['ape_odometry'][r]}")
            if not o["dpgo_bytes_per_round"] > 0:
                fail("pods: no bytes received in a dpgo round")
            idle = [k for k in PATH_KERNELS if k != "hamming_top2"
                    and o["kernel_launches"].get(k, 0) == 0]
            if idle:
                fail(f"pods: pod {o['pod']} never launched {idle}")
        launches = {k: sum(o["kernel_launches"].get(k, 0) for o in outs)
                    for k in outs[0]["kernel_launches"]}
        t = time.perf_counter()
        dry = dryrun_multichip(1)
        dry_ms = (time.perf_counter() - t) * 1e3
        if not (dry["ok"] and np.isfinite(dry["round_cost"])
                and np.isfinite(dry["chain_t_max"])):
            fail(f"dryrun_multichip(1): {dry}")
        return {"pods_ms": pods_ms, "pods_args": " ".join(POD_ARGS),
                "pods_digest": outs[0]["digest"],
                "pods_ape_rmse_trans": {r: a for o in outs
                                        for r, a in o["ape_rmse"].items()},
                "pods_odometry_ape_rmse_trans": {
                    r: a for o in outs
                    for r, a in o["ape_odometry"].items()},
                "pods_dpgo_bytes_per_round": [o["dpgo_bytes_per_round"]
                                              for o in outs],
                "pods_bow_round_bytes": [o["bow_round_bytes"] for o in outs],
                "pods_rounds_s": [o["rounds_s"] for o in outs],
                "pods_wall_s": [o["wall_s"] for o in outs],
                "pods_launches": launches, "dryrun_multichip_1": dry,
                "dryrun_multichip_1_ms": dry_ms}
    finally:
        for p, out_f, err_f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out_f.close()
            err_f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def check(name, got, ref, what):
    """Fails unless a kernel's result equals its plain version's exactly;
    logs and returns the largest difference."""
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

    # each phase's wall time from here on (s); the build, the kernels'
    # checks and the verification phase before it as one entry
    phase_s = {"build_kernels_verification": time.time() - t_start}

    def run_phase(name, fn):
        t = time.time()
        r = fn()
        phase_s[name] = time.time() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return r

    log(f"phase build_kernels_verification: "
        f"{phase_s['build_kernels_verification']:.1f} s")
    # ------------------------------------------------------------------ 6
    kernels.insert(1, run_phase("db_top2", lambda: db_top2_phase(
        desc_store, check)))
    kernels[1]["launches_per_chunk"] = launches5["hamming_top2"] // n_chunks
    # ------------------------------------------------------------------ 7
    stages.update(run_phase("frontend", lambda: frontend_phase(dev,
                                                               profile)))
    # ------------------------------------------------------------------ 8
    stages.update(run_phase("backend", lambda: backend_phase(dev, profile)))
    stages.update(run_phase("entry", lambda: entry_phase(dev, profile,
                                                         check)))
    # ------------------------------------------------------------------ 9
    stages.update(run_phase("sim", lambda: sim_phase(
        dev, profile, stages["fe_launches"])))
    # ----------------------------------------------------------------- 10
    stages.update(run_phase("vio_sim", lambda: vio_phase(dev, profile,
                                                         check)))
    # ----------------------------------------------------------------- 11
    stages.update(run_phase("euroc", lambda: euroc_phase(dev, check)))
    # ----------------------------------------------------------------- 12
    stages.update(run_phase("sequential", lambda: sequential_phase(
        dev, check)))
    stages.update(run_phase("tools", lambda: tools_phase(dev)))
    # ----------------------------------------------------------------- 13
    stages.update(run_phase("sharded", lambda: sharded_phase(
        dev, stages["fe_launches"], check)))
    # ----------------------------------------------------------------- 14
    stages.update(run_phase("pods", lambda: pods_phase(dev)))
    stages["phase_s"] = phase_s
    for k in kernels:
        k["launches_vio_sim"] = stages["vio_launches"].get(k["name"], 0)
        k["launches_euroc"] = stages["euroc_launches"].get(k["name"], 0)
        k["launches_replay"] = stages["replay_launches"].get(k["name"], 0)
        k["launches_sequential"] = stages["seq_launches"].get(k["name"], 0)
        k["launches_sharded"] = stages["sharded_launches"].get(k["name"], 0)
        k["launches_pods"] = stages["pods_launches"].get(k["name"], 0)
        if k["name"] == "rigid_counts":
            k["split_table_shapes"] = stages["split_table_shapes"]
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
