"""One run of one cell:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the world and the backlog from the seed on the host, uploads
the keyframe stores, builds the verifier and warms it up on one chunk.
The window then verifies the backlog pass after pass, one chunk at a time,
each chunk's answers read back to the host before the next is sent (a
closed loop, as the front-end's `verify_candidates` runs), for `--seconds`
seconds. With `--trace 1` a second stretch of one pass runs under the
profiler. After the window the program is freed and a sample of its
answers is compared with the plain reference. The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
end standard error.

Exits 2 without a result where there is no card or fewer cards than the
cell asks for, and 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import backlog as backlog_mod  # noqa: E402
from . import compare, reference, roofline, spec, threefry  # noqa: E402
from . import trace as trace_mod  # noqa: E402
from .world import make_world  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kimera_multi_tpu")
_RESULTS = ("mono_ok", "stereo_ok", "mono_inliers", "stereo_inliers", "R",
            "t")


def forbidden_modules() -> list:
    """Top-level names in sys.modules that belong to JAX or the JAX
    package, compared whole (the port's name starts with the package's)."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def world_of(cfg: dict, seed: int):
    return make_world(cfg["robots"], cfg["keyframes_per_robot"],
                      cfg["feature_slots"], cfg["features"], cfg["places"],
                      seed, **cfg["world"])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _table_counts(m: torch.Tensor) -> tuple[int, int, int]:
    """(matched points, matched among each candidate's first PRESEL_PTS,
    distinct (candidate, target column) pairs the indices reach)."""
    matched = m >= 0
    n = matched.sum(1)
    idx = torch.clamp(m, min=0)
    z = torch.zeros_like(matched)
    z.scatter_(1, idx.long(), True)
    return (int(n.sum()),
            int(torch.clamp(n, max=roofline.PRESEL_PTS).sum()),
            int(z.sum()))


def run_cell(c: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None, hook=None) -> dict:
    """Set-up, window, optional traced pass, comparison. `hook`, where
    given, wraps each chunk's launch (the fault tests break the timed
    path with it). Returns the result object and the comparison rows."""
    from .program import Program

    t0 = T0 if t0 is None else t0
    cfg = c["config"]
    dev = torch.device(device)
    world = world_of(cfg, seed)
    bl = backlog_mod.make_backlog(world, c["traffic"], seed)
    key = threefry.base_key(seed)
    chunks = [bl.chunk_arrays(i) for i in range(bl.n_chunks)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    with Program(cfg, world, key, dev) as prog:
        call = prog.call if hook is None else hook(prog.call)
        # warm-up: the one chunk shape of this cell, twice (allocator)
        for _ in range(2):
            out, _m = call(chunks[0][0])
            Program.read_back(out, chunks[0][1])
        _sync(dev)
        setup_s = time.perf_counter() - t0

        results = []          # (chunk index, host answers)
        tables = {}           # chunk index -> latest match table
        chunk_ms, enqueue_ms = [], []
        done = 0
        i = 0
        t_start = time.perf_counter()
        while True:
            arrays, n = chunks[i]
            a = time.perf_counter()
            out, m = call(arrays)
            b = time.perf_counter()
            res = Program.read_back(out, n)
            e = time.perf_counter()
            chunk_ms.append((e - a) * 1e3)
            enqueue_ms.append((b - a) * 1e3)
            results.append((i, res))
            tables[i] = m
            done += n
            i = (i + 1) % bl.n_chunks
            if e - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start

        traced = None
        if trace:
            # one whole pass under the profiler, from chunk 0
            traced_tables = []
            before = prog.launches()
            prof = trace_mod.profiler()
            with prof:
                for j in range(bl.n_chunks):
                    arrays, n = chunks[j]
                    out, m = call(arrays)
                    results.append((j, Program.read_back(out, n)))
                    tables[j] = m
                    traced_tables.append(m)
            after = prog.launches()
            launched = {k: after[k] - before.get(k, 0) for k in after
                        if after[k] - before.get(k, 0)}
            tr = trace_mod.read(prof)
            bounds: dict = {}
            C, K = bl.chunk, cfg["feature_slots"]
            for m in traced_tables:
                nv, nvp, ncols = _table_counts(m)
                for k, v in roofline.chunk_bounds(
                        cfg["mono_solver"], C, K, cfg["ransac_hypotheses"],
                        nv, nvp, ncols).items():
                    bounds[k] = bounds.get(k, 0.0) + v
            expect = {k: v * bl.n_chunks for k, v in
                      roofline.chunk_launches(cfg["mono_solver"]).items()}
            traced = {"trace": tr, "chunks": bl.n_chunks,
                      "bounds_ms": bounds, "launches": launched,
                      "launches_expected": expect}
            del traced_tables

        memory_peak = (int(torch.cuda.max_memory_allocated(dev))
                       if dev.type == "cuda" else 0)

        # what is compared: sampled candidates, every pass's answer, and
        # the match table rows of the window's last pass
        pick = compare.sample(bl.n, c["limits"]["sample"], seed)
        by_chunk = {}
        for ci in np.unique(pick // bl.chunk):
            by_chunk[int(ci)] = pick[pick // bl.chunk == ci] - ci * bl.chunk
        per_pass: dict = {}
        for ci, res in results:
            if ci in by_chunk:
                per_pass.setdefault(ci, []).append(res)
        if len(per_pass) < len(by_chunk):
            raise RuntimeError("the window did not reach every sampled "
                               "chunk once: lengthen --seconds")
        n_pass = min(len(v) for v in per_pass.values())
        prog_ans = {}
        for k in _RESULTS:
            rows = []
            for p in range(n_pass):
                rows.append(np.concatenate(
                    [per_pass[ci][p][k][by_chunk[ci]] for ci in by_chunk]))
            prog_ans[k] = np.stack(rows)
        prog_ans["match"] = np.concatenate(
            [tables[ci][torch.as_tensor(by_chunk[ci], device=dev)].cpu()
             .numpy() for ci in by_chunk])
        order = np.concatenate([by_chunk[ci] + ci * bl.chunk
                                for ci in by_chunk])
        del tables, results, out, m
        prog.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference.verify(world, cfg, key, bl.qr[order], bl.qf[order],
                           bl.tr[order], bl.tm[order], device=dev)
    ref_s = time.perf_counter() - t_ref
    nums = compare.numbers(prog_ans, ref, cfg)
    correct, rows = compare.judge(nums, c["limits"]["limits"])
    failed = int(np.sum((prog_ans["mono_ok"] != ref["mono_ok"][None])
                        .any(0) | (prog_ans["stereo_ok"]
                                   != ref["stereo_ok"][None]).any(0)))

    rec = {"chunk_ms": chunk_ms, "enqueue_ms": enqueue_ms,
           "traced": traced}
    e2e = {"lc_verifications_per_s": done / window_s, "setup_s": setup_s}
    metrics = {}
    if trace:
        for mdef in c["per_layer"]:
            v = spec.load_reader(mdef["name"])(rec)
            if v is not None:
                metrics[mdef["name"]] = {"value": v, "unit": mdef["unit"]}
    else:
        for mdef in c["end_to_end"]:
            metrics[mdef["name"]] = {"value": e2e[mdef["name"]],
                                     "unit": mdef["unit"]}
    result = {"correct": bool(correct), "attempted": int(done),
              "failed": failed, "metrics": metrics}
    info = {"window_s": window_s, "chunks": len(chunk_ms),
            "passes_compared": n_pass, "candidates_compared": len(order),
            "reference_s": ref_s, "setup_s": setup_s,
            "chunk_ms_median": statistics.median(chunk_ms),
            "reported": {k: nums[k] for k in compare.REPORTED}}
    return {"result": result, "rows": rows, "memory_peak": memory_peak,
            "traced": traced, "info": info, "numbers": nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False: this "
              "benchmark runs on the card only", file=sys.stderr)
        return 2
    c = spec.cell(args.workload)
    chips = int(c["workload"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = run_cell(c, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the benchmark may run "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3

    res = out["result"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak"]}
    if args.trace:
        tr = out["traced"]["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        res["breakdown"] = trace_mod.breakdown(tr)
        launched, expect = (out["traced"]["launches"],
                            out["traced"]["launches_expected"])
        if launched != expect:
            print(f"portbench: hand-written launches {launched} differ from "
                  f"the path's {expect}: the roofline readers report "
                  "nothing", file=sys.stderr)
    res["device"] = device
    print("portbench: " + json.dumps(out["info"]), file=sys.stderr)
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, v, lim in out["rows"]}
    for k, v, lim in out["rows"]:
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
