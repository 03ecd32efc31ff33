"""CPU tests of the benchmark at tiny sizes (the card-only case is marked
`cuda` and skips without a card):

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import (backlog, compare, control, reference, roofline, run,
                       spec, threefry, trace, world)

torch.set_num_threads(1)

ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def tiny(cell: str) -> dict:
    """The cell at a size a CPU test holds: 2 robots x 40 keyframes of 60
    features in 64 slots, 100 hypotheses, 60 candidates in chunks of 32."""
    c = copy.deepcopy(spec.cell(cell))
    c["config"].update(robots=2, keyframes_per_robot=40, feature_slots=64,
                       features=60, places=8, ransac_hypotheses=100)
    c["traffic"].update(candidates=60, same_place=38, same_robot_gap=10,
                        chunk=32)
    c["limits"]["sample"] = 24
    return c


SEED = 2 ** 31 + 77


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    b = spec.benchmark()
    c = spec.cell(cell)
    conf = next(x for x in b["configs"] if x["name"] == c["workload"]["config"])
    assert c["config"]["name"] == conf["name"]
    assert set(conf["reduced"]) == set(c["config"]["reduced"])
    assert set(c["limits"]["limits"]) == set(compare.NAMES)
    for m in c["per_layer"]:
        assert callable(spec.load_reader(m["name"]))
    assert {m["name"] for m in c["end_to_end"]} == {
        "lc_verifications_per_s", "setup_s"}


def test_world_is_the_ports_world():
    from kimera_multi_tpu_torch.io.sim_world import make_world

    pw = make_world(2, 30, 64, 8, seed=3)
    w = world.make_world(2, 30, 64, 64, 8, seed=3)
    assert np.array_equal(pw.descriptors, w.descriptors)
    assert np.array_equal(pw.obs_valid, w.obs_valid)
    assert np.array_equal(pw.place_of_kf, w.place_of_kf)
    assert np.allclose(pw.landmarks_local, w.landmarks, atol=1e-6)


def test_backlog_mix_is_fixed_and_seeded():
    c = tiny(CELLS[0])
    w = run.world_of(c["config"], 5)
    a = backlog.make_backlog(w, c["traffic"], 5)
    b = backlog.make_backlog(w, c["traffic"], 5)
    assert np.array_equal(a.qr, b.qr) and np.array_equal(a.tm, b.tm)
    assert a.n == 60 and a.same_place.sum() == 38
    p = w.place_of_kf
    assert np.array_equal(p[a.qr, a.qf] == p[a.tr, a.tm], a.same_place)
    assert np.all(a.tm < a.qf)
    same = a.qr == a.tr
    assert np.all(a.qf[same] - a.tm[same] >= 10)
    arrays, n = a.chunk_arrays(1)
    assert n == 28 and all(x.shape == (32,) for x in arrays)


def test_threefry_matches_the_ports():
    from kimera_multi_tpu_torch.core import rng

    key = threefry.base_key(2 ** 33 + 5)
    tk = rng.base_key(2 ** 33 + 5)
    ids = np.array([3, 7, 2 ** 31 + 1])
    mine = threefry.uniform(threefry.derive(np.broadcast_to(key, (3, 2)),
                                            ids, 1), (4, 5))
    theirs = rng.uniform(rng.derive(tk.expand(3, 2), torch.tensor(ids), 1),
                         (4, 5)).numpy()
    assert np.array_equal(mine, theirs)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell):
    out = run.run_cell(tiny(cell), SEED, 0.5, trace=False, device="cpu")
    assert out["result"]["correct"], out["rows"]
    assert out["result"]["attempted"] >= 60
    assert out["info"]["passes_compared"] >= 1
    assert out["numbers"]["match_entries_differing"] == 0


def _faulty(kind):
    def hook(call):
        state = {}

        def broken(arrays):
            out, m = call(arrays)
            out = {k: v.clone() for k, v in out.items()}
            C = out["mono_ok"].shape[0]
            if kind == "half_left_out":
                for k, v in out.items():
                    v[C // 2:] = 0
            elif kind == "answer_altered":
                out["t"][:, 0] += 0.01
            elif kind == "stale":
                prev = state.get("prev")
                state["prev"] = out
                out = prev if prev is not None else out
            return out, m
        return broken
    return hook


@pytest.mark.parametrize("kind", ["half_left_out", "answer_altered",
                                  "stale"])
def test_broken_path_is_not_correct(kind):
    out = run.run_cell(tiny(CELLS[0]), SEED, 0.5, trace=False,
                       device="cpu", hook=_faulty(kind))
    assert not out["result"]["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = control.readings(tiny(cell), SEED, "cpu")
    assert not r["correct"], r


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(spec.PKG, "reference.py")
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    assert not {n for n in names if n.split(".")[0].startswith("kimera")}
    code = ("import sys; import portbench.reference, portbench.compare, "
            "portbench.control; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    mods = json.loads(subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, check=True,
        capture_output=True, text=True).stdout.replace("'", '"'))
    assert "kimera_multi_tpu_torch" not in mods
    assert not set(mods) & set(run.FORBIDDEN)


def test_no_jax_after_a_run():
    code = ("import json, sys, copy; sys.argv=['x'];"
            "from portbench.tests.test_portbench import tiny, CELLS, SEED;"
            "from portbench import run;"
            "out = run.run_cell(tiny(CELLS[0]), SEED, 0.5, False, 'cpu');"
            "print(json.dumps(run.forbidden_modules()))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, check=True)
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_roofline_gives_pr7_bounds():
    # kernel table of PR 7 (C = 1,024, K = 704, H = 500; 430,264 valid
    # points, 65,536 preselect points): K6 1.0297 ms, K8 0.0835 ms fused
    # (0.1670 one instruction an operation), K1 0.1313, K7 0.1565, K9 at
    # H = 128 0.0329
    assert roofline.fivept_models(1024, 500, 8, 8) == pytest.approx(
        1.0297, abs=5e-5)
    k8 = roofline.rigid_counts(1024, 704, 500, 430264)
    assert k8 == pytest.approx(0.0835, abs=5e-5)
    assert 2 * k8 == pytest.approx(0.1670, abs=5e-5)
    assert roofline.pair_top2(1024, 704, 704) == pytest.approx(0.13130,
                                                               abs=5e-5)
    assert roofline.presel_counts(1024, 500, 8, 64, 65536) == pytest.approx(
        0.15650, abs=5e-5)
    assert roofline.essential_counts(1024, 704, 128, 430264) == \
        pytest.approx(0.03288, abs=5e-5)


class _FakeProf:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def test_trace_reduction():
    k = "(anonymous namespace)::fivept_kernel(float const*)"
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 0.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": k, "ts": 10.0, "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "at::native::add_kernel",
         "ts": 30.0, "dur": 30.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 62.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 80.0, "dur": 20.0},
    ]
    tr = trace.read(_FakeProf(ev))
    assert tr["busy_s"] == pytest.approx(70e-6)
    assert tr["window_s"] == pytest.approx(100e-6)
    assert trace.hand_written(k) and not trace.hand_written(
        "at::native::add_kernel")
    bd = trace.breakdown(tr)
    assert bd["idle_gaps"][0][0] == "host in cudaMemcpyAsync"
    assert bd["idle_gaps"][0][1] == pytest.approx(20e-6)
    rec = {"traced": {"trace": tr, "chunks": 1,
                      "bounds_ms": {"fivept_models": 0.02},
                      "launches": {}, "launches_expected": {}},
           "chunk_ms": [], "enqueue_ms": []}
    assert spec.load_reader("fivept_models_roofline")(rec) == \
        pytest.approx(50.0)
    assert spec.load_reader("device.idle_share")(rec) == pytest.approx(30.0)
    assert spec.load_reader("torch_ops.kernels_per_chunk")(rec) == 1


def test_reference_five_point_finds_the_true_model():
    rs = np.random.default_rng(0)
    R = world.so3_exp(rs.normal(0, 0.3, 3))
    t = rs.normal(0, 1, 3)
    X = rs.uniform(-2, 2, (5, 3)) + [0, 0, 6]
    f1 = X / np.linalg.norm(X, axis=1, keepdims=True)
    X2 = X @ R.T + t
    f2 = X2 / np.linalg.norm(X2, axis=1, keepdims=True)
    pr = reference.Precision("float64")
    E, ok = reference.five_point(torch.tensor(f1)[None],
                                 torch.tensor(f2)[None], pr)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_true = torch.tensor(tx @ R, dtype=torch.float64)
    E_true = reference.project_essential(E_true / E_true.norm(), pr)[0]
    d = torch.minimum((E[0][ok[0]] - E_true).flatten(1).norm(dim=1),
                      (E[0][ok[0]] + E_true).flatten(1).norm(dim=1))
    assert ok[0].any() and float(d.min()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run.run_cell(spec.cell(cell), 11, 3.0, trace=True,
                       device="cuda")
    assert out["result"]["correct"], out["rows"]
