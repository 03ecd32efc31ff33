"""The port's submap coarsening (`frontend/submap.py`) and pose-graph
assembly (`frontend/dlc.build_pose_graph_from_loops`) against the JAX
package's on the CPU, on the odometry of `make_world(2, 64, 16, seed=7)`
(tests/test_submap_e2e.py's world, at fewer features) composed on the
host, with loop closures made from its ground truth.

Tolerances: submap indices, anchors, counts and the coarsened graph's
indices and types equal (the greedy gate runs in numpy float32 in the
port and in a `lax.scan` in JAX, on the same float32 poses); composed
odometry within 1e-5 (63 float32 compositions, translations up to 10 m);
relative poses, coarsened measurements and expanded poses within 2e-5
(two or three float32 compositions of such poses); the pose graph equal
(both assemble the same numpy arrays)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.cli import run as jrun
from kimera_multi_tpu.core import lie as jlie
from kimera_multi_tpu.frontend import dlc as jdlc, submap as jsubmap
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.cli import run
from kimera_multi_tpu_torch.frontend import dlc, submap
from kimera_multi_tpu_torch.io import sim_world

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

FIELDS = ("src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
          "kappa", "tau", "etype")
T = 64


def _loops(world, record):
    """Ground-truth loop closures: within robot 0 (one inside the first
    submap, one across), within robot 1, and between the robots."""
    out = []
    for ra, fa, rb, fb in ((0, 2, 0, 5), (0, 3, 0, 40), (1, 10, 1, 50),
                           (0, 20, 1, 21), (1, 60, 0, 7), (0, 63, 1, 0)):
        Ra, ta = world.R_gt[ra, fa], world.t_gt[ra, fa]
        Rb, tb = world.R_gt[rb, fb], world.t_gt[rb, fb]
        out.append(record(robot_a=ra, frame_a=fa, robot_b=rb, frame_b=fb,
                          R=(Ra.T @ Rb).astype(np.float32),
                          t=(Ra.T @ (tb - ta)).astype(np.float32),
                          mono_inliers=30, stereo_inliers=20, bow_score=0.5,
                          status=0, accepted=True))
    return out


@pytest.fixture(scope="module")
def world():
    w = sim_world.make_world(n_robots=2, n_steps=T, features_per_kf=16,
                             seed=7)
    R_kf, t_kf = run._odometry_poses(w)
    Rj, tj = jrun._odometry_poses(w)
    np.testing.assert_allclose(R_kf, Rj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_kf, tj, rtol=0, atol=1e-5)
    return w, R_kf, t_kf


def test_build_pose_graph_from_loops_matches_jax(world):
    w = world[0]
    cfg = dlc.FrontendConfig()
    e = dlc.build_pose_graph_from_loops(_loops(w, dlc.VerifiedLC), w.R_odo,
                                        w.t_odo, cfg, device="cpu")
    ej = jdlc.build_pose_graph_from_loops(_loops(w, jdlc.VerifiedLC),
                                          w.R_odo, w.t_odo, jdlc.FrontendConfig())
    assert e.capacity == ej.capacity == 256
    for f in FIELDS:
        got = getattr(e, f)
        assert got.dtype == (torch.int32 if f in ("src_robot", "src_pose",
                                                  "dst_robot", "dst_pose",
                                                  "etype")
                             else torch.float32), f
        assert np.array_equal(got.numpy(), np.asarray(getattr(ej, f))), f
    e2 = dlc.build_pose_graph_from_loops([], w.R_odo, w.t_odo, cfg,
                                         edge_capacity=200, device="cpu")
    ej2 = jdlc.build_pose_graph_from_loops([], w.R_odo, w.t_odo,
                                           jdlc.FrontendConfig(), 200)
    for f in FIELDS:
        assert np.array_equal(getattr(e2, f).numpy(),
                              np.asarray(getattr(ej2, f))), f


@pytest.mark.parametrize("size,dist", [(8, 5.0), (20, 1.0)])
def test_submaps_match_jax(world, size, dist):
    w, R_kf, t_kf = world
    valid = np.ones((2, T), bool)
    valid[1, [0, 17, 18, 33]] = False  # keyframes that open no submap
    assigns, jassigns = [], []
    for r in range(2):
        a = submap.assign_submaps(torch.from_numpy(R_kf[r]),
                                  torch.from_numpy(t_kf[r]),
                                  torch.from_numpy(valid[r]),
                                  max_submap_size=size,
                                  max_submap_distance=dist)
        aj = jsubmap.assign_submaps(jnp.asarray(R_kf[r]),
                                    jnp.asarray(t_kf[r]),
                                    jnp.asarray(valid[r]),
                                    max_submap_size=size,
                                    max_submap_distance=dist)
        for f in ("submap_of_kf", "anchor_kf"):
            assert np.array_equal(getattr(a, f).numpy(),
                                  np.asarray(getattr(aj, f))), f
        assert a.n_submaps == int(aj.n_submaps) > 1
        for f in ("R_in_submap", "t_in_submap"):
            np.testing.assert_allclose(getattr(a, f).numpy(),
                                       np.asarray(getattr(aj, f)), rtol=0,
                                       atol=2e-5)
        # the numpy form carries the JAX assignment across unchanged
        c = convert.submap_assignment_from_numpy(
            *(np.asarray(x) for x in aj), device="cpu")
        assert c.n_submaps == a.n_submaps
        assert torch.equal(c.submap_of_kf, a.submap_of_kf)
        assigns.append(a)
        jassigns.append(aj)

    e = dlc.build_pose_graph_from_loops(_loops(w, dlc.VerifiedLC), w.R_odo,
                                        w.t_odo, dlc.FrontendConfig(),
                                        device="cpu")
    ej = jdlc.build_pose_graph_from_loops(_loops(w, jdlc.VerifiedLC),
                                          w.R_odo, w.t_odo,
                                          jdlc.FrontendConfig())
    ce = submap.coarsen_edges(e, assigns, T)
    cj = jsubmap.coarsen_edges(ej, jassigns, T)
    for f in FIELDS:
        got, want = getattr(ce, f).numpy(), np.asarray(getattr(cj, f))
        if f in ("R", "t"):
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert (ce.etype.numpy() == 0).sum() > (e.etype.numpy() == 0).sum()

    S = max(a.n_submaps for a in assigns)
    rs = np.random.default_rng(0)
    R_sm = np.array(jlie.so3_exp(jnp.asarray(rs.normal(size=(2 * S, 3)),
                                             jnp.float32)))
    t_sm = rs.normal(size=(2 * S, 3)).astype(np.float32)
    for r in range(2):
        Rx, tx = submap.expand_solution(torch.from_numpy(R_sm),
                                        torch.from_numpy(t_sm), assigns[r],
                                        r * S)
        Rxj, txj = jsubmap.expand_solution(jnp.asarray(R_sm),
                                           jnp.asarray(t_sm), jassigns[r],
                                           jnp.asarray(r * S, jnp.int32))
        np.testing.assert_allclose(Rx.numpy(), np.asarray(Rxj), rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(tx.numpy(), np.asarray(txj), rtol=0,
                                   atol=2e-5)
