"""The port's PCM (`solve/pcm.py`) against the JAX package's on the CPU,
on tests/test_chordal_pcm.py's graph (`multi_robot_graph(seed=11,
n_robots=3, n_poses=32, outlier_ratio=0.4, n_intra_lc=4, n_inter_lc=8)`)
carried across as numpy, and on two edits of it: robots 0 and 2 sharing
no loop closure (robot 2 is placed through robot 1), and besides robots
1 and 2 sharing two edges that disagree (a best clique of one member),
which leaves robot 2 unplaced.

Tolerances: the consensus mask and frame_ok equal (the port builds each
pair's matrix over the pair's edges only, in index order; its threshold
tests take cos(dR) > cos(thr) where JAX takes acos, which differ only
within an ulp of the threshold); the relative-frame proposals within
1e-5 and the placed poses within 1e-5 absolute (float32 products of
poses up to 10 m; the consensus mean is summed in other orders). The
fixed-order 3 x 3 products of `lie.mat3_mul` are the bits of torch's CPU
matmul."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import containers as jc
from kimera_multi_tpu.eval.ape import align_left as jalign_left
from kimera_multi_tpu.io.synthetic import multi_robot_graph as jgraph
from kimera_multi_tpu.solve import pcm as jpcm, pgo as jpgo
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.core import lie
from kimera_multi_tpu_torch.core.containers import EDGE_INVALID, EDGE_SHARED_LC
from kimera_multi_tpu_torch.solve import pcm, pgo

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

FIELDS = ("src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
          "kappa", "tau", "etype")
N_ROBOTS, PPR = 3, 32


def _edited(ej, case):
    """tests/test_chordal_pcm.py's graph, or an edit of it (numpy)."""
    ej = {f: a.copy() for f, a in ej.items()}
    if case == "full":
        return ej
    sr, dr = ej["src_robot"], ej["dst_robot"]
    shared = ej["etype"] == EDGE_SHARED_LC
    # no loop closure between robots 0 and 2
    p02 = shared & (((sr == 0) & (dr == 2)) | ((sr == 2) & (dr == 0)))
    ej["etype"][p02] = EDGE_INVALID
    if case == "clique_of_one":
        # robots 1 and 2 keep two edges, the second moved 5 m: they
        # propose frames that disagree
        p12 = np.nonzero(shared & (((sr == 1) & (dr == 2))
                                   | ((sr == 2) & (dr == 1))))[0]
        ej["etype"][p12[2:]] = EDGE_INVALID
        ej["t"][p12[1]] += np.float32(5.0)
    return ej


@pytest.fixture(scope="module")
def graph():
    gj = jgraph(seed=11, n_robots=N_ROBOTS, n_poses=PPR, outlier_ratio=0.4,
                n_intra_lc=4, n_inter_lc=8)
    return gj, {f: np.asarray(getattr(gj.edges, f)) for f in FIELDS}


def test_mat3_products_are_cpu_matmul_bits():
    rs = np.random.default_rng(0)
    A = torch.from_numpy(rs.normal(size=(500, 3, 3)).astype(np.float32))
    B = torch.from_numpy(rs.normal(size=(500, 3, 3)).astype(np.float32))
    v = torch.from_numpy(rs.normal(size=(500, 3)).astype(np.float32))
    assert torch.equal(lie.mat3_mul(A, B), A @ B)
    assert torch.equal(lie.mat3_vec(A, v), torch.einsum("...ij,...j->...i",
                                                        A, v))
    R, t = lie.se3_compose(A, v, B, v)
    assert torch.equal(R, A @ B)
    assert torch.equal(t, torch.einsum("...ij,...j->...i", A, v) + v)
    Ri, ti = lie.se3_inverse(A, v)
    assert torch.equal(ti, -torch.einsum("...ji,...j->...i", A, v))


def test_relative_frame_candidates_match_jax(graph):
    gj, ej = graph
    edges = convert.edges_from_numpy(**ej, device="cpu")
    pj = jpgo.init_from_odometry(gj.edges, N_ROBOTS, PPR)
    p = pgo.init_from_odometry(edges, N_ROBOTS, PPR)
    Rj, tj = jpcm.relative_frame_candidates(gj.edges, pj, PPR)
    R, t = pcm.relative_frame_candidates(edges, p, PPR)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    # the consistency matrix of the whole graph's shared edges
    shared = gj.edges.valid & (gj.edges.etype == EDGE_SHARED_LC)
    Cj = np.asarray(jpcm.consistency_matrix(Rj, tj, shared))
    C = pcm.consistency_matrix(R, t, torch.tensor(np.asarray(shared)))
    assert np.array_equal(C.numpy(), Cj)
    mj = np.asarray(jpcm.max_consensus(jnp.asarray(Cj)))
    assert np.array_equal(pcm.max_consensus(C).numpy(), mj)


@pytest.mark.parametrize("case", ["full", "no_shared_pair", "clique_of_one"])
def test_robot_frame_init_matches_jax(graph, case):
    gj, ej0 = graph
    ej = _edited(ej0, case)
    ejax = jc.PoseGraphEdges(**{f: jnp.asarray(a) for f, a in ej.items()})
    edges = convert.edges_from_numpy(**ej, device="cpu")
    pj0 = jpgo.init_from_odometry(ejax, N_ROBOTS, PPR)
    p0 = pgo.init_from_odometry(edges, N_ROBOTS, PPR)
    pwj, cj, okj = jpcm.robot_frame_init(ejax, pj0, N_ROBOTS, PPR)
    pw, c, ok = pcm.robot_frame_init(edges, p0, N_ROBOTS, PPR)
    assert np.array_equal(c.numpy(), np.asarray(cj))
    assert np.array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_allclose(pw.R.numpy(), np.asarray(pwj.R), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pw.t.numpy(), np.asarray(pwj.t), rtol=0,
                               atol=1e-5)
    if case == "full":
        # tests/test_chordal_pcm.py's assertions on the port's result
        out = np.asarray(gj.is_outlier)
        shared = ej["etype"] == EDGE_SHARED_LC
        cons = c.numpy()
        assert cons[shared & out].sum() == 0
        assert cons[shared & ~out].sum() >= 0.5 * (shared & ~out).sum()
        Ra, ta = jalign_left(gj.R_gt[0], gj.t_gt[0], pw.R[0].numpy(),
                             pw.t[0].numpy(), pw.R.numpy(), pw.t.numpy())
        err = np.linalg.norm(np.asarray(ta) - np.asarray(gj.t_gt), axis=-1)
        assert err[np.repeat(ok.numpy(), PPR)].max() < 1.5
    elif case == "no_shared_pair":
        # robot 2 is placed through robot 1
        assert ok.numpy().tolist() == [True, True, True]
    else:
        # and without a clique of two with robot 1, not at all
        assert ok.numpy().tolist() == [True, True, False]
