"""`--artifacts` of the port's `sim` run on the CPU
(`cli/run.py::write_artifacts`: deformation graph, TSDF, surface,
marching tetrahedra, PLY and HTML), against the JAX package's
`write_artifacts` fed the same optimized poses (the port run's, carried
across as numpy), so that back-end drift stays out. 2 robots x 30
keyframes x 704 features (the `sim` world's full feature width: dense
enough landmark clouds for a mesh), seed 1, 12 GNC rounds.

Tolerances: valid surface-vertex and triangle counts within 1 % of
JAX's; 99 % of each package's valid surface vertices within 0.01 m of
the other's nearest one. The files: their PLY headers parse and their
counts match the rows; every mesh vertex lies in the grid's box; the
share of surface vertices inside it within 0.01 of JAX's (the
reference's sub-voxel step carries a vertex out of the box where the
TSDF gradient is small)."""

import argparse
import os

import jax.numpy as jnp
import numpy as np
import torch

from kimera_multi_tpu.cli import run as jrun
from kimera_multi_tpu.solve import pgo as jpgo
from kimera_multi_tpu_torch.cli import run
from kimera_multi_tpu_torch.io import sim_world

torch.set_num_threads(1)

ARGS = ["--mode", "sim", "--robots", "2", "--steps", "30", "--features",
        "704", "--seed", "1", "--gnc-rounds", "12", "--device", "cpu"]


def read_ply(path):
    """(header dict of element counts, vertex rows (N, cols) float,
    faces (F, 4) int) of an ASCII PLY; raises if the rows do not match
    the header's counts."""
    lines = open(path).read().splitlines()
    end = lines.index("end_header")
    counts = {ln.split()[1]: int(ln.split()[2]) for ln in lines[:end]
              if ln.startswith("element ")}
    body = lines[end + 1:]
    n_v, n_f = counts.get("vertex", 0), counts.get("face", 0)
    if len(body) != n_v + n_f:
        raise ValueError(f"{path}: {len(body)} rows for {n_v} vertices and "
                         f"{n_f} faces")
    verts = np.asarray([[float(x) for x in r.split()] for r in body[:n_v]])
    faces = np.asarray([[int(x) for x in r.split()] for r in body[n_v:]],
                       np.int64).reshape(-1, 4)
    return counts, verts.reshape(n_v, -1), faces


def _near_share(a, b, tol=0.01):
    """Share of rows of a within tol of their nearest row of b."""
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min(1)
    return float((d <= tol).mean())


def test_sim_artifacts_against_jax(tmp_path):
    log_dir = str(tmp_path / "port")
    out = run.main(ARGS + ["--log-dir", log_dir, "--artifacts"])
    art = out["artifacts"]
    assert out["stages"]["artifacts_s"] > 0
    cp, vp, _ = read_ply(os.path.join(log_dir, "surface.ply"))
    ct, vt, ft = read_ply(os.path.join(log_dir, "mesh.ply"))
    assert cp["vertex"] == art["n_vertices"] > 0
    assert ct["face"] == art["n_triangles"] > 0
    assert ct["vertex"] == 3 * ct["face"]
    assert (ft[:, 0] == 3).all() and ft[:, 1:].max() < ct["vertex"]
    assert vp.shape[1] == 9  # x y z, normals, colour
    html = open(os.path.join(log_dir, "run.html")).read()
    assert html.startswith("<!DOCTYPE html>") and '"trajectories"' in html
    # mesh vertices interpolate between voxel centres: inside the grid's
    # box; a surface vertex moves by -tsdf / |gradient| voxels from its
    # voxel's centre, which leaves the box where the gradient is small (in
    # the JAX package too: the share inside is compared below)
    lo = art["grid"].origin.numpy()
    hi = lo + np.asarray(art["grid"].tsdf.shape) * art["grid"].voxel_size
    inside = lambda v: ((v >= lo - 1e-4) & (v <= hi + 1e-4)).all(1)  # noqa
    assert inside(vt).all()
    assert np.isfinite(vp).all()
    assert len(art["states"]) == 2 and len(art["con_residual"]) == 2

    # the JAX package's write_artifacts from the same optimized poses
    p = out["backend"]["params"]
    world = sim_world.make_world(n_robots=2, n_steps=30, features_per_kf=704,
                                 seed=1)
    jdir = str(tmp_path / "jax")
    jrun.write_artifacts(
        argparse.Namespace(steps=30, robots=2, log_dir=jdir), world,
        jpgo.PgoParams(R=jnp.asarray(p.R.numpy()),
                       t=jnp.asarray(p.t.numpy())))
    cj, vj, _ = read_ply(os.path.join(jdir, "surface.ply"))
    ctj, _, _ = read_ply(os.path.join(jdir, "mesh.ply"))
    assert abs(cp["vertex"] - cj["vertex"]) <= 0.01 * cj["vertex"]
    assert abs(ct["face"] - ctj["face"]) <= 0.01 * ctj["face"]
    assert _near_share(vp[:, :3], vj[:, :3]) >= 0.99
    assert _near_share(vj[:, :3], vp[:, :3]) >= 0.99
    assert abs(inside(vp[:, :3]).mean() - inside(vj[:, :3]).mean()) <= 0.01
