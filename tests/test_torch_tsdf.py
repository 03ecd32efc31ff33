"""The port's metric-semantic TSDF (`semantics/tsdf.py`), marching
tetrahedra (`semantics/marching.py`) and PLY / HTML writers
(`semantics/mesh_io.py`) against the JAX package's, on the CPU, on
inputs made from a seed with numpy: a 24 x 20 x 12 grid, a 40 x 56
camera, point clouds with points behind, beside and far outside the
camera.

Tolerances: `depth_image_from_points` equal; `integrate` (a sequence of
updates, and one update from the same JAX-made grid) weights and
histograms equal and TSDF values within 1e-6, except voxels whose float
pixel coordinate lies within 1e-4 of a pixel edge (the two packages may
round such a voxel to the neighbouring pixel; the test counts them and
allows no more than 1 % of the voxels); from the same JAX-made grid,
`extract_surface` indices, labels and validity equal (ties: the lower
voxel index first, as `jax.lax.top_k`), vertices and normals within
1e-6, and marching tetrahedra validity equal and vertices within 1e-6;
PLY and HTML bytes equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.semantics import (marching as jmarching,
                                        mesh_io as jmesh_io, tsdf as jtsdf)
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.core import lie
from kimera_multi_tpu_torch.semantics import marching, mesh_io, tsdf

torch.set_num_threads(1)

H, W, FX, FY = 40, 56, 30.0, 32.0
CX, CY = W / 2, H / 2
SHAPE, ORIGIN, VOXEL, TRUNC = (24, 20, 12), (-3.0, -2.5, -0.5), 0.25, 0.6


def _cloud(rng, n=300):
    """Camera-frame points: most in front, some behind, beside or at
    z ~ 0 (pixel coordinates far past int32)."""
    p = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(0.5, 6, n)], -1).astype(np.float32)
    p[:20, 2] *= -1.0
    p[20:30, 2] = 1e-7
    p[30:40, :2] *= 40.0
    return p, rng.integers(0, 8, n).astype(np.int32), rng.random(n) > 0.1


def _pose(rng):
    w = rng.normal(0, 0.3, 3).astype(np.float32)
    # a camera looking along world +y, tilted by w
    R = lie.so3_exp(torch.from_numpy(w)).numpy() @ np.asarray(
        [[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    t = np.asarray([rng.uniform(-1, 1), -4.0, rng.uniform(0, 1)], np.float32)
    return R.astype(np.float32), t


def _grids(seed, n_frames=4):
    """The same integration sequence in both packages: the final grids,
    and the last frame's inputs and float pixel coordinates."""
    rng = np.random.default_rng(seed)
    g = tsdf.make_grid(SHAPE, ORIGIN, VOXEL, TRUNC, device="cpu")
    gj = jtsdf.make_grid(SHAPE, ORIGIN, VOXEL, TRUNC)
    for _ in range(n_frames):
        pts, lab, ok = _cloud(rng, 600)
        pts[:, 2] = np.abs(pts[:, 2]) + 0.5
        depth, lab_img = jtsdf.depth_image_from_points(
            jnp.asarray(pts), jnp.asarray(lab), jnp.asarray(ok), H, W, FX,
            FY, CX, CY, dilate=2)
        R, t = _pose(rng)
        gj = jtsdf.integrate(gj, depth, lab_img, jnp.asarray(R),
                             jnp.asarray(t), FX, FY, CX, CY)
        g = tsdf.integrate(g, torch.tensor(np.asarray(depth)),
                           torch.tensor(np.asarray(lab_img)),
                           torch.from_numpy(R), torch.from_numpy(t), FX, FY,
                           CX, CY)
    return g, gj, (R, t)


@pytest.fixture(scope="module")
def grids():
    return _grids(3)


def _port_grid(gj):
    """The JAX grid carried across (the same input for both packages)."""
    return convert.tsdf_grid_from_numpy(
        np.asarray(gj.tsdf), np.asarray(gj.weight), np.asarray(gj.sem_hist),
        np.asarray(gj.origin), gj.voxel_size, gj.trunc, device="cpu")


def _pixel_edge_voxels(R, t):
    """Voxels whose float u or v lies within 1e-4 of an integer (float64)."""
    X, Y, Z = SHAPE
    ijk = np.stack(np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                               indexing="ij"), -1).astype(np.float64)
    c = (ijk + 0.5) * VOXEL + np.asarray(ORIGIN)
    pc = (c - t) @ R.astype(np.float64)
    z = np.maximum(pc[..., 2], 1e-6)
    u = FX * pc[..., 0] / z + CX
    v = FY * pc[..., 1] / z + CY
    near = lambda x: np.abs(x - np.round(x)) < 1e-4  # noqa: E731
    return near(u) | near(v)


@pytest.mark.parametrize("dilate", [0, 2])
def test_depth_image_from_points(dilate):
    rng = np.random.default_rng(dilate)
    pts, lab, ok = _cloud(rng)
    dj, lj = jtsdf.depth_image_from_points(
        jnp.asarray(pts), jnp.asarray(lab), jnp.asarray(ok), H, W, FX, FY,
        CX, CY, dilate=dilate)
    d, lb = tsdf.depth_image_from_points(
        torch.from_numpy(pts), torch.from_numpy(lab), torch.from_numpy(ok),
        H, W, FX, FY, CX, CY, dilate=dilate)
    assert np.array_equal(d.numpy(), np.asarray(dj))
    assert np.array_equal(lb.numpy(), np.asarray(lj))
    assert (d.numpy() > 0).sum() > 50


def test_integrate(grids):
    g, gj, (R, t) = grids
    assert np.array_equal(g.weight.numpy(), np.asarray(gj.weight))
    assert np.array_equal(g.sem_hist.numpy(), np.asarray(gj.sem_hist))
    diff = np.abs(g.tsdf.numpy() - np.asarray(gj.tsdf))
    edge = _pixel_edge_voxels(R, t)
    off = diff > 1e-6
    assert (off & ~edge).sum() == 0
    assert off.sum() <= 0.01 * off.size
    assert (g.weight.numpy() > 0).mean() > 0.05


def test_integrate_one_frame_from_jax_state():
    """One update from the same (JAX-made) grid state, carried across with
    `convert.tsdf_grid_from_numpy`."""
    gj = _grids(5, n_frames=2)[1]
    rng = np.random.default_rng(9)
    pts, lab, ok = _cloud(rng, 600)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    depth, lab_img = jtsdf.depth_image_from_points(
        jnp.asarray(pts), jnp.asarray(lab), jnp.asarray(ok), H, W, FX, FY,
        CX, CY, dilate=1)
    R, t = _pose(rng)
    g = _port_grid(gj)
    out = tsdf.integrate(g, torch.tensor(np.asarray(depth)),
                         torch.tensor(np.asarray(lab_img)),
                         torch.from_numpy(R), torch.from_numpy(t), FX, FY,
                         CX, CY)
    outj = jtsdf.integrate(gj, depth, lab_img, jnp.asarray(R),
                           jnp.asarray(t), FX, FY, CX, CY)
    assert np.array_equal(out.weight.numpy(), np.asarray(outj.weight))
    assert np.array_equal(out.sem_hist.numpy(), np.asarray(outj.sem_hist))
    off = np.abs(out.tsdf.numpy() - np.asarray(outj.tsdf)) > 1e-6
    assert (off & ~_pixel_edge_voxels(R, t)).sum() == 0


def test_extract_surface(grids):
    gj = grids[1]
    g = _port_grid(gj)
    for m in (64, 2000):
        v, n, lab, ok = tsdf.extract_surface(g, m)
        vj, nj, labj, okj = jtsdf.extract_surface(gj, m)
        assert np.array_equal(ok.numpy(), np.asarray(okj))
        assert np.array_equal(lab.numpy(), np.asarray(labj))
        np.testing.assert_allclose(v.numpy(), np.asarray(vj), atol=1e-6)
        np.testing.assert_allclose(n.numpy(), np.asarray(nj), atol=1e-6)
    assert 64 < int(ok.sum()) < 2000  # ties among the invalid tail


def test_topk_tie_order_is_lower_index_first():
    """`jax.lax.top_k` on the CPU puts equal scores in index order; the
    port's stable descending sort does the same."""
    x = np.asarray([0.5, 1.0, 0.5, 0.0, 1.0, 0.5, 0.0, 0.0], np.float32)
    _, ij = jax.lax.top_k(jnp.asarray(x), 8)
    assert np.asarray(ij).tolist() == [1, 4, 0, 2, 5, 3, 6, 7]
    from kimera_multi_tpu_torch.frontend.lcd import _topk
    assert _topk(torch.from_numpy(x), 8)[1].tolist() == [1, 4, 0, 2, 5, 3,
                                                         6, 7]


def test_marching_tetrahedra_and_writers(grids, tmp_path):
    gj = grids[1]
    g = _port_grid(gj)
    tris, ok = marching.marching_tetrahedra(g, max_triangles=20000)
    trj, okj = jmarching.marching_tetrahedra(gj, max_triangles=20000)
    assert np.array_equal(ok.numpy(), np.asarray(okj))
    assert 0 < int(ok.sum()) < 20000
    np.testing.assert_allclose(tris.numpy(), np.asarray(trj), atol=1e-6)
    # the writers' bytes, from the same arrays
    n = marching.write_ply_triangles(str(tmp_path / "p.ply"), tris, ok)
    nj = jmarching.write_ply_triangles(str(tmp_path / "j.ply"), tris.numpy(),
                                       ok.numpy())
    assert n == nj == int(ok.sum())
    assert (tmp_path / "p.ply").read_bytes() \
        == (tmp_path / "j.ply").read_bytes()
    v, nrm, lab, vok = tsdf.extract_surface(g, 512)
    n = mesh_io.write_ply_points(str(tmp_path / "ps.ply"), v, nrm, lab, vok)
    nj = jmesh_io.write_ply_points(str(tmp_path / "js.ply"), v.numpy(),
                                   nrm.numpy(), lab.numpy(), vok.numpy())
    assert n == nj == int(vok.sum())
    assert (tmp_path / "ps.ply").read_bytes() \
        == (tmp_path / "js.ply").read_bytes()
    traj = {0: np.cumsum(np.ones((5, 3)), 0), 1: np.zeros((3, 3))}
    mesh_io.write_html_viewer(str(tmp_path / "p.html"), traj,
                              points=v[vok])
    jmesh_io.write_html_viewer(str(tmp_path / "j.html"), traj,
                               points=v[vok].numpy())
    assert (tmp_path / "p.html").read_bytes() \
        == (tmp_path / "j.html").read_bytes()
