"""Triangle mesh extraction from TSDF grids: marching tetrahedra (the JAX
package's semantics/marching.py).

Every cube splits into 6 tetrahedra sharing the 0-7 diagonal; each
tetrahedron's sign configuration indexes a (16, 2, 3) edge table;
triangle vertices are linear zero-crossing interpolations along its
edges. Output has a fixed capacity: the valid triangles first, in the
order of (tetrahedron, triangle slot, cube), then invalid ones.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .tsdf import TsdfGrid

# cube corners: bit 0 -> +x, bit 1 -> +y, bit 2 -> +z
_CORNER_OFFSETS = np.asarray(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int32)
# corner index = x + 2 y + 4 z; the 6-tet split shares the 0-7 diagonal
_TETS = np.asarray(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
     [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int32)
# tet edges by local vertex pair: e01=0 e02=1 e03=2 e12=3 e13=4 e23=5
_TET_EDGES = np.asarray(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)

# (16, 2, 3): for each inside-bitmask, up to two triangles of edge ids
_TRI_TABLE = -np.ones((16, 2, 3), np.int32)
_TRI_TABLE[0b0001, 0] = [0, 1, 2]                       # v0 inside
_TRI_TABLE[0b0010, 0] = [0, 4, 3]                       # v1
_TRI_TABLE[0b0100, 0] = [1, 3, 5]                       # v2
_TRI_TABLE[0b1000, 0] = [2, 5, 4]                       # v3
_TRI_TABLE[0b0011] = [[1, 2, 4], [1, 4, 3]]             # v0, v1
_TRI_TABLE[0b0101] = [[0, 2, 5], [0, 5, 3]]             # v0, v2
_TRI_TABLE[0b1001] = [[0, 1, 5], [0, 5, 4]]             # v0, v3
_TRI_TABLE[0b0110] = [[0, 1, 5], [0, 5, 4]]             # v1, v2
_TRI_TABLE[0b1010] = [[0, 3, 5], [0, 5, 2]]             # v1, v3
_TRI_TABLE[0b1100] = [[1, 2, 4], [1, 4, 3]]             # v2, v3
_TRI_TABLE[0b1110] = _TRI_TABLE[0b0001]                 # complements
_TRI_TABLE[0b1101] = _TRI_TABLE[0b0010]
_TRI_TABLE[0b1011] = _TRI_TABLE[0b0100]
_TRI_TABLE[0b0111] = _TRI_TABLE[0b1000]


@torch.no_grad()
def marching_tetrahedra(grid: TsdfGrid, level: float = 0.0,
                        max_triangles: int = 16384):
    """Extract the level-set triangle mesh.

    Returns (tris (T, 3, 3) world-space vertices, valid (T,)). Only
    tetrahedra whose 4 corners are all observed (weight > 0) emit
    geometry.
    """
    t, w = grid.tsdf, grid.weight
    dev = t.device
    X, Y, Z = t.shape
    cx, cy, cz = X - 1, Y - 1, Z - 1

    def corner(arr, off):
        return arr[off[0]:off[0] + cx, off[1]:off[1] + cy,
                   off[2]:off[2] + cz]

    vals = torch.stack([corner(t, o) for o in _CORNER_OFFSETS], -1)
    obs = torch.stack([corner(w, o) > 0 for o in _CORNER_OFFSETS], -1)
    ii, jj, kk = torch.meshgrid(torch.arange(cx, device=dev),
                                torch.arange(cy, device=dev),
                                torch.arange(cz, device=dev), indexing="ij")
    base = torch.stack([ii, jj, kk], -1).to(torch.float32)
    offs = torch.from_numpy(_CORNER_OFFSETS.astype(np.float32)).to(dev)
    corners = ((base[..., None, :] + offs) + 0.5) * grid.voxel_size \
        + grid.origin  # (cx, cy, cz, 8, 3)

    tri_table = torch.from_numpy(_TRI_TABLE.astype(np.int64)).to(dev)
    e0 = torch.from_numpy(_TET_EDGES[:, 0].astype(np.int64)).to(dev)
    e1 = torch.from_numpy(_TET_EDGES[:, 1].astype(np.int64)).to(dev)
    tris_out, valid_out = [], []
    for tv in _TETS.astype(np.int64):
        tv = torch.from_numpy(tv).to(dev)
        v4 = vals[..., tv]  # (cx, cy, cz, 4)
        p4 = corners[..., tv, :]  # (cx, cy, cz, 4, 3)
        tet_obs = torch.all(obs[..., tv], dim=-1)
        inside = (v4 < level).to(torch.int64)
        code = (inside[..., 0] + 2 * inside[..., 1] + 4 * inside[..., 2]
                + 8 * inside[..., 3])
        # edge zero crossings (cx, cy, cz, 6, 3)
        a, b = v4[..., e0], v4[..., e1]
        pa, pb = p4[..., e0, :], p4[..., e1, :]
        den = torch.where(torch.abs(b - a) < 1e-9, 1e-9, b - a)
        alpha = torch.clamp((level - a) / den, 0.0, 1.0)[..., None]
        epts = pa + alpha * (pb - pa)
        for slot in range(2):
            eidx = tri_table[code, slot]  # (cx, cy, cz, 3)
            tri_ok = (eidx[..., 0] >= 0) & tet_obs
            safe = torch.clamp(eidx, 0, 5)
            verts = torch.take_along_dim(
                epts, safe[..., :, None].expand(*safe.shape, 3), dim=-2)
            tris_out.append(verts.reshape(-1, 3, 3))
            valid_out.append(tri_ok.reshape(-1))
    tris = torch.cat(tris_out)
    valid = torch.cat(valid_out)
    # valid triangles first, each group in index order (a stable sort)
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    order = order[:max_triangles]
    return tris[order], valid[order]


def write_ply_triangles(path: str, tris, valid) -> int:
    """Write a triangle mesh PLY (ASCII). Returns the triangle count."""
    tris = np.asarray(torch.as_tensor(tris).cpu())[
        np.asarray(torch.as_tensor(valid).cpu())]
    n_t = len(tris)
    verts = tris.reshape(-1, 3)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {3 * n_t}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {n_t}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for p in verts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        for i in range(n_t):
            f.write(f"3 {3*i} {3*i+1} {3*i+2}\n")
    return n_t
