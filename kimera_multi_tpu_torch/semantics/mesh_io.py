"""Offline mesh and trajectory artifacts: PLY point clouds and a
self-contained HTML viewer (the JAX package's semantics/mesh_io.py, numpy
only; tensors on any device are read back first)."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_PALETTE = np.asarray(
    [[166, 206, 227], [31, 120, 180], [178, 223, 138], [51, 160, 44],
     [251, 154, 153], [227, 26, 28], [253, 191, 111], [255, 127, 0]],
    np.uint8)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def write_ply_points(path: str, verts, normals=None, labels=None,
                     valid=None) -> int:
    """Write a point cloud (with optional normals and semantic colours).
    Returns the number of points written."""
    verts = _np(verts).astype(np.float32)
    if valid is not None:
        m = _np(valid).astype(bool)
        verts = verts[m]
        normals = None if normals is None else _np(normals)[m]
        labels = None if labels is None else _np(labels)[m]
    n = len(verts)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if labels is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = list(verts[i])
            if normals is not None:
                row += list(normals[i])
            line = " ".join(f"{x:.5f}" for x in row)
            if labels is not None:
                c = _PALETTE[int(labels[i]) % len(_PALETTE)]
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
    return n


def write_html_viewer(path: str, trajectories: dict, points=None,
                      labels=None) -> None:
    """Self-contained HTML viewer: a top-down canvas of the robots'
    trajectories and optional surface points."""
    data = {
        "trajectories": {
            str(k): _np(v).astype(np.float64)[:, :2].tolist()
            for k, v in trajectories.items()
        },
        "points": (_np(points).astype(np.float64)[:, :2].tolist()
                   if points is not None else []),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    html = """<!DOCTYPE html><html><head><meta charset="utf-8">
<title>kimera_multi_tpu run</title></head><body>
<canvas id="c" width="900" height="900" style="border:1px solid #ccc"></canvas>
<script>
const data = %s;
const ctx = document.getElementById('c').getContext('2d');
let xs=[], ys=[];
for (const k in data.trajectories) for (const p of data.trajectories[k]) {xs.push(p[0]); ys.push(p[1]);}
for (const p of data.points) {xs.push(p[0]); ys.push(p[1]);}
const minx=Math.min(...xs), maxx=Math.max(...xs), miny=Math.min(...ys), maxy=Math.max(...ys);
const s = 860/Math.max(maxx-minx, maxy-miny, 1e-6);
const X = x => 20+(x-minx)*s, Y = y => 880-(y-miny)*s;
ctx.fillStyle='#999';
for (const p of data.points) ctx.fillRect(X(p[0]), Y(p[1]), 1.5, 1.5);
const colors=['#e41a1c','#377eb8','#4daf4a','#984ea3','#ff7f00','#a65628'];
let ci=0;
for (const k in data.trajectories) {
  ctx.strokeStyle=colors[ci++%%colors.length]; ctx.lineWidth=2; ctx.beginPath();
  data.trajectories[k].forEach((p,i)=>{i?ctx.lineTo(X(p[0]),Y(p[1])):ctx.moveTo(X(p[0]),Y(p[1]))});
  ctx.stroke();
}
</script></body></html>""" % json.dumps(data)
    with open(path, "w") as f:
        f.write(html)
