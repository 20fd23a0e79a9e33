"""Dataset converter: per-scan PCD -> PLY export (points or alpha-shape mesh).

Parity with reference run_converter.py:138-191 (converter): iterate the
scan list and save each cloud under robot0/lidar/dataply/<t>.ply.  With
``mesh=True`` each scan is surface-reconstructed first via the alpha shape
(reference save_pointcloud_as_mesh, keyframe.py:53-59, which calls Open3D's
create_from_point_cloud_alpha_shape with alpha=0.01) — here a scipy-Delaunay
host-side implementation (viz/mapping.alpha_shape_mesh).
"""

from __future__ import annotations

import os

from lidar_slam_arvc_tpu.io import EurocDataset, read_pcd
from lidar_slam_arvc_tpu.viz.mapping import alpha_shape_mesh, write_ply


def convert_dataset(directory: str, sampling: int = 1, mesh: bool = False,
                    alpha: float = 0.01) -> int:
    euroc = EurocDataset(directory)
    df = euroc.read_csv("/robot0/lidar/data.csv")
    times = df["#timestamp [ns]"]
    out_dir = f"{directory}/robot0/lidar/dataply"
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for t in times[::sampling]:
        pts = read_pcd(euroc.scan_pcd_path(t))
        if mesh:
            verts, tris = alpha_shape_mesh(pts, alpha)
            write_ply(f"{out_dir}/{t}.ply", verts, faces=tris)
        else:
            write_ply(f"{out_dir}/{t}.ply", pts)
        n += 1
    kind = "mesh" if mesh else "point"
    print(f"converter: wrote {n} {kind} PLY files -> {out_dir}")
    return n
