"""Visualization and map export.

The reference's interactive Open3D windows (keyframemanager.py:108-184,
run_map_viewer.py) are replaced with headless artifacts: matplotlib PNGs for
trajectories/loop-closures and PLY/PCD exports for global maps
(SURVEY.md §2.2 — interactive 3D visualization is a non-goal on
accelerator hosts).
"""

from lidar_slam_arvc_tpu.viz.mapping import (
    alpha_shape_mesh, build_map, write_ply,
)
from lidar_slam_arvc_tpu.viz.plots import (
    plot_trajectory, plot_trajectory_with_loop_closures, plot_gps_comparison,
    plot_registration, plot_trajectory_with_uncertainty, plot_gps_osm,
)

__all__ = ["alpha_shape_mesh", "build_map", "write_ply", "plot_trajectory",
           "plot_trajectory_with_loop_closures", "plot_gps_comparison",
           "plot_registration", "plot_trajectory_with_uncertainty",
           "plot_gps_osm"]
