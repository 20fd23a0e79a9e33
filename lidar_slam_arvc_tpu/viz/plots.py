"""Headless trajectory/GPS/loop-closure plotting (PNG artifacts).

Replaces the reference's live matplotlib windows (graphSLAM.py:147-209,
run_map_viewer.py:52-69, tools/plottools.py) with saved figures.
"""

from __future__ import annotations

import numpy as np

from lidar_slam_arvc_tpu.io.formats import n_rows


def _agg():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_trajectory(T: np.ndarray, path: str, label: str = "trajectory",
                    extra: dict | None = None) -> None:
    """Top-down XY plot; ``extra`` maps label -> (N,4,4) for overlays."""
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    p = np.asarray(T)[:, :3, 3]
    ax.plot(p[:, 0], p[:, 1], ".-", markersize=3, label=label)
    for name, Te in (extra or {}).items():
        pe = np.asarray(Te)[:, :3, 3]
        ax.plot(pe[:, 0], pe[:, 1], ".-", markersize=3, label=name)
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.axis("equal")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_trajectory_with_loop_closures(T: np.ndarray, loop_pairs,
                                       path: str) -> None:
    """XY trajectory + black chords for accepted loop closures
    (reference run_map_viewer.py:52-69)."""
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    p = np.asarray(T)[:, :3, 3]
    ax.plot(p[:, 0], p[:, 1], ".-", markersize=3, color="tab:blue")
    for (i, j) in loop_pairs:
        ax.plot([p[i, 0], p[j, 0]], [p[i, 1], p[j, 1]],
                color="black", linewidth=1.5)
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.axis("equal")
    ax.set_title(f"{len(loop_pairs)} loop closures")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_trajectory_with_uncertainty(T: np.ndarray, covs: np.ndarray,
                                     path: str, scale: float = 1.0,
                                     skip: int = 1) -> None:
    """XY trajectory with per-pose 1-sigma position-uncertainty ellipses.

    Headless equivalent of the reference's GraphSLAM.plot with
    plot_uncertainty_ellipse=True (graphSLAM.py:115-145, which draws
    gtsam_plot.plot_pose3 ellipsoids from marginalCovariance).  ``covs`` is
    (N,6,6) tangent covariance in [w, v] order (PoseGraph.marginal_covariances);
    the drawn ellipse is the xy marginal of the translation block rotated
    into the world frame.
    """
    plt = _agg()
    from matplotlib.patches import Ellipse
    fig, ax = plt.subplots(figsize=(8, 8))
    T = np.asarray(T)
    covs = np.asarray(covs)
    p = T[:, :3, 3]
    ax.plot(p[:, 0], p[:, 1], ".-", markersize=3, color="tab:blue")
    for i in range(0, len(T), max(int(skip), 1)):
        # translation covariance is expressed in the body frame (right
        # perturbation); rotate into world: R Sigma_v R^T
        R = T[i, :3, :3]
        Sw = R @ covs[i, 3:, 3:] @ R.T
        S2 = Sw[:2, :2]
        w, V = np.linalg.eigh(S2)
        w = np.clip(w, 0.0, None)
        ang = float(np.degrees(np.arctan2(V[1, -1], V[0, -1])))
        ax.add_patch(Ellipse(p[i, :2], 2 * scale * np.sqrt(w[-1]),
                             2 * scale * np.sqrt(w[0]), angle=ang,
                             facecolor="none", edgecolor="tab:red",
                             linewidth=0.8, alpha=0.8))
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.axis("equal")
    ax.set_title("trajectory with 1-sigma position uncertainty")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_gps_comparison(T: np.ndarray, df_gps, correspondences,
                        path: str) -> None:
    """Estimate-vs-GPS overlay with correspondence segments
    (reference graphSLAM.py:183-209)."""
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    p = np.asarray(T)[:, :3, 3]
    ax.plot(p[:, 0], p[:, 1], marker=".", color="blue",
            label="GraphSLAM estimation")
    ax.plot(df_gps["x"], df_gps["y"], marker="o", linestyle="none",
            markersize=3, color="red", label="GPS UTM")
    for (i, k) in correspondences:
        ax.plot([p[i, 0], np.asarray(df_gps["x"])[k]],
                [p[i, 1], np.asarray(df_gps["y"])[k]], color="black",
                linewidth=1)
    ax.legend()
    ax.set_title("Correspondences (estimation, GPS)")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_gps_osm(df_gps, path: str, expand: float = 0.001) -> bool:
    """GPS track over an OpenStreetMap basemap (reference
    tools/plottools.py:245-271 plot_gps_OSM), saved headless.

    Basemap tiles need the optional ``tilemapbase`` package plus network
    access; when unavailable this degrades to the same figure without the
    basemap — the track drawn in Web-Mercator-projected lon/lat with the
    identical extent semantics.  Returns True when tiles were rendered.
    """
    plt = _agg()
    lon = np.asarray(df_gps["longitude"], dtype=np.float64)
    lat = np.asarray(df_gps["latitude"], dtype=np.float64)
    fig, ax = plt.subplots(figsize=(8, 8), dpi=150)
    tiles_ok = False
    try:  # optional dependency + network
        import tilemapbase
        tilemapbase.init(create=True)
        extent = tilemapbase.Extent.from_lonlat(
            lon.min() - expand, lon.max() + expand,
            lat.min() - expand, lat.max() + expand)
        proj = np.array([tilemapbase.project(x, y)
                         for x, y in zip(lon, lat)])
        plotter = tilemapbase.Plotter(extent, tilemapbase.tiles.build_OSM(),
                                      height=600)
        plotter.plot(ax, tilemapbase.tiles.build_OSM(), alpha=0.8)
        tiles_ok = True
    except Exception:
        # offline fallback: same Web-Mercator projection, no tiles
        x = np.radians(lon)
        y = np.arcsinh(np.tan(np.radians(lat)))
        proj = np.column_stack([(x / (2 * np.pi)) + 0.5,
                                0.5 - y / (2 * np.pi)])
        ax.invert_yaxis()
    ax.plot(proj[:, 0], proj[:, 1], color="blue", linewidth=1)
    ax.xaxis.set_visible(False)
    ax.yaxis.set_visible(False)
    ax.set_title("GPS track" + ("" if tiles_ok else " (no OSM tiles)"))
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return tiles_ok


def compute_distance(lat1, lng1, lat2, lng2):
    """Haversine great-circle distance in meters (reference
    tools/plottools.py:174-189, R = 6373 km).  Vectorized over numpy inputs."""
    R = 6373.0 * 1000.0
    lat1, lng1, lat2, lng2 = (np.radians(np.asarray(v, dtype=np.float64))
                              for v in (lat1, lng1, lat2, lng2))
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lng2 - lng1) / 2) ** 2)
    return R * 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))


def _plot_points(df, xcol, ycol, xlabel, ylabel, path, title,
                 annotate_index, annotate_error, sample):
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(df[xcol], df[ycol])
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    for i in range(0, n_rows(df), max(int(sample), 1)):
        x = np.asarray(df[xcol])[i]
        y = np.asarray(df[ycol])[i]
        if annotate_index:
            ax.annotate(str(i), (x, y), fontsize=12)
        if annotate_error:
            s = 2 * np.sqrt(np.asarray(df["covariance_d1"])[i])
            ax.annotate(f"{s:.3f}", (x, y), fontsize=12)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_gps_points(df_gps, path: str,
                    title: str = "GPS POINTS (index, radius error in meters)",
                    annotate_index: bool = False,
                    annotate_error: bool = False, sample: int = 10) -> None:
    """lon/lat scatter with optional index / 2-sigma radius annotations
    (reference tools/plottools.py:191-216), saved headless."""
    _plot_points(df_gps, "longitude", "latitude", "longitude", "latitude",
                 path, title, annotate_index, annotate_error, sample)


def plot_utm_points(df_utm, path: str,
                    title: str = "UTM POINTS (index, radius error in meters)",
                    annotate_index: bool = False,
                    annotate_error: bool = False, sample: int = 10) -> None:
    """UTM x/y scatter with the same annotation options (reference
    tools/plottools.py:218-243), saved headless."""
    _plot_points(df_utm, "x", "y", "x (m)", "y (m)", path, title,
                 annotate_index, annotate_error, sample)


def plot_quaternion_data(df_data, path: str,
                         title: str = "Quaternion data to Euler",
                         annotate_time: bool = False) -> None:
    """Per-sample quaternion orientation converted to XYZ Euler angles and
    plotted against index or experiment time (reference
    tools/plottools.py:96-126; the reference's ad hoc -2.5 rad yaw shift is
    not reproduced — it was a dataset-specific mounting offset)."""
    from lidar_slam_arvc_tpu.geom.hostmath import quat_to_rot_np
    plt = _agg()
    q = np.column_stack([df_data["qw"], df_data["qx"],
                         df_data["qy"], df_data["qz"]]).astype(np.float64)

    def euler_xyz(R):  # first branch of the XYZ mobile-axes extraction;
        # arctan2 makes the cos(beta) scaling redundant and NaN-free at
        # gimbal lock (cos(beta) >= 0 from arcsin, so signs are unchanged)
        beta = np.arcsin(np.clip(R[0, 2], -1.0, 1.0))
        alpha = np.arctan2(-R[1, 2], R[2, 2])
        gamma = np.arctan2(-R[0, 1], R[0, 0])
        return alpha, beta, gamma

    eul = np.array([euler_xyz(quat_to_rot_np(qi)) for qi in q])
    if annotate_time:
        ts = np.asarray(df_data["#timestamp [ns]"], dtype=np.float64)
        xs = (ts - ts[0]) / 1e9
        xlabel = "Experiment time (s)"
    else:
        xs = np.arange(len(eul))
        xlabel = "Data index"
    fig, ax = plt.subplots(figsize=(10, 6))
    for k, color in enumerate(("red", "green", "blue")):
        ax.plot(xs, eul[:, k], color=color, linestyle="dashed", marker="o",
                markersize=3)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_xyz_data(df_data, path: str, title: str = "XYZ",
                  annotate_time: bool = False) -> None:
    """x/y/z columns against index or time (reference
    tools/plottools.py:129-143), saved headless."""
    plt = _agg()
    if annotate_time:
        ts = np.asarray(df_data["#timestamp [ns]"], dtype=np.float64)
        xs = (ts - ts[0]) / 1e9
    else:
        xs = np.arange(n_rows(df_data))
    fig, ax = plt.subplots(figsize=(10, 6))
    for col, color in (("x", "red"), ("y", "green"), ("z", "blue")):
        ax.plot(xs, df_data[col], color=color, linestyle="dashed", marker="o",
                markersize=3, label=col)
    ax.set_title(title)
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_xy_data(df_data, path: str, title: str = "XY", sample: int = 10,
                 annotate_time: bool = False,
                 annotate_index: bool = False) -> None:
    """XY scatter with optional time/index annotations (reference
    tools/plottools.py:145-158), saved headless."""
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(df_data["x"], df_data["y"], color="blue")
    if annotate_time:
        ts = np.asarray(df_data["#timestamp [ns]"], dtype=np.float64)
        for i in range(0, n_rows(df_data), sample):
            ax.annotate(f"{(ts[i] - ts[0]) / 1e9:.3f}",
                        (np.asarray(df_data["x"])[i],
                         np.asarray(df_data["y"])[i]),
                        fontsize=12)
    if annotate_index:
        for i in range(0, n_rows(df_data), sample):
            ax.annotate(str(i), (np.asarray(df_data["x"])[i],
                                 np.asarray(df_data["y"])[i]),
                        fontsize=12)
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_registration(src_points, tgt_points, transform, path: str,
                      max_points: int = 5000) -> None:
    """Overlay of a registered pair: source (red) transformed into the
    target frame (blue) — headless equivalent of the reference's
    draw_registration_result (keyframe.py:347-358)."""
    plt = _agg()
    src = np.asarray(src_points)
    tgt = np.asarray(tgt_points)
    T = np.asarray(transform)
    if len(src) > max_points:
        src = src[np.linspace(0, len(src) - 1, max_points).astype(int)]
    if len(tgt) > max_points:
        tgt = tgt[np.linspace(0, len(tgt) - 1, max_points).astype(int)]
    moved = src @ T[:3, :3].T + T[:3, 3]
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(tgt[:, 0], tgt[:, 1], s=1, color="tab:blue", label="target")
    ax.scatter(moved[:, 0], moved[:, 1], s=1, color="tab:red",
               label="source (transformed)")
    ax.axis("equal")
    ax.legend(markerscale=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
