"""Command-line interface (reference L5/L6 parity: automate.sh + run_*.py).

    python -m lidar_slam_arvc_tpu.pipeline.cli scanmatch -i <dataset>
    python -m lidar_slam_arvc_tpu.pipeline.cli graph     -i <dataset>
    python -m lidar_slam_arvc_tpu.pipeline.cli run       -i <dataset>   # both
    python -m lidar_slam_arvc_tpu.pipeline.cli view      -i <dataset>
    python -m lidar_slam_arvc_tpu.pipeline.cli convert   -i <dataset>

``-i/--ifile`` keeps the reference's flag (run_scanmatcher.py:19-34).
"""

from __future__ import annotations

import argparse
import sys


def _add_common(p):
    p.add_argument("-i", "--ifile", required=True, dest="directory",
                   help="EUROC-format dataset directory")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (debugging)")
    p.add_argument("--capacity", type=int, default=None,
                   help="padded per-scan point capacity")
    p.add_argument("--batch-size", type=int, default=None,
                   help="scan pairs per ICP dispatch")
    p.add_argument("--source-stride", type=int, default=None,
                   help="subsample ICP source clouds by this stride "
                        "(~stride x faster NN sweep; 1 = all points)")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="device-mesh width for the pipeline (stage-1 ICP "
                        "sharding + stage-2 distributed Schur solve); "
                        "0 = all visible devices, default 1 = single device")
    p.add_argument("--shard-scans", action="store_true",
                   help="with --devices N: shard the preprocessed scan "
                        "stack itself over the mesh (n_scans/N per device, "
                        "ppermute halo for pair boundaries) instead of "
                        "replicating it")
    p.add_argument("--mesh", action="store_true",
                   help="convert: export alpha-shape meshes instead of "
                        "point PLYs (reference save_pointcloud_as_mesh)")
    p.add_argument("--alpha", type=float, default=0.01,
                   help="convert --mesh: alpha-shape radius "
                        "(reference keyframe.py:57 uses 0.01)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="lidar_slam_arvc_tpu")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("scanmatch", "graph", "run", "view", "convert", "diag"):
        _add_common(sub.add_parser(name))
    p_ing = sub.add_parser("ingest", help="extract a ROS1 bag into the "
                           "EUROC layout (replaces the reference's broken "
                           "bagreader.py)")
    p_ing.add_argument("-i", "--ifile", required=True, dest="directory",
                       help="output EUROC dataset directory")
    p_ing.add_argument("--bag", required=True, help="input .bag (v2.0)")
    p_ing.add_argument("--odom-topic", default=None)
    p_ing.add_argument("--lidar-topic", default=None)
    p_ing.add_argument("--gps-topic", default=None)
    args = parser.parse_args(argv)

    if args.command == "ingest":
        from lidar_slam_arvc_tpu.io.rosbag import ingest_bag
        ingest_bag(args.bag, args.directory, odom_topic=args.odom_topic,
                   lidar_topic=args.lidar_topic, gps_topic=args.gps_topic)
        return 0

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from lidar_slam_arvc_tpu.utils.profiling import setup_compile_cache
    setup_compile_cache()

    from lidar_slam_arvc_tpu.utils.config import IcpConfig
    overrides = {}
    if args.capacity:
        overrides["capacity"] = args.capacity
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.source_stride:
        overrides["source_stride"] = args.source_stride
    if args.devices is not None:
        overrides["mesh_devices"] = args.devices
    if args.shard_scans:
        overrides["shard_scans"] = True
    cfg = IcpConfig(**overrides)

    preprocessed = None
    if args.command in ("scanmatch", "run"):
        from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher
        # fused mode: hand stage 1's preprocessed tensors to stage 2 so it
        # skips re-loading when the configurations match
        out = run_scanmatcher(args.directory, cfg=cfg,
                              return_preprocessed=(args.command == "run"))
        preprocessed = out.get("preprocessed")
        if preprocessed is not None and \
                preprocessed.get("voxel_size") is not None:
            # stage 2 always wants voxel None (full resolution): a
            # voxelized stage-1 stack can never be reused, so drop the
            # reference instead of pinning it in HBM through stage 2
            preprocessed = None
        print(f"scanmatcher: {len(out['relative'])} pairs, "
              f"{out['frames_per_second']:.2f} frames/s (ICP)")
    if args.command in ("graph", "run"):
        from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam
        out = run_graphslam(args.directory, cfg=cfg,
                            preprocessed=preprocessed)
        print(f"graphSLAM: {len(out['solution'])} poses, "
              f"{out['n_loop_closures']} loop closures, "
              f"{out['seconds']:.1f}s")
    if args.command == "view":
        from lidar_slam_arvc_tpu.viz.viewer import view_dataset
        view_dataset(args.directory)
    if args.command == "convert":
        from lidar_slam_arvc_tpu.viz.converter import convert_dataset
        convert_dataset(args.directory, mesh=args.mesh, alpha=args.alpha)
    if args.command == "diag":
        import json
        from lidar_slam_arvc_tpu.viz import diagnostics
        report = {"timestamps": diagnostics.check_timestamps(args.directory)}
        report["raw_data"] = diagnostics.view_raw_data(args.directory)
        for csv, tag in (("/robot0/SLAM/solution_graphslam.csv", "slam"),
                         ("/robot0/scanmatcher/scanmatcher_global.csv",
                          "scanmatcher")):
            try:
                report[f"solution_{tag}"] = diagnostics.view_solutions(
                    args.directory, csv)
                report[f"delta_{tag}"] = diagnostics.compare_solutions(
                    args.directory, csv)
            except FileNotFoundError:
                pass
        print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
