"""Configuration system.

Three tiers, mirroring the reference (SURVEY.md §5):
  1. CLI: ``-i <dataset dir>`` (pipeline.cli),
  2. per-dataset YAMLs inside the dataset (robot0/scanmatcher_parameters.yaml,
     robot0/slam_parameters.yaml — read via io.euroc),
  3. framework-global ICP/crop parameters — this module.  Unlike the
     reference's import-time singleton (config/config.py:34) these are an
     explicit dataclass passed down, overridable from an optional
     ``icp_parameters.yaml``.
"""

from __future__ import annotations

import dataclasses

from lidar_slam_arvc_tpu.io.formats import load_yaml


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Defaults = reference config/icp_parameters.yaml."""
    # filter_by_radius (yaml:4-6)
    max_radius: float = 35.0
    min_radius: float = 0.5
    # filter_by_height (yaml:8-10)
    min_height: float = -1.0
    max_height: float = 50.0
    # down_sample (yaml:1-2) — None keeps full resolution
    voxel_size: float | None = None
    # normals (yaml:16-18); radius actually used by the reference for normal
    # estimation is keyframe.py:33's voxel_size_normals=0.3, not the yaml's 3.0
    normal_radius: float = 0.3
    normal_radius_ground: float = 0.5
    # icp (yaml:20-22)
    distance_threshold: float = 10.0
    # fpfh global registration: descriptor ball radius.  Needs tens of
    # neighbors per point (~5x the voxel size) or the 33-bin histograms are
    # noise; the reference's 0.3 works only on its full-resolution clouds.
    fpfh_radius: float = 1.0
    # shape policy (no reference counterpart)
    # failure detection: if a pair's ICP inlier fraction falls below this,
    # keep the odometry seed instead of the (likely diverged) ICP result.
    # The reference has no such gate (SURVEY.md §5: failures abort the run).
    min_fitness: float = 0.1
    # mid-stage checkpointing: 0 = off (enables the fused single-dispatch
    # scan-matching path); >0 persists progress after every batch so an
    # interrupted run resumes (costs one host sync per batch).
    checkpoint_batches: int = 0
    raw_capacity: int = 65536       # padded size of a loaded scan
    capacity: int = 16384           # padded size after crop+voxel downsample
    max_iterations: int = 30
    # scan pairs per ICP dispatch group.  A vmapped group iterates until
    # EVERY member's early exit fires, so smaller groups waste fewer
    # iterations on already-converged pairs, while larger groups fill the
    # device better.
    batch_size: int = 4
    # persistent source subsampling inside ICP (registration/icp.py
    # ICPParams.source_stride): stride f cuts the dominant O(S*T) NN-sweep
    # cost ~f x while the point-to-plane solve stays overdetermined.
    # 1 = reference parity (all source points).
    source_stride: int = 1
    # device-mesh width for the pipeline itself (SURVEY.md §2.3 rows 1/3):
    # stage-1 ICP pair batches shard_map over a 1-D 'data' mesh and stage-2
    # auto-selects the distributed Schur solver.  1 = single device (the
    # reference-shaped sequential pipeline), 0 = all visible devices,
    # N>1 = exactly N devices.  CLI: --devices.
    mesh_devices: int = 1
    # stage-1 memory scaling: shard the preprocessed SCAN STACK itself over
    # the mesh (each device holds n_scans/D scans) instead of replicating
    # it; consecutive-pair ICP gets the one cross-boundary scan per device
    # via a ppermute halo exchange (pipeline/scanmatcher._mesh_matcher_
    # sharded).  Off by default: replication is free at bench scale and
    # avoids the halo collective; turn on for long trajectories where the
    # replicated stack would not fit per-device HBM.  CLI: --shard-scans.
    shard_scans: bool = False

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "IcpConfig":
        y = load_yaml(path)
        kw = dict(
            max_radius=y["filter_by_radius"]["max_radius"],
            min_radius=y["filter_by_radius"]["min_radius"],
            max_height=y["filter_by_height"]["max_height"],
            min_height=y["filter_by_height"]["min_height"],
            voxel_size=y["down_sample"]["voxel_size"],
            distance_threshold=y["icp"]["distance_threshold"],
        )
        kw.update(overrides)
        return cls(**kw)
