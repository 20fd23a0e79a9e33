"""SE(3) factor-graph optimization (replaces GTSAM — SURVEY.md §2.2).

The reference wraps GTSAM's C++ ``NonlinearFactorGraph`` + incremental ISAM2
(graphslam/graphSLAM.py).  Here the graph lives in fixed-capacity device
tensors — stacked between-factors, GPS unary factors, and priors with
validity masks — and each ``optimize`` is a batch Gauss-Newton /
Levenberg-Marquardt re-solve: all factor residuals and Jacobian blocks are
evaluated in one vmapped program, the normal equations assembled by
scatter-add, and solved by dense Cholesky (small graphs) — numerically
equivalent to ISAM2's fixpoint for this offline workload, and
embarrassingly batchable on device.
"""

from lidar_slam_arvc_tpu.graph.factors import (
    NoiseSigmas, DEFAULT_SIGMAS, FactorData, make_factor_buffers,
)
from lidar_slam_arvc_tpu.graph.solver import (
    solve_graph, graph_cost, marginal_covariances,
)
from lidar_slam_arvc_tpu.graph.builder import PoseGraph

__all__ = [
    "NoiseSigmas", "DEFAULT_SIGMAS", "FactorData", "make_factor_buffers",
    "solve_graph", "graph_cost", "marginal_covariances", "PoseGraph",
]
