"""Low-level compute ops: nearest-neighbour search, ball moments, 3x3 eigen.

These replace the reference's Open3D C++ calls (KD-tree NN, covariance
eigen-solve).  Each op has a plain tiled XLA implementation that runs
everywhere; the NN sweep and the ball moments also have a fused Pallas
kernel for CUDA GPUs, chosen per device by ops.select.
"""

from lidar_slam_arvc_tpu.ops.eigh3 import smallest_eigenvector_sym3, eigvals_sym3
from lidar_slam_arvc_tpu.ops.nn import nn_search, nn2_search, radius_accumulate
from lidar_slam_arvc_tpu.ops.moments_pallas import ball_moments_pallas
from lidar_slam_arvc_tpu.ops.nn_pallas import nn_search_pallas
from lidar_slam_arvc_tpu.ops.select import ball_moments, nearest_neighbors

__all__ = [
    "smallest_eigenvector_sym3", "eigvals_sym3", "nn_search",
    "nn2_search", "radius_accumulate", "ball_moments_pallas",
    "nn_search_pallas", "ball_moments", "nearest_neighbors",
]
