"""lidar_slam_arvc_tpu — a LiDAR SLAM framework for accelerators, in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
JudithV/LIDAR_SLAM_ARVC reference pipeline (EUROC/ASL ingestion, keyframe
management, ICP scan-matching seeded by odometry, radius-gated loop closing
with triangle consistency, and SE(3) pose-graph optimization), built for
accelerators: fixed-shape padded tensors, exact brute-force neighbor search
(fused Pallas kernels on CUDA GPUs), batched registration over device
meshes, and a batch Gauss-Newton /
Levenberg-Marquardt pose-graph solver replacing incremental ISAM2.

Subpackages
-----------
geom          SO(3)/SE(3) algebra (quaternions wxyz, Euler XYZ, exp/log maps)
io            EUROC dataset layer: PCD parsing, CSV schemas, YAML configs, UTM
cloud         point-cloud ops: crop, voxel downsample, normals, ground plane
ops           low-level kernels (nearest neighbor, ball moments, 3x3 eigen)
registration  ICP point-to-point / point-to-plane / two-planes / FPFH-global
graph         factor-graph construction and GN/LM solver on SE(3)
loop          loop-closure candidate search and triangle consistency gating
pipeline      scanmatcher and graphSLAM drivers + CLI (automate.sh parity)
parallel      mesh/sharding utilities, multi-chip batched ICP and solve
utils         config system, ATE/RPE metrics, profiling, synthetic datasets
viz           trajectory/map plotting and PLY export
compat        artelib-compatible value classes (HomogeneousMatrix, ...) for
              line-for-line porting of reference scripts
"""

__version__ = "0.1.0"
