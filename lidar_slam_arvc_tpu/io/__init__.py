"""EUROC/ASL dataset layer: PCD files, CSV schemas, YAML configs, UTM.

Host-side numpy code that feeds device buffers (tables and parameter
files through io.formats, without pandas or PyYAML).  File formats and
directory layout are byte-compatible with the reference pipeline
(eurocreader/eurocreader.py) so artifacts interoperate in both directions.
"""

from lidar_slam_arvc_tpu.io.pcd import read_pcd, write_pcd
from lidar_slam_arvc_tpu.io.euroc import EurocDataset
from lidar_slam_arvc_tpu.io.sampling import sample_times, sample_odometry
from lidar_slam_arvc_tpu.io.utm import latlon_to_utm, gps2utm, filter_gps
from lidar_slam_arvc_tpu.io.rosbag import ingest_bag, read_bag

__all__ = [
    "read_pcd", "write_pcd", "EurocDataset",
    "sample_times", "sample_odometry",
    "latlon_to_utm", "gps2utm", "filter_gps",
    "ingest_bag", "read_bag",
]
