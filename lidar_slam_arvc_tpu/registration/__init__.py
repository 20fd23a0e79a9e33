"""Scan registration: ICP variants + global (feature-based) registration.

Device equivalents of the reference's four registration methods
(keyframemanager/keyframe.py:231-345 / keyframemanager.py:52-75):

  * ``icppointpoint`` -> :func:`icp` with method='point_to_point'
  * ``icppointplane`` -> :func:`icp` with method='point_to_plane'
  * ``icp2planes``    -> :func:`icp_two_planes`
  * ``fpfh``          -> :func:`lidar_slam_arvc_tpu.registration.global_reg.global_registration`
"""

from lidar_slam_arvc_tpu.registration.icp import (
    ICPParams, ICPResult, icp, icp_batch, icp_two_planes,
)

__all__ = ["ICPParams", "ICPResult", "icp", "icp_batch", "icp_two_planes"]
