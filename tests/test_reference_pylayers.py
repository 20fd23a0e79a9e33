"""Golden parity tests against the reference's RUNNABLE pure-Python layers.

The reference's heavy numerics live in uninstallable C++ wheels (Open3D,
GTSAM — see BASELINE.md; tests/test_reference_golden.py skips here), but its
pure-Python layers import fine from /root/reference in this sandbox:
`artelib` (numpy-only rotation/SE(3) algebra), `eurocreader.eurocreader`
(pandas CSV serialization + time association) and `tools.sampling`
(samplers).  These tests run the REFERENCE CODE ITSELF as the oracle over
randomized inputs — the only reference-code parity obtainable offline:

- rot2quaternion / rot2euler / euler2rot / quaternion2rot
  (reference artelib/tools.py:92-277) vs geom.hostmath + compat
- trajectory algebra (homogeneousmatrix.py:147-212) vs compat
- sample_times / sample_odometry (tools/sampling.py:8-58) vs io/sampling
- BYTE-IDENTICAL CSVs from EurocReader.save_transforms_as_csv /
  save_sensor_times_as_csv / save_loop_closures_as_csv
  (eurocreader.py:46-100) vs io/euroc.py on the same trajectories
- get_closest_times association (eurocreader.py:128-144) vs io/euroc.py
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest

REFERENCE = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REFERENCE),
    reason="reference checkout not present at /root/reference")


@pytest.fixture(scope="module")
def ref():
    """Reference modules imported from /root/reference (appended to
    sys.path so nothing in this repo can be shadowed)."""
    from types import SimpleNamespace
    if REFERENCE not in sys.path:
        sys.path.append(REFERENCE)
    import artelib.homogeneousmatrix as hm
    import artelib.quaternion as quaternion
    import artelib.tools as tools
    import tools.sampling as sampling
    from eurocreader.eurocreader import EurocReader
    return SimpleNamespace(tools=tools, hm=hm, quaternion=quaternion,
                           sampling=sampling, EurocReader=EurocReader)


def random_rotations(n: int, seed: int = 0) -> np.ndarray:
    from scipy.spatial.transform import Rotation as SR
    return SR.random(n, random_state=seed).as_matrix()


def random_trajectory_df(n: int, seed: int = 0) -> pd.DataFrame:
    """A EUROC-schema pose dataframe with normalized wxyz quaternions."""
    rng = np.random.default_rng(seed)
    from scipy.spatial.transform import Rotation as SR
    q_xyzw = SR.random(n, random_state=seed + 1).as_quat()
    q = np.concatenate([q_xyzw[:, 3:], q_xyzw[:, :3]], axis=1)  # wxyz
    xyz = rng.normal(scale=20.0, size=(n, 3))
    t = (1_600_000_000_000_000_000
         + np.cumsum(rng.integers(10**8, 10**9, size=n)))
    return pd.DataFrame({
        "#timestamp [ns]": t, "x": xyz[:, 0], "y": xyz[:, 1],
        "z": xyz[:, 2], "qx": q[:, 1], "qy": q[:, 2], "qz": q[:, 3],
        "qw": q[:, 0]})


class TestRotationConversions:
    def test_rot2quaternion(self, ref):
        """hostmath.rot_to_quat_np == reference rot2quaternion
        (artelib/tools.py:110-172), element-for-element incl. the
        mod_sign branch choice."""
        from lidar_slam_arvc_tpu.geom.hostmath import rot_to_quat_np
        Rs = random_rotations(300)
        ours = rot_to_quat_np(Rs)
        for k, R in enumerate(Rs):
            golden = ref.tools.rot2quaternion(R.copy())
            np.testing.assert_allclose(ours[k], golden, atol=1e-12,
                                       err_msg=f"rotation {k}")

    def test_rot2quaternion_via_compat(self, ref):
        from lidar_slam_arvc_tpu.compat import RotationMatrix
        Rs = random_rotations(50, seed=3)
        for R in Rs:
            golden = ref.tools.rot2quaternion(R.copy())
            ours = RotationMatrix(R).Q().toarray()
            np.testing.assert_allclose(ours, golden, atol=1e-12)

    def test_quaternion2rot(self, ref):
        from lidar_slam_arvc_tpu.geom.hostmath import quat_to_rot_np
        rng = np.random.default_rng(5)
        q = rng.normal(size=(200, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        ours = quat_to_rot_np(q)
        for k in range(len(q)):
            golden = ref.tools.quaternion2rot(q[k])
            np.testing.assert_allclose(ours[k], golden, atol=1e-12)

    def test_rot2euler_both_branches(self, ref):
        """compat._rot_to_euler_both_np == reference rot2euler
        (artelib/tools.py:241-275), BOTH branch solutions."""
        from lidar_slam_arvc_tpu.compat import _rot_to_euler_both_np
        Rs = random_rotations(300, seed=7)
        for k, R in enumerate(Rs):
            # the reference MUTATES R in place (clips R[0,2]) — pass a copy
            g1, g2 = ref.tools.rot2euler(R.copy())
            e1, e2 = _rot_to_euler_both_np(R)
            np.testing.assert_allclose(e1, g1, atol=1e-12,
                                       err_msg=f"branch 1, rotation {k}")
            np.testing.assert_allclose(e2, g2, atol=1e-12,
                                       err_msg=f"branch 2, rotation {k}")

    def test_rot2euler_gimbal_lock(self, ref):
        """The degenerate |R02|=1 branch (artelib/tools.py:259-271)."""
        from lidar_slam_arvc_tpu.compat import _rot_to_euler_both_np
        for beta in (np.pi / 2, -np.pi / 2):
            for gamma in (0.0, 0.4, -1.1):
                R = (ref.tools.euler2rot([0.0, beta, gamma]))
                g1, g2 = ref.tools.rot2euler(R.copy())
                e1, e2 = _rot_to_euler_both_np(R)
                np.testing.assert_allclose(e1, g1, atol=1e-9)
                np.testing.assert_allclose(e2, g2, atol=1e-9)

    def test_euler2rot(self, ref):
        from lidar_slam_arvc_tpu.compat import Euler
        rng = np.random.default_rng(11)
        for abg in rng.uniform(-np.pi, np.pi, size=(100, 3)):
            golden = ref.tools.euler2rot(abg)
            ours = Euler(abg).R().toarray()
            np.testing.assert_allclose(ours, golden, atol=1e-12)


class TestTrajectoryAlgebra:
    """homogeneousmatrix.py:147-212 free functions vs compat."""

    def test_compute_homogeneous_transforms(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        df = random_trajectory_df(40)
        golden = ref.hm.compute_homogeneous_transforms(df)
        ours = compat.compute_homogeneous_transforms(df)
        assert len(ours) == len(golden)
        for a, b in zip(ours, golden):
            np.testing.assert_allclose(a.toarray(), b.toarray(), atol=1e-12)

    def test_compute_relative_transformations(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        df = random_trajectory_df(25, seed=2)
        golden_g = ref.hm.compute_homogeneous_transforms(df)
        ours_g = compat.compute_homogeneous_transforms(df)
        golden = ref.hm.compute_relative_transformations(golden_g)
        ours = compat.compute_relative_transformations(ours_g)
        assert len(ours) == len(golden) == len(df) - 1
        for a, b in zip(ours, golden):
            np.testing.assert_allclose(a.toarray(), b.toarray(), atol=1e-10)

    def test_compute_global_transformations(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        df = random_trajectory_df(25, seed=4)
        rel_ref = ref.hm.compute_relative_transformations(
            ref.hm.compute_homogeneous_transforms(df))
        rel_ours = compat.compute_relative_transformations(
            compat.compute_homogeneous_transforms(df))
        T0_ref = ref.hm.HomogeneousMatrix(np.eye(4))
        Tg_arr = random_rotations(1, seed=9)[0]
        Trobot_gps = np.eye(4)
        Trobot_gps[:3, :3] = Tg_arr
        Trobot_gps[:3, 3] = (0.3, -0.1, 0.2)
        golden = ref.hm.compute_global_transformations(
            rel_ref, T0_ref, ref.hm.HomogeneousMatrix(Trobot_gps))
        ours = compat.compute_global_transformations(
            rel_ours, compat.HomogeneousMatrix(np.eye(4)),
            compat.HomogeneousMatrix(Trobot_gps))
        assert len(ours) == len(golden) == len(df)
        for a, b in zip(ours, golden):
            np.testing.assert_allclose(a.toarray(), b.toarray(), atol=1e-9)

    def test_multiply_by_transform(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        df = random_trajectory_df(10, seed=6)
        g_ref = ref.hm.compute_homogeneous_transforms(df)
        g_ours = compat.compute_homogeneous_transforms(df)
        Trel = np.eye(4)
        Trel[:3, 3] = (1.0, 2.0, -0.5)
        golden = ref.hm.multiply_by_transform(
            g_ref, ref.hm.HomogeneousMatrix(Trel))
        ours = compat.multiply_by_transform(
            g_ours, compat.HomogeneousMatrix(Trel))
        for a, b in zip(ours, golden):
            np.testing.assert_allclose(a.toarray(), b.toarray(), atol=1e-12)

    def test_homogeneous_matrix_algebra(self, ref):
        """compose / inv / t2v against the reference class itself."""
        import lidar_slam_arvc_tpu.compat as compat
        Rs = random_rotations(20, seed=13)
        rng = np.random.default_rng(14)
        for k in range(0, 20, 2):
            A = np.eye(4)
            A[:3, :3] = Rs[k]
            A[:3, 3] = rng.normal(size=3)
            B = np.eye(4)
            B[:3, :3] = Rs[k + 1]
            B[:3, 3] = rng.normal(size=3)
            ra, rb = ref.hm.HomogeneousMatrix(A), ref.hm.HomogeneousMatrix(B)
            ca, cb = compat.HomogeneousMatrix(A), compat.HomogeneousMatrix(B)
            np.testing.assert_allclose((ca * cb).toarray(),
                                       (ra * rb).toarray(), atol=1e-12)
            np.testing.assert_allclose(ca.inv().toarray(),
                                       ra.inv().toarray(), atol=1e-12)
            np.testing.assert_allclose(ca.t2v(n=3), ra.t2v(n=3), atol=1e-12)


class TestSamplers:
    def test_sample_times(self, ref):
        """io.sampling.sample_times == reference tools/sampling.py:39-58."""
        from lidar_slam_arvc_tpu.io.sampling import sample_times
        rng = np.random.default_rng(21)
        times = (1_600_000_000_000_000_000
                 + np.cumsum(rng.integers(5 * 10**7, 5 * 10**8, size=400)))
        for start, dt in ((10, 1e9), (0, 5e8), (25, 2.5e9)):
            golden = ref.sampling.sample_times(times, start_index=start,
                                               delta_time=dt)
            ours = sample_times(times, start_index=start, delta_time=dt)
            np.testing.assert_array_equal(ours, golden)

    def test_sample_odometry(self, ref):
        """io.sampling.sample_odometry == reference tools/sampling.py:8-36
        (kept times AND kept rows)."""
        from lidar_slam_arvc_tpu.io.sampling import sample_odometry
        rng = np.random.default_rng(22)
        n = 120
        # a wandering planar trajectory with yaw drift so both gates fire
        steps = rng.normal(scale=0.3, size=(n, 2)).cumsum(axis=0)
        yaw = rng.normal(scale=0.12, size=n).cumsum()
        df = pd.DataFrame({
            "#timestamp [ns]": 10**9 * np.arange(n) + 5,
            "x": steps[:, 0], "y": steps[:, 1], "z": np.zeros(n),
            "qx": np.zeros(n), "qy": np.zeros(n),
            "qz": np.sin(yaw / 2), "qw": np.cos(yaw / 2)})
        golden_times, golden_df = ref.sampling.sample_odometry(
            df, deltaxy=0.5, deltath=0.2)
        ours_times, ours_df = sample_odometry(df, deltaxy=0.5, deltath=0.2)
        np.testing.assert_array_equal(ours_times, golden_times)
        assert len(ours_df) == len(golden_df)
        for col in ("x", "y", "z", "qx", "qy", "qz", "qw"):
            np.testing.assert_allclose(
                np.asarray(ours_df[col], dtype=np.float64),
                golden_df[col].to_numpy(dtype=np.float64), atol=0)


class TestValueClassConstructors:
    """compat's drop-in classes vs the reference's own value classes
    (artelib/{homogeneousmatrix,rotationmatrix,vector}.py) — every
    constructor form and operator the reference supports."""

    def test_homogeneous_matrix_constructor_forms(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        rng = np.random.default_rng(71)
        pos = list(rng.normal(size=3))
        abg = list(rng.uniform(-1, 1, size=3))
        R = random_rotations(1, seed=72)[0]
        from scipy.spatial.transform import Rotation as SR
        qx = SR.random(1, random_state=73).as_quat()[0]
        q = [qx[3], qx[0], qx[1], qx[2]]                      # wxyz
        cases = [
            ((), {}),
            ((np.eye(4),), {}),
            (([list(r) for r in np.eye(4)],), {}),
        ]
        for args, _ in cases:
            ours = compat.HomogeneousMatrix(*args).toarray()
            golden = ref.hm.HomogeneousMatrix(*args).toarray()
            np.testing.assert_allclose(ours, golden, atol=0)
        # (position, orientation) forms: Euler / list / Quaternion / R
        import artelib.euler as ref_euler
        import artelib.rotationmatrix as ref_rm
        pairs = [
            (compat.Euler(abg), ref_euler.Euler(abg)),
            (abg, abg),
            (compat.Quaternion(q), ref.quaternion.Quaternion(q)),
            (compat.RotationMatrix(R), ref_rm.RotationMatrix(R)),
        ]
        for ours_o, ref_o in pairs:
            ours = compat.HomogeneousMatrix(pos, ours_o).toarray()
            golden = ref.hm.HomogeneousMatrix(pos, ref_o).toarray()
            np.testing.assert_allclose(ours, golden, atol=1e-12,
                                       err_msg=str(type(ref_o)))

    def test_rotation_constructors(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        import artelib.rotationmatrix as ref_rm
        for th in (0.0, 0.3, -1.2, np.pi):
            for name in ("Rx", "Ry", "Rz", "R2"):
                ours = getattr(compat, name)(th).toarray()
                golden = getattr(ref_rm, name)(th).toarray()
                np.testing.assert_allclose(ours, golden, atol=0,
                                           err_msg=f"{name}({th})")

    def test_rotationmatrix_ops(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        import artelib.rotationmatrix as ref_rm
        R = random_rotations(1, seed=75)[0]
        ours = compat.RotationMatrix(R)
        golden = ref_rm.RotationMatrix(R)
        np.testing.assert_allclose(ours.inv().toarray(),
                                   golden.inv().toarray(), atol=0)
        np.testing.assert_allclose(ours.det(), golden.det(), atol=0)
        np.testing.assert_allclose(ours.homogeneous().toarray(),
                                   golden.homogeneous().toarray(), atol=0)

    def test_vector_ops(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        import artelib.vector as ref_vec
        rng = np.random.default_rng(77)
        a, b = rng.normal(size=(2, 3))
        va, vb = compat.Vector(a), compat.Vector(b)
        ra, rb = ref_vec.Vector(a), ref_vec.Vector(b)
        np.testing.assert_allclose((va + vb).toarray(),
                                   (ra + rb).toarray(), atol=0)
        np.testing.assert_allclose((va - vb).toarray(),
                                   (ra - rb).toarray(), atol=0)
        np.testing.assert_allclose(va.cross(vb).toarray(),
                                   ra.cross(rb).toarray(), atol=0)
        assert va * vb == pytest.approx(ra * rb)     # scalar product
        # the REFERENCE's Vector.homogeneous is broken: it passes a raw
        # np.eye(3) where HomogeneousMatrix's 2-arg branch demands a typed
        # orientation and hits `raise Exception`
        # (vector.py:31-32 -> homogeneousmatrix.py:31-44); ours returns the
        # intended translation-only transform
        with pytest.raises(Exception):
            ra.homogeneous()
        H = va.homogeneous().toarray()
        np.testing.assert_allclose(H[:3, 3], a, atol=0)
        np.testing.assert_allclose(H[:3, :3], np.eye(3), atol=0)

    def test_buildT(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        rng = np.random.default_rng(79)
        pos = rng.normal(size=3)
        abg = rng.uniform(-1, 1, size=3)
        golden = ref.tools.buildT(pos, __import__(
            "artelib.euler", fromlist=["Euler"]).Euler(abg))
        ours = compat.HomogeneousMatrix(list(pos),
                                        compat.Euler(abg)).toarray()
        np.testing.assert_allclose(ours, golden, atol=1e-12)


class TestYamlReaders:
    """Sensor transform.yaml / GPS reference.yaml parsing parity
    (eurocreader.py:15-36) on shared fixture files."""

    def _write_fixtures(self, root):
        import yaml
        os.makedirs(f"{root}/robot0/gps0", exist_ok=True)
        T = np.eye(4)
        T[:3, 3] = (0.1, -0.2, 0.85)
        T[:3, :3] = random_rotations(1, seed=81)[0]
        with open(f"{root}/robot0/gps0/transform.yaml", "w") as f:
            yaml.safe_dump({"transform": [list(map(float, r)) for r in T]},
                           f)
        with open(f"{root}/robot0/gps0/reference.yaml", "w") as f:
            yaml.safe_dump({"latitude": 38.27, "longitude": -0.68,
                            "altitude": 12.5}, f)
        return T

    def test_read_transform(self, ref, tmp_path):
        from lidar_slam_arvc_tpu.io import EurocDataset
        T = self._write_fixtures(str(tmp_path))
        golden = ref.EurocReader(str(tmp_path)).read_transform(
            "gps0").toarray()
        ours = EurocDataset(str(tmp_path)).read_transform("gps0")
        np.testing.assert_allclose(ours, golden, atol=0)
        np.testing.assert_allclose(ours, T, atol=1e-12)

    def test_read_utm_ref(self, ref, tmp_path):
        from lidar_slam_arvc_tpu.io import EurocDataset
        self._write_fixtures(str(tmp_path))
        golden = ref.EurocReader(str(tmp_path)).read_utm_ref("gps0")
        ours = EurocDataset(str(tmp_path)).read_utm_ref("gps0")
        for key in ("latitude", "longitude", "altitude"):
            assert ours[key] == golden[key], key


class TestQuaternionAlgebra:
    """Quaternion product/conjugate/slerp vs the reference's own
    implementations (artelib/tools.py:205-312, artelib/quaternion.py)."""

    def _random_unit_quats(self, n, seed):
        rng = np.random.default_rng(seed)
        q = rng.normal(size=(n, 4))
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    def test_qprod_qconj(self, ref):
        from lidar_slam_arvc_tpu.compat import Quaternion
        qs = self._random_unit_quats(40, 51)
        for k in range(0, 40, 2):
            q1, q2 = qs[k], qs[k + 1]
            golden = ref.tools.qprod(q1, q2)
            ours = (Quaternion(q1) * Quaternion(q2)).toarray()
            np.testing.assert_allclose(ours, golden, atol=1e-12)
            np.testing.assert_allclose(Quaternion(q1).qconj().toarray(),
                                       ref.tools.qconj(q1), atol=0)

    def test_quaternion_class_product_matches_reference_class(self, ref):
        from lidar_slam_arvc_tpu.compat import Quaternion
        qs = self._random_unit_quats(20, 53)
        for k in range(0, 20, 2):
            golden = (ref.quaternion.Quaternion(qs[k])
                      * ref.quaternion.Quaternion(qs[k + 1])).toarray()
            ours = (Quaternion(qs[k]) * Quaternion(qs[k + 1])).toarray()
            np.testing.assert_allclose(ours, golden, atol=1e-12)

    def test_slerp(self, ref):
        """geom.quat_slerp vs reference slerp (artelib/tools.py:290-311),
        incl. the negative-dot hemisphere flip."""
        from lidar_slam_arvc_tpu.geom import quat_slerp
        qs = self._random_unit_quats(20, 57)
        for k in range(0, 20, 2):
            q1, q2 = qs[k], qs[k + 1]
            for t in (0.0, 0.25, 0.5, 0.9, 1.0):
                golden = ref.tools.slerp(ref.quaternion.Quaternion(q1),
                                         ref.quaternion.Quaternion(q2),
                                         t).toarray()
                ours = np.asarray(quat_slerp(q1, q2, t), dtype=np.float64)
                np.testing.assert_allclose(ours, golden, atol=1e-6,
                                           err_msg=f"pair {k}, t={t}")

    def test_q2euler(self, ref):
        from lidar_slam_arvc_tpu.compat import Quaternion
        qs = self._random_unit_quats(30, 59)
        for q in qs:
            g1, g2 = ref.tools.q2euler(q)
            e1, e2 = Quaternion(q).Euler()
            np.testing.assert_allclose(e1.abg, g1, atol=1e-12)
            np.testing.assert_allclose(e2.abg, g2, atol=1e-12)


class TestDHKinematics:
    """SerialRobot/SerialLink forward kinematics vs the reference's
    artelib/seriallink.py (runnable pure numpy)."""

    def test_directkinematics_random_arms(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        sys.path.append(REFERENCE)
        from artelib.seriallink import SerialRobot as RefRobot
        rng = np.random.default_rng(61)
        for trial in range(5):
            n = int(rng.integers(2, 7))
            T0 = np.eye(4)
            T0[:3, 3] = rng.normal(size=3)
            ours = compat.SerialRobot(n, T0.copy(), "arm")
            golden = RefRobot(n, T0.copy(), "arm")
            for i in range(n):
                th, d, a, alpha = rng.normal(size=4)
                lt = "R" if rng.random() < 0.7 else "P"
                ours.append(th, d, a, alpha, link_type=lt)
                golden.append(th, d, a, alpha, link_type=lt)
            q = rng.normal(size=n)
            np.testing.assert_allclose(
                ours.directkinematics(q).toarray(),
                golden.directkinematics(q).toarray(), atol=1e-12,
                err_msg=f"trial {trial}")

    def test_single_link_dh(self, ref):
        import lidar_slam_arvc_tpu.compat as compat
        sys.path.append(REFERENCE)
        from artelib.seriallink import SerialLink as RefLink
        rng = np.random.default_rng(67)
        for lt in ("R", "P"):
            th, d, a, alpha = rng.normal(size=4)
            q = float(rng.normal())
            ours = compat.SerialLink(th, d, a, alpha, link_type=lt).dh(q)
            golden = RefLink(th, d, a, alpha, link_type=lt).dh(q)
            np.testing.assert_allclose(ours.toarray(), golden.toarray(),
                                       atol=1e-12)


class TestCsvSerialization:
    """The interop contract: our CSVs must be byte-compatible with the
    reference's (eurocreader.py:46-100) so either stage of either pipeline
    can consume the other's artifacts."""

    def _transforms(self, n=30, seed=31):
        df = random_trajectory_df(n, seed=seed)
        from lidar_slam_arvc_tpu.geom.hostmath import (
            transforms_from_pose_columns_np)
        xyz = df[["x", "y", "z"]].to_numpy(dtype=np.float64)
        q = df[["qw", "qx", "qy", "qz"]].to_numpy(dtype=np.float64)
        return df["#timestamp [ns]"].to_numpy(), \
            transforms_from_pose_columns_np(xyz, q)

    def test_save_transforms_byte_identical(self, ref, tmp_path):
        from lidar_slam_arvc_tpu.io import EurocDataset
        times, T = self._transforms()
        ref_dir = tmp_path / "ref"
        our_dir = tmp_path / "ours"
        ref_dir.mkdir()
        our_dir.mkdir()
        golden_T = [ref.hm.HomogeneousMatrix(T[i]) for i in range(len(T))]
        ref.EurocReader(str(ref_dir)).save_transforms_as_csv(
            times, golden_T, "/traj.csv")
        EurocDataset(str(our_dir)).save_transforms_as_csv(
            times, T, "/traj.csv")
        a = (ref_dir / "traj.csv").read_bytes()
        b = (our_dir / "traj.csv").read_bytes()
        assert a == b, "transform CSV bytes differ from the reference's"

    def test_save_sensor_times_byte_identical(self, ref, tmp_path):
        from lidar_slam_arvc_tpu.io import EurocDataset
        times, _ = self._transforms(seed=33)
        ref_dir = tmp_path / "ref"
        our_dir = tmp_path / "ours"
        ref_dir.mkdir()
        our_dir.mkdir()
        ref.EurocReader(str(ref_dir)).save_sensor_times_as_csv(
            times, "/times.csv")
        EurocDataset(str(our_dir)).save_sensor_times_as_csv(
            times, "/times.csv")
        assert (ref_dir / "times.csv").read_bytes() == \
            (our_dir / "times.csv").read_bytes()

    def test_save_loop_closures_byte_identical(self, ref, tmp_path):
        from lidar_slam_arvc_tpu.io import EurocDataset
        closures = [[[5, 1], [5, 2]], None, [], [[9, 3]]]
        ref_dir = tmp_path / "ref"
        our_dir = tmp_path / "ours"
        ref_dir.mkdir()
        our_dir.mkdir()
        ref.EurocReader(str(ref_dir)).save_loop_closures_as_csv(
            closures, "/loops.csv")
        EurocDataset(str(our_dir)).save_loop_closures_as_csv(
            closures, "/loops.csv")
        assert (ref_dir / "loops.csv").read_bytes() == \
            (our_dir / "loops.csv").read_bytes()

    def test_roundtrip_through_reference_reader(self, ref, tmp_path):
        """Trajectories written by us and re-read through the REFERENCE's
        compute_homogeneous_transforms reproduce the input poses."""
        from lidar_slam_arvc_tpu.io import EurocDataset
        times, T = self._transforms(seed=35)
        EurocDataset(str(tmp_path)).save_transforms_as_csv(
            times, T, "/traj.csv")
        df = ref.EurocReader(str(tmp_path)).read_csv("/traj.csv")
        golden = ref.hm.compute_homogeneous_transforms(df)
        for i in range(len(T)):
            np.testing.assert_allclose(golden[i].toarray(), T[i], atol=1e-9)

    def test_get_closest_times(self, ref, tmp_path):
        from lidar_slam_arvc_tpu.io import EurocDataset
        rng = np.random.default_rng(41)
        master = np.sort(rng.integers(0, 10**12, size=50))
        sensor = np.sort(rng.integers(0, 10**12, size=200))
        golden = ref.EurocReader(str(tmp_path)).get_closest_times(
            master, sensor, warning_max_time_dif_s=np.inf)
        ours = EurocDataset.get_closest_times(master, sensor)
        np.testing.assert_array_equal(ours, golden)
