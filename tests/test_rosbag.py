"""Rosbag -> EUROC ingest (replaces reference eurocreader/bagreader.py,
which is import-broken upstream).  Hermetic: bags are generated by the
module's own spec-conformant writer, read back through the parser, and
extracted into the pipeline's EUROC layout."""

import numpy as np
import pytest

from lidar_slam_arvc_tpu.io import EurocDataset, ingest_bag, read_bag, read_pcd
from lidar_slam_arvc_tpu.io.rosbag import (
    parse_odometry, parse_pointcloud2, serialize_navsatfix,
    serialize_odometry, serialize_pointcloud2, write_bag,
)


def _make_bag(path, compression="none", n=5, extra_field=True):
    rng = np.random.default_rng(0)
    msgs = []
    clouds = []
    for i in range(n):
        t = 1_000_000_000 * (i + 1) + 123
        msgs.append(("/odom", "nav_msgs/Odometry", t,
                     serialize_odometry(t, (i * 0.5, 0.1 * i, 0.0),
                                        (0.0, 0.0, 0.0, 1.0))))
        pts = rng.normal(size=(40 + i, 3)).astype(np.float32)
        clouds.append(pts)
        msgs.append(("/points", "sensor_msgs/PointCloud2", t,
                     serialize_pointcloud2(t, pts, extra_field=extra_field)))
        msgs.append(("/fix", "sensor_msgs/NavSatFix", t,
                     serialize_navsatfix(t, 38.0 + 1e-5 * i, -0.7, 50.0)))
    write_bag(str(path), msgs, compression=compression)
    return msgs, clouds


class TestBagParser:
    @pytest.mark.parametrize("compression", ["none", "bz2"])
    def test_roundtrip(self, tmp_path, compression):
        bag = tmp_path / f"t_{compression}.bag"
        msgs, clouds = _make_bag(bag, compression)
        got = list(read_bag(str(bag)))
        assert len(got) == len(msgs)
        topics = {t for t, _, _, _ in got}
        assert topics == {"/odom", "/points", "/fix"}
        # message payloads survive byte-exact
        for (t1, ty1, ts1, raw1), (t2, ty2, ts2, raw2) in zip(got, msgs):
            assert (t1, ty1, ts1) == (t2, ty2, ts2)
            assert raw1 == raw2

    def test_odometry_fields(self, tmp_path):
        bag = tmp_path / "t.bag"
        _make_bag(bag)
        odo = [parse_odometry(raw) for t, ty, ts, raw in read_bag(str(bag))
               if ty == "nav_msgs/Odometry"]
        assert odo[2]["x"] == pytest.approx(1.0)
        assert odo[2]["qw"] == pytest.approx(1.0)
        assert odo[2]["stamp_ns"] == 3_000_000_123

    @pytest.mark.parametrize("extra_field", [False, True])
    def test_pointcloud_strided_fields(self, tmp_path, extra_field):
        # intensity between xyz fields exercises point_step striding
        bag = tmp_path / "t.bag"
        _, clouds = _make_bag(bag, extra_field=extra_field)
        got = [parse_pointcloud2(raw) for t, ty, ts, raw
               in read_bag(str(bag)) if ty == "sensor_msgs/PointCloud2"]
        for (stamp, pts), ref in zip(got, clouds):
            np.testing.assert_array_equal(pts, ref)

    def test_rejects_non_bag(self, tmp_path):
        p = tmp_path / "not.bag"
        p.write_bytes(b"hello world")
        with pytest.raises(ValueError, match="not a ROS bag"):
            list(read_bag(str(p)))


class TestIngest:
    def test_euroc_layout(self, tmp_path):
        bag = tmp_path / "t.bag"
        _, clouds = _make_bag(bag, compression="bz2")
        out = str(tmp_path / "dataset")
        counts = ingest_bag(str(bag), out, progress=False)
        assert counts == {
            "odometry": 5, "lidar_scans": 5, "gps_fixes": 5,
            "messages_read": 15,
            "topics": {"nav_msgs/Odometry": "/odom",
                       "sensor_msgs/PointCloud2": "/points",
                       "sensor_msgs/NavSatFix": "/fix"}}
        euroc = EurocDataset(out)
        df = euroc.read_csv("/robot0/lidar/data.csv")
        times = np.asarray(df["#timestamp [ns]"])
        assert len(times) == 5
        pts = read_pcd(euroc.scan_pcd_path(times[0]))
        np.testing.assert_allclose(pts, clouds[0], atol=1e-6)
        df_odo = euroc.read_csv("/robot0/odom/data.csv")
        assert list(df_odo) == ["#timestamp [ns]", "x", "y", "z",
                                        "qx", "qy", "qz", "qw"]
        df_gps = euroc.read_csv("/robot0/gps0/data.csv")
        assert df_gps["latitude"][0] == pytest.approx(38.0)
        ref = euroc.read_utm_ref("gps0")
        assert ref["latitude"] == pytest.approx(38.0)

    def test_cli_ingest(self, tmp_path):
        from lidar_slam_arvc_tpu.pipeline import cli
        bag = tmp_path / "t.bag"
        _make_bag(bag)
        out = str(tmp_path / "ds")
        assert cli.main(["ingest", "-i", out, "--bag", str(bag),
                         "--lidar-topic", "/points"]) == 0
        assert (tmp_path / "ds/robot0/lidar/data.csv").exists()
