"""Tests for the EUROC dataset layer: PCD, CSV schema, time association, UTM."""

import numpy as np
import pandas as pd
import pytest

from lidar_slam_arvc_tpu.io import (
    EurocDataset, filter_gps, gps2utm, latlon_to_utm, read_pcd, sample_times,
    write_pcd,
)
from lidar_slam_arvc_tpu.io.pcd import lzf_decompress_py


class TestPCD:
    def test_roundtrip_binary(self, tmp_path, rng):
        pts = rng.normal(size=(1000, 3)).astype(np.float32)
        fn = str(tmp_path / "a.pcd")
        write_pcd(fn, pts, data_kind="binary")
        back = read_pcd(fn)
        np.testing.assert_array_equal(back, pts)

    def test_roundtrip_ascii(self, tmp_path, rng):
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        fn = str(tmp_path / "a.pcd")
        write_pcd(fn, pts, data_kind="ascii")
        back = read_pcd(fn)
        np.testing.assert_allclose(back, pts, atol=1e-5)

    def test_extra_fields_binary(self, tmp_path):
        # PCD with intensity field: x y z intensity
        pts = np.array([[1, 2, 3, 9], [4, 5, 6, 8]], dtype=np.float32)
        header = (
            "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
            "TYPE F F F F\nCOUNT 1 1 1 1\nWIDTH 2\nHEIGHT 1\n"
            "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS 2\nDATA binary\n"
        )
        fn = tmp_path / "i.pcd"
        with open(fn, "wb") as f:
            f.write(header.encode())
            f.write(pts.tobytes())
        back = read_pcd(str(fn))
        np.testing.assert_array_equal(back, pts[:, :3])

    def test_lzf_roundtrip_via_compressed_file(self, tmp_path, rng):
        # build a binary_compressed PCD by LZF-compressing SoA data
        n = 257
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        soa = np.concatenate([pts[:, 0], pts[:, 1], pts[:, 2]]).tobytes()
        comp = _lzf_compress(soa)
        header = (
            "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
            f"COUNT 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA binary_compressed\n"
        )
        fn = tmp_path / "c.pcd"
        with open(fn, "wb") as f:
            f.write(header.encode())
            f.write(np.array([len(comp), len(soa)], dtype=np.uint32).tobytes())
            f.write(comp)
        back = read_pcd(str(fn))
        np.testing.assert_array_equal(back, pts)

    def test_lzf_decompress_known(self):
        # literal-only stream: ctrl byte = len-1 then the bytes
        data = bytes([4]) + b"hello"
        assert lzf_decompress_py(data, 5) == b"hello"


def _lzf_compress(data: bytes) -> bytes:
    """Minimal LZF compressor (literal runs only — valid LZF, no back refs)."""
    out = bytearray()
    i = 0
    while i < len(data):
        run = min(32, len(data) - i)
        out.append(run - 1)
        out += data[i:i + run]
        i += run
    return bytes(out)


class TestTimeAssociation:
    def test_matches_bruteforce(self, rng):
        master = np.sort(rng.integers(0, 10**12, size=200))
        sensor = np.sort(rng.integers(0, 10**12, size=500))
        got = EurocDataset.get_closest_times(master, sensor)
        # oracle: the reference's argmin loop (eurocreader.py:128-144)
        expected = np.array([sensor[np.abs(sensor - t).argmin()] for t in master])
        np.testing.assert_array_equal(got, expected)

    def test_unsorted_sensor_times(self, rng):
        master = np.array([100, 200])
        sensor = np.array([250, 90, 180])
        got = EurocDataset.get_closest_times(master, sensor)
        np.testing.assert_array_equal(got, [90, 180])

    def test_get_df_at_times(self):
        df = pd.DataFrame({
            "#timestamp [ns]": [10, 20, 30],
            "x": [1.0, 2.0, 3.0], "y": 0.0, "z": 0.0,
            "qx": 0.0, "qy": 0.0, "qz": 0.0, "qw": 1.0,
        })
        out = EurocDataset.get_df_at_times(df, np.array([30, 10]))
        assert list(out["x"]) == [3.0, 1.0]


class TestSampling:
    def test_sample_times_semantics(self):
        # reference tools/sampling.py:39-58: keep >= delta spacing, always last
        times = np.arange(0, 10_000_000_001, 100_000_000)  # 0..10s at 10Hz
        out = sample_times(times, start_index=0, delta_time=1e9)
        assert out[0] == 0
        assert times[-1] in out
        assert np.all(np.diff(out) >= 1e9)

    def test_sample_times_start_index(self):
        times = np.arange(100) * int(1e9)
        out = sample_times(times, start_index=20, delta_time=1e9)
        assert out[0] == 20 * int(1e9)


class TestUTM:
    @staticmethod
    def _snyder_utm(lat_deg, lon_deg, zone):
        """Independent oracle: Snyder's USGS transverse-Mercator series."""
        lat = np.deg2rad(lat_deg)
        lon = np.deg2rad(lon_deg)
        lon0 = np.deg2rad(zone * 6.0 - 183.0)
        a = 6378137.0
        f = 1 / 298.257223563
        e2 = f * (2 - f)
        ep2 = e2 / (1 - e2)
        k0 = 0.9996
        N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
        T = np.tan(lat) ** 2
        C = ep2 * np.cos(lat) ** 2
        A = np.cos(lat) * (lon - lon0)
        M = a * ((1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256) * lat
                 - (3 * e2 / 8 + 3 * e2**2 / 32 + 45 * e2**3 / 1024) * np.sin(2 * lat)
                 + (15 * e2**2 / 256 + 45 * e2**3 / 1024) * np.sin(4 * lat)
                 - (35 * e2**3 / 3072) * np.sin(6 * lat))
        E = k0 * N * (A + (1 - T + C) * A**3 / 6
                      + (5 - 18 * T + T**2 + 72 * C - 58 * ep2) * A**5 / 120) + 500000
        Nn = k0 * (M + N * np.tan(lat) * (A**2 / 2
                   + (5 - T + 9 * C + 4 * C**2) * A**4 / 24
                   + (61 - 58 * T + T**2 + 600 * C - 330 * ep2) * A**6 / 720))
        return E, Nn

    def test_matches_snyder_series(self):
        cases = [
            (43.642566, -79.387057, 17),   # Toronto
            (38.275, -0.685, 30),          # Elche (ARVC region)
            (38.9, -1.1, 30),
            (0.5, -2.9, 30),               # near equator, zone edge
            (60.0, 5.0, 31),               # high latitude
        ]
        for lat, lon, zone in cases:
            e, n = latlon_to_utm(lat, lon, zone=zone)
            e_ref, n_ref = self._snyder_utm(lat, lon, zone)
            assert abs(e - e_ref) < 0.01, (lat, lon, e, e_ref)
            assert abs(n - n_ref) < 0.01, (lat, lon, n, n_ref)

    def test_elche_zone30(self):
        # UMH Elche campus (the ARVC datasets' region), zone 30
        e, n = latlon_to_utm(38.275, -0.685, zone=30)
        # sanity: within UTM easting bounds and northing for lat 38.3
        assert 600000 < e < 800000
        assert 4.2e6 < n < 4.3e6

    def test_gps2utm_offsets(self):
        df = pd.DataFrame({
            "#timestamp [ns]": [0, 1],
            "latitude": [38.275, 38.2751],
            "longitude": [-0.685, -0.685],
            "altitude": [100.0, 101.0],
        })
        ref = {"latitude": 38.275, "longitude": -0.685, "altitude": 100.0}
        out = gps2utm(df, ref)
        assert abs(out["x"][0]) < 1e-6 and abs(out["y"][0]) < 1e-6
        assert abs(out["altitude"][0]) < 1e-9
        # 1e-4 deg latitude is ~11.1 m north
        assert 10.5 < out["y"][1] < 11.7

    def test_filter_gps(self):
        df = pd.DataFrame({"latitude": [0.0, 38.0, 0.0], "longitude": [0, 1, 2],
                           "altitude": [0, 1, 2]})
        out = filter_gps(df)
        assert len(out["latitude"]) == 1 and out["latitude"][0] == 38.0


class TestCSVSchema:
    def test_trajectory_roundtrip(self, tmp_path, rng):
        from scipy.spatial.transform import Rotation as SR
        d = EurocDataset(str(tmp_path))
        n = 10
        T = np.tile(np.eye(4), (n, 1, 1))
        T[:, :3, :3] = SR.random(n, random_state=3).as_matrix()
        T[:, :3, 3] = rng.normal(size=(n, 3)) * 5
        times = np.arange(n) * int(1e9)
        d.save_transforms_as_csv(times, T, "/robot0/scanmatcher/scanmatcher_global.csv")
        times2, T2 = d.read_trajectory("/robot0/scanmatcher/scanmatcher_global.csv")
        np.testing.assert_array_equal(times2, times)
        np.testing.assert_allclose(T2, T, atol=1e-5)

    def test_schema_columns_match_reference(self, tmp_path):
        d = EurocDataset(str(tmp_path))
        T = np.eye(4)[None]
        d.save_transforms_as_csv(np.array([7]), T, "/robot0/scanmatcher/x.csv")
        df = pd.read_csv(str(tmp_path) + "/robot0/scanmatcher/x.csv")
        # reference writes an unnamed index column then these columns
        # (eurocreader.py:54-63)
        assert list(df.columns)[1:] == ["#timestamp [ns]", "x", "y", "z",
                                        "qx", "qy", "qz", "qw"]

    def test_loop_closures_csv(self, tmp_path):
        d = EurocDataset(str(tmp_path))
        d.save_loop_closures_as_csv([[[1, 2], [3, 4]], None, [[5, 6]]],
                                    "/robot0/SLAM/loop_closures.csv")
        df = pd.read_csv(str(tmp_path) + "/robot0/SLAM/loop_closures.csv")
        assert list(df["i"]) == [1, 3, 5]
        assert list(df["j"]) == [2, 4, 6]


class TestNativeLoader:
    """Native C++ PCD loader (built on demand; skipped without toolchain)."""

    @pytest.fixture(autouse=True)
    def _need_native(self):
        from lidar_slam_arvc_tpu.io import native
        if not native.available():
            pytest.skip("native toolchain unavailable")

    def test_binary_matches_python(self, tmp_path, rng):
        from lidar_slam_arvc_tpu.io import native
        pts = rng.normal(size=(3000, 3)).astype(np.float32)
        fn = str(tmp_path / "n.pcd")
        write_pcd(fn, pts)
        np.testing.assert_array_equal(native.read_pcd_xyz(fn, 4096), pts)
        np.testing.assert_array_equal(read_pcd(fn), pts)

    def test_lzf_matches_python(self, rng):
        from lidar_slam_arvc_tpu.io import native
        data = np.repeat(rng.integers(0, 40, 300),
                         rng.integers(1, 30, 300)).astype(np.uint8).tobytes()
        comp = _lzf_compress(data)
        assert native.lzf_decompress(comp, len(data)) == data
        assert lzf_decompress_py(comp, len(data)) == data

    def test_batch_threaded(self, tmp_path, rng):
        from lidar_slam_arvc_tpu.io import native
        paths = []
        clouds = []
        for i in range(6):
            pts = rng.normal(size=(100 + 10 * i, 3)).astype(np.float32)
            fn = str(tmp_path / f"{i}.pcd")
            write_pcd(fn, pts)
            paths.append(fn)
            clouds.append(pts)
        out, counts = native.read_pcd_batch(paths, 256, n_threads=3)
        for i in range(6):
            assert counts[i] == len(clouds[i])
            np.testing.assert_array_equal(out[i, :counts[i]], clouds[i])

    def test_capacity_truncation(self, tmp_path, rng):
        from lidar_slam_arvc_tpu.io import native
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        fn = str(tmp_path / "t.pcd")
        write_pcd(fn, pts)
        out = native.read_pcd_xyz(fn, 40)
        np.testing.assert_array_equal(out, pts[:40])
