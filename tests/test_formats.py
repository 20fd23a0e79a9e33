"""io.formats: CSV tables and parameter YAML, with pandas and PyYAML as
oracles, plus the main path running with neither importable."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

from lidar_slam_arvc_tpu.io import formats

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tables():
    rng = np.random.default_rng(5)
    n = 40
    vals = rng.normal(size=n) * 10.0 ** rng.integers(-9, 12, n)
    vals[[3, 7]] = [np.nan, np.inf]
    return {
        "trajectory": ({
            "#timestamp [ns]": 1_600_000_000_000_000_000
            + np.arange(n, dtype=np.int64) * 10 ** 8,
            "x": rng.normal(size=n) * 30, "y": rng.normal(size=n),
            "z": np.zeros(n), "qx": rng.uniform(-1, 1, n),
            "qy": rng.uniform(-1, 1, n), "qz": rng.uniform(-1, 1, n),
            "qw": np.ones(n)}, True),
        "times_only": ({"#timestamp [ns]": np.arange(n) * 10 ** 9}, False),
        "extreme_floats": ({"v": vals, "f32": vals.astype(np.float32)},
                           True),
        "loop_pairs": ({"i": np.array([5, 5, 9]), "j": np.array([1, 2, 3])},
                       True),
        "no_rows": ({"i": np.zeros(0, np.int64),
                     "j": np.zeros(0, np.int64)}, True),
    }


@pytest.mark.parametrize("name", list(_tables()))
def test_csv_write_matches_pandas_bytes(tmp_path, name):
    table, index = _tables()[name]
    formats.write_csv(str(tmp_path / "ours.csv"), table, index=index)
    pd.DataFrame(table).to_csv(str(tmp_path / "pandas.csv"), index=index)
    assert (tmp_path / "ours.csv").read_bytes() == \
        (tmp_path / "pandas.csv").read_bytes()


@pytest.mark.parametrize("name", list(_tables()))
def test_csv_read_matches_pandas(tmp_path, name):
    table, index = _tables()[name]
    path = str(tmp_path / "t.csv")
    pd.DataFrame(table).to_csv(path, index=index)
    ours = formats.read_csv(path)
    # pandas' default float parser is not correctly rounded; ours is
    # (Python float), as is pandas' round_trip parser
    theirs = pd.read_csv(path, float_precision="round_trip")
    assert list(ours) == list(theirs.columns)
    for col in ours:
        a, b = ours[col], theirs[col].to_numpy()
        if len(a):
            assert a.dtype.kind == b.dtype.kind, col
        np.testing.assert_array_equal(a, b)


def test_csv_read_roundtrips_exactly(tmp_path):
    table, _ = _tables()["trajectory"]
    path = str(tmp_path / "t.csv")
    formats.write_csv(path, table)
    back = formats.read_csv(path)
    assert list(back) == ["Unnamed: 0"] + list(table)
    for col in table:
        np.testing.assert_array_equal(back[col], table[col])


def test_csv_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        formats.read_csv(str(tmp_path / "none.csv"))


def test_table_helpers():
    t = {"a": np.arange(5), "b": np.arange(5) * 2.0}
    assert formats.n_rows(t) == 5
    assert formats.n_rows(pd.DataFrame(t)) == 5
    sub = formats.take_rows(pd.DataFrame(t), np.array([4, 0]))
    np.testing.assert_array_equal(sub["b"], [8.0, 0.0])
    np.testing.assert_array_equal(formats.columns(t, ["b", "a"])[1], [2, 1])


# Parameter files as the synthetic datasets and the reference write them.
_YAML_VALUES = {
    "scanmatcher": {"start_index": 0, "delta_time": 1.0, "voxel_size": None,
                    "method": "icppointplane"},
    "slam": {"perform_loop_closing": True, "method": "icppointplane",
             "skip_loop_closing": 8, "skip_optimization": 8,
             "number_of_triplets_loop_closing": 6, "radius_threshold": 7.0,
             "distance_backwards": 7.0,
             "visualization_keyframe_sampling": 10},
    "gps_reference": {"latitude": 38.275, "longitude": -0.685,
                      "altitude": 100.0},
    "transform_flat": {"transform": np.eye(4).reshape(-1).tolist()},
    "transform_rows": {"transform": [[0.99, -0.1, 0.0, 0.1],
                                     [0.1, 0.99, 0.0, -0.2],
                                     [0.0, 0.0, 1.0, 0.85],
                                     [0.0, 0.0, 0.0, 1.0]]},
    "icp_parameters": {"down_sample": {"voxel_size": 0.1},
                       "filter_by_radius": {"max_radius": 35,
                                            "min_radius": 0.5},
                       "filter_by_height": {"max_height": 50.0,
                                            "min_height": -1.0},
                       "icp": {"distance_threshold": 1e-05},
                       "names": ["a b", "yes", "-x", ""],
                       "empty": {}, "none": []},
}


@pytest.mark.parametrize("name", list(_YAML_VALUES))
def test_yaml_dump_matches_safe_dump_bytes(tmp_path, name):
    value = _YAML_VALUES[name]
    formats.dump_yaml(value, str(tmp_path / "ours.yaml"))
    with open(tmp_path / "pyyaml.yaml", "w") as f:
        yaml.safe_dump(value, f)
    assert (tmp_path / "ours.yaml").read_text() == \
        (tmp_path / "pyyaml.yaml").read_text()


@pytest.mark.parametrize("name", list(_YAML_VALUES))
def test_yaml_load_matches_safe_load(tmp_path, name):
    path = tmp_path / "p.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(_YAML_VALUES[name], f)
    assert formats.load_yaml(str(path)) == yaml.safe_load(path.read_text())


# Hand-written files in the reference's style: comments, flow sequences
# across lines, YAML 1.1 booleans, quoted strings.
_HAND_WRITTEN = [
    "# ICP parameters\ndown_sample:\n  voxel_size: 0.2  # metres\n"
    "filter_by_radius:\n    max_radius: 35\n    min_radius: .5\n",
    "transform: [1, 0, 0, 0.1,\n            0, 1, 0, -0.2,\n"
    "            0, 0, 1, 0.85,\n            0, 0, 0, 1]\n",
    "flags: {}\na: yes\nb: Off\nc: ~\nd: 'it''s'\ne: \"tab\\t\"\n"
    "f: 1e-5\ng: -.inf\nh: 1_000\ni: 0.5e+3\nj: text # note\n",
    "seq:\n  - 1\n  - [2, 3]\n  - - 4\n    - 5\n  - k: v\n    l: 2\n",
]


@pytest.mark.parametrize("text", _HAND_WRITTEN)
def test_yaml_load_hand_written(tmp_path, text):
    path = tmp_path / "h.yaml"
    path.write_text(text)
    assert formats.load_yaml(str(path)) == yaml.safe_load(text)


def test_dataset_files_match_pyyaml_and_pandas(tmp_path):
    """Every parameter YAML and CSV a synthetic dataset writes reads the
    same through io.formats as through PyYAML / pandas."""
    from lidar_slam_arvc_tpu.utils import synthetic
    synthetic.make_dataset(str(tmp_path), n_scans=4, scan_points=50)
    seen = 0
    for root, _, files in os.walk(tmp_path):
        for name in files:
            path = os.path.join(root, name)
            if name.endswith(".yaml"):
                with open(path) as f:
                    assert formats.load_yaml(path) == yaml.safe_load(f)
                seen += 1
            elif name.endswith(".csv"):
                ours = formats.read_csv(path)
                theirs = pd.read_csv(path, float_precision="round_trip")
                assert list(ours) == list(theirs.columns)
                for col in ours:
                    np.testing.assert_array_equal(ours[col],
                                                  theirs[col].to_numpy())
                seen += 1
    assert seen == 8


_NO_PANDAS_RUN = """
import sys
sys.modules["pandas"] = None      # any import of either now fails
sys.modules["yaml"] = None
from lidar_slam_arvc_tpu.pipeline import cli
from lidar_slam_arvc_tpu.utils import synthetic
synthetic.make_dataset(sys.argv[1], n_scans=6, scan_points=600,
                       scanmatcher_params={"voxel_size": 0.3},
                       slam_params={"skip_loop_closing": 2,
                                    "skip_optimization": 2})
sys.exit(cli.main(["run", "-i", sys.argv[1], "--capacity", "512",
                   "--batch-size", "2"]))
"""


def test_cli_run_without_pandas_or_yaml(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    out = subprocess.run(
        [sys.executable, "-c", _NO_PANDAS_RUN, str(tmp_path / "d")],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    for f in ("scanmatcher/scanmatcher_global.csv",
              "SLAM/solution_graphslam.csv"):
        assert os.path.isfile(tmp_path / "d" / "robot0" / f)
