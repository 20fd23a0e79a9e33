"""Stage 1 end to end with the fused GPU kernels vs XLA's plain sweeps.

Runs ``scanmatch`` (PCD load, crop, normals, batched ICP) on the synthetic
200-scan x 20k-point outdoor loop twice per variant, in the order
xla, kernel, kernel, xla.  Each variant starts from cleared JAX caches;
its first run compiles and is discarded, the second is reported.  The
"xla" variant routes ops.select.on_gpu to the plain branch, so both run
the same pipeline code on the same card.

    python benchmarks/kernel_ab.py

Prints one JSON line per measured run, each naming the card.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax
    from lidar_slam_arvc_tpu.ops import select
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher
    from lidar_slam_arvc_tpu.utils import synthetic
    from lidar_slam_arvc_tpu.utils.profiling import setup_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_ab: needs a GPU")
    setup_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    d = tempfile.mkdtemp(prefix="kernel_ab_")
    try:
        synthetic.make_outdoor_loop_dataset(d)
        for variant in ("xla", "kernel", "kernel", "xla"):
            patch = (mock.patch.object(select, "on_gpu",
                                       lambda kernel, plain, *a: plain(*a))
                     if variant == "xla" else contextlib.nullcontext())
            with patch:
                jax.clear_caches()
                for rep in range(2):
                    t0 = time.perf_counter()
                    out = run_scanmatcher(d, progress=False)
                    wall = time.perf_counter() - t0
                with open(f"{d}/robot0/viz/scanmatcher_profile.json") as f:
                    prof = json.load(f)
            print(json.dumps({
                "card": card, "variant": variant, "stage1_wall_s": wall,
                "load_preprocess_s": prof["load_preprocess_seconds"],
                "icp_s": prof["icp_seconds"],
                "frames_per_second": out["frames_per_second"]}), flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
