"""Micro-probe: which piece of the dense H assembly is slow on the device.

Variants, each timed as a REPS-chained jitted program (large arrays passed
as ARGUMENTS — closed-over concrete arrays become program literals):

  onehot      build the (N, E) selection matrices
  d_einsum    block-diagonal accumulation via einsum('pe,eab->pab')
  d_matmul    same as (N,E) @ (E,36) jnp.matmul + reshape
  off_scatter off-diagonal (E,6,6) blocks into (N,N,6,6) windows
  off_fancy   the r3 formulation: fancy-index scatter into (6N,6N)
  expand      (N,N,6,6) -> transpose -> (6N,6N) reshape
  full        _assemble as shipped

Usage: python benchmarks/assemble_probe.py [N_POSES] [REPS]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_POSES = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
REPS = int(sys.argv[2]) if len(sys.argv) > 2 else 10


def main():
    import jax
    import jax.numpy as jnp
    from benchmarks.graph_roofline import build_graph
    from lidar_slam_arvc_tpu.graph.solver import (
        _assemble, _between_residuals, _block_indices, _onehot)

    _HI = jax.lax.Precision.HIGHEST
    g = build_graph(N_POSES)
    poses = jnp.asarray(g.poses)
    f = g._factor_data()
    n_active = jnp.asarray(g.n_poses, dtype=jnp.int32)
    N = poses.shape[0]
    E = f.bt_i.shape[0]

    # precompute edge blocks once (host side of the probe)
    r, A, B = _between_residuals(poses, f)
    w2 = f.bt_winv ** 2
    AtW = jnp.swapaxes(A, -1, -2) * w2[:, None, :]
    BtW = jnp.swapaxes(B, -1, -2) * w2[:, None, :]
    Hii = jnp.einsum("eab,ebc->eac", AtW, A, precision=_HI)
    Hij = jnp.einsum("eab,ebc->eac", AtW, B, precision=_HI)
    Hjj = jnp.einsum("eab,ebc->eac", BtW, B, precision=_HI)

    def chain(fn, x0, *consts):
        @jax.jit
        def run(x, *cs):
            def body(_, c):
                return fn(c, *cs)
            return jax.lax.fori_loop(0, REPS, body, x)
        out = run(x0, *consts)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[0])
        t0 = time.time()
        out = run(x0, *consts)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[0])
        return (time.time() - t0) / REPS * 1e3

    res = {"n_poses": N_POSES, "n_between": int(E), "reps": REPS}

    oi = _onehot(f.bt_i, N, poses.dtype)
    oj = _onehot(f.bt_j, N, poses.dtype)

    res["onehot_ms"] = round(chain(
        lambda c, bi: (_onehot(bi + (c[0][0, 0] > 2).astype(bi.dtype), N,
                               jnp.float32),),
        (oi,), f.bt_i), 3)

    res["d_einsum_ms"] = round(chain(
        lambda c, o, h: (jnp.einsum("pe,eab->pab",
                                    o, h + 1e-12 * c[0][0, 0, 0],
                                    precision=_HI),),
        (jnp.zeros((N, 6, 6)),), oi, Hii), 3)

    res["d_matmul_ms"] = round(chain(
        lambda c, o, h: (jnp.matmul(
            o, (h + 1e-12 * c[0][0, 0, 0]).reshape(E, 36),
            precision=_HI).reshape(N, 6, 6),),
        (jnp.zeros((N, 6, 6)),), oi, Hii), 3)

    res["off_scatter_ms"] = round(chain(
        lambda c, bi, bj, h: (jnp.zeros((N, N, 6, 6), poses.dtype)
                              .at[bi, bj].add(h + 1e-12 * c[0][0, 0, 0, 0])
                              .at[bj, bi].add(jnp.swapaxes(h, -1, -2)),),
        (jnp.zeros((N, N, 6, 6)),), f.bt_i, f.bt_j, Hij), 3)

    def off_fancy(c, bi, bj, h):
        N6 = N * 6
        H = jnp.zeros((N6, N6), poses.dtype)
        ri = _block_indices(bi)
        rj = _block_indices(bj)
        h = h + 1e-12 * c[0][0, 0]
        H = H.at[ri[:, :, None], rj[:, None, :]].add(h)
        H = H.at[rj[:, :, None], ri[:, None, :]].add(
            jnp.swapaxes(h, -1, -2))
        return (H,)
    res["off_fancy_ms"] = round(chain(
        off_fancy, (jnp.zeros((N * 6, N * 6)),), f.bt_i, f.bt_j, Hij), 3)

    res["expand_ms"] = round(chain(
        lambda c, h4: ((h4 + 1e-12 * c[0][0, 0]).transpose(0, 2, 1, 3)
                       .reshape(N * 6, N * 6),),
        (jnp.zeros((N * 6, N * 6)),), jnp.zeros((N, N, 6, 6))), 3)

    # diagonal accumulation via scatter into the SMALL (N, 36) array
    res["d_smallscatter_ms"] = round(chain(
        lambda c, bi, h: (jnp.zeros((N, 36), poses.dtype)
                          .at[bi].add((h + 1e-12 * c[0][0, 0])
                                      .reshape(E, 36)),),
        (jnp.zeros((N, 36)),), f.bt_i, Hii), 3)

    from lidar_slam_arvc_tpu.graph.solver import _expand_block_diag
    res["expand_eye_ms"] = round(chain(
        lambda c, d: (_expand_block_diag(d + 1e-12 * c[0][0, 0]),),
        (jnp.zeros((N * 6, N * 6)),), jnp.zeros((N, 6, 6))), 3)

    res["full_assemble_ms"] = round(chain(
        lambda c, p: _assemble(p + 1e-12 * c[1][0], f, n_active),
        _assemble(poses, f, n_active), poses), 3)

    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
