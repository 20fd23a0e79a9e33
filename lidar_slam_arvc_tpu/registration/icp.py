"""ICP on SE(3): point-to-point, point-to-plane, and the two-planes fusion.

Replaces Open3D's C++ ``registration_icp`` (reference keyframe.py:231-295).
Direction convention matches the reference: ``icp(src=cloud_j, tgt=cloud_i,
T_init=T_ij)`` returns the refined T_i_j that maps points of scan j into
scan i's frame (reference keyframemanager.py:52-75, "aTb").

Structure (one fused jitted program per pair, batchable by vmap):
  * correspondences from the exact brute-force nearest-neighbor sweep
    (ops.nearest_neighbors: a fused kernel on the GPU, a tiled XLA sweep
    elsewhere) gated by ``max_correspondence_distance`` (10 m —
    reference config/icp_parameters.yaml:20-22),
  * a Gauss-Newton step on the se(3) left perturbation per iteration; the
    6x6 normal equations are built as (6,N)x(N,6) matmuls,
  * iterations under ``lax.while_loop`` with an update-norm early exit
    (static shapes; the trip count is bounded by ``max_iterations``).

Residuals/Jacobians (xi = [w, v], T' = exp(xi) T):
  point-to-plane: r = n . (p' - q),      J = [p' x n, n]
  point-to-point: r = p' - q (3-vec),    J = [-[p']_x, I3]
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import geom
from lidar_slam_arvc_tpu.cloud import Cloud
from lidar_slam_arvc_tpu.ops import nearest_neighbors

_HI = jax.lax.Precision.HIGHEST


class ICPParams(NamedTuple):
    max_correspondence_distance: float = 10.0
    max_iterations: int = 30
    # tiles of the XLA correspondence sweep (ops.nn.nn_search); the GPU
    # kernel uses its own blocks
    src_block: int = 1024
    tgt_block: int = 2048
    # Robust (Welsch) IRLS weighting with a scale adapted to the current
    # residual distribution.  Plain Open3D-style ICP (the reference's
    # behavior) weights every gated correspondence equally, which biases the
    # estimate wherever scans only partially overlap (range boundaries,
    # occlusions); the adaptive kernel anneals those out as the fit
    # tightens.  Set robust=False for strict reference parity.
    robust: bool = True
    # Early exit: stop when the se(3) update norm falls below this
    # (Open3D's criteria stop on relative fitness/rmse 1e-6 similarly;
    # reference keyframe.py:246-252 uses the defaults).  Under vmap the
    # batch runs until every pair converges.  0 disables early exit.
    # Default 1e-4 (~0.1 mm updates) sits 10x below the scan-noise accuracy
    # floor while cutting the post-convergence iteration tail; at 1e-5 the
    # exit hovers on a knife edge where sub-noise normal perturbations
    # cost extra iterations.
    convergence_tol: float = 1e-4
    # Coarse-to-fine: run up to ``coarse_iterations`` first with the source
    # statically strided by ``coarse_factor``, then refine at full
    # resolution.  Disabled by default (it doubles the compile time);
    # available for bad-seed/large-motion regimes.
    coarse_factor: int = 1
    coarse_iterations: int = 0
    # Final fitness/inlier_rmse: False (default) reports the metrics of the
    # LAST iteration's correspondence set (one se(3) update behind the
    # returned transform — indistinguishable below convergence_tol), saving
    # one full NN sweep per solve, a large share of a solve that converges
    # in 2-3 iterations.  True recomputes at the final
    # transform (Open3D evaluate_registration semantics).  For a
    # max_iterations exit the carried metrics predate a possibly-large last
    # update — divergence detection must gate on ICPResult.final_delta, as
    # the scanmatcher pipeline does.
    exact_metrics: bool = False
    # Persistent source subsampling: stride the source cloud by this factor
    # for the ENTIRE solve (unlike coarse-to-fine, no full-resolution refine
    # phase).  The NN sweep is O(S*T) and dominates per-iteration cost,
    # so stride f cuts sweep time ~f x.
    # Point-to-plane stays hugely overdetermined (6 DOF from thousands of
    # correspondences); the voxel grid already decorrelates neighbors, so a
    # uniform stride is an unbiased spatial subsample.  Final
    # fitness/inlier_rmse are reported over the strided set.  1 = reference
    # parity (all points, keyframe.py:250-252).
    source_stride: int = 1


class ICPResult(NamedTuple):
    transform: jax.Array      # (4,4) refined T mapping src into tgt frame
    fitness: jax.Array        # inlier fraction of valid source points
    inlier_rmse: jax.Array    # RMSE over inlier correspondences
    # while_loop trips (diagnostics); plain-int default so importing this
    # module never touches the JAX backend (a jnp default would initialize
    # the device plugin at import time)
    iterations: jax.Array | int = 0
    # se(3) update norm of the LAST iteration: <= convergence_tol means the
    # solve exited converged; large values mean it hit max_iterations while
    # still moving (the pipeline's divergence gate uses this, since with
    # exact_metrics=False fitness is measured one update behind)
    final_delta: jax.Array | float = 0.0


def _gn_step_point_to_plane(p, n_corr, q, w):
    """(H, b) for point-to-plane residuals; w gates invalid correspondences."""
    r = jnp.sum(n_corr * (p - q), axis=-1)
    Jw = jnp.cross(p, n_corr)
    J = jnp.concatenate([Jw, n_corr], axis=-1)  # (N, 6)
    Jw_ = J * w[:, None]
    H = jnp.dot(Jw_.T, J, precision=_HI)
    b = -jnp.dot(Jw_.T, r, precision=_HI)
    return H, b, r


def _gn_step_point_to_point(p, q, w):
    """(H, b) for 3-vector point-to-point residuals."""
    r = p - q  # (N, 3)
    # J_i = [-[p]_x | I]; accumulate H = sum J^T J, b = -sum J^T r in closed
    # form to avoid materializing (N, 3, 6).
    px = geom.so3_hat(p)                       # (N,3,3) = [p]_x
    # J^T r: rotation part = [p]_x r (since (-[p]_x)^T r = [p]_x r),
    # translation part = r
    w1 = w[:, None]
    bw = -jnp.sum(jnp.einsum("nij,nj->ni", px, r, precision=_HI) * w1, axis=0)
    bv = -jnp.sum(r * w1, axis=0)
    # H blocks: Hww = sum [p]_x^T [p]_x = -sum [p]_x [p]_x,
    #           Hwv = sum (-[p]_x)^T = sum [p]_x, Hvv = sum(w) I
    pxw = px * w[:, None, None]
    Hww = -jnp.einsum("nij,njk->ik", pxw, px, precision=_HI)
    Hwv = jnp.sum(pxw, axis=0)
    n_eff = jnp.sum(w)
    Hvv = n_eff * jnp.eye(3, dtype=p.dtype)
    H = jnp.block([[Hww, Hwv], [Hwv.T, Hvv]])
    b = jnp.concatenate([bw, bv])
    rnorm = jnp.linalg.norm(r, axis=-1)
    return H, b, rnorm


@functools.partial(jax.jit, static_argnames=("params", "method"))
def icp(src: Cloud, tgt: Cloud, T_init: jax.Array,
        params: ICPParams = ICPParams(),
        method: str = "point_to_plane") -> ICPResult:
    """Refine T_init so that T @ src aligns with tgt.

    For 'point_to_plane' the target must carry ``normals``
    (cloud.estimate_normals), matching the reference's preprocessing
    (keyframe.py:156-162).
    """
    if method == "point_to_plane" and tgt.normals is None:
        raise ValueError("point_to_plane ICP needs target normals")

    tgt_pts, tgt_mask = tgt.points, tgt.mask
    src_points, src_mask = src.points, src.mask
    if params.source_stride > 1:
        src_points = src_points[::params.source_stride]
        src_mask = src_mask[::params.source_stride]
    tgt_normals = tgt.normals if tgt.normals is not None else jnp.zeros_like(tgt.points)

    def nn(p, tpts, tmask):
        return nearest_neighbors(p, tpts, tmask, src_block=params.src_block,
                                 tgt_block=params.tgt_block)

    thr2 = params.max_correspondence_distance ** 2
    src_pts = src_points
    src_mask_f = src_mask.astype(src_pts.dtype)

    def correspond(p):
        """(d2, q, n_corr) for each transformed source point."""
        idx, d2 = nn(p, tgt_pts, tgt_mask)
        return d2, tgt_pts[idx], tgt_normals[idx]

    def make_step(pts, mask_f):
        def step(T):
            p = geom.transform_points(T, pts)
            d2, q, n_corr = correspond(p)
            gate = mask_f * (d2 <= thr2).astype(pts.dtype)
            # metrics of THIS correspondence set (gate-only, matching the
            # final-metrics definition); carried out by the caller so the
            # converged solve needs no extra sweep
            n_src = jnp.maximum(jnp.sum(mask_f), 1.0)
            n_in = jnp.sum(gate)
            fit = n_in / n_src
            rmse = jnp.sqrt(jnp.sum(d2 * gate) / jnp.maximum(n_in, 1.0))
            w = gate
            if params.robust:
                # Welsch IRLS: scale from the gated mean-square distance,
                # sharpened once by reweighting (two cheap passes, no new NN).
                sigma2 = jnp.sum(w * d2) / jnp.maximum(jnp.sum(w), 1.0)
                w1 = w * jnp.exp(-d2 / jnp.maximum(2.0 * sigma2, 1e-8))
                sigma2 = jnp.sum(w1 * d2) / jnp.maximum(jnp.sum(w1), 1e-6)
                w = w * jnp.exp(-d2 / jnp.maximum(2.0 * sigma2, 1e-8))
            if method == "point_to_plane":
                H, b, _ = _gn_step_point_to_plane(p, n_corr, q, w)
            else:
                H, b, _ = _gn_step_point_to_point(p, q, w)
            # Tikhonov floor keeps degenerate geometry (no constraints
            # along an axis) from blowing up the solve.
            damp = 1e-6 * (jnp.trace(H) / 6.0 + 1.0)
            xi = jnp.linalg.solve(H + damp * jnp.eye(6, dtype=H.dtype), b)
            # guard: non-finite solve keeps T unchanged
            xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros_like(xi))
            return (geom.compose(geom.se3_exp(xi), T), jnp.linalg.norm(xi),
                    fit, rmse)
        return step

    def run_phase(T0, step, max_iters, tol):
        init_metrics = (jnp.float32(0.0), jnp.float32(jnp.inf))
        if params.convergence_tol > 0:
            def cond(state):
                _, it, delta, _, _ = state
                return (it < max_iters) & (delta > tol)

            def while_body(state):
                T, it, _, _, _ = state
                T_new, delta, fit, rmse = step(T)
                return T_new, it + 1, delta, fit, rmse

            T, it, delta, fit, rmse = jax.lax.while_loop(
                cond, while_body,
                (T0, jnp.int32(0), jnp.float32(jnp.inf), *init_metrics))
            return T, it, delta, fit, rmse

        def fori_body(_, carry):
            T, _, _, _ = carry
            T_new, delta, fit, rmse = step(T)
            return T_new, delta, fit, rmse

        T, delta, fit, rmse = jax.lax.fori_loop(
            0, max_iters, fori_body,
            (T0, jnp.float32(0.0), *init_metrics), unroll=False)
        return T, jnp.int32(max_iters), delta, fit, rmse

    T = T_init
    iters = jnp.int32(0)
    fine_iters = params.max_iterations
    if params.coarse_factor > 1 and params.coarse_iterations > 0:
        f = params.coarse_factor
        coarse_step = make_step(src_pts[::f], src_mask_f[::f])
        T, it_c, _, _, _ = run_phase(T, coarse_step,
                                     params.coarse_iterations,
                                     10.0 * params.convergence_tol)
        iters = iters + it_c
    T, it_f, final_delta, fitness, rmse = run_phase(
        T, make_step(src_pts, src_mask_f), fine_iters,
        params.convergence_tol)
    iters = iters + it_f
    # zero iterations (max_iterations=0 evaluate-only, or the while_loop's
    # cond failing immediately) must read as converged, not as the +inf
    # delta initializer — otherwise the divergence gate
    # (final_delta > 100*tol) flags every evaluate-only result
    final_delta = jnp.where(it_f > 0, final_delta, 0.0)

    if params.exact_metrics or params.max_iterations == 0:
        # recompute at the final transform (Open3D evaluate_registration
        # semantics); forced for max_iterations=0, where the loop never ran
        # and the carried metrics would be the (0, inf) initializers
        p = geom.transform_points(T, src_pts)
        d2, _, _ = correspond(p)
        inlier = src_mask_f * (d2 <= thr2).astype(src_pts.dtype)
        n_src = jnp.maximum(jnp.sum(src_mask_f), 1.0)
        n_in = jnp.sum(inlier)
        fitness = n_in / n_src
        rmse = jnp.sqrt(jnp.sum(d2 * inlier) / jnp.maximum(n_in, 1.0))
    return ICPResult(transform=T, fitness=fitness, inlier_rmse=rmse,
                     iterations=iters, final_delta=final_delta)


def icp_batch(src_points, src_masks, tgt_points, tgt_masks, tgt_normals,
              T_inits, params: ICPParams = ICPParams(),
              method: str = "point_to_plane"):
    """vmap of :func:`icp` over a leading batch of scan pairs.

    This is the data-parallel unit the scanmatcher pipeline shards over the
    device mesh: consecutive (i, i+1) pairs are independent given their
    odometry seeds (SURVEY.md §2.3).
    """
    def one(sp, sm, tp, tm, tn, T0):
        return icp(Cloud(sp, sm), Cloud(tp, tm, tn), T0, params, method)

    return jax.vmap(one)(src_points, src_masks, tgt_points, tgt_masks,
                         tgt_normals, T_inits)


@functools.partial(jax.jit, static_argnames=("params",))
def icp_two_planes(src_ground: Cloud, tgt_ground: Cloud,
                   src_nonground: Cloud, tgt_nonground: Cloud,
                   T_init: jax.Array,
                   params: ICPParams = ICPParams()) -> ICPResult:
    """Two-phase point-to-plane ICP fused per-component.

    Reference keyframe.py:262-295 (local_registration_two_planes): run
    point-to-plane ICP separately on the ground-plane clouds (solution t1)
    and the non-ground clouds (t2), then fuse [tx,ty,gamma] from t2 with
    [tz,alpha,beta] from t1 — the ground constrains height/tilt, the
    structure constrains planar motion and heading.
    """
    res_a = icp(src_ground, tgt_ground, T_init, params, "point_to_plane")
    res_b = icp(src_nonground, tgt_nonground, T_init, params, "point_to_plane")
    t1 = geom.t2v(res_a.transform)
    t2 = geom.t2v(res_b.transform)
    fused = jnp.stack([t2[0], t2[1], t1[2]])
    abg = jnp.stack([t1[3], t1[4], t2[5]])
    T = geom.transform_from_euler(fused, abg)
    return ICPResult(transform=T, fitness=res_b.fitness,
                     inlier_rmse=res_b.inlier_rmse,
                     iterations=res_a.iterations + res_b.iterations,
                     final_delta=jnp.maximum(res_a.final_delta,
                                             res_b.final_delta))
