"""Batch Gauss-Newton / Levenberg-Marquardt pose-graph solver.

Replaces GTSAM's ISAM2 incremental solve (reference graphSLAM.py:74-105)
with batch re-solves at the same cadence: all residuals/Jacobians in one
vmapped evaluation, normal equations assembled by scatter-add into a dense
(6N, 6N) system (these graphs are hundreds-to-thousands of poses; dense
Cholesky beats sparse bookkeeping at this scale), LM damping with
accept/reject on the true cost.

Jacobians are closed-form with the standard first-order inverse-right-
Jacobian approximation Jr^-1(r) ~= I + ad(r)/2 — exact at the optimum
(r -> 0), standard in g2o-class solvers.

The active pose count is dynamic (n_active) under a static capacity so one
compile serves the whole incremental SLAM run; inactive poses are pinned by
identity-prior rows with tiny weight added implicitly via mask handling.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import geom
from lidar_slam_arvc_tpu.geom.rotations import so3_hat
from lidar_slam_arvc_tpu.graph.factors import FactorData

_HI = jax.lax.Precision.HIGHEST


def _adjoint(T: jax.Array) -> jax.Array:
    """SE(3) adjoint for xi=[w,v]: Ad(T) = [[R,0],[[t]x R, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tx = so3_hat(t)
    top = jnp.concatenate([R, jnp.zeros_like(R)], axis=-1)
    bottom = jnp.concatenate([tx @ R, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def _ad_se3(xi: jax.Array) -> jax.Array:
    """se(3) adjoint (little ad): [[ [w]x, 0],[ [v]x, [w]x ]]."""
    w = xi[..., :3]
    v = xi[..., 3:]
    wx = so3_hat(w)
    vx = so3_hat(v)
    top = jnp.concatenate([wx, jnp.zeros_like(wx)], axis=-1)
    bottom = jnp.concatenate([vx, wx], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def _jr_inv(r: jax.Array) -> jax.Array:
    """First-order inverse right Jacobian of SE(3): I + ad(r)/2."""
    eye = jnp.broadcast_to(jnp.eye(6, dtype=r.dtype), r.shape[:-1] + (6, 6))
    return eye + 0.5 * _ad_se3(r)


def _between_residuals(poses, f: FactorData):
    """(r (E,6), A (E,6,6), B (E,6,6)) for all between factors."""
    Ti = poses[f.bt_i]
    Tj = poses[f.bt_j]
    Tij = geom.compose(geom.inverse(Ti), Tj)
    E = geom.compose(geom.inverse(f.bt_T), Tij)
    r = geom.se3_log(E)
    Jri = _jr_inv(r)
    B = Jri
    A = -jnp.einsum("eab,ebc->eac", Jri, _adjoint(geom.inverse(Tij)),
                    precision=_HI)
    return r, A, B


def _gps_residuals(poses, f: FactorData):
    """(r (G,3), J (G,3,6)) for GPS unary factors: r = t(X_i) - z."""
    Ti = poses[f.gps_i]
    r = Ti[..., :3, 3] - f.gps_z
    # right perturbation: dt = R_i dv -> J = [0 | R_i]
    J = jnp.concatenate([jnp.zeros_like(Ti[..., :3, :3]), Ti[..., :3, :3]],
                        axis=-1)
    return r, J


def _prior_residuals(poses, f: FactorData):
    Ti = poses[f.pr_i]
    E = geom.compose(geom.inverse(f.pr_T), Ti)
    r = geom.se3_log(E)
    J = _jr_inv(r)
    return r, J


@functools.partial(jax.jit, static_argnames=())
def graph_cost(poses: jax.Array, factors: FactorData) -> jax.Array:
    """0.5 * sum of squared whitened residuals over active factors."""
    r_b, _, _ = _between_residuals(poses, factors)
    r_g, _ = _gps_residuals(poses, factors)
    r_p, _ = _prior_residuals(poses, factors)
    cb = jnp.sum((r_b * factors.bt_winv) ** 2)
    cg = jnp.sum((r_g * factors.gps_winv) ** 2)
    cp = jnp.sum((r_p * factors.pr_winv) ** 2)
    return 0.5 * (cb + cg + cp)


def _block_indices(idx: jax.Array):
    """(E,) pose indices -> (E,6) row indices into the flat 6N state."""
    return idx[:, None] * 6 + jnp.arange(6, dtype=idx.dtype)[None, :]


def _onehot(idx: jax.Array, n: int, dtype) -> jax.Array:
    """(P, E) selection matrix: out[p, e] = 1 iff idx[e] == p.

    Block-DIAGONAL accumulations run as one-hot matmuls instead
    of colliding-index scatter-adds (which XLA serializes).  Exact in f32:
    each output element is a sum of selected addends (no scaling), done at
    Precision.HIGHEST.
    """
    return (idx[None, :] == jnp.arange(n, dtype=idx.dtype)[:, None]).astype(dtype)


def _expand_block_diag(D: jax.Array) -> jax.Array:
    """(N, 6, 6) diagonal blocks -> dense (6N, 6N) with NO scatter.

    Layout is everything here (benchmarks/assemble_probe.py, 1024 poses):
    any intermediate whose minor dimension is 6 wastes most of each wide
    vector tile, as do an (N,6,N,6)-shaped broadcast-vs-eye expansion and
    an (N,N,6,6) transpose.  This version works at (6N, 6N) the whole way: `tile` repeats the (6N, 6)
    row blocks across the full row (wide contiguous writes), and a fused
    iota mask zeroes everything off the block diagonal — one elementwise
    pass over the output in its native tiling.
    """
    N = D.shape[0]
    M = N * 6
    tiled = jnp.tile(D.reshape(M, 6), (1, N))        # row r = D[r//6, r%6, :]
    rb = jax.lax.broadcasted_iota(jnp.int32, (M, M), 0) // 6
    cb = jax.lax.broadcasted_iota(jnp.int32, (M, M), 1) // 6
    return jnp.where(rb == cb, tiled, 0.0)


def _expand_block_tridiag(D: jax.Array, S: jax.Array) -> jax.Array:
    """(N,6,6) diagonal blocks D + (N,6,6) SUPER-diagonal blocks S (block
    (i, i+1) = S[i], block (i+1, i) = S[i]^T) -> dense (6N, 6N), NO scatter.

    The chain-band counterpart of _expand_block_diag: consecutive-pose
    between factors (SM+ODO both connect (i, i+1) — the overwhelming
    majority of SLAM-graph edges) form a block-tridiagonal band, which this
    lays out with three wide tiled writes + one fused iota-mask pass instead
    of the XLA-serialized scatter.  Only
    non-consecutive (loop-closure) edges still scatter (_add_offdiag).

    Layout identities (r = row, c = col, rb = r//6, cb = c//6):
      upper band  tile(S.reshape(M,6), (1,N))[r,c] = S[rb][r%6, c%6]
      lower band  tile(S.reshape(M,6).T, (N,1))[r,c] = S[cb][c%6, r%6]
                  = (S[cb]^T)[r%6, c%6]  — exactly block (cb+1, cb).
    """
    N = D.shape[0]
    M = N * 6
    G = S.reshape(M, 6)
    tiled_d = jnp.tile(D.reshape(M, 6), (1, N))
    tiled_u = jnp.tile(G, (1, N))
    tiled_l = jnp.tile(G.T, (N, 1))
    rb = jax.lax.broadcasted_iota(jnp.int32, (M, M), 0) // 6
    cb = jax.lax.broadcasted_iota(jnp.int32, (M, M), 1) // 6
    return (jnp.where(rb == cb, tiled_d, 0.0)
            + jnp.where(cb == rb + 1, tiled_u, 0.0)
            + jnp.where(rb == cb + 1, tiled_l, 0.0))


def _between_parts(poses: jax.Array, bt_i, bt_j, bt_T, bt_winv):
    """Between-factor contributions in block form: (D (N,6,6) diagonal
    blocks, b2 (N,6) gradient blocks, Hij (E,6,6) off-diagonal blocks).

    Formulation (variants compared in benchmarks/assemble_probe.py at
    1024 poses): block-DIAGONAL mass and the gradient accumulate via
    one-hot matmuls — no colliding scatter; only the strictly
    OFF-diagonal (i, j) blocks ever go through a scatter (_add_offdiag).
    """
    from lidar_slam_arvc_tpu.graph.factors import FactorData
    N = poses.shape[0]
    f = FactorData(bt_i=bt_i, bt_j=bt_j, bt_T=bt_T, bt_winv=bt_winv,
                   gps_i=None, gps_z=None, gps_winv=None,
                   pr_i=None, pr_T=None, pr_winv=None)
    r, A, B = _between_residuals(poses, f)
    w2 = bt_winv ** 2                               # (E,6) diagonal weights
    AtW = jnp.swapaxes(A, -1, -2) * w2[:, None, :]  # A^T W^2
    BtW = jnp.swapaxes(B, -1, -2) * w2[:, None, :]
    Hii = jnp.einsum("eab,ebc->eac", AtW, A, precision=_HI)
    Hij = jnp.einsum("eab,ebc->eac", AtW, B, precision=_HI)
    Hjj = jnp.einsum("eab,ebc->eac", BtW, B, precision=_HI)
    bi = jnp.einsum("eab,eb->ea", AtW, r, precision=_HI)
    bj = jnp.einsum("eab,eb->ea", BtW, r, precision=_HI)

    oi = _onehot(bt_i, N, poses.dtype)              # (N, E)
    oj = _onehot(bt_j, N, poses.dtype)
    E = bt_i.shape[0]
    # block diagonal + gradient: one-hot matmuls, scatter-free
    D = (jnp.matmul(oi, Hii.reshape(E, 36), precision=_HI)
         + jnp.matmul(oj, Hjj.reshape(E, 36), precision=_HI)).reshape(N, 6, 6)
    b2 = jnp.matmul(oi, bi, precision=_HI) \
        + jnp.matmul(oj, bj, precision=_HI)         # (N, 6)
    return D, b2, Hij


def _add_offdiag(H, bt_i, bt_j, Hij):
    """Scatter the strictly off-diagonal (i, j)/(j, i) blocks into dense H
    — the fastest of the scatter formulations measured
    (benchmarks/assemble_probe.py; the (N,N,6,6) window-scatter +
    transpose alternative costs several times more in the relayout)."""
    ri = _block_indices(bt_i)
    rj = _block_indices(bt_j)
    H = H.at[ri[:, :, None], rj[:, None, :]].add(Hij)
    return H.at[rj[:, :, None], ri[:, None, :]].add(
        jnp.swapaxes(Hij, -1, -2))


def _assemble_between(poses: jax.Array, bt_i, bt_j, bt_T, bt_winv):
    """Dense (6N,6N)/(6N,) contributions of a set of between factors.

    Kept as a standalone entry point so the distributed solver
    (parallel/dist_solver.py) can run it per edge-shard inside shard_map
    and psum the partials; the fused single-device path uses
    _between_parts directly so the block-diagonal expansion happens once.
    """
    D, b2, Hij = _between_parts(poses, bt_i, bt_j, bt_T, bt_winv)
    H = _add_offdiag(_expand_block_diag(D), bt_i, bt_j, Hij)
    return H, b2.reshape(-1)


def _unary_parts(poses: jax.Array, factors: FactorData, n_active):
    """GPS + prior contributions and the inactive-pose diagonal, in block
    form (D (N,6,6), b2 (N,6)).  All unary mass is block-DIAGONAL:
    accumulated with one-hot matmuls (see _onehot — no colliding scatter).
    """
    N = poses.shape[0]

    # --- gps factors ---
    rg, Jg = _gps_residuals(poses, factors)
    wg2 = factors.gps_winv ** 2
    JtW = jnp.swapaxes(Jg, -1, -2) * wg2[:, None, :]
    Hg = jnp.einsum("eab,ebc->eac", JtW, Jg, precision=_HI)
    bg = jnp.einsum("eab,eb->ea", JtW, rg, precision=_HI)
    og = _onehot(factors.gps_i, N, poses.dtype)

    # --- priors ---
    rp, Jp = _prior_residuals(poses, factors)
    wp2 = factors.pr_winv ** 2
    JtWp = jnp.swapaxes(Jp, -1, -2) * wp2[:, None, :]
    Hp = jnp.einsum("eab,ebc->eac", JtWp, Jp, precision=_HI)
    bp = jnp.einsum("eab,eb->ea", JtWp, rp, precision=_HI)
    op = _onehot(factors.pr_i, N, poses.dtype)

    D = jnp.einsum("pe,eab->pab", og, Hg, precision=_HI) \
        + jnp.einsum("pe,eab->pab", op, Hp, precision=_HI)    # (N, 6, 6)
    b2 = jnp.einsum("pe,ea->pa", og, bg, precision=_HI) \
        + jnp.einsum("pe,ea->pa", op, bp, precision=_HI)      # (N, 6)

    # inactive poses (index >= n_active) get identity diagonal so the dense
    # solve stays non-singular; their (zeroed) gradient keeps them fixed.
    inactive = jnp.arange(N) >= n_active
    D = D + jnp.where(inactive[:, None, None],
                      jnp.eye(6, dtype=poses.dtype)[None], 0.0)
    b2 = jnp.where(inactive[:, None], 0.0, b2)
    return D, b2


def _assemble_unary(poses: jax.Array, factors: FactorData, n_active):
    """Dense (6N,6N)/(6N,) unary contributions (dist_solver entry point)."""
    D, b2 = _unary_parts(poses, factors, n_active)
    return _expand_block_diag(D), b2.reshape(-1)


@functools.partial(jax.jit, static_argnames=("chain_capacity",))
def _assemble(poses: jax.Array, factors: FactorData, n_active: jax.Array,
              chain_capacity: int = 0):
    """Dense H (6N,6N) and gradient b (6N,).

    All block-diagonal mass (between Hii/Hjj, GPS, priors, inactive
    padding) accumulates in (N,6,6) form and expands to dense ONCE
    (_expand_block_diag); only the off-diagonal between blocks scatter.

    ``chain_capacity`` (static): the first ``chain_capacity`` between slots
    are guaranteed CHAIN slots — either a consecutive edge (j == i+1) or
    zero-weight padding (PoseGraph partitions its buffers this way).  Their
    off-diagonal blocks are laid down as a block-tridiagonal band with NO
    scatter (_expand_block_tridiag); only the remaining (loop-closure)
    slots go through the serialized scatter.  0 = all slots scatter
    (layout-agnostic fallback).
    """
    Db, bb, Hij = _between_parts(poses, factors.bt_i, factors.bt_j,
                                 factors.bt_T, factors.bt_winv)
    Du, bu = _unary_parts(poses, factors, n_active)
    C = chain_capacity
    if C > 0:
        # super-diagonal band blocks: segment-sum of the chain slots'
        # Hij over i, as a one-hot matmul (zero-weight padding slots
        # contribute zero blocks; band placement only reads i)
        N = poses.shape[0]
        oc = _onehot(factors.bt_i[:C], N, poses.dtype)          # (N, C)
        S = jnp.matmul(oc, Hij[:C].reshape(C, 36),
                       precision=_HI).reshape(N, 6, 6)
        H = _expand_block_tridiag(Db + Du, S)
        H = _add_offdiag(H, factors.bt_i[C:], factors.bt_j[C:], Hij[C:])
    else:
        H = _expand_block_diag(Db + Du)
        H = _add_offdiag(H, factors.bt_i, factors.bt_j, Hij)
    return H, (bb + bu).reshape(-1)


@functools.partial(jax.jit, static_argnames=("chain_capacity",))
def _lm_step(poses, factors, n_active, lam, chain_capacity: int = 0):
    """One damped step: returns (new_poses, new_cost)."""
    H, b = _assemble(poses, factors, n_active, chain_capacity)
    # Levenberg damping scaled by the diagonal (Marquardt form); written as
    # a unique-index diagonal scatter — jnp.diag(jnp.diag(H)) + eye would
    # materialize two extra (6N,6N) passes
    di = jnp.arange(H.shape[0])
    damped = H.at[di, di].add(lam * jnp.diagonal(H) + 1e-9,
                              unique_indices=True)
    # Jacobi equilibration before the f32 Cholesky (see
    # marginal_covariances): rotation vs weak-prior rows put cond(H) at
    # ~1e8, and S H S solves several digits more accurately
    s = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(damped), 1e-30))
    damped = damped * s[:, None] * s[None, :]
    delta = s * jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(damped, lower=True), -(b * s))
    delta = delta.reshape(-1, 6)
    # freeze inactive poses explicitly
    active = (jnp.arange(poses.shape[0]) < n_active)[:, None]
    delta = jnp.where(active, delta, 0.0)
    new_poses = geom.compose(poses, geom.se3_exp(delta))
    return new_poses, graph_cost(new_poses, factors)


@functools.partial(jax.jit, static_argnames=("chunk", "chain_capacity"))
def marginal_covariances(poses: jax.Array, factors: FactorData,
                         n_active: jax.Array, chunk: int = 64,
                         chain_capacity: int = 0) -> jax.Array:
    """Per-pose 6x6 marginal covariance blocks in the tangent frame [w, v].

    Parity with gtsam.Marginals(...).marginalCovariance(i) (reference
    graphslam/graphSLAM.py:117-137, used for the uncertainty ellipses in
    GraphSLAM.plot).  The linearized information matrix H = J^T W J is
    assembled at the current estimate and Cholesky-factored ONCE; the
    marginal of pose i is the i-th 6x6 diagonal block of H^-1, obtained by
    back-substituting 6-column unit RHS blocks ``chunk`` poses at a time
    (lax.map) — never materializing the (6N)^2 full inverse, so memory is
    O((6N)^2) for H/L only, same as the solve itself.  Inactive poses carry
    identity diagonal and are meaningless; slice [:n_poses] on the host.

    For graphs where even dense H is too large, use
    graph.pcg.marginal_blocks_pcg (matrix-free, per-index).
    """
    n = poses.shape[0]
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError(f"pose capacity {n} not divisible by chunk {chunk}")
    H, _ = _assemble(poses, factors, jnp.asarray(n_active, dtype=jnp.int32),
                     chain_capacity)
    H = H + 1e-9 * jnp.eye(H.shape[0], dtype=H.dtype)
    # Jacobi equilibration: the SLAM information matrix mixes rotation rows
    # (winv^2 ~ 1e6) with weak-prior rows (~1e-2), cond(H) ~ 1e8 — at f32
    # that costs the solve several digits.  Factor S H S (cond ~ that of
    # the correlation matrix) and unscale: H^-1 = S (S H S)^-1 S.
    s = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(H), 1e-30))
    Hs = H * s[:, None] * s[None, :]
    F = jax.scipy.linalg.cho_factor(Hs, lower=True)
    N6 = H.shape[0]
    C6 = 6 * chunk

    def one_chunk(ci):
        cols = ci * C6 + jnp.arange(C6)
        rhs = jnp.zeros((N6, C6), dtype=H.dtype).at[
            cols, jnp.arange(C6)].set(1.0)
        X = jax.scipy.linalg.cho_solve(F, rhs * s[cols][None, :])
        X = X * s[:, None]                          # unscale rows
        Xr = X.reshape(n, 6, chunk, 6)
        k = jnp.arange(chunk)
        return Xr[ci * chunk + k, :, k, :]          # (chunk, 6, 6)

    blocks = jax.lax.map(one_chunk, jnp.arange(n // chunk, dtype=jnp.int32))
    return blocks.reshape(n, 6, 6)


def lm_drive(step_fn, poses: jax.Array, cost0: float,
             max_iterations: int = 15, lam0: float = 1e-6,
             tol: float = 1e-7):
    """Host-controlled LM accept/reject schedule around a damped-step
    callable ``step_fn(poses, lam) -> (candidate_poses, candidate_cost)``.

    Shared by the single-device solve (solve_graph) and the distributed
    Schur solve (parallel.schur.schur_solve_graph) so the schedule cannot
    diverge between them.  Returns (poses, cost).
    """
    cost = float(cost0)
    lam = lam0
    for _ in range(max_iterations):
        cand, cand_cost = step_fn(poses, lam)
        cand_cost = float(cand_cost)
        if not (cand_cost < cost) or not jnp.isfinite(cand_cost):
            lam = min(lam * 10.0, 1e4)
            if lam >= 1e4:
                break
            continue
        improved = cost - cand_cost
        poses, cost = cand, cand_cost
        lam = max(lam / 5.0, 1e-9)
        if improved < tol * max(cost, 1.0):
            break
    return poses, cost


@functools.partial(jax.jit, static_argnames=("max_iterations",
                                             "chain_capacity"))
def _solve_graph_fused(poses, factors, n_active, lam0, tol,
                       max_iterations: int, chain_capacity: int = 0):
    """The full LM accept/reject schedule of lm_drive inside ONE program.

    Host-looped LM costs one dispatch + host sync per iteration, which
    adds up at the pipeline's every-K-poses optimize cadence.  The fused
    while_loop runs the identical schedule (same accept/reject, damping
    ladder, and stop conditions as lm_drive) in a single dispatch.
    """
    cost0 = graph_cost(poses, factors)

    def cond(s):
        _, _, _, it, done = s
        return (it < max_iterations) & ~done

    def body(s):
        p, cost, lam, it, _ = s
        cand, cand_cost = _lm_step(p, factors, n_active, lam,
                                   chain_capacity)
        ok = jnp.isfinite(cand_cost) & (cand_cost < cost)
        improved = cost - cand_cost
        new_p = jnp.where(ok, cand, p)
        new_cost = jnp.where(ok, cand_cost, cost)
        new_lam = jnp.where(ok, jnp.maximum(lam / 5.0, 1e-9),
                            jnp.minimum(lam * 10.0, 1e4))
        done = jnp.where(ok, improved < tol * jnp.maximum(new_cost, 1.0),
                         new_lam >= 1e4)
        return new_p, new_cost, new_lam, it + 1, done

    poses, cost, _, _, _ = jax.lax.while_loop(
        cond, body, (poses, cost0, jnp.float32(lam0), jnp.int32(0),
                     jnp.bool_(False)))
    # ONE packed output: poses flattened with the cost appended, so the
    # host needs a single device-to-host transfer per optimize()
    return jnp.concatenate([poses.reshape(-1), cost.reshape(1)])


def solve_graph(poses: jax.Array, factors: FactorData, n_active,
                max_iterations: int = 15, lam0: float = 1e-6,
                tol: float = 1e-7, chain_capacity: int = 0):
    """Batch LM solve, one device dispatch + ONE host transfer.

    Returns (optimized poses as a HOST numpy array, final cost float).
    Shapes are static, so repeated calls with a growing graph (same
    capacities) reuse the same executable.
    ``chain_capacity``: see _assemble — pass PoseGraph.chain_capacity when
    the factor buffers are chain-partitioned (scatter-free band assembly).
    """
    n_active = jnp.asarray(n_active, dtype=jnp.int32)
    n = poses.shape[0]
    packed = np.asarray(_solve_graph_fused(
        poses, factors, n_active, jnp.float32(lam0), jnp.float32(tol),
        max_iterations, chain_capacity))
    return packed[:-1].reshape(n, 4, 4), float(packed[-1])
