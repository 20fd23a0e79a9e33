"""Matrix-free preconditioned conjugate gradient for large pose graphs.

The dense (6N, 6N) Cholesky in solver.py is ideal up to ~1-2k poses; beyond
that the normal equations are solved matrix-free: per-LM-step the factor
Jacobian blocks (A, B per between edge, J per unary) are evaluated once, and
H @ x products are gather/scatter block einsums — O(E) 6x6 work with no
materialized matrix.  Preconditioner: block-Jacobi (the 6x6 diagonal blocks
of H, batch-inverted).  This is also the building block the distributed
solver scales with: the block products shard over edges exactly like
parallel/dist_solver.py's assembly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import geom
from lidar_slam_arvc_tpu.graph.factors import FactorData
from lidar_slam_arvc_tpu.graph.solver import (
    _between_residuals, _gps_residuals, _prior_residuals, graph_cost,
)

_HI = jax.lax.Precision.HIGHEST


class _LinearizedGraph(NamedTuple):
    """Per-step linearization: Jacobian blocks + weighted residual gradient."""
    A: jax.Array        # (E,6,6) between d r / d xi_i
    B: jax.Array        # (E,6,6) between d r / d xi_j
    w2_bt: jax.Array    # (E,6)
    Jg: jax.Array       # (G,3,6)
    w2_g: jax.Array     # (G,3)
    Jp: jax.Array       # (P,6,6)
    w2_p: jax.Array     # (P,6)
    grad: jax.Array     # (N,6) J^T W^2 r
    diag_blocks: jax.Array  # (N,6,6) block-diagonal of H


def _linearize(poses, factors: FactorData, n_active):
    N = poses.shape[0]
    r_b, A, B = _between_residuals(poses, factors)
    w2_bt = factors.bt_winv ** 2
    r_g, Jg = _gps_residuals(poses, factors)
    w2_g = factors.gps_winv ** 2
    r_p, Jp = _prior_residuals(poses, factors)
    w2_p = factors.pr_winv ** 2

    grad = jnp.zeros((N, 6), dtype=poses.dtype)
    zb = w2_bt * r_b
    grad = grad.at[factors.bt_i].add(
        jnp.einsum("eba,eb->ea", A, zb, precision=_HI))
    grad = grad.at[factors.bt_j].add(
        jnp.einsum("eba,eb->ea", B, zb, precision=_HI))
    zg = w2_g * r_g
    grad = grad.at[factors.gps_i].add(
        jnp.einsum("eba,eb->ea", Jg, zg, precision=_HI))
    zp = w2_p * r_p
    grad = grad.at[factors.pr_i].add(
        jnp.einsum("eba,eb->ea", Jp, zp, precision=_HI))

    diag = jnp.zeros((N, 6, 6), dtype=poses.dtype)
    AtWA = jnp.einsum("eba,eb,ebc->eac", A, w2_bt, A, precision=_HI)
    BtWB = jnp.einsum("eba,eb,ebc->eac", B, w2_bt, B, precision=_HI)
    diag = diag.at[factors.bt_i].add(AtWA)
    diag = diag.at[factors.bt_j].add(BtWB)
    diag = diag.at[factors.gps_i].add(
        jnp.einsum("eba,eb,ebc->eac", Jg, w2_g, Jg, precision=_HI))
    diag = diag.at[factors.pr_i].add(
        jnp.einsum("eba,eb,ebc->eac", Jp, w2_p, Jp, precision=_HI))

    # inactive poses pinned with identity
    inactive = (jnp.arange(N) >= n_active)
    diag = diag + inactive[:, None, None] * jnp.eye(6, dtype=poses.dtype)
    grad = jnp.where(inactive[:, None], 0.0, grad)
    return _LinearizedGraph(A, B, w2_bt, Jg, w2_g, Jp, w2_p, grad, diag), (
        factors.bt_i, factors.bt_j, factors.gps_i, factors.pr_i, inactive)


def _tridiag_blocks(lin: _LinearizedGraph, factors: FactorData, lam):
    """(A (N,6,6) damped diagonal blocks, E (N,6,6) superdiagonal with
    E[N-1]=0) — the block-TRIDIAGONAL part of damped H, shared by the
    scan factorization below and the cyclic-reduction one (graph/bcr.py).
    """
    N = lin.diag_blocks.shape[0]
    A = lin.diag_blocks * (1.0 + lam) + 1e-8 * jnp.eye(
        6, dtype=lin.diag_blocks.dtype)
    # E[k] = damped H[k, k+1]: A^T W^2 B of consecutive between edges
    AtWB = jnp.einsum("eba,eb,ebc->eac", lin.A, lin.w2_bt, lin.B,
                      precision=_HI)
    consec = factors.bt_j == factors.bt_i + 1
    dst = jnp.where(consec, factors.bt_i, N)
    E = jnp.zeros((N, 6, 6), dtype=A.dtype).at[dst].add(AtWB, mode="drop")
    # chain ends at inactive poses: their identity diagonal + zero E rows
    # (edges into them have zero weight) keep the factorization regular
    return A, E


def _build_tridiag_precond(lin: _LinearizedGraph, factors: FactorData, lam):
    """Block-LDL^T factorization of the block-TRIDIAGONAL part of damped H.

    SLAM normal equations are a stiff chain (consecutive-pose coupling at
    ICP/odometry weight, ~2500x the GPS anchor weight) plus sparse loop
    blocks.  Block-Jacobi ignores the chain, so CG propagates information
    ~1 pose/iteration between anchors; taking the tridiagonal part as the
    preconditioner solves the chain EXACTLY and leaves CG only the
    loop-closure/GPS low-rank corrections — tens of iterations instead of
    O(N).  SPD by construction: every factor's diagonal blocks stay in M,
    only non-consecutive off-diagonal blocks are dropped (a PSD-preserving
    truncation), plus Marquardt damping.

    The factorization is a lax.scan of 6x6 ops over the pose chain
    (sequential but tiny, once per CG solve); applying it is
    one forward + one backward scan.
    """
    A, E = _tridiag_blocks(lin, factors, lam)
    Uinv0 = jnp.linalg.inv(A[0])

    def fact_step(Uinv_prev, inputs):
        Ak, Ek_prev = inputs
        Wk = jnp.einsum("ba,bc->ac", Ek_prev, Uinv_prev, precision=_HI)
        Uk = Ak - jnp.einsum("ab,bc->ac", Wk, Ek_prev, precision=_HI)
        Uinv_k = jnp.linalg.inv(Uk)
        return Uinv_k, (Uinv_k, Wk)

    _, (Uinv_rest, W_rest) = jax.lax.scan(fact_step, Uinv0,
                                          (A[1:], E[:-1]))
    Uinv = jnp.concatenate([Uinv0[None], Uinv_rest])
    W = jnp.concatenate([jnp.zeros((1, 6, 6), dtype=A.dtype), W_rest])
    return Uinv, W, E


def _apply_tridiag_precond(Uinv, W, E, b):
    """Solve M x = b for block-tridiagonal M = (L+I) U (L+I)^T factors."""
    def fwd(y_prev, inputs):
        bk, Wk = inputs
        yk = bk - jnp.einsum("ab,b->a", Wk, y_prev, precision=_HI)
        return yk, yk

    y0 = b[0]
    _, y_rest = jax.lax.scan(fwd, y0, (b[1:], W[1:]))
    y = jnp.concatenate([y0[None], y_rest])

    def bwd(x_next, inputs):
        yk, Uinv_k, Ek = inputs
        xk = jnp.einsum("ab,b->a", Uinv_k,
                        yk - jnp.einsum("ab,b->a", Ek, x_next,
                                        precision=_HI), precision=_HI)
        return xk, xk

    xN = jnp.einsum("ab,b->a", Uinv[-1], y[-1], precision=_HI)
    _, x_rest = jax.lax.scan(bwd, xN, (y[:-1], Uinv[:-1], E[:-1]),
                             reverse=True)
    return jnp.concatenate([x_rest, xN[None]])


def _hx(lin: _LinearizedGraph, idx, x, lam):
    """(H + lam * blockdiag(H)) @ x for x (N,6)."""
    bt_i, bt_j, gps_i, pr_i, inactive = idx
    N = x.shape[0]
    y = jnp.zeros_like(x)
    u = (jnp.einsum("eab,eb->ea", lin.A, x[bt_i], precision=_HI)
         + jnp.einsum("eab,eb->ea", lin.B, x[bt_j], precision=_HI))
    z = lin.w2_bt * u
    y = y.at[bt_i].add(jnp.einsum("eba,eb->ea", lin.A, z, precision=_HI))
    y = y.at[bt_j].add(jnp.einsum("eba,eb->ea", lin.B, z, precision=_HI))

    ug = jnp.einsum("eab,eb->ea", lin.Jg, x[gps_i], precision=_HI)
    y = y.at[gps_i].add(
        jnp.einsum("eba,eb->ea", lin.Jg, lin.w2_g * ug, precision=_HI))

    up = jnp.einsum("eab,eb->ea", lin.Jp, x[pr_i], precision=_HI)
    y = y.at[pr_i].add(
        jnp.einsum("eba,eb->ea", lin.Jp, lin.w2_p * up, precision=_HI))

    y = y + inactive[:, None] * x
    # Marquardt damping on the block diagonal
    y = y + lam * jnp.einsum("nab,nb->na", lin.diag_blocks, x, precision=_HI)
    return y


@functools.partial(jax.jit, static_argnames=("max_cg_iters", "precond"))
def pcg_lm_step(poses, factors: FactorData, n_active, lam,
                max_cg_iters: int = 200, rtol: float = 1e-6,
                precond: str = "auto"):
    """One damped GN step solved by preconditioned CG; returns (poses, cost).

    precond: 'auto' (default) = 'bcr' at power-of-two pose capacity, else
    'tridiag'.  Both solve the block-tridiagonal chain part of damped H
    exactly; 'bcr' (graph/bcr.py cyclic reduction) does the factorization
    AND every apply in log2(N) batched levels instead of N-step scans.
    'jacobi' (block-diagonal) is kept for comparison."""
    n_active = jnp.asarray(n_active, dtype=jnp.int32)
    lin, idx = _linearize(poses, factors, n_active)
    b = -lin.grad  # solve H delta = -grad
    N = poses.shape[0]

    if precond == "auto":
        precond = "bcr" if (N & (N - 1)) == 0 else "tridiag"
    if precond == "bcr":
        from lidar_slam_arvc_tpu.graph.bcr import bcr_factor, bcr_solve
        A, E = _tridiag_blocks(lin, factors, lam)
        levels, Dinv_root = bcr_factor(A, E)
        apply_M = lambda r: bcr_solve(levels, Dinv_root, r)
    elif precond == "tridiag":
        Uinv, W, E = _build_tridiag_precond(lin, factors, lam)
        apply_M = lambda r: _apply_tridiag_precond(Uinv, W, E, r)
    else:
        # block-Jacobi preconditioner with damping folded in
        M = lin.diag_blocks * (1.0 + lam) + 1e-8 * jnp.eye(
            6, dtype=poses.dtype)
        M_inv = jnp.linalg.inv(M)
        apply_M = lambda r: jnp.einsum("nab,nb->na", M_inv, r,
                                       precision=_HI)

    def dot(a, b_):
        return jnp.sum(a * b_)

    x0 = jnp.zeros_like(b)
    r0 = b  # since x0 = 0
    z0 = apply_M(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    b_norm2 = jnp.maximum(dot(b, b), 1e-30)

    def cond(state):
        k, x, r, p, rz = state
        return (k < max_cg_iters) & (dot(r, r) > rtol * rtol * b_norm2)

    def body(state):
        k, x, r, p, rz = state
        Hp = _hx(lin, idx, p, lam)
        alpha = rz / jnp.maximum(dot(p, Hp), 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = apply_M(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return k + 1, x, r, p, rz_new

    _, delta, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x0, r0, p0, rz0))

    active = (jnp.arange(poses.shape[0]) < n_active)[:, None]
    delta = jnp.where(active, delta, 0.0)
    new_poses = geom.compose(poses, geom.se3_exp(delta))
    return new_poses, graph_cost(new_poses, factors)


@functools.partial(jax.jit, static_argnames=("max_iterations",
                                              "max_cg_iters"))
def _solve_graph_pcg_fused(poses, factors: FactorData, n_active, lam0, tol,
                           max_iterations: int, max_cg_iters: int):
    """LM accept/reject schedule around PCG steps in one program (the PCG
    twin of graph.solver._solve_graph_fused — one dispatch per optimize
    call instead of one per LM iteration)."""
    cost0 = graph_cost(poses, factors)

    def cond(s):
        _, _, _, it, done = s
        return (it < max_iterations) & ~done

    def body(s):
        p, cost, lam, it, _ = s
        cand, cand_cost = pcg_lm_step(p, factors, n_active, lam,
                                      max_cg_iters=max_cg_iters)
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
    # single packed output = single host transfer (see solver.py
    # _solve_graph_fused)
    return jnp.concatenate([poses.reshape(-1), cost.reshape(1)])


@functools.partial(jax.jit, static_argnames=("max_cg_iters",))
def marginal_blocks_pcg(poses, factors: FactorData, n_active, indices,
                        max_cg_iters: int = 400, rtol: float = 1e-9):
    """Matrix-free marginal 6x6 covariance blocks for the requested poses.

    The PCG-regime counterpart of graph.solver.marginal_covariances: for
    each pose index p the 6 columns H^-1 e_{p,j} are solved by block-Jacobi
    PCG against the linearized information operator (never assembling H),
    and the block is read off at pose p.  Cost is 6 CG solves per requested
    index — use for the skip-sampled uncertainty artifact, not all poses.
    ``indices`` is a (K,) int array; returns (K, 6, 6).
    """
    n_active = jnp.asarray(n_active, dtype=jnp.int32)
    lin, idx = _linearize(poses, factors, n_active)
    zero = jnp.zeros((), dtype=poses.dtype)   # undamped H
    N = poses.shape[0]
    if (N & (N - 1)) == 0:                    # log-depth preconditioner
        from lidar_slam_arvc_tpu.graph.bcr import bcr_factor, bcr_solve
        A, E_t = _tridiag_blocks(lin, factors, zero)
        levels, Dinv_root = bcr_factor(A, E_t)
        apply_precond = lambda r: bcr_solve(levels, Dinv_root, r)
    else:
        Uinv, W, E = _build_tridiag_precond(lin, factors, zero)
        apply_precond = lambda r: _apply_tridiag_precond(Uinv, W, E, r)

    def solve_one(p, j):
        b = jnp.zeros_like(lin.grad).at[p, j].set(1.0)
        apply_M = apply_precond
        dot = lambda a, c: jnp.sum(a * c)
        r0 = b
        z0 = apply_M(r0)
        b_norm2 = jnp.maximum(dot(b, b), 1e-30)

        def cond(s):
            k, x, r, pp, rz = s
            return (k < max_cg_iters) & (dot(r, r) > rtol * rtol * b_norm2)

        def body(s):
            k, x, r, pp, rz = s
            Hp = _hx(lin, idx, pp, zero)
            alpha = rz / jnp.maximum(dot(pp, Hp), 1e-30)
            x = x + alpha * pp
            r = r - alpha * Hp
            z = apply_M(r)
            rz_new = dot(r, z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            return k + 1, x, r, z + beta * pp, rz_new

        _, x, _, _, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros_like(b), r0, z0,
                         dot(r0, z0)))
        return x[p]                                   # (6,) column at pose p

    # one fully-vmapped batch over ALL K*6 unit columns: each CG iteration
    # is tiny (edge sweep + BCR apply on (N,6) vectors), so a sequential
    # lax.map over poses is latency-bound; batching turns it into
    # K*6-wide vectorized sweeps (memory: ~5 CG state vectors x K*6 x
    # (N,6) f32 — a few tens of MB at pipeline scales).  The batch runs
    # until its slowest column converges, which the width amortizes.
    req = jnp.asarray(indices, dtype=jnp.int32)
    K = req.shape[0]
    pp = jnp.repeat(req, 6)                            # (K*6,)
    jj = jnp.tile(jnp.arange(6), K)                    # (K*6,)
    cols = jax.vmap(solve_one)(pp, jj)                 # (K*6, 6)
    return jnp.swapaxes(cols.reshape(K, 6, 6), 1, 2)


def solve_graph_pcg(poses, factors: FactorData, n_active,
                    max_iterations: int = 15, lam0: float = 1e-6,
                    tol: float = 1e-7, max_cg_iters: int = 200):
    """LM loop around PCG steps (same accept/reject policy as solve_graph),
    fused into one device dispatch + one host transfer.  Returns
    (host numpy poses, cost float)."""
    n = poses.shape[0]
    packed = np.asarray(_solve_graph_pcg_fused(
        poses, factors, jnp.asarray(n_active, dtype=jnp.int32),
        jnp.float32(lam0), jnp.float32(tol), max_iterations, max_cg_iters))
    return packed[:-1].reshape(n, 4, 4), float(packed[-1])
