"""Distributed Schur-complement pose-graph solve.

The SURVEY.md §2.2/§2.3 "distributed pose-graph solve" in its direct form:
the trajectory is partitioned into contiguous pose chunks, one per device
along the mesh axis.  Poses touched by a cross-chunk factor (chain
boundaries and loop-closure endpoints) form the SEPARATOR set; everything
else is interior to exactly one chunk.  Each device then

  1. assembles its own interior block H_II^d (6m x 6m dense — small, and
     dense Cholesky), the interior-separator coupling
     H_IS^d, its partial of the separator block H_SS and of the gradient,
  2. eliminates its interior locally: Y = H_II^-1 [H_IS | b_I],
  3. psums the reduced system S = H_SS - sum_d H_SI^d Y^d over the mesh
     (device collectives) and solves the small replicated separator system,
  4. back-substitutes its interior update locally.

This is algebraically exact: identical (to roundoff) to the dense damped
solve of graph/solver.py:_lm_step on the full H, but the O((6N)^3)
factorization cost becomes O(D * (6m)^3 + (6S)^3) spread over D devices,
and the only communication is the (6S)^2 psum.  The reference's analogue
is a single-process ISAM2 update (graphSLAM.py:102-105) — no distributed
counterpart exists there.

Capacity contract: like everything in graph/, shapes are static — pass a
``sep_capacity`` upper bound on the separator count (chunk boundaries +
2 x loop closures).  The returned ``n_sep`` must be checked on the host
(<= sep_capacity) or the step is invalid.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from lidar_slam_arvc_tpu import geom
from lidar_slam_arvc_tpu.graph.factors import FactorData
from lidar_slam_arvc_tpu.graph.solver import (
    _between_residuals, _gps_residuals, _prior_residuals, graph_cost,
)

_HI = jax.lax.Precision.HIGHEST


def _rows6(r):
    """(E,) block ids -> (E, 6) flat row ids."""
    return r[:, None] * 6 + jnp.arange(6, dtype=r.dtype)[None, :]


def _add_block(H, r, c, blocks):
    """Scatter-add (E,6,6) blocks at block coordinates (r, c)."""
    r6 = _rows6(r)
    c6 = _rows6(c)
    return H.at[r6[:, :, None], c6[:, None, :]].add(blocks)


def _add_vec(b, r, vecs):
    return b.at[_rows6(r)].add(vecs)


def _weighted_between_blocks(poses, f: FactorData):
    """Per-edge (Hii, Hij, Hjj, bi, bj) weighted normal-equation blocks."""
    r, A, B = _between_residuals(poses, f)
    w2 = f.bt_winv ** 2
    AtW = jnp.swapaxes(A, -1, -2) * w2[:, None, :]
    BtW = jnp.swapaxes(B, -1, -2) * w2[:, None, :]
    Hii = jnp.einsum("eab,ebc->eac", AtW, A, precision=_HI)
    Hij = jnp.einsum("eab,ebc->eac", AtW, B, precision=_HI)
    Hjj = jnp.einsum("eab,ebc->eac", BtW, B, precision=_HI)
    bi = jnp.einsum("eab,eb->ea", AtW, r, precision=_HI)
    bj = jnp.einsum("eab,eb->ea", BtW, r, precision=_HI)
    return Hii, Hij, Hjj, bi, bj


def _weighted_unary_blocks(poses, factors: FactorData):
    """((idx, Hu, bu) for gps, (idx, Hu, bu) for prior) 6x6 unary blocks."""
    rg, Jg = _gps_residuals(poses, factors)
    wg2 = factors.gps_winv ** 2
    JtW = jnp.swapaxes(Jg, -1, -2) * wg2[:, None, :]
    Hg = jnp.einsum("eab,ebc->eac", JtW, Jg, precision=_HI)
    bg = jnp.einsum("eab,eb->ea", JtW, rg, precision=_HI)

    rp, Jp = _prior_residuals(poses, factors)
    wp2 = factors.pr_winv ** 2
    JtWp = jnp.swapaxes(Jp, -1, -2) * wp2[:, None, :]
    Hp = jnp.einsum("eab,ebc->eac", JtWp, Jp, precision=_HI)
    bp = jnp.einsum("eab,eb->ea", JtWp, rp, precision=_HI)
    return (factors.gps_i, Hg, bg), (factors.pr_i, Hp, bp)


def schur_lm_step(mesh: Mesh, poses: jax.Array, factors: FactorData,
                  n_active, lam: float = 1e-6, sep_capacity: int = 64,
                  axis: str = "data"):
    """One damped GN step via distributed Schur elimination.

    Returns (new_poses, cost, n_sep).  ``n_sep`` (separator count) must be
    <= sep_capacity for the step to be valid — check it on the host; the
    bound is D chunk boundaries * 2 + 2 per loop-closure edge.
    """
    D = mesh.shape[axis]
    N = poses.shape[0]
    if N % D:
        raise ValueError(f"pose capacity {N} not divisible by mesh size {D}")
    m = N // D
    S = sep_capacity
    n_active = jnp.asarray(n_active, dtype=jnp.int32)
    lam = jnp.asarray(lam, dtype=poses.dtype)

    def local(poses, factors, n_active, lam):
        d = jax.lax.axis_index(axis)
        part = jnp.arange(N, dtype=jnp.int32) // m

        # --- separator identification (replicated; deterministic ranks) ---
        e_act = jnp.any(factors.bt_winv > 0, axis=1)
        cross = (factors.bt_i // m != factors.bt_j // m) & e_act
        sep_i32 = jnp.zeros(N, dtype=jnp.int32)
        sep_i32 = sep_i32.at[factors.bt_i].max(cross.astype(jnp.int32))
        sep_i32 = sep_i32.at[factors.bt_j].max(cross.astype(jnp.int32))
        sep = sep_i32 > 0
        n_sep = jnp.sum(sep_i32)
        rank_all = jnp.cumsum(sep_i32) - 1
        # rank S = dump slot for non-separators and capacity overflow
        srank = jnp.where(sep & (rank_all < S), rank_all, S).astype(jnp.int32)
        sep_pose = (jnp.full((S + 1,), N, dtype=jnp.int32)
                    .at[srank].set(jnp.arange(N, dtype=jnp.int32),
                                   mode="drop")[:S])
        # fix the dump-slot collision: slot S was overwritten arbitrarily
        # (sliced away), but any non-sep pose writing into a real slot is
        # impossible since srank==S for all of them.

        own = (part == d) & ~sep                      # interior of my chunk
        li_all = jnp.arange(N, dtype=jnp.int32) - d * m
        rloc = jnp.where(own, li_all, m).astype(jnp.int32)  # m = dump row

        Hii, Hij, Hjj, bi, bj = _weighted_between_blocks(poses, factors)
        ei, ej = factors.bt_i, factors.bt_j
        own_i, own_j = own[ei], own[ej]
        sep_e_i, sep_e_j = sep[ei], sep[ej]
        ri, rj = rloc[ei], rloc[ej]
        si, sj = srank[ei], srank[ej]

        # --- H_II, b_I (fully local by ownership) ---
        HII = jnp.zeros(((m + 1) * 6, (m + 1) * 6), dtype=poses.dtype)
        bI = jnp.zeros(((m + 1) * 6,), dtype=poses.dtype)
        HII = _add_block(HII, ri, ri, Hii)
        HII = _add_block(HII, rj, rj, Hjj)
        rij_i = jnp.where(own_i & own_j, ri, m)
        rij_j = jnp.where(own_i & own_j, rj, m)
        HII = _add_block(HII, rij_i, rij_j, Hij)
        HII = _add_block(HII, rij_j, rij_i, jnp.swapaxes(Hij, -1, -2))
        bI = _add_vec(bI, ri, bi)
        bI = _add_vec(bI, rj, bj)

        # --- H_IS coupling ---
        HIS = jnp.zeros(((m + 1) * 6, (S + 1) * 6), dtype=poses.dtype)
        r_is = jnp.where(own_i & sep_e_j, ri, m)
        c_is = jnp.where(own_i & sep_e_j, sj, S)
        HIS = _add_block(HIS, r_is, c_is, Hij)
        r_si = jnp.where(own_j & sep_e_i, rj, m)
        c_si = jnp.where(own_j & sep_e_i, si, S)
        HIS = _add_block(HIS, r_si, c_si, jnp.swapaxes(Hij, -1, -2))

        # --- H_SS / b_S partials (each edge assembled by its owner) ---
        part_i, part_j = part[ei], part[ej]
        owner = jnp.where(~sep_e_i, part_i,
                          jnp.where(~sep_e_j, part_j, part_i))
        own_e = owner == d
        HSS = jnp.zeros(((S + 1) * 6, (S + 1) * 6), dtype=poses.dtype)
        bS = jnp.zeros(((S + 1) * 6,), dtype=poses.dtype)
        s_ii = jnp.where(own_e & sep_e_i, si, S)
        s_jj = jnp.where(own_e & sep_e_j, sj, S)
        HSS = _add_block(HSS, s_ii, s_ii, Hii)
        HSS = _add_block(HSS, s_jj, s_jj, Hjj)
        both = own_e & sep_e_i & sep_e_j
        s_bi = jnp.where(both, si, S)
        s_bj = jnp.where(both, sj, S)
        HSS = _add_block(HSS, s_bi, s_bj, Hij)
        HSS = _add_block(HSS, s_bj, s_bi, jnp.swapaxes(Hij, -1, -2))
        bS = _add_vec(bS, s_ii, bi)
        bS = _add_vec(bS, s_jj, bj)

        # --- unary factors (gps + prior) routed the same way ---
        for idx, Hu, bu in _weighted_unary_blocks(poses, factors):
            own_u = own[idx]
            sep_u = sep[idx] & (part[idx] == d)   # owner of a unary = part
            r_u = jnp.where(own_u, rloc[idx], m)
            HII = _add_block(HII, r_u, r_u, Hu)
            bI = _add_vec(bI, r_u, bu)
            s_u = jnp.where(sep_u, srank[idx], S)
            HSS = _add_block(HSS, s_u, s_u, Hu)
            bS = _add_vec(bS, s_u, bu)

        # --- slice off dump rows/cols; damp; pin invalid rows ---
        HII = HII[: 6 * m, : 6 * m]
        bI = bI[: 6 * m]
        HIS = HIS[: 6 * m, : 6 * S]
        HSS = HSS[: 6 * S, : 6 * S]
        bS = bS[: 6 * S]

        gidx = d * m + jnp.arange(m, dtype=jnp.int32)
        row_valid = jnp.repeat(own[gidx] & (gidx < n_active), 6)
        rv = row_valid.astype(poses.dtype)
        HII = HII * rv[:, None] * rv[None, :]
        dII = jnp.diag(HII)
        HII = (HII + jnp.diag(lam * dII + (1.0 - rv)
                              + 1e-9 * jnp.ones_like(dII)))
        bI = bI * rv
        HIS = HIS * rv[:, None]

        F = jax.scipy.linalg.cho_factor(HII, lower=True)
        Y = jax.scipy.linalg.cho_solve(F, jnp.concatenate(
            [HIS, bI[:, None]], axis=1))              # (6m, 6S+1)
        red = jnp.dot(HIS.T, Y, precision=_HI)        # (6S, 6S+1)

        HSS_full = jax.lax.psum(HSS, axis_name=axis)
        bS_full = jax.lax.psum(bS, axis_name=axis)
        red_full = jax.lax.psum(red, axis_name=axis)

        srow_valid = jnp.repeat(
            jnp.arange(S, dtype=jnp.int32) < jnp.minimum(n_sep, S), 6)
        sv = srow_valid.astype(poses.dtype)
        dSS = jnp.diag(HSS_full)
        S_damped = HSS_full + jnp.diag(lam * dSS + (1.0 - sv)
                                       + 1e-9 * jnp.ones_like(dSS))
        S_red = S_damped - red_full[:, : 6 * S]
        rhs = (-bS_full + red_full[:, -1]) * sv
        xS = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(S_red, lower=True), rhs)

        xI = -Y[:, -1] - jnp.dot(Y[:, : 6 * S], xS, precision=_HI)
        xI = xI * rv
        return (xI.reshape(m, 6), xS.reshape(S, 6)[None], sep_pose[None],
                n_sep[None])

    xI, xS, sep_pose, n_sep = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )(poses, factors, n_active, lam)
    # replicated per-device copies come back stacked along the axis; take
    # device 0's copy of the separator solution
    xS0, sep_pose0, n_sep0 = xS[0], sep_pose[0], n_sep[0]

    delta = jnp.zeros((N + 1, 6), dtype=poses.dtype)
    delta = delta.at[:N].set(xI)
    delta = delta.at[jnp.minimum(sep_pose0, N)].set(xS0, mode="drop")[:N]
    active = (jnp.arange(N) < n_active)[:, None]
    delta = jnp.where(active, delta, 0.0)
    new_poses = geom.compose(poses, geom.se3_exp(delta))
    return new_poses, graph_cost(new_poses, factors), n_sep0


def schur_lm_step_jit(mesh: Mesh, sep_capacity: int = 64, axis: str = "data"):
    """jit-wrapped schur_lm_step with the static arguments bound."""
    @jax.jit
    def step(poses, factors, n_active, lam):
        return schur_lm_step(mesh, poses, factors, n_active, lam,
                             sep_capacity=sep_capacity, axis=axis)
    return step


def schur_solve_graph(mesh: Mesh, poses: jax.Array, factors: FactorData,
                      n_active, sep_capacity: int = 64,
                      max_iterations: int = 15, lam0: float = 1e-6,
                      tol: float = 1e-7, axis: str = "data"):
    """Full LM loop over distributed Schur steps — the multi-device
    counterpart of graph.solver.solve_graph (same host-controlled
    accept/reject schedule).  Returns (poses, cost)."""
    from lidar_slam_arvc_tpu.graph.solver import lm_drive
    step = schur_lm_step_jit(mesh, sep_capacity=sep_capacity, axis=axis)
    n_active = jnp.asarray(n_active, dtype=jnp.int32)

    def lm_step(p, lam):
        cand, cand_cost, n_sep = step(p, factors, n_active,
                                      jnp.asarray(lam, dtype=p.dtype))
        if int(n_sep) > sep_capacity:
            raise ValueError(
                f"separator count {int(n_sep)} exceeds sep_capacity "
                f"{sep_capacity}; raise it (bound: mesh size * 2 + 2 per "
                f"loop closure)")
        return cand, cand_cost

    return lm_drive(lm_step, poses, graph_cost(poses, factors),
                    max_iterations=max_iterations, lam0=lam0, tol=tol)
