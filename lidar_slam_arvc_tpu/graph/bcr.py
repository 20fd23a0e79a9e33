"""Block cyclic reduction for SPD block-tridiagonal systems.

The scan-based LDL^T factorization/apply in graph/pcg.py is sequential in
the pose count: measured at 2048 poses (benchmarks/pcg_probe.py) the
factorization scan costs 13.4 ms and each preconditioner apply 4.2 ms —
latency walls (2048 dependent 6x6 steps), not compute.  Cyclic reduction
eliminates the odd-indexed block unknowns level by level: log2(N) levels
of BATCHED 6x6 inverses/matmuls (N/2^k independent blocks per level), so
both the factorization and every solve are log-depth programs.

Math per level (SPD block tridiagonal: diagonal D_i, superdiagonal
E_i = M[i, i+1], and M[i+1, i] = E_i^T); eliminating odd j:

    x_j = D_j^-1 (b_j - E_{j-1}^T x_{j-1} - E_j x_{j+1})

substituted into the even rows i = 2k gives the half-size system

    D'_k = D_2k - E_{2k-1}^T D_{2k-1}^-1 E_{2k-1}
                - E_2k     D_{2k+1}^-1 E_2k^T
    E'_k = -E_2k D_{2k+1}^-1 E_{2k+1}
    b'_k = b_2k - E_{2k-1}^T D_{2k-1}^-1 b_{2k-1}
                - E_2k     D_{2k+1}^-1 b_{2k+1}

which is nested-dissection elimination — stable on SPD systems (each D'
is a Schur complement of an SPD matrix, hence SPD).  E is stored with one
row per diagonal block, E[N-1] = 0, which makes every boundary case a
plain slice.

No reference counterpart: GTSAM's elimination is sequential by design;
this exists because an accelerator pays per *dependent step*, not per
flop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


class BCRLevel(NamedTuple):
    Dinv_odd: jax.Array   # (n/2, 6, 6)  D_{2k+1}^-1
    E_up: jax.Array       # (n/2, 6, 6)  E_{2k}   (couples 2k   <-> 2k+1)
    E_dn: jax.Array       # (n/2, 6, 6)  E_{2k+1} (couples 2k+1 <-> 2k+2)
    U: jax.Array          # (n/2, 6, 6)  U_k = E_{2k-1}^T D_{2k-1}^-1, U_0 = 0
    V: jax.Array          # (n/2, 6, 6)  V_k = E_2k D_{2k+1}^-1


def _mm(a, b):
    return jnp.einsum("kab,kbc->kac", a, b, precision=_HI)


def _mmT(a, b):
    """a^T b per block."""
    return jnp.einsum("kba,kbc->kac", a, b, precision=_HI)


def bcr_factor(D: jax.Array, E: jax.Array):
    """Factor an SPD block-tridiagonal matrix for log-depth solves.

    D (N,6,6) diagonal blocks, E (N,6,6) superdiagonal blocks with
    E[N-1] == 0.  N must be a power of two.  Returns (levels, Dinv_root).
    """
    N = D.shape[0]
    if N & (N - 1):
        raise ValueError(f"bcr_factor needs a power-of-two block count, "
                         f"got {N}")
    levels = []
    while N > 1:
        D_even, D_odd = D[0::2], D[1::2]
        E_up, E_dn = E[0::2], E[1::2]          # E_dn[-1] == 0 by invariant
        Dinv_odd = jnp.linalg.inv(D_odd)
        V = _mm(E_up, Dinv_odd)                 # (n/2,6,6)
        U_rest = _mmT(E_dn[:-1], Dinv_odd[:-1])
        zero = jnp.zeros((1, 6, 6), D.dtype)
        U = jnp.concatenate([zero, U_rest])
        t_up = jnp.concatenate([zero, _mm(U_rest, E_dn[:-1])])
        D = D_even - t_up - _mm(V, jnp.swapaxes(E_up, -1, -2))
        E = -_mm(V, E_dn)                       # E'[-1] = 0 since E_dn[-1]=0
        levels.append(BCRLevel(Dinv_odd, E_up, E_dn, U, V))
        N //= 2
    return levels, jnp.linalg.inv(D[0])


def _mv(a, x):
    return jnp.einsum("kab,kb->ka", a, x, precision=_HI)


def _mvT(a, x):
    return jnp.einsum("kba,kb->ka", a, x, precision=_HI)


def bcr_solve(levels, Dinv_root, b: jax.Array) -> jax.Array:
    """Solve M x = b given bcr_factor output.  b is (N, 6)."""
    odd_stack = []
    for lv in levels:
        b_even, b_odd = b[0::2], b[1::2]
        odd_stack.append(b_odd)
        t_up = jnp.concatenate([
            jnp.zeros((1, 6), b.dtype), _mv(lv.U[1:], b_odd[:-1])])
        b = b_even - t_up - _mv(lv.V, b_odd)

    x = jnp.einsum("ab,b->a", Dinv_root, b[0], precision=_HI)[None]

    for lv, b_odd in zip(reversed(levels), reversed(odd_stack)):
        x_even = x
        x_next = jnp.concatenate([x_even[1:],
                                  jnp.zeros((1, 6), x.dtype)])
        rhs = b_odd - _mvT(lv.E_up, x_even) - _mv(lv.E_dn, x_next)
        x_odd = _mv(lv.Dinv_odd, rhs)
        n = 2 * x_even.shape[0]
        x = jnp.stack([x_even, x_odd], axis=1).reshape(n, 6)
    return x
