"""Fused nearest-neighbour sweep for CUDA GPUs (Pallas, Triton route).

The GPU counterpart of :func:`lidar_slam_arvc_tpu.ops.nn.nn_search` for 3-D
points, used for every ICP correspondence search on the GPU.  One program
handles one block of sources of one cloud pair and loops over all target
tiles inside the kernel, so the (sources x targets) distance tile exists
only in registers: no score tile is written to device memory, and an ICP
iteration's whole sweep is one launch.

Distances are computed per coordinate in fp32 (dx^2 + dy^2 + dz^2): no
matmul identity, so neither TF32 rounding nor the ||s||^2 + ||t||^2 - 2 s.t
cancellation can reorder neighbours.  The running minimum is kept element
by element over (source, target lane) pairs, one compare and two selects
per pair with no cross-lane reduction inside the loop, and is reduced once
per program at the end, breaking ties towards the lowest target index.

Masked and padded targets are moved to the far sentinel ``_SENT``: their
squared distance to any terrestrial source exceeds 1e15 m^2, far beyond any
correspondence gate, so they cannot win against a valid target.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# -4e7 m lies beyond any terrestrial coordinate frame (UTM northings reach
# ~1e7 m), so a sentinel target is never nearer than a real one
_SENT = -4e7
_NO_INDEX = 2 ** 30


def block_size(n: int, cap: int) -> int:
    """Power-of-two block for ``n`` items: ``cap``, or less for small ``n``."""
    return max(16, min(cap, pl.next_power_of_2(n)))


def pad_to(x: jax.Array, n: int, fill: float) -> jax.Array:
    """Pad the leading axis of ``x`` to ``n`` rows of ``fill``."""
    pad = ((0, n - x.shape[0]),) + ((0, 0),) * (x.ndim - 1)
    return jnp.pad(x, pad, constant_values=fill)


def _nn_kernel(sx_ref, sy_ref, sz_ref, tx_ref, ty_ref, tz_ref,
               d2_ref, idx_ref, *, tgt_block: int):
    sx = sx_ref[...][:, None]
    sy = sy_ref[...][:, None]
    sz = sz_ref[...][:, None]
    shape = (sx.shape[0], tgt_block)

    def body(k, carry):
        best, tile = carry
        sl = pl.ds(pl.multiple_of(k * tgt_block, tgt_block), tgt_block)
        dx = sx - tx_ref[sl][None, :]
        dy = sy - ty_ref[sl][None, :]
        dz = sz - tz_ref[sl][None, :]
        d2 = dx * dx + dy * dy + dz * dz
        better = d2 < best
        return jnp.where(better, d2, best), jnp.where(better, k, tile)

    init = (jnp.full(shape, jnp.inf, jnp.float32),
            jnp.zeros(shape, jnp.int32))
    n_tiles = tx_ref.shape[0] // tgt_block
    best, tile = jax.lax.fori_loop(0, n_tiles, body, init)
    d2 = jnp.min(best, axis=1)
    lane = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    index = jnp.where(best == d2[:, None], tile * tgt_block + lane,
                      _NO_INDEX)
    d2_ref[...] = d2
    idx_ref[...] = jnp.min(index, axis=1)


@functools.partial(jax.jit, static_argnames=(
    "src_block", "tgt_block", "interpret"))
def nn_search_pallas(src: jax.Array, tgt: jax.Array, tgt_mask: jax.Array,
                     src_block: int = 64, tgt_block: int = 64,
                     interpret: bool = False):
    """Nearest valid target for every source point (3-D only).

    Same contract as :func:`lidar_slam_arvc_tpu.ops.nn.nn_search`:
    returns ``(idx (S,) int32, d2 (S,) f32)``.  Sources are split into
    blocks of ``src_block`` (one program each); targets are swept in tiles
    of ``tgt_block`` inside the program.  The default blocks and the 8
    warps measured fastest for 16384 x 16384 and 4096 x 16384 sweeps on an
    H100 (PERF.md).  ``interpret`` runs the kernel in
    the Pallas interpreter, for tests on a machine without a GPU.
    """
    S, T = src.shape[0], tgt.shape[0]
    bs, bt = block_size(S, src_block), block_size(T, tgt_block)
    Sp, Tp = pl.cdiv(S, bs) * bs, pl.cdiv(T, bt) * bt
    src_t = pad_to(src, Sp, 0.0).T
    tgt_t = pad_to(jnp.where(tgt_mask[:, None], tgt, _SENT), Tp, _SENT).T

    block = pl.BlockSpec((bs,), lambda i: (i,))
    whole = pl.BlockSpec((Tp,), lambda i: (0,))
    d2, idx = pl.pallas_call(
        functools.partial(_nn_kernel, tgt_block=bt),
        grid=(Sp // bs,),
        in_specs=[block] * 3 + [whole] * 3,
        out_specs=[block, block],
        out_shape=[jax.ShapeDtypeStruct((Sp,), jnp.float32),
                   jax.ShapeDtypeStruct((Sp,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=8),
        interpret=interpret,
        name="nn_sweep",
    )(*src_t, *tgt_t)
    return idx[:S], d2[:S]
