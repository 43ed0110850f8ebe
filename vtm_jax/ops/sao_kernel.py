"""Vectorized (device) SAO application kernel.

Dense whole-plane twin of SampleAdaptiveOffset::offsetBlock:293 (mirrored
by the scalar ops/sao.py _offset_block).  The running sign caches of the
reference are an optimization only — each pixel's edge class is
sgn(c - nA) + sgn(c - nB) on the pre-SAO plane, so the dense form is
order-free and bit-exact.  Per-CTU types/offsets/validity ranges arrive as
per-pixel maps (validity encodes the boundary-availability rules).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("bit_depth",))
def sao_apply(src, type_map, ctu_map, offsets, valid, bit_depth: int):
    """src int32 [H, W]; type_map 0..4; ctu_map CTU address per pixel;
    offsets int32 [n_ctu, 32] (EO at [0..4], BO spread at band positions);
    valid bool [H, W]."""
    pad = jnp.pad(src, 1, mode="edge")
    return sao_apply_ext(pad, type_map, ctu_map, offsets, valid, bit_depth)


def sao_apply_ext(pad, type_map, ctu_map, offsets, valid, bit_depth: int):
    """Core on a 1-sample-extended plane (halo-exchanged under sharding)."""
    maxv = (1 << bit_depth) - 1
    H, W = pad.shape[0] - 2, pad.shape[1] - 2
    c = pad[1:-1, 1:-1]

    def sh(dy, dx):
        return pad[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]

    def edge(a, b):
        return jnp.sign(c - a) + jnp.sign(c - b) + 2

    e0 = edge(sh(0, -1), sh(0, 1))
    e90 = edge(sh(-1, 0), sh(1, 0))
    e135 = edge(sh(-1, -1), sh(1, 1))
    e45 = edge(sh(-1, 1), sh(1, -1))
    band = c >> (bit_depth - 5)
    idx = jnp.select(
        [type_map == 0, type_map == 1, type_map == 2, type_map == 3],
        [e0, e90, e135, e45],
        band,
    )
    off = offsets[ctu_map, idx]
    out = jnp.clip(c + off, 0, maxv)
    return jnp.where(valid, out, c)
