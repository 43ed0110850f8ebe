"""Distortion function registry — SAD / SSE / Hadamard SATD.

Behavioral contract from CommonLib/RdCost.cpp: the HAD family
(xGetHADs:2819 tiling dispatch; xCalcHADs8x8:2294, 4x4:2166, 2x2:2140,
16x8/8x16:2385/2526, 8x4/4x8:2659/2742) with the JVET-R0164 mean-scaled
DC term (TypeDef.h:62).  Each tile applies an unnormalized 2-D Hadamard
transform to the difference block, sums |coeff| with the DC term scaled
by 1/4, then normalizes by 2/sqrt(N):

    8x8  -> (s + 2) >> 2          4x4 -> (s + 1) >> 1
    16x8 -> int(s / sqrt(128) * 2) 8x4 -> int(s / sqrt(32) * 2)

Implemented as matrix products H_h @ D @ H_w^T with Sylvester-ordered
+-1 Hadamard matrices (row 0 = all ones, so [0,0] is the DC term; the
abs-coefficient sum is invariant to the reference's butterfly ordering).

Two implementations, bit-identical: numpy (scalar encoder paths) and a
jax/batched form (device RMD / ME kernels) in satd_batch_jax.
"""

from __future__ import annotations

import math

import numpy as np

_SQRT_NORM_16x8 = 2.0 / math.sqrt(16.0 * 8)
_SQRT_NORM_8x4 = 2.0 / math.sqrt(4.0 * 8)


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H = {n: _hadamard(n) for n in (2, 4, 8, 16)}


def _tile_satd_sum(d: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Mean-scaled abs-coefficient sum per (th, tw) tile.

    d: (..., th, tw) int64 difference tiles -> (...,) sums (pre-norm).
    """
    m = _H[th] @ d @ _H[tw].T
    a = np.abs(m)
    s = a.sum(axis=(-2, -1))
    dc = a[..., 0, 0]
    return s - dc + (dc >> 2)


def _tiles(d: np.ndarray, th: int, tw: int) -> np.ndarray:
    h, w = d.shape[-2:]
    lead = d.shape[:-2]
    t = d.reshape(*lead, h // th, th, w // tw, tw)
    return np.moveaxis(t, -3, -2)  # (..., h/th, w/tw, th, tw)


def satd(org: np.ndarray, cur: np.ndarray) -> int:
    """RdCost::xGetHADs — full-block Hadamard SATD (mean-scaled)."""
    d = org.astype(np.int64) - cur.astype(np.int64)
    h, w = d.shape
    if w > h and h % 8 == 0 and w % 16 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 16), 8, 16)
        return int((s.astype(np.float64) * _SQRT_NORM_16x8).astype(np.int64).sum())
    if w < h and w % 8 == 0 and h % 16 == 0:
        s = _tile_satd_sum(_tiles(d, 16, 8), 16, 8)
        return int((s.astype(np.float64) * _SQRT_NORM_16x8).astype(np.int64).sum())
    if w > h and h % 4 == 0 and w % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 4, 8), 4, 8)
        return int((s.astype(np.float64) * _SQRT_NORM_8x4).astype(np.int64).sum())
    if w < h and w % 4 == 0 and h % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 4), 8, 4)
        return int((s.astype(np.float64) * _SQRT_NORM_8x4).astype(np.int64).sum())
    if h % 8 == 0 and w % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 8), 8, 8)
        return int(((s + 2) >> 2).sum())
    if h % 4 == 0 and w % 4 == 0:
        s = _tile_satd_sum(_tiles(d, 4, 4), 4, 4)
        return int(((s + 1) >> 1).sum())
    if h % 2 == 0 and w % 2 == 0:
        s = _tile_satd_sum(_tiles(d, 2, 2), 2, 2)
        return int(s.sum())
    return int(np.abs(d).sum())


def satd_batch(org: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """Batched SATD: org/cur (..., h, w) -> (...,) int64, same tiling."""
    d = org.astype(np.int64) - cur.astype(np.int64)
    h, w = d.shape[-2:]
    if w > h and h % 8 == 0 and w % 16 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 16), 8, 16)
        return (s.astype(np.float64) * _SQRT_NORM_16x8).astype(np.int64).sum(axis=(-2, -1))
    if w < h and w % 8 == 0 and h % 16 == 0:
        s = _tile_satd_sum(_tiles(d, 16, 8), 16, 8)
        return (s.astype(np.float64) * _SQRT_NORM_16x8).astype(np.int64).sum(axis=(-2, -1))
    if w > h and h % 4 == 0 and w % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 4, 8), 4, 8)
        return (s.astype(np.float64) * _SQRT_NORM_8x4).astype(np.int64).sum(axis=(-2, -1))
    if w < h and w % 4 == 0 and h % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 4), 8, 4)
        return (s.astype(np.float64) * _SQRT_NORM_8x4).astype(np.int64).sum(axis=(-2, -1))
    if h % 8 == 0 and w % 8 == 0:
        return ((_tile_satd_sum(_tiles(d, 8, 8), 8, 8) + 2) >> 2).sum(axis=(-2, -1))
    if h % 4 == 0 and w % 4 == 0:
        return ((_tile_satd_sum(_tiles(d, 4, 4), 4, 4) + 1) >> 1).sum(axis=(-2, -1))
    if h % 2 == 0 and w % 2 == 0:
        return _tile_satd_sum(_tiles(d, 2, 2), 2, 2).sum(axis=(-2, -1))
    return np.abs(d).sum(axis=(-2, -1))


def sad(org: np.ndarray, cur: np.ndarray) -> int:
    return int(np.abs(org.astype(np.int64) - cur.astype(np.int64)).sum())


def sse(org: np.ndarray, cur: np.ndarray) -> int:
    d = org.astype(np.int64) - cur.astype(np.int64)
    return int((d * d).sum())


# ---------------------------------------------------------------------------
# jax batched form (device RMD / ME).  Same arithmetic in int32 (diff fits
# 10-bit samples; Hadamard growth <= N * max|d| < 2^23 for 8x8 10-bit).


def satd_batch_jax(diff, h: int, w: int):
    """diff: jax int32 (..., h, w) difference blocks -> (...,) int32 SATD.

    Matches satd_batch() / RdCost::xGetHADs for the same block shape.
    The Hadamard products run as float32 matmuls at HIGHEST precision
    (never TF32 on a GPU); exact for |diff| < 2^14 (8x8 tile growth 64x
    stays under the 2^24 float32 integer limit).
    """
    import jax
    import jax.numpy as jnp

    def tile_sum(d, th, tw):
        lead = d.shape[:-2]
        t = d.reshape(*lead, h // th, th, w // tw, tw)
        t = jnp.moveaxis(t, -3, -2).astype(jnp.float32)
        hh = jnp.asarray(_H[th], jnp.float32)
        hw = jnp.asarray(_H[tw], jnp.float32)
        m = jnp.matmul(
            jnp.matmul(hh, t, precision=jax.lax.Precision.HIGHEST),
            hw.T, precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
        a = jnp.abs(m)
        s = a.sum(axis=(-2, -1))
        dc = a[..., 0, 0]
        return s - dc + (dc >> 2)

    if w > h and h % 8 == 0 and w % 16 == 0:
        s = tile_sum(diff, 8, 16)
        return (s.astype(jnp.float32) * _SQRT_NORM_16x8).astype(jnp.int32).sum(axis=(-2, -1))
    if w < h and w % 8 == 0 and h % 16 == 0:
        s = tile_sum(diff, 16, 8)
        return (s.astype(jnp.float32) * _SQRT_NORM_16x8).astype(jnp.int32).sum(axis=(-2, -1))
    if w > h and h % 4 == 0 and w % 8 == 0:
        s = tile_sum(diff, 4, 8)
        return (s.astype(jnp.float32) * _SQRT_NORM_8x4).astype(jnp.int32).sum(axis=(-2, -1))
    if w < h and w % 4 == 0 and h % 8 == 0:
        s = tile_sum(diff, 8, 4)
        return (s.astype(jnp.float32) * _SQRT_NORM_8x4).astype(jnp.int32).sum(axis=(-2, -1))
    if h % 8 == 0 and w % 8 == 0:
        return ((tile_sum(diff, 8, 8) + 2) >> 2).sum(axis=(-2, -1))
    if h % 4 == 0 and w % 4 == 0:
        return ((tile_sum(diff, 4, 4) + 1) >> 1).sum(axis=(-2, -1))
    if h % 2 == 0 and w % 2 == 0:
        return tile_sum(diff, 2, 2).sum(axis=(-2, -1))
    return jnp.abs(diff).sum(axis=(-2, -1))
