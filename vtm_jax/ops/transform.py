"""VVC primary transforms (DCT2 / DST7 / DCT8), forward and inverse.

Behavioral contract from the reference (TrQuant.cpp:776 xT, :853 xIT;
TrQuant_EMT.cpp fastForward/Inverse*): separable integer transforms with
6-bit basis matrices (`rom.tr_matrix`), stage shifts

    inverse: shift1 = 7,              shift2 = 20 - bitDepth
    forward: shift1 = log2W + bitDepth + 6 - 15, shift2 = log2H + 6

and clipping of every stage output to [-2^15, 2^15-1] on the inverse path.
Inverse order is vertical then horizontal; forward is horizontal then
vertical.  Zero-out rules (>32-point DCT2, >16-point DST7/DCT8) are
enforced where coefficients are produced; on the inverse path the zeroed
region is zero so full matmuls are bit-exact.

Two implementations:
  * numpy `*_np` — exact int64 scalar reference used by the conformance
    decoder and as the oracle for kernel tests.
  * jax batched — int32 tensor version, bit-exact on every backend.
"""

from __future__ import annotations

import functools

import numpy as np

from vtm_jax.common import rom

MAX_LOG2_TR_DYNAMIC_RANGE = 15
COEFF_MIN = -(1 << MAX_LOG2_TR_DYNAMIC_RANGE)
COEFF_MAX = (1 << MAX_LOG2_TR_DYNAMIC_RANGE) - 1

DCT2, DCT8, DST7 = 0, 1, 2
_KIND_NAME = {DCT2: "DCT2", DCT8: "DCT8", DST7: "DST7"}


@functools.cache
def _mat(kind: int, size: int, forward: bool) -> np.ndarray:
    return rom.tr_matrix(_KIND_NAME[kind], size, forward).astype(np.int64)


def inv_transform_2d_np(
    coeff: np.ndarray, bit_depth: int, tr_hor: int = DCT2, tr_ver: int = DCT2
) -> np.ndarray:
    """Exact inverse 2D transform of an (H, W) int coefficient block."""
    h, w = coeff.shape
    c = coeff.astype(np.int64)
    shift1 = 7
    shift2 = 20 - bit_depth
    if h > 1 and w > 1:
        tv = _mat(tr_ver, h, forward=False)
        tmp = (tv.T @ c + (1 << (shift1 - 1))) >> shift1
        tmp = np.clip(tmp, COEFF_MIN, COEFF_MAX)
        th = _mat(tr_hor, w, forward=False)
        out = (tmp @ th + (1 << (shift2 - 1))) >> shift2
        return np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32)
    # 1-D cases get the +1 shift folded in (xIT 1-D branches)
    if w == 1:
        tv = _mat(tr_ver, h, forward=False)
        s = shift2 + 1
        out = (tv.T @ c + (1 << (s - 1))) >> s
    else:
        th = _mat(tr_hor, w, forward=False)
        s = shift2 + 1
        out = (c @ th + (1 << (s - 1))) >> s
    return np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32)


def fwd_transform_2d_np(
    resi: np.ndarray, bit_depth: int, tr_hor: int = DCT2, tr_ver: int = DCT2
) -> np.ndarray:
    """Exact forward 2D transform of an (H, W) residual block.

    Returns the coefficient block with zero-out applied (ref xT skipWidth/
    skipHeight): DCT2 keeps at most 32 low-freq coeffs per dim, DST7/DCT8
    at 32-point keep 16.
    """
    h, w = resi.shape
    r = resi.astype(np.int64)
    log2w, log2h = int(np.log2(w)), int(np.log2(h))
    def rnd(s: int) -> int:
        return (1 << (s - 1)) if s > 0 else 0

    if h > 1 and w > 1:
        shift1 = log2w + bit_depth + 6 - MAX_LOG2_TR_DYNAMIC_RANGE
        shift2 = log2h + 6
        th = _mat(tr_hor, w, forward=True)
        # horizontal first: rows of resi → coeff index
        tmp = (r @ th.T + rnd(shift1)) >> shift1
        tv = _mat(tr_ver, h, forward=True)
        out = (tv @ tmp + rnd(shift2)) >> shift2
    elif h == 1:
        shift = log2w + bit_depth + 6 - MAX_LOG2_TR_DYNAMIC_RANGE
        th = _mat(tr_hor, w, forward=True)
        out = (r @ th.T + rnd(shift)) >> shift
    else:
        shift = log2h + bit_depth + 6 - MAX_LOG2_TR_DYNAMIC_RANGE
        tv = _mat(tr_ver, h, forward=True)
        out = (tv @ r + rnd(shift)) >> shift
    out = out.astype(np.int32)
    # zero-out
    zw = 16 if (tr_hor != DCT2 and w == 32) else min(w, 32)
    zh = 16 if (tr_ver != DCT2 and h == 32) else min(h, 32)
    if w > zw:
        out[:, zw:] = 0
    if h > zh:
        out[zh:, :] = 0
    return out


# ---------------------------------------------------------------------------
# JAX batched versions
# ---------------------------------------------------------------------------

def _jnp():
    import jax.numpy as jnp  # deferred so numpy-only users avoid jax import

    return jnp


def _jmat(kind: int, size: int, forward: bool):
    # NB: do NOT cache the jnp array — inside a trace jnp.asarray yields a
    # tracer-wrapped constant and caching it leaks tracers across traces.
    jnp = _jnp()
    return jnp.asarray(_mat(kind, size, forward).astype(np.int32))


def inv_transform_batch(coeff, bit_depth: int, tr_hor: int = DCT2, tr_ver: int = DCT2):
    """Inverse transform a (B, H, W) int32 batch. Bit-exact, int32 math."""
    jnp = _jnp()
    b, h, w = coeff.shape
    shift1, shift2 = 7, 20 - bit_depth
    tv = _jmat(tr_ver, h, False)
    th = _jmat(tr_hor, w, False)
    tmp = (jnp.einsum("ky,bkx->byx", tv, coeff) + (1 << (shift1 - 1))) >> shift1
    tmp = jnp.clip(tmp, COEFF_MIN, COEFF_MAX)
    out = (jnp.einsum("byk,kx->byx", tmp, th) + (1 << (shift2 - 1))) >> shift2
    return jnp.clip(out, COEFF_MIN, COEFF_MAX)

