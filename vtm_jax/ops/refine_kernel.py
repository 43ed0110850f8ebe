"""Batched (device) DMVR bilateral search and BDOF optical-flow kernels.

Mirrors the scalar reference in decoder/refine.py (InterPrediction.cpp
xProcessDMVR / xBIPMVRefine / xDMVRCost / xSubPelErrorSrfc / applyBiOptFlow)
as dense integer computations over batches of 16x16-class sub-PUs.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from vtm_jax.common import rom

_BILINEAR = np.asarray(rom.get("bilinearFilterPrec4"), dtype=np.int32)  # (16,2)
IF_INTERNAL_PREC = 14
IF_OFFS = 1 << (IF_INTERNAL_PREC - 1)

# xBIPMVRefine search offsets in evaluation order (raster dy,dx in [-2,2])
_OFFS = [(dx, dy) for dy in range(-2, 3) for dx in range(-2, 3)]


def _bilinear_batch(pre, fx, fy, w: int, h: int, bd: int):
    """2-tap bilinear search-grid generation (xinitMC), batched.

    pre: int32 [N, h+3, w+3] prefetch windows (grid origin at (1,1));
    fx, fy: int32 [N] fractional phases.  Returns [N, h, w] 10-bit grids.
    """
    c = jnp.asarray(_BILINEAR)
    cx0 = c[fx, 0][:, None, None]
    cx1 = c[fx, 1][:, None, None]
    cy0 = c[fy, 0][:, None, None]
    cy1 = c[fy, 1][:, None, None]
    src = pre[:, 1 : 1 + h + 1, 1 : 1 + w + 1]
    s = 4 - (10 - bd)
    off = 1 << (s - 1)
    both0 = src[:, :h, :w] << (10 - bd)
    hx = (cx0 * src[:, :h, :w] + cx1 * src[:, :h, 1 : w + 1] + off) >> s
    vy = (cy0 * src[:, :h, :w] + cy1 * src[:, 1 : h + 1, :w] + off) >> s
    tmp = (cx0 * src[:, :, :w] + cx1 * src[:, :, 1 : w + 1] + off) >> s
    hv = (cy0 * tmp[:, :h, :] + cy1 * tmp[:, 1 : h + 1, :] + 8) >> 4
    fx0 = (fx == 0)[:, None, None]
    fy0 = (fy == 0)[:, None, None]
    return jnp.where(fx0 & fy0, both0, jnp.where(fy0, hx, jnp.where(fx0, vy, hv)))


def _div_for_maxq7(num, den):
    """xDivForMaxq7, vectorized (den > 0)."""
    sign = num < 0
    n = jnp.abs(num)
    d = den << 3
    ge = n >= d
    n = jnp.where(ge, n - d, n)
    q = ge.astype(jnp.int32)
    q = q << 1
    d = d >> 1
    ge = n >= d
    n = jnp.where(ge, n - d, n)
    q = q + ge
    q = q << 1
    q = q + (n >= (d >> 1))
    return jnp.where(sign, -q, q)


@partial(jax.jit, static_argnames=("bd", "dx", "dy"))
def dmvr_search(pre0, pre1, f0x, f0y, f1x, f1y, bd: int, dx: int, dy: int):
    """xBIPMVRefine + xDMVRSubPixelErrorSurface, batched over sub-PUs.

    pre0/pre1: int32 [N, dy+7, dx+7] luma prefetch windows.
    Returns (total_x, total_y, min_cost): int32 [N] each; totals are the
    refined MVD in internal 1/16 precision.
    """
    g0 = _bilinear_batch(pre0, f0x, f0y, dx + 4, dy + 4, bd)
    g1 = _bilinear_batch(pre1, f1x, f1y, dx + 4, dy + 4, bd)

    costs = []
    for dmx, dmy in _OFFS:
        a = g0[:, 2 + dmy : 2 + dmy + dy : 2, 2 + dmx : 2 + dmx + dx]
        b = g1[:, 2 - dmy : 2 - dmy + dy : 2, 2 - dmx : 2 - dmx + dx]
        costs.append(jnp.sum(jnp.abs(a - b), axis=(1, 2)))
    costs = jnp.stack(costs, axis=1)  # [N, 25]

    c00 = costs[:, 12]
    minc0 = c00 - (c00 >> 2)
    early = minc0 < (dx * dy)
    cvec = costs.at[:, 12].set(minc0)
    # xBIPMVRefine scans with minCost pre-seeded to the biased centre and
    # strict <, so an offset that TIES the centre loses to it even when it
    # comes earlier in scan order; plain argmin would pick the earlier
    # index.  Resolve: centre wins any tie with the global minimum.
    min_cost = jnp.min(cvec, axis=1)
    best = jnp.argmin(cvec, axis=1).astype(jnp.int32)  # first-min, eval order
    best = jnp.where(minc0 == min_cost, 12, best)
    bx = best % 5 - 2
    by = best // 5 - 2
    bx = jnp.where(early, 0, bx)
    by = jnp.where(early, 0, by)
    min_cost = jnp.where(early, minc0, min_cost)

    total_x = bx << 4
    total_y = by << 4
    do_sub = jnp.logical_not(early) & (jnp.abs(bx) != 2) & (jnp.abs(by) != 2)

    def nb(dy_, dx_):
        idx = jnp.clip((by + 2 + dy_) * 5 + (bx + 2 + dx_), 0, 24)[:, None]
        return jnp.take_along_axis(cvec, idx, axis=1)[:, 0]

    sC, sL, sT, sR, sB = min_cost, nb(0, -1), nb(-1, 0), nb(0, 1), nb(1, 0)

    def axis_delta(sa, sb):
        num = (sa - sb) << 4
        den = sa + sb - (sC << 1)
        d_div = _div_for_maxq7(num, den)
        d_edge = jnp.where(sa == sC, -8, 8)
        d = jnp.where((sa != sC) & (sb != sC), d_div, d_edge)
        return jnp.where(den != 0, d, 0)

    total_x = total_x + jnp.where(do_sub, axis_delta(sL, sR), 0)
    total_y = total_y + jnp.where(do_sub, axis_delta(sT, sB), 0)
    # stacked into one output: a single device->host sync
    return jnp.stack([total_x, total_y, min_cost])


@partial(jax.jit, static_argnames=("w", "h", "wc", "hc", "bd", "nc"))
def dmvr_final_pack(l0, l1, cargs, w: int, h: int, wc: int, hc: int,
                    bd: int, nc: int):
    """Both lists' final luma FIR + all chroma FIRs in ONE dispatch,
    outputs packed into a single flat vector (one sync).

    l0/l1: (bufs, x0, y0, cfh, cfv) luma args; cargs: tuple of nc
    (bufs, x0, y0, cfh, cfv) chroma args (list-major order)."""
    parts = []
    for a in (l0, l1):
        parts.append(fir_blocks(*a, w=w, h=h, taps=8, bd=bd).reshape(-1))
    for a in cargs:
        parts.append(fir_blocks(*a, w=wc, h=hc, taps=4, bd=bd).reshape(-1))
    return jnp.concatenate(parts)


@partial(jax.jit, static_argnames=("w", "h", "taps", "bd"))
def fir_blocks(bufs, x0, y0, cfh, cfv, w: int, h: int, taps: int, bd: int):
    """Batched two-pass FIR over per-block private support buffers, producing
    the 14-bit intermediate (the rnd=False / notLast path of
    InterpolationFilter::filter).  Reads clamp at buffer edges, which equals
    the reference's edge-padded DMVR prefetch buffers (xFinalPaddedMCForDMVR):
    replication is idempotent under further clamping.

    bufs: int32 [N, H, W]; x0, y0: int32 [N] block sample origin inside the
    buffer; cfh, cfv: int32 [N, taps] (identity row for phase 0).
    Returns int32 [N, h, w]."""
    N, H, W = bufs.shape
    half = taps // 2 - 1
    hr = max(2, IF_INTERNAL_PREC - bd)
    s1 = 6 - hr
    off1 = -(IF_OFFS << s1)
    iy = jnp.clip(y0[:, None] - half + jnp.arange(h + taps - 1), 0, H - 1)
    ix = jnp.clip(x0[:, None] - half + jnp.arange(w + taps - 1), 0, W - 1)
    win = bufs[jnp.arange(N)[:, None, None], iy[:, :, None], ix[:, None, :]]
    tmp = jnp.zeros((N, h + taps - 1, w), dtype=jnp.int32)
    for k in range(taps):
        tmp = tmp + cfh[:, k, None, None] * win[:, :, k : k + w]
    tmp = (tmp + off1) >> s1
    acc = jnp.zeros((N, h, w), dtype=jnp.int32)
    for k in range(taps):
        acc = acc + cfv[:, k, None, None] * tmp[:, k : k + h, :]
    return acc >> 6


def _floor_log2(x):
    """Exact integer floor(log2(max(x,1))) via comparisons."""
    lg = jnp.zeros_like(x)
    for i in range(1, 20):
        lg = lg + (x >= (1 << i)).astype(x.dtype)
    return lg


@partial(jax.jit, static_argnames=("bd", "w", "h"))
def bdof_blend_batch(p0e, p1e, bd: int, w: int, h: int):
    """applyBiOptFlow core, batched: p0e/p1e int32 [N, h+2, w+2] extended
    predictions (centre = 14-bit MC, ring = shifted integer samples).
    Returns int32 [N, h, w] final samples."""
    shift1 = 6
    N = p0e.shape[0]

    def grads(pe):
        gx_i = (pe[:, 1 : h + 1, 2 : w + 2] >> shift1) - (pe[:, 1 : h + 1, 0:w] >> shift1)
        gy_i = (pe[:, 2 : h + 2, 1 : w + 1] >> shift1) - (pe[:, 0:h, 1 : w + 1] >> shift1)
        # replicate-pad to (h+2, w+2)
        def pad2(g):
            g = jnp.concatenate([g[:, :, :1], g, g[:, :, -1:]], axis=2)
            g = jnp.concatenate([g[:, :1, :], g, g[:, -1:, :]], axis=1)
            return g
        return pad2(gx_i), pad2(gy_i)

    gx0, gy0 = grads(p0e)
    gx1, gy1 = grads(p1e)

    def repad(pe):
        inner = pe[:, 1 : h + 1, 1 : w + 1]
        g = jnp.concatenate([inner[:, :, :1], inner, inner[:, :, -1:]], axis=2)
        g = jnp.concatenate([g[:, :1, :], g, g[:, -1:, :]], axis=1)
        return g

    p0r = repad(p0e)
    p1r = repad(p1e)

    shift_num = IF_INTERNAL_PREC + 1 - bd
    offset = (1 << (shift_num - 1)) + 2 * IF_OFFS
    limit = 15
    maxv = (1 << bd) - 1

    tmp_gx = (gx0 + gx1) >> 1
    tmp_gy = (gy0 + gy1) >> 1
    tmp_di = (p1r >> 4) - (p0r >> 4)
    sgx = jnp.sign(tmp_gx)
    sgy = jnp.sign(tmp_gy)

    nby, nbx = h // 4, w // 4

    def wsum(a):
        s = jnp.zeros((N, nby, nbx), dtype=jnp.int32)
        for i in range(6):
            for j in range(6):
                s = s + a[:, i : i + 4 * nby : 4, j : j + 4 * nbx : 4]
        return s

    sum_abs_gx = wsum(jnp.abs(tmp_gx))
    sum_abs_gy = wsum(jnp.abs(tmp_gy))
    sum_dix = wsum(sgx * tmp_di)
    sum_diy = wsum(sgy * tmp_di)
    sum_sign = wsum(sgy * tmp_gx)

    lg_gx = _floor_log2(jnp.maximum(sum_abs_gx, 1))
    lg_gy = _floor_log2(jnp.maximum(sum_abs_gy, 1))
    tmpx = jnp.where(sum_abs_gx == 0, 0, (sum_dix << 2) >> lg_gx)
    tmpx = jnp.clip(tmpx, -limit, limit)
    mains = sum_sign >> 12
    secs = sum_sign & 4095
    tmp_data = (((tmpx * mains) << 12) + tmpx * secs) >> 1
    tmpy = jnp.where(sum_abs_gy == 0, 0, ((sum_diy << 2) - tmp_data) >> lg_gy)
    tmpy = jnp.clip(tmpy, -limit, limit)

    tx = jnp.repeat(jnp.repeat(tmpx, 4, axis=1), 4, axis=2)
    ty = jnp.repeat(jnp.repeat(tmpy, 4, axis=1), 4, axis=2)
    inner = (slice(None), slice(1, h + 1), slice(1, w + 1))
    b = tx * (gx0[inner] - gx1[inner]) + ty * (gy0[inner] - gy1[inner])
    val = (p0r[inner] + p1r[inner] + b + offset) >> shift_num
    return jnp.clip(val, 0, maxv)
