"""Vectorized (device) deblocking filter kernels.

Design: the per-CU marking pass (ops/deblock.py phase 1) emits picture-wide
per-segment parameter maps on the 4x4 luma grid — boundary strength, tc,
beta, max filter lengths, palette no-filter flags — all of which are
sample-independent.  This module applies the normative luma/chroma edge
filters (LoopFilter.cpp xEdgeFilterLuma:434 / xEdgeFilterChroma:441,
xPelFilterLuma, xFilteringPandQ, xUseStrongFiltering) *densely* over the
whole segment grid as one batched integer computation per direction.

VVC deblocking is parallel within a direction by construction (the
max-filter-length rules guarantee the samples an edge writes are never
used by another edge's decisions or filtering in the same direction), so
the dense evaluation is bit-exact vs the sequential scalar reference —
verified by the golden-stream conformance tests.

Horizontal edges are filtered by transposing the plane and reusing the
vertical kernel with transposed maps.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

# position-coefficient tables of xFilteringPandQ (LoopFilter.cpp)
_DB7 = np.array([59, 50, 41, 32, 23, 14, 5], dtype=np.int32)
_DB5 = np.array([58, 45, 32, 19, 6, 0, 0], dtype=np.int32)
_DB3 = np.array([53, 32, 11, 0, 0, 0, 0], dtype=np.int32)
_TC7 = np.array([6, 5, 4, 3, 2, 1, 1], dtype=np.int32)
_TC3 = np.array([6, 4, 2, 0, 0, 0, 0], dtype=np.int32)


def _abs(x):
    return jnp.abs(x)


def _clip3(lo, hi, v):
    return jnp.clip(v, lo, hi)


# ---------------------------------------------------------------------------
# luma
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("bit_depth",))
def deblock_luma_ver(plane, active, tc, beta, max_p, max_q, no_p, no_q,
                     bit_depth: int):
    """Filter all vertical luma edges of `plane` in one dense pass.

    plane:  int32 [H, W] reconstruction (H, W multiples of 4).
    active: bool  [H4, W4] — segment has bs>0 and an available P neighbour.
    tc, beta, max_p, max_q: int32 [H4, W4] per-segment parameters
      (tc/beta already bit-depth scaled; max_p after the affine / CTU-row
      clamps of the marking pass).
    no_p, no_q: bool [H4, W4] palette no-filter flags.
    """
    pad = jnp.pad(plane, ((0, 0), (8, 8)), mode="edge")
    acc = luma_ver_delta(pad, active, tc, beta, max_p, max_q, no_p, no_q,
                         bit_depth)
    return plane + acc[:, 8:-8]


def luma_ver_delta(pad, active, tc, beta, max_p, max_q, no_p, no_q,
                   bit_depth: int):
    """Delta form of the vertical luma edge filter: `pad` is the plane
    extended by 8 columns each side (edge-replicated at picture borders,
    real neighbour halo under spatial sharding); returns the sample deltas
    over the extended width (overflow into the halo is the neighbour
    shard's contribution — disjoint by the max-filter-length rules)."""
    H, Wp = pad.shape
    W = Wp - 16
    H4, W4 = H // 4, W // 4
    maxv = (1 << bit_depth) - 1

    # gather windows: Wn[H4, W4, 4, 16]; j = 8+i maps to s[i], i in [-8, 7]
    ys = (jnp.arange(H4) * 4)[:, None] + jnp.arange(4)[None, :]          # [H4,4]
    xs = (jnp.arange(W4) * 4)[:, None] + jnp.arange(16)[None, :]         # [W4,16] (pad offset folds: x0-8+8)
    Wn = pad[ys[:, None, :, None], xs[None, :, None, :]]                 # [H4,W4,4,16]

    def s(line, i):
        return Wn[:, :, line, 8 + i]

    tc = tc[:, :]
    beta = beta[:, :]
    side_p = max_p > 3
    side_q = max_q > 3

    # --- decisions on lines 0 and 3 ---
    def calc_dp(line, off=0):
        return _abs(s(line, -3 + off) - 2 * s(line, -2 + off) + s(line, -1 + off))

    def calc_dq(line, off=0):
        return _abs(s(line, 0 + off) - 2 * s(line, 1 + off) + s(line, 2 + off))

    dp0, dq0 = calc_dp(0), calc_dq(0)
    dp3, dq3 = calc_dp(3), calc_dq(3)
    dp0l = jnp.where(side_p, (dp0 + calc_dp(0, -3) + 1) >> 1, dp0)
    dp3l = jnp.where(side_p, (dp3 + calc_dp(3, -3) + 1) >> 1, dp3)
    dq0l = jnp.where(side_q, (dq0 + calc_dq(0, 3) + 1) >> 1, dq0)
    dq3l = jnp.where(side_q, (dq3 + calc_dq(3, 3) + 1) >> 1, dq3)

    def use_strong_plain(line, d):
        # xUseStrongFiltering without large sides
        m4, m3, m7, m0 = s(line, 0), s(line, -1), s(line, 3), s(line, -4)
        return (
            ((_abs(m0 - m3) + _abs(m7 - m4)) < (beta >> 3))
            & (d < (beta >> 2))
            & (_abs(m3 - m4) < ((tc * 5 + 1) >> 1))
        )

    def use_strong_large(line, d):
        # xUseStrongFiltering with side_p_large/side_q_large extensions
        m4, m3, m7, m0 = s(line, 0), s(line, -1), s(line, 3), s(line, -4)
        sp3_base = _abs(m0 - m3)
        sq3_base = _abs(m7 - m4)
        sp3_l = jnp.where(
            max_p == 7,
            sp3_base + _abs(s(line, -5) - s(line, -6) - s(line, -7) + s(line, -8)),
            sp3_base,
        )
        mp4 = jnp.where(max_p == 7, s(line, -8), s(line, -6))
        sp3_l = (sp3_l + _abs(m0 - mp4) + 1) >> 1
        sp3_l = jnp.where(side_p, sp3_l, sp3_base)
        sq3_l = jnp.where(
            max_q == 7,
            sq3_base + _abs(s(line, 4) - s(line, 5) - s(line, 6) + s(line, 7)),
            sq3_base,
        )
        m11 = jnp.where(max_q == 7, s(line, 7), s(line, 5))
        sq3_l = (sq3_l + _abs(m11 - m7) + 1) >> 1
        sq3_l = jnp.where(side_q, sq3_l, sq3_base)
        return (
            ((sp3_l + sq3_l) < (beta * 3 >> 5))
            & (d < (beta >> 4))
            & (_abs(m3 - m4) < ((tc * 5 + 1) >> 1))
        )

    # --- long (large-side) path ---
    dl = (dp0l + dq0l) + (dp3l + dq3l)
    side_thresh = (beta + (beta >> 1)) >> 3
    swl = use_strong_large(0, 2 * (dp0l + dq0l)) & use_strong_large(3, 2 * (dp3l + dq3l))
    use_long = (side_p | side_q) & (dl < beta) & swl

    n_p = jnp.where(side_p, max_p, 3)
    n_q = jnp.where(side_q, max_q, 3)

    # xFilteringPandQ refs (line-wise; shape [H4,W4,4] by stacking lines)
    def sv(i):  # all 4 lines at offset i: [H4,W4,4]
        return Wn[:, :, :, 8 + i]

    e = lambda a: a[:, :, None]  # expand segment-level value over lines

    ref_p = jnp.where(
        e(n_p == 7), (sv(-7) + sv(-8) + 1) >> 1,
        jnp.where(e(n_p == 3), (sv(-3) + sv(-4) + 1) >> 1, (sv(-5) + sv(-6) + 1) >> 1),
    )
    ref_q = jnp.where(
        e(n_q == 7), (sv(6) + sv(7) + 1) >> 1,
        jnp.where(e(n_q == 3), (sv(2) + sv(3) + 1) >> 1, (sv(4) + sv(5) + 1) >> 1),
    )
    mid_55 = (2 * (sv(-1) + sv(0) + sv(-2) + sv(1) + sv(-3) + sv(2))
              + sv(-4) + sv(3) + sv(-5) + sv(4) + 8) >> 4
    mid_77 = (2 * (sv(-1) + sv(0)) + sv(-2) + sv(1) + sv(-3) + sv(2)
              + sv(-4) + sv(3) + sv(-5) + sv(4) + sv(-6) + sv(5)
              + sv(-7) + sv(6) + 8) >> 4
    mid_75 = (2 * (sv(-1) + sv(0) + sv(-2) + sv(1)) + sv(-3) + sv(2)
              + sv(-4) + sv(3) + sv(-5) + sv(4) + sv(-6) + sv(5) + 8) >> 4
    # asymmetric 7/3 (swapped-pointer form, see ops/deblock.py _filter_pq)
    mid_37 = (2 * (sv(0) + sv(-1)) + sv(-1) + 2 * (sv(-2) + sv(-3))
              + sv(1) + sv(-2) + sv(2) + sv(3) + sv(4) + sv(5) + sv(6) + 8) >> 4
    mid_73 = (2 * (sv(-1) + sv(0)) + sv(0) + 2 * (sv(1) + sv(2))
              + sv(-2) + sv(1) + sv(-3) + sv(-4) + sv(-5) + sv(-6) + sv(-7) + 8) >> 4
    mid_53 = (sv(-1) + sv(0) + sv(-2) + sv(1) + sv(-3) + sv(2)
              + sv(-4) + sv(3) + 4) >> 3
    mx = e(jnp.maximum(n_p, n_q))
    mn = e(jnp.minimum(n_p, n_q))
    mid = jnp.where(
        e(n_p == n_q),
        jnp.where(e(n_p == 5), mid_55, mid_77),
        jnp.where(
            (mx == 7) & (mn == 5), mid_75,
            jnp.where(
                (mx == 7) & (mn == 3),
                jnp.where(e(n_q > n_p), mid_37, mid_73),
                mid_53,
            ),
        ),
    )

    db7 = jnp.asarray(_DB7)
    db5 = jnp.asarray(_DB5)
    db3 = jnp.asarray(_DB3)
    tc7 = jnp.asarray(_TC7)
    tc3 = jnp.asarray(_TC3)

    def long_val(pos, p_side):
        n = n_p if p_side else n_q
        co = jnp.where(e(n == 7), db7[pos], jnp.where(e(n == 5), db5[pos], db3[pos]))
        tck = jnp.where(e(n == 3), tc3[pos], tc7[pos])
        src = sv(-1 - pos) if p_side else sv(pos)
        cval = (e(tc) * tck) >> 1
        refs = ref_p if p_side else ref_q
        out = (mid * co + refs * (64 - co) + 32) >> 6
        return _clip3(src - cval, src + cval, out)

    # --- short path ---
    d = (dp0 + dq0) + (dp3 + dq3)
    short_act = jnp.logical_not(use_long) & (d < beta)
    filter_p_s = (max_p > 1) & (max_q > 1) & ((dp0 + dp3) < side_thresh)
    filter_q_s = (max_p > 1) & (max_q > 1) & ((dq0 + dq3) < side_thresh)
    sw = (max_p > 2) & (max_q > 2) & use_strong_plain(0, 2 * (dp0 + dq0)) \
        & use_strong_plain(3, 2 * (dp3 + dq3))

    m0v, m1v, m2v, m3v = sv(-4), sv(-3), sv(-2), sv(-1)
    m4v, m5v, m6v, m7v = sv(0), sv(1), sv(2), sv(3)
    tcv = e(tc)
    # strong (3+3) filter values
    st_p0 = _clip3(m3v - 3 * tcv, m3v + 3 * tcv,
                   (m1v + 2 * m2v + 2 * m3v + 2 * m4v + m5v + 4) >> 3)
    st_q0 = _clip3(m4v - 3 * tcv, m4v + 3 * tcv,
                   (m2v + 2 * m3v + 2 * m4v + 2 * m5v + m6v + 4) >> 3)
    st_p1 = _clip3(m2v - 2 * tcv, m2v + 2 * tcv, (m1v + m2v + m3v + m4v + 2) >> 2)
    st_q1 = _clip3(m5v - 2 * tcv, m5v + 2 * tcv, (m3v + m4v + m5v + m6v + 2) >> 2)
    st_p2 = _clip3(m1v - tcv, m1v + tcv,
                   (2 * m0v + 3 * m1v + m2v + m3v + m4v + 4) >> 3)
    st_q2 = _clip3(m6v - tcv, m6v + tcv,
                   (m3v + m4v + m5v + 3 * m6v + 2 * m7v + 4) >> 3)
    # weak filter values
    delta = (9 * (m4v - m3v) - 3 * (m5v - m2v) + 8) >> 4
    wk_ok = _abs(delta) < e(tc * 10)
    dclip = _clip3(-tcv, tcv, delta)
    wk_p0 = _clip3(0, maxv, m3v + dclip)
    wk_q0 = _clip3(0, maxv, m4v - dclip)
    tc2 = tcv >> 1
    d1 = _clip3(-tc2, tc2, (((m1v + m3v + 1) >> 1) - m2v + dclip) >> 1)
    wk_p1 = _clip3(0, maxv, m2v + d1)
    d2 = _clip3(-tc2, tc2, (((m6v + m4v + 1) >> 1) - m5v - dclip) >> 1)
    wk_q1 = _clip3(0, maxv, m5v + d2)

    act = e(active)
    long_m = act & e(use_long)
    str_m = act & e(short_act & sw)
    wk_m = act & e(short_act & jnp.logical_not(sw)) & wk_ok
    nop = e(no_p)
    noq = e(no_q)
    pm = jnp.logical_not(nop)
    qm = jnp.logical_not(noq)

    out = Wn
    # long path writes, positions 0..6 on each side (xFilteringPandQ filters
    # both sides unconditionally once swl holds)
    for pos in range(7):
        wp = long_m & pm & e(pos < n_p)
        out = out.at[:, :, :, 8 - 1 - pos].set(
            jnp.where(wp, long_val(pos, True), out[:, :, :, 8 - 1 - pos]))
        wq = long_m & qm & e(pos < n_q)
        out = out.at[:, :, :, 8 + pos].set(
            jnp.where(wq, long_val(pos, False), out[:, :, :, 8 + pos]))
    # strong short writes p2..q2
    for pos, val in ((-1, st_p0), (-2, st_p1), (-3, st_p2)):
        out = out.at[:, :, :, 8 + pos].set(
            jnp.where(str_m & pm, val, out[:, :, :, 8 + pos]))
    for pos, val in ((0, st_q0), (1, st_q1), (2, st_q2)):
        out = out.at[:, :, :, 8 + pos].set(
            jnp.where(str_m & qm, val, out[:, :, :, 8 + pos]))
    # weak writes
    out = out.at[:, :, :, 7].set(jnp.where(wk_m & pm, wk_p0, out[:, :, :, 7]))
    out = out.at[:, :, :, 8].set(jnp.where(wk_m & qm, wk_q0, out[:, :, :, 8]))
    out = out.at[:, :, :, 6].set(
        jnp.where(wk_m & pm & e(filter_p_s), wk_p1, out[:, :, :, 6]))
    out = out.at[:, :, :, 9].set(
        jnp.where(wk_m & qm & e(filter_q_s), wk_q1, out[:, :, :, 9]))

    # overlap-sum of the per-window deltas into the padded plane as four
    # shifted adds: padded column c' = 4q'+r' receives window gx = q'-d at
    # tap j = r'+4d for d in 0..3; windows never overlap in rows.  Integer
    # sums, so the result does not depend on the order of the adds.
    delta_w = out - Wn  # [H4, W4, 4lines, 16]
    acc = jnp.zeros((H4, W4 + 4, 4, 4), dtype=delta_w.dtype)
    for d in range(4):
        sub = delta_w[:, :, :, 4 * d : 4 * d + 4]        # [H4, W4, 4, 4]
        acc = acc.at[:, d : d + W4].add(sub)
    return acc.transpose(0, 2, 1, 3).reshape(H, Wp)


@partial(jax.jit, static_argnames=("bit_depth", "hor", "has_l", "has_cb",
                                   "has_cr", "sx", "sy"))
def deblock_dir(y, cb, cr,
                l_act, l_tc, l_beta, l_mp, l_mq, l_nop, l_noq,
                cb_act, cb_tc, cb_beta, cr_act, cr_tc, cr_beta,
                c_large, c_nop, c_noq, c_hctb,
                bit_depth: int, hor: bool, has_l: bool, has_cb: bool,
                has_cr: bool, sx: int, sy: int):
    """Fused one-direction deblock over all components (one device
    dispatch per direction per picture).  Maps are on the 4x4 luma grid in
    picture orientation; HOR transposes on device."""
    if hor:
        y = y.T
        cb = cb.T
        cr = cr.T
        l_maps = (l_act.T, l_tc.T, l_beta.T, l_mp.T, l_mq.T, l_nop.T, l_noq.T)
        csl = (slice(None), slice(None, None, 1 << sy))
        c_cb = (cb_act.T[csl], cb_tc.T[csl], cb_beta.T[csl])
        c_cr = (cr_act.T[csl], cr_tc.T[csl], cr_beta.T[csl])
        c_sh = (c_large.T[csl], c_nop.T[csl], c_noq.T[csl], c_hctb.T[csl])
        loop_len, dec_line = 4 >> sx, (1 if sx else 3)
    else:
        l_maps = (l_act, l_tc, l_beta, l_mp, l_mq, l_nop, l_noq)
        csl = (slice(None), slice(None, None, 1 << sx))
        c_cb = (cb_act[csl], cb_tc[csl], cb_beta[csl])
        c_cr = (cr_act[csl], cr_tc[csl], cr_beta[csl])
        c_sh = (c_large[csl], c_nop[csl], c_noq[csl], c_hctb[csl])
        loop_len, dec_line = 4 >> sy, (1 if sy else 3)
    if has_l:
        pad = jnp.pad(y, ((0, 0), (8, 8)), mode="edge")
        y = y + luma_ver_delta(pad, *l_maps, bit_depth)[:, 8:-8]
    if has_cb:
        cb = chroma_ver_core(cb, *c_cb, *c_sh, bit_depth, loop_len, dec_line)
    if has_cr:
        cr = chroma_ver_core(cr, *c_cr, *c_sh, bit_depth, loop_len, dec_line)
    if hor:
        return y.T, cb.T, cr.T
    return y, cb, cr


# NOTE on the long-path p-side mask above: filter_p_l/filter_q_l gate nothing
# in the reference long path (xFilteringPandQ filters both sides
# unconditionally once swl holds); the `| True` keeps that explicit.


@partial(jax.jit, static_argnames=("bit_depth", "loop_len", "dec_line"))
def deblock_chroma_ver(plane, active, tc, beta, large, no_p, no_q, hor_ctb,
                       bit_depth: int, loop_len: int, dec_line: int):
    """Vertical-edge chroma filter, dense over the segment grid.

    plane: int32 [Hc, Wc].  Segment grid: rows in steps of loop_len, cols in
    steps of 4 chroma samples?  — the maps are provided on the *chroma
    segment grid* [Hs, Ws] where Hs = Hc // loop_len and Ws = Wc // 4 is the
    4-chroma-sample edge grid; inactive cells are masked out.
    dec_line: the second decision line index (1 if subsampled, else 3).
    """
    return chroma_ver_core(plane, active, tc, beta, large, no_p, no_q,
                           hor_ctb, bit_depth, loop_len, dec_line)


def chroma_ver_core(plane, active, tc, beta, large, no_p, no_q, hor_ctb,
                    bit_depth: int, loop_len: int, dec_line: int):
    Hc, Wc = plane.shape
    Hs, Ws = Hc // loop_len, Wc // 4
    maxv = (1 << bit_depth) - 1
    pad = jnp.pad(plane, ((0, 0), (4, 4)), mode="edge")

    ys = (jnp.arange(Hs) * loop_len)[:, None] + jnp.arange(loop_len)[None, :]
    xs = (jnp.arange(Ws) * 4)[:, None] + jnp.arange(8)[None, :]
    Wn = pad[ys[:, None, :, None], xs[None, :, None, :]]  # [Hs,Ws,L,8]

    def s(line, i):
        return Wn[:, :, line, 4 + i]

    def sv(i):
        return Wn[:, :, :, 4 + i]

    e = lambda a: a[:, :, None]

    # large-boundary decision (lines 0 and dec_line)
    def calc_dp(line):
        return jnp.where(
            hor_ctb,
            _abs(s(line, -2) - 2 * s(line, -2) + s(line, -1)),
            _abs(s(line, -3) - 2 * s(line, -2) + s(line, -1)),
        )

    def calc_dq(line):
        return _abs(s(line, 0) - 2 * s(line, 1) + s(line, 2))

    def use_strong(line, d):
        m4, m3, m7 = s(line, 0), s(line, -1), s(line, 3)
        sp3 = jnp.where(hor_ctb, _abs(s(line, -2) - m3), _abs(s(line, -4) - m3))
        sq3 = _abs(m7 - m4)
        return ((sp3 + sq3) < (beta >> 3)) & (d < (beta >> 2)) \
            & (_abs(m3 - m4) < ((tc * 5 + 1) >> 1))

    d0 = calc_dp(0) + calc_dq(0)
    d3 = calc_dp(dec_line) + calc_dq(dec_line)
    d = d0 + d3
    lg_act = large & (d < beta)
    sw = lg_act & use_strong(0, 2 * d0) & use_strong(dec_line, 2 * d3)

    m0v, m1v, m2v, m3v = sv(-4), sv(-3), sv(-2), sv(-1)
    m4v, m5v, m6v, m7v = sv(0), sv(1), sv(2), sv(3)
    tcv = e(tc)
    hcb = e(hor_ctb)

    # strong chroma values (both the ctb-row and normal variants)
    sp2 = _clip3(m1v - tcv, m1v + tcv, (3 * m0v + 2 * m1v + m2v + m3v + m4v + 4) >> 3)
    sp1 = _clip3(m2v - tcv, m2v + tcv,
                 (2 * m0v + m1v + 2 * m2v + m3v + m4v + m5v + 4) >> 3)
    sp0 = jnp.where(
        hcb,
        _clip3(m3v - tcv, m3v + tcv, (3 * m2v + 2 * m3v + m4v + m5v + m6v + 4) >> 3),
        _clip3(m3v - tcv, m3v + tcv, (m0v + m1v + m2v + 2 * m3v + m4v + m5v + m6v + 4) >> 3),
    )
    sq0 = jnp.where(
        hcb,
        _clip3(m4v - tcv, m4v + tcv, (2 * m2v + m3v + 2 * m4v + m5v + m6v + m7v + 4) >> 3),
        _clip3(m4v - tcv, m4v + tcv, (m1v + m2v + m3v + 2 * m4v + m5v + m6v + m7v + 4) >> 3),
    )
    sq1 = _clip3(m5v - tcv, m5v + tcv, (m2v + m3v + m4v + 2 * m5v + m6v + 2 * m7v + 4) >> 3)
    sq2 = _clip3(m6v - tcv, m6v + tcv, (m3v + m4v + m5v + 2 * m6v + 3 * m7v + 4) >> 3)
    # weak chroma
    dclip = _clip3(-tcv, tcv, (((m4v - m3v) * 4) + m2v - m5v + 4) >> 3)
    wp0 = _clip3(0, maxv, m3v + dclip)
    wq0 = _clip3(0, maxv, m4v - dclip)

    act = e(active)
    sw_m = act & e(sw)
    wk_m = act & e(jnp.logical_not(sw))
    pm = jnp.logical_not(e(no_p))
    qm = jnp.logical_not(e(no_q))

    out = Wn
    # strong writes: p side depends on hor_ctb (writes p0 only at CTB row)
    out = out.at[:, :, :, 3].set(jnp.where(sw_m & pm, sp0, out[:, :, :, 3]))
    out = out.at[:, :, :, 2].set(
        jnp.where(sw_m & pm & jnp.logical_not(hcb), sp1, out[:, :, :, 2]))
    out = out.at[:, :, :, 1].set(
        jnp.where(sw_m & pm & jnp.logical_not(hcb), sp2, out[:, :, :, 1]))
    out = out.at[:, :, :, 4].set(jnp.where(sw_m & qm, sq0, out[:, :, :, 4]))
    out = out.at[:, :, :, 5].set(jnp.where(sw_m & qm, sq1, out[:, :, :, 5]))
    out = out.at[:, :, :, 6].set(jnp.where(sw_m & qm, sq2, out[:, :, :, 6]))
    # weak writes p0/q0
    out = out.at[:, :, :, 3].set(jnp.where(wk_m & pm, wp0, out[:, :, :, 3]))
    out = out.at[:, :, :, 4].set(jnp.where(wk_m & qm, wq0, out[:, :, :, 4]))

    # overlap-sum without scatter: padded col c' = 4q'+r' receives window
    # gx = q'-d at tap j = r'+4d for d in 0..1 (8-wide windows, 4 apart);
    # row groups (loop_len) never overlap.
    delta_w = out - Wn  # [Hs, Ws, L, 8]
    acc = jnp.zeros((Hs, Ws + 2, loop_len, 4), dtype=delta_w.dtype)
    for d in range(2):
        acc = acc.at[:, d : d + Ws].add(delta_w[:, :, :, 4 * d : 4 * d + 4])
    acc = acc.transpose(0, 2, 1, 3).reshape(Hc, Wc + 8)
    return plane + acc[:, 4:-4]
