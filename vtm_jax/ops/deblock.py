"""VVC deblocking filter — exact integer reference implementation.

Behavioral contract from CommonLib/LoopFilter.cpp: two picture sweeps
(vertical then horizontal edges, loopFilterPic:144), per-CTU edge marking
from TU/PU geometry (xDeblockCU:270, xSetEdgefilterMultiple,
xSetMaxFilterLengthPQFromTransformSizes), boundary strengths
(xGetBoundaryStrengthSingle:410), and the luma short/long and chroma
filters (xEdgeFilterLuma:434, xEdgeFilterChroma, xPelFilterLuma/Chroma,
xFilteringPandQ, xUseStrongFiltering).
"""

from __future__ import annotations

import numpy as np

from vtm_jax.decoder.cs import CH_C, CH_L, MODE_INTRA, TREE_C

TC_TABLE = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 4, 4, 4, 4, 5, 5,
    5, 5, 7, 7, 8, 9, 10, 10, 11, 13, 14, 15, 17, 19, 21, 24, 25, 29, 33, 36,
    41, 45, 51, 57, 64, 71, 80, 89, 100, 112, 125, 141, 157, 177, 198, 222,
    250, 280, 314, 352, 395,
]
BETA_TABLE = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
    44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78,
    80, 82, 84, 86, 88,
]
DEFAULT_INTRA_TC_OFFSET = 2
EDGE_VER, EDGE_HOR = 0, 1
_TC_TABLE_NP = np.asarray(TC_TABLE, dtype=np.int32)
_BETA_TABLE_NP = np.asarray(BETA_TABLE, dtype=np.int32)


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


class _Line:
    """1-D sample accessor along the filtering direction (Pel* + offset)."""

    __slots__ = ("plane", "x", "y", "dx", "dy")

    def __init__(self, plane, x, y, dx, dy):
        self.plane = plane
        self.x = x
        self.y = y
        self.dx = dx
        self.dy = dy

    def __getitem__(self, i):
        # clamp: the reference reads from padded margins; out-of-range values
        # are only ever read when unused by the active filter decision
        y = min(max(self.y + i * self.dy, 0), self.plane.shape[0] - 1)
        x = min(max(self.x + i * self.dx, 0), self.plane.shape[1] - 1)
        return int(self.plane[y, x])

    def __setitem__(self, i, v):
        self.plane[self.y + i * self.dy, self.x + i * self.dx] = v


def _calc_dp(s: _Line, chroma_hor_ctb: bool = False) -> int:
    if chroma_hor_ctb:
        return abs(s[-2] - 2 * s[-2] + s[-1])
    return abs(s[-3] - 2 * s[-2] + s[-1])


def _calc_dq(s: _Line) -> int:
    return abs(s[0] - 2 * s[1] + s[2])


def _use_strong(s: _Line, d: int, beta: int, tc: int, side_p_large=False,
                side_q_large=False, max_p=7, max_q=7, chroma_hor_ctb=False) -> bool:
    m4, m3, m7, m0, m2 = s[0], s[-1], s[3], s[-4], s[-2]
    sp3 = abs(m2 - m3) if chroma_hor_ctb else abs(m0 - m3)
    sq3 = abs(m7 - m4)
    d_strong = sp3 + sq3
    if side_p_large or side_q_large:
        if side_p_large:
            if max_p == 7:
                mp5, mp6, mp7, mp4 = s[-5], s[-6], s[-7], s[-8]
                sp3 = sp3 + abs(mp5 - mp6 - mp7 + mp4)
            else:
                mp4 = s[-6]
            sp3 = (sp3 + abs(m0 - mp4) + 1) >> 1
        if side_q_large:
            if max_q == 7:
                m8, m9, m10, m11 = s[4], s[5], s[6], s[7]
                sq3 = sq3 + abs(m8 - m9 - m10 + m11)
            else:
                m11 = s[5]
            sq3 = (sq3 + abs(m11 - m7) + 1) >> 1
        return (
            (sp3 + sq3) < (beta * 3 >> 5)
            and d < (beta >> 4)
            and abs(m3 - m4) < ((tc * 5 + 1) >> 1)
        )
    return (
        d_strong < (beta >> 3) and d < (beta >> 2)
        and abs(m3 - m4) < ((tc * 5 + 1) >> 1)
    )


def _bilinear(s: _Line, ref_middle, ref_p, ref_q, n_p, n_q, co_p, co_q, tc):
    tc7 = [6, 5, 4, 3, 2, 1, 1]
    tc3 = [6, 4, 2]
    tc_p = tc3 if n_p == 3 else tc7
    tc_q = tc3 if n_q == 3 else tc7
    for pos in range(n_p):
        src = s[-1 - pos]
        cval = (tc * tc_p[pos]) >> 1
        s[-1 - pos] = _clip3(
            src - cval, src + cval,
            (ref_middle * co_p[pos] + ref_p * (64 - co_p[pos]) + 32) >> 6,
        )
    for pos in range(n_q):
        src = s[pos]
        cval = (tc * tc_q[pos]) >> 1
        s[pos] = _clip3(
            src - cval, src + cval,
            (ref_middle * co_q[pos] + ref_q * (64 - co_q[pos]) + 32) >> 6,
        )


def _filter_pq(s: _Line, n_p, n_q, tc):
    db7 = [59, 50, 41, 32, 23, 14, 5]
    db3 = [53, 32, 11]
    db5 = [58, 45, 32, 19, 6]
    co_p = db7 if n_p == 7 else (db5 if n_p == 5 else db3)
    co_q = db7 if n_q == 7 else (db5 if n_q == 5 else db3)
    # refP from P side samples: srcP = s at -1 offsets
    if n_p == 7:
        ref_p = (s[-7] + s[-8] + 1) >> 1
    elif n_p == 3:
        ref_p = (s[-3] + s[-4] + 1) >> 1
    else:
        ref_p = (s[-5] + s[-6] + 1) >> 1
    if n_q == 7:
        ref_q = (s[6] + s[7] + 1) >> 1
    elif n_q == 3:
        ref_q = (s[2] + s[3] + 1) >> 1
    else:
        ref_q = (s[4] + s[5] + 1) >> 1
    if n_p == n_q:
        if n_p == 5:
            ref_middle = (2 * (s[-1] + s[0] + s[-2] + s[1] + s[-3] + s[2])
                          + s[-4] + s[3] + s[-5] + s[4] + 8) >> 4
        else:
            ref_middle = (2 * (s[-1] + s[0]) + s[-2] + s[1] + s[-3] + s[2]
                          + s[-4] + s[3] + s[-5] + s[4] + s[-6] + s[5]
                          + s[-7] + s[6] + 8) >> 4
    else:
        if max(n_p, n_q) == 7 and min(n_p, n_q) == 5:
            ref_middle = (2 * (s[-1] + s[0] + s[-2] + s[1]) + s[-3] + s[2]
                          + s[-4] + s[3] + s[-5] + s[4] + s[-6] + s[5] + 8) >> 4
        elif max(n_p, n_q) == 7 and min(n_p, n_q) == 3:
            # asymmetric 7/3: formulated over swapped P/Q pointers
            if n_q > n_p:  # P'=Q side (long), Q'=P side (short)
                pt0, qt0 = s[0], s[-1]
                qt = lambda i: s[-1 - i]
                pt = lambda i: s[i]
            else:
                pt0, qt0 = s[-1], s[0]
                qt = lambda i: s[i]
                pt = lambda i: s[-1 - i]
            ref_middle = (2 * (pt0 + qt0) + qt0 + 2 * (qt(1) + qt(2))
                          + pt(1) + qt(1) + pt(2) + pt(3) + pt(4) + pt(5)
                          + pt(6) + 8) >> 4
        else:  # 5/3
            ref_middle = (s[-1] + s[0] + s[-2] + s[1] + s[-3] + s[2]
                          + s[-4] + s[3] + 4) >> 3
    _bilinear(s, ref_middle, ref_p, ref_q, n_p, n_q, co_p, co_q, tc)


def _pel_filter_luma(s: _Line, tc, sw, no_p, no_q, thr_cut, filter_p, filter_q,
                     maxv, side_p_large=False, side_q_large=False,
                     max_p=7, max_q=7):
    m4, m3, m5, m2 = s[0], s[-1], s[1], s[-2]
    m6, m1, m7, m0 = s[2], s[-3], s[3], s[-4]
    # long-side samples only exist (and are only needed) for large sides
    if side_p_large and no_p:
        mp1, mp2, mp3 = s[-5], s[-6], s[-7]
    if side_q_large and no_q:
        m8, m9, m10 = s[4], s[5], s[6]
    tc3 = [3, 2, 1]
    if sw:
        if side_p_large or side_q_large:
            _filter_pq(s, max_p if side_p_large else 3, max_q if side_q_large else 3, tc)
        else:
            s[-1] = _clip3(m3 - tc3[0] * tc, m3 + tc3[0] * tc,
                           (m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3)
            s[0] = _clip3(m4 - tc3[0] * tc, m4 + tc3[0] * tc,
                          (m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3)
            s[-2] = _clip3(m2 - tc3[1] * tc, m2 + tc3[1] * tc,
                           (m1 + m2 + m3 + m4 + 2) >> 2)
            s[1] = _clip3(m5 - tc3[1] * tc, m5 + tc3[1] * tc,
                          (m3 + m4 + m5 + m6 + 2) >> 2)
            s[-3] = _clip3(m1 - tc3[2] * tc, m1 + tc3[2] * tc,
                           (2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3)
            s[2] = _clip3(m6 - tc3[2] * tc, m6 + tc3[2] * tc,
                          (m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3)
    else:
        delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4
        if abs(delta) < thr_cut:
            delta = _clip3(-tc, tc, delta)
            s[-1] = _clip3(0, maxv, m3 + delta)
            s[0] = _clip3(0, maxv, m4 - delta)
            tc2 = tc >> 1
            if filter_p:
                delta1 = _clip3(-tc2, tc2, (((m1 + m3 + 1) >> 1) - m2 + delta) >> 1)
                s[-2] = _clip3(0, maxv, m2 + delta1)
            if filter_q:
                delta2 = _clip3(-tc2, tc2, (((m6 + m4 + 1) >> 1) - m5 - delta) >> 1)
                s[1] = _clip3(0, maxv, m5 + delta2)
    if no_p:
        s[-1], s[-2], s[-3] = m3, m2, m1
        if side_p_large:
            s[-4], s[-5], s[-6], s[-7] = m0, mp1, mp2, mp3
    if no_q:
        s[0], s[1], s[2] = m4, m5, m6
        if side_q_large:
            s[3], s[4], s[5], s[6] = m7, m8, m9, m10


def _pel_filter_chroma(s: _Line, tc, sw, no_p, no_q, maxv, large_boundary,
                       chroma_hor_ctb):
    m0, m1, m2, m3 = s[-4], s[-3], s[-2], s[-1]
    m4, m5, m6, m7 = s[0], s[1], s[2], s[3]
    if sw:
        if chroma_hor_ctb:
            s[-1] = _clip3(m3 - tc, m3 + tc, (3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3)
            s[0] = _clip3(m4 - tc, m4 + tc, (2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3)
            s[1] = _clip3(m5 - tc, m5 + tc, (m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3)
            s[2] = _clip3(m6 - tc, m6 + tc, (m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3)
        else:
            s[-3] = _clip3(m1 - tc, m1 + tc, (3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3)
            s[-2] = _clip3(m2 - tc, m2 + tc, (2 * m0 + m1 + 2 * m2 + m3 + m4 + m5 + 4) >> 3)
            s[-1] = _clip3(m3 - tc, m3 + tc, (m0 + m1 + m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3)
            s[0] = _clip3(m4 - tc, m4 + tc, (m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3)
            s[1] = _clip3(m5 - tc, m5 + tc, (m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3)
            s[2] = _clip3(m6 - tc, m6 + tc, (m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3)
    else:
        delta = _clip3(-tc, tc, (((m4 - m3) * 4) + m2 - m5 + 4) >> 3)
        s[-1] = _clip3(0, maxv, m3 + delta)
        s[0] = _clip3(0, maxv, m4 - delta)
    if no_p:
        if large_boundary:
            s[-3], s[-2] = m1, m2
        s[-1] = m3
    if no_q:
        if large_boundary:
            s[1], s[2] = m5, m6
        s[0] = m4


class DeblockState:
    """Edge maps (the m_aapucBS / maxFilterLength arrays).

    Historically per-CTU (square ctu_size extent, like the reference's
    m_aapucBS); when pic_w/pic_h are given the arrays span the whole
    picture so the vectorized BS/collect passes run ONCE per direction
    instead of per CTU.  Marking semantics are identical: every cell is
    owned by exactly one CU, and the subblock max-length lookbehind/
    lookahead never leaves the owning CU (see _set_max_filter_len_
    subblocks), so picture-wide accumulation cannot alias."""

    def __init__(self, ctu_size: int, pic_w: int = None, pic_h: int = None):
        sw = ctu_size if pic_w is None else pic_w
        sh = ctu_size if pic_h is None else pic_h
        nx, ny = (sw + 3) // 4, (sh + 3) // 4
        self.n = max(nx, ny)
        self.nx, self.ny = nx, ny
        self.ctu_size = ctu_size
        self.sw, self.sh = sw, sh
        self.bs = [np.zeros((ny, nx), dtype=np.int32), np.zeros((ny, nx), dtype=np.int32)]
        self.edge_filter = [np.zeros((ny, nx), dtype=bool), np.zeros((ny, nx), dtype=bool)]
        self.max_len_p = np.zeros((3, sw, sh), dtype=np.int8)
        self.max_len_q = np.zeros((3, sw, sh), dtype=np.int8)
        self.transform_edge = np.zeros((3, sw, sh), dtype=bool)

    def reset(self, edge_dir: int):
        self.bs[edge_dir][:] = 0
        self.edge_filter[edge_dir][:] = False
        self.max_len_p[:] = 0
        self.max_len_q[:] = 0
        self.transform_edge[:] = False


class PicDeblockMaps:
    """Picture-wide per-segment filter parameters on the 4x4 luma grid.

    Collected by the (sample-independent) marking pass, consumed by the
    dense vectorized kernels in ops/deblock_kernel.py.
    """

    def __init__(self, h: int, w: int):
        h4, w4 = h // 4, w // 4
        z = lambda dt=np.int32: np.zeros((h4, w4), dtype=dt)
        self.l_active = z(bool)
        self.l_tc = z()
        self.l_beta = z()
        self.l_maxp = z()
        self.l_maxq = z()
        self.l_nop = z(bool)
        self.l_noq = z(bool)
        # chroma (indexed on the luma grid; sliced per chroma format)
        for c in ("cb", "cr"):
            setattr(self, f"{c}_active", z(bool))
            setattr(self, f"{c}_tc", z())
            setattr(self, f"{c}_beta", z())
        self.c_large = z(bool)
        self.c_nop = z(bool)
        self.c_noq = z(bool)
        self.c_horctb = z(bool)


def deblock_picture(dcs, pic) -> None:
    """loopFilterPic equivalent over the decode coding structure."""
    for edge_dir, maps in zip((EDGE_VER, EDGE_HOR), build_pic_maps(dcs, pic)):
        _apply_maps(dcs, pic, maps, edge_dir)


def build_pic_maps(dcs, pic) -> list:
    """Marking pass for BOTH directions (sample-independent): returns
    [maps_ver, maps_hor] for the fused filter chain."""
    ctu = dcs.sps.ctu_size
    state = DeblockState(ctu, pic_w=dcs.pic_w, pic_h=dcs.pic_h)
    is_dual = dcs.cus and any(c.blocks[0] is None for c in dcs.cus)
    h, w = pic.planes[0].shape
    cap = getattr(pic, "filter_capture", None)
    if cap is not None:
        cap["luma_in"] = pic.planes[0].copy()
        cap["dmaps"] = {}
        cap["bit_depth"] = dcs.sps.bit_depth
    # dcs.cus is in decode order (CTU raster, z-order within), so marking
    # the whole picture in one sweep sees exactly the per-CTU ordering
    luma_cus = [c for c in dcs.cus if c.blocks[0] is not None]
    chroma_cus = ([c for c in dcs.cus
                   if c.blocks[0] is None and c.blocks[1] is not None]
                  if is_dual else [])
    out = []
    for edge_dir in (EDGE_VER, EDGE_HOR):
        maps = PicDeblockMaps(h, w)
        state.reset(edge_dir)
        for cu in luma_cus:
            _deblock_cu(dcs, pic, cu, edge_dir, state, 0, 0, maps, phase=1)
        _bs_ctu_vec(dcs, state, edge_dir, 0, 0, chroma_tree=False)
        _collect_ctu_vec(dcs, state, edge_dir, 0, 0, maps, chroma_tree=False)
        if is_dual:
            state.reset(edge_dir)
            for cu in chroma_cus:
                _deblock_cu(dcs, pic, cu, edge_dir, state, 0, 0, maps, phase=1)
            _bs_ctu_vec(dcs, state, edge_dir, 0, 0, chroma_tree=True)
            _collect_ctu_vec(dcs, state, edge_dir, 0, 0, maps,
                             chroma_tree=True)
        if cap is not None:
            cap["dmaps"][edge_dir] = (
                maps.l_active.copy(), maps.l_tc.copy(), maps.l_beta.copy(),
                maps.l_maxp.copy(), maps.l_maxq.copy(), maps.l_nop.copy(),
                maps.l_noq.copy())
        out.append(maps)
    return out


def _apply_maps(dcs, pic, maps: PicDeblockMaps, edge_dir) -> None:
    """Run the dense vectorized edge filters for one direction — one fused
    device dispatch covering luma + both chroma components."""
    import jax.numpy as jnp

    from vtm_jax.ops import deblock_kernel as K

    bd = dcs.sps.bit_depth
    fmt = dcs.chroma_format
    sx, sy = fmt.scale_x, fmt.scale_y
    has_l = bool(maps.l_active.any())
    has_chroma = fmt.num_components > 1
    has_cb = has_chroma and bool(maps.cb_active.any())
    has_cr = has_chroma and bool(maps.cr_active.any())
    if not (has_l or has_cb or has_cr):
        return
    j = lambda a: jnp.asarray(a)
    pl = pic.planes[0]
    pcb = pic.planes[1] if has_chroma else pl
    pcr = pic.planes[2] if has_chroma else pl
    oy, ocb, ocr = K.deblock_dir(
        j(pl.astype(np.int32)), j(pcb.astype(np.int32)), j(pcr.astype(np.int32)),
        j(maps.l_active), j(maps.l_tc), j(maps.l_beta), j(maps.l_maxp),
        j(maps.l_maxq), j(maps.l_nop), j(maps.l_noq),
        j(maps.cb_active), j(maps.cb_tc), j(maps.cb_beta),
        j(maps.cr_active), j(maps.cr_tc), j(maps.cr_beta),
        j(maps.c_large), j(maps.c_nop), j(maps.c_noq), j(maps.c_horctb),
        bit_depth=bd, hor=edge_dir == EDGE_HOR,
        has_l=has_l, has_cb=has_cb, has_cr=has_cr, sx=sx, sy=sy)
    if has_l:
        pl[:] = np.asarray(oy).astype(pl.dtype)
    if has_cb:
        pcb[:] = np.asarray(ocb).astype(pcb.dtype)
    if has_cr:
        pcr[:] = np.asarray(ocr).astype(pcr.dtype)


def _lf_params(dcs, cu):
    """xSetLoopfilterParam: (internal, left, top)."""
    sh = _slice_of(dcs, cu)
    if sh.deblocking_disable:
        return False, False, False
    comp = 0 if cu.blocks[0] is not None else 1
    b = cu.blocks[comp]
    ch = CH_L if comp == 0 else CH_C
    internal = True
    left = top = False
    if b.x > 0:
        cu_left = dcs.get_cu(b.x - 1, b.y, ch)
        left = _lf_available(dcs, cu, cu_left)
    if b.y > 0:
        cu_above = dcs.get_cu(b.x, b.y - 1, ch)
        top = _lf_available(dcs, cu, cu_above)
    return internal, left, top


def _slice_of(dcs, cu):
    return pic_slice(dcs, cu.slice_idx)


def pic_slice(dcs, slice_idx):
    # slice headers recorded on the picture in decode order
    return dcs._slice_headers[slice_idx]


def _lf_available(dcs, cu, cu2) -> bool:
    if cu2 is None:
        return False
    pps = dcs.pps
    if not pps.loop_filter_across_slices and cu.slice_idx != cu2.slice_idx:
        return False
    if not pps.loop_filter_across_tiles and cu.tile_idx != cu2.tile_idx:
        return False
    return True


def _deblock_cu(dcs, pic, cu, edge_dir, state: DeblockState, ctu_x, ctu_y,
                maps=None, phase=0):
    """xDeblockCU.  phase 0 = full per-CU pass (edges + scalar BS + collect/
    filter); phase 1 = edge/max-length marking only (BS then runs vectorized
    per CTU via _bs_ctu_vec); phase 2 = parameter collection only."""
    fmt = dcs.chroma_format
    sps = dcs.sps
    area_x, area_y = cu.lx, cu.ly
    area_w, area_h = cu.lwidth, cu.lheight
    internal, left_e, top_e = _lf_params(dcs, cu)
    edge_idx_list = []
    sx, sy = fmt.scale_x, fmt.scale_y
    has_luma = cu.blocks[0] is not None
    mark = phase != 2
    # --- TU edges ---
    for tu in cu.tus:
        if has_luma:
            tb = tu.blocks[0]
            t_x, t_y, t_w, t_h = tb.x, tb.y, tb.w, tb.h
        else:
            tb = tu.blocks[1]
            t_x, t_y = tb.x << sx, tb.y << sy
            t_w, t_h = tb.w << sx, tb.h << sy
        ver_f = hor_f = internal
        if edge_dir == EDGE_HOR and (t_y % 4) != 0:
            continue
        if edge_dir == EDGE_VER and (t_x % 4) != 0:
            continue
        if mark:
            _set_edge_multiple(state, EDGE_VER, t_x, t_y, t_w, t_h, ver_f, ctu_x, ctu_y, False)
            _set_edge_multiple(state, EDGE_HOR, t_x, t_y, t_w, t_h, hor_f, ctu_x, ctu_y, False)
            _set_max_filter_lengths(dcs, cu, tu, edge_dir, state, ctu_x, ctu_y,
                                    internal, left_e, top_e)
        if has_luma:
            edge_idx_list.append(
                (tu.blocks[0].y - cu.blocks[0].y) // 4 if edge_dir == EDGE_HOR
                else (tu.blocks[0].x - cu.blocks[0].x) // 4
            )
        else:
            edge_idx_list.append(
                ((tu.blocks[1].y - cu.blocks[1].y) << sy) // 4 if edge_dir == EDGE_HOR
                else ((tu.blocks[1].x - cu.blocks[1].x) << sx) // 4
            )
    # --- PU edges (one PU per CU in VVC) ---
    if mark:
        ver_f = left_e
        hor_f = top_e
        _set_edge_multiple(state, EDGE_VER, area_x, area_y, area_w, area_h, ver_f, ctu_x, ctu_y, False)
        _set_edge_multiple(state, EDGE_HOR, area_x, area_y, area_w, area_h, hor_f, ctu_x, ctu_y, False)
    edge_idx_list.append(0)
    # --- subblock-motion internal edges (SbTMVP / affine, LoopFilter.cpp:357) ---
    mv_subblocks = has_luma and (
        cu.affine or (cu.merge_flag and getattr(cu, "_sbtmvp", None) is not None)
    )
    if mv_subblocks:
        sub = 8
        if edge_dir == EDGE_HOR:
            for off in range(sub, area_h, sub):
                if mark:
                    _set_edge_multiple(state, EDGE_HOR, area_x, area_y + off,
                                       area_w, 4, internal, ctu_x, ctu_y, True)
                edge_idx_list.append(off // 4)
        else:
            for off in range(sub, area_w, sub):
                if mark:
                    _set_edge_multiple(state, EDGE_VER, area_x + off, area_y,
                                       4, area_h, internal, ctu_x, ctu_y, True)
                edge_idx_list.append(off // 4)
        if mark:
            _set_max_filter_len_subblocks(state, edge_dir, area_x, area_y,
                                          area_w, area_h, ctu_x, ctu_y)
    # --- boundary strengths (scalar; phase 0 only) ---
    if phase == 0:
        for y in range(0, area_h, 4):
            for x in range(0, area_w, 4):
                lx, ly = area_x + x, area_y + y
                gx, gy = (lx - ctu_x) >> 2, (ly - ctu_y) >> 2
                if not state.edge_filter[edge_dir][gy, gx]:
                    continue
                preset = int(state.bs[edge_dir][gy, gx])
                bs = 0
                if cu.tree_type != TREE_C and cu.blocks[0] is not None:
                    bs |= _bs_single(dcs, cu, edge_dir, lx, ly, CH_L, preset)
                if cu.blocks[1] is not None and fmt.num_components > 1:
                    bs |= _bs_single(dcs, cu, edge_dir, lx, ly, CH_C, preset)
                state.bs[edge_dir][gy, gx] = bs
    if phase == 1:
        return
    # --- filter edges (collect per-segment params into the picture maps;
    #     the sample filtering itself runs densely in ops/deblock_kernel) ---
    maxv = (1 << sps.bit_depth) - 1
    for edge in sorted(set(edge_idx_list)):
        if maps is not None:
            if cu.blocks[0] is not None:
                _collect_edge_params_luma(dcs, cu, edge_dir, edge, state,
                                          ctu_x, ctu_y, maps)
            if fmt.num_components > 1 and cu.blocks[1] is not None:
                if not cu.isp_mode or edge == 0:
                    _collect_edge_params_chroma(dcs, cu, edge_dir, edge, state,
                                                ctu_x, ctu_y, maps)
        else:
            if cu.blocks[0] is not None:
                _edge_filter_luma(dcs, pic, cu, edge_dir, edge, state, ctu_x, ctu_y, maxv)
            if fmt.num_components > 1 and cu.blocks[1] is not None:
                if not cu.isp_mode or edge == 0:
                    _edge_filter_chroma(dcs, pic, cu, edge_dir, edge, state, ctu_x, ctu_y, maxv)


def _set_edge_multiple(state, edge_dir, x, y, w, h, value, ctu_x, ctu_y, edge_flag_only):
    gx, gy = (x - ctu_x) >> 2, (y - ctu_y) >> 2
    n = (h // 4) if edge_dir == EDGE_VER else (w // 4)
    for i in range(n):
        yy, xx = (gy + i, gx) if edge_dir == EDGE_VER else (gy, gx + i)
        if yy >= state.ny or xx >= state.nx or yy < 0 or xx < 0:
            continue
        state.edge_filter[edge_dir][yy, xx] = value
        if state.bs[edge_dir][yy, xx] and value:
            state.bs[edge_dir][yy, xx] = 3
        elif not edge_flag_only:
            state.bs[edge_dir][yy, xx] = int(value)


def _set_max_filter_lengths(dcs, cu, tu, edge_dir, state, ctu_x, ctu_y,
                            internal, left_e, top_e):
    """xSetMaxFilterLengthPQFromTransformSizes."""
    fmt = dcs.chroma_format
    ncomp = fmt.num_components
    for comp in range(ncomp):
        tb = tu.blocks[comp]
        if tb is None:
            continue
        cu_b = cu.blocks[comp]
        ch = CH_L if comp == 0 else CH_C
        shift_h = 0 if comp == 0 else fmt.scale_x
        shift_v = 0 if comp == 0 else fmt.scale_y
        ctu_x_off = tb.x - (ctu_x >> shift_h)
        ctu_y_off = tb.y - (ctu_y >> shift_v)
        if edge_dir == EDGE_HOR:
            min_cu_w = 4 >> shift_h
            edge_enabled = top_e if (cu_b is not None and tb.y == cu_b.y) else internal
            if not edge_enabled:
                continue
            for x in range(0, tb.w, min_cu_w):
                tu_p = dcs.get_tu(tb.x + x, tb.y - 1, ch)
                if tu_p is None:
                    continue
                size_q = tb.h
                size_p = tu_p.blocks[comp].h
                xi, yi = ctu_x_off + x, ctu_y_off
                if xi < 0 or yi < 0:
                    continue
                state.transform_edge[comp, xi, yi] = True
                if comp == 0:
                    if size_p <= 4 or size_q <= 4:
                        state.max_len_q[comp, xi, yi] = 1
                        state.max_len_p[comp, xi, yi] = 1
                    else:
                        state.max_len_q[comp, xi, yi] = 7 if size_q >= 32 else 3
                        state.max_len_p[comp, xi, yi] = 7 if size_p >= 32 else 3
                else:
                    v = 3 if (size_q >= 8 and size_p >= 8) else 1
                    state.max_len_q[comp, xi, yi] = v
                    state.max_len_p[comp, xi, yi] = v
        else:
            min_cu_h = 4 >> shift_v
            edge_enabled = left_e if (cu_b is not None and tb.x == cu_b.x) else internal
            if not edge_enabled:
                continue
            for y in range(0, tb.h, min_cu_h):
                tu_p = dcs.get_tu(tb.x - 1, tb.y + y, ch)
                if tu_p is None:
                    continue
                size_q = tb.w
                size_p = tu_p.blocks[comp].w
                xi, yi = ctu_x_off, ctu_y_off + y
                if xi < 0 or yi < 0:
                    continue
                state.transform_edge[comp, xi, yi] = True
                if comp == 0:
                    if size_p <= 4 or size_q <= 4:
                        state.max_len_q[comp, xi, yi] = 1
                        state.max_len_p[comp, xi, yi] = 1
                    else:
                        state.max_len_q[comp, xi, yi] = 7 if size_q >= 32 else 3
                        state.max_len_p[comp, xi, yi] = 7 if size_p >= 32 else 3
                else:
                    v = 3 if (size_q >= 8 and size_p >= 8) else 1
                    state.max_len_q[comp, xi, yi] = v
                    state.max_len_p[comp, xi, yi] = v


def _set_max_filter_len_subblocks(state, edge_dir, area_x, area_y, area_w,
                                  area_h, ctu_x, ctu_y):
    """xSetMaxFilterLengthPQForCodingSubBlocks (LoopFilter.cpp:587)."""
    sub = 8
    xo = area_x - ctu_x
    yo = area_y - ctu_y
    te = state.transform_edge
    mq = state.max_len_q
    mp = state.max_len_p
    if edge_dir == EDGE_HOR:
        for y in range(0, area_h, sub):
            for x in range(0, area_w, 4):
                xi, yi = xo + x, yo + y
                if xi < 0 or yi < 0:
                    continue
                if te[0, xi, yi]:
                    mq[0, xi, yi] = min(mq[0, xi, yi], 5)
                    if y > 0:
                        mp[0, xi, yi] = min(mp[0, xi, yi], 5)
                elif y > 0 and (
                    (yi >= 4 and te[0, xi, yi - 4]) or (y + 4) >= area_h
                    or (yi + 4 < state.sh and te[0, xi, yi + 4])
                ):
                    mq[0, xi, yi] = 1
                    mp[0, xi, yi] = 1
                elif y > 0 and (
                    y == 8 or (yi >= 8 and te[0, xi, yi - 8]) or (y + 8) >= area_h
                    or (yi + 8 < state.sh and te[0, xi, yi + 8])
                ):
                    mq[0, xi, yi] = 2
                    mp[0, xi, yi] = 2
                else:
                    mq[0, xi, yi] = 3
                    mp[0, xi, yi] = 3
    else:
        for x in range(0, area_w, sub):
            for y in range(0, area_h, 4):
                xi, yi = xo + x, yo + y
                if xi < 0 or yi < 0:
                    continue
                if te[0, xi, yi]:
                    mq[0, xi, yi] = min(mq[0, xi, yi], 5)
                    if x > 0:
                        mp[0, xi, yi] = min(mp[0, xi, yi], 5)
                elif x > 0 and (
                    (xi >= 4 and te[0, xi - 4, yi]) or (x + 4) >= area_w
                    or (xi + 4 < state.sw and te[0, xi + 4, yi])
                ):
                    mq[0, xi, yi] = 1
                    mp[0, xi, yi] = 1
                elif x > 0 and (
                    x == 8 or (xi >= 8 and te[0, xi - 8, yi]) or (x + 8) >= area_w
                    or (xi + 8 < state.sw and te[0, xi + 8, yi])
                ):
                    mq[0, xi, yi] = 2
                    mp[0, xi, yi] = 2
                else:
                    mq[0, xi, yi] = 3
                    mp[0, xi, yi] = 3


def _build_bs_tables(dcs):
    """Per-picture CU/TU attribute vectors + slice reference-identity tables
    for the vectorized boundary-strength pass (cached on the dcs).  Index
    association is exactly the scalar one: dcs.map_l/map_c/map_tu_l/map_tu_c."""
    t = getattr(dcs, "_bs_tables", None)
    if t is not None and t["n_cu"] == len(dcs.cus) and t["n_tu"] == len(dcs.tus):
        return t
    cus, tus = dcs.cus, dcs.tus
    n_cu, n_tu = len(cus), len(tus)
    t = {
        "n_cu": n_cu, "n_tu": n_tu,
        "mode": np.fromiter((c.pred_mode for c in cus), np.int8, n_cu),
        "bdpcm": np.fromiter((c.bdpcm_mode != 0 for c in cus), bool, n_cu),
        "bdpcm_c": np.fromiter((c.bdpcm_mode_chroma != 0 for c in cus), bool, n_cu),
        "ciip": np.fromiter((bool(c.ciip_flag) for c in cus), bool, n_cu),
        "slice": np.fromiter((c.slice_idx for c in cus), np.int32, n_cu),
        "has_c": np.fromiter((c.blocks[1] is not None for c in cus), bool, n_cu),
        "cbf0": np.fromiter((bool(tu.cbf[0]) for tu in tus), bool, n_tu),
        "cbf1": np.fromiter((bool(tu.cbf[1]) or bool(tu.joint_cbcr) for tu in tus), bool, n_tu),
        "cbf2": np.fromiter((bool(tu.cbf[2]) or bool(tu.joint_cbcr) for tu in tus), bool, n_tu),
        "qp": np.fromiter((c.qp for c in cus), np.int32, n_cu),
        "affine": np.fromiter((bool(getattr(c, "affine", False)) for c in cus), bool, n_cu),
        "tile": np.fromiter((getattr(c, "tile_idx", 0) for c in cus), np.int32, n_cu),
        "isp": np.fromiter((bool(c.isp_mode) for c in cus), bool, n_cu),
        "sep": np.fromiter((bool(getattr(c, "is_sep_tree", False)) for c in cus), bool, n_cu),
        "lx": np.fromiter(
            (c.blocks[0].x if c.blocks[0] is not None
             else c.blocks[1].x << dcs.chroma_format.scale_x for c in cus),
            np.int32, n_cu),
        "ly": np.fromiter(
            (c.blocks[0].y if c.blocks[0] is not None
             else c.blocks[1].y << dcs.chroma_format.scale_y for c in cus),
            np.int32, n_cu),
    }
    # per-TU chroma deblock base QPs (QpParam(tu, comp).Qp(0) - qpBdOffset),
    # memoized over the few distinct (slice, qp, adj, jcbcr) combinations
    if dcs.chroma_format.num_components > 1:
        memo: dict = {}
        cqp = np.zeros((max(n_tu, 1), 2), dtype=np.int32)
        for ti, tu in enumerate(tus):
            cu = tu.cu
            key = (cu.slice_idx, cu.qp, cu.chroma_qp_adj, tu.joint_cbcr)
            v = memo.get(key)
            if v is None:
                v = (_chroma_base_qp(dcs, tu, 1), _chroma_base_qp(dcs, tu, 2))
                memo[key] = v
            cqp[ti, 0] = v[0]
            cqp[ti, 1] = v[1]
        t["cqp"] = cqp
    shs = dcs._slice_headers
    max_ref = 1
    for sh in shs:
        rp = getattr(sh, "ref_pics", None) or [[], []]
        max_ref = max(max_ref, len(rp[0]), len(rp[1]))
    ref_id = np.full((max(len(shs), 1), 2, max_ref), -1, dtype=np.int32)
    pic_ids: dict[int, int] = {}
    for si, sh in enumerate(shs):
        rp = getattr(sh, "ref_pics", None) or [[], []]
        for lst in range(2):
            for ri, p in enumerate(rp[lst]):
                ref_id[si, lst, ri] = pic_ids.setdefault(id(p), len(pic_ids) + 1)
    t["ref_id"] = ref_id
    t["is_b"] = np.fromiter((bool(getattr(sh, "is_b", False)) for sh in shs),
                            bool, len(shs)) if shs else np.zeros(1, bool)
    nsl = max(len(shs), 1)

    def sl_vec(attr):
        out = np.zeros(nsl, dtype=np.int32)
        for si, sh in enumerate(shs):
            out[si] = getattr(sh, attr)
        return out

    for attr in ("beta_offset_div2", "tc_offset_div2", "cb_tc_offset_div2",
                 "cr_tc_offset_div2", "cb_beta_offset_div2",
                 "cr_beta_offset_div2"):
        t[attr] = sl_vec(attr)
    cu_idx_of = {id(c): i for i, c in enumerate(cus)}
    t["tu_cui"] = np.fromiter((cu_idx_of[id(tu.cu)] for tu in tus),
                              np.int32, n_tu)
    dcs._bs_tables = t
    return t


def _bs_ctu_vec(dcs, state, edge_dir, ctu_x, ctu_y, chroma_tree: bool) -> None:
    """Vectorized xGetBoundaryStrengthSingle over every flagged 4x4 position
    of one CTU — bit-identical to the scalar _bs_single / per-CU BS loop."""
    t = _build_bs_tables(dcs)
    fmt = dcs.chroma_format
    ef = state.edge_filter[edge_dir]
    ys, xs = np.nonzero(ef)
    if ys.size == 0:
        return
    qly = ctu_y + (ys << 2)
    qlx = ctu_x + (xs << 2)
    inpic = (qly < dcs.pic_h) & (qlx < dcs.pic_w)
    if not inpic.all():
        ys, xs, qly, qlx = ys[inpic], xs[inpic], qly[inpic], qlx[inpic]
        if ys.size == 0:
            return
    ver = edge_dir == EDGE_VER
    ply = qly - (0 if ver else 1)
    plx = qlx - (1 if ver else 0)
    p_ok = (ply >= 0) & (plx >= 0)
    q4y, q4x = qly >> 2, qlx >> 2
    p4y, p4x = np.maximum(ply, 0) >> 2, np.maximum(plx, 0) >> 2
    preset = state.bs[edge_dir][ys, xs].astype(np.int32)
    pre_nz = preset != 0
    mode, bdpcm, bdpcm_c = t["mode"], t["bdpcm"], t["bdpcm_c"]
    ciip, cu_slice = t["ciip"], t["slice"]
    thr = (1 << 4) >> 1

    def safe(vec, idx):
        return np.where(idx >= 0, vec[np.maximum(idx, 0)], 0)

    bs = np.zeros(ys.size, dtype=np.int64)

    if not chroma_tree:
        qcu = dcs.map_l[q4y, q4x]
        pcu = np.where(p_ok, dcs.map_l[p4y, p4x], -1)
        valid = (qcu >= 0) & (pcu >= 0)
        qc = np.maximum(qcu, 0)
        pc = np.maximum(pcu, 0)
        m_q, m_p = mode[qc].astype(np.int32), mode[pc].astype(np.int32)
        intra_any = (m_q == MODE_INTRA_V) | (m_p == MODE_INTRA_V)
        both_bdpcm = (m_q == MODE_INTRA_V) & bdpcm[qc] & (m_p == MODE_INTRA_V) & bdpcm[pc]
        bs_intra = np.where(both_bdpcm, 0, 2)
        qtu = dcs.map_tu_l[q4y, q4x]
        ptu = np.where(p_ok, dcs.map_tu_l[p4y, p4x], -1)
        ciip_any = ciip[qc] | ciip[pc]
        tmp = pre_nz & (safe(t["cbf0"], qtu) | safe(t["cbf0"], ptu)).astype(bool)
        # --- MV-based BS (motion field exists only once an inter slice
        # initialized it; on intra-only pictures every pair hits the
        # intra_any branch, so bs_mv is never selected) ---
        if not hasattr(dcs, "mf_refidx"):
            bs_mv = np.zeros(ys.size, dtype=np.int64)
        else:
            is_b_any = t["is_b"][cu_slice[qc]] | t["is_b"][cu_slice[pc]]
            ibc_q, ibc_p = m_q == MODE_IBC_V, m_p == MODE_IBC_V
            ridq = dcs.mf_refidx[q4y, q4x].astype(np.int32)     # (N, 2)
            ridp = dcs.mf_refidx[p4y, p4x].astype(np.int32)
            mvq = dcs.mf_mv[q4y, q4x].astype(np.int64)          # (N, 2, 2)
            mvp = dcs.mf_mv[p4y, p4x].astype(np.int64)
            nref = t["ref_id"].shape[2]
            slq, slp = cu_slice[qc], cu_slice[pc]

            def refid(sl, rid, lst, is_ibc):
                base = t["ref_id"][sl, lst, np.clip(rid[:, lst], 0, nref - 1)]
                base = np.where(rid[:, lst] >= 0, base, -1)
                return np.where(is_ibc, -2 if lst == 0 else -1, base)

            rq0 = refid(slq, ridq, 0, ibc_q)
            rq1 = refid(slq, ridq, 1, ibc_q)
            rp0 = refid(slp, ridp, 0, ibc_p)
            rp1 = refid(slp, ridp, 1, ibc_p)
            mvq_g = np.where(ridq[:, :, None] >= 0, mvq, 0)
            mvp_g = np.where(ridp[:, :, None] >= 0, mvp, 0)

            def diff(a, b):
                return (np.abs(a[:, 0] - b[:, 0]) >= thr) | (np.abs(a[:, 1] - b[:, 1]) >= thr)

            d00 = diff(mvq_g[:, 0], mvp_g[:, 0])
            d11 = diff(mvq_g[:, 1], mvp_g[:, 1])
            d10 = diff(mvq_g[:, 1], mvp_g[:, 0])
            d01 = diff(mvq_g[:, 0], mvp_g[:, 1])
            same_refs = ((rp0 == rq0) & (rp1 == rq1)) | ((rp0 == rq1) & (rp1 == rq0))
            bs_b = np.where(
                ~same_refs, 1,
                np.where(rp0 != rp1,
                         np.where(rp0 == rq0, d00 | d11, d10 | d01),
                         (d00 | d11) & (d10 | d01)).astype(np.int64))
            d_p = diff(mvq[:, 0], mvp[:, 0])
            bs_p_path = np.where(rp0 != rq0, 1, d_p.astype(np.int64))
            bs_mv = np.where(is_b_any, bs_b, bs_p_path)
        luma = np.select(
            [intra_any,
             ciip_any & pre_nz,
             tmp,
             ciip_any,
             pre_nz & (preset != 3),
             m_q != m_p],
            [bs_intra, 2, 1, 1, 0, 1],
            default=bs_mv)
        bs |= np.where(valid, luma, 0)

    if fmt.num_components > 1 and dcs.map_c is not None:
        sx, sy = fmt.scale_x, fmt.scale_y
        qcy, qcx = (qly >> sy) >> 1, (qlx >> sx) >> 1
        pcy = np.maximum(ply >> sy, 0) >> 1
        pcx = np.maximum(plx >> sx, 0) >> 1
        qcu_c = dcs.map_c[qcy, qcx]
        pcu_c = np.where(p_ok, dcs.map_c[pcy, pcx], -1)
        if chroma_tree:
            applies = qcu_c >= 0
        else:
            qcu_l = dcs.map_l[q4y, q4x]
            applies = (qcu_l >= 0) & t["has_c"][np.maximum(qcu_l, 0)]
        valid_c = applies & (pcu_c >= 0)
        qcc = np.maximum(qcu_c, 0)
        pcc = np.maximum(pcu_c, 0)
        m_qc, m_pc = mode[qcc].astype(np.int32), mode[pcc].astype(np.int32)
        intra_any_c = (m_qc == MODE_INTRA_V) | (m_pc == MODE_INTRA_V)
        both_bdpcm_c = ((m_qc == MODE_INTRA_V) & bdpcm_c[qcc]
                        & (m_pc == MODE_INTRA_V) & bdpcm_c[pcc])
        c_val = np.where(both_bdpcm_c, 0, 2)
        bs_intra_c = (c_val << 2) + (c_val << 4)
        qtu_c = dcs.map_tu_c[qcy, qcx]
        ptu_c = np.where(p_ok, dcs.map_tu_c[pcy, pcx], -1)
        ciip_any_c = ciip[qcc] | ciip[pcc]
        tmp_c = (np.where(pre_nz & (safe(t["cbf1"], qtu_c) | safe(t["cbf1"], ptu_c)).astype(bool), 1 << 2, 0)
                 + np.where(pre_nz & (safe(t["cbf2"], qtu_c) | safe(t["cbf2"], ptu_c)).astype(bool), 1 << 4, 0))
        chroma = np.select(
            [intra_any_c, ciip_any_c & pre_nz, ciip_any_c],
            [bs_intra_c, (2 << 2) + (2 << 4), 1],
            default=tmp_c)
        bs |= np.where(valid_c, chroma, 0)

    state.bs[edge_dir][ys, xs] = bs


def _collect_ctu_vec(dcs, state, edge_dir, ctu_x, ctu_y, maps,
                     chroma_tree: bool) -> None:
    """Vectorized per-CTU edge-parameter collection — bit-identical twin of
    _collect_edge_params_luma/_collect_edge_params_chroma over every flagged
    position of the CTU."""
    t = _build_bs_tables(dcs)
    fmt = dcs.chroma_format
    sps = dcs.sps
    pps = dcs.pps
    ef = state.edge_filter[edge_dir]
    ys, xs = np.nonzero(ef)
    if ys.size == 0:
        return
    qly = ctu_y + (ys << 2)
    qlx = ctu_x + (xs << 2)
    inpic = (qly < dcs.pic_h) & (qlx < dcs.pic_w)
    if not inpic.all():
        ys, xs, qly, qlx = ys[inpic], xs[inpic], qly[inpic], qlx[inpic]
        if ys.size == 0:
            return
    ver = edge_dir == EDGE_VER
    q4y, q4x = qly >> 2, qlx >> 2
    p4y = q4y - (0 if ver else 1)
    p4x = q4x - (1 if ver else 0)
    p_ok = (p4y >= 0) & (p4x >= 0)
    pc4y, pc4x = np.maximum(p4y, 0), np.maximum(p4x, 0)
    bit_depth = sps.bit_depth
    bd_scale = 1 << (bit_depth - 8)
    bs_now = state.bs[edge_dir][ys, xs].astype(np.int64)
    pgy, pgx = q4y, q4x  # global picture 4x4-map coords

    def tc_from_idx(idx_tc):
        if bit_depth < 10:
            return (_TC_TABLE_NP[idx_tc] + (1 << (9 - bit_depth))) >> (10 - bit_depth)
        return _TC_TABLE_NP[idx_tc] << (bit_depth - 10)

    if not chroma_tree:
        qcu = dcs.map_l[q4y, q4x]
        pcu = np.where(p_ok, dcs.map_l[pc4y, pc4x], -1)
        qc = np.maximum(qcu, 0)
        pc = np.maximum(pcu, 0)
        bsl = bs_now & 3
        act = (bsl != 0) & (qcu >= 0)
        avail = pcu >= 0
        if not pps.loop_filter_across_slices:
            avail &= t["slice"][qc] == t["slice"][pc]
        if not pps.loop_filter_across_tiles:
            avail &= t["tile"][qc] == t["tile"][pc]
        wipe = act & ~avail
        if wipe.any():
            state.bs[edge_dir][ys[wipe], xs[wipe]] = 0
            bs_now = np.where(wipe, 0, bs_now)
        sel = act & avail
        if sel.any():
            qp = (t["qp"][pc] + t["qp"][qc] + 1) >> 1
            mxp = state.max_len_p[0, xs << 2, ys << 2].astype(np.int64)
            mxq = state.max_len_q[0, xs << 2, ys << 2]
            mxp = np.where((mxp > 5) & t["affine"][pc], 5, mxp)
            if edge_dir == EDGE_HOR:
                mxp = np.where(qly % sps.ctu_size == 0, np.minimum(mxp, 3), mxp)
            sl = t["slice"][qc]
            idx_tc = np.clip(qp + DEFAULT_INTRA_TC_OFFSET * (bsl - 1)
                             + (t["tc_offset_div2"][sl] << 1),
                             0, 63 + DEFAULT_INTRA_TC_OFFSET)
            idx_b = np.clip(qp + (t["beta_offset_div2"][sl] << 1), 0, 63)
            tc = tc_from_idx(idx_tc)
            beta = _BETA_TABLE_NP[idx_b] * bd_scale
            w = sel
            maps.l_active[pgy[w], pgx[w]] = True
            maps.l_tc[pgy[w], pgx[w]] = tc[w]
            maps.l_beta[pgy[w], pgx[w]] = beta[w]
            maps.l_maxp[pgy[w], pgx[w]] = mxp[w]
            maps.l_maxq[pgy[w], pgx[w]] = mxq[w]
            if sps.palette:
                maps.l_nop[pgy[w], pgx[w]] = (t["mode"][pc] == 3)[w]
                maps.l_noq[pgy[w], pgx[w]] = (t["mode"][qc] == 3)[w]
            else:
                maps.l_nop[pgy[w], pgx[w]] = False
                maps.l_noq[pgy[w], pgx[w]] = False

    if fmt.num_components <= 1 or dcs.map_c is None:
        return
    sx, sy = fmt.scale_x, fmt.scale_y
    pels_h, pels_v = 4 >> sx, 4 >> sy
    if pels_h < 8 and pels_v < 8:
        gate = (xs % (8 // pels_h) == 0) if ver else (ys % (8 // pels_v) == 0)
    else:
        gate = np.ones(xs.size, bool)
    bscb = (bs_now >> 2) & 3
    bscr = (bs_now >> 4) & 3
    act_c = gate & ((bscb != 0) | (bscr != 0))
    qcy = (qly >> sy) >> 1
    qcx = (qlx >> sx) >> 1
    if chroma_tree:
        qcu_c = dcs.map_c[qcy, qcx]
        own = qcu_c >= 0
        cu_own = np.maximum(qcu_c, 0)
    else:
        qcu_l = dcs.map_l[q4y, q4x]
        own = (qcu_l >= 0) & t["has_c"][np.maximum(qcu_l, 0)]
        cu_own = np.maximum(qcu_l, 0)
    isp = t["isp"][cu_own]
    at_cu_edge = (qlx == t["lx"][cu_own]) if ver else (qly == t["ly"][cu_own])
    act_c &= own & (~isp | at_cu_edge)
    if not act_c.any():
        return
    # p-side CU: luma-map CU unless separate-tree, else chroma-map CU
    cu_p1 = np.where(p_ok, dcs.map_l[pc4y, pc4x], -1)
    pcy = ((qly - (0 if ver else 4)) >> sy) >> 1
    pcx = ((qlx - (4 if ver else 0)) >> sx) >> 1
    cu_p2 = np.where(p_ok, dcs.map_c[np.maximum(pcy, 0), np.maximum(pcx, 0)], -1)
    use1 = (cu_p1 >= 0) & ~t["sep"][np.maximum(cu_p1, 0)]
    cu_p = np.where(use1, cu_p1, cu_p2)
    act_c &= cu_p >= 0
    if not act_c.any():
        return
    mxp_c = state.max_len_p[1, (qlx - ctu_x) >> sx, (qly - ctu_y) >> sy]
    mxq_c = state.max_len_q[1, (qlx - ctu_x) >> sx, (qly - ctu_y) >> sy]
    large = (mxp_c >= 3) & (mxq_c >= 3)
    horctb = np.zeros(xs.size, bool) if ver else (qly % sps.ctu_size == 0)
    tu_q = np.maximum(dcs.map_tu_c[qcy, qcx], 0)
    tu_p = np.maximum(
        np.where(p_ok, dcs.map_tu_c[np.maximum(pcy, 0), np.maximum(pcx, 0)], 0), 0)
    sl_c = t["slice"][cu_own]
    any_active = np.zeros(xs.size, bool)
    for ci in range(2):
        bs_i = bscb if ci == 0 else bscr
        a = act_c & ((bs_i == 2) | (large & (bs_i == 1)))
        if not a.any():
            continue
        qp_i = (t["cqp"][tu_p, ci] + t["cqp"][tu_q, ci] + 1) >> 1
        tc_off = (t["cb_tc_offset_div2"] if ci == 0 else t["cr_tc_offset_div2"])[sl_c]
        b_off = (t["cb_beta_offset_div2"] if ci == 0 else t["cr_beta_offset_div2"])[sl_c]
        idx_tc = np.clip(qp_i + DEFAULT_INTRA_TC_OFFSET * (bs_i - 1) + (tc_off << 1),
                         0, 63 + DEFAULT_INTRA_TC_OFFSET)
        idx_b = np.clip(qp_i + (b_off << 1), 0, 63)
        tc = tc_from_idx(idx_tc)
        beta = _BETA_TABLE_NP[idx_b] * bd_scale
        pre = "cb" if ci == 0 else "cr"
        getattr(maps, f"{pre}_active")[pgy[a], pgx[a]] = True
        getattr(maps, f"{pre}_tc")[pgy[a], pgx[a]] = tc[a]
        getattr(maps, f"{pre}_beta")[pgy[a], pgx[a]] = beta[a]
        any_active |= a
    w = any_active
    if w.any():
        maps.c_large[pgy[w], pgx[w]] = large[w]
        if sps.palette:
            maps.c_nop[pgy[w], pgx[w]] = (t["mode"][t["tu_cui"][tu_p]] == 3)[w]
            maps.c_noq[pgy[w], pgx[w]] = (t["mode"][t["tu_cui"][tu_q]] == 3)[w]
        else:
            maps.c_nop[pgy[w], pgx[w]] = False
            maps.c_noq[pgy[w], pgx[w]] = False
        maps.c_horctb[pgy[w], pgx[w]] = horctb[w]


MODE_INTRA_V = MODE_INTRA
MODE_IBC_V = 2  # D.MODE_IBC


def _bs_single(dcs, cu, edge_dir, lx, ly, ch, preset: int = 0) -> int:
    """xGetBoundaryStrengthSingle (LoopFilter.cpp:410); `preset` is the
    edge-classification value previously stored in m_aapucBS."""
    fmt = dcs.chroma_format
    if cu.blocks[0] is not None:
        shift_h = shift_v = 0
    else:
        shift_h, shift_v = fmt.scale_x, fmt.scale_y
    qx, qy = lx >> shift_h, ly >> shift_v
    px, py = (qx - 1, qy) if edge_dir == EDGE_VER else (qx, qy - 1)
    cu_ch = CH_L if cu.blocks[0] is not None else CH_C
    if ch == CH_C and cu_ch == CH_L:
        cu_p = dcs.get_cu(px >> fmt.scale_x, py >> fmt.scale_y, CH_C)
    else:
        cu_p = dcs.get_cu(px, py, cu_ch)
    if cu_p is None:
        return 0
    cu_q = cu
    if cu_p.pred_mode == MODE_INTRA or cu_q.pred_mode == MODE_INTRA:
        if ch == CH_L:
            bs_y = 0 if (
                cu_p.pred_mode == MODE_INTRA and cu_p.bdpcm_mode
                and cu_q.pred_mode == MODE_INTRA and cu_q.bdpcm_mode
            ) else 2
            return bs_y  # BsSet(bsY, Y) = bsY << 0
        bs_c = 0 if (
            cu_p.pred_mode == MODE_INTRA and cu_p.bdpcm_mode_chroma
            and cu_q.pred_mode == MODE_INTRA and cu_q.bdpcm_mode_chroma
        ) else 2
        return (bs_c << 2) + (bs_c << 4)
    # ---- inter BS (LoopFilter.cpp xGetBoundaryStrengthSingle inter part) ----
    tu_q = dcs.get_tu(qx, qy, cu_ch)
    if ch == CH_C and cu_p.blocks[0] is None and cu_ch == CH_L:
        tu_p = dcs.get_tu(px >> fmt.scale_x, py >> fmt.scale_y, CH_C)
    else:
        tu_p = dcs.get_tu(px, py, cu_ch)
    if preset and (cu_p.ciip_flag or cu_q.ciip_flag):
        if ch == CH_L:
            return 2
        return (2 << 2) + (2 << 4)
    tmp_bs = 0
    if ch == CH_L:
        if preset and (tu_q.cbf[0] or tu_p.cbf[0]):
            tmp_bs += 1
    else:
        if fmt.num_components > 1:
            if preset and (tu_q.cbf[1] or tu_p.cbf[1] or tu_q.joint_cbcr or tu_p.joint_cbcr):
                tmp_bs += 1 << 2
            if preset and (tu_q.cbf[2] or tu_p.cbf[2] or tu_q.joint_cbcr or tu_p.joint_cbcr):
                tmp_bs += 1 << 4
    if (tmp_bs & 3) == 1:
        return tmp_bs
    if cu_p.ciip_flag or cu_q.ciip_flag:
        return 1
    if cu.blocks[0] is None:
        return tmp_bs
    if preset != 0 and preset != 3:
        return tmp_bs
    if ch == CH_C:
        return tmp_bs
    if cu_p.pred_mode != cu_q.pred_mode:
        return 1
    # MV-based BS
    from vtm_jax.decoder import motion as M

    lqx, lqy = lx, ly
    lpx, lpy = (lx - 1, ly) if edge_dir == EDGE_VER else (lx, ly - 1)
    mi_q = M.get_motion_info(dcs, lqx, lqy)
    mi_p = M.get_motion_info(dcs, lpx, lpy)
    sh_q = _slice_of(dcs, cu_q)
    sh_p = _slice_of(dcs, cu_p)
    thr = (1 << 4) >> 1  # half-pel at internal precision

    _CUR_PIC = object()  # sentinel: the current picture (IBC "reference")

    def ref(sh, mi, lst, is_ibc=False):
        # LoopFilter.cpp:823-826,876: IBC refs are (current picture, NULL)
        if is_ibc:
            return _CUR_PIC if lst == 0 else None
        ri = mi.ref_idx[lst]
        return sh.ref_pics[lst][ri] if ri >= 0 else None

    ibc_p = cu_p.pred_mode == 2  # D.MODE_IBC
    ibc_q = cu_q.pred_mode == 2

    if sh_q.is_b or sh_p.is_b:
        rp0, rp1 = ref(sh_p, mi_p, 0, ibc_p), ref(sh_p, mi_p, 1, ibc_p)
        rq0, rq1 = ref(sh_q, mi_q, 0, ibc_q), ref(sh_q, mi_q, 1, ibc_q)
        mv_p0 = mi_p.mv[0] if mi_p.ref_idx[0] >= 0 else (0, 0)
        mv_p1 = mi_p.mv[1] if mi_p.ref_idx[1] >= 0 else (0, 0)
        mv_q0 = mi_q.mv[0] if mi_q.ref_idx[0] >= 0 else (0, 0)
        mv_q1 = mi_q.mv[1] if mi_q.ref_idx[1] >= 0 else (0, 0)

        def diff(a, b):
            return abs(a[0] - b[0]) >= thr or abs(a[1] - b[1]) >= thr

        if (rp0 is rq0 and rp1 is rq1) or (rp0 is rq1 and rp1 is rq0):
            if rp0 is not rp1:
                if rp0 is rq0:
                    bs = 1 if (diff(mv_q0, mv_p0) or diff(mv_q1, mv_p1)) else 0
                else:
                    bs = 1 if (diff(mv_q1, mv_p0) or diff(mv_q0, mv_p1)) else 0
            else:
                bs = 1 if (
                    (diff(mv_q0, mv_p0) or diff(mv_q1, mv_p1))
                    and (diff(mv_q1, mv_p0) or diff(mv_q0, mv_p1))
                ) else 0
        else:
            bs = 1
        return bs + tmp_bs
    rp0 = ref(sh_p, mi_p, 0, ibc_p)
    rq0 = ref(sh_q, mi_q, 0, ibc_q)
    if rp0 is not rq0:
        return tmp_bs + 1
    mv_p0, mv_q0 = mi_p.mv[0], mi_q.mv[0]
    if abs(mv_q0[0] - mv_p0[0]) >= thr or abs(mv_q0[1] - mv_p0[1]) >= thr:
        return tmp_bs + 1
    return tmp_bs


def _collect_edge_params_luma(dcs, cu, edge_dir, edge, state, ctu_x, ctu_y,
                              maps: "PicDeblockMaps"):
    """Per-segment parameter emission — mirrors _edge_filter_luma up to (but
    excluding) the sample-dependent decisions, which run in the kernel."""
    b = cu.blocks[0]
    sps = dcs.sps
    sh_q = _slice_of(dcs, cu)
    beta_off2 = sh_q.beta_offset_div2
    tc_off2 = sh_q.tc_offset_div2
    bit_depth = sps.bit_depth
    bd_scale = 1 << (bit_depth - 8)
    num_parts = b.h // 4 if edge_dir == EDGE_VER else b.w // 4
    for idx in range(num_parts):
        if edge_dir == EDGE_VER:
            px = b.x + edge * 4
            py = b.y + idx * 4
        else:
            px = b.x + idx * 4
            py = b.y + edge * 4
        gx, gy = (px - ctu_x) >> 2, (py - ctu_y) >> 2
        bs = state.bs[edge_dir][gy, gx] & 3
        if not bs:
            continue
        cu_p = dcs.get_cu(px - (1 if edge_dir == EDGE_VER else 0),
                          py - (1 if edge_dir == EDGE_HOR else 0), CH_L)
        if cu_p is None or not _lf_available(dcs, cu, cu_p):
            state.bs[edge_dir][gy, gx] = 0
            continue
        qp = (cu_p.qp + cu.qp + 1) >> 1
        max_p = int(state.max_len_p[0, px - ctu_x, py - ctu_y])
        max_q = int(state.max_len_q[0, px - ctu_x, py - ctu_y])
        # side_p_large clamps folded into max_p (equivalent: the short path
        # only tests max_p>1 / max_p>2, and n_p = max_p when side_p_large)
        if max_p > 5 and cu_p.affine:
            max_p = 5
        if edge_dir == EDGE_HOR and py % sps.ctu_size == 0:
            max_p = min(max_p, 3)
        idx_tc = _clip3(0, 63 + DEFAULT_INTRA_TC_OFFSET,
                        qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1) + (tc_off2 << 1))
        idx_b = _clip3(0, 63, qp + (beta_off2 << 1))
        tc = (
            (TC_TABLE[idx_tc] + (1 << (9 - bit_depth))) >> (10 - bit_depth)
            if bit_depth < 10 else TC_TABLE[idx_tc] << (bit_depth - 10)
        )
        beta = BETA_TABLE[idx_b] * bd_scale
        no_p = no_q = False
        if sps.palette:
            no_p = cu_p.pred_mode == 3
            no_q = cu.pred_mode == 3
        pgy, pgx = py >> 2, px >> 2
        maps.l_active[pgy, pgx] = True
        maps.l_tc[pgy, pgx] = tc
        maps.l_beta[pgy, pgx] = beta
        maps.l_maxp[pgy, pgx] = max_p
        maps.l_maxq[pgy, pgx] = max_q
        maps.l_nop[pgy, pgx] = no_p
        maps.l_noq[pgy, pgx] = no_q


def _collect_edge_params_chroma(dcs, cu, edge_dir, edge, state, ctu_x, ctu_y,
                                maps: "PicDeblockMaps"):
    """Mirror of _edge_filter_chroma up to the sample-dependent decisions."""
    fmt = dcs.chroma_format
    sps = dcs.sps
    sx, sy = fmt.scale_x, fmt.scale_y
    if cu.blocks[0] is not None:
        luma_x, luma_y = cu.blocks[0].x, cu.blocks[0].y
        luma_w, luma_h = cu.blocks[0].w, cu.blocks[0].h
    else:
        luma_x, luma_y = cu.blocks[1].x << sx, cu.blocks[1].y << sy
        luma_w, luma_h = cu.blocks[1].w << sx, cu.blocks[1].h << sy
    pels_chroma_h = 4 >> sx
    pels_chroma_v = 4 >> sy
    edge_num_ver = ((luma_x - ctu_x) >> 2) + edge
    edge_num_hor = ((luma_y - ctu_y) >> 2) + edge
    if pels_chroma_h < 8 and pels_chroma_v < 8:
        if edge_dir == EDGE_VER and (edge_num_ver % (8 // pels_chroma_h)):
            return
        if edge_dir == EDGE_HOR and (edge_num_hor % (8 // pels_chroma_v)):
            return
    sh_q = _slice_of(dcs, cu)
    tc_off2 = [sh_q.cb_tc_offset_div2, sh_q.cr_tc_offset_div2]
    beta_off2 = [sh_q.cb_beta_offset_div2, sh_q.cr_beta_offset_div2]
    num_parts = luma_h // 4 if edge_dir == EDGE_VER else luma_w // 4
    bit_depth = sps.bit_depth
    bd_scale = 1 << (bit_depth - 8)
    for idx in range(num_parts):
        if edge_dir == EDGE_VER:
            lpx = luma_x + edge * 4
            lpy = luma_y + idx * 4
        else:
            lpx = luma_x + idx * 4
            lpy = luma_y + edge * 4
        gx, gy = (lpx - ctu_x) >> 2, (lpy - ctu_y) >> 2
        tmp_bs = int(state.bs[edge_dir][gy, gx])
        bs_cb = (tmp_bs >> 2) & 3
        bs_cr = (tmp_bs >> 4) & 3
        if bs_cb == 0 and bs_cr == 0:
            continue
        ppx = lpx - (4 if edge_dir == EDGE_VER else 0)
        ppy = lpy - (4 if edge_dir == EDGE_HOR else 0)
        cu_p1 = dcs.get_cu(ppx, ppy, CH_L)
        if cu_p1 is not None and not cu_p1.is_sep_tree:
            cu_p = cu_p1
        else:
            cu_p = dcs.get_cu(ppx >> sx, ppy >> sy, CH_C)
        if cu_p is None:
            continue
        max_p = int(state.max_len_p[1, (lpx - ctu_x) >> sx, (lpy - ctu_y) >> sy])
        max_q = int(state.max_len_q[1, (lpx - ctu_x) >> sx, (lpy - ctu_y) >> sy])
        large_boundary = max_p >= 3 and max_q >= 3
        chroma_hor_ctb = edge_dir == EDGE_HOR and lpy % sps.ctu_size == 0
        no_p = no_q = False
        cpx = lpx >> sx
        cpy = lpy >> sy
        tu_q = dcs.get_tu(cpx, cpy, CH_C)
        tu_p = dcs.get_tu(
            cpx - (1 if edge_dir == EDGE_VER else 0),
            cpy - (1 if edge_dir == EDGE_HOR else 0), CH_C)
        if sps.palette:
            no_p = tu_p.cu.pred_mode == 3
            no_q = tu_q.cu.pred_mode == 3
        pgy, pgx = lpy >> 2, lpx >> 2
        any_active = False
        for c_idx in range(2):
            bs = bs_cb if c_idx == 0 else bs_cr
            if not (bs == 2 or (large_boundary and bs == 1)):
                continue
            comp = c_idx + 1
            qp_p = _chroma_base_qp(dcs, tu_p, comp)
            qp_q = _chroma_base_qp(dcs, tu_q, comp)
            qp = (qp_p + qp_q + 1) >> 1
            idx_tc = _clip3(0, 63 + DEFAULT_INTRA_TC_OFFSET,
                            qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1) + (tc_off2[c_idx] << 1))
            tc = (
                (TC_TABLE[idx_tc] + (1 << (9 - bit_depth))) >> (10 - bit_depth)
                if bit_depth < 10 else TC_TABLE[idx_tc] << (bit_depth - 10)
            )
            idx_b = _clip3(0, 63, qp + (beta_off2[c_idx] << 1))
            beta = BETA_TABLE[idx_b] * bd_scale
            pre = "cb" if c_idx == 0 else "cr"
            getattr(maps, f"{pre}_active")[pgy, pgx] = True
            getattr(maps, f"{pre}_tc")[pgy, pgx] = tc
            getattr(maps, f"{pre}_beta")[pgy, pgx] = beta
            any_active = True
        if any_active:
            maps.c_large[pgy, pgx] = large_boundary
            maps.c_nop[pgy, pgx] = no_p
            maps.c_noq[pgy, pgx] = no_q
            maps.c_horctb[pgy, pgx] = chroma_hor_ctb


def _edge_filter_luma(dcs, pic, cu, edge_dir, edge, state, ctu_x, ctu_y, maxv):
    plane = pic.planes[0]
    b = cu.blocks[0]
    sps = dcs.sps
    sh_q = _slice_of(dcs, cu)
    beta_off2 = sh_q.beta_offset_div2
    tc_off2 = sh_q.tc_offset_div2
    bit_depth = sps.bit_depth
    bd_scale = 1 << (bit_depth - 8)
    num_parts = b.h // 4 if edge_dir == EDGE_VER else b.w // 4
    for idx in range(num_parts):
        if edge_dir == EDGE_VER:
            px = b.x + edge * 4
            py = b.y + idx * 4
        else:
            px = b.x + idx * 4
            py = b.y + edge * 4
        if edge_dir == EDGE_HOR and py % 4 != 0:
            continue
        if edge_dir == EDGE_VER and px % 4 != 0:
            continue
        gx, gy = (px - ctu_x) >> 2, (py - ctu_y) >> 2
        bs = state.bs[edge_dir][gy, gx] & 3
        if not bs:
            continue
        cu_p = dcs.get_cu(px - (1 if edge_dir == EDGE_VER else 0),
                          py - (1 if edge_dir == EDGE_HOR else 0), CH_L)
        if cu_p is None or not _lf_available(dcs, cu, cu_p):
            state.bs[edge_dir][gy, gx] = 0
            continue
        qp = (cu_p.qp + cu.qp + 1) >> 1
        side_p_large = side_q_large = False
        max_p = int(state.max_len_p[0, px - ctu_x, py - ctu_y])
        max_q = int(state.max_len_q[0, px - ctu_x, py - ctu_y])
        if max_p > 3:
            side_p_large = True
            # restrict filter length if P uses sub-block motion (affine/SbTMVP)
            if max_p > 5 and cu_p.affine:
                max_p = min(max_p, 5)
        if max_q > 3:
            side_q_large = True
        if edge_dir == EDGE_HOR and py % sps.ctu_size == 0:
            side_p_large = False
        idx_tc = _clip3(0, 63 + DEFAULT_INTRA_TC_OFFSET,
                        qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1) + (tc_off2 << 1))
        idx_b = _clip3(0, 63, qp + (beta_off2 << 1))
        tc = (
            (TC_TABLE[idx_tc] + (1 << (9 - bit_depth))) >> (10 - bit_depth)
            if bit_depth < 10 else TC_TABLE[idx_tc] << (bit_depth - 10)
        )
        beta = BETA_TABLE[idx_b] * bd_scale
        side_thresh = (beta + (beta >> 1)) >> 3
        thr_cut = tc * 10
        # the 4 lines in this part (block of 4)
        def line(i):
            if edge_dir == EDGE_VER:
                return _Line(plane, px, py + i, 1, 0)
            return _Line(plane, px + i, py, 0, 1)

        s0, s3 = line(0), line(3)
        dp0, dq0 = _calc_dp(s0), _calc_dq(s0)
        dp3, dq3 = _calc_dp(s3), _calc_dq(s3)
        dp0l, dq0l, dp3l, dq3l = dp0, dq0, dp3, dq3
        if side_p_large:
            if edge_dir == EDGE_VER:
                dp0l = (dp0l + _calc_dp(_Line(plane, px - 3, py, 1, 0)) + 1) >> 1
                dp3l = (dp3l + _calc_dp(_Line(plane, px - 3, py + 3, 1, 0)) + 1) >> 1
            else:
                dp0l = (dp0l + _calc_dp(_Line(plane, px, py - 3, 0, 1)) + 1) >> 1
                dp3l = (dp3l + _calc_dp(_Line(plane, px + 3, py - 3, 0, 1)) + 1) >> 1
        if side_q_large:
            if edge_dir == EDGE_VER:
                dq0l = (dq0l + _calc_dq(_Line(plane, px + 3, py, 1, 0)) + 1) >> 1
                dq3l = (dq3l + _calc_dq(_Line(plane, px + 3, py + 3, 1, 0)) + 1) >> 1
            else:
                dq0l = (dq0l + _calc_dq(_Line(plane, px, py + 3, 0, 1)) + 1) >> 1
                dq3l = (dq3l + _calc_dq(_Line(plane, px + 3, py + 3, 0, 1)) + 1) >> 1
        use_long = False
        # palette-coded sides are never filtered (LoopFilter.cpp:1091-1096)
        no_p = no_q = False
        if sps.palette:
            no_p = cu_p.pred_mode == 3  # MODE_PLT
            no_q = cu.pred_mode == 3
        if side_p_large and max_p > 5 and False:
            pass
        if side_p_large or side_q_large:
            d0l = dp0l + dq0l
            d3l = dp3l + dq3l
            dpl = dp0l + dp3l
            dql = dq0l + dq3l
            dl = d0l + d3l
            if dl < beta:
                filter_p = dpl < side_thresh
                filter_q = dql < side_thresh
                swl = _use_strong(s0, 2 * d0l, beta, tc, side_p_large, side_q_large,
                                  max_p, max_q) and _use_strong(
                    s3, 2 * d3l, beta, tc, side_p_large, side_q_large, max_p, max_q)
                if swl:
                    use_long = True
                    for i in range(4):
                        _pel_filter_luma(line(i), tc, True, no_p, no_q, thr_cut,
                                         filter_p, filter_q, maxv,
                                         side_p_large, side_q_large, max_p, max_q)
        if not use_long:
            d0 = dp0 + dq0
            d3 = dp3 + dq3
            dp = dp0 + dp3
            dq = dq0 + dq3
            d = d0 + d3
            if d < beta:
                filter_p = filter_q = False
                if max_p > 1 and max_q > 1:
                    filter_p = dp < side_thresh
                    filter_q = dq < side_thresh
                sw = False
                if max_p > 2 and max_q > 2:
                    sw = _use_strong(s0, 2 * d0, beta, tc) and _use_strong(
                        s3, 2 * d3, beta, tc)
                for i in range(4):
                    _pel_filter_luma(line(i), tc, sw, no_p, no_q, thr_cut,
                                     filter_p, filter_q, maxv)


def _edge_filter_chroma(dcs, pic, cu, edge_dir, edge, state, ctu_x, ctu_y, maxv):
    fmt = dcs.chroma_format
    sps = dcs.sps
    sx, sy = fmt.scale_x, fmt.scale_y
    if cu.blocks[0] is not None:
        luma_x, luma_y = cu.blocks[0].x, cu.blocks[0].y
        luma_w, luma_h = cu.blocks[0].w, cu.blocks[0].h
    else:
        luma_x, luma_y = cu.blocks[1].x << sx, cu.blocks[1].y << sy
        luma_w, luma_h = cu.blocks[1].w << sx, cu.blocks[1].h << sy
    pels_chroma_h = 4 >> sx
    pels_chroma_v = 4 >> sy
    edge_num_ver = ((luma_x - ctu_x) >> 2) + edge
    edge_num_hor = ((luma_y - ctu_y) >> 2) + edge
    if pels_chroma_h < 8 and pels_chroma_v < 8:
        if edge_dir == EDGE_VER and (edge_num_ver % (8 // pels_chroma_h)):
            return
        if edge_dir == EDGE_HOR and (edge_num_hor % (8 // pels_chroma_v)):
            return
    sh_q = _slice_of(dcs, cu)
    tc_off2 = [sh_q.cb_tc_offset_div2, sh_q.cr_tc_offset_div2]
    beta_off2 = [sh_q.cb_beta_offset_div2, sh_q.cr_beta_offset_div2]
    num_parts = luma_h // 4 if edge_dir == EDGE_VER else luma_w // 4
    loop_length = pels_chroma_v if edge_dir == EDGE_VER else pels_chroma_h
    bit_depth = sps.bit_depth
    bd_scale = 1 << (bit_depth - 8)
    for idx in range(num_parts):
        if edge_dir == EDGE_VER:
            lpx = luma_x + edge * 4
            lpy = luma_y + idx * 4
        else:
            lpx = luma_x + idx * 4
            lpy = luma_y + edge * 4
        gx, gy = (lpx - ctu_x) >> 2, (lpy - ctu_y) >> 2
        tmp_bs = int(state.bs[edge_dir][gy, gx])
        bs_cb = (tmp_bs >> 2) & 3
        bs_cr = (tmp_bs >> 4) & 3
        if bs_cb == 0 and bs_cr == 0:
            continue
        # P-side CU (chroma tree if sep)
        ppx = lpx - (4 if edge_dir == EDGE_VER else 0)
        ppy = lpy - (4 if edge_dir == EDGE_HOR else 0)
        cu_p1 = dcs.get_cu(ppx, ppy, CH_L)
        if cu_p1 is not None and not cu_p1.is_sep_tree:
            cu_p = cu_p1
        else:
            cu_p = dcs.get_cu(ppx >> sx, ppy >> sy, CH_C)
        if cu_p is None:
            continue
        max_p = int(state.max_len_p[1, (lpx - ctu_x) >> sx, (lpy - ctu_y) >> sy])
        max_q = int(state.max_len_q[1, (lpx - ctu_x) >> sx, (lpy - ctu_y) >> sy])
        large_boundary = max_p >= 3 and max_q >= 3
        chroma_hor_ctb = edge_dir == EDGE_HOR and lpy % sps.ctu_size == 0
        for c_idx in range(2):
            bs = bs_cb if c_idx == 0 else bs_cr
            if not (bs == 2 or (large_boundary and bs == 1)):
                continue
            comp = c_idx + 1
            plane = pic.planes[comp]
            cpx = lpx >> sx
            cpy = lpy >> sy
            tu_q = dcs.get_tu(cpx, cpy, CH_C)
            tu_p = dcs.get_tu(
                cpx - (1 if edge_dir == EDGE_VER else 0),
                cpy - (1 if edge_dir == EDGE_HOR else 0), CH_C)
            qp_p = _chroma_base_qp(dcs, tu_p, comp)
            qp_q = _chroma_base_qp(dcs, tu_q, comp)
            qp = (qp_p + qp_q + 1) >> 1
            idx_tc = _clip3(0, 63 + DEFAULT_INTRA_TC_OFFSET,
                            qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1) + (tc_off2[c_idx] << 1))
            tc = (
                (TC_TABLE[idx_tc] + (1 << (9 - bit_depth))) >> (10 - bit_depth)
                if bit_depth < 10 else TC_TABLE[idx_tc] << (bit_depth - 10)
            )
            use_long = False
            # palette-coded sides are never filtered (LoopFilter.cpp:1274-1275)
            no_p = no_q = False
            if sps.palette:
                no_p = tu_p.cu.pred_mode == 3  # MODE_PLT
                no_q = tu_q.cu.pred_mode == 3

            def cline(step):
                if edge_dir == EDGE_VER:
                    return _Line(plane, cpx, cpy + step, 1, 0)
                return _Line(plane, cpx + step, cpy, 0, 1)

            if large_boundary:
                idx_b = _clip3(0, 63, qp + (beta_off2[c_idx] << 1))
                beta = BETA_TABLE[idx_b] * bd_scale
                sub_shift = sy if edge_dir == EDGE_VER else sx
                s0 = cline(0)
                s3 = cline(1 if sub_shift == 1 else 3)
                dp0 = _calc_dp(s0, chroma_hor_ctb)
                dq0 = _calc_dq(s0)
                dp3 = _calc_dp(s3, chroma_hor_ctb)
                dq3 = _calc_dq(s3)
                d0 = dp0 + dq0
                d3 = dp3 + dq3
                d = d0 + d3
                if d < beta:
                    use_long = True
                    sw = _use_strong(s0, 2 * d0, beta, tc, False, False, 7, 7,
                                     chroma_hor_ctb) and _use_strong(
                        s3, 2 * d3, beta, tc, False, False, 7, 7, chroma_hor_ctb)
                    for step in range(loop_length):
                        _pel_filter_chroma(cline(step), tc, sw, no_p, no_q, maxv,
                                           large_boundary, chroma_hor_ctb)
            if not use_long:
                for step in range(loop_length):
                    _pel_filter_chroma(cline(step), tc, False, no_p, no_q, maxv,
                                       large_boundary, chroma_hor_ctb)


def _chroma_base_qp(dcs, tu, comp) -> int:
    """QpParam(tu, comp).Qp(0) - qpBdOffset (deblock chroma QP)."""
    from vtm_jax.ops.quant import G_ICT_MODES, qp_param

    cu = tu.cu
    sh = pic_slice(dcs, cu.slice_idx)
    mode = 0
    if tu.joint_cbcr:
        sign = 1 if dcs.ph.joint_cbcr_sign else 0
        mode = G_ICT_MODES[sign][tu.joint_cbcr]
    use_jqp = abs(mode) == 2
    adj_offsets = (0, 0, 0)
    if cu.chroma_qp_adj and dcs.pps.chroma_qp_offset_list:
        adj_offsets = dcs.pps.chroma_qp_offset_list[cu.chroma_qp_adj - 1]
    qp, _, _ = qp_param(
        cu.qp, comp, dcs.sps, sh.cb_qp_offset, sh.cr_qp_offset,
        sh.joint_cbcr_qp_offset, adj_offsets, use_jqp,
    )
    return qp - dcs.sps.qp_bd_offset
