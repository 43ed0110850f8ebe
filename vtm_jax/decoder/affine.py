"""Affine motion: merge/AMVP derivation, subblock MC with PROF, SbTMVP.

Behavioral equivalent of UnitTools.cpp getAffineMergeCand:2527,
getAffineControlPointCand:2317, xInheritedAffineMv:1990,
fillAffineMvpCand:2034, addAffineMVPCandUnscaled:1900,
setAllAffineMv:2852, getInterMergeSubPuMvpCand:2949 (SbTMVP),
InterPrediction::xPredAffineBlk:856 (incl. PROF, Buffer.cpp
applyPROFCore:45, gradFilterCore:130) and xSubPuMC:275.
"""

from __future__ import annotations

import numpy as np

from vtm_jax.decoder import cs as D
from vtm_jax.decoder import motion as M
from vtm_jax.ops import mc as MC

MAX_CU_DEPTH = 7  # MAX_CU_DEPTH (CommonDef.h:310) — 'shift' in affine math
AFFINE_MIN_BLOCK = 4
_AMVR_PREC_AFFINE = [4, 6, 2]  # quarter, 1/16, int (Mv.cpp:44)
MRG_TYPE_DEFAULT, MRG_TYPE_SUBPU_ATMVP = 0, 1
ATMVP_SUB_BLOCK_SIZE = 3  # log2(8)


def change_affine_prec_amvr_2_internal(mv, imv: int):
    return M.change_precision(mv, _AMVR_PREC_AFFINE[imv], 6)


def round_affine_prec_internal_2_amvr(mv, imv: int):
    return M.round_to_precision(mv, 6, _AMVR_PREC_AFFINE[imv])


def _round_affine(vx: int, vy: int, shift: int):
    off = 1 << (shift - 1)
    rx = (vx + off - 1) >> shift if vx >= 0 else (vx + off) >> shift
    ry = (vy + off - 1) >> shift if vy >= 0 else (vy + off) >> shift
    return rx, ry


def _floor_log2(v: int) -> int:
    return v.bit_length() - 1


class AffineMergeCtx:
    def __init__(self, max_cand: int):
        self.mv = [[[(0, 0)] * 3, [(0, 0)] * 3] for _ in range(max_cand)]
        self.ref_idx = [[-1, -1] for _ in range(max_cand)]
        self.interdir = [0] * max_cand
        self.affine_type = [0] * max_cand
        self.merge_type = [MRG_TYPE_DEFAULT] * max_cand
        self.bcw = [M.BCW_DEFAULT] * max_cand
        self.num_valid = 0
        self.max_cand = max_cand
        self.subpu_mi = None  # SbTMVP per-8x8 motion (set when used)


def _inherited_affine_mv(dcs, cu, nb, lst: int):
    """PU::xInheritedAffineMv (UnitTools.cpp:1990)."""
    nb_b = nb.blocks[0]
    cur_b = cu.blocks[0]
    pos_nei_x, pos_nei_y = nb_b.x, nb_b.y
    nei_w, nei_h = nb_b.w, nb_b.h
    mv_lt = nb.mv_affi[lst][0]
    mv_rt = nb.mv_affi[lst][1]
    mv_lb = nb.mv_affi[lst][2]
    is_top_ctu_boundary = False
    if (pos_nei_y + nei_h) % dcs.ctu_size == 0 and (pos_nei_y + nei_h) == cur_b.y:
        mv_lt = M.get_motion_info(dcs, nb_b.x, nb_b.y + nb_b.h - 1).mv[lst]
        mv_rt = M.get_motion_info(dcs, nb_b.x + nb_b.w - 1, nb_b.y + nb_b.h - 1).mv[lst]
        pos_nei_y += nei_h
        is_top_ctu_boundary = True
    shift = MAX_CU_DEPTH
    dhx = (mv_rt[0] - mv_lt[0]) << (shift - _floor_log2(nei_w))
    dhy = (mv_rt[1] - mv_lt[1]) << (shift - _floor_log2(nei_w))
    if nb.affine_type == 1 and not is_top_ctu_boundary:
        dvx = (mv_lb[0] - mv_lt[0]) << (shift - _floor_log2(nei_h))
        dvy = (mv_lb[1] - mv_lt[1]) << (shift - _floor_log2(nei_h))
    else:
        dvx = -dhy
        dvy = dhx
    sh = mv_lt[0] << shift
    sv = mv_lt[1] << shift
    out = []
    dx0 = cur_b.x - pos_nei_x
    dy0 = cur_b.y - pos_nei_y
    for px, py in ((dx0, dy0), (dx0 + cur_b.w, dy0),
                   (dx0, dy0 + cur_b.h)):
        hx = sh + dhx * px + dvx * py
        vy = sv + dhy * px + dvy * py
        hx, vy = _round_affine(hx, vy, shift)
        out.append(M.clip_storage((hx, vy)))
    if cu.affine_type != 1:
        out[2] = (0, 0)
        # reference leaves rcMv[2] unset for 4-param; value unused
    return out


def _affine_neighbours(dcs, cu):
    """getAvailableAffineNeighboursFor{Left,Above}Predictor."""
    b = cu.blocks[0]
    plevel = dcs.sps.log2_parallel_merge_level
    cands = []

    def check(lx, ly):
        n = M._get_pu_restricted(dcs, cu, lx, ly)
        if (n is not None and n.affine and n.merge_type == MRG_TYPE_DEFAULT
                and M._is_diff_mer((b.x, b.y), (lx, ly), plevel)):
            return n
        return None

    # left: A0 then A1
    n = check(b.x - 1, b.y + b.h)
    if n is None:
        n = check(b.x - 1, b.y + b.h - 1)
    if n is not None:
        cands.append(n)
    # above: B0, B1, B2
    n = check(b.x + b.w, b.y - 1)
    if n is None:
        n = check(b.x + b.w - 1, b.y - 1)
        if n is None:
            n = check(b.x - 1, b.y - 1)
    if n is not None:
        cands.append(n)
    return cands


def _sbtmvp_cand(dcs, cu, ctx: AffineMergeCtx):
    """SbTMVP first candidate of the subblock merge list
    (getAffineMergeCand head + getInterMergeSubPuMvpCand)."""
    sh = dcs.sh
    sps = dcs.sps
    if not sps.sbtmvp or not dcs.ph.tmvp_enabled:
        return False
    ref0 = sh.ref_pics[0][0]
    if sh.poc == ref0.poc:
        return False
    b = cu.blocks[0]
    plevel = sps.log2_parallel_merge_level
    # A1 spatial MV
    tmv = (0, 0)
    n = M._get_pu_restricted(dcs, cu, b.x - 1, b.y + b.h - 1)
    col_pic = sh.ref_pics[1 - int(sh.col_from_l0) if sh.is_b else 0][sh.col_ref_idx]
    if (n is not None and not b.contains(b.x - 1, b.y + b.h - 1)
            and M._is_diff_mer((b.x, b.y), (b.x - 1, b.y + b.h - 1), plevel)
            and n.pred_mode == D.MODE_INTER):
        mi = M.get_motion_info(dcs, b.x - 1, b.y + b.h - 1)
        if (mi.interdir & 1) and sh.ref_pics[0][mi.ref_idx[0]] is col_pic:
            tmv = mi.mv[0]
        elif sh.is_b and (mi.interdir & 2) and sh.ref_pics[1][mi.ref_idx[1]] is col_pic:
            tmv = mi.mv[1]
    # temporal vector at integer precision
    tx = M._change_prec_comp(tmv[0], 2 - 6)
    ty = M._change_prec_comp(tmv[1], 2 - 6)

    log2ctu = dcs.sps.log2_ctu_size
    ctu_x = (b.x >> log2ctu) << log2ctu
    ctu_y = (b.y >> log2ctu) << log2ctu

    def clip_col(px, py):
        hor_max = min(dcs.pic_w - 1, ctu_x + dcs.ctu_size + 3)
        hor_min = max(0, ctu_x)
        ver_max = min(dcs.pic_h - 1, ctu_y + dcs.ctu_size - 1)
        ver_min = max(0, ctu_y)
        return (min(hor_max, max(hor_min, px)) & ~15,
                min(ver_max, max(ver_min, py)) & ~15)

    cx, cy = clip_col(b.x + (b.w >> 1) + tx, b.y + (b.h >> 1) + ty)
    mf = col_pic.motion
    is_b = sh.is_b
    if not (mf["inter"][cy >> 2, cx >> 2] and not mf["ibc"][cy >> 2, cx >> 2]):
        return False
    ctr_dir = 0
    ctr_mv = [(0, 0), (0, 0)]
    for lst in range(2 if is_b else 1):
        found, cmv = M.get_colocated_mvp(dcs, cu, lst, (cx, cy), 0, sb_flag=True)
        if found:
            ctr_mv[lst] = cmv
            ctr_dir |= 1 << lst
    if ctr_dir == 0:
        return False
    # per-subblock motion
    num_line = max(b.w >> ATMVP_SUB_BLOCK_SIZE, 1)
    num_col = max(b.h >> ATMVP_SUB_BLOCK_SIZE, 1)
    pu_h = b.h if num_col == 1 else 8
    pu_w = b.w if num_line == 1 else 8
    x_off = (pu_w >> 1) + tx
    y_off = (pu_h >> 1) + ty
    bi_restrict = M.is_bipred_restriction(cu)
    sub = []
    for y in range(b.y, b.y + b.h, pu_h):
        row = []
        for x in range(b.x, b.x + b.w, pu_w):
            px, py = clip_col(x + x_off, y + y_off)
            found_any = False
            mv = [(0, 0), (0, 0)]
            ri = [-1, -1]
            if mf["inter"][py >> 2, px >> 2] and not mf["ibc"][py >> 2, px >> 2]:
                for lst in range(2 if is_b else 1):
                    ok, cmv = M.get_colocated_mvp(dcs, cu, lst, (px, py), 0,
                                                  sb_flag=True)
                    if ok:
                        mv[lst] = cmv
                        ri[lst] = 0
                        found_any = True
            if not found_any:
                mv = [ctr_mv[0], ctr_mv[1]]
                ri = [0 if (ctr_dir & 1) else -1, 0 if (ctr_dir & 2) else -1]
            d = (1 if ri[0] != -1 else 0) + (2 if ri[1] != -1 else 0)
            if bi_restrict and d == 3:
                d = 1
                mv[1] = (0, 0)
                ri[1] = -1
            row.append((d, mv, ri))
        sub.append(row)
    i = ctx.num_valid
    for mv_num in range(3):
        ctx.mv[i][0][mv_num] = ctr_mv[0]
        ctx.mv[i][1][mv_num] = ctr_mv[1]
    ctx.ref_idx[i] = [0 if (ctr_dir & 1) else -1, 0 if (ctr_dir & 2) else -1]
    ctx.interdir[i] = ctr_dir
    ctx.affine_type[i] = 2  # AFFINE_MODEL_NUM marker
    ctx.merge_type[i] = MRG_TYPE_SUBPU_ATMVP
    ctx.subpu_mi = (sub, pu_w, pu_h)
    return True


def get_affine_merge_cand(dcs, cu, mrg_cand_idx: int) -> AffineMergeCtx:
    """PU::getAffineMergeCand (UnitTools.cpp:2527)."""
    sh = dcs.sh
    sps = dcs.sps
    max_cand = dcs.ph.max_num_affine_merge_cand
    ctx = AffineMergeCtx(max_cand)
    is_b = sh.is_b
    b = cu.blocks[0]
    plevel = sps.log2_parallel_merge_level

    if _sbtmvp_cand(dcs, cu, ctx):
        if ctx.num_valid == mrg_cand_idx:
            ctx.num_valid += 1
            return ctx
        ctx.num_valid += 1
        if ctx.num_valid == max_cand:
            return ctx

    if sps.affine:
        # inherited candidates
        for nb in _affine_neighbours(dcs, cu):
            i = ctx.num_valid
            cu.affine_type = nb.affine_type
            mv0 = [(0, 0)] * 3
            mv1 = [(0, 0)] * 3
            if nb.interdir != 2:
                mv0 = _inherited_affine_mv(dcs, cu, nb, 0)
            if is_b and nb.interdir != 1:
                mv1 = _inherited_affine_mv(dcs, cu, nb, 1)
            ctx.mv[i][0] = mv0
            ctx.mv[i][1] = mv1
            ctx.ref_idx[i] = [nb.ref_idx[0], nb.ref_idx[1]]
            ctx.interdir[i] = nb.interdir
            ctx.affine_type[i] = nb.affine_type
            ctx.bcw[i] = nb.bcw_idx
            if i == mrg_cand_idx:
                ctx.num_valid += 1
                return ctx
            ctx.num_valid += 1
            if ctx.num_valid == max_cand:
                return ctx
        # constructed candidates
        mi = [None] * 4
        avail = [False] * 4
        neigh_bcw = [M.BCW_DEFAULT, M.BCW_DEFAULT]
        for lx, ly in ((b.x - 1, b.y - 1), (b.x, b.y - 1), (b.x - 1, b.y)):
            n = M._get_pu_restricted(dcs, cu, lx, ly)
            if (n is not None and n.pred_mode == D.MODE_INTER
                    and M._is_diff_mer((b.x, b.y), (lx, ly), plevel)):
                avail[0] = True
                mi[0] = M.get_motion_info(dcs, lx, ly)
                neigh_bcw[0] = n.bcw_idx
                break
        for lx, ly in ((b.x + b.w - 1, b.y - 1), (b.x + b.w, b.y - 1)):
            n = M._get_pu_restricted(dcs, cu, lx, ly)
            if (n is not None and n.pred_mode == D.MODE_INTER
                    and M._is_diff_mer((b.x, b.y), (lx, ly), plevel)):
                avail[1] = True
                mi[1] = M.get_motion_info(dcs, lx, ly)
                neigh_bcw[1] = n.bcw_idx
                break
        for lx, ly in ((b.x - 1, b.y + b.h - 1), (b.x - 1, b.y + b.h)):
            n = M._get_pu_restricted(dcs, cu, lx, ly)
            if (n is not None and n.pred_mode == D.MODE_INTER
                    and M._is_diff_mer((b.x, b.y), (lx, ly), plevel)):
                avail[2] = True
                mi[2] = M.get_motion_info(dcs, lx, ly)
                break
        if dcs.ph.tmvp_enabled:
            c0, _ = M._tmvp_c0_c1(dcs, cu)
            if c0 is not None:
                mi3 = M.MotionInfo()
                found, cmv = M.get_colocated_mvp(dcs, cu, 0, c0, 0)
                if found:
                    mi3.mv[0] = cmv
                    mi3.ref_idx[0] = 0
                    mi3.interdir = 1
                    avail[3] = True
                if is_b:
                    found, cmv = M.get_colocated_mvp(dcs, cu, 1, c0, 0)
                    if found:
                        mi3.mv[1] = cmv
                        mi3.ref_idx[1] = 0
                        mi3.interdir |= 2
                        avail[3] = True
                mi[3] = mi3
        models = [
            ([0, 1, 2], 3), ([0, 1, 3], 3), ([0, 2, 3], 3), ([1, 2, 3], 3),
            ([0, 1], 2), ([0, 2], 2),
        ]
        start = 0 if sps.affine_type else 4
        for model_idx in range(start, 6):
            ver_idx, ver_num = models[model_idx]
            _construct_cand(dcs, cu, mi, avail, ver_idx,
                            neigh_bcw[1] if model_idx == 3 else neigh_bcw[0],
                            model_idx, ver_num, ctx, is_b)
            if ctx.num_valid != 0 and ctx.num_valid - 1 == mrg_cand_idx:
                return ctx
            if ctx.num_valid == max_cand:
                return ctx

    # zero padding
    while ctx.num_valid < max_cand:
        i = ctx.num_valid
        for mv_num in range(3):
            ctx.mv[i][0][mv_num] = (0, 0)
        ctx.ref_idx[i][0] = 0
        ctx.interdir[i] = 1
        if is_b:
            for mv_num in range(3):
                ctx.mv[i][1][mv_num] = (0, 0)
            ctx.ref_idx[i][1] = 0
            ctx.interdir[i] = 3
        ctx.affine_type[i] = 0
        if i == mrg_cand_idx:
            ctx.num_valid += 1
            return ctx
        ctx.num_valid += 1
    return ctx


def _construct_cand(dcs, cu, mi, avail, ver_idx, bcw_idx, model_idx, ver_num,
                    ctx: AffineMergeCtx, is_b: bool):
    """PU::getAffineControlPointCand (UnitTools.cpp:2317)."""
    b = cu.blocks[0]
    cw, ch = b.w, b.h
    shift = MAX_CU_DEPTH
    shift_htow = shift + _floor_log2(cw) - _floor_log2(ch)
    ref_idx = [-1, -1]
    direction = 0
    cur_type = 0 if ver_num == 2 else 1
    idxs = ver_idx[:ver_num]
    if not all(avail[i] for i in idxs):
        return
    for l in range(2):
        ris = [mi[i].ref_idx[l] for i in idxs]
        if all(r >= 0 for r in ris) and all(r == ris[0] for r in ris):
            direction |= l + 1
            ref_idx[l] = ris[0]
    if direction == 0:
        return
    cmv = [[(0, 0)] * 4 for _ in range(2)]
    for l in range(2):
        if direction & (l + 1):
            for i in idxs:
                cmv[l][i] = mi[i].mv[l]
            if model_idx == 1:
                v = (cmv[l][3][0] + cmv[l][0][0] - cmv[l][1][0],
                     cmv[l][3][1] + cmv[l][0][1] - cmv[l][1][1])
                cmv[l][2] = M.clip_storage(v)
            elif model_idx == 2:
                v = (cmv[l][3][0] + cmv[l][0][0] - cmv[l][2][0],
                     cmv[l][3][1] + cmv[l][0][1] - cmv[l][2][1])
                cmv[l][1] = M.clip_storage(v)
            elif model_idx == 3:
                v = (cmv[l][1][0] + cmv[l][2][0] - cmv[l][3][0],
                     cmv[l][1][1] + cmv[l][2][1] - cmv[l][3][1])
                cmv[l][0] = M.clip_storage(v)
            elif model_idx == 5:
                vx = (cmv[l][0][0] << shift) + (
                    (cmv[l][2][1] - cmv[l][0][1]) << shift_htow
                )
                vy = (cmv[l][0][1] << shift) - (
                    (cmv[l][2][0] - cmv[l][0][0]) << shift_htow
                )
                vx, vy = _round_affine(vx, vy, shift)
                cmv[l][1] = M.clip_storage((vx, vy))
    i = ctx.num_valid
    for k in range(3):
        ctx.mv[i][0][k] = cmv[0][k]
        ctx.mv[i][1][k] = cmv[1][k]
    ctx.ref_idx[i] = ref_idx
    ctx.interdir[i] = direction
    ctx.affine_type[i] = cur_type
    ctx.bcw[i] = bcw_idx if direction == 3 else M.BCW_DEFAULT
    ctx.num_valid += 1


# ---------------------------------------------------------------------------
def set_all_affine_mv(dcs, cu, lst: int, lt, rt, lb, clip_cpmvs: bool):
    """PU::setAllAffineMv (UnitTools.cpp:2852): derive per-4x4 subblock MVs
    into the motion field and store the CPMVs."""
    b = cu.blocks[0]
    if clip_cpmvs:
        lt = M.mv_clip_periodic(lt)
        rt = M.mv_clip_periodic(rt)
        if cu.affine_type == 1:
            lb = M.mv_clip_periodic(lb)
    shift = MAX_CU_DEPTH
    w, h = b.w, b.h
    dhx = (rt[0] - lt[0]) << (shift - _floor_log2(w))
    dhy = (rt[1] - lt[1]) << (shift - _floor_log2(w))
    if cu.affine_type == 1:
        dvx = (lb[0] - lt[0]) << (shift - _floor_log2(h))
        dvy = (lb[1] - lt[1]) << (shift - _floor_log2(h))
    else:
        dvx = -dhy
        dvy = dhx
    sh_ = lt[0] << shift
    sv_ = lt[1] << shift
    spread = _spread_over_limit(dhx, dhy, dvx, dvy, cu.interdir)
    for hh in range(0, h, 4):
        for ww in range(0, w, 4):
            if not spread:
                hx = sh_ + dhx * (2 + ww) + dvx * (2 + hh)
                vy = sv_ + dhy * (2 + ww) + dvy * (2 + hh)
            else:
                hx = sh_ + dhx * (w >> 1) + dvx * (h >> 1)
                vy = sv_ + dhy * (w >> 1) + dvy * (h >> 1)
            hx, vy = _round_affine(hx, vy, shift)
            mv = M.clip_storage((hx, vy))
            y4 = (b.y + hh) >> 2
            x4 = (b.x + ww) >> 2
            dcs.mf_mv[y4, x4, lst, 0] = mv[0]
            dcs.mf_mv[y4, x4, lst, 1] = mv[1]
    cu.mv_affi[lst] = [lt, rt, lb]


def _spread_over_limit(a, b, c, d, pred_type):
    """InterPrediction::isSubblockVectorSpreadOverLimit
    (InterPrediction.cpp:817)."""
    s4 = 4 << 11
    tap = 6
    if pred_type == 3:
        rw = max(max(0, 4 * a + s4), max(4 * c, 4 * a + 4 * c + s4)) - min(
            min(0, 4 * a + s4), min(4 * c, 4 * a + 4 * c + s4)
        )
        rh = max(max(0, 4 * b), max(4 * d + s4, 4 * b + 4 * d + s4)) - min(
            min(0, 4 * b), min(4 * d + s4, 4 * b + 4 * d + s4)
        )
        rw = (rw >> 11) + tap + 3
        rh = (rh >> 11) + tap + 3
        return rw * rh > (tap + 9) * (tap + 9)
    rw = max(0, 4 * a + s4) - min(0, 4 * a + s4)
    rh = max(0, 4 * b) - min(0, 4 * b)
    rw = (rw >> 11) + tap + 3
    rh = (rh >> 11) + tap + 3
    if rw * rh > (tap + 9) * (tap + 5):
        return True
    rw = max(0, 4 * c) - min(0, 4 * c)
    rh = max(0, 4 * d + s4) - min(0, 4 * d + s4)
    rw = (rw >> 11) + tap + 3
    rh = (rh >> 11) + tap + 3
    return rw * rh > (tap + 5) * (tap + 9)


def span_affine_motion(dcs, cu):
    """spanMotionInfo for affine CUs: per-4x4 MVs already in mf_mv; fill the
    remaining fields uniformly (UnitTools.cpp:3134)."""
    b = cu.blocks[0]
    sl = slice(b.y >> 2, b.y1 >> 2), slice(b.x >> 2, b.x1 >> 2)
    dcs.mf_inter[sl] = True
    dcs.mf_ibc[sl] = False
    dcs.mf_interdir[sl] = cu.interdir
    dcs.mf_slice[sl] = dcs.cur_ind_slice_idx
    dcs.mf_alt_hpel[sl] = False
    for l in range(2):
        if cu.ref_idx[l] == -1:
            dcs.mf_mv[sl[0], sl[1], l, :] = 0
        dcs.mf_refidx[sl[0], sl[1], l] = cu.ref_idx[l]
    dcs.mf_bcw[sl] = cu.bcw_idx


def span_sbtmvp_motion(dcs, cu, sub, pu_w, pu_h):
    """spanMotionInfo for SbTMVP (copy the sub-PU buffer)."""
    b = cu.blocks[0]
    slice_idx = dcs.cur_ind_slice_idx
    for sy, row in enumerate(sub):
        for sx, (d, mv, ri) in enumerate(row):
            y0 = (b.y + sy * pu_h) >> 2
            x0 = (b.x + sx * pu_w) >> 2
            ys = slice(y0, y0 + (pu_h >> 2))
            xs = slice(x0, x0 + (pu_w >> 2))
            dcs.mf_inter[ys, xs] = True
            dcs.mf_ibc[ys, xs] = False
            dcs.mf_interdir[ys, xs] = d
            dcs.mf_slice[ys, xs] = slice_idx
            dcs.mf_alt_hpel[ys, xs] = False
            for l in range(2):
                dcs.mf_mv[ys, xs, l, 0] = mv[l][0]
                dcs.mf_mv[ys, xs, l, 1] = mv[l][1]
                dcs.mf_refidx[ys, xs, l] = ri[l]
            dcs.mf_bcw[ys, xs] = M.BCW_DEFAULT


# ---------------------------------------------------------------------------
def fill_affine_mvp_cand(dcs, cu, lst: int, ref_idx: int):
    """PU::fillAffineMvpCand (UnitTools.cpp:2034) → list of (LT, RT, LB)."""
    cands = []
    b = cu.blocks[0]
    pos_lt = (b.x, b.y)
    pos_rt = (b.x + b.w - 1, b.y)
    pos_lb = (b.x, b.y + b.h - 1)
    cur_ref_poc = dcs.sh.ref_pocs[lst][ref_idx]

    def add_inherited(lx, ly):
        n = M._get_pu_restricted(dcs, cu, lx, ly)
        if (n is None or n.pred_mode != D.MODE_INTER or not n.affine
                or n.merge_type != MRG_TYPE_DEFAULT):
            return False
        mi = M.get_motion_info(dcs, lx, ly)
        for l2 in (lst, 1 - lst):
            ri = mi.ref_idx[l2]
            if (n.interdir & (l2 + 1)) == 0 or ri < 0:
                continue
            if dcs.sh.ref_pocs[l2][ri] != cur_ref_poc:
                continue
            out = _inherited_affine_mv(dcs, cu, n, l2)
            lt = round_affine_prec_internal_2_amvr(out[0], cu.imv)
            rt = round_affine_prec_internal_2_amvr(out[1], cu.imv)
            lb = round_affine_prec_internal_2_amvr(out[2], cu.imv) \
                if cu.affine_type == 1 else out[2]
            cands.append([lt, rt, lb])
            return True
        return False

    if not add_inherited(pos_lb[0] - 1, pos_lb[1] + 1):
        add_inherited(pos_lb[0] - 1, pos_lb[1])
    if not add_inherited(pos_rt[0] + 1, pos_rt[1] - 1):
        if not add_inherited(pos_rt[0], pos_rt[1] - 1):
            add_inherited(pos_lt[0] - 1, pos_lt[1] - 1)

    if len(cands) >= 2:
        return cands[:2]

    # constructed from corner translational MVPs
    def corner(positions):
        for lx, ly in positions:
            mi = M._get_inter_neighbor(dcs, cu, lx, ly)
            if mi is None:
                continue
            for l2 in (lst, 1 - lst):
                ri = mi.ref_idx[l2]
                if ri >= 0 and dcs.sh.ref_pocs[l2][ri] == cur_ref_poc:
                    return mi.mv[l2]
        return None

    v0 = corner([(pos_lt[0] - 1, pos_lt[1] - 1), (pos_lt[0], pos_lt[1] - 1),
                 (pos_lt[0] - 1, pos_lt[1])])
    v1 = corner([(pos_rt[0], pos_rt[1] - 1), (pos_rt[0] + 1, pos_rt[1] - 1)])
    v2 = corner([(pos_lb[0] - 1, pos_lb[1]), (pos_lb[0] - 1, pos_lb[1] + 1)])
    pattern = (1 if v0 else 0) | (2 if v1 else 0) | (4 if v2 else 0)
    out = [
        round_affine_prec_internal_2_amvr(v0, cu.imv) if v0 else (0, 0),
        round_affine_prec_internal_2_amvr(v1, cu.imv) if v1 else (0, 0),
        round_affine_prec_internal_2_amvr(v2, cu.imv) if v2 else (0, 0),
    ]
    if pattern == 7 or (pattern == 3 and cu.affine_type == 0):
        cands.append([out[0], out[1], out[2]])
    if len(cands) < 2:
        for i in (2, 1, 0):
            if len(cands) >= 2:
                break
            if pattern & (1 << i):
                cands.append([out[i], out[i], out[i]])
        if len(cands) < 2 and dcs.ph.tmvp_enabled:
            c0, c1 = M._tmvp_c0_c1(dcs, cu)
            found, cmv = (M.get_colocated_mvp(dcs, cu, lst, c0, ref_idx)
                          if c0 else (False, None))
            if not found:
                found, cmv = M.get_colocated_mvp(dcs, cu, lst, c1, ref_idx)
            if found:
                cmv = round_affine_prec_internal_2_amvr(cmv, cu.imv)
                cands.append([cmv, cmv, cmv])
        while len(cands) < 2:
            cands.append([(0, 0), (0, 0), (0, 0)])
    cands = cands[:2]
    return [
        [round_affine_prec_internal_2_amvr(v, cu.imv) for v in c]
        for c in cands
    ]


# ---------------------------------------------------------------------------
# Affine motion compensation with PROF

def affine_mc_component(recon, dcs, cu, lst: int, comp: int, rnd_res: bool,
                        stored_mv):
    """xPredAffineBlk for one component/list.  `stored_mv` is the per-4x4
    luma subblock MV dict shared between luma and chroma passes."""
    sh = dcs.sh
    fmt = dcs.chroma_format
    bd = recon.bit_depth
    ref_plane = sh.ref_pics[lst][cu.ref_idx[lst]].planes[comp]
    b = cu.blocks[0]
    cb = cu.blocks[comp]
    scale_x = fmt.scale_x if comp else 0
    scale_y = fmt.scale_y if comp else 0
    lt, rt, lb = cu.mv_affi[lst]
    w, h = b.w, b.h
    cx_w = w >> scale_x
    cx_h = h >> scale_y
    bw = bh = AFFINE_MIN_BLOCK
    shift = MAX_CU_DEPTH
    dhx = (rt[0] - lt[0]) << (shift - _floor_log2(cx_w))
    dhy = (rt[1] - lt[1]) << (shift - _floor_log2(cx_w))
    if cu.affine_type == 1:
        dvx = (lb[0] - lt[0]) << (shift - _floor_log2(cx_h))
        dvy = (lb[1] - lt[1]) << (shift - _floor_log2(cx_h))
    else:
        dvx = -dhy
        dvy = dhx
    sh_mv = lt[0] << shift
    sv_mv = lt[1] << shift
    spread = _spread_over_limit(dhx, dhy, dvx, dvy, cu.interdir)
    enable_prof = (
        dcs.sps.prof and comp == 0 and not dcs.ph.dis_prof
        and not (
            (cu.affine_type == 1 and lt == rt and lt == lb)
            or (cu.affine_type == 0 and lt == rt)
        )
        and not spread
    )
    round_shift = shift - 4 + 4  # iBit - 4 + MV_FRACTIONAL_BITS_INTERNAL
    out = np.zeros((cx_h, cx_w), dtype=np.int64)
    # PROF per-sample delta MVs (same pattern for every subblock)
    if enable_prof:
        quad_hx, quad_hy = dhx << 2, dhy << 2
        quad_vx, quad_vy = dvx << 2, dvy << 2
        dmv_h = np.zeros((4, 4), dtype=np.int64)
        dmv_v = np.zeros((4, 4), dtype=np.int64)
        dmv_h[0, 0] = ((dhx + dvx) << 1) - ((quad_hx + quad_vx) << 1)
        dmv_v[0, 0] = ((dhy + dvy) << 1) - ((quad_hy + quad_vy) << 1)
        for ww in range(1, 4):
            dmv_h[0, ww] = dmv_h[0, ww - 1] + quad_hx
            dmv_v[0, ww] = dmv_v[0, ww - 1] + quad_hy
        for hh in range(1, 4):
            dmv_h[hh] = dmv_h[hh - 1] + quad_vx
            dmv_v[hh] = dmv_v[hh - 1] + quad_vy
        # roundAffineMv(mvShift=8) + clip to ±31
        def rnd8(a):
            off = 1 << 7
            return np.clip(np.where(a >= 0, (a + off - 1) >> 8, (a + off) >> 8),
                           -31, 31)
        dmv_h = rnd8(dmv_h)
        dmv_v = rnd8(dmv_v)
    for hh in range(0, cx_h, bh):
        for ww in range(0, cx_w, bw):
            if comp == 0 or fmt.scale_x == 0:
                if not spread:
                    hx = sh_mv + dhx * (2 + ww) + dvx * (2 + hh)
                    vy = sv_mv + dhy * (2 + ww) + dvy * (2 + hh)
                else:
                    hx = sh_mv + dhx * (cx_w >> 1) + dvx * (cx_h >> 1)
                    vy = sv_mv + dhy * (cx_w >> 1) + dvy * (cx_h >> 1)
                hx, vy = _round_affine(hx, vy, round_shift)
                mv = M.clip_storage((hx, vy))
                if comp == 0:
                    stored_mv[(hh >> 2, ww >> 2)] = mv
                mv = M.clip_mv_in_pic(mv, b.x, b.y, dcs)
            else:
                m0 = stored_mv[((hh << scale_y) >> 2, (ww << scale_x) >> 2)]
                m1 = stored_mv[(((hh << scale_y) >> 2) + scale_y,
                                ((ww << scale_x) >> 2) + scale_x)]
                sx_ = m0[0] + m1[0]
                sy_ = m0[1] + m1[1]
                rx, ry = _round_affine(sx_, sy_, 1)
                mv = M.clip_mv_in_pic((rx, ry), b.x, b.y, dcs)
            if scale_x:
                x_int, x_frac = mv[0] >> 5, mv[0] & 31
            else:
                x_int, x_frac = mv[0] >> 4, mv[0] & 15
            if scale_y:
                y_int, y_frac = mv[1] >> 5, mv[1] & 31
            else:
                y_int, y_frac = mv[1] >> 4, mv[1] & 15
            x0 = cb.x + x_int + ww
            y0 = cb.y + y_int + hh
            if not enable_prof:
                blk = MC.mc_block(ref_plane, x0, y0, bw, bh, x_frac, y_frac,
                                  comp == 0, bd, rnd_res,
                                  scale_x=scale_x, scale_y=scale_y)
                out[hh : hh + bh, ww : ww + bw] = blk
                continue
            # PROF: 14-bit MC + integer-sample ring, gradients, per-sample dI
            blk = MC.mc_block(ref_plane, x0, y0, bw, bh, x_frac, y_frac,
                              True, bd, rnd_res=False)
            sh2 = max(2, MC.IF_INTERNAL_PREC - bd)
            x_off = x_frac >> 3
            y_off = y_frac >> 3
            ring_src = _affine_gather(ref_plane, x0 + x_off - 1, y0 + y_off - 1,
                                      bw + 2, bh + 2)
            ext = (ring_src << sh2) - MC.IF_INTERNAL_OFFS
            ext[1 : bh + 1, 1 : bw + 1] = blk
            gx = (ext[1 : bh + 1, 2 : bw + 2] >> 6) - (ext[1 : bh + 1, 0:bw] >> 6)
            gy = (ext[2 : bh + 2, 1 : bw + 1] >> 6) - (ext[0:bh, 1 : bw + 1] >> 6)
            di_limit = 1 << max(bd + 1, 13)
            di = np.clip(dmv_h * gx + dmv_v * gy, -di_limit, di_limit - 1)
            res = blk + di
            if rnd_res:
                off = (1 << (sh2 - 1)) + MC.IF_INTERNAL_OFFS
                res = np.clip((res + off) >> sh2, 0, (1 << bd) - 1)
            out[hh : hh + bh, ww : ww + bw] = res
    return out


def _affine_gather(plane, x0, y0, w, h):
    ph, pw = plane.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, ph - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, pw - 1)
    return plane[np.ix_(ys, xs)].astype(np.int64)
