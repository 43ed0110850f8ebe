"""ALF + CC-ALF — exact integer reference implementation.

Behavioral contract from CommonLib/AdaptiveLoopFilter.cpp: 4x4 gradient
classification with virtual-boundary handling (deriveClassificationBlk:859),
geometric transposes + clipped 7x7/5x5 diamond filtering (filterBlk),
fixed/APS filter-set reconstruction (reconstructCoeff:~700), and the
cross-component filter (filterBlkCcAlf).
"""

from __future__ import annotations

import numpy as np

from vtm_jax.common import rom

MAX_NUM_ALF_CLASSES = 25
MAX_NUM_ALF_LUMA_COEFF = 13
NUM_FIXED_FILTER_SETS = 16
NUM_BITS = 8
SCALE_BITS_CC = 7
PAD = 4
ACT_TH = [0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4]
TRANSPOSE_TABLE = [0, 1, 0, 2, 2, 3, 1, 3]


def clip_values(bit_depth: int) -> list[int]:
    vals = [1 << bit_depth]
    shift = bit_depth - 8
    for i in range(1, 4):
        vals.append(1 << (7 - 2 * i + shift))
    return vals


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


def _clip_alf(clip, ref, v0, v1):
    return _clip3(-clip, clip, v0 - ref) + _clip3(-clip, clip, v1 - ref)


def reconstruct_luma_coeffs(alf_param, bit_depth: int):
    """reconstructCoeff for luma: (25, 13) coeff + clip arrays."""
    factor = 1 << (NUM_BITS - 1)
    cvals = clip_values(bit_depth)
    coeff = np.zeros((MAX_NUM_ALF_CLASSES, MAX_NUM_ALF_LUMA_COEFF), dtype=np.int64)
    clipp = np.zeros_like(coeff)
    for cls in range(MAX_NUM_ALF_CLASSES):
        f = alf_param.filter_coeff_delta_idx[cls]
        for i in range(12):
            coeff[cls, i] = alf_param.luma_coeff[f][i]
            ci = alf_param.luma_clip[f][i] if alf_param.nonlinear_luma else 0
            clipp[cls, i] = cvals[ci]
        coeff[cls, 12] = factor
        clipp[cls, 12] = cvals[0]
    return coeff, clipp


def reconstruct_chroma_coeffs(alf_param, alt: int, bit_depth: int):
    factor = 1 << (NUM_BITS - 1)
    cvals = clip_values(bit_depth)
    coeff = np.zeros(7, dtype=np.int64)
    clipp = np.zeros(7, dtype=np.int64)
    for i in range(6):
        coeff[i] = alf_param.chroma_coeff[alt][i]
        ci = alf_param.chroma_clip[alt][i] if alf_param.nonlinear_chroma else 0
        clipp[i] = cvals[ci]
    coeff[6] = factor
    clipp[6] = cvals[0]
    return coeff, clipp


def fixed_filter_sets(bit_depth: int):
    """m_fixedFilterSetCoeffDec + m_clipDefault."""
    fixed = rom.get("alfFixedFilterCoeff").astype(np.int64)  # (64, 13)
    mapping = rom.get("alfClassToFilterMapping").astype(np.int64)  # (16, 25)
    cvals = clip_values(bit_depth)
    sets = np.zeros((NUM_FIXED_FILTER_SETS, MAX_NUM_ALF_CLASSES, 13), dtype=np.int64)
    for s in range(NUM_FIXED_FILTER_SETS):
        for cls in range(MAX_NUM_ALF_CLASSES):
            sets[s, cls] = fixed[mapping[s, cls]]
    clip_default = np.full((MAX_NUM_ALF_CLASSES, 13), cvals[0], dtype=np.int64)
    return sets, clip_default


def classify_block(luma_pad: np.ndarray, x0: int, y0: int, w: int, h: int,
                   bit_depth: int, vb_ctu_height: int, vb_pos: int):
    """deriveClassificationBlk → (class_idx, transpose_idx) per 4x4 block.

    luma_pad is the picture luma padded by PAD with edge replication;
    (x0, y0) are picture coords of the block (blkDst == blk here).
    """
    shift = bit_depth + 4

    def S(y, x):
        return int(luma_pad[y + PAD, x + PAD])

    hgt = h + 4
    wdt = w + 4
    lap = np.zeros((4, hgt, wdt), dtype=np.int64)  # VER, HOR, D0, D1
    for i in range(0, hgt, 2):
        y = y0 + i - 2  # row of pY
        # VB-adjusted source rows
        yd, yu, yu2 = y - 1, y + 1, y + 2
        dst_y = y0 - 2 + i
        if dst_y > 0 and (dst_y & (vb_ctu_height - 1)) == vb_pos - 2:
            yu2 = yu
        elif dst_y > 0 and (dst_y & (vb_ctu_height - 1)) == vb_pos:
            yd = y
        for j in range(0, wdt, 2):
            x = x0 + j - 2
            y0v = S(y, x) * 2
            yup1 = S(yu, x + 1) * 2
            lap[0, i, j] = abs(y0v - S(yd, x) - S(yu, x)) + abs(yup1 - S(y, x + 1) - S(yu2, x + 1))
            lap[1, i, j] = abs(y0v - S(y, x + 1) - S(y, x - 1)) + abs(yup1 - S(yu, x + 2) - S(yu, x))
            lap[2, i, j] = abs(y0v - S(yd, x - 1) - S(yu, x + 1)) + abs(yup1 - S(y, x) - S(yu2, x + 2))
            lap[3, i, j] = abs(y0v - S(yu, x - 1) - S(yd, x + 1)) + abs(yup1 - S(yu2, x) - S(y, x + 2))
            if j > 4 and (j - 6) % 4 == 0:
                for d in range(4):
                    lap[d, i, j - 6] += lap[d, i, j - 4] + lap[d, i, j - 2] + lap[d, i, j]
    classes = np.zeros((h // 4, w // 4), dtype=np.int32)
    transposes = np.zeros_like(classes)
    for i in range(0, h, 4):
        for j in range(0, w, 4):
            yv = (i + y0) % vb_ctu_height
            if yv == vb_pos - 4:
                rows = (i, i + 2, i + 4)
            elif yv == vb_pos:
                rows = (i + 2, i + 4, i + 6)
            else:
                rows = (i, i + 2, i + 4, i + 6)
            sum_v = sum(int(lap[0, r, j]) for r in rows)
            sum_h = sum(int(lap[1, r, j]) for r in rows)
            sum_d0 = sum(int(lap[2, r, j]) for r in rows)
            sum_d1 = sum(int(lap[3, r, j]) for r in rows)
            temp_act = sum_v + sum_h
            yb = (i + y0) & (vb_ctu_height - 1)
            mult = 96 if (yb == vb_pos - 4 or yb == vb_pos) else 64
            activity = _clip3(0, 15, (temp_act * mult) >> shift)
            class_idx = ACT_TH[activity]
            if sum_v > sum_h:
                hv1, hv0, dir_hv = sum_v, sum_h, 1
            else:
                hv1, hv0, dir_hv = sum_h, sum_v, 3
            if sum_d0 > sum_d1:
                d1, d0, dir_d = sum_d0, sum_d1, 0
            else:
                d1, d0, dir_d = sum_d1, sum_d0, 2
            if d1 * hv0 > hv1 * d0:
                hvd1, hvd0 = d1, d0
                main_dir, sec_dir = dir_d, dir_hv
            else:
                hvd1, hvd0 = hv1, hv0
                main_dir, sec_dir = dir_hv, dir_d
            strength = 0
            if hvd1 > 2 * hvd0:
                strength = 1
            if hvd1 * 2 > 9 * hvd0:
                strength = 2
            if strength:
                class_idx += (((main_dir & 1) << 1) + strength) * 5
            transposes[i // 4, j // 4] = TRANSPOSE_TABLE[main_dir * 2 + (sec_dir >> 1)]
            classes[i // 4, j // 4] = class_idx
    return classes, transposes


_TR7 = {
    0: [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
    1: [9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6, 12],
    2: [0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11, 12],
    3: [9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6, 12],
}
_TR5 = {
    0: [0, 1, 2, 3, 4, 5, 6],
    1: [4, 1, 5, 3, 0, 2, 6],
    2: [0, 3, 2, 1, 4, 5, 6],
    3: [4, 3, 5, 1, 0, 2, 6],
}


def filter_block(src_pad, dst, x0, y0, w, h, is_luma, classes, transposes,
                 coeff_sets, clip_sets, bit_depth, vb_ctu_height, vb_pos):
    """filterBlk (7x7 luma / 5x5 chroma diamond with clipping + VB).

    src_pad: padded pre-ALF plane; dst: output plane (picture coords);
    classes/transposes indexed per 4x4 of this block (luma only).
    """
    shift = NUM_BITS - 1
    offset = 1 << (shift - 1)
    maxv = (1 << bit_depth) - 1

    # per-pixel coefficient/clip planes: expand the per-4x4 (luma) or
    # single (chroma) permuted filters to (n_taps, w) per 4-row strip
    n_taps = 12 if is_luma else 6
    if is_luma:
        nby, nbx = (h + 3) // 4, (w + 3) // 4
        coef_blk = np.empty((nby, nbx, n_taps), dtype=np.int64)
        clip_blk = np.empty((nby, nbx, n_taps), dtype=np.int64)
        for bi in range(nby):
            for bj in range(nbx):
                perm = _TR7[int(transposes[bi, bj])][:n_taps]
                cs = coeff_sets[int(classes[bi, bj])]
                ls = clip_sets[int(classes[bi, bj])]
                coef_blk[bi, bj] = [int(cs[k]) for k in perm]
                clip_blk[bi, bj] = [int(ls[k]) for k in perm]
        # taps: (row_off_pair, dx) per tap index
        taps = [(5, 0), (3, 1), (3, 0), (3, -1), (1, 2), (1, 1), (1, 0),
                (1, -1), (1, -2), (0, 3), (0, 2), (0, 1)]
    else:
        coef_1d = np.array([int(coeff_sets[k]) for k in _TR5[0][:n_taps]],
                           dtype=np.int64)
        clip_1d = np.array([int(clip_sets[k]) for k in _TR5[0][:n_taps]],
                           dtype=np.int64)
        taps = [(3, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1)]

    src = src_pad.astype(np.int64)
    rng = 2 if not is_luma else 4
    for iy in range(h):
        y = y0 + iy
        yvb = y & (vb_ctu_height - 1)
        o1, o2, o3, o4, o5, o6 = 1, -1, 2, -2, 3, -3
        if yvb < vb_pos and yvb >= vb_pos - rng:  # above VB
            if yvb == vb_pos - 1:
                o1 = o2 = 0
            if yvb >= vb_pos - 2:
                o3, o4 = o1, o2
            if yvb >= vb_pos - 3:
                o5, o6 = o3, o4
        elif vb_pos <= yvb <= vb_pos + (1 if not is_luma else 3):
            if yvb == vb_pos:
                o1 = o2 = 0
            if yvb <= vb_pos + 1:
                o3, o4 = o1, o2
            if yvb <= vb_pos + 2:
                o5, o6 = o3, o4
        near_vb = yvb in (vb_pos - 1, vb_pos)
        off_pairs = {0: (0, 0), 1: (o1, o2), 3: (o3, o4), 5: (o5, o6)}
        py = y + PAD
        px = x0 + PAD
        curr = src[py, px : px + w]
        if is_luma:
            coef_px = np.repeat(coef_blk[iy // 4], 4, axis=0)[:w]  # (w, taps)
            clip_px = np.repeat(clip_blk[iy // 4], 4, axis=0)[:w]
        acc = np.zeros(w, dtype=np.int64)
        for k, (op, dx) in enumerate(taps):
            oa, ob = off_pairs[op]
            a = src[py + oa, px + dx : px + dx + w]
            b = src[py + ob, px - dx : px - dx + w]
            if is_luma:
                cl = clip_px[:, k]
                co = coef_px[:, k]
            else:
                cl = clip_1d[k]
                co = coef_1d[k]
            d = np.clip(a - curr, -cl, cl) + np.clip(b - curr, -cl, cl)
            acc += co * d
        if near_vb:
            acc = (acc + (1 << (shift + 3 - 1))) >> (shift + 3)
        else:
            acc = (acc + offset) >> shift
        dst[y, x0 : x0 + w] = np.clip(curr + acc, 0, maxv)


def filter_block_ccalf(luma_pad, dst, x0c, y0c, wc, hc, scale_x, scale_y,
                       coeffs, bit_depth, vb_ctu_height, vb_pos):
    """filterBlkCcAlf: chroma block coords; luma from padded pre-ALF luma."""
    maxv = (1 << bit_depth) - 1
    half = (1 << bit_depth) >> 1

    def L(y, x):
        return int(luma_pad[y + PAD, x + PAD])

    for i in range(hc):
        yc = y0c + i
        yl = yc << scale_y
        pos = (yc << scale_y) & (vb_ctu_height - 1)
        if scale_y == 0 and (pos == vb_pos or pos == vb_pos + 1):
            continue
        o1, o2, o3 = 1, -1, 2
        if pos == vb_pos - 2 or pos == vb_pos + 1:
            o3 = o1
        elif pos == vb_pos - 1 or pos == vb_pos:
            o1 = o2 = o3 = 0
        for jx in range(wc):
            xc = x0c + jx
            xl = xc << scale_x
            curr = L(yl, xl)
            s = 0
            s += coeffs[0] * (L(yl + o2, xl) - curr)
            s += coeffs[1] * (L(yl, xl - 1) - curr)
            s += coeffs[2] * (L(yl, xl + 1) - curr)
            s += coeffs[3] * (L(yl + o1, xl - 1) - curr)
            s += coeffs[4] * (L(yl + o1, xl) - curr)
            s += coeffs[5] * (L(yl + o1, xl + 1) - curr)
            s += coeffs[6] * (L(yl + o3, xl) - curr)
            s = (s + ((1 << SCALE_BITS_CC) >> 1)) >> SCALE_BITS_CC
            # ClipPel(sum + offset) - offset (AdaptiveLoopFilter.cpp:1399)
            s = _clip3(0, maxv, s + half) - half
            v = s + int(dst[yc, xc])
            dst[yc, xc] = _clip3(0, maxv, v)


def alf_picture(dcs, pic) -> None:
    """ALFProcess over the picture — vectorized whole-plane path.

    Per-CTU filter selections (fixed/APS set index, transposes, chroma
    alternatives, CC-ALF idc) are folded into per-4x4 coefficient/clip maps
    on host; the sample work runs in ops/alf_kernel.py as dense integer
    kernels (classification + clipped diamond filtering + CC-ALF).
    """
    import jax.numpy as jnp

    from vtm_jax.ops import alf_kernel as K

    t = build_alf_tables(dcs, pic)
    if t is None:
        return
    n_comp = t["n_comp"]
    j = jnp.asarray
    src_pad0 = np.pad(pic.planes[0], K.PAD, mode="edge").astype(np.int32)
    pcb = pic.planes[1].astype(np.int32) if n_comp > 1 else src_pad0
    pcr = pic.planes[2].astype(np.int32) if n_comp > 2 else src_pad0
    oy, ocb, ocr = K.alf_all(
        j(src_pad0), j(pcb), j(pcr), *[j(a) for a in t["args"]],
        bit_depth=t["bit_depth"], sx=t["sx"], sy=t["sy"],
        has_l=t["has_l"], has_cb=t["has_cb"], has_cr=t["has_cr"],
        has_cc1=t["has_cc1"], has_cc2=t["has_cc2"])
    if t["has_l"]:
        pic.planes[0][:] = np.asarray(oy).astype(pic.planes[0].dtype)
    if t["has_cb"] or t["has_cc1"]:
        pic.planes[1][:] = np.asarray(ocb).astype(pic.planes[1].dtype)
    if t["has_cr"] or t["has_cc2"]:
        pic.planes[2][:] = np.asarray(ocr).astype(pic.planes[2].dtype)


def build_alf_tables(dcs, pic):
    """Host-side ALF table assembly (sample-independent): returns the
    alf_all kernel argument tuple + flags, or None if ALF is fully off."""
    from vtm_jax.ops import alf_kernel as K

    sps = dcs.sps
    bit_depth = sps.bit_depth
    fmt = dcs.chroma_format
    ctu = sps.ctu_size
    vb_luma_pos = ctu - 4
    vb_chroma_ctu = ctu >> (1 if fmt.value == 1 else 0)
    vb_chroma_pos = vb_chroma_ctu - 2
    # pre-ALF padded source planes
    fixed_sets, clip_default = fixed_filter_sets(bit_depth)
    aps_luma_cache = {}
    chroma_cache = {}
    n_comp = fmt.num_components
    w_ctu = dcs.pic_w_ctu
    n_ctu = w_ctu * dcs.pic_h_ctu
    h, w = dcs.pic_h, dcs.pic_w
    sxc, syc = fmt.scale_x, fmt.scale_y
    hc, wc = h >> syc, w >> sxc

    # ---- per-CTU filter tables (zeros = identity) ----
    any_luma = False
    ctb_coeff = np.zeros((n_ctu, MAX_NUM_ALF_CLASSES, 13), dtype=np.int32)
    ctb_clip = np.zeros_like(ctb_coeff)
    chroma_coeff = np.zeros((n_comp, n_ctu, 7), dtype=np.int32)
    chroma_clip = np.zeros_like(chroma_coeff)
    cc_coeff = np.zeros((n_comp, n_ctu, 7), dtype=np.int32)
    any_chroma = [False] * n_comp
    any_cc = [False] * n_comp
    for addr in range(n_ctu):
        sl_idx = int(dcs.slice_idx_of_ctu[addr])
        sh = dcs._slice_headers[sl_idx]
        if pic.alf_ctb_flag[0][addr] and sh.alf_enabled[0]:
            any_luma = True
            fset = int(pic.alf_ctb_filter_index[addr])
            if fset >= NUM_FIXED_FILTER_SETS:
                aps_id = sh.alf_aps_ids[fset - NUM_FIXED_FILTER_SETS]
                if aps_id not in aps_luma_cache:
                    aps = dcs.aps_map[(0, aps_id)]
                    aps_luma_cache[aps_id] = reconstruct_luma_coeffs(aps.alf, bit_depth)
                coeffs, clips = aps_luma_cache[aps_id]
            else:
                coeffs, clips = fixed_sets[fset], clip_default
            ctb_coeff[addr] = coeffs
            ctb_clip[addr] = clips
        for comp in (1, 2):
            if comp >= n_comp:
                continue
            if pic.alf_ctb_flag[comp][addr] and sh.alf_enabled[comp]:
                aps_id = sh.alf_aps_id_chroma
                alt = int(pic.alf_ctb_alt[comp][addr])
                key = (aps_id, alt)
                if key not in chroma_cache:
                    aps = dcs.aps_map[(0, aps_id)]
                    chroma_cache[key] = reconstruct_chroma_coeffs(aps.alf, alt, bit_depth)
                ccoef, cclip = chroma_cache[key]
                chroma_coeff[comp][addr] = ccoef
                chroma_clip[comp][addr] = cclip
                any_chroma[comp] = True
            cc_enabled = sh.ccalf_cb_enabled if comp == 1 else sh.ccalf_cr_enabled
            if cc_enabled:
                idc = int(pic.ccalf_control[comp - 1][addr])
                if idc:
                    aps_id = sh.ccalf_cb_aps_id if comp == 1 else sh.ccalf_cr_aps_id
                    aps = dcs.aps_map[(0, aps_id)]
                    # APS rows carry CCALF_NUM_COEFF(8) slots; 7 signalled
                    cc_coeff[comp][addr] = \
                        aps.alf.ccalf_coeff[comp - 1][idc - 1][:7]
                    any_cc[comp] = True

    # ---- host-side tables for the fused dispatch ----
    perm = np.array([_TR7[t][:12] for t in range(4)], dtype=np.int32)
    cperm = (ctb_coeff[:, :, perm] if any_luma
             else np.zeros((1, 1, 4, 12), dtype=np.int32))
    lperm = (ctb_clip[:, :, perm] if any_luma
             else np.zeros((1, 1, 4, 12), dtype=np.int32))
    h4, w4 = h // 4, w // 4
    by, bx = np.mgrid[0:h4, 0:w4]
    ctu_of = ((by * 4 // ctu) * w_ctu + (bx * 4 // ctu)).astype(np.int32)
    l_orows, l_near = K.vb_row_offsets(h, ctu, vb_luma_pos, True)
    y_i, yd_i, yu_i, yu2_i = K.classify_row_indices(h, ctu, vb_luma_pos)
    drop_f, drop_l, mult = K.classify_block_rows(h, ctu, vb_luma_pos)
    cap = getattr(pic, "filter_capture", None)
    if cap is not None and any_luma:
        cap["alf"] = dict(
            cperm=cperm.astype(np.int32), lperm=lperm.astype(np.int32),
            ctu_of=ctu_of, o_rows=l_orows, near=l_near,
            cls_rows=(y_i, yd_i, yu_i, yu2_i),
            cls_blocks=(drop_f, drop_l, mult))

    perm5 = np.array(_TR5[0][:6], dtype=np.int32)
    hc4, wc4 = max(hc // 4, 1), max(wc // 4, 1)
    cby, cbx = np.mgrid[0:hc4, 0:wc4]
    ctu_of_c = ((cby * 4) << syc) // ctu * w_ctu + ((cbx * 4) << sxc) // ctu
    c_orows, c_near = K.vb_row_offsets(max(hc, 1), vb_chroma_ctu,
                                       vb_chroma_pos, False)
    cc_orows, cc_skip = K.ccalf_row_offsets(max(hc, 1), syc, ctu, vb_luma_pos)
    zero6 = np.zeros((hc4, wc4, 6), dtype=np.int32)
    zero7 = np.zeros((hc4, wc4, 7), dtype=np.int32)

    def cmaps(comp):
        if comp >= n_comp or not any_chroma[comp]:
            return zero6, zero6
        return (chroma_coeff[comp][:, perm5][ctu_of_c],
                chroma_clip[comp][:, perm5][ctu_of_c])

    cb_coef, cb_clip = cmaps(1)
    cr_coef, cr_clip = cmaps(2)
    cc1 = cc_coeff[1][ctu_of_c] if n_comp > 1 and any_cc[1] else zero7
    cc2 = cc_coeff[2][ctu_of_c] if n_comp > 2 and any_cc[2] else zero7

    has_cb = n_comp > 1 and any_chroma[1]
    has_cr = n_comp > 2 and any_chroma[2]
    has_cc1 = n_comp > 1 and any_cc[1]
    has_cc2 = n_comp > 2 and any_cc[2]
    if not (any_luma or has_cb or has_cr or has_cc1 or has_cc2):
        return None
    return dict(
        args=(cperm.astype(np.int32), lperm.astype(np.int32), ctu_of,
              l_orows, l_near, y_i, yd_i, yu_i, yu2_i, drop_f, drop_l, mult,
              cb_coef, cb_clip, cr_coef, cr_clip, c_orows, c_near,
              cc1, cc2, cc_orows, cc_skip),
        bit_depth=bit_depth, sx=sxc, sy=syc, n_comp=n_comp,
        has_l=any_luma, has_cb=has_cb, has_cr=has_cr,
        has_cc1=has_cc1, has_cc2=has_cc2)
