"""Intra prediction sample ops — exact integer reference implementations.

Behavioral contract from CommonLib/IntraPrediction.cpp: reference-sample
fill/pad (xFillReferenceSamples:~860), [1 2 1] reference smoothing
(xFilterReferenceSamples), planar (xPredIntraPlanar:294), DC (xGetPredValDc
:153), angular with wide-angle remap, 4-tap cubic(DCT-IF)/smoothing
interpolation and PDPC (xPredIntraAng:459, predIntraAng:217), and the MDIS
filter decisions (initPredIntraParams:356).

Reference layout here: `top[0]` is the top-left corner sample, `top[1..]`
the above row; `left[0]` the same corner, `left[1..]` the left column —
matching the reference's refBufUnfiltered rows at stride predStride.
"""

from __future__ import annotations

import numpy as np

from vtm_jax.common import rom

PLANAR_IDX, DC_IDX, HOR_IDX, VER_IDX, DIA_IDX, VDIA_IDX = 0, 1, 18, 50, 34, 66
NUM_LUMA_MODE = 67

ANG_TABLE = [0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32, 35,
             39, 45, 51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512, 1024]
INV_ANG_TABLE = [0, 16384, 8192, 5461, 4096, 2731, 2048, 1638, 1365, 1170,
                 1024, 910, 819, 712, 630, 565, 512, 468, 420, 364, 321, 287,
                 256, 224, 191, 161, 128, 96, 64, 48, 32, 16]
INTRA_FILTER_THRESH = [24, 24, 24, 14, 2, 0, 0, 0]  # m_aucIntraFilter per log2 size

_CHROMA_FILTER = rom.chroma_filter().astype(np.int64)  # (32, 4) DCT-IF


def floor_log2(x: int) -> int:
    return x.bit_length() - 1


def modified_wide_angle(width: int, height: int, pred_mode: int) -> int:
    if DC_IDX < pred_mode <= VDIA_IDX:
        mode_shift = [0, 6, 10, 12, 14, 15]
        delta = abs(floor_log2(width) - floor_log2(height))
        if width > height and pred_mode < 2 + mode_shift[delta]:
            pred_mode += VDIA_IDX - 1
        elif height > width and pred_mode > VDIA_IDX - mode_shift[delta]:
            pred_mode -= VDIA_IDX - 1
    return pred_mode


class IntraParams:
    """m_ipaParam equivalent (initPredIntraParams)."""

    def __init__(self, dir_mode: int, pu_w: int, pu_h: int, cu_w: int, cu_h: int,
                 is_luma: bool, multi_ref_idx: int, use_isp: bool, bdpcm: bool):
        blk_w, blk_h = (cu_w, cu_h) if use_isp and is_luma else (pu_w, pu_h)
        pred_mode = modified_wide_angle(blk_w, blk_h, dir_mode)
        self.pred_mode = pred_mode
        self.is_mode_ver = pred_mode >= DIA_IDX
        self.multi_ref_idx = multi_ref_idx if is_luma else 0
        self.ref_filter_flag = False
        self.interpolation_flag = False
        self.apply_pdpc = (pu_w >= 4 and pu_h >= 4) and self.multi_ref_idx == 0
        self.intra_pred_angle = 0
        self.inv_angle = 0
        self.angular_scale = 0
        angle_mode = (pred_mode - VER_IDX) if self.is_mode_ver else -(pred_mode - HOR_IDX)
        abs_ang = 0
        if DC_IDX < dir_mode < NUM_LUMA_MODE:
            abs_mode = abs(angle_mode)
            sign = -1 if angle_mode < 0 else 1
            abs_ang = ANG_TABLE[abs_mode]
            self.inv_angle = INV_ANG_TABLE[abs_mode]
            self.intra_pred_angle = sign * abs_ang
            if angle_mode < 0:
                self.apply_pdpc = False
            elif angle_mode > 0:
                side = pu_h if self.is_mode_ver else pu_w
                self.angular_scale = min(
                    2, floor_log2(side) - (floor_log2(3 * self.inv_angle - 2) - 8)
                )
                self.apply_pdpc = self.apply_pdpc and self.angular_scale >= 0
        # MDIS / reference filter decision
        if (not is_luma) or use_isp or self.multi_ref_idx or dir_mode == DC_IDX:
            pass
        elif bdpcm:
            self.ref_filter_flag = False
        elif dir_mode == PLANAR_IDX:
            self.ref_filter_flag = pu_w * pu_h > 32
        else:
            diff = min(abs(pred_mode - HOR_IDX), abs(pred_mode - VER_IDX))
            log2_size = (floor_log2(pu_w) + floor_log2(pu_h)) >> 1
            if diff > INTRA_FILTER_THRESH[log2_size]:
                is_integer = abs_ang in (0, 32, 64, 512, 1024) or (abs_ang & 31) == 0
                # isIntegerSlope: (absAng & 0x1F) == 0
                is_integer = (abs_ang & 0x1F) == 0
                self.ref_filter_flag = is_integer
                self.interpolation_flag = not is_integer


def filter_reference_samples(top: np.ndarray, left: np.ndarray,
                             pred_size: int, pred_hsize: int, mrl: int):
    """[1 2 1]/4 smoothing (xFilterReferenceSamples). Arrays modified copy."""
    ps = pred_size + mrl
    phs = pred_hsize + mrl
    ft = top.copy()
    fl = left.copy()
    top_left = (int(top[0]) + int(top[1]) + int(left[0]) + int(left[1]) + 2) >> 2
    ft[0] = top_left
    t = top.astype(np.int64)
    ft[1:ps] = (t[:ps - 1] + 2 * t[1:ps] + t[2:ps + 1] + 2) >> 2
    ft[ps] = top[ps]
    fl[0] = top_left
    le = left.astype(np.int64)
    fl[1:phs] = (le[:phs - 1] + 2 * le[1:phs] + le[2:phs + 1] + 2) >> 2
    fl[phs] = left[phs]
    return ft, fl


def pred_planar(top: np.ndarray, left: np.ndarray, w: int, h: int) -> np.ndarray:
    log2w, log2h = floor_log2(w), floor_log2(h)
    top_row = top[1 : w + 2].astype(np.int64)  # w+1 entries
    left_col = left[1 : h + 2].astype(np.int64)
    bottom_left = left_col[h]
    top_right = top_row[w]
    t = top_row[:w]
    l = left_col[:h]
    bottom_row = bottom_left - t  # (w,)
    right_col = top_right - l  # (h,)
    top_scaled = t << log2h
    left_scaled = l << log2w
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    hor = left_scaled[:, None] + (x + 1) * right_col[:, None]
    ver = top_scaled[None, :] + (y + 1) * bottom_row[None, :]
    offset = 1 << (log2w + log2h)
    final_shift = 1 + log2w + log2h
    return ((hor << log2h) + (ver << log2w) + offset) >> final_shift


def pred_dc(top: np.ndarray, left: np.ndarray, w: int, h: int, mrl: int) -> int:
    denom = (w << 1) if w == h else max(w, h)
    shift = floor_log2(denom)
    off = denom >> 1
    s = 0
    if w >= h:
        s += int(np.sum(top[mrl + 1 : mrl + 1 + w].astype(np.int64)))
    if w <= h:
        s += int(np.sum(left[mrl + 1 : mrl + 1 + h].astype(np.int64)))
    return (s + off) >> shift


def pred_angular(
    top: np.ndarray,
    left: np.ndarray,
    w: int,
    h: int,
    p: IntraParams,
    is_luma: bool,
    bit_depth: int,
    top_ref_len: int | None = None,
    left_ref_len: int | None = None,
) -> np.ndarray:
    """xPredIntraAng — returns (h, w) int array (no PDPC; applied by caller
    for angular modes inside, matching reference placement).

    top_ref_len/left_ref_len default to 2w/2h; ISP passes cuW+tbW / cuH+tbH.
    """
    mrl = p.multi_ref_idx
    angle = p.intra_pred_angle
    inv_angle = p.inv_angle
    is_ver = p.is_mode_ver
    # build refMain / refSide as python lists indexed from negative offsets
    # use dict-free approach: offset arrays
    if angle < 0:
        # refAbove[x + height] = top[x] for x in 0..w+1+mrl
        ref_above = np.zeros(1400, dtype=np.int64)
        ref_left = np.zeros_like(ref_above)
        nt = w + 2 + mrl
        nl = h + 2 + mrl
        ref_above[h : h + nt] = top[:nt]
        ref_left[w : w + nl] = left[:nl]
        if is_ver:
            ref_main_base = h
            ref_main = ref_above
            ref_side = ref_left
            side_off = w
        else:
            ref_main_base = w
            ref_main = ref_left
            ref_side = ref_above
            side_off = h
        size_side = h if is_ver else w
        ks = np.arange(-size_side, 0, dtype=np.int64)
        sidx = np.minimum((-ks * inv_angle + 256) >> 9, size_side)
        ref_main[ref_main_base - size_side : ref_main_base] = \
            ref_side[side_off + sidx]
    else:
        if top_ref_len is None:
            top_ref_len = w * 2
        if left_ref_len is None:
            left_ref_len = h * 2
        ref_above = np.zeros(1400, dtype=np.int64)
        ref_left = np.zeros_like(ref_above)
        ref_above[: top_ref_len + mrl + 1] = top[: top_ref_len + mrl + 1]
        ref_left[: left_ref_len + mrl + 1] = left[: left_ref_len + mrl + 1]
        ref_main = ref_above if is_ver else ref_left
        ref_side = ref_left if is_ver else ref_above
        ref_main_base = 0
        log2_ratio = floor_log2(w) - floor_log2(h)
        s = max(0, log2_ratio if is_ver else -log2_ratio)
        max_index = (mrl << s) + 2
        ref_length = top_ref_len if is_ver else left_ref_len
        ref_main[ref_length + mrl + 1 : ref_length + mrl + max_index + 1] = \
            ref_main[ref_length + mrl]
    # swap w/h for horizontal modes
    dw, dh = (w, h) if is_ver else (h, w)
    rm = ref_main_base + mrl  # compensate line offset
    rs_base = (w if angle < 0 and is_ver else (h if angle < 0 else 0)) + mrl
    ref_side_arr = ref_side
    maxv = (1 << bit_depth) - 1
    xr = np.arange(dw, dtype=np.int64)
    yr = np.arange(dh, dtype=np.int64)
    if angle == 0:
        dst = np.broadcast_to(ref_main[rm + 1 : rm + 1 + dw],
                              (dh, dw)).copy()
        if p.apply_pdpc:
            scale = (floor_log2(dw) + floor_log2(dh) - 2) >> 2
            top_left_s = ref_main[rm]
            nx = min(3 << scale, dw)
            wl = 32 >> ((2 * xr[:nx]) >> scale)
            left_s = ref_side_arr[rs_base + 1 + yr][:, None]
            val = dst[:, :nx] + ((wl[None, :] * (left_s - top_left_s) + 32) >> 6)
            dst[:, :nx] = np.clip(val, 0, maxv)
    else:
        delta_pos = angle * (1 + mrl) + yr * angle
        delta_int = delta_pos >> 5
        delta_fract = delta_pos & 31
        abs_ang_int = (abs(angle) & 0x1F) == 0
        if not abs_ang_int:
            if is_luma:
                if not p.interpolation_flag:  # cubic (DCT-IF)
                    f = _CHROMA_FILTER[delta_fract]  # (dh, 4)
                else:
                    hf = delta_fract >> 1
                    f = np.stack([16 - hf, 32 - hf, 16 + hf, hf], axis=1)
                idx = (rm + delta_int)[:, None] + xr[None, :]
                val = (f[:, 0, None] * ref_main[idx]
                       + f[:, 1, None] * ref_main[idx + 1]
                       + f[:, 2, None] * ref_main[idx + 2]
                       + f[:, 3, None] * ref_main[idx + 3] + 32) >> 6
                dst = np.clip(val, 0, maxv)
            else:
                idx = (rm + delta_int + 1)[:, None] + xr[None, :]
                p0 = ref_main[idx]
                p1 = ref_main[idx + 1]
                dst = p0 + ((delta_fract[:, None] * (p1 - p0) + 16) >> 5)
        else:
            idx = (rm + delta_int + 1)[:, None] + xr[None, :]
            dst = ref_main[idx].copy()
        if p.apply_pdpc:
            scale = p.angular_scale
            nx = min(3 << scale, dw)
            inv_sum = 256 + (xr[:nx] + 1) * inv_angle
            wl = 32 >> ((2 * xr[:nx]) >> scale)
            sidx = rs_base + yr[:, None] + (inv_sum >> 9)[None, :] + 1
            left_s = ref_side_arr[sidx]
            d = dst[:, :nx]
            dst[:, :nx] = d + ((wl[None, :] * (left_s - d) + 32) >> 6)
    if not is_ver:
        dst = dst.T
    return dst


def angular_sad_batch(top, left, ftop, fleft, w: int, h: int, modes,
                      src: np.ndarray, bit_depth: int) -> dict:
    """SAD(src, pred) for a set of angular luma modes (2..66), mrl=0, no
    ISP/BDPCM — the encoder's RMD preselection sweep as ONE batched gather
    + 4-tap interpolation over all modes (vs one pred_angular call per
    mode).  Bit-exact with pred_angular(+PDPC): verified by
    tests/test_mip_mrl_encode.py::test_angular_sad_batch_exact.

    Returns {mode: float sad}.
    """
    maxv = (1 << bit_depth) - 1
    out: dict = {}
    # per-mode metadata + ref_main/ref_side construction (cheap 1D ops);
    # the (h, w) interpolation below is batched across modes
    groups: dict = {}  # is_ver -> list of per-mode records
    for m in modes:
        p = IntraParams(m, w, h, w, h, True, 0, False, False)
        angle, inv_angle, is_ver = p.intra_pred_angle, p.inv_angle, p.is_mode_ver
        if angle == 0:  # exact hor/ver: rare (2 modes) — scalar fallback
            use_t, use_l = (ftop, fleft) if p.ref_filter_flag else (top, left)
            pred = pred_angular(use_t, use_l, w, h, p, True, bit_depth)
            out[m] = float(np.abs(src - pred).sum())
            continue
        use_t, use_l = (ftop, fleft) if p.ref_filter_flag else (top, left)
        ref_above = np.zeros(1400, dtype=np.int64)
        ref_left = np.zeros_like(ref_above)
        if angle < 0:
            nt, nl = w + 2, h + 2
            ref_above[h : h + nt] = use_t[:nt]
            ref_left[w : w + nl] = use_l[:nl]
            if is_ver:
                ref_main, ref_side = ref_above, ref_left
                ref_main_base, side_off = h, w
            else:
                ref_main, ref_side = ref_left, ref_above
                ref_main_base, side_off = w, h
            size_side = h if is_ver else w
            ks = np.arange(-size_side, 0, dtype=np.int64)
            sidx = np.minimum((-ks * inv_angle + 256) >> 9, size_side)
            ref_main[ref_main_base - size_side : ref_main_base] = \
                ref_side[side_off + sidx]
            rs_base = side_off
        else:
            trl, lrl = w * 2, h * 2
            ref_above[: trl + 1] = use_t[: trl + 1]
            ref_left[: lrl + 1] = use_l[: lrl + 1]
            ref_main = ref_above if is_ver else ref_left
            ref_side = ref_left if is_ver else ref_above
            ref_main_base = 0
            # max_index = (mrl << s) + 2 with mrl fixed at 0 here
            max_index = 2
            ref_length = trl if is_ver else lrl
            ref_main[ref_length + 1 : ref_length + max_index + 1] = \
                ref_main[ref_length]
            rs_base = 0
        groups.setdefault(is_ver, []).append(
            (m, p, angle, inv_angle, ref_main, ref_side,
             ref_main_base, rs_base))
    for is_ver, recs in groups.items():
        dw, dh = (w, h) if is_ver else (h, w)
        M = len(recs)
        xr = np.arange(dw, dtype=np.int64)
        yr = np.arange(dh, dtype=np.int64)
        rmains = np.stack([r[4] for r in recs])              # (M, L)
        angles = np.array([r[2] for r in recs], dtype=np.int64)
        rms = np.array([r[6] for r in recs], dtype=np.int64)  # ref_main_base
        delta_pos = angles[:, None] * (1 + yr[None, :])       # (M, dh)
        delta_int = delta_pos >> 5
        delta_fract = delta_pos & 31
        # filter bank per mode/row: cubic DCT-IF, smoothing, or integer tap
        f = np.empty((M, dh, 4), dtype=np.int64)
        for i, (m, p, angle, *_rest) in enumerate(recs):
            if (abs(angle) & 0x1F) == 0:
                f[i] = np.array([64, 0, 0, 0], dtype=np.int64)
                delta_int[i] += 1  # integer path reads ref[rm+di+1+x]
                delta_fract[i] = 0
            elif not p.interpolation_flag:
                f[i] = _CHROMA_FILTER[delta_fract[i]]
            else:
                hf = delta_fract[i] >> 1
                f[i] = np.stack([16 - hf, 32 - hf, 16 + hf, hf], axis=1)
        # flat gather: row m of rmains starts at m*L in the raveled buffer
        L = rmains.shape[1]
        flat = rmains.ravel()
        idx = (rms[:, None] + delta_int
               + (np.arange(M, dtype=np.int64) * L)[:, None])[:, :, None] \
            + xr[None, None, :]
        g = flat[idx]
        g1 = flat[idx + 1]
        g2 = flat[idx + 2]
        g3 = flat[idx + 3]
        dst = (f[:, :, 0:1] * g + f[:, :, 1:2] * g1
               + f[:, :, 2:3] * g2 + f[:, :, 3:4] * g3 + 32) >> 6
        np.clip(dst, 0, maxv, out=dst)
        # integer-slope taps produce the raw sample (no clip needed, but
        # clip is a no-op there); PDPC tail per mode (small slices)
        cmp_src = src if is_ver else src.T
        for i, (m, p, angle, inv_angle, _rm, ref_side, _rb, rs_base) in \
                enumerate(recs):
            d = dst[i]
            if angle > 0 and p.apply_pdpc:
                scale = p.angular_scale
                nx = min(3 << scale, dw)
                inv_sum = 256 + (xr[:nx] + 1) * inv_angle
                wl = 32 >> ((2 * xr[:nx]) >> scale)
                sidx = rs_base + yr[:, None] + (inv_sum >> 9)[None, :] + 1
                left_s = ref_side[sidx]
                dd = d[:, :nx]
                d = d.copy()
                d[:, :nx] = dd + ((wl[None, :] * (left_s - dd) + 32) >> 6)
            out[m] = float(np.abs(cmp_src - d).sum())
    return out


def pdpc_planar_dc(pred: np.ndarray, top: np.ndarray, left: np.ndarray) -> np.ndarray:
    """PDPC for planar/DC (predIntraAng tail)."""
    h, w = pred.shape
    scale = (floor_log2(w) - 2 + floor_log2(h) - 2 + 2) >> 2
    out = pred.astype(np.int64).copy()
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    wt = 32 >> np.minimum(31, (y << 1) >> scale)
    wl = 32 >> np.minimum(31, (x << 1) >> scale)
    left_col = left[1 : h + 1].astype(np.int64)[:, None]
    top_row = top[1 : w + 1].astype(np.int64)[None, :]
    out = out + ((wl * (left_col - out) + wt * (top_row - out) + 32) >> 6)
    return out


def cclm_downsample_luma(
    luma: np.ndarray,
    lx: int,
    ly: int,
    cw: int,
    ch: int,
    scale_x: int,
    scale_y: int,
    above_avail: bool,
    left_avail: bool,
    first_row_of_ctu: bool,
    collocated: bool,
    added_above_right: int,
    added_left_below: int,
):
    """xGetLumaRecPixels (IntraPrediction.cpp): 6-tap / 5-tap / 3-tap luma
    downsampling for CCLM.  Returns (inner (ch,cw), top row, left col) in the
    CCLM temp-buffer layout (top[i] = pDst0[-stride + i], left[j] =
    pDst0[-1 + j*stride])."""
    H, W = luma.shape

    def rec(y, x):
        return int(luma[min(max(y, 0), H - 1), min(max(x, 0), W - 1)])

    inner = np.zeros((ch, cw), dtype=np.int64)
    top = np.zeros(cw + added_above_right, dtype=np.int64)
    left = np.zeros(ch + added_left_below, dtype=np.int64)
    if scale_x == 0 and scale_y == 0:  # 444
        for j in range(ch):
            for i in range(cw):
                inner[j, i] = rec(ly + j, lx + i)
        if above_avail:
            for i in range(len(top)):
                top[i] = rec(ly - 1, lx + i)
        if left_avail:
            for j in range(len(left)):
                left[j] = rec(ly + j, lx - 1)
        return inner, top, left
    is422 = scale_y == 0
    if above_avail:
        for i in range(len(top)):
            left_pad = i == 0 and not left_avail
            x2 = lx + 2 * i
            if first_row_of_ctu:
                top[i] = (rec(ly - 1, x2) * 2 + rec(ly - 1, x2 - (0 if left_pad else 1))
                          + rec(ly - 1, x2 + 1) + 2) >> 2
            elif is422:
                top[i] = (rec(ly - 2, x2) * 2 + rec(ly - 2, x2 - (0 if left_pad else 1))
                          + rec(ly - 2, x2 + 1) + 2) >> 2
            elif collocated:
                s = 4
                s += rec(ly - 3, x2)
                s += rec(ly - 2, x2) * 4
                s += rec(ly - 2, x2 - (0 if left_pad else 1))
                s += rec(ly - 2, x2 + 1)
                s += rec(ly - 1, x2)
                top[i] = s >> 3
            else:
                s = 4
                s += rec(ly - 2, x2) * 2
                s += rec(ly - 2, x2 + 1)
                s += rec(ly - 2, x2 - (0 if left_pad else 1))
                s += rec(ly - 1, x2) * 2
                s += rec(ly - 1, x2 + 1)
                s += rec(ly - 1, x2 - (0 if left_pad else 1))
                top[i] = s >> 3
    if left_avail:
        for j in range(len(left)):
            y2 = ly + (j << scale_y)
            xs = lx - 1 - scale_x
            if is422:
                left[j] = (rec(y2, xs) * 2 + rec(y2, xs - 1) + rec(y2, xs + 1) + 2) >> 2
            elif collocated:
                above_pad = j == 0 and not above_avail
                s = 4
                s += rec(y2 - (0 if above_pad else 1), xs)
                s += rec(y2, xs) * 4
                s += rec(y2, xs - 1)
                s += rec(y2, xs + 1)
                s += rec(y2 + 1, xs)
                left[j] = s >> 3
            else:
                s = 4
                s += rec(y2, xs) * 2
                s += rec(y2, xs + 1)
                s += rec(y2, xs - 1)
                s += rec(y2 + 1, xs) * 2
                s += rec(y2 + 1, xs + 1)
                s += rec(y2 + 1, xs - 1)
                left[j] = s >> 3
    for j in range(ch):
        for i in range(cw):
            left_pad = i == 0 and not left_avail
            x2 = lx + 2 * i
            y2 = ly + (j << scale_y)
            if is422:
                inner[j, i] = (rec(y2, x2) * 2 + rec(y2, x2 - (0 if left_pad else 1))
                               + rec(y2, x2 + 1) + 2) >> 2
            elif collocated:
                above_pad = j == 0 and not above_avail
                s = 4
                s += rec(y2 - (0 if above_pad else 1), x2)
                s += rec(y2, x2) * 4
                s += rec(y2, x2 - (0 if left_pad else 1))
                s += rec(y2, x2 + 1)
                s += rec(y2 + 1, x2)
                inner[j, i] = s >> 3
            else:
                s = 4
                s += rec(y2, x2) * 2
                s += rec(y2, x2 + 1)
                s += rec(y2, x2 - (0 if left_pad else 1))
                s += rec(y2 + 1, x2) * 2
                s += rec(y2 + 1, x2 + 1)
                s += rec(y2 + 1, x2 - (0 if left_pad else 1))
                inner[j, i] = s >> 3
    return inner, top, left


MIP_SHIFT_MATRIX = 6
MIP_OFFSET_MATRIX = 32


def mip_size_id(w: int, h: int) -> int:
    if w == 4 and h == 4:
        return 0
    if w == 4 or h == 4 or (w == 8 and h == 8):
        return 1
    return 2


def _mip_boundary_downsample(full: np.ndarray, dst_len: int) -> np.ndarray:
    src_len = len(full)
    if dst_len < src_len:
        factor = src_len // dst_len
        log2f = floor_log2(factor)
        off = 1 << (log2f - 1)
        return (full.reshape(dst_len, factor).sum(axis=1) + off) >> log2f
    return full[:dst_len].copy()


def _mip_upsample_1d(dst, src, bndry, src_size_up, src_size_orth, src_step,
                     src_stride, dst_step, dst_stride, bndry_step, factor):
    """predictionUpsampling1D on flat int arrays."""
    log2f = floor_log2(factor)
    off = 1 << (log2f - 1)
    src_line = 0
    dst_line = 0
    bndry_line = bndry_step - 1
    for _ in range(src_size_orth):
        before_arr, before_idx = bndry, bndry_line
        behind_idx = src_line
        cur = dst_line
        for _k in range(src_size_up):
            before_v = int(before_arr[before_idx])
            behind_v = int(src[behind_idx])
            scaled_before = before_v << log2f
            scaled_behind = 0
            for _pos in range(factor):
                scaled_before -= before_v
                scaled_behind += behind_v
                dst[cur] = (scaled_before + scaled_behind + off) >> log2f
                cur += dst_step
            before_arr, before_idx = src, behind_idx
            behind_idx += src_step
        bndry_line += bndry_step
        src_line += src_stride
        dst_line += dst_stride


def pred_mip(
    top_row: np.ndarray,  # refs top[1..w]
    left_col: np.ndarray,  # refs left[1..h]
    w: int,
    h: int,
    mode_idx: int,
    transpose: bool,
    bit_depth: int,
) -> np.ndarray:
    """Matrix intra prediction (MatrixIntraPrediction.cpp)."""
    size_id = mip_size_id(w, h)
    bdry_size = 2 if size_id == 0 else 4
    red_pred = 4 if size_id < 2 else 8
    up_h = w // red_pred
    up_v = h // red_pred
    top_red = _mip_boundary_downsample(top_row.astype(np.int64), bdry_size)
    left_red = _mip_boundary_downsample(left_col.astype(np.int64), bdry_size)
    input_size = 2 * bdry_size
    red = np.concatenate([top_red, left_red])
    red_t = np.concatenate([left_red, top_red])
    off0 = int(red[0])
    off0_t = int(red_t[0])
    has_first = size_id < 2
    red = red.copy()
    red_t = red_t.copy()
    red[1:] -= off0
    red_t[1:] -= off0_t
    red[0] = ((1 << (bit_depth - 1)) - off0) if has_first else 0
    red_t[0] = ((1 << (bit_depth - 1)) - off0_t) if has_first else 0
    inp = red_t if transpose else red
    input_offset = off0_t if transpose else off0
    matrix = rom.mip_matrix(size_id)[mode_idx].astype(np.int64)  # (redN^2, taps)
    s = int(np.sum(inp))
    offset = (1 << (MIP_SHIFT_MATRIX - 1)) - MIP_OFFSET_MATRIX * s
    red_size = size_id == 2
    res = np.zeros(red_pred * red_pred, dtype=np.int64)
    wflat = matrix.ravel()
    wpos = 0
    maxv = (1 << bit_depth) - 1
    for pos in range(red_pred * red_pred):
        if red_size:
            wpos -= 1
        acc = 0 if red_size else int(inp[0]) * int(wflat[wpos])
        for i in range(1, input_size):
            acc += int(inp[i]) * int(wflat[wpos + i])
        res[pos] = max(0, min(maxv, ((acc + offset) >> MIP_SHIFT_MATRIX) + input_offset))
        wpos += input_size
    if transpose:
        res = res.reshape(red_pred, red_pred).T.ravel().copy()
    if up_h > 1 or up_v > 1:
        dst = np.zeros(w * h, dtype=np.int64)
        ver_src = res
        ver_src_step = w
        ver_src_off = 0
        if up_h > 1:
            hor_off = (up_v - 1) * w
            ver_src_step = w * up_v
            _mip_upsample_1d(
                dst[hor_off:], res, left_col.astype(np.int64),
                red_pred, red_pred, 1, red_pred, 1, ver_src_step, up_v, up_h
            )
            ver_src = dst[hor_off:]
        if up_v > 1:
            _mip_upsample_1d(
                dst, ver_src, top_row.astype(np.int64),
                red_pred, w, ver_src_step if up_h > 1 else w, 1, w, 1, 1, up_v
            )
        return dst.reshape(h, w)
    return res.reshape(h, w)


DIV_SIG_TABLE = [0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0]


def cclm_parameters(
    mode: str,  # 'lm', 'mdlm_l', 'mdlm_t'
    cw: int,
    ch: int,
    luma_top: np.ndarray,
    luma_left: np.ndarray,
    chroma_top: np.ndarray,  # unfiltered chroma refs: top[1..], left[1..]
    chroma_left: np.ndarray,
    above_avail: bool,
    left_avail: bool,
    avai_above_right_units: int,
    avai_left_below_units: int,
    unit_w: int,
    unit_h: int,
    bit_depth: int,
):
    """xGetLMParameters — returns (a, b, shift)."""
    if mode == "mdlm_t":
        left_avail = False
        aru = min(avai_above_right_units, ch // unit_w)
        actual_top = unit_w * (cw // unit_w + aru) if above_avail else 0
        actual_left = 0
    elif mode == "mdlm_l":
        above_avail = False
        lbu = min(avai_left_below_units, cw // unit_h)
        actual_left = unit_h * (ch // unit_h + lbu) if left_avail else 0
        actual_top = 0
    else:
        actual_top = cw
        actual_left = ch
    above_is4 = 0 if left_avail else 1
    left_is4 = 0 if above_avail else 1
    start = [actual_top >> (2 + above_is4), actual_left >> (2 + left_is4)]
    step = [max(1, actual_top >> (1 + above_is4)), max(1, actual_left >> (1 + left_is4))]
    sel_luma = [0, 0, 0, 0]
    sel_chroma = [0, 0, 0, 0]
    cnt_t = cnt_l = 0
    cnt = 0
    if above_avail:
        cnt_t = min(actual_top, (1 + above_is4) << 1)
        pos = start[0]
        while cnt < cnt_t:
            sel_luma[cnt] = int(luma_top[pos])
            sel_chroma[cnt] = int(chroma_top[1 + pos])
            pos += step[0]
            cnt += 1
    if left_avail:
        cnt_l = min(actual_left, (1 + left_is4) << 1)
        pos = start[1]
        k = 0
        while k < cnt_l:
            sel_luma[k + cnt_t] = int(luma_left[pos])
            sel_chroma[k + cnt_t] = int(chroma_left[1 + pos])
            pos += step[1]
            k += 1
    cnt = cnt_l + cnt_t
    if cnt == 2:
        sel_luma[3], sel_chroma[3] = sel_luma[0], sel_chroma[0]
        sel_luma[2], sel_chroma[2] = sel_luma[1], sel_chroma[1]
        sel_luma[0], sel_chroma[0] = sel_luma[1], sel_chroma[1]
        sel_luma[1], sel_chroma[1] = sel_luma[3], sel_chroma[3]
    min_grp = [0, 2]
    max_grp = [1, 3]
    if sel_luma[min_grp[0]] > sel_luma[min_grp[1]]:
        min_grp = [min_grp[1], min_grp[0]]
    if sel_luma[max_grp[0]] > sel_luma[max_grp[1]]:
        max_grp = [max_grp[1], max_grp[0]]
    if sel_luma[min_grp[0]] > sel_luma[max_grp[1]]:
        min_grp, max_grp = max_grp, min_grp
    if sel_luma[min_grp[1]] > sel_luma[max_grp[0]]:
        min_grp[1], max_grp[0] = max_grp[0], min_grp[1]
    min_l = (sel_luma[min_grp[0]] + sel_luma[min_grp[1]] + 1) >> 1
    min_c = (sel_chroma[min_grp[0]] + sel_chroma[min_grp[1]] + 1) >> 1
    max_l = (sel_luma[max_grp[0]] + sel_luma[max_grp[1]] + 1) >> 1
    max_c = (sel_chroma[max_grp[0]] + sel_chroma[max_grp[1]] + 1) >> 1
    if left_avail or above_avail:
        diff = max_l - min_l
        if diff > 0:
            diff_c = max_c - min_c
            x = floor_log2(diff)
            norm_diff = ((diff << 4) >> x) & 15
            v = DIV_SIG_TABLE[norm_diff] | 8
            x += int(norm_diff != 0)
            y = floor_log2(abs(diff_c)) + 1 if diff_c else 1
            add = (1 << y) >> 1
            a = (diff_c * v + add) >> y
            shift = 3 + x - y
            if shift < 1:
                shift = 1
                a = 0 if a == 0 else (-15 if a < 0 else 15)
            b = min_c - ((a * min_l) >> shift)
        else:
            a, b, shift = 0, min_c, 0
        return a, b, shift
    return 0, 1 << (bit_depth - 1), 0


def pred_bdpcm(top: np.ndarray, left: np.ndarray, w: int, h: int, dir_mode: int,
               bit_depth: int) -> np.ndarray:
    """xPredIntraBDPCM: 1=horizontal (copy left), 2=vertical (copy top)."""
    if dir_mode == 1:
        return np.tile(left[1 : h + 1].astype(np.int64)[:, None], (1, w))
    return np.tile(top[1 : w + 1].astype(np.int64)[None, :], (h, 1))
