"""Motion-compensation interpolation (exact integer reference path).

Behavioral equivalent of InterpolationFilter.cpp (filter:551, filterCopy:397,
filterHor:749, filterVer:832) and InterPrediction::xPredInterBlk:660 /
xWeightedAverage:1354 (addAvg core, Buffer.cpp:74).

The reference extends picture borders (Picture::extendPicBorder) so MC can
read outside the frame; we instead gather with clamped indices, which is
numerically identical to edge replication.

Vectorized numpy scalar-exact path; the batched device variant
(ops/mc_kernel.py) builds on the same coefficient ROMs.
"""

from __future__ import annotations

import numpy as np

from vtm_jax.common import rom

IF_INTERNAL_PREC = 14
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)  # 8192
IF_FILTER_PREC = 6
NTAPS_LUMA = 8
NTAPS_CHROMA = 4
NTAPS_BILINEAR = 2


_LUMA = rom.get("lumaFilter")          # (16, 8)
_LUMA_4x4 = rom.get("lumaFilter4x4")   # (16, 8)
_LUMA_ALT_HPEL = rom.get("lumaAltHpelIFilter")  # (8,)
_CHROMA = rom.get("chromaFilter")      # (32, 4)
_BILINEAR = rom.get("bilinearFilterPrec4")  # (16, 2)


def luma_coeffs(frac: int, w: int, h: int, use_alt_hpel: bool,
                hor: bool) -> np.ndarray:
    """Select luma filter taps (InterpolationFilter::filterHor/Ver dispatch)."""
    if frac == 8 and use_alt_hpel:
        return _LUMA_ALT_HPEL
    if hor:
        if (w == 4 and h == 4) or (w == 4 and h == 4 + NTAPS_LUMA - 1):
            return _LUMA_4x4[frac]
    else:
        if w == 4 and h == 4:
            return _LUMA_4x4[frac]
    return _LUMA[frac]


def _gather_ref(plane: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Window read with clamped indices == replicated border extension."""
    ph, pw = plane.shape
    if 0 <= x0 and 0 <= y0 and x0 + w <= pw and y0 + h <= ph:
        return plane[y0 : y0 + h, x0 : x0 + w].astype(np.int64)
    ys = np.clip(np.arange(y0, y0 + h), 0, ph - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, pw - 1)
    return plane[np.ix_(ys, xs)].astype(np.int64)


def _fir(block: np.ndarray, coeff: np.ndarray, axis: int, is_first: bool,
         is_last: bool, bd: int) -> np.ndarray:
    """InterpolationFilter::filter<N, isVertical, isFirst, isLast>.

    `block` already includes the (N-1) extra rows/cols of support along
    `axis` (starting at tap 0); output length = len - N + 1 along axis.
    """
    n = len(coeff)
    head_room = max(2, IF_INTERNAL_PREC - bd)
    shift = IF_FILTER_PREC
    if is_last:
        shift += 0 if is_first else head_room
        offset = 1 << (shift - 1)
        offset += 0 if is_first else IF_INTERNAL_OFFS << IF_FILTER_PREC
    else:
        shift -= head_room if is_first else 0
        offset = (-IF_INTERNAL_OFFS << shift) if is_first else 0
    out_len = block.shape[axis] - n + 1
    acc = np.zeros(
        (out_len, block.shape[1]) if axis == 0 else (block.shape[0], out_len),
        dtype=np.int64,
    )
    for k in range(n):
        c = int(coeff[k])
        if c == 0:
            continue
        if axis == 0:
            acc += c * block[k : k + out_len, :]
        else:
            acc += c * block[:, k : k + out_len]
    val = (acc + offset) >> shift
    if is_last:
        val = np.clip(val, 0, (1 << bd) - 1)
    return val


def _copy(block: np.ndarray, is_first: bool, is_last: bool, bd: int) -> np.ndarray:
    """filterCopy (frac == 0)."""
    if is_first == is_last:
        return block.copy()
    shift = max(2, IF_INTERNAL_PREC - bd)
    if is_first:
        return (block << shift) - IF_INTERNAL_OFFS
    val = (block + IF_INTERNAL_OFFS + (1 << (shift - 1))) >> shift
    return np.clip(val, 0, (1 << bd) - 1)


def mc_block(
    plane: np.ndarray,
    x0: int,
    y0: int,
    w: int,
    h: int,
    frac_x: int,
    frac_y: int,
    is_luma: bool,
    bd: int,
    rnd_res: bool,
    use_alt_hpel: bool = False,
    scale_x: int = 0,
    scale_y: int = 0,
) -> np.ndarray:
    """xPredInterBlk core for one component, translational MV.

    (x0, y0) integer start position in component coords; frac_* are the
    fractional phases in the component's MV precision (luma /16, chroma /32
    for 4:2:0).  rnd_res=True → final clipped samples (uni); False → 14-bit
    intermediate (bi).
    """
    if is_luma:
        taps = NTAPS_LUMA
        # filterHor sees height=h for the single-pass case but h+taps-1 in
        # the two-pass case; the (4,4)/(4,11) special-case checks use that.
        hor_h = h if frac_y == 0 else h + taps - 1
        cf_h = luma_coeffs(frac_x, w, hor_h, use_alt_hpel, True)
        cf_v = luma_coeffs(frac_y, w, h, use_alt_hpel, False)
    else:
        taps = NTAPS_CHROMA
        cf_h = _CHROMA[frac_x << (1 - scale_x)]
        cf_v = _CHROMA[frac_y << (1 - scale_y)]
    half = (taps >> 1) - 1

    if frac_y == 0 and frac_x == 0:
        ref = _gather_ref(plane, x0, y0, w, h)
        return _copy(ref, True, rnd_res, bd)
    if frac_y == 0:
        ref = _gather_ref(plane, x0 - half, y0, w + taps - 1, h)
        return _fir(ref, cf_h, 1, True, rnd_res, bd)
    if frac_x == 0:
        ref = _gather_ref(plane, x0, y0 - half, w, h + taps - 1)
        return _fir(ref, cf_v, 0, True, rnd_res, bd)
    ref = _gather_ref(plane, x0 - half, y0 - half, w + taps - 1, h + taps - 1)
    tmp = _fir(ref, cf_h, 1, True, False, bd)
    return _fir(tmp, cf_v, 0, False, rnd_res, bd)


def bi_average(p0: np.ndarray, p1: np.ndarray, bd: int) -> np.ndarray:
    """addAvg (Buffer.h): (a + b + offset) >> shift, clip.

    shift = max(2, 14-bd) + 1; offset = (1 << (shift-1)) + 2*IF_INTERNAL_OFFS.
    """
    shift = max(2, IF_INTERNAL_PREC - bd) + 1
    offset = (1 << (shift - 1)) + 2 * IF_INTERNAL_OFFS
    return np.clip((p0 + p1 + offset) >> shift, 0, (1 << bd) - 1)


def _init_geo_weights():
    """All GEO_NUM_PRESTORED_MASK=6 weight masks (initGeoTemplate,
    Rom.cpp:719-747) — the ROM dump only carries masks 0 and 1."""
    a2m = rom.get("geoAngle2mask")
    dis = rom.get("geoDis")
    masks = [None] * 6
    s = 112  # GEO_WEIGHT_MASK_SIZE
    mask_off = (2 * 64 - s) >> 1
    y = np.arange(s)
    x = np.arange(s)
    for angle in range(9):  # (GEO_NUM_ANGLES >> 2) + 1
        if a2m[angle] == -1:
            continue
        dist_x = angle
        dist_y = (dist_x + 8) % 32
        rho = (int(dis[dist_x]) << 7) + (int(dis[dist_y]) << 7)
        lookup_y = ((((y + mask_off) << 1) + 1) * int(dis[dist_y]))[:, None]
        sx = (((x + mask_off) << 1) + 1)[None, :]
        widx = sx * int(dis[dist_x]) + lookup_y - rho
        masks[int(a2m[angle])] = np.clip((32 + widx + 4) >> 3, 0, 8).astype(np.int16)
    return masks


_GEO_WEIGHTS = _init_geo_weights()
_GEO_PARAMS = rom.get("geoParams")
_GEO_OFFSET = rom.get("geoWeightOffset")
_GEO_A2MASK = rom.get("geoAngle2mask")
_GEO_A2MIRROR = rom.get("geoAngle2mirror")
GEO_WEIGHT_MASK_SIZE = 112


def geo_weight_block(split_dir: int, lw: int, lh: int, scale_x: int,
                     scale_y: int, w: int, h: int) -> np.ndarray:
    """Per-sample weights for one component (xWeightedGeoBlk walk,
    InterpolationFilter.cpp:905)."""
    angle = int(_GEO_PARAMS[split_dir][0])
    w_idx = lw.bit_length() - 1 - 3  # GEO_MIN_CU_LOG2
    h_idx = lh.bit_length() - 1 - 3
    off_x = int(_GEO_OFFSET[split_dir][h_idx][w_idx][0])
    off_y = int(_GEO_OFFSET[split_dir][h_idx][w_idx][1])
    grid = _GEO_WEIGHTS[int(_GEO_A2MASK[angle])]
    mirror = int(_GEO_A2MIRROR[angle])
    s = GEO_WEIGHT_MASK_SIZE
    ys = np.arange(h) << scale_y
    xs = np.arange(w) << scale_x
    if mirror == 2:
        rows = (s - 1 - off_y) - ys
        cols = off_x + xs
    elif mirror == 1:
        rows = off_y + ys
        cols = (s - 1 - off_x) - xs
    else:
        rows = off_y + ys
        cols = off_x + xs
    return grid[np.ix_(rows, cols)].astype(np.int64)


def geo_blend(p0: np.ndarray, p1: np.ndarray, weights: np.ndarray,
              bd: int) -> np.ndarray:
    """Weighted geo blending of two 14-bit predictions (xWeightedGeoBlk)."""
    log2_wd = 3
    shift = max(2, IF_INTERNAL_PREC - bd) + log2_wd
    offset = (1 << (shift - 1)) + (IF_INTERNAL_OFFS << log2_wd)
    return np.clip((weights * p0 + (8 - weights) * p1 + offset) >> shift,
                   0, (1 << bd) - 1)


def bcw_average(p0: np.ndarray, p1: np.ndarray, bd: int, w0: int, w1: int) -> np.ndarray:
    """addWeightedAvg (Buffer.cpp:366): (w0*a + w1*b + offset) >> shift with
    shift = max(2, 14-bd) + 3 and offset = (1<<(shift-1)) + (OFFS << 3)."""
    log2_wd = 3  # g_BcwLog2WeightBase
    shift = max(2, IF_INTERNAL_PREC - bd) + log2_wd
    offset = (1 << (shift - 1)) + (IF_INTERNAL_OFFS << log2_wd)
    return np.clip((w0 * p0 + w1 * p1 + offset) >> shift, 0, (1 << bd) - 1)
