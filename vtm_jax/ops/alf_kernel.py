"""Vectorized (device) ALF kernels: picture-wide classification, clipped
diamond filtering, and CC-ALF.

Mirrors the scalar reference in ops/alf.py (AdaptiveLoopFilter.cpp
deriveClassificationBlk:859 / filterBlk / filterBlkCcAlf) as dense integer
computations over whole planes.  Per-CTU filter selection is folded into
per-4x4 coefficient/clip maps assembled on host (a CTU with ALF off gets
all-zero coefficients, which makes the filter an exact identity), so the
kernels themselves are branch-free.

Virtual-boundary (VB) handling is row-wise: the VB-adjusted source row
indices / filter tap offsets are precomputed per picture row on host and
passed as gather indices.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

PAD = 4
ACT_TH = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4],
                  dtype=np.int32)
TRANSPOSE_TABLE = np.array([0, 1, 0, 2, 2, 3, 1, 3], dtype=np.int32)

LUMA_TAPS = ((5, 0), (3, 1), (3, 0), (3, -1), (1, 2), (1, 1), (1, 0),
             (1, -1), (1, -2), (0, 3), (0, 2), (0, 1))
CHROMA_TAPS = ((3, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1))


# ---------------------------------------------------------------------------
# host-side VB row preparation
# ---------------------------------------------------------------------------

def vb_row_offsets(h: int, vb_ctu_height: int, vb_pos: int, is_luma: bool):
    """Per-row (o1..o6) tap row offsets + near_vb flag (filterBlk VB logic)."""
    o = np.zeros((h, 6), dtype=np.int32)
    near = np.zeros(h, dtype=bool)
    rng = 4 if is_luma else 2
    for y in range(h):
        yvb = y & (vb_ctu_height - 1)
        o1, o2, o3, o4, o5, o6 = 1, -1, 2, -2, 3, -3
        if yvb < vb_pos and yvb >= vb_pos - rng:
            if yvb == vb_pos - 1:
                o1 = o2 = 0
            if yvb >= vb_pos - 2:
                o3, o4 = o1, o2
            if yvb >= vb_pos - 3:
                o5, o6 = o3, o4
        elif vb_pos <= yvb <= vb_pos + (3 if is_luma else 1):
            if yvb == vb_pos:
                o1 = o2 = 0
            if yvb <= vb_pos + 1:
                o3, o4 = o1, o2
            if yvb <= vb_pos + 2:
                o5, o6 = o3, o4
        o[y] = (o1, o2, o3, o4, o5, o6)
        near[y] = yvb in (vb_pos - 1, vb_pos)
    return o, near


def classify_row_indices(h: int, vb_ctu_height: int, vb_pos: int):
    """VB-adjusted (yd, yu, yu2) padded-row indices per even laplacian row."""
    nr = h // 2 + 2
    y_i = np.zeros(nr, dtype=np.int32)
    yd_i = np.zeros(nr, dtype=np.int32)
    yu_i = np.zeros(nr, dtype=np.int32)
    yu2_i = np.zeros(nr, dtype=np.int32)
    for gy in range(nr):
        y = 2 * gy - 2
        yd, yu, yu2 = y - 1, y + 1, y + 2
        if y > 0 and (y & (vb_ctu_height - 1)) == vb_pos - 2:
            yu2 = yu
        elif y > 0 and (y & (vb_ctu_height - 1)) == vb_pos:
            yd = y
        y_i[gy] = y + PAD
        yd_i[gy] = yd + PAD
        yu_i[gy] = yu + PAD
        yu2_i[gy] = yu2 + PAD
    return y_i, yd_i, yu_i, yu2_i


def classify_block_rows(h: int, vb_ctu_height: int, vb_pos: int):
    """Per 4x4-block-row: (drop_first, drop_last, mult) of the class sums."""
    nb = h // 4
    drop_first = np.zeros(nb, dtype=bool)
    drop_last = np.zeros(nb, dtype=bool)
    mult = np.full(nb, 64, dtype=np.int32)
    for by in range(nb):
        y = by * 4
        yv = y % vb_ctu_height
        if yv == vb_pos - 4:
            drop_last[by] = True
        elif yv == vb_pos:
            drop_first[by] = True
        yb = y & (vb_ctu_height - 1)
        if yb in (vb_pos - 4, vb_pos):
            mult[by] = 96
    return drop_first, drop_last, mult


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("bit_depth",))
def classify_picture(pad, y_i, yd_i, yu_i, yu2_i, drop_first, drop_last, mult,
                     bit_depth: int):
    """deriveClassificationBlk over the whole picture.

    pad: int32 luma plane padded by PAD (edge).  Returns (classes,
    transposes) int32 [H4, W4].
    """
    shift = bit_depth + 4
    Hp, Wp = pad.shape
    w = Wp - 2 * PAD
    NW = w // 2 + 2

    Ry = pad[y_i]      # [NR, Wp]
    Rd = pad[yd_i]
    Ru = pad[yu_i]
    Ru2 = pad[yu2_i]

    def cols(R, dx):
        # even columns x = 2*gx - 2 + dx  →  padded col = 2*gx + 2 + dx
        return jax.lax.slice(R, (0, 2 + dx), (R.shape[0], 2 + dx + 2 * NW), (1, 2))

    y0v = cols(Ry, 0) * 2
    yup1 = cols(Ru, 1) * 2
    V = jnp.abs(y0v - cols(Rd, 0) - cols(Ru, 0)) \
        + jnp.abs(yup1 - cols(Ry, 1) - cols(Ru2, 1))
    Hh = jnp.abs(y0v - cols(Ry, 1) - cols(Ry, -1)) \
        + jnp.abs(yup1 - cols(Ru, 2) - cols(Ru, 0))
    D0 = jnp.abs(y0v - cols(Rd, -1) - cols(Ru, 1)) \
        + jnp.abs(yup1 - cols(Ry, 0) - cols(Ru2, 2))
    D1 = jnp.abs(y0v - cols(Ru, -1) - cols(Rd, 1)) \
        + jnp.abs(yup1 - cols(Ru2, 0) - cols(Ry, 2))

    H4 = (y_i.shape[0] - 2) // 2
    W4 = (NW - 2) // 2

    def block_sum(A):
        # col window: gx = 2bx .. 2bx+3
        C = A[:, 0:-3] + A[:, 1:-2] + A[:, 2:-1] + A[:, 3:]
        C = C[:, 0 : 2 * W4 : 2]
        R = [C[a : a + 2 * H4 : 2] for a in range(4)]
        full = R[0] + R[1] + R[2] + R[3]
        nolast = R[0] + R[1] + R[2]
        nofirst = R[1] + R[2] + R[3]
        df = drop_first[:, None]
        dl = drop_last[:, None]
        return jnp.where(dl, nolast, jnp.where(df, nofirst, full))

    sum_v = block_sum(V)
    sum_h = block_sum(Hh)
    sum_d0 = block_sum(D0)
    sum_d1 = block_sum(D1)

    temp_act = sum_v + sum_h
    activity = jnp.clip((temp_act * mult[:, None]) >> shift, 0, 15)
    class_idx = jnp.asarray(ACT_TH)[activity]

    hv_gt = sum_v > sum_h
    hv1 = jnp.where(hv_gt, sum_v, sum_h)
    hv0 = jnp.where(hv_gt, sum_h, sum_v)
    dir_hv = jnp.where(hv_gt, 1, 3)
    d_gt = sum_d0 > sum_d1
    d1 = jnp.where(d_gt, sum_d0, sum_d1)
    d0 = jnp.where(d_gt, sum_d1, sum_d0)
    dir_d = jnp.where(d_gt, 0, 2)
    # int32 products, matching the reference's plain-int arithmetic
    # (AdaptiveLoopFilter.cpp deriveClassificationBlk direction compare)
    dmain = d1 * hv0 > hv1 * d0
    hvd1 = jnp.where(dmain, d1, hv1)
    hvd0 = jnp.where(dmain, d0, hv0)
    main_dir = jnp.where(dmain, dir_d, dir_hv)
    sec_dir = jnp.where(dmain, dir_hv, dir_d)
    strength = jnp.where(
        hvd1 * 2 > 9 * hvd0, 2,
        jnp.where(hvd1 > 2 * hvd0, 1, 0))
    class_idx = jnp.where(
        strength > 0,
        class_idx + (((main_dir & 1) << 1) + strength) * 5,
        class_idx)
    transposes = jnp.asarray(TRANSPOSE_TABLE)[main_dir * 2 + (sec_dir >> 1)]
    return class_idx.astype(jnp.int32), transposes.astype(jnp.int32)


@partial(jax.jit, static_argnames=("taps", "bit_depth"))
def alf_filter(src_pad, coefmap, clipmap, o_rows, near_vb,
               taps, bit_depth: int):
    """Clipped diamond filter over a whole plane.

    src_pad: int32 [H+2P, W+2P]; coefmap/clipmap: int32 [H4, W4, n_taps]
    (4x4 granularity, zero coeffs → identity); o_rows: int32 [H, 6]
    VB-adjusted row offsets; near_vb: bool [H].
    """
    shift = 8 - 1  # NUM_BITS - 1
    offset = 1 << (shift - 1)
    maxv = (1 << bit_depth) - 1
    H = o_rows.shape[0]
    W = coefmap.shape[1] * 4
    yy = jnp.arange(H, dtype=jnp.int32)
    curr = src_pad[PAD:PAD + H, PAD:PAD + W]

    # row-gathered planes per offset pair index (0→(0,0),1→(o1,o2),...)
    rowsA = {0: src_pad[yy + PAD]}
    rowsB = {0: rowsA[0]}
    for op, (ia, ib) in ((1, (0, 1)), (3, (2, 3)), (5, (4, 5))):
        rowsA[op] = src_pad[yy + PAD + o_rows[:, ia]]
        rowsB[op] = src_pad[yy + PAD + o_rows[:, ib]]

    def expand(m):  # [H4, W4] → [H, W]
        return jnp.repeat(jnp.repeat(m, 4, axis=0), 4, axis=1)

    acc = jnp.zeros((H, W), dtype=jnp.int32)
    for k, (op, dx) in enumerate(taps):
        a = jax.lax.slice(rowsA[op], (0, PAD + dx), (H, PAD + dx + W))
        b = jax.lax.slice(rowsB[op], (0, PAD - dx), (H, PAD - dx + W))
        cl = expand(clipmap[:, :, k])
        co = expand(coefmap[:, :, k])
        d = jnp.clip(a - curr, -cl, cl) + jnp.clip(b - curr, -cl, cl)
        acc = acc + co * d
    acc = jnp.where(
        near_vb[:, None],
        (acc + (1 << (shift + 3 - 1))) >> (shift + 3),
        (acc + offset) >> shift,
    )
    return jnp.clip(curr + acc, 0, maxv)


@partial(jax.jit, static_argnames=("bit_depth", "sx", "sy", "has_l",
                                   "has_cb", "has_cr", "has_cc1", "has_cc2"))
def alf_all(y_pad, cb, cr,
            cperm, lperm, ctu_of, l_orows, l_near,
            y_i, yd_i, yu_i, yu2_i, df, dl, mult,
            cb_coef, cb_clip, cr_coef, cr_clip, c_orows, c_near,
            cc1_coef, cc2_coef, cc_orows, cc_skip,
            bit_depth: int, sx: int, sy: int, has_l: bool, has_cb: bool,
            has_cr: bool, has_cc1: bool, has_cc2: bool):
    """Whole-picture ALF in ONE device dispatch: luma classification +
    clipped diamond filtering with the per-CTU coefficient gather done
    in-kernel, chroma ALF, and CC-ALF (which reads the pre-ALF luma)."""
    if has_l:
        cls, tr = classify_picture(y_pad, y_i, yd_i, yu_i, yu2_i, df, dl,
                                   mult, bit_depth=bit_depth)
        coef = cperm[ctu_of, cls, tr]
        clip = lperm[ctu_of, cls, tr]
        y = alf_filter(y_pad, coef, clip, l_orows, l_near,
                       taps=LUMA_TAPS, bit_depth=bit_depth)
    else:
        y = y_pad[PAD:-PAD, PAD:-PAD]
    if has_cb:
        cb = alf_filter(jnp.pad(cb, PAD, mode="edge"), cb_coef, cb_clip,
                        c_orows, c_near, taps=CHROMA_TAPS, bit_depth=bit_depth)
    if has_cr:
        cr = alf_filter(jnp.pad(cr, PAD, mode="edge"), cr_coef, cr_clip,
                        c_orows, c_near, taps=CHROMA_TAPS, bit_depth=bit_depth)
    if has_cc1:
        cb = ccalf_filter(y_pad, cb, cc1_coef, cc_orows, cc_skip,
                          scale_x=sx, scale_y=sy, bit_depth=bit_depth)
    if has_cc2:
        cr = ccalf_filter(y_pad, cr, cc2_coef, cc_orows, cc_skip,
                          scale_x=sx, scale_y=sy, bit_depth=bit_depth)
    return y, cb, cr


def ccalf_row_offsets(hc: int, scale_y: int, vb_ctu_height: int, vb_pos: int):
    """Per chroma row: (o1, o2, o3) luma tap offsets + skip flag."""
    o = np.zeros((hc, 3), dtype=np.int32)
    skip = np.zeros(hc, dtype=bool)
    for i in range(hc):
        pos = (i << scale_y) & (vb_ctu_height - 1)
        if scale_y == 0 and (pos == vb_pos or pos == vb_pos + 1):
            skip[i] = True
        o1, o2, o3 = 1, -1, 2
        if pos == vb_pos - 2 or pos == vb_pos + 1:
            o3 = o1
        elif pos == vb_pos - 1 or pos == vb_pos:
            o1 = o2 = o3 = 0
        o[i] = (o1, o2, o3)
    return o, skip


@partial(jax.jit, static_argnames=("scale_x", "scale_y", "bit_depth"))
def ccalf_filter(luma_pad, dst, coefmap, o_rows, skip,
                 scale_x: int, scale_y: int, bit_depth: int):
    """filterBlkCcAlf over a whole chroma plane.

    luma_pad: int32 pre-ALF luma padded by PAD; dst: int32 [Hc, Wc] chroma
    (post chroma-ALF); coefmap: int32 [Hc4, Wc4, 7] per-4x4 CC-ALF coeffs
    (zeros → identity); o_rows: [Hc, 3]; skip: bool [Hc].
    """
    maxv = (1 << bit_depth) - 1
    half = (1 << bit_depth) >> 1
    Hc, Wc = dst.shape
    yy = jnp.arange(Hc, dtype=jnp.int32)
    yl = (yy << scale_y) + PAD

    R0 = luma_pad[yl]                       # center rows
    R1 = luma_pad[yl + o_rows[:, 0]]        # +o1
    R2 = luma_pad[yl + o_rows[:, 1]]        # +o2
    R3 = luma_pad[yl + o_rows[:, 2]]        # +o3

    step = 1 << scale_x

    def cols(R, dx):
        return jax.lax.slice(R, (0, PAD + dx), (Hc, PAD + dx + step * Wc),
                             (1, step))

    curr = cols(R0, 0)
    c = [jnp.repeat(jnp.repeat(coefmap[:, :, k], 4, axis=0), 4, axis=1)
         for k in range(7)]
    s = c[0] * (cols(R2, 0) - curr)
    s = s + c[1] * (cols(R0, -1) - curr)
    s = s + c[2] * (cols(R0, 1) - curr)
    s = s + c[3] * (cols(R1, -1) - curr)
    s = s + c[4] * (cols(R1, 0) - curr)
    s = s + c[5] * (cols(R1, 1) - curr)
    s = s + c[6] * (cols(R3, 0) - curr)
    s = (s + ((1 << 7) >> 1)) >> 7  # SCALE_BITS_CC
    # ClipPel(sum + offset) - offset (AdaptiveLoopFilter.cpp:1399)
    s = jnp.clip(s + half, 0, maxv) - half
    out = jnp.clip(s + dst, 0, maxv)
    return jnp.where(skip[:, None], dst, out)
