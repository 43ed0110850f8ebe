"""Whole-frame batched intra RMD (rough mode decision) on the device.

Batched redesign of IntraSearch::estIntraPredLumaQT's SATD candidate
pass (EncoderLib/IntraSearch.cpp:370): instead of predicting+costing one
CU and one mode at a time inside the partition recursion, ALL candidate
blocks of a frame (every (w,h) size class of the intra partition universe
at every legal offset) are evaluated for ALL 67 regular modes plus every
MIP mode in a handful of jitted device dispatches:

  * reference rows are built from the SOURCE plane (classic fast-encoder
    approximation: reconstruction is unavailable before the partition
    decision; the exact-RD stage still uses true reconstructed refs),
  * angular prediction = per-mode precomputed gather tables + the 4-tap
    DCT-IF/smoothing interpolation, batched over (position, mode, y, x),
  * MIP = boundary downsample + weight-matrix einsum + linear
    upsample,
  * cost = mean-scaled Hadamard SATD (RdCost.cpp:2294 family) via
    batched +-1 matrix products.

The host reads back one small (positions, modes) int32 cost tensor per
class and the partition recursion ranks candidates from the table —
turning the encoder's RMD from O(CUs * modes) scalar work into a few
large device ops (SURVEY §7 "search as argmin over enumerated
candidates").
"""

from __future__ import annotations

import numpy as np

from vtm_jax.common import rom
from vtm_jax.ops import intra as I
from vtm_jax.ops import rdcost

# ---------------------------------------------------------------------------
# host-side per-class mode tables (depend only on (w, h, bit_depth))

_CLASS_TABLES: dict = {}
_JIT_CACHE: dict = {}


def _seg_bases(w: int, h: int):
    """Index bases of the concat ref buffer C = [Tu|Lu|Tf|Lf|0]."""
    tu = 0
    lu = 2 * w + 1
    tf = lu + 2 * h + 1
    lf = tf + 2 * w + 1
    zero = lf + 2 * h + 1
    return tu, lu, tf, lf, zero


def _build_mode_tables(w: int, h: int, bit_depth: int):
    """Per-mode symbolic gather tables for angular modes 2..66.

    Returns dict with two groups ('ver'/'hor'), each holding stacked
    numpy arrays: modes, rm_sym (M,L), gi (M,dh,dw,4), f (M,dh,4),
    wl (M,dw), rs_sym (M,LS), sidx (M,dh,dw); plus scalars.
    """
    tu0, lu0, tf0, lf0, zslot = _seg_bases(w, h)
    lc = zslot + 1

    groups = {True: [], False: []}
    for m in range(2, 67):
        if m in (I.HOR_IDX, I.VER_IDX):
            continue  # angle==0: special PDPC, computed in _planar_dc_jnp
        p = I.IntraParams(m, w, h, w, h, True, 0, False, False)
        angle, inv_angle, is_ver = p.intra_pred_angle, p.inv_angle, p.is_mode_ver
        filt = p.ref_filter_flag
        # main/side segment bases in C for this orientation
        if is_ver:
            t_seg = tf0 if filt else tu0
            l_seg = lf0 if filt else lu0
            mw, mh = w, h  # main length w-based, side h-based
        else:
            t_seg = lf0 if filt else lu0  # "top" role played by left col
            l_seg = tf0 if filt else tu0
            mw, mh = h, w
        dh, dw = (h, w) if is_ver else (w, h)
        # ref_main symbolic array over absolute indices [0 .. rm + 2mw + 2]
        if angle < 0:
            rm = mh
            L = mh + mw + 2
            sym = np.full(L, zslot, dtype=np.int64)
            for k in range(mw + 2):
                sym[rm + k] = t_seg + k
            ks = np.arange(-mh, 0, dtype=np.int64)
            sidx = np.minimum((-ks * inv_angle + 256) >> 9, mh)
            sym[0:mh] = l_seg + sidx
            rs_len = 0  # no pos-angle PDPC
            rs_sym = np.zeros(1, dtype=np.int64)
        else:
            rm = 0
            L = 2 * mw + 3
            sym = np.full(L, zslot, dtype=np.int64)
            for k in range(2 * mw + 1):
                sym[k] = t_seg + k
            sym[2 * mw + 1 :] = t_seg + 2 * mw
            # side for PDPC: unpadded side col (same filter choice),
            # zeros beyond 2mh (scalar path zero-pads)
            rs_len = 2 * mh + 1
            rs_sym = np.full(rs_len, zslot, dtype=np.int64)
            for k in range(rs_len):
                rs_sym[k] = l_seg + k
        # per-row interpolation
        di = np.zeros(dh, dtype=np.int64)
        f = np.zeros((dh, 4), dtype=np.int64)
        yr = np.arange(dh, dtype=np.int64)
        delta_pos = angle * (1 + yr)
        delta_int = delta_pos >> 5
        delta_fract = delta_pos & 31
        if (abs(angle) & 0x1F) == 0:
            f[:] = np.array([64, 0, 0, 0], dtype=np.int64)
            di[:] = delta_int + 1
        elif not p.interpolation_flag:
            f[:] = I._CHROMA_FILTER[delta_fract]
            di[:] = delta_int
        else:
            hf = delta_fract >> 1
            f[:] = np.stack([16 - hf, 32 - hf, 16 + hf, hf], axis=1)
            di[:] = delta_int
        xr = np.arange(dw, dtype=np.int64)
        gi = rm + di[:, None] + xr[None, :]  # (dh, dw) base gather idx
        # PDPC (angle > 0 only; angle < 0 has apply_pdpc False; angle==0
        # excluded from this table — handled separately)
        wl = np.zeros(dw, dtype=np.int64)
        sidx_t = np.zeros((dh, dw), dtype=np.int64)
        if angle > 0 and p.apply_pdpc:
            scale = p.angular_scale
            nx = min(3 << scale, dw)
            wl[:nx] = 32 >> ((2 * xr[:nx]) >> scale)
            inv_sum = 256 + (xr + 1) * inv_angle
            s_t = yr[:, None] + (inv_sum >> 9)[None, :] + 1
            sidx_t[:] = np.minimum(s_t, rs_len - 1 if rs_len else 0)
        groups[is_ver].append(
            dict(mode=m, sym=sym, gi=gi, f=f, wl=wl, rs_sym=rs_sym,
                 sidx=sidx_t, clip_free=(abs(angle) & 0x1F) == 0
                 and not (angle > 0 and p.apply_pdpc))
        )

    out = {}
    for is_ver, recs in groups.items():
        if not recs:
            continue
        M = len(recs)
        lmax = max(len(r["sym"]) for r in recs)
        lsmax = max(len(r["rs_sym"]) for r in recs)
        sym = np.full((M, lmax), zslot, dtype=np.int64)
        rs = np.full((M, lsmax), zslot, dtype=np.int64)
        dh, dw = (h, w) if is_ver else (w, h)
        gi = np.zeros((M, dh, dw), dtype=np.int64)
        f = np.zeros((M, dh, 4), dtype=np.int64)
        wl = np.zeros((M, dw), dtype=np.int64)
        sx = np.zeros((M, dh, dw), dtype=np.int64)
        modes = []
        for i, r in enumerate(recs):
            sym[i, : len(r["sym"])] = r["sym"]
            rs[i, : len(r["rs_sym"])] = r["rs_sym"]
            gi[i] = r["gi"]
            f[i] = r["f"]
            wl[i] = r["wl"]
            sx[i] = r["sidx"]
            modes.append(r["mode"])
        out["ver" if is_ver else "hor"] = dict(
            modes=modes, sym=sym, rs=rs, gi=gi, f=f, wl=wl, sidx=sx
        )
    out["lc"] = lc
    return out


def class_tables(w: int, h: int, bit_depth: int):
    key = (w, h, bit_depth)
    t = _CLASS_TABLES.get(key)
    if t is None:
        t = _build_mode_tables(w, h, bit_depth)
        _CLASS_TABLES[key] = t
    return t


# ---------------------------------------------------------------------------
# Matmul formulation: angular prediction is a LINEAR map from the
# reference buffer C to the prediction samples, so each mode's gather+4-tap
# filter collapses into a constant (LC, K) matrix and the whole mode sweep
# into one batched matmul — the design SURVEY §7 asks for.  float32 at
# HIGHEST precision is exact here: |C| < 2^10, coefficient sums <= 64,
# so every product/accumulation stays under the 2^24 float32 int limit.
# HIGHEST also keeps XLA from running the product in TF32 on the GPU,
# which would round the operands and break exactness.

_MM_TABLES: dict = {}


def matmul_tables(w: int, h: int, bit_depth: int):
    key = (w, h, bit_depth)
    t = _MM_TABLES.get(key)
    if t is not None:
        return t
    tabs = class_tables(w, h, bit_depth)
    lc = tabs["lc"]
    zslot = lc - 1
    out = {"lc": lc}
    for gname in ("ver", "hor"):
        g = tabs.get(gname)
        if g is None:
            continue
        is_ver = gname == "ver"
        dh, dw = (h, w) if is_ver else (w, h)
        modes = g["modes"]
        M = len(modes)
        sym, gi, f = g["sym"], g["gi"], g["f"]
        rs, sidx, wl = g["rs"], g["sidx"], g["wl"]
        lmax = sym.shape[1]
        K = dh * dw
        # W[m, c, k]: prediction pre-shift accumulator coefficients
        mi, yi, xi, ti = np.meshgrid(
            np.arange(M), np.arange(dh), np.arange(dw), np.arange(4),
            indexing="ij")
        j = gi[mi, yi, xi] + ti  # ref_main index per tap
        csel = np.where(j < lmax, sym[mi, np.minimum(j, lmax - 1)], zslot)
        W = np.zeros((M, lc, K), np.float32)
        np.add.at(W, (mi.ravel(), csel.ravel(),
                      (yi * dw + xi).ravel()), f[mi, yi, ti].ravel())
        ent = {"W": W, "modes": modes}
        # PDPC side-sample selector (first nxmax columns only)
        nxmax = int(min(12, dw))
        any_pdpc = bool((wl != 0).any())
        ent["nxmax"] = nxmax
        ent["any_pdpc"] = any_pdpc
        ent["wl"] = wl[:, :nxmax].astype(np.int32)
        if any_pdpc:
            mi2, yi2, xi2 = np.meshgrid(
                np.arange(M), np.arange(dh), np.arange(nxmax), indexing="ij")
            cs = rs[mi2, sidx[mi2, yi2, xi2]]
            Ws = np.zeros((M, lc, dh, nxmax), np.float32)
            np.add.at(Ws, (mi2.ravel(), cs.ravel(), yi2.ravel(),
                           xi2.ravel()), 1.0)
            ent["Ws"] = Ws
        out[gname] = ent
    _MM_TABLES[key] = out
    return out


_CONST_DEV: dict = {}


def _device_consts(key, arrays: list):
    """Per-class upload cache for the big constant matrices — uploaded
    once per process instead of embedded in the executable."""
    import jax.numpy as jnp

    v = _CONST_DEV.get(key)
    if v is None:
        v = [jnp.asarray(a) for a in arrays]
        _CONST_DEV[key] = v
    return v


# ---------------------------------------------------------------------------
# jitted per-class cost kernel


def _filter_refs_jnp(tu, lu, w, h):
    """filter_reference_samples (xFilterReferenceSamples) batched: tu
    (P, 2w+1), lu (P, 2h+1) -> filtered copies."""
    import jax.numpy as jnp

    corner = (tu[:, 0] + tu[:, 1] + lu[:, 0] + lu[:, 1] + 2) >> 2
    ps, phs = 2 * w, 2 * h
    tf = jnp.concatenate(
        [corner[:, None],
         (tu[:, 0 : ps - 1] + 2 * tu[:, 1:ps] + tu[:, 2 : ps + 1] + 2) >> 2,
         tu[:, ps : ps + 1]], axis=1)
    lf = jnp.concatenate(
        [corner[:, None],
         (lu[:, 0 : phs - 1] + 2 * lu[:, 1:phs] + lu[:, 2 : phs + 1] + 2) >> 2,
         lu[:, phs : phs + 1]], axis=1)
    return tf, lf


def _planar_dc_jnp(tu, lu, tf, lf, src, w, h, maxv):
    """Planar + DC + exact-hor/ver (modes 0,1,18,50) with PDPC, batched
    over positions. Returns (P, 4) SATD costs in order [0, 1, 18, 50]."""
    import jax.numpy as jnp

    P = tu.shape[0]
    log2w, log2h = I.floor_log2(w), I.floor_log2(h)
    # --- planar (filtered refs iff w*h > 32)
    ut, ul = (tf, lf) if w * h > 32 else (tu, lu)
    t = ut[:, 1 : w + 1]
    le = ul[:, 1 : h + 1]
    br = ul[:, h + 1]  # bottomLeft
    tr = ut[:, w + 1]  # topRight
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    hor = (le << log2w)[:, :, None] + (x + 1)[None] * (tr[:, None] - le)[:, :, None]
    ver = (t << log2h)[:, None, :] + (y + 1)[None] * (br[:, None] - t)[:, None, :]
    pl = ((hor << log2h) + (ver << log2w) + (1 << (log2w + log2h))) >> (
        1 + log2w + log2h)
    pl = _pdpc_planar_dc_jnp(pl, ut, ul, w, h)
    # --- DC (unfiltered)
    denom = (w << 1) if w == h else max(w, h)
    shift = I.floor_log2(denom)
    s = jnp.zeros((P,), jnp.int32)
    if w >= h:
        s = s + tu[:, 1 : 1 + w].sum(axis=1)
    if w <= h:
        s = s + lu[:, 1 : 1 + h].sum(axis=1)
    dcv = (s + (denom >> 1)) >> shift
    dc = jnp.broadcast_to(dcv[:, None, None], (P, h, w))
    dc = _pdpc_planar_dc_jnp(dc, tu, lu, w, h)
    # --- exact horizontal (18) / vertical (50): filter flag False
    # (diff == 0 <= thresh), PDPC with top-left term (xPredIntraAng
    # angle==0 branch)
    scale = (log2w + log2h - 2) >> 2
    # vertical: dst = top row; pdpc over x < nx with left side
    xr = np.arange(w, dtype=np.int64)
    nxv = min(3 << scale, w)
    wlv = np.where(xr < nxv, 32 >> np.minimum(31, (2 * xr) >> scale), 0)
    ver_p = jnp.broadcast_to(tu[:, None, 1 : w + 1], (P, h, w))
    tl = tu[:, 0][:, None, None]
    lcol = lu[:, 1 : h + 1][:, :, None]
    vv = ver_p + ((wlv[None, None, :] * (lcol - tl) + 32) >> 6)
    ver_p = jnp.clip(vv, 0, maxv)
    yrr = np.arange(h, dtype=np.int64)
    nxh = min(3 << scale, h)
    wlh = np.where(yrr < nxh, 32 >> np.minimum(31, (2 * yrr) >> scale), 0)
    hor_p = jnp.broadcast_to(lu[:, 1 : h + 1][:, :, None], (P, h, w))
    trow = tu[:, 1 : w + 1][:, None, :]
    hh = hor_p + ((wlh[None, :, None] * (trow - tl) + 32) >> 6)
    hor_p = jnp.clip(hh, 0, maxv)
    preds = jnp.stack([pl, dc, hor_p, ver_p], axis=1)  # (P,4,h,w)
    d = (preds - src[:, None]).astype(jnp.int32)
    return rdcost.satd_batch_jax(d, h, w)


def _pdpc_planar_dc_jnp(pred, top, left, w, h):
    import jax.numpy as jnp  # noqa: F401

    scale = (I.floor_log2(w) - 2 + I.floor_log2(h) - 2 + 2) >> 2
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    wt = 32 >> np.minimum(31, (y << 1) >> scale)
    wlx = 32 >> np.minimum(31, (x << 1) >> scale)
    lcol = left[:, 1 : h + 1][:, :, None]
    trow = top[:, 1 : w + 1][:, None, :]
    return pred + ((wlx * (lcol - pred) + wt * (trow - pred) + 32) >> 6)


def _mip_jnp(tu, lu, src, w, h, bit_depth):
    """Batched MIP predictions + SATD for all (mode, transpose) pairs.

    MatrixIntraPrediction.cpp:335 redesigned as an einsum over the weight
    ROM; returns (P, n_modes * 2) costs, order [(m0,F),(m0,T),(m1,F),..].
    """
    import jax.numpy as jnp

    size_id = I.mip_size_id(w, h)
    bdry = 2 if size_id == 0 else 4
    red = 4 if size_id < 2 else 8
    input_size = 2 * bdry
    up_h, up_v = w // red, h // red
    maxv = (1 << bit_depth) - 1
    t1 = tu[:, 1 : w + 1]
    l1 = lu[:, 1 : h + 1]

    def dsmp(full, n):
        ln = full.shape[1]
        if n < ln:
            fct = ln // n
            lf = I.floor_log2(fct)
            return (full.reshape(full.shape[0], n, fct).sum(axis=2)
                    + (1 << (lf - 1))) >> lf
        return full[:, :n]

    tr_red = dsmp(t1, bdry)
    lr_red = dsmp(l1, bdry)
    P = tu.shape[0]
    half = 1 << (bit_depth - 1)
    reds = []
    offs = []
    for trp in (False, True):
        parts = [lr_red, tr_red] if trp else [tr_red, lr_red]
        r = jnp.concatenate(parts, axis=1)
        off0 = r[:, 0]
        r = r - off0[:, None]
        first = (half - off0) if size_id < 2 else jnp.zeros_like(off0)
        r = jnp.concatenate([first[:, None], r[:, 1:]], axis=1)
        reds.append(r)
        offs.append(off0)
    inp = jnp.stack(reds, axis=1)  # (P, 2, input_size)
    ioff = jnp.stack(offs, axis=1)  # (P, 2)
    # adjusted weight tensor (host): (modes, red*red, input_size)
    mat = rom.mip_matrix(size_id).astype(np.int64)
    n_modes = mat.shape[0]
    wadj = np.zeros((n_modes, red * red, input_size), dtype=np.int64)
    for mi in range(n_modes):
        wflat = mat[mi].ravel()
        wpos = 0
        for pos in range(red * red):
            if size_id == 2:
                wpos -= 1
            for i in range(0 if size_id != 2 else 1, input_size):
                wadj[mi, pos, i] = wflat[wpos + i]
            wpos += input_size
    s = inp.sum(axis=2)  # (P, 2)
    offset = (1 << (I.MIP_SHIFT_MATRIX - 1)) - I.MIP_OFFSET_MATRIX * s
    acc = jnp.einsum("pti,moi->ptmo", inp, jnp.asarray(wadj))
    res = jnp.clip(((acc + offset[:, :, None, None]) >> I.MIP_SHIFT_MATRIX)
                   + ioff[:, :, None, None], 0, maxv)
    res = res.reshape(P, 2, n_modes, red, red)
    res = jnp.stack([res[:, 0], jnp.swapaxes(res[:, 1], -1, -2)], axis=1)
    # upsampling (predictionUpsampling1D: horizontal on the reduced rows
    # with the original left column as "before" boundary, then vertical
    # with the original top row)
    if up_h > 1:
        lf = I.floor_log2(up_h)
        off = 1 << (lf - 1)
        k = np.arange(w) // up_h
        pos = np.arange(w) % up_h
        # boundary per reduced row r: left[(r+1)*up_v - 1]
        bsel = (np.arange(red) + 1) * up_v - 1
        before_b = l1[:, bsel][:, None, None, :, None]  # (P,1,1,red,1)
        prev = jnp.concatenate(
            [jnp.broadcast_to(before_b, res[..., :1].shape), res[..., :-1]],
            axis=-1)
        before = prev[..., k]
        behind = res[..., k]
        res = ((before * (up_h - 1 - pos) + behind * (pos + 1) + off) >> lf)
    if up_v > 1:
        lf = I.floor_log2(up_v)
        off = 1 << (lf - 1)
        k = np.arange(h) // up_v
        pos = np.arange(h) % up_v
        bnd_row = t1[:, None, None, None, :]  # (P,1,1,1,w)
        prev = jnp.concatenate(
            [jnp.broadcast_to(bnd_row, res[..., :1, :].shape),
             res[..., :-1, :]], axis=-2)
        before = prev[..., k, :]
        behind = res[..., k, :]
        res = ((before * (up_v - 1 - pos)[:, None]
                + behind * (pos + 1)[:, None] + off) >> lf)
    # res: (P, 2, M, h, w)
    d = (res - src[:, None, None]).astype(jnp.int32)
    c = rdcost.satd_batch_jax(d, h, w)  # (P, 2, M)
    return jnp.swapaxes(c, 1, 2).reshape(P, n_modes * 2)


def _make_class_fn(w: int, h: int, bit_depth: int, with_mip: bool):
    """Build the jitted cost function for one (w, h) class.

    fn(srcpad, xs, ys, *consts) -> (ang (P, 67), mip (P, n_mip*2)) costs,
    ang ordered by mode index 0..66.  `consts` are the per-class constant
    matrices (host list returned alongside; upload once per device via
    _device_consts).

    Default path: matmul formulation (see matmul_tables).  The 64x64
    class keeps the gather formulation — its constant matrix would be
    ~0.5 GB while its position count is tiny.
    """
    import jax
    import jax.numpy as jnp

    tabs = class_tables(w, h, bit_depth)
    maxv = (1 << bit_depth) - 1
    use_matmul = not (w == 64 and h == 64)
    mm = matmul_tables(w, h, bit_depth) if use_matmul else None
    HI = jax.lax.Precision.HIGHEST

    consts: list = []
    cidx: dict = {}
    if use_matmul:
        for gname in ("ver", "hor"):
            g = mm.get(gname)
            if g is None:
                continue
            cidx[gname] = len(consts)
            consts.append(g["W"])
            if g["any_pdpc"]:
                cidx[gname + "_side"] = len(consts)
                consts.append(g["Ws"])

    # column order of the returned cost matrix: [0,1,18,50] + ver modes +
    # hor modes (+ mip); the host reorders via mode_order (XLA scatters
    # from .at[].set compile poorly — avoid them on device)
    mode_order = [0, 1, 18, 50]
    for gname in ("ver", "hor"):
        g = (mm if use_matmul else tabs).get(gname)
        if g is not None:
            mode_order.extend(g["modes"])

    def fn(srcpad, xs, ys, *cdev):
        iw = np.arange(2 * w + 1)
        ihh = np.arange(2 * h + 1)
        tu = srcpad[ys[:, None], xs[:, None] + iw[None, :]].astype(jnp.int32)
        lu = srcpad[ys[:, None] + ihh[None, :], xs[:, None]].astype(jnp.int32)
        tf, lf = _filter_refs_jnp(tu, lu, w, h)
        zero = jnp.zeros((tu.shape[0], 1), jnp.int32)
        C = jnp.concatenate([tu, lu, tf, lf, zero], axis=1)
        src = srcpad[ys[:, None, None] + 1 + np.arange(h)[None, :, None],
                     xs[:, None, None] + 1 + np.arange(w)[None, None, :]
                     ].astype(jnp.int32)
        P = tu.shape[0]
        cols = [_planar_dc_jnp(tu, lu, tf, lf, src, w, h, maxv)]
        Cf = C.astype(jnp.float32)
        for gname in ("ver", "hor"):
            g = (mm if use_matmul else tabs).get(gname)
            if g is None:
                continue
            is_ver = gname == "ver"
            dh, dw = (h, w) if is_ver else (w, h)
            if use_matmul:
                M = len(g["modes"])
                Wd = cdev[cidx[gname]]
                acc = jnp.einsum("pc,mck->pmk", Cf, Wd,
                                 precision=HI).astype(jnp.int32)
                acc = acc.reshape(P, M, dh, dw)
                pred = jnp.clip((acc + 32) >> 6, 0, maxv)
                if g["any_pdpc"]:
                    nx = g["nxmax"]
                    Wsd = cdev[cidx[gname + "_side"]]
                    side = jnp.einsum("pc,mcyx->pmyx", Cf, Wsd,
                                      precision=HI).astype(jnp.int32)
                    wl = jnp.asarray(g["wl"])  # (M, nx)
                    pn = pred[:, :, :, :nx]
                    adj = pn + ((wl[None, :, None, :] * (side - pn) + 32) >> 6)
                    pred = jnp.concatenate([adj, pred[:, :, :, nx:]], axis=3)
            else:
                RM = C[:, jnp.asarray(g["sym"])]  # (P, M, L)
                gi = jnp.asarray(g["gi"])  # (M, dh, dw)
                M = gi.shape[0]
                f = jnp.asarray(g["f"])  # (M, dh, 4)
                acc = jnp.zeros((P, M, dh, dw), jnp.int32)
                for t in range(4):
                    g_idx = (gi + t).reshape(M, dh * dw)[None].astype(jnp.int32)
                    v = jnp.take_along_axis(
                        RM, jnp.broadcast_to(g_idx, (P, M, dh * dw)), axis=2)
                    v = v.reshape(P, M, dh, dw)
                    acc = acc + f[None, :, :, None, t].astype(jnp.int32) * v
                pred = jnp.clip((acc + 32) >> 6, 0, maxv)
                RS = C[:, jnp.asarray(g["rs"])]  # (P, M, LS)
                sx = jnp.asarray(g["sidx"]).reshape(M, dh * dw)[None].astype(jnp.int32)
                side = jnp.take_along_axis(
                    RS, jnp.broadcast_to(sx, (P, M, dh * dw)), axis=2
                ).reshape(P, M, dh, dw)
                wl = jnp.asarray(g["wl"]).astype(jnp.int32)  # (M, dw)
                pred = pred + ((wl[None, :, None, :] * (side - pred) + 32) >> 6)
            cmp_src = src if is_ver else jnp.swapaxes(src, -1, -2)
            d = (pred - cmp_src[:, None]).astype(jnp.int32)
            cc = rdcost.satd_batch_jax(d, dh, dw)  # (P, M)
            cols.append(cc.astype(jnp.int32))
        if with_mip:
            cols.append(_mip_jnp(tu, lu, src, w, h, bit_depth))
        out = jnp.concatenate(cols, axis=1)
        # fused per-position reduction (fetched instead of the full
        # tensor): min/argmin over angular modes, planar, min/argmin MIP
        ang = out[:, :67]
        red = [jnp.min(ang, axis=1), jnp.argmin(ang, axis=1).astype(
            jnp.int32), ang[:, 0]]  # native col 0 == planar (mode_order)
        if with_mip:
            red += [jnp.min(out[:, 67:], axis=1),
                    jnp.argmin(out[:, 67:], axis=1).astype(jnp.int32)]
        else:
            red += [jnp.full((P,), np.int32(2 ** 30), jnp.int32),
                    jnp.zeros((P,), jnp.int32)]
        return out, jnp.stack(red, axis=1)

    return jax.jit(fn), consts, np.array(mode_order)


def class_fn(w: int, h: int, bit_depth: int, with_mip: bool):
    """-> (jitted fn, host constants, mode_order). Cached per class."""
    key = (w, h, bit_depth, with_mip)
    f = _JIT_CACHE.get(key)
    if f is None:
        f = _make_class_fn(w, h, bit_depth, with_mip)
        _JIT_CACHE[key] = f
    return f


# ---------------------------------------------------------------------------
# frame-level driver


def _class_strides(w: int, h: int):
    def stride(d):
        if d <= 8:
            return 4
        if d <= 16:
            return 8
        return d  # 32/64-wide blocks sit at their own alignment

    return stride(w), stride(h)


def intra_class_list(cfg) -> list[tuple[int, int]]:
    """Size classes reachable by the intra partitioner (QT to 8 + <=2 MTT
    levels, min CU 4, max BT/TT 32)."""
    classes = []
    for lw in range(2, cfg.log2_ctu_size + 1):
        for lh in range(2, cfg.log2_ctu_size + 1):
            w, hh = 1 << lw, 1 << lh
            if w == hh:
                classes.append((w, hh))
            else:
                if max(w, hh) <= (1 << cfg.log2_max_bt_intra) * 2 and \
                        cfg.max_mtt_depth_intra > 0:
                    # rects need at least one MTT split from a square
                    if max(w, hh) // min(w, hh) <= 8 and max(w, hh) <= 32:
                        classes.append((w, hh))
    return classes


class FrameRMD:
    """Per-frame RMD cost tables.

    All class kernels are dispatched asynchronously at construction on
    JAX's default device; the host fetches only the per-position
    reductions, in one batched device->host transfer per frame.
    """

    def __init__(self, src_y: np.ndarray, cfg, lam_sqrt: float):
        self.cfg = cfg
        self.bit_depth = cfg.bit_depth
        h, w = src_y.shape
        self.pic_w, self.pic_h = w, h
        pad_r = 2 * 64 + 2
        srcpad = np.pad(src_y.astype(np.int32), ((1, pad_r), (1, pad_r)),
                        mode="edge")
        self._build(srcpad, cfg)

    def _build(self, srcpad, cfg):
        from concurrent.futures import ThreadPoolExecutor

        import jax.numpy as jnp

        sp = jnp.asarray(srcpad)
        self._classes = {}
        self._flat = None
        w, h = self.pic_w, self.pic_h
        jobs = []
        for (cw, ch) in intra_class_list(cfg):
            if cw > w or ch > h:
                continue
            sx, sy = _class_strides(cw, ch)
            xs = np.arange(0, w - cw + 1, sx, dtype=np.int32)
            ys = np.arange(0, h - ch + 1, sy, dtype=np.int32)
            if len(xs) == 0 or len(ys) == 0:
                continue
            gx, gy = np.meshgrid(xs, ys)
            jobs.append((cw, ch, gx.ravel(), gy.ravel()))

        def dispatch(job):
            cw, ch, fx, fy = job
            with_mip = bool(cfg.mip) and cw <= 64 and ch <= 64
            key = (cw, ch, self.bit_depth, with_mip)
            fn, consts, mode_order = class_fn(cw, ch, self.bit_depth,
                                              with_mip)
            cdev = _device_consts(key, consts)
            # pad the position count to a power-of-two bucket so the
            # compiled kernel is shared across frame geometries (XLA
            # compiles per shape; tests/production use many resolutions)
            p = len(fx)
            cap = max(8, 1 << (p - 1).bit_length())
            fxp = np.concatenate([fx, np.zeros(cap - p, np.int32)])
            fyp = np.concatenate([fy, np.zeros(cap - p, np.int32)])
            out, red = fn(sp, jnp.asarray(fxp), jnp.asarray(fyp), *cdev)
            return out, red, mode_order

        # dispatch concurrently: first-use XLA compiles of the class
        # kernels overlap instead of serializing.  On an H100 (400 W) the
        # first 1080p build took 21.8 s this way against 62.7 s serially;
        # warm builds took 0.9-1.0 s against 0.8-0.9 s (two samples each)
        with ThreadPoolExecutor(max_workers=8) as ex:
            results = list(ex.map(dispatch, jobs))
        # the full (P, modes) tensors STAY on the device; only the fused
        # per-position reductions are fetched (one batched device_get),
        # and full rows are gathered per chosen leaf afterwards — cutting
        # host readback ~14x and keeping per-frame syncs at 2
        self._full = {}
        self._red_dev = {}
        self._stats = None
        self._rows: dict = {}
        for (cw, ch, fx, fy), (out, red, mode_order) in zip(jobs, results):
            idx = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(fx, fy))}
            p = len(fx)
            ncols = int(out.shape[1])
            nm = ncols - 67
            # perm[mode] = column of mode in the kernel's native order
            perm = np.empty(67, np.int64)
            perm[mode_order] = np.arange(67)
            self._classes[(cw, ch)] = (idx, p, ncols, nm, perm,
                                       np.asarray(mode_order))
            self._full[(cw, ch)] = out
            self._red_dev[(cw, ch)] = red

    def _force_reduced(self):
        if self._stats is None:
            import jax

            keys = list(self._red_dev)
            vals = jax.device_get([self._red_dev[k] for k in keys])
            self._stats = {}
            for k, red in zip(keys, vals):
                idx, p, ncols, nm, perm, mode_order = self._classes[k]
                red = red[:p]
                self._stats[k] = (red[:, 0], mode_order[red[:, 1]],
                                  red[:, 2],
                                  red[:, 3] if nm else None, red[:, 4])
            self._red_dev = {}
        return self._stats

    def stats(self, x: int, y: int, w: int, h: int):
        """Per-position summary (min_ang, best_mode, planar, min_mip,
        mip_idx) from the reduced device fetch, or None."""
        entry = self._classes.get((w, h))
        if entry is None:
            return None
        i = entry[0].get((x, y))
        if i is None:
            return None
        s = self._force_reduced()[(w, h)]
        return (int(s[0][i]), int(s[1][i]), int(s[2][i]),
                int(s[3][i]) if s[3] is not None else None, int(s[4][i]))

    def prefetch_rows(self, reqs):
        """Gather the FULL mode-cost rows of the given (x, y, w, h) leaf
        positions (one device gather per class, one batched fetch);
        subsequent costs() calls for them are host-local."""
        if not self._full or not reqs:
            return
        import jax

        per_class: dict = {}
        for (x, y, w, h) in reqs:
            entry = self._classes.get((w, h))
            if entry is None:
                continue
            i = entry[0].get((x, y))
            if i is None or (x, y, w, h) in self._rows:
                continue
            per_class.setdefault((w, h), []).append(((x, y, w, h), i))
        if not per_class:
            return
        gathers = []
        for k, lst in per_class.items():
            ridx = np.array([i for _, i in lst], np.int32)
            gathers.append(self._full[k][ridx])
        for (k, lst), rows in zip(per_class.items(),
                                  jax.device_get(gathers)):
            perm = self._classes[k][4]
            for (key, _), row in zip(lst, rows):
                self._rows[key] = (row[perm], row[67:])

    def _force(self):
        if self._flat is None and self._full:
            import jax

            keys = list(self._full)
            self._flat = dict(zip(keys, jax.device_get(
                [self._full[k] for k in keys])))
        return self._flat

    def costs(self, x: int, y: int, w: int, h: int):
        """(angular_costs[67], mip_costs[nm*2]) numpy rows or None."""
        entry = self._classes.get((w, h))
        if entry is None:
            return None
        idx, p, ncols, nm, perm = entry[:5]
        i = idx.get((x, y))
        if i is None:
            return None
        hit = self._rows.get((x, y, w, h)) if hasattr(self, "_rows") else None
        if hit is not None:
            return hit
        row = self._force()[(w, h)][i]
        return row[perm], row[67:]
