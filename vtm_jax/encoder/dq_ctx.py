"""Context-aware dependent quantization (encoder side).

Python orchestration for the batched TCQ scan (encoder/tcq_scan.py
design; native twin native/tcq.c) — the behavioral counterpart of the
reference dependent quantizer (DepQuant.cpp:806-1008, contract only):
per-TU rate tables are computed from the LIVE CABAC estimator contexts
(sig/par/gt1/gt2/sbb flags and last-position prefixes), neighbor-
template geometry tables are cached per block size, and the trellis
prices every candidate level with the real fractional bits the final
CABAC pass will pay.

Replaces the context-free 4-state rate model (quant.quant_dep) on the
luma/chroma regular residual path; reconstruction still goes through
the normative quant.dequant_dep, so any level choice is conformant.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from vtm_jax.common import rom
from vtm_jax.encoder.bin_encoder import _FRAC_BITS

QUANT_SHIFT = 14
IQUANT_SHIFT = 6
SCALE_BITS = 15
_GROUP_IDX = np.array(
    [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7] + [8] * 8 + [9] * 8
    + [10] * 16 + [11] * 16, dtype=np.int64)
_MIN_IN_GROUP = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96]

_NATIVE = None
_TABLES: dict = {}  # (lineage, epoch, ch, w, h, cbf_delta) -> rate tables


class _RateCtx:
    """Static context-id bases per (w, h, comp) — the subset of CoeffCtx
    the DQ rate tables need (cheap, cacheable; CoeffCtx itself carries
    per-TU mutable coding state and costs too much to rebuild per TU)."""

    def __init__(self, w: int, h: int, comp: int):
        from vtm_jax.decoder.cabac_reader import _CTXOFF

        ch = 0 if comp == 0 else 1
        self.ch = ch
        self.width, self.height = w, h
        log2w, log2h = floor_log2(w), floor_log2(h)
        if ch == 1:
            self.last_offset_x = self.last_offset_y = 0
            self.last_shift_x = min(max(0, w >> 3), 2)
            self.last_shift_y = min(max(0, h >> 3), 2)
        else:
            prefix_ctx = [0, 0, 0, 3, 6, 10, 15, 21]
            self.last_offset_x = prefix_ctx[log2w]
            self.last_offset_y = prefix_ctx[log2h]
            self.last_shift_x = (log2w + 1) >> 2
            self.last_shift_y = (log2h + 1) >> 2
        self.ctx_last_x = _CTXOFF[f"LastX_{ch}"][0]
        self.ctx_last_y = _CTXOFF[f"LastY_{ch}"][0]
        self.sig_flag_sets = [_CTXOFF[f"SigFlag_{ch}"][0],
                              _CTXOFF[f"SigFlag_{ch + 2}"][0],
                              _CTXOFF[f"SigFlag_{ch + 4}"][0]]
        self.par_flag_set = _CTXOFF[f"ParFlag_{ch}"][0]
        self.gtx_flag_sets = [_CTXOFF[f"GtxFlag_{ch}"][0],
                              _CTXOFF[f"GtxFlag_{ch + 2}"][0]]
        self.sig_cg_set = _CTXOFF[f"SigCoeffGroup_{ch}"][0]


@functools.lru_cache(maxsize=None)
def rate_ctx(w: int, h: int, comp: int) -> _RateCtx:
    return _RateCtx(w, h, comp)


def _native():
    global _NATIVE
    if _NATIVE is None:
        from vtm_jax import native

        _NATIVE = native.load_tcq() or False
    return _NATIVE


def floor_log2(x: int) -> int:
    return x.bit_length() - 1


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


@functools.lru_cache(maxsize=None)
def _dq_geom(w: int, h: int):
    """Scan + neighbor-template geometry for the trellis (TUParameters /
    Rom NbInfoSbb/NbInfoOut analogue, DepQuant.cpp:175-295)."""
    log2w, log2h = floor_log2(w), floor_log2(h)
    cgw_l2, cgh_l2 = rom.log2_sbb_size(log2w, log2h)
    gsize_l2 = cgw_l2 + cgh_l2
    gsize = 1 << gsize_l2
    scan = rom.scan(1, w, h)  # (N,3): rasterpos, x, y
    w_nz, h_nz = min(32, w), min(32, h)
    # clip to the non-zero-out region (Rom.cpp:327 builds the grouped
    # scan over min(32, dim) only; our dumped table covers the full
    # block — filtering preserves the diag CG order over the NZ grid)
    keep = (scan[:, 1] < w_nz) & (scan[:, 2] < h_nz)
    scan = scan[keep]
    n = len(scan)
    r2id = {}
    for sid in range(n):
        r2id[int(scan[sid][0])] = sid
    sx = np.ascontiguousarray(scan[:, 1], dtype=np.int32)
    sy = np.ascontiguousarray(scan[:, 2], dtype=np.int32)
    nbs_num = np.zeros(n, np.int8)
    nbs = np.zeros((n, 5), np.int32)
    nbo_num = np.zeros(n, np.int8)
    nbo = np.zeros((n, 5), np.int32)
    for sid in range(n):
        x, y = int(sx[sid]), int(sy[sid])
        beg = sid - (sid & (gsize - 1))
        cand = []
        for dx, dy in ((1, 0), (2, 0), (1, 1), (0, 1), (0, 2)):
            nx_, ny_ = x + dx, y + dy
            if nx_ < w_nz and ny_ < h_nz:
                cand.append(r2id[ny_ * w + nx_])
        ins = sorted(c - beg for c in cand if c < beg + gsize)
        outs = sorted(c for c in cand if c >= beg + gsize)
        nbs_num[sid] = len(ins)
        nbs[sid, : len(ins)] = ins
        nbo_num[sid] = len(outs)
        nbo[sid, : len(outs)] = outs
    wig = w_nz >> cgw_l2
    hig = h_nz >> cgh_l2
    scan_cg = rom.scan(0, wig, hig)
    sbbpos = np.ascontiguousarray(scan_cg[:, 0], dtype=np.int32)
    raster = np.ascontiguousarray(scan[:, 0], dtype=np.int64)
    return dict(n=n, gsize_l2=gsize_l2, wig=wig, sx=sx, sy=sy,
                nbs_num=nbs_num, nbs=np.ascontiguousarray(nbs),
                nbo_num=nbo_num, nbo=np.ascontiguousarray(nbo),
                sbbpos=sbbpos, raster=raster)


def _fb_many(ctx, ids: np.ndarray) -> np.ndarray:
    """(n, 2) fractional bits for an array of ctx ids (vectorized)."""
    states = (ctx.state0[ids].astype(np.int64) + ctx.state1[ids]) >> 8
    return _FRAC_BITS[states]


def build_rate_tables(ctx, cctx):
    """(sig+sbb int32, gtx int32) from the live contexts.

    sig layout: [3 sets][12 ctx][2 bins] then sigSbb [2][2] appended.
    gtx layout: [21 ctx][6] per RateEstimator::xSetGtxFlagBits.
    """
    ch = cctx.ch
    nsig = 12 if ch == 0 else 8
    sig = np.zeros((3 * 12 + 2, 2), np.int32)
    rng = np.arange(nsig)
    for st in range(3):
        sig[st * 12 : st * 12 + nsig] = _fb_many(
            ctx, cctx.sig_flag_sets[st] + rng)
    sig[36:38] = _fb_many(ctx, cctx.sig_cg_set + np.arange(2))
    ngtx = 21 if ch == 0 else 11
    gtx = np.zeros((21, 6), np.int32)
    one = 1 << SCALE_BITS
    g = np.arange(ngtx)
    par = _fb_many(ctx, cctx.par_flag_set + g)
    gt1 = _fb_many(ctx, cctx.gtx_flag_sets[1] + g)
    gt2 = _fb_many(ctx, cctx.gtx_flag_sets[0] + g)
    gtx[:ngtx, 1] = gt1[:, 0] + one
    gtx[:ngtx, 2] = gt1[:, 1] + (one + par[:, 0]) + gt2[:, 0]
    gtx[:ngtx, 3] = gt1[:, 1] + (one + par[:, 1]) + gt2[:, 0]
    gtx[:ngtx, 4] = gt1[:, 1] + (one + par[:, 0]) + gt2[:, 1]
    gtx[:ngtx, 5] = gt1[:, 1] + (one + par[:, 1]) + gt2[:, 1]
    return np.ascontiguousarray(sig), np.ascontiguousarray(gtx)


def build_last_bits(ctx, cctx, geom, cbf_delta_bits: int = 0):
    """lastOffset per scanId (RateEstimator::xSetLastCoeffOffset)."""
    out = np.zeros(geom["n"], np.int32)
    lb = []
    for xy in range(2):
        size = cctx.height if xy else cctx.width
        if xy:
            ctx_base = cctx.ctx_last_y
            off, shift = cctx.last_offset_y, cctx.last_shift_y
            bit_off = cbf_delta_bits
        else:
            ctx_base = cctx.ctx_last_x
            off, shift = cctx.last_offset_x, cctx.last_shift_x
            bit_off = 0
        max_ctx = int(_GROUP_IDX[min(32, size) - 1])
        cids = np.arange(max_ctx)
        fb = _fb_many(ctx, ctx_base + off + (cids >> shift))
        ep = np.where(cids > 3, ((cids - 2) >> 1) << SCALE_BITS, 0)
        cum1 = np.concatenate([[0], np.cumsum(fb[:, 1])])
        ctx_bits = np.empty(max_ctx + 1, np.int64)
        ctx_bits[:max_ctx] = cum1[:max_ctx] + fb[:, 0] + ep + bit_off
        ctx_bits[max_ctx] = cum1[max_ctx] + (
            ((max_ctx - 2) >> 1) << SCALE_BITS if max_ctx > 3 else 0) + bit_off
        lb.append(ctx_bits[_GROUP_IDX[: min(32, size)]])
    out[:] = lb[0][geom["sx"]] + lb[1][geom["sy"]]
    return np.ascontiguousarray(out)


def quant_dep_ctx(coeff: np.ndarray, qp: tuple, bit_depth: int, lam: float,
                  cctx, est, eff_w: int | None = None,
                  eff_h: int | None = None, lfnst_idx: int = 0,
                  cbf_delta_bits: int = 0):
    """Context-aware TCQ for one TU component; returns int32 levels (h,w)
    or None when the native trellis is unavailable."""
    nat = _native()
    if not nat:
        return None
    h, w = coeff.shape
    geom = _dq_geom(w, h)
    n = geom["n"]
    # ---- quantizer parameters (Quantizer::initQuantBlock) ----
    max_range = 15
    qp_dq = qp[0] + 1
    qp_per, qp_rem = qp_dq // 6, qp_dq % 6
    log2w, log2h = floor_log2(w), floor_log2(h)
    nom_tshift = max_range - bit_depth - ((log2w + log2h) >> 1)
    needs_sqrt2 = ((log2w + log2h) & 1) == 1
    tshift = nom_tshift + (-1 if needs_sqrt2 else 0)
    q_shift = QUANT_SHIFT - 1 + qp_per + tshift
    q_add = -((3 << q_shift) >> 1)
    q_scale = int(rom.quant_scale(qp_rem, needs_sqrt2))
    inv_shift = IQUANT_SHIFT + 1 - qp_per - tshift
    q_idx_bd = min(max_range + 1, 64 + inv_shift - IQUANT_SHIFT - 1)
    max_q_idx = (1 << (q_idx_bd - 1)) - 4
    nom_d_shift = (SCALE_BITS - 2 * nom_tshift + q_shift
                   + (1 if needs_sqrt2 else 0))
    q_scale2 = float(q_scale * q_scale)
    if nom_d_shift < 0:
        nom_dist_factor = 1.0 / (float(1 << -nom_d_shift) * q_scale2 * lam)
    else:
        nom_dist_factor = float(1 << nom_d_shift) / (q_scale2 * lam)
    df_shift = _ceil_log2(int(nom_dist_factor * q_scale2) + 1)
    dist_shift = 62 + q_shift - 2 * max_range - df_shift
    dist_add = (1 << dist_shift) >> 1
    dist_step_add = int(nom_dist_factor * float(1 << (dist_shift + q_shift))
                        + 0.5)
    dist_org_fact = int(nom_dist_factor * float(1 << (dist_shift + 1)) + 0.5)
    # ---- per-position data ----
    flat = coeff.ravel().astype(np.int64)
    absc = np.abs(flat[geom["raster"]])
    zero = np.zeros(n, np.uint8)
    if eff_w is not None and eff_w < w:
        zero |= (geom["sx"] >= eff_w).astype(np.uint8)
    if eff_h is not None and eff_h < h:
        zero |= (geom["sy"] >= eff_h).astype(np.uint8)
    first_cap = n
    if lfnst_idx > 0 and w >= 4 and h >= 4:
        first_cap = 8 if ((w == 4 and h == 4) or (w == 8 and h == 8)) else 16
    # rate tables depend only on the estimator ctx state and TU shape;
    # frac_bits is a monotone version counter for the ctx.  Quantized to
    # ~128-bit epochs: context probabilities drift slowly (dual-rate
    # adaptation), so refreshing the trellis rate tables every ~128 coded
    # bits loses nothing measurable and cuts table builds ~50x.  The
    # cache is module-global keyed by estimator LINEAGE (not object id):
    # RD branches copy the estimator per candidate, and all copies within
    # an epoch share tables.
    ck = (est.lineage, est.frac_bits >> 22, cctx.ch, w, h, cbf_delta_bits)
    hit = _TABLES.get(ck)
    if hit is not None:
        sig, gtx, last = hit
    else:
        sig, gtx = build_rate_tables(est.ctx, cctx)
        last = build_last_bits(est.ctx, cctx, geom, cbf_delta_bits)
        if len(_TABLES) > 768:
            _TABLES.clear()
        _TABLES[ck] = (sig, gtx, last)
    init_rem_reg = (min(32, eff_w or w) * min(32, eff_h or h) * 28) >> 4
    lev = np.zeros((1, n), np.int32)
    nat.tcq_run(
        np.ascontiguousarray(absc[None, :]), lev, 1, n, int(first_cap),
        geom["gsize_l2"], geom["wig"], geom["sbbpos"], geom["sx"],
        geom["sy"], geom["nbs_num"], geom["nbs"], geom["nbo_num"],
        geom["nbo"], zero,
        np.ascontiguousarray(last[None, :].astype(np.int64)),
        np.ascontiguousarray(sig[None]), np.ascontiguousarray(gtx[None]),
        0 if cctx.ch else 1, int(init_rem_reg),
        int(q_add), int(max_q_idx), int(q_scale), int(dist_step_add),
        int(dist_org_fact), int(dist_add), int(q_shift), int(dist_shift))
    lev = lev[0]
    out = np.zeros(w * h, np.int64)
    out[geom["raster"]] = np.where(flat[geom["raster"]] < 0, -lev, lev)
    return out.reshape(h, w).astype(np.int32)
