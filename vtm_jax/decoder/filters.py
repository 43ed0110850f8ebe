"""In-loop filter chain for the decoder (DecLib::executeLoopFilters:596).

Order: LMCS inverse luma mapping → deblocking → SAO → ALF / CC-ALF.
Sample math lives in vtm_jax.ops; this module sequences the stages using
the per-picture state captured during slice decode.
"""

from __future__ import annotations

import numpy as np

# opt-in capture of per-picture filter inputs (used by the multi-chip
# sharded-filter dryrun to replay the exact same maps across a mesh)
CAPTURE_FILTERS = False


def apply_loop_filters(dec, pic) -> None:
    if not hasattr(pic, "dcs"):
        return
    if CAPTURE_FILTERS and not hasattr(pic, "filter_capture"):
        pic.filter_capture = {}
    dcs = pic.dcs
    # all filter parameters are sample-independent: build every stage's
    # maps first, then run LMCS→deblock→SAO→ALF as ONE device dispatch
    # (ops/filter_chain.py) so the planes cross host↔device once
    lmcs = getattr(pic, "lmcs_model", None)
    lmcs_lut = None
    if lmcs is not None and any(sl.lmcs_enabled for sl in pic.slices):
        lmcs_lut = lmcs.inv_lut
    from vtm_jax.ops import deblock as DB

    dmaps = None
    if any(not sl.deblocking_disable for sl in pic.slices):
        dmaps = DB.build_pic_maps(dcs, pic)
    sao_maps = None
    if dcs.sps.sao and any(sl.sao_enabled[0] or sl.sao_enabled[1] for sl in pic.slices):
        from vtm_jax.ops import sao as SAO

        sao_maps = SAO.build_sao_maps(dcs, pic)
    alf_tables = None
    if dcs.sps.alf and any(sl.alf_enabled[0] or sl.alf_enabled[1] or sl.alf_enabled[2]
                           or sl.ccalf_cb_enabled or sl.ccalf_cr_enabled
                           for sl in pic.slices):
        from vtm_jax.ops import alf as ALF

        alf_tables = ALF.build_alf_tables(dcs, pic)
    from vtm_jax.ops.filter_chain import run_filter_chain

    fmt = dcs.chroma_format
    run_filter_chain(pic, pic.planes, lmcs_lut, dmaps, sao_maps, alf_tables,
                     dcs.sps.bit_depth, fmt.scale_x, fmt.scale_y)
    # DMVR-refined MVs into the motion field for TMVP
    # (DecLib::executeLoopFilters → setRefinedMotionField, DecLib.cpp:629)
    if hasattr(dcs, "mf_mv"):
        for cu in dcs.cus:
            mvd_info = getattr(cu, "_dmvr_mvd", None)
            if mvd_info is None:
                continue
            mvd_sub, sdx, sdy = mvd_info
            b = cu.blocks[0]
            for (sy, sx), mvd in mvd_sub.items():
                y0 = (b.y + sy * sdy) >> 2
                x0 = (b.x + sx * sdx) >> 2
                ys = slice(y0, y0 + (sdy >> 2))
                xs = slice(x0, x0 + (sdx >> 2))
                from vtm_jax.decoder import motion as M

                mv0 = M.clip_storage((cu.mv[0][0] + mvd[0], cu.mv[0][1] + mvd[1]))
                mv1 = M.clip_storage((cu.mv[1][0] - mvd[0], cu.mv[1][1] - mvd[1]))
                dcs.mf_mv[ys, xs, 0, 0] = mv0[0]
                dcs.mf_mv[ys, xs, 0, 1] = mv0[1]
                dcs.mf_mv[ys, xs, 1, 0] = mv1[0]
                dcs.mf_mv[ys, xs, 1, 1] = mv1[1]
    cap = getattr(pic, "filter_capture", None)
    if cap is not None:
        cap["luma_out"] = pic.planes[0].copy()
