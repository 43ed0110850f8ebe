"""Whole-picture in-loop filter chain as ONE device dispatch.

DecLib::executeLoopFilters order (DecLib.cpp:596): LMCS inverse luma
mapping → deblocking (VER, HOR) → SAO → ALF/CC-ALF.  Every stage's
parameters are sample-independent (built on host from parse state), so the
full chain fuses into a single jit call per picture: the reconstruction
planes cross the host↔device boundary exactly once in each direction.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def chain_body(y, cb, cr, lmcs_lut, dbv, dbh, sao, alf,
               bd: int, sx: int, sy: int, fl: tuple):
    """Un-jitted chain body — also vmapped/shard_mapped by
    parallel/pic_shard for the gop-axis data-parallel dryrun."""
    from vtm_jax.ops import alf_kernel as AK
    from vtm_jax.ops import deblock_kernel as DK
    from vtm_jax.ops import sao_kernel as SK

    (f_lmcs, dvl, dvcb, dvcr, dhl, dhcb, dhcr,
     s0, s1, s2, a_l, a_cb, a_cr, a_cc1, a_cc2) = fl
    if f_lmcs:
        y = lmcs_lut[y]
    if dvl or dvcb or dvcr:
        y, cb, cr = DK.deblock_dir(
            y, cb, cr, *dbv, bit_depth=bd, hor=False,
            has_l=dvl, has_cb=dvcb, has_cr=dvcr, sx=sx, sy=sy)
    if dhl or dhcb or dhcr:
        y, cb, cr = DK.deblock_dir(
            y, cb, cr, *dbh, bit_depth=bd, hor=True,
            has_l=dhl, has_cb=dhcb, has_cr=dhcr, sx=sx, sy=sy)
    for flag, comp in ((s0, 0), (s1, 1), (s2, 2)):
        if flag:
            p = (y, cb, cr)[comp]
            out = SK.sao_apply(p, *sao[comp], bit_depth=bd)
            if comp == 0:
                y = out
            elif comp == 1:
                cb = out
            else:
                cr = out
    if a_l or a_cb or a_cr or a_cc1 or a_cc2:
        y_pad = jnp.pad(y, AK.PAD, mode="edge")
        y, cb, cr = AK.alf_all(
            y_pad, cb, cr, *alf, bit_depth=bd, sx=sx, sy=sy,
            has_l=a_l, has_cb=a_cb, has_cr=a_cr,
            has_cc1=a_cc1, has_cc2=a_cc2)
    # pack the three planes into ONE output so the host pays a single
    # device->host sync per picture
    return jnp.concatenate(
        [y.reshape(-1), cb.reshape(-1), cr.reshape(-1)])


_chain = partial(jax.jit, static_argnames=("bd", "sx", "sy", "fl"))(chain_body)


def run_filter_chain(pic, planes, lmcs_lut, dmaps, sao_maps, alf_tables,
                     bit_depth: int, sx: int, sy: int) -> None:
    """Assemble arguments and run the fused chain; writes planes in place.

    dmaps: [maps_ver, maps_hor] (ops/deblock.PicDeblockMaps) or None;
    sao_maps: per-comp (tmap, cmap, offsets, valid) or None;
    alf_tables: dict from ops/alf.build_alf_tables or None.
    """
    n_comp = len(planes)
    from vtm_jax.parallel import mesh as MESH

    dmesh = MESH.decode_mesh()
    if dmesh is not None:
        # live sharded path: width-shard the sample planes over the mesh's
        # 'tile' axis; the SAME jitted chain recompiles partitioned and
        # XLA/GSPMD inserts the deblock/SAO/ALF halo exchanges
        from jax.sharding import NamedSharding, PartitionSpec as PSpec

        shard = NamedSharding(dmesh, PSpec(None, "tile"))
        j = lambda a: (jax.device_put(jnp.asarray(a), shard)
                       if getattr(a, "ndim", 0) == 2
                       and a.shape[-1] >= 8 * dmesh.shape["tile"]
                       else jnp.asarray(a))
    else:
        j = jnp.asarray
    y = j(planes[0].astype(np.int32))
    cb = j(planes[1].astype(np.int32)) if n_comp > 1 else y
    cr = j(planes[2].astype(np.int32)) if n_comp > 2 else y

    def dmap_args(m):
        if m is None:
            return None, (False, False, False)
        has_l = bool(m.l_active.any())
        has_cb = n_comp > 1 and bool(m.cb_active.any())
        has_cr = n_comp > 1 and bool(m.cr_active.any())
        args = tuple(j(a) for a in (
            m.l_active, m.l_tc, m.l_beta, m.l_maxp, m.l_maxq, m.l_nop,
            m.l_noq, m.cb_active, m.cb_tc, m.cb_beta, m.cr_active, m.cr_tc,
            m.cr_beta, m.c_large, m.c_nop, m.c_noq, m.c_horctb))
        return args, (has_l, has_cb, has_cr)

    dbv, fv = dmap_args(dmaps[0] if dmaps else None)
    dbh, fh = dmap_args(dmaps[1] if dmaps else None)
    sao = [None, None, None]
    sflags = [False, False, False]
    if sao_maps:
        for c, a in enumerate(sao_maps):
            if a is not None:
                sao[c] = tuple(j(x) for x in a)
                sflags[c] = True
    alf_args = None
    aflags = (False,) * 5
    if alf_tables is not None:
        alf_args = tuple(j(a) for a in alf_tables["args"])
        aflags = (alf_tables["has_l"], alf_tables["has_cb"],
                  alf_tables["has_cr"], alf_tables["has_cc1"],
                  alf_tables["has_cc2"])
    f_lmcs = lmcs_lut is not None
    fl = (f_lmcs,) + fv + fh + tuple(sflags) + aflags
    if not any(fl):
        return
    packed_dev = _chain(
        y, cb, cr, j(lmcs_lut.astype(np.int32)) if f_lmcs else y,
        dbv, dbh, tuple(sao), alf_args,
        bd=bit_depth, sx=sx, sy=sy, fl=fl)
    cap = getattr(pic, "filter_capture", None) if pic is not None else None
    if (cap is None and pic is not None and planes is getattr(pic, "_planes", None)
            and hasattr(pic, "_pending_packed")):
        # leave the result on the device; the Picture materializes it at
        # first host use (overlaps device compute + transfer latency with
        # the next picture's parse, and device reference planes slice the
        # packed output with no round-trip)
        pic._pending_packed = packed_dev
        return
    packed = np.asarray(packed_dev)
    if cap is not None:
        # full-chain capture for the gop-axis multichip dryrun
        cap["full"] = dict(
            y=np.asarray(y), cb=np.asarray(cb), cr=np.asarray(cr),
            lmcs=(np.asarray(lmcs_lut, dtype=np.int32) if f_lmcs else None),
            dbv=None if dbv is None else tuple(np.asarray(a) for a in dbv),
            dbh=None if dbh is None else tuple(np.asarray(a) for a in dbh),
            sao=tuple(None if s is None else
                      tuple(np.asarray(x) for x in s) for s in sao),
            alf=None if alf_args is None else
            tuple(np.asarray(a) for a in alf_args),
            fl=fl, bd=bit_depth, sx=sx, sy=sy, out=packed.copy())
    ny = planes[0].size
    planes[0][:] = packed[:ny].reshape(planes[0].shape).astype(planes[0].dtype)
    if n_comp > 1:
        nc = planes[1].size
        planes[1][:] = packed[ny : ny + nc].reshape(
            planes[1].shape).astype(planes[1].dtype)
        planes[2][:] = packed[ny + nc : ny + 2 * nc].reshape(
            planes[2].shape).astype(planes[2].dtype)
