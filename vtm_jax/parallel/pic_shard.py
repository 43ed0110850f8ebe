"""Spatial (intra-picture) sharding of the codec's sample pipeline.

The (gop, tile) mesh from parallel/mesh.py carries two real axes:
  - 'gop':  frame-batch data parallelism (pictures across devices),
  - 'tile': intra-picture spatial parallelism along picture width.

This module shards the actual decoder stages over that mesh:
  - the whole-plane luma in-loop filter chain (deblock VER with an 8-column
    reference halo and a scatter-delta return exchange, deblock HOR, SAO
    with a 1-column halo, ALF classification+filtering with a 4-column
    halo) — the cross-device analogue of the reference's subpicture border
    save/restore (Picture.cpp:757-954);
  - the batched translational-MC tile kernel, sharded over the job axis.

Halos ride jax.lax.ppermute inside shard_map; picture borders replicate
edges exactly like the single-device kernels' jnp.pad(mode="edge"), so the
sharded outputs are bit-exact vs the single-device path (asserted by the
driver dryrun and tests/test_multichip.py).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def _perms(n):
    fwd = [(k, (k + 1) % n) for k in range(n)]
    bwd = [(k, (k - 1) % n) for k in range(n)]
    return fwd, bwd


def _halo_cols(x, h: int, n: int):
    """Exchange h columns with width-axis neighbours ('tile'); picture
    borders are edge-replicated.  x: [..., H, Wl] → [..., H, Wl+2h]."""
    fwd, bwd = _perms(n)
    i = jax.lax.axis_index("tile")
    left = jax.lax.ppermute(x[..., -h:], "tile", fwd)
    right = jax.lax.ppermute(x[..., :h], "tile", bwd)
    left = jnp.where(i == 0, jnp.repeat(x[..., :1], h, axis=-1), left)
    right = jnp.where(i == n - 1, jnp.repeat(x[..., -1:], h, axis=-1), right)
    return jnp.concatenate([left, x, right], axis=-1)


def make_sharded_luma_filters(mesh, have_sao: bool, have_alf: bool, bd: int):
    """Build the jitted sharded luma filter chain.

    Call signature of the returned fn (all batched over a leading frame
    axis B sharded on 'gop'; width axes sharded on 'tile'):
      x [B,H,W], dv (7 maps [B,H4,W4]), dh (7 maps [B,W4,H4], transposed),
      sao (tmap,cmap,valid [B,H,W]-class + offs [B,nctu,32]) or absent,
      alf (cperm,lperm [B,...] + ctu_of [B,H4,W4] + row tables) or absent.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from vtm_jax.ops import alf_kernel as AK
    from vtm_jax.ops import deblock_kernel as DK
    from vtm_jax.ops import sao_kernel as SK

    n_tile = mesh.shape["tile"]
    fwd, bwd = _perms(n_tile)

    sp_x = P("gop", None, "tile")
    sp_map = P("gop", None, "tile")
    sp_maph = P("gop", "tile", None)
    sp_rep = P("gop")

    in_specs = [sp_x, (sp_map,) * 7, (sp_maph,) * 7]
    if have_sao:
        in_specs.append((sp_map, sp_map, sp_rep, sp_map))
    if have_alf:
        # cperm, lperm, ctu_of, o_rows, near, y_i, yd, yu, yu2, df, dl, mult
        in_specs.append((sp_rep, sp_rep, sp_map) + (P(),) * 9)

    def step(x, dv, dh, *rest):
        rest = list(rest)
        i = jax.lax.axis_index("tile")
        # ---- deblock VER: 8-col halo, scatter-delta return exchange ----
        ext = _halo_cols(x, 8, n_tile)
        acc = jax.vmap(
            lambda p, a, t, b, mp, mq, np_, nq: DK.luma_ver_delta(
                p, a, t, b, mp, mq, np_, nq, bd)
        )(ext, *dv)
        from_left = jax.lax.ppermute(acc[..., -8:], "tile", fwd)
        from_right = jax.lax.ppermute(acc[..., :8], "tile", bwd)
        from_left = jnp.where(i == 0, 0, from_left)
        from_right = jnp.where(i == n_tile - 1, 0, from_right)
        x = x + acc[..., 8:-8]
        x = x.at[..., :8].add(from_left)
        x = x.at[..., -8:].add(from_right)
        # ---- deblock HOR: column-local after transpose ----
        xt = jnp.swapaxes(x, 1, 2)
        padh = jnp.pad(xt, ((0, 0), (0, 0), (8, 8)), mode="edge")
        acch = jax.vmap(
            lambda p, a, t, b, mp, mq, np_, nq: DK.luma_ver_delta(
                p, a, t, b, mp, mq, np_, nq, bd)
        )(padh, *dh)
        x = jnp.swapaxes(xt + acch[..., 8:-8], 1, 2)
        # ---- SAO: 1-col halo ----
        if have_sao:
            tmap, cmap, offs, valid = rest.pop(0)
            ext1 = _halo_cols(x, 1, n_tile)
            padv = jnp.pad(ext1, ((0, 0), (1, 1), (0, 0)), mode="edge")
            x = jax.vmap(
                lambda p, t, c, o, v: SK.sao_apply_ext(p, t, c, o, v, bd)
            )(padv, tmap, cmap, offs, valid)
        # ---- ALF: 4-col halo, classification + clipped diamond ----
        if have_alf:
            (cperm, lperm, ctu_of, o_rows, near,
             y_i, yd_i, yu_i, yu2_i, df, dl, mult) = rest.pop(0)
            ext4 = _halo_cols(x, 4, n_tile)
            pad4 = jnp.pad(ext4, ((0, 0), (4, 4), (0, 0)), mode="edge")

            def one(p4, cp, lp, cof):
                cls, tr = AK.classify_picture(
                    p4, y_i, yd_i, yu_i, yu2_i, df, dl, mult, bit_depth=bd)
                coef = cp[cof, cls, tr]
                clip = lp[cof, cls, tr]
                return AK.alf_filter(p4, coef, clip, o_rows, near,
                                     taps=AK.LUMA_TAPS, bit_depth=bd)

            x = jax.vmap(one)(pad4, cperm, lperm, ctu_of)
        return x

    sharded = shard_map(step, mesh=mesh, in_specs=tuple(in_specs),
                        out_specs=sp_x)
    return jax.jit(sharded)


def sharded_mc_tiles(mesh, cap):
    """Replay a captured MC tile batch sharded over the job axis across the
    whole mesh; refs replicated.  Returns the [N, tile, tile] results."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vtm_jax.ops.mc_kernel import mc_tiles

    n_dev = mesh.devices.size
    refs, r, x, y, ch, cv, fy, rnd = cap["args"]
    nb = r.shape[0]
    npad = -(-nb // n_dev) * n_dev

    def padn(a):
        out = np.zeros((npad,) + a.shape[1:], dtype=a.dtype)
        out[:nb] = a
        return out

    rep = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P(("gop", "tile")))
    args = [jax.device_put(refs, rep)] + [
        jax.device_put(padn(a), shard) for a in (r, x, y, ch, cv, fy, rnd)
    ]
    fn = jax.jit(partial(mc_tiles, taps=cap["taps"], tile=cap["tile"],
                         bd=cap["bd"]))
    out = fn(*args)
    return np.asarray(out)[:nb]


def full_chain_sig(c):
    """Static signature of a full-chain capture (groupable frames)."""
    def shp(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(shp(x) for x in v)
        return v.shape
    return (c["fl"], c["bd"], c["sx"], c["sy"], shp(c["y"]), shp(c["cb"]),
            shp(c["dbv"]), shp(c["dbh"]), shp(c["sao"]), shp(c["alf"]),
            None if c["lmcs"] is None else c["lmcs"].shape)


def run_full_chain_gop(mesh, caps):
    """Gop-axis data-parallel FULL in-loop filter chain.

    Each mesh 'gop' lane carries a DISTINCT picture's luma+chroma planes
    and filter maps; the fused LMCS-inverse -> deblock -> SAO -> ALF/
    CC-ALF chain (ops/filter_chain.chain_body) runs vmapped inside
    shard_map.  Returns the packed [B, n] outputs (host-asserted against
    each lane's single-device decode by the driver dryrun).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from vtm_jax.ops.filter_chain import chain_body

    g = mesh.shape["gop"]
    b = len(caps)
    sel = [caps[i % b] for i in range(((b + g - 1) // g) * g)]
    c0 = sel[0]
    fl, bd, sx, sy = c0["fl"], c0["bd"], c0["sx"], c0["sy"]

    def stack(key):
        v0 = c0[key]
        if v0 is None:
            return None
        if isinstance(v0, tuple):
            return tuple(
                None if e is None else
                (tuple(np.stack([c[key][i][j] for c in sel])
                       for j in range(len(e)))
                 if isinstance(e, tuple)
                 else np.stack([c[key][i] for c in sel]))
                for i, e in enumerate(v0))
        return np.stack([c[key] for c in sel])

    Y = stack("y")
    CB = stack("cb")
    CR = stack("cr")
    LM = stack("lmcs")
    DBV = stack("dbv")
    DBH = stack("dbh")
    SAO = stack("sao")
    ALF = stack("alf")
    args = (Y, CB, CR, LM if LM is not None else Y, DBV, DBH, SAO, ALF)

    def lane(y, cb, cr, lm, dbv, dbh, sao, alf):
        return jax.vmap(
            lambda *a: chain_body(*a, bd=bd, sx=sx, sy=sy, fl=fl)
        )(y, cb, cr, lm, dbv, dbh, sao, alf)

    specs = jax.tree.map(lambda _: P("gop"), args)
    fn = jax.jit(shard_map(lane, mesh=mesh, in_specs=specs,
                           out_specs=P("gop")))
    sharded = jax.device_put(
        args, jax.tree.map(
            lambda _: jax.sharding.NamedSharding(mesh, P("gop")), args))
    return np.asarray(fn(*sharded)), sel
