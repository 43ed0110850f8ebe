"""Batched (device) motion-compensation interpolation.

All translational MC of a slice runs as ONE batched kernel call per
component class: blocks are decomposed into fixed-size tiles (4x4 luma,
2x2 chroma), windows are gathered on device from a stacked reference-plane
array, and a uniform two-pass FIR produces either the 14-bit intermediate
(bi) or the final clipped sample (uni) per tile.

Exactness notes (vs InterpolationFilter.cpp filter/filterCopy dispatch,
mirrored by ops/mc.py):
- the H(first,notlast) pass with the phase-0 identity coefficient row is
  bit-exact to filterCopy(first,notlast): (64x - OFFS<<s)>>s == (x<<hr)-OFFS.
- the V(notfirst,notlast) pass with identity is exact: (64t)>>6 == t.
- for the final (isLast) stage, V(notfirst,last) applied to the uniform tmp
  is exact for fy!=0 (both fx cases), and copyLast applied to the uniform
  intermediate is exact for fy==0 (both fx cases):
  ((Σc x)>>s - OFFS + OFFS + 2^(hr-1))>>hr == (Σc x + 32)>>6 because the
  discarded low s bits never affect the bit-5 rounding decision (s < 6).
Hence one branch-free kernel reproduces all four scalar dispatch paths.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

IF_INTERNAL_PREC = 14
IF_OFFS = 1 << (IF_INTERNAL_PREC - 1)


@partial(jax.jit, static_argnames=("taps", "tile", "bd"))
def mc_tiles(refs, r_idx, x0, y0, cH, cV, fy_nz, rnd, taps: int, tile: int,
             bd: int):
    """Batched tile MC.

    refs:  int32 [R, H, W] stacked reference planes (one component class).
    r_idx: int32 [N] plane index per tile.
    x0,y0: int32 [N] top-left of the FIR support window
           (block_x + int_mv - (taps/2 - 1)).
    cH,cV: int32 [N, taps] filter coefficients (phase already selected;
           identity row for frac 0).
    fy_nz: bool [N] — vertical phase nonzero (selects the isLast variant).
    rnd:   bool [N] — True → final clipped sample (uni), False → 14-bit
           intermediate (bi).
    Returns int32 [N, tile, tile].
    """
    R, H, W = refs.shape
    n = taps
    hr = max(2, IF_INTERNAL_PREC - bd)
    s1 = 6 - hr
    off1 = -(IF_OFFS << s1)
    maxv = (1 << bd) - 1

    iy = jnp.clip(y0[:, None] + jnp.arange(tile + n - 1), 0, H - 1)
    ix = jnp.clip(x0[:, None] + jnp.arange(tile + n - 1), 0, W - 1)
    win = refs[r_idx[:, None, None], iy[:, :, None], ix[:, None, :]]

    # H pass: isFirst, notLast
    tmp = jnp.zeros((win.shape[0], tile + n - 1, tile), dtype=jnp.int32)
    for k in range(n):
        tmp = tmp + cH[:, k, None, None] * win[:, :, k:k + tile]
    tmp = (tmp + off1) >> s1

    # V pass: notFirst, notLast → intermediate
    acc = jnp.zeros((win.shape[0], tile, tile), dtype=jnp.int32)
    for k in range(n):
        acc = acc + cV[:, k, None, None] * tmp[:, k:k + tile, :]
    inter = acc >> 6

    # final stage variants for uni
    shl = 6 + hr
    offl = (1 << (shl - 1)) + (IF_OFFS << 6)
    r_v = jnp.clip((acc + offl) >> shl, 0, maxv)
    r_c = jnp.clip((inter + IF_OFFS + (1 << (hr - 1))) >> hr, 0, maxv)
    uni = jnp.where(fy_nz[:, None, None], r_v, r_c)
    return jnp.where(rnd[:, None, None], uni, inter)


# opt-in capture of the last executed luma batch (multi-chip dryrun replay)
CAPTURE = None


@partial(jax.jit, static_argnames=("bd",))
def _mc_tiles_pair(largs, cargs, bd: int):
    """Luma + chroma tile batches in ONE device dispatch, outputs packed
    into a single flat vector (one device->host sync)."""
    parts = []
    if largs is not None:
        parts.append(mc_tiles(*largs, taps=8, tile=4, bd=bd).reshape(-1))
    if cargs is not None:
        parts.append(mc_tiles(*cargs, taps=4, tile=2, bd=bd).reshape(-1))
    return jnp.concatenate(parts)


@partial(jax.jit, static_argnames=("kinds", "bd"))
def _mc_tiles_multi(argsets, kinds, bd: int):
    """Several tile batches (mixed luma/chroma) in ONE device dispatch."""
    return tuple(
        mc_tiles(*a, taps=8 if lum else 4, tile=4 if lum else 2, bd=bd)
        for a, lum in zip(argsets, kinds)
    )


def execute_many(batches):
    """Execute several McBatch instances as a single device dispatch."""
    slots = []
    for b in batches:
        for lum in (True, False):
            if b.n[lum]:
                slots.append((b, lum, b._build_args(lum)))
    if not slots:
        return
    outs = _mc_tiles_multi(tuple(s[2] for s in slots),
                           tuple(s[1] for s in slots), bd=batches[0].bd)
    for (b, lum, _), out in zip(slots, outs):
        b.results[lum] = np.asarray(out[: b.n[lum]])


def _bucket(n: int) -> int:
    """Pad batch size to a small set of bucket sizes to bound jit compiles."""
    b = 64
    while b < n:
        b <<= 1
    return b


class McBatch:
    """Per-slice collector for translational MC tile jobs.

    Usage: add blocks via `add_block` (returns an index range), call
    `execute()`, then read back with `block_result`.
    """

    def __init__(self, bd: int):
        self.bd = bd
        # per-block records; tile/column expansion is vectorized in execute()
        self.recs = {True: [], False: []}     # (r, x0, y0, nbx, nby, fy, rnd)
        self.cfs = {True: [], False: []}      # (cf_h, cf_v) per block
        self.planes = {True: [], False: []}   # list of np planes
        self.plane_ids = {True: {}, False: {}}
        self.results = {True: None, False: None}
        self.n = {True: 0, False: 0}

    def _plane_idx(self, lum: bool, plane: np.ndarray) -> int:
        key = id(plane)
        d = self.plane_ids[lum]
        if key not in d:
            d[key] = len(self.planes[lum])
            self.planes[lum].append(plane)
        return d[key]

    def add_block(self, plane, x0, y0, w, h, cf_h, cf_v, frac_y_nz: bool,
                  rnd_res: bool, is_luma: bool):
        """Register one mc_block; (x0, y0) is the *sample* position of the
        block (integer MV applied), support offset handled here."""
        lum = is_luma
        tile = 4 if lum else 2
        taps = 8 if lum else 4
        half = (taps >> 1) - 1
        r = self._plane_idx(lum, plane)
        nbx, nby = w // tile, h // tile
        cnt = nbx * nby
        self.recs[lum].append((r, x0 - half, y0 - half, nbx, nby,
                               frac_y_nz, rnd_res))
        self.cfs[lum].append((cf_h, cf_v))
        start = self.n[lum]
        self.n[lum] += cnt
        return (lum, start, nby, nbx, tile)

    def execute(self):
        """Run the collected luma + chroma batches as ONE device dispatch."""
        args = {True: None, False: None}
        for lum in (True, False):
            if self.n[lum]:
                args[lum] = self._build_args(lum)
        if args[True] is None and args[False] is None:
            return
        packed = np.asarray(_mc_tiles_pair(args[True], args[False],
                                           bd=self.bd))
        off = 0
        if args[True] is not None:
            npad = args[True][1].shape[0]  # r_idx padded length
            sz = npad * 16
            self.results[True] = packed[off : off + sz].reshape(
                npad, 4, 4)[: self.n[True]]
            off += sz
        if args[False] is not None:
            npad = args[False][1].shape[0]
            sz = npad * 4
            self.results[False] = packed[off : off + sz].reshape(
                npad, 2, 2)[: self.n[False]]
        global CAPTURE
        if CAPTURE is not None and args[True] is not None and self.n[True] >= 64:
            CAPTURE = {"args": tuple(np.asarray(a) for a in args[True]),
                       "taps": 8, "tile": 4, "bd": self.bd,
                       "out": self.results[True].copy(), "n": self.n[True]}

    def _build_args(self, lum: bool):
        n = self.n[lum]
        tile = 4 if lum else 2
        taps = 8 if lum else 4
        if True:
            recs = np.asarray(self.recs[lum], dtype=np.int64)
            r_b, x_b, y_b = recs[:, 0], recs[:, 1], recs[:, 2]
            nbx_b, nby_b = recs[:, 3], recs[:, 4]
            fy_b, rnd_b = recs[:, 5], recs[:, 6]
            counts = nbx_b * nby_b
            blk = np.repeat(np.arange(len(recs)), counts)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            within = np.arange(n) - starts[blk]
            bx = within % nbx_b[blk]
            by = within // nbx_b[blk]
            cat_x = (x_b[blk] + bx * tile).astype(np.int32)
            cat_y = (y_b[blk] + by * tile).astype(np.int32)
            cfh = np.stack([c[0] for c in self.cfs[lum]]).astype(np.int32)
            cfv = np.stack([c[1] for c in self.cfs[lum]]).astype(np.int32)
            nb = _bucket(n)
            first = self.planes[lum][0]
            # pad the plane-stack count to a small bucket set so mc_tiles
            # compiles once per (bucket, plane-shape), not per ref count
            nr = len(self.planes[lum])
            rpad = 1
            while rpad < nr:
                rpad <<= 1
            if isinstance(first, np.ndarray):
                refs = np.zeros((rpad,) + first.shape, dtype=np.int32)
                refs[:nr] = np.stack(self.planes[lum])
                refs = jnp.asarray(refs)
            else:
                # device-resident reference planes (Picture.device_planes)
                refs = jnp.stack(self.planes[lum])
                if rpad > nr:
                    refs = jnp.concatenate(
                        [refs, jnp.zeros((rpad - nr,) + first.shape,
                                         dtype=refs.dtype)])

            def padded(a, dt):
                out = np.zeros((nb,) + a.shape[1:], dtype=dt)
                out[:n] = a
                return out

            from vtm_jax.parallel import mesh as MESH

            dmesh = MESH.decode_mesh()
            if dmesh is not None and nb % len(dmesh.devices.flat) == 0:
                # live sharded path: the tile-job batch axis spreads over
                # the whole mesh; reference planes replicate
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as PS

                sj = NamedSharding(dmesh, PS(("gop", "tile")))
                put = lambda a: jax.device_put(jnp.asarray(a), sj)
            else:
                put = jnp.asarray
            return (
                refs,
                put(padded(r_b[blk], np.int32)),
                put(padded(cat_x, np.int32)),
                put(padded(cat_y, np.int32)),
                put(padded(cfh[blk], np.int32)),
                put(padded(cfv[blk], np.int32)),
                put(padded(fy_b[blk], bool)),
                put(padded(rnd_b[blk], bool)),
            )

    def block_result(self, handle) -> np.ndarray:
        lum, start, nby, nbx, tile = handle
        r = self.results[lum][start : start + nby * nbx]
        return (
            r.reshape(nby, nbx, tile, tile)
            .transpose(0, 2, 1, 3)
            .reshape(nby * tile, nbx * tile)
            .astype(np.int64)
        )
