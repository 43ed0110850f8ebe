"""RdCost SATD + batched device RMD parity tests.

The numpy satd() follows RdCost::xGetHADs tiling (RdCost.cpp:2819) with
the JVET-R0164 mean-scaled DC; satd_batch_jax must match it bit-exactly
(modulo +-1 on the sqrt-normalized 16x8/8x4 tilings where the reference
uses double and the jax path float32).  FrameRMD costs must equal the
scalar prediction path (pred_angular/pred_planar/pred_dc/pred_mip +
PDPC) costed with satd() on source-built reference samples.
"""

import numpy as np
import pytest

from vtm_jax.ops import intra as I
from vtm_jax.ops import rdcost

RNG = np.random.default_rng(42)


def _rand_block(h, w):
    return (RNG.integers(0, 256, (h, w)).astype(np.int64),
            RNG.integers(0, 256, (h, w)).astype(np.int64))


def _scalar_had(org, cur, th, tw):
    """Direct per-tile Hadamard reference (butterfly-free formulation)."""
    d = org - cur
    hh = rdcost._hadamard(th)
    hw = rdcost._hadamard(tw)
    m = hh @ d @ hw.T
    a = np.abs(m)
    s = a.sum() - a[0, 0] + (a[0, 0] >> 2)
    return s


def test_satd_8x8_norm():
    org, cur = _rand_block(8, 8)
    s = _scalar_had(org, cur, 8, 8)
    assert rdcost.satd(org, cur) == (s + 2) >> 2


def test_satd_4x4_norm():
    org, cur = _rand_block(4, 4)
    s = _scalar_had(org, cur, 4, 4)
    assert rdcost.satd(org, cur) == (s + 1) >> 1


def test_satd_16x8_norm():
    org, cur = _rand_block(8, 16)
    s = _scalar_had(org, cur, 8, 16)
    import math

    assert rdcost.satd(org, cur) == int(s / math.sqrt(16.0 * 8) * 2)


def test_satd_tiling_sums():
    org, cur = _rand_block(16, 16)
    total = rdcost.satd(org, cur)
    parts = sum(rdcost.satd(org[y : y + 8, x : x + 8],
                            cur[y : y + 8, x : x + 8])
                for y in (0, 8) for x in (0, 8))
    assert total == parts


@pytest.mark.parametrize("shape", [(8, 8), (4, 4), (16, 16), (8, 16),
                                   (16, 8), (4, 8), (8, 4), (32, 32)])
def test_satd_batch_jax_matches_numpy(shape):
    h, w = shape
    org = RNG.integers(0, 256, (5, h, w)).astype(np.int64)
    cur = RNG.integers(0, 256, (5, h, w)).astype(np.int64)
    want = rdcost.satd_batch(org, cur)
    import jax.numpy as jnp

    got = np.asarray(rdcost.satd_batch_jax(
        jnp.asarray((org - cur).astype(np.int32)), h, w))
    tol = 1 if (w != h and (w % 8 == 0 or h % 8 == 0)) else 0
    assert np.abs(got.astype(np.int64) - want).max() <= tol


# ---------------------------------------------------------------------------


class _Cfg:
    bit_depth = 8
    mip = True
    log2_ctu_size = 6
    log2_max_bt_intra = 5
    max_mtt_depth_intra = 2


def _scalar_costs(src, srcpad, x, y, w, h):
    Tu = srcpad[y, x : x + 2 * w + 1].copy()
    Lu = srcpad[y : y + 2 * h + 1, x].copy()
    ft, fl = I.filter_reference_samples(Tu, Lu, w * 2, h * 2, 0)
    s = src[y : y + h, x : x + w].astype(np.int64)
    out = np.zeros(67, np.int64)
    for m in range(67):
        p = I.IntraParams(m, w, h, w, h, True, 0, False, False)
        ut, ul = (ft, fl) if p.ref_filter_flag else (Tu, Lu)
        if m == 0:
            pred = I.pred_planar(ut, ul, w, h)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, ut, ul)
        elif m == 1:
            pred = np.full((h, w), I.pred_dc(Tu, Lu, w, h, 0), np.int64)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, Tu, Lu)
        else:
            pred = I.pred_angular(ut, ul, w, h, p, True, 8)
        out[m] = rdcost.satd(s, pred)
    nm = {0: 16, 1: 8, 2: 6}[I.mip_size_id(w, h)]
    mips = []
    for idx in range(nm):
        for tr in (False, True):
            mips.append(rdcost.satd(
                s, I.pred_mip(Tu[1 : w + 1], Lu[1 : h + 1], w, h, idx, tr, 8)))
    return out, np.array(mips)


def test_frame_rmd_matches_scalar():
    from vtm_jax.encoder import frame_rmd

    src = RNG.integers(0, 256, (48, 64)).astype(np.int32)
    fr = frame_rmd.FrameRMD(src, _Cfg(), 1.0)
    srcpad = np.pad(src, ((1, 130), (1, 130)), mode="edge").astype(np.int64)
    cases = [(4, 4, 0, 0), (8, 8, 4, 4), (16, 16, 16, 16), (8, 4, 12, 8),
             (4, 8, 40, 24), (16, 8, 8, 4), (8, 16, 24, 16), (32, 32, 32, 0),
             (32, 8, 0, 4), (4, 16, 56, 16), (16, 4, 16, 40), (32, 16, 0, 8)]
    for (w, h, x, y) in cases:
        got = fr.costs(x, y, w, h)
        assert got is not None, (w, h, x, y)
        ga, gm = got
        ea, em = _scalar_costs(src, srcpad, x, y, w, h)
        # +-1 on sqrt-normalized tile shapes (float32 vs double norm)
        tol = 1 if (w != h) else 0
        assert np.abs(ga.astype(np.int64) - ea).max() <= tol, (w, h, x, y)
        assert np.abs(gm.astype(np.int64) - em).max() <= tol, (w, h, x, y)
