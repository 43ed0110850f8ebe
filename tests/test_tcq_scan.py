"""Batched TCQ scan: numpy design (encoder/tcq_scan.py) vs native twin
(native/tcq.c) equivalence, batching invariance, and integration through
the encoder's quant_dep_ctx entry.

The two implementations must make bit-identical level decisions — the
numpy module is the design reference and oracle, the C module is the
low-latency engine the encoder loads.
"""

import numpy as np
import pytest

from vtm_jax import native
from vtm_jax.common import rom
from vtm_jax.encoder import dq_ctx
from vtm_jax.encoder.tcq_scan import TcqBatch


def _qparams(w, h, qp0, lam=50.0, bit_depth=8):
    max_range = 15
    qp_dq = qp0 + 1
    qp_per, qp_rem = qp_dq // 6, qp_dq % 6
    fl = lambda x: x.bit_length() - 1  # noqa: E731
    log2w, log2h = fl(w), fl(h)
    nom_tshift = max_range - bit_depth - ((log2w + log2h) >> 1)
    needs_sqrt2 = ((log2w + log2h) & 1) == 1
    tshift = nom_tshift + (-1 if needs_sqrt2 else 0)
    q_shift = 14 - 1 + qp_per + tshift
    q_scale = int(rom.quant_scale(qp_rem, needs_sqrt2))
    inv_shift = 6 + 1 - qp_per - tshift
    q_idx_bd = min(max_range + 1, 64 + inv_shift - 6 - 1)
    nom_d_shift = 15 - 2 * nom_tshift + q_shift + (1 if needs_sqrt2 else 0)
    q2 = float(q_scale * q_scale)
    if nom_d_shift < 0:
        ndf = 1.0 / (float(1 << -nom_d_shift) * q2 * lam)
    else:
        ndf = float(1 << nom_d_shift) / (q2 * lam)
    v = int(ndf * q2) + 1
    df_shift = (v - 1).bit_length() if v > 1 else 0
    dist_shift = 62 + q_shift - 2 * max_range - df_shift
    return dict(
        q_shift=q_shift, q_add=-((3 << q_shift) >> 1),
        max_q_idx=(1 << (q_idx_bd - 1)) - 4, q_scale=q_scale,
        dist_step_add=int(ndf * float(1 << (dist_shift + q_shift)) + 0.5),
        dist_org_fact=int(ndf * float(1 << (dist_shift + 1)) + 0.5),
        dist_add=(1 << dist_shift) >> 1, dist_shift=dist_shift)


def _native_run(tcq, geom, q, mags, first_cap, zero, last, sig, gtx,
                ch_luma, init_rem):
    B, n = mags.shape
    lev = np.zeros((B, n), np.int32)
    tcq.tcq_run(
        np.ascontiguousarray(mags), lev, B, n, first_cap,
        geom["gsize_l2"], geom["wig"], geom["sbbpos"], geom["sx"],
        geom["sy"], geom["nbs_num"], geom["nbs"], geom["nbo_num"],
        geom["nbo"], zero, np.ascontiguousarray(last.astype(np.int64)),
        np.ascontiguousarray(sig), np.ascontiguousarray(gtx), ch_luma,
        init_rem, int(q["q_add"]), int(q["max_q_idx"]), int(q["q_scale"]),
        int(q["dist_step_add"]), int(q["dist_org_fact"]),
        int(q["dist_add"]), int(q["q_shift"]), int(q["dist_shift"]))
    return lev


@pytest.mark.parametrize("shape", [(4, 4), (8, 8), (16, 16), (32, 32),
                                   (4, 16), (32, 8), (8, 4)])
def test_numpy_vs_native(shape):
    w, h = shape
    tcq = native.load_tcq()
    assert tcq is not None
    geom = dq_ctx._dq_geom(w, h)
    n = geom["n"]
    rng = np.random.default_rng(w * 100 + h)
    for trial in range(8):
        ch_luma = trial & 1
        q = _qparams(w, h, int(rng.integers(5, 55)))
        B = 5
        mags = rng.integers(0, 90, (B, n)).astype(np.int64)
        mags[rng.random((B, n)) < 0.5] = 0
        if trial == 3:
            mags[2] = rng.integers(0, 20000, n)  # Rice-escape stress
        mags[0] = 0  # dead TU inside the batch
        zero = np.zeros(n, np.uint8)
        if trial == 5 and w >= 32:
            zero |= (geom["sx"] >= 16).astype(np.uint8)
        first_cap = n if trial != 4 or min(w, h) < 4 else (
            8 if (w, h) in ((4, 4), (8, 8)) else 16)
        sig = rng.integers(0, 5 << 15, (B, 38, 2)).astype(np.int32)
        gtx = np.zeros((B, 21, 6), np.int32)
        gtx[:, :, 1:] = rng.integers(0, 6 << 15, (B, 21, 5))
        last = rng.integers(0, 20 << 15, (B, n)).astype(np.int64)
        init_rem = (min(32, w) * min(32, h) * 28) >> 4
        ref = TcqBatch(geom, q, ch_luma, init_rem, zero).run(
            mags, first_cap, sig, gtx, last)
        got = _native_run(tcq, geom, q, mags, first_cap, zero, last, sig,
                          gtx, ch_luma, init_rem)
        assert np.array_equal(ref, got), (shape, trial)


def test_batch_equals_singles():
    """Running a batch must equal running each TU alone (no cross-TU
    leakage through the shared scan)."""
    w = h = 8
    tcq = native.load_tcq()
    geom = dq_ctx._dq_geom(w, h)
    n = geom["n"]
    rng = np.random.default_rng(11)
    q = _qparams(w, h, 33)
    B = 9
    mags = rng.integers(0, 60, (B, n)).astype(np.int64)
    mags[rng.random((B, n)) < 0.5] = 0
    zero = np.zeros(n, np.uint8)
    sig = rng.integers(0, 5 << 15, (B, 38, 2)).astype(np.int32)
    gtx = np.zeros((B, 21, 6), np.int32)
    gtx[:, :, 1:] = rng.integers(0, 6 << 15, (B, 21, 5))
    last = rng.integers(0, 20 << 15, (B, n)).astype(np.int64)
    init_rem = (w * h * 28) >> 4
    batch = _native_run(tcq, geom, q, mags, n, zero, last, sig, gtx, 1,
                        init_rem)
    ref = TcqBatch(geom, q, 1, init_rem, zero).run(mags, n, sig, gtx, last)
    assert np.array_equal(batch, ref)
    for b in range(B):
        single = _native_run(tcq, geom, q, mags[b:b + 1], n, zero,
                             last[b:b + 1], sig[b:b + 1], gtx[b:b + 1], 1,
                             init_rem)
        assert np.array_equal(single[0], batch[b]), b


def test_quant_dep_ctx_reconstructs():
    """The encoder entry point returns conformant levels: reconstruction
    through the normative dequant_dep round-trips without error and the
    distortion beats naive scalar quantization on a dense block."""
    from vtm_jax.decoder.cabac import ContextModels
    from vtm_jax.encoder.bin_encoder import BitEstimator
    from vtm_jax.ops import quant as Q

    rng = np.random.default_rng(5)
    w = h = 16
    coeff = rng.integers(-900, 900, (h, w)).astype(np.int32)
    qp = (33, 33 // 6, 33 % 6)
    ctx = ContextModels()
    ctx.init(32, 2)
    est = BitEstimator(ctx)
    cctx = dq_ctx.rate_ctx(w, h, 0)
    lam = 80.0
    lev = dq_ctx.quant_dep_ctx(coeff, qp, 8, lam, cctx, est)
    assert lev is not None and lev.shape == (h, w)
    scan = rom.scan(1, w, h)
    rec = Q.dequant_dep(lev, qp, 8, scan)
    naive = Q.quant_fwd(coeff, qp, 8, True)
    rec_naive = Q.dequant(naive, qp, 8)
    d_tcq = float(((coeff.astype(np.int64) - rec) ** 2).sum())
    d_scalar = float(((coeff.astype(np.int64) - rec_naive) ** 2).sum())
    assert d_tcq <= d_scalar * 1.10
