"""Dependent-quantization encoder (trellis) tests.

The trellis (ops/quant.quant_dep, native twin vtm_jax/native/depquant.c) is
the encoder side of VTM's DepQuant (DepQuant.cpp:806-1008); correctness
contract: levels reconstruct through the normative dequant_dep, and the
native and Python Viterbi make identical decisions.
"""

import numpy as np
import pytest

from vtm_jax.common import rom
from vtm_jax.ops import quant as Q


QP = (32, 32 // 6, 32 % 6)
LAM = 0.57 * 2.0 ** ((32 - 12) / 3.0)


def _rand_block(rng, h, w, density=0.4, amp=400):
    c = rng.integers(-amp, amp, size=(h, w)).astype(np.int32)
    c[rng.random((h, w)) > density] = 0
    return c


@pytest.mark.parametrize("shape", [(4, 4), (8, 8), (16, 16), (4, 8), (32, 16)])
def test_native_matches_python(shape, monkeypatch):
    h, w = shape
    rng = np.random.default_rng(h * 100 + w)
    scan = rom.scan(1, w, h)
    for _ in range(5):
        c = _rand_block(rng, h, w)
        lev_native = Q.quant_dep(c, QP, 8, LAM, scan)
        monkeypatch.setenv("VTM_NO_NATIVE", "1")
        monkeypatch.setattr(Q, "_DQ_NATIVE", None)
        lev_py = Q.quant_dep(c, QP, 8, LAM, scan)
        monkeypatch.delenv("VTM_NO_NATIVE")
        monkeypatch.setattr(Q, "_DQ_NATIVE", None)
        assert np.array_equal(lev_native, lev_py)


def test_trellis_beats_rdoq_rd_cost():
    """On dense blocks the DQ trellis should win the lam-weighted RD cost
    against RDOQ reconstructed through scalar dequant (the half-step
    quantizers halve the max reconstruction error)."""
    rng = np.random.default_rng(3)
    wins = 0
    trials = 10
    for _ in range(trials):
        c = _rand_block(rng, 16, 16, density=0.7)
        scan = rom.scan(1, 16, 16)
        lev_dq = Q.quant_dep(c, QP, 8, LAM, scan)
        rec_dq = Q.dequant_dep(lev_dq, QP, 8, scan)
        lev_rd = Q.quant_rdoq(c, QP, 8, LAM)
        rec_rd = Q.dequant(lev_rd, QP, 8)

        def cost(rec, lev):
            d = float(np.sum((c.astype(np.int64) - rec.astype(np.int64)) ** 2))
            bits = float(np.abs(lev).sum() + np.count_nonzero(lev))
            return d / 16.0 + LAM * bits  # err_scale(16x16,qp32,8b) = 1/16

        if cost(rec_dq, lev_dq) <= cost(rec_rd, lev_rd):
            wins += 1
    assert wins >= trials // 2 + 1


def test_zero_block_and_last_significant():
    scan = rom.scan(1, 8, 8)
    zero = np.zeros((8, 8), dtype=np.int32)
    assert not Q.quant_dep(zero, QP, 8, LAM, scan).any()
    tiny = zero.copy()
    tiny[7, 7] = 3  # far-off tiny coefficient: cheaper to drop the block
    assert not Q.quant_dep(tiny, QP, 8, LAM, scan).any()
    # a solid DC coefficient must survive and reconstruct losslessly-ish
    dc = zero.copy()
    dc[0, 0] = 4000
    lev = Q.quant_dep(dc, QP, 8, LAM, scan)
    assert lev[0, 0] != 0
    rec = Q.dequant_dep(lev, QP, 8, scan)
    assert abs(int(rec[0, 0]) - 4000) < 200


def test_intra_encode_roundtrip_dep_quant(tmp_path):
    """64x64 AI encode with dep_quant on: our decoder reproduces the
    encoder reconstruction bit-exactly (hash-SEI oracle path)."""
    from vtm_jax.decoder.declib import Decoder

    rng = np.random.default_rng(11)
    y = np.clip(
        np.kron(rng.integers(0, 255, (8, 8)), np.ones((8, 8), int))
        + rng.integers(-10, 10, (64, 64)),
        0,
        255,
    ).astype(np.int32)
    u = np.full((32, 32), 100, np.int32)
    v = np.full((32, 32), 150, np.int32)
    from vtm_jax.encoder.enc_lib import EncoderConfig, IntraEncoder

    cfg = EncoderConfig(width=64, height=64, qp=32, dep_quant=True)
    enc = IntraEncoder(cfg)
    bs = enc.encode([[y, u, v]])
    dec = Decoder()
    pics = dec.decode_stream(bs)
    assert dec.hash_results and all(hr.ok for hr in dec.hash_results)
    for c in range(3):
        assert np.array_equal(pics[0].planes[c], enc.last_recon[c])
