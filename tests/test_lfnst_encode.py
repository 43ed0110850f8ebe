"""Encoder-side LFNST (secondary transform) tests.

fwd_lfnst (TrQuant::xFwdLfnst analogue) must be the adjoint of the
conformance-proven inv_lfnst, and streams encoded with the LFNST search on
must stay bit-exact through our decoder (hash-SEI oracle).
"""

import numpy as np
import pytest

from vtm_jax.decoder.declib import Decoder
from vtm_jax.encoder.enc_lib import EncoderConfig, IntraEncoder


def _encoder_with_cu(qp=32, lfnst=True):
    cfg = EncoderConfig(width=64, height=64, qp=qp, lfnst=lfnst)
    enc = IntraEncoder(cfg)
    y = np.full((64, 64), 128, np.int32)
    u = np.full((32, 32), 128, np.int32)
    v = np.full((32, 32), 128, np.int32)
    enc.encode([[y, u, v]])
    return enc


@pytest.mark.parametrize("size", [(4, 4), (8, 8), (16, 16), (4, 8)])
@pytest.mark.parametrize("mode", [0, 1, 18, 50, 66])
def test_fwd_inv_lfnst_adjoint(size, mode):
    """Round-tripping LFNST-domain coefficients through the normative
    inverse and back through the forward must reproduce them (the basis
    rows are orthogonal with norm^2 = 2^14, so (M (x M >> 7)) >> 7 ~ x)."""
    from vtm_jax.decoder.cs import Rect

    w, h = size
    enc = _encoder_with_cu()
    cu = enc.dcs.cus[0]
    tu = cu.tus[0]
    cu.blocks[0] = Rect(0, 0, w, h)
    tu.blocks[0] = Rect(0, 0, w, h)
    cu.intra_dir[0] = mode
    zero_out = 8 if ((w == 4 and h == 4) or (w == 8 and h == 8)) else 16
    rng = np.random.default_rng(w * 100 + h + mode)
    for idx in (1, 2):
        from vtm_jax.common import rom

        whge3 = w >= 8 and h >= 8
        scan = rom.get(f"scanTL8x8_w{w}") if whge3 else rom.scan(1, w, h)
        coeffs = np.zeros((h, w), dtype=np.int32)
        vec = rng.integers(-200, 200, zero_out)
        flat = coeffs.ravel()
        for i in range(zero_out):
            flat[int(scan[i][0])] = vec[i]
        coeffs = flat.reshape(h, w)
        cu.lfnst_idx = idx
        spatial = enc.recon.inv_lfnst(tu, 0, coeffs)
        cu.lfnst_idx = 0
        back = enc.recon.fwd_lfnst(tu, 0, spatial, idx)
        got = np.array([back.ravel()[int(scan[i][0])] for i in range(zero_out)])
        err = np.abs(got - vec)
        assert err.max() <= np.maximum(4, np.abs(vec) // 32).max(), (
            idx, vec, got)


def test_lfnst_encode_roundtrip():
    """AI encode with the LFNST search enabled: bit-exact self-decode."""
    rng = np.random.default_rng(3)
    xx, yy = np.meshgrid(np.arange(64), np.arange(64))
    y = ((np.sin(xx / 10.0) * np.cos(yy / 8.0)) * 50 + 128 +
         rng.normal(0, 2, (64, 64))).clip(0, 255).astype(np.int32)
    u = np.clip(120 + rng.integers(-5, 5, (32, 32)), 0, 255).astype(np.int32)
    v = np.clip(130 + rng.integers(-5, 5, (32, 32)), 0, 255).astype(np.int32)
    cfg = EncoderConfig(width=64, height=64, qp=30, lfnst=True, mts=True)
    enc = IntraEncoder(cfg)
    bs = enc.encode([[y, u, v]])
    dec = Decoder()
    pics = dec.decode_stream(bs)
    assert dec.hash_results and all(hr.ok for hr in dec.hash_results)
    for c in range(3):
        assert np.array_equal(pics[0].planes[c], enc.last_recon[c])
