"""Encoder-side MIP (matrix intra prediction) and MRL (multi-reference
line) search tests: candidate selection must produce streams our
conformance-proven decoder reproduces bit-exactly (hash-SEI oracle), with
the tools actually being chosen on natural content.
"""

import numpy as np

from vtm_jax.common.types import ChromaFormat
from vtm_jax.decoder.declib import Decoder
from vtm_jax.encoder.enc_lib import EncoderConfig, IntraEncoder
from vtm_jax.utils.yuv_io import YuvFormat, read_yuv


def test_mip_mrl_lfnst_roundtrip_and_selection():
    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv("testdata/small208_208x120_420_8.yuv", fmt, 1)
    cfg = EncoderConfig(width=208, height=120, qp=32, max_mtt_depth_intra=1,
                        mip=True, mrl=True, lfnst=True)
    enc = IntraEncoder(cfg)
    bs = enc.encode([list(frames[0])])
    n_mip = sum(1 for cu in enc.dcs.cus if getattr(cu, "mip_flag", False))
    n_lfnst = sum(1 for cu in enc.dcs.cus if getattr(cu, "lfnst_idx", 0))
    assert n_mip > 0, "MIP never selected on natural content"
    assert n_lfnst > 0, "LFNST never selected on natural content"
    dec = Decoder()
    pics = dec.decode_stream(bs)
    assert dec.hash_results and all(hr.ok for hr in dec.hash_results)
    for c in range(3):
        assert np.array_equal(pics[0].planes[c], enc.last_recon[c])


def test_mrl_signalling_roundtrip():
    """Force MRL-eligible geometry (CU rows below the CTU top) and check the
    extend_ref_line syntax survives an encode/decode round trip."""
    rng = np.random.default_rng(17)
    y = np.clip(
        np.kron(rng.integers(40, 210, (16, 16)), np.ones((8, 8), int))
        + rng.integers(-6, 6, (128, 128)),
        0, 255).astype(np.int32)
    u = np.full((64, 64), 128, np.int32)
    v = np.full((64, 64), 128, np.int32)
    cfg = EncoderConfig(width=128, height=128, qp=30, mrl=True,
                        max_mtt_depth_intra=1)
    enc = IntraEncoder(cfg)
    bs = enc.encode([[y, u, v]])
    dec = Decoder()
    pics = dec.decode_stream(bs)
    assert dec.hash_results and all(hr.ok for hr in dec.hash_results)
    for c in range(3):
        assert np.array_equal(pics[0].planes[c], enc.last_recon[c])


def test_cclm_chroma_search_roundtrip():
    """CCLM chroma search: LM modes selected on natural content; bit-exact
    self-decode with the chroma linear-model signalling."""
    from vtm_jax.decoder import cs as D

    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv("testdata/small208_208x120_420_8.yuv", fmt, 1)
    cfg = EncoderConfig(width=208, height=120, qp=32, max_mtt_depth_intra=1,
                        cclm=True)
    enc = IntraEncoder(cfg)
    bs = enc.encode([list(frames[0])])
    n_lm = sum(1 for cu in enc.dcs.cus if cu.intra_dir[1] in
               (D.LM_CHROMA_IDX, D.MDLM_L_IDX, D.MDLM_T_IDX))
    assert n_lm > 0, "CCLM never selected"
    dec = Decoder()
    pics = dec.decode_stream(bs)
    assert dec.hash_results and all(hr.ok for hr in dec.hash_results)
    for c in range(3):
        assert np.array_equal(pics[0].planes[c], enc.last_recon[c])


def test_isp_all_intra_tools_roundtrip():
    """All intra tools on together (MTS+LFNST+MIP+MRL+CCLM+ISP): streams
    must stay bit-exact through our decoder; ISP must be selectable."""
    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv("testdata/small208_208x120_420_8.yuv", fmt, 1)
    cfg = EncoderConfig(width=208, height=120, qp=27, max_mtt_depth_intra=1,
                        mts=True, lfnst=True, mip=True, mrl=True, cclm=True,
                        isp=True)
    enc = IntraEncoder(cfg)
    bs = enc.encode([list(frames[0])])
    dec = Decoder()
    pics = dec.decode_stream(bs)
    assert dec.hash_results and all(hr.ok for hr in dec.hash_results)
    for c in range(3):
        assert np.array_equal(pics[0].planes[c], enc.last_recon[c])


def test_angular_sad_batch_exact():
    """angular_sad_batch (the RMD preselection sweep as one batched gather)
    is bit-exact with per-mode pred_angular(+PDPC) SAD."""
    import numpy as np

    from vtm_jax.ops import intra as I

    rng = np.random.default_rng(7)
    for _ in range(40):
        w = int(rng.choice([4, 8, 16, 32, 64]))
        h = int(rng.choice([4, 8, 16, 32, 64]))
        top = rng.integers(0, 256, size=2 * w + 3).astype(np.int64)
        left = rng.integers(0, 256, size=2 * h + 3).astype(np.int64)
        ft, fl = I.filter_reference_samples(top, left, w * 2, h * 2, 0)
        src = rng.integers(0, 256, size=(h, w)).astype(np.int64)
        modes = [int(m) for m in
                 rng.choice(np.arange(2, 67), size=9, replace=False)]
        got = I.angular_sad_batch(top, left, ft, fl, w, h, modes, src, 8)
        for m in modes:
            p = I.IntraParams(m, w, h, w, h, True, 0, False, False)
            use_t, use_l = (ft, fl) if p.ref_filter_flag else (top, left)
            pred = I.pred_angular(use_t, use_l, w, h, p, True, 8)
            assert got[m] == float(np.abs(src - pred).sum()), (m, w, h)
