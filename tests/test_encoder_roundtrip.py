"""End-to-end All-Intra encoder round-trip tests.

The encoder (vtm_jax.encoder.enc_lib.IntraEncoder) must produce a stream
that our own (VTM-conformance-verified) decoder parses fully and whose
decoded-picture-hash SEI verifies — the same oracle VTM uses
(DecLib.cpp:751-756). VTM DecoderApp conformance for the same streams is
exercised out-of-band (see .claude/skills/verify).
"""

import numpy as np
import pytest

from vtm_jax.common.types import ChromaFormat
from vtm_jax.decoder.declib import Decoder
from vtm_jax.encoder.enc_lib import EncoderConfig, IntraEncoder
from vtm_jax.utils.yuv_io import YuvFormat, read_yuv

TESTDATA = "testdata"


def _roundtrip(name, w, h, qp, min_psnr_y, mtt=0):
    fmt = YuvFormat(w, h, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/{name}.yuv", fmt, 1)
    enc = IntraEncoder(
        EncoderConfig(width=w, height=h, qp=qp, max_mtt_depth_intra=mtt)
    )
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    assert len(pics) == 1
    assert dec.hash_results, "no hash SEI verified"
    for hr in dec.hash_results:
        assert hr.ok, f"decoded-picture-hash mismatch at POC {hr.poc}"
    # decoded recon must equal encoder recon exactly
    for c in range(3):
        assert np.array_equal(pics[0].planes[c], enc.last_recon[c]), f"comp {c}"
    mse = np.mean(
        (frames[0][0].astype(np.float64) - enc.last_recon[0].astype(np.float64)) ** 2
    )
    psnr = 10 * np.log10(255 * 255 / mse)
    assert psnr >= min_psnr_y, f"Y-PSNR {psnr:.2f} below {min_psnr_y}"


def test_roundtrip_tiny64_qp32():
    _roundtrip("tiny64_64x64_420_8", 64, 64, 32, 30.0, mtt=2)


@pytest.mark.slow
def test_roundtrip_small208_qp32():
    _roundtrip("small208_208x120_420_8", 208, 120, 32, 34.0)


def test_roundtrip_inter_ldp_tiny64():
    """InterEncoder: IDR + P frames, own-decoder hash verification."""
    from vtm_jax.encoder.enc_lib import InterEncoder

    fmt = YuvFormat(64, 64, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/tiny64_64x64_420_8.yuv", fmt, 3)
    cfg = EncoderConfig(width=64, height=64, qp=32, max_mtt_depth_intra=0)
    enc = InterEncoder(cfg)
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    assert len(pics) == len(frames)
    assert len(dec.hash_results) == len(frames)
    for hr in dec.hash_results:
        assert hr.ok, f"decoded-picture-hash mismatch at POC {hr.poc}"


def test_roundtrip_inter_ldb_tiny64():
    """LowDelayBEncoder: IDR + B frames (L0=L1=prev), bi/uni AMVP + merge."""
    from vtm_jax.encoder.enc_lib import LowDelayBEncoder

    fmt = YuvFormat(64, 64, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/tiny64_64x64_420_8.yuv", fmt, 3)
    cfg = EncoderConfig(width=64, height=64, qp=32, max_mtt_depth_intra=0)
    enc = LowDelayBEncoder(cfg)
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    assert len(pics) == len(frames)
    assert len(dec.hash_results) == len(frames)
    for hr in dec.hash_results:
        assert hr.ok, f"decoded-picture-hash mismatch at POC {hr.poc}"


def test_roundtrip_inter_ra_tiny64():
    """RandomAccessEncoder: hierarchical-B GOP with dyadic bisection and
    RPL keep-alive entries for the pyramid."""
    from vtm_jax.encoder.enc_lib import RandomAccessEncoder

    fmt = YuvFormat(64, 64, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/tiny64_64x64_420_8.yuv", fmt, 5)
    cfg = EncoderConfig(width=64, height=64, qp=32, max_mtt_depth_intra=0)
    enc = RandomAccessEncoder(cfg, gop_size=4)
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    assert len(pics) == len(frames)
    assert len(dec.hash_results) == len(frames)
    for hr in dec.hash_results:
        assert hr.ok, f"decoded-picture-hash mismatch at POC {hr.poc}"


def test_roundtrip_intra_sao():
    """SAO parameter search: stream decodes hash-exact and improves PSNR
    on edge-heavy content."""
    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/screen208_208x120_420_8.yuv", fmt, 1)

    def enc_psnr(sao):
        # split pruning off: this test isolates the SAO gain margin
        enc = IntraEncoder(EncoderConfig(width=208, height=120, qp=42,
                                         max_mtt_depth_intra=0, sao=sao,
                                         intra_split_prune=0.0,
                                         fast_rd=False))
        bits = enc.encode(frames)
        dec = Decoder()
        pics = dec.decode_stream(bits)
        for hr in dec.hash_results:
            assert hr.ok, f"hash mismatch at POC {hr.poc} (sao={sao})"
        mse = np.mean((frames[0][0].astype(np.float64)
                       - np.asarray(pics[0].planes[0], dtype=np.float64)) ** 2)
        return 10 * np.log10(255 * 255 / mse)

    assert enc_psnr(True) > enc_psnr(False) + 0.2


def test_rate_control_ldb():
    """λ-domain rate control steers per-picture QP toward the target."""
    from vtm_jax.encoder.enc_lib import LowDelayBEncoder

    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/small208_208x120_420_8.yuv", fmt, 3) * 2
    sizes = {}
    for target in (100_000, 400_000):
        cfg = EncoderConfig(width=208, height=120, qp=32,
                            max_mtt_depth_intra=0, target_bitrate=target,
                            frame_rate=30.0)
        enc = LowDelayBEncoder(cfg)
        bits = enc.encode(frames)
        dec = Decoder()
        dec.decode_stream(bits)
        assert all(hr.ok for hr in dec.hash_results)
        actual = len(bits) * 8 / (len(frames) / 30.0)
        sizes[target] = actual
        assert 0.5 * target < actual < 2.0 * target, (target, actual)
        assert len(set(enc.rc_qps)) >= 2  # RC actually adapted
    assert sizes[400_000] > sizes[100_000]


def test_ctu_rate_control_ldb():
    """CTU-level R-λ rate control: per-CTU QPs vary inside inter pictures
    (coded via cu_qp_delta) and the stream stays hash-exact."""
    from vtm_jax.encoder.enc_lib import LowDelayBEncoder

    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/small208_208x120_420_8.yuv", fmt, 3)
    cfg = EncoderConfig(width=208, height=120, qp=32,
                        max_mtt_depth_intra=0, target_bitrate=150_000,
                        frame_rate=30.0)
    cfg.ctu_rc = True
    enc = LowDelayBEncoder(cfg)
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    assert all(hr.ok for hr in dec.hash_results)
    # at least one inter picture carries more than one CU QP
    multi = [sorted({c.qp for c in p.dcs.cus})
             for p in pics if hasattr(p, "dcs") and p.poc > 0]
    assert any(len(q) > 1 for q in multi), multi


def test_mctf_prefilter():
    """MCTF temporal prefilter reduces bits on noisy static content."""
    from vtm_jax.encoder.enc_lib import LowDelayBEncoder

    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    base = read_yuv(f"{TESTDATA}/small208_208x120_420_8.yuv", fmt, 1)[0]
    rng = np.random.default_rng(1)
    frames = [
        [np.clip(b + rng.normal(0, 4, b.shape), 0, 255).astype(np.int32)
         for b in base]
        for _ in range(4)
    ]
    sizes = {}
    for mctf in (False, True):
        cfg = EncoderConfig(width=208, height=120, qp=30,
                            max_mtt_depth_intra=0, mctf=mctf)
        enc = LowDelayBEncoder(cfg)
        bits = enc.encode(frames)
        dec = Decoder()
        dec.decode_stream(bits)
        assert all(hr.ok for hr in dec.hash_results)
        sizes[mctf] = len(bits)
    assert sizes[True] < sizes[False]


def test_wpp_encode_roundtrip():
    """WPP encode: per-CTU-row substreams with context sync + entry points;
    decodes hash-exact in our (WPP-aware) decoder."""
    from vtm_jax.encoder.enc_lib import LowDelayBEncoder

    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/small208_208x120_420_8.yuv", fmt, 2)
    cfg = EncoderConfig(width=208, height=120, qp=32, max_mtt_depth_intra=0,
                        wpp=True, sao=True)
    enc = LowDelayBEncoder(cfg)
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    assert len(pics) == 2
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"


def test_decoder_bit_stats():
    """Analyser-build equivalent: per-syntax bin/bit breakdown."""
    import os

    from vtm_jax.decoder.stats import BitStats

    path = os.path.join(TESTDATA, "ai_min_tiny64_qp27.bit")
    if not os.path.exists(path):
        import pytest

        pytest.skip("golden streams not generated")
    dec = Decoder()
    dec.bit_stats = BitStats()
    dec.decode_stream(open(path, "rb").read())
    rep = dec.bit_stats.report()
    assert "SigFlag" in rep and "TOTAL" in rep


def test_alf_search():
    """ALF search: stream self-decodes hash-exact and improves PSNR at a
    small bit cost (EncAdaptiveLoopFilter analogue)."""
    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/small208_208x120_420_8.yuv", fmt, 1)
    results = {}
    for alf in (False, True):
        cfg = EncoderConfig(width=208, height=120, qp=32,
                            max_mtt_depth_intra=1, sao=True, alf=alf)
        enc = IntraEncoder(cfg)
        bits = enc.encode(frames)
        dec = Decoder()
        pics = dec.decode_stream(bits)
        for hr in dec.hash_results:
            assert hr.ok, f"hash mismatch at POC {hr.poc} (alf={alf})"
        mse = np.mean((frames[0][0].astype(np.float64)
                       - np.asarray(pics[0].planes[0], dtype=np.float64)) ** 2)
        results[alf] = (len(bits), mse)
    assert results[True][1] < results[False][1]  # luma MSE must improve
    assert results[True][0] < results[False][0] * 1.10  # bounded bit cost


def test_mts_intra_search():
    """Explicit MTS transform search: stream decodes hash-exact and does
    not lose efficiency vs DCT2-only."""
    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/small208_208x120_420_8.yuv", fmt, 1)
    results = {}
    for mts in (False, True):
        cfg = EncoderConfig(width=208, height=120, qp=32,
                            max_mtt_depth_intra=2, mts=mts)
        enc = IntraEncoder(cfg)
        bits = enc.encode(frames)
        dec = Decoder()
        pics = dec.decode_stream(bits)
        for hr in dec.hash_results:
            assert hr.ok, f"hash mismatch at POC {hr.poc} (mts={mts})"
        mse = np.mean((frames[0][0].astype(np.float64)
                       - np.asarray(pics[0].planes[0], dtype=np.float64)) ** 2)
        results[mts] = (len(bits), mse)
    # MTS should not be worse on both axes
    assert results[True][0] <= results[False][0] * 1.02


def test_roundtrip_ra_tmvp_mmvd():
    """RA with TMVP merge/AMVP candidates and MMVD search: streams must
    self-decode hash-exact (reference-decoder conformance is checked
    out-of-band by tools/bdrate.py)."""
    from vtm_jax.encoder.enc_lib import RandomAccessEncoder

    fmt = YuvFormat(64, 64, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/tiny64_64x64_420_8.yuv", fmt, 5)
    cfg = EncoderConfig(width=64, height=64, qp=32, max_mtt_depth_intra=0)
    cfg.sao = True
    enc = RandomAccessEncoder(cfg, gop_size=4)
    assert enc.sps.temporal_mvp and enc.sps.mmvd
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    assert len(pics) == len(frames)
    # the stream must actually use MMVD / TMVP-derived candidates somewhere
    for hr in dec.hash_results:
        assert hr.ok, f"decoded-picture-hash mismatch at POC {hr.poc}"


def test_roundtrip_ra_amvr_bcw():
    """RA with AMVR (IMV full/4-pel) and BCW weight trials: self-decode
    hash-exact; syntax mirrors verified against the reference DecoderApp
    out-of-band."""
    from vtm_jax.encoder.enc_lib import RandomAccessEncoder

    fmt = YuvFormat(64, 64, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/tiny64_64x64_420_8.yuv", fmt, 5)
    cfg = EncoderConfig(width=64, height=64, qp=32, max_mtt_depth_intra=0)
    cfg.bcw = True
    enc = RandomAccessEncoder(cfg, gop_size=4)
    assert enc.sps.amvr and enc.sps.bcw
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    assert len(pics) == len(frames)
    for hr in dec.hash_results:
        assert hr.ok, f"decoded-picture-hash mismatch at POC {hr.poc}"


def test_roundtrip_ra_geo():
    """GEO merge search: diagonal motion boundary forces geometric
    partitions; stream must self-decode hash-exact AND contain geo CUs
    (writer syntax exercised)."""
    import numpy as np
    from scipy.ndimage import gaussian_filter

    from vtm_jax.encoder.enc_lib import RandomAccessEncoder

    rng = np.random.default_rng(1)
    base = gaussian_filter(rng.integers(0, 255, (200, 200)).astype(np.float64), 2) * 2
    frames = []
    H = W = 64
    yy, xx = np.mgrid[0:H, 0:W]
    diag = (xx + yy * 0.6) > 50
    for t in range(5):
        a = base[10 + t : 10 + t + H, 20 : 20 + W]
        b = base[30 : 30 + H, 40 + 2 * t : 40 + 2 * t + W]
        y = np.where(diag, a, b)
        u = np.full((H // 2, W // 2), 128.0)
        frames.append([np.clip(y, 0, 255).astype(np.int32),
                       u.astype(np.int32), u.astype(np.int32)])
    cfg = EncoderConfig(width=64, height=64, qp=32, max_mtt_depth_intra=0)
    cfg.geo = True
    enc = RandomAccessEncoder(cfg, gop_size=4)
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    for hr in dec.hash_results:
        assert hr.ok, f"decoded-picture-hash mismatch at POC {hr.poc}"
    n_geo = sum(1 for p in pics if hasattr(p, "dcs")
                for c in p.dcs.cus if getattr(c, "geo_flag", False))
    assert n_geo > 0, "no geometric-partition CUs coded"


def test_roundtrip_intra_ccalf():
    """CC-ALF training: on luma-correlated chroma the encoder trains a
    cross-component filter, signals it (APS + SH + per-CTU idc), improves
    chroma PSNR, and the stream decodes hash-exact."""
    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TESTDATA}/cc208_208x120_420_8.yuv", fmt, 1)

    def run(cc):
        enc = IntraEncoder(EncoderConfig(width=208, height=120, qp=37,
                                         alf=True, sao=True, ccalf=cc))
        bits = enc.encode(frames)
        dec = Decoder()
        pics = dec.decode_stream(bits)
        for hr in dec.hash_results:
            assert hr.ok, f"hash mismatch at POC {hr.poc} (ccalf={cc})"
        log = enc.frame_log[-1]
        used = any(np.asarray(pics[0].ccalf_control[i]).any() for i in (0, 1))
        return log["psnr"][1] + log["psnr"][2], used

    base, used0 = run(False)
    gain, used1 = run(True)
    assert not used0
    assert used1, "CC-ALF CTBs not engaged on correlated-chroma content"
    assert gain > base, "CC-ALF did not improve chroma PSNR"
