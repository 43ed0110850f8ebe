"""Bitstream utility apps: parcat, SEI removal, stream merge/extract."""

import os

import numpy as np
import pytest

from vtm_jax.common.types import ChromaFormat
from vtm_jax.decoder.declib import Decoder
from vtm_jax.utils.yuv_io import YuvFormat, read_yuv

TD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata")


def _enc(frames, w, h):
    from vtm_jax.encoder.enc_lib import EncoderConfig, InterEncoder

    cfg = EncoderConfig(width=w, height=h, qp=32, max_mtt_depth_intra=0)
    return InterEncoder(cfg).encode(frames)


def test_parcat_gop_parallel():
    """Two overlapping segments stitch into one decodable stream with
    continuous POCs (App/Parcat readme: GOP-parallel encoding)."""
    from vtm_jax.apps.parcat import parcat

    fmt = YuvFormat(64, 64, ChromaFormat.YUV420, 8)
    frames = read_yuv(f"{TD}/tiny64_64x64_420_8.yuv", fmt, 5)
    seg1 = _enc(frames[0:3], 64, 64)   # frames 0,1,2 (IDR+P+P)
    seg2 = _enc(frames[3:5], 64, 64)   # frames 3,4 (own IDR)
    p1, p2 = "/tmp/parcat_s1.bit", "/tmp/parcat_s2.bit"
    open(p1, "wb").write(seg1)
    open(p2, "wb").write(seg2)
    out = parcat([p1, p2])
    dec = Decoder()
    pics = dec.decode_stream(out)
    assert sorted(p.poc for p in pics) == [0, 1, 2, 3, 4]
    assert len(dec.hash_results) == 5
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"


def test_sei_removal():
    from vtm_jax.apps.sei_removal import remove_sei

    path = os.path.join(TD, "ai_min_tiny64_qp27.bit")
    if not os.path.exists(path):
        pytest.skip("golden streams not generated")
    data = open(path, "rb").read()
    out = remove_sei(data)
    assert len(out) < len(data)
    dec = Decoder()
    pics = dec.decode_stream(out)
    assert pics and not dec.hash_results  # hash SEIs gone, stream decodes


def test_stream_merge_and_extract():
    from vtm_jax.apps.bitstream_extract import extract_layer
    from vtm_jax.apps.stream_merge import merge_streams

    a = os.path.join(TD, "ai_min_tiny64_qp27.bit")
    b = os.path.join(TD, "ai_min_tiny64_qp37.bit")
    if not (os.path.exists(a) and os.path.exists(b)):
        pytest.skip("golden streams not generated")
    open("/tmp/merge_a.bit", "wb").write(open(a, "rb").read())
    open("/tmp/merge_b.bit", "wb").write(open(b, "rb").read())
    merged = merge_streams(["/tmp/merge_a.bit", "/tmp/merge_b.bit"])
    for layer, src in ((0, a), (1, b)):
        ext = extract_layer(merged, layer)
        dec0 = Decoder()
        ref = dec0.decode_stream(open(src, "rb").read())
        dec1 = Decoder()
        got = dec1.decode_stream(ext)
        assert len(got) == len(ref)
        for pr, pg in zip(ref, got):
            for c in range(3):
                assert np.array_equal(pr.planes[c], pg.planes[c])


def test_vps_dci_parse():
    """VPS body + DCI parsing (VLCReader.cpp parseVPS/parseDCI behavior):
    the merged two-layer stream's VPS parses with correct layer/OLS
    derivation, and HRD/VUI-bearing SPS streams activate."""
    from vtm_jax.apps.stream_merge import merge_streams
    from vtm_jax.bitstream import reader as nalio
    from vtm_jax.decoder import vlc

    a = os.path.join(TD, "ai_min_tiny64_qp27.bit")
    if not os.path.exists(a):
        pytest.skip("golden streams not generated")
    open("/tmp/merge_a.bit", "wb").write(open(a, "rb").read())
    merged = merge_streams(["/tmp/merge_a.bit", "/tmp/merge_a.bit"])
    vps = None
    for raw in nalio.split_annexb(merged):
        nal = nalio.parse_nal(raw)
        if nal.nal_unit_type == nalio.NAL_VPS:
            vps = vlc.parse_vps(nal.rbsp)
            break
    assert vps is not None
    assert vps["max_layers"] == 2
    assert vps["all_independent_layers"]
    assert vps["total_num_olss"] >= 1
    assert vps["num_layers_in_ols"][0] == 1
    # HRD/VUI SPS activation (golden ai_hrdvui stream)
    h = os.path.join(TD, "ai_hrdvui_small208_qp32.bit")
    if os.path.exists(h):
        for raw in nalio.split_annexb(open(h, "rb").read()):
            nal = nalio.parse_nal(raw)
            if nal.nal_unit_type == nalio.NAL_SPS:
                sps = vlc.parse_sps(nal.rbsp)
                assert sps.general_hrd["time_scale"] > 0
                assert sps.ols_hrd[-1] is not None
                assert sps.vui["aspect_ratio_idc"] == 1
                break


def test_sei_suite_parse():
    """Typed SEI payload parsing (SEIread.cpp behavior): buffering period
    + picture timing from the HRD golden, plus the HDR metadata payload
    parsers on synthetic payloads."""
    from vtm_jax.decoder import sei as S
    from vtm_jax.decoder.declib import Decoder

    h = os.path.join(TD, "ai_hrdvui_small208_qp32.bit")
    if not os.path.exists(h):
        pytest.skip("golden streams not generated")
    dec = Decoder()
    dec.decode_stream(open(h, "rb").read())
    types = {t for t, _ in dec.sei_log}
    assert S.SEI_BUFFERING_PERIOD in types
    assert S.SEI_PICTURE_TIMING in types
    bp = [p for t, p in dec.sei_log if t == S.SEI_BUFFERING_PERIOD][0]
    assert bp["cpb_cnt"] >= 1 and bp["initial_removal"]
    pt = [p for t, p in dec.sei_log if t == S.SEI_PICTURE_TIMING][0]
    assert pt["au_cpb_removal_delay"]
    # HDR metadata payloads
    cll = S.parse_content_light_level(bytes([0x03, 0xE8, 0x01, 0x90]))
    assert cll == {"max_content_light_level": 1000,
                   "max_pic_average_light_level": 400}
    md = S.parse_mastering_display(bytes(24))
    assert len(md["primaries"]) == 3
    amb = S.parse_ambient_viewing_environment(bytes(8))
    assert amb["illuminance"] == 0
