"""Bit-exact decode conformance vs VTM golden streams.

Each stream was encoded by the reference EncoderApp (tools/make_golden.sh)
with a decoded-picture-hash SEI; we decode and require every picture hash to
match (the reference's own oracle: DecLib.cpp:751-756).
"""

import os

import pytest

from vtm_jax.decoder.declib import Decoder

TD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata")

STREAMS = [
    "ai_min_tiny64_qp37",
    "ai_min_tiny64_qp27",
    "ai_min_small208_qp32",
    "ai_dq_tiny64_qp32",
]


@pytest.mark.parametrize("name", STREAMS)
def test_bit_exact_decode(name):
    path = os.path.join(TD, f"{name}.bit")
    if not os.path.exists(path):
        pytest.skip("golden streams not generated on this machine")
    dec = Decoder()
    dec.decode_stream(open(path, "rb").read())
    assert dec.hash_results, "no picture hashes found"
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"

TOOL_STREAMS = [
    "ai_tools_tiny64_qp32",
    "ai_tools_small208_qp27",
    "ai_full_tiny64_qp32",
    "ai_full_small208_qp37",
    # HRD (general+OLS timing/buffering) + VUI (aspect ratio) in the SPS
    "ai_hrdvui_small208_qp32",
]


@pytest.mark.slow
def test_bit_exact_decode_hd1080():
    """North-star config: 1080p full-toolset AI stream decodes hash-exact."""
    path = os.path.join(TD, "ai_full_hd1080_qp37.bit")
    if not os.path.exists(path):
        pytest.skip("golden streams not generated on this machine")
    dec = Decoder()
    pics = dec.decode_stream(open(path, "rb").read())
    assert pics and dec.hash_results
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"


@pytest.mark.parametrize("name", TOOL_STREAMS)
def test_bit_exact_decode_tools(name):
    path = os.path.join(TD, f"{name}.bit")
    if not os.path.exists(path):
        pytest.skip("golden streams not generated on this machine")
    dec = Decoder()
    dec.decode_stream(open(path, "rb").read())
    assert dec.hash_results
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"


INTER_STREAMS = [
    "ld_min_tiny64_qp32",
    "ld_min_small208_qp32",
    "ld_db_small208_qp32",
    "ld_tmvp_small208_qp32",
    "ld_imv_small208_qp32",
    "ld_mmvd_small208_qp32",
    "ld_affine_small208_qp32",
    "ld_sbtmvp_small208_qp32",
    "ld_sbt_small208_qp32",
    "ldb_min_small208_qp32",
    "ldb_tools_small208_qp32",
    "ldb_full_small208_qp32",
    "ra_min_small208_qp32",
    "ra_dmvr_small208_qp32",
    "ra_full_small208_qp32",
]

PARALLEL_STREAMS = [
    "ai_wpp_small208_qp32",
    "ld_wpp_small208_qp32",
    "ai_tiles_bq416_qp32",
    "ra_wpp_bq416_qp37",
    # 2x2 tiles + 3 raster-scan slices per picture + standalone PH NAL
    "ai_slices_bq416_qp32",
]


@pytest.mark.parametrize("name", PARALLEL_STREAMS)
def test_bit_exact_decode_wpp_tiles(name):
    path = os.path.join(TD, f"{name}.bit")
    if not os.path.exists(path):
        pytest.skip("golden streams not generated on this machine")
    dec = Decoder()
    dec.decode_stream(open(path, "rb").read())
    assert dec.hash_results
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"


@pytest.mark.parametrize("name", INTER_STREAMS)
def test_bit_exact_decode_inter(name):
    path = os.path.join(TD, f"{name}.bit")
    if not os.path.exists(path):
        pytest.skip("golden streams not generated on this machine")
    dec = Decoder()
    dec.decode_stream(open(path, "rb").read())
    assert dec.hash_results
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"


SCREEN_CONTENT_STREAMS = [
    "sc_ibc_ai_qp27",
    "sc_ibc_full_ai_qp32",
    "sc_plt_ai_qp27",
    "sc_ibcplt_ai_qp32",
    "sc_ibc_ldb_qp32",
]


@pytest.mark.parametrize("name", SCREEN_CONTENT_STREAMS)
def test_bit_exact_decode_screen_content(name):
    """IBC (virtual buffer block copy) + palette mode streams."""
    path = os.path.join(TD, f"{name}.bit")
    if not os.path.exists(path):
        pytest.skip("golden streams not generated on this machine")
    dec = Decoder()
    dec.decode_stream(open(path, "rb").read())
    assert dec.hash_results
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"


TENBIT_STREAMS = [
    "ai10_small208_qp32",
    "ai10src_small208_qp27",
    "ra10_small208_qp32",
    "ai_sclist_small208_qp32",   # default scaling lists (flat 16 in VVC)
    "ai_sclaps_small208_qp32",   # CUSTOM scaling lists via APS
]


@pytest.mark.parametrize("name", TENBIT_STREAMS)
def test_bit_exact_decode_10bit_and_scaling_lists(name):
    path = os.path.join(TD, f"{name}.bit")
    if not os.path.exists(path):
        pytest.skip("golden streams not generated on this machine")
    dec = Decoder()
    dec.decode_stream(open(path, "rb").read())
    assert dec.hash_results
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"


FORMAT_TOOL_STREAMS = [
    "ai444_screen_qp32",    # 4:4:4 chroma format
    "act444_screen_qp32",   # adaptive color transform + IBC/PLT in 4:4:4
    "wp_fade_ldb_qp32",     # explicit weighted prediction (uni + bi)
    "ai422_small208_qp32",  # 4:2:2 chroma format
    # luma-correlated chroma: the reference encoder enables CC-ALF CTBs
    # (exercises the cc filter-control parse + the CC-ALF clip path)
    "ai_ccalf_cc208_qp32",
]


@pytest.mark.parametrize("name", FORMAT_TOOL_STREAMS)
def test_bit_exact_decode_formats_and_wp(name):
    path = os.path.join(TD, f"{name}.bit")
    if not os.path.exists(path):
        pytest.skip("golden streams not generated on this machine")
    dec = Decoder()
    dec.decode_stream(open(path, "rb").read())
    assert dec.hash_results
    for hr in dec.hash_results:
        assert hr.ok, f"hash mismatch at POC {hr.poc}"
