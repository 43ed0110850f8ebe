"""Decoder error resilience: lost-reference concealment
(DecLib::xCreateLostPicture, DecLib.cpp:818) and tolerant NAL skipping."""

import os

import numpy as np
import pytest

from vtm_jax.bitstream import reader as nalio
from vtm_jax.decoder.declib import Decoder

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "testdata")


def _nal_units(path):
    with open(path, "rb") as f:
        data = f.read()
    return nalio.split_annexb(data)


def test_lost_reference_concealment():
    """Drop one leading reference picture's slice NAL from an RA stream:
    the decoder must conceal it from the nearest decoded picture and finish
    the stream (hashes of pictures predicting from the concealed one will
    mismatch, but nothing may crash)."""
    nals = _nal_units(os.path.join(TESTDATA, "ra_full_small208_qp32.bit"))
    # find the second slice NAL (a reference B picture) and drop it
    slice_idx = [i for i, e in enumerate(nals)
                 if nalio.parse_nal(e).nal_unit_type in nalio.SLICE_NAL_TYPES]
    assert len(slice_idx) >= 3
    dropped = slice_idx[1]
    stream = b"".join(
        b"\x00\x00\x00\x01" + e for i, e in enumerate(nals) if i != dropped)
    dec = Decoder(strict=False)
    pics = dec.decode_stream(stream)
    assert dec.concealed_count >= 1
    assert len(pics) >= 1


def test_tolerant_mode_skips_garbage_nal():
    nals = _nal_units(os.path.join(TESTDATA, "ai_full_tiny64_qp32.bit"))
    rng = np.random.default_rng(0)
    garbage = bytes([0x01, 0x00]) + rng.integers(0, 255, 64).astype(np.uint8).tobytes()
    stream = (b"\x00\x00\x00\x01" + nals[0]
              + b"\x00\x00\x00\x01" + garbage)
    for e in nals[1:]:
        stream += b"\x00\x00\x00\x01" + e
    clean = Decoder()
    n_clean = len(clean.decode_stream(
        b"".join(b"\x00\x00\x00\x01" + e for e in nals)))
    dec = Decoder(strict=False)
    pics = dec.decode_stream(stream)
    # the garbage NAL is skipped (counted), every real picture still decodes
    assert dec.error_count >= 1
    assert len(pics) == n_clean
    assert all(hr.ok for hr in dec.hash_results)
