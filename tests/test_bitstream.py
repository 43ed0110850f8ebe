"""Bit-level reader tests."""

import numpy as np
import pytest

from vtm_jax.bitstream.reader import (
    BitReader,
    ebsp_to_rbsp,
    parse_nal,
    split_annexb,
)


def test_u_reads_msb_first():
    r = BitReader(bytes([0b10110001, 0b01000000]))
    assert r.u(1) == 1
    assert r.u(3) == 0b011
    assert r.u(4) == 0b0001
    assert r.u(2) == 0b01


def test_ue_se():
    # ue codes: 1 -> 0; 010 -> 1; 011 -> 2; 00100 -> 3
    bits = "1" + "010" + "011" + "00100"
    bits += "0" * (8 - len(bits) % 8)
    data = int(bits, 2).to_bytes(len(bits) // 8, "big")
    r = BitReader(data)
    assert r.ue() == 0
    assert r.ue() == 1
    assert r.ue() == 2
    assert r.ue() == 3
    # se mapping: k=0->0, 1->1, 2->-1, 3->2, 4->-2
    bits = "1" + "010" + "011" + "00100" + "00101"
    bits += "0" * ((8 - len(bits) % 8) % 8)
    r = BitReader(int(bits, 2).to_bytes((len(bits) + 7) // 8, "big"))
    assert r.se() == 0
    assert r.se() == 1
    assert r.se() == -1
    assert r.se() == 2
    assert r.se() == -2


def test_ebsp_to_rbsp():
    assert ebsp_to_rbsp(b"\x00\x00\x03\x01") == b"\x00\x00\x01"
    assert ebsp_to_rbsp(b"\x00\x00\x03\x03") == b"\x00\x00\x03"
    # 03 not preceded by 00 00 is kept
    assert ebsp_to_rbsp(b"\x01\x00\x03\x00") == b"\x01\x00\x03\x00"
    # 00 00 03 followed by >3 is kept (not an emulation byte)
    assert ebsp_to_rbsp(b"\x00\x00\x03\x04") == b"\x00\x00\x03\x04"


def test_split_annexb():
    stream = b"\x00\x00\x01\xaa\xbb" + b"\x00\x00\x00\x01\xcc" + b"\x00\x00\x01\xdd\xee\xff"
    nals = split_annexb(stream)
    assert nals == [b"\xaa\xbb", b"\xcc", b"\xdd\xee\xff"]


def test_parse_nal_header():
    # layer 0, nal_unit_type 15 (SPS), tid 0 => bytes 0x00, (15<<3)|1
    nal = parse_nal(bytes([0x00, (15 << 3) | 1, 0x42]))
    assert nal.nal_unit_type == 15
    assert nal.temporal_id == 0
    assert nal.layer_id == 0
    assert nal.rbsp == b"\x42"


def test_more_rbsp_data():
    # one flag bit = 1, then stop bit 1, padding zeros: byte 11000000
    r = BitReader(bytes([0b11000000]))
    assert r.more_rbsp_data()
    r.u(1)
    assert not r.more_rbsp_data()
