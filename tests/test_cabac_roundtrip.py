"""CABAC encoder/decoder round-trip: random bin sequences must survive."""

import numpy as np

from vtm_jax.bitstream.writer import BitWriter
from vtm_jax.decoder.cabac import CabacDecoder, ContextModels
from vtm_jax.encoder.bin_encoder import BinEncoder


def test_cabac_roundtrip():
    rng = np.random.default_rng(42)
    n = 2000
    ops = []
    for _ in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:
            ops.append(("ctx", int(rng.integers(0, 393)), int(rng.integers(0, 2))))
        elif kind == 1:
            ops.append(("ep", int(rng.integers(0, 2))))
        else:
            nb = int(rng.integers(1, 16))
            ops.append(("eps", int(rng.integers(0, 1 << nb)), nb))
    ctx_e = ContextModels()
    ctx_e.init(32, 2)
    bw = BitWriter()
    enc = BinEncoder(bw, ctx_e)
    enc.start()
    for op in ops:
        if op[0] == "ctx":
            enc.encode_bin(op[2], op[1])
        elif op[0] == "ep":
            enc.encode_bin_ep(op[1])
        else:
            enc.encode_bins_ep(op[1], op[2])
    enc.encode_bin_trm(1)
    enc.finish()
    bw.write_byte_alignment()
    data = bw.data()

    ctx_d = ContextModels()
    ctx_d.init(32, 2)
    dec = CabacDecoder(data, ctx_d)
    dec.start()
    for op in ops:
        if op[0] == "ctx":
            assert dec.decode_bin(op[1]) == op[2]
        elif op[0] == "ep":
            assert dec.decode_bin_ep() == op[1]
        else:
            assert dec.decode_bins_ep(op[2]) == op[1]
    assert dec.decode_bin_trm() == 1
    # context states must match exactly after the run
    assert (ctx_e.state0 == ctx_d.state0).all()
    assert (ctx_e.state1 == ctx_d.state1).all()


def test_rem_abs_roundtrip():
    rng = np.random.default_rng(7)
    vals = [int(v) for v in rng.integers(0, 4000, size=200)]
    pars = [int(p) for p in rng.integers(0, 4, size=200)]
    ctx = ContextModels()
    ctx.init(30, 2)
    bw = BitWriter()
    enc = BinEncoder(bw, ctx)
    enc.start()
    for v, p in zip(vals, pars):
        enc.encode_rem_abs_ep(v, p, 5, 15)
    enc.encode_bin_trm(1)
    enc.finish()
    bw.write_byte_alignment()
    dec = CabacDecoder(bw.data(), ContextModels())
    dec.start()
    for v, p in zip(vals, pars):
        assert dec.decode_rem_abs_ep(p, 5, 15) == v
