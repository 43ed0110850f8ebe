"""ROM table sanity tests against well-known VVC spec values."""

import numpy as np

from vtm_jax.common import rom


def test_dct2_p4_inverse():
    m = rom.tr_matrix("DCT2", 4, forward=False)
    assert m[0].tolist() == [64, 64, 64, 64]
    assert m[1].tolist() == [83, 36, -36, -83]


def test_quant_scales():
    assert rom.quant_scale(0, False) == 26214
    assert rom.inv_quant_scale(4, False) == 64


def test_scan_4x4_diag():
    s = rom.scan(1, 4, 4)
    # up-right diagonal: (0,0),(0,1),(1,0),(0,2)... as (raster,x,y)
    assert s[0].tolist() == [0, 0, 0]
    assert s[1].tolist() == [4, 0, 1]
    assert s[2].tolist() == [1, 1, 0]
    assert s.shape == (16, 3)


def test_ctx_tables():
    n = rom.num_contexts()
    assert n == 393  # VTM 9.3 context count
    for i in range(4):
        assert rom.ctx_init_table(i).shape == (n,)
    offs = rom.ctx_offsets()
    assert "SplitFlag" in offs and offs["SplitFlag"][0] == 0
    assert offs["SplitFlag"][1] == 9
    # all (offset, size) ranges must tile within [0, n)
    for name, (o, s) in offs.items():
        assert 0 <= o and o + s <= n, name


def test_interp_half_pel():
    assert rom.luma_filter()[8].tolist() == [-1, 4, -11, 40, 40, -11, 4, -1]


def test_mip_shapes():
    assert rom.mip_matrix(0).shape == (16, 16, 4)
    assert rom.mip_matrix(1).shape == (8, 16, 8)
    assert rom.mip_matrix(2).shape == (6, 64, 7)
