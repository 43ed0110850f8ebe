"""MCTS MV-constraint checks + bitrate-targeting lambda guesser."""

import numpy as np


def test_mcts_mv_constraint():
    from types import SimpleNamespace

    from vtm_jax.common import mcts

    pps = SimpleNamespace(ctu_to_tile_col=[0, 0, 1, 1],
                          ctu_to_tile_row=[0, 0],
                          tile_col_bd=[0, 2, 4], tile_row_bd=[0, 2])
    sps = SimpleNamespace(ctu_size=64, ctu_size_log2=6)
    dcs = SimpleNamespace(pps=pps, sps=sps, pic_w=256, pic_h=128)
    blk = (16, 16, 16, 16)
    assert mcts.check_mv(dcs, blk, (0, 0))
    assert mcts.check_mv(dcs, blk, (16 << 4, 0))  # integer, inside tile
    # crossing the x=128 tile boundary is illegal
    assert not mcts.check_mv(dcs, blk, (112 << 4, 0))
    # fractional MV near the tile edge needs the filter margin
    assert not mcts.check_mv(dcs, blk, ((95 << 4) + 8, 0))
    assert mcts.check_mv(dcs, blk, ((90 << 4) + 8, 0))
    # clip pulls an out-of-area MV back inside
    mv = mcts.clip_mv_to_area((400 << 4, -100 << 4), blk, (0, 0, 128, 128))
    assert mcts.check_mv(dcs, blk, mv)


def test_guess_lambda_modifiers_converges():
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools.bitrate_targeting import guess_lambda_modifier

    # synthetic encoder: bitrate ~ 1000 / lm**0.7
    def rate(lm):
        return 1000.0 / lm ** 0.7

    target = 600.0
    pts = [(1.0, rate(1.0))]
    for _ in range(10):
        lm = guess_lambda_modifier(target, pts)
        pts.append((lm, rate(lm)))
    assert abs(pts[-1][1] - target) / target < 0.05  # within 5%
