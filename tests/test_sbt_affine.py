"""SBT and affine-AMVP encoder tool tests.

Both tools go through the real CABAC writer (not just the estimator twin)
and must survive a full self-decode with decoded-picture-hash verification.
SBT rarely wins RD on the synthetic clips, so the SBT test forces the
RD competition to the SBT candidates (monkeypatched trial set) to pin the
sbt_mode / transform_unit syntax path; the affine test uses a synthetic
rotation so affine AMVP wins naturally.
"""

import numpy as np
import pytest

from vtm_jax.common.types import ChromaFormat
from vtm_jax.decoder.declib import Decoder
from vtm_jax.encoder import enc_lib as EL
from vtm_jax.utils.yuv_io import YuvFormat, read_yuv

TESTDATA = "testdata"


def _load(n):
    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    return read_yuv(f"{TESTDATA}/small208_208x120_420_8.yuv", fmt, n)


def test_sbt_stream_roundtrip(monkeypatch):
    """A stream containing real SBT CUs decodes hash-exact."""
    frames = _load(3)
    f2 = [p.copy() for p in frames[2]]
    f2[0][:60, :104] = np.clip(f2[0][:60, :104] + 25, 0, 255)
    frames[2] = f2

    # force the RD competition to SBT candidates only (plus skip/intra):
    # every half config offered, all competing non-skip trials withdrawn
    monkeypatch.setattr(
        EL.InterEncoder, "_sbt_pick",
        lambda self, a, lst, ri, mv:
        ([1, 1 | 16] if a.w >= 8 else []) + ([2, 2 | 16] if a.h >= 8 else []))
    for name in ("_try_mmvd", "_try_geo", "_try_ciip", "_try_affine_merge"):
        monkeypatch.setattr(EL.InterEncoder, name,
                            lambda self, *a, **k: None)
    orig_amvp = EL.InterEncoder._try_amvp
    monkeypatch.setattr(
        EL.InterEncoder, "_try_amvp",
        lambda self, a, part, lst, mv, mvpi, est, ref_idx=0, sbt_info=0:
        (orig_amvp(self, a, part, lst, mv, mvpi, est, ref_idx=ref_idx,
                   sbt_info=sbt_info) if sbt_info else None))
    orig_merge = EL.InterEncoder._try_merge
    monkeypatch.setattr(
        EL.InterEncoder, "_try_merge",
        lambda self, a, part, idx, skip, est, sbt_info=0:
        (orig_merge(self, a, part, idx, skip, est, sbt_info=sbt_info)
         if (skip or sbt_info) else None))

    cfg = EL.EncoderConfig(width=208, height=120, qp=32)
    cfg.sbt = True
    enc = EL.RandomAccessEncoder(cfg, gop_size=4)
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    for hr in dec.hash_results:
        assert hr.ok, f"decoded-picture-hash mismatch at POC {hr.poc}"
    n_sbt = sum(1 for p in pics if hasattr(p, "dcs")
                for c in p.dcs.cus if getattr(c, "sbt_info", 0))
    assert n_sbt > 0, "no SBT CU reached the bitstream"


def test_affine_amvp_rotation_roundtrip():
    """Synthetic rotation/zoom: affine AMVP CUs win naturally and the
    stream decodes hash-exact."""
    base = _load(1)[0]
    H, W = 120, 208
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    frames = [base]
    for k in (1, 2):
        ang, s = 0.01 * k, 1.0 + 0.01 * k
        cy, cx = H / 2, W / 2
        xs = (np.cos(ang) * (xx - cx) - np.sin(ang) * (yy - cy)) / s + cx
        ys = (np.sin(ang) * (xx - cx) + np.cos(ang) * (yy - cy)) / s + cy
        xi = np.clip(xs.astype(int), 0, W - 1)
        yi = np.clip(ys.astype(int), 0, H - 1)
        y = base[0][yi, xi]
        u = base[1][np.clip(yi[::2, ::2] // 2, 0, H // 2 - 1),
                    np.clip(xi[::2, ::2] // 2, 0, W // 2 - 1)]
        v = base[2][np.clip(yi[::2, ::2] // 2, 0, H // 2 - 1),
                    np.clip(xi[::2, ::2] // 2, 0, W // 2 - 1)]
        frames.append([y.astype(np.int32), u.astype(np.int32),
                       v.astype(np.int32)])
    cfg = EL.EncoderConfig(width=208, height=120, qp=32)
    cfg.affine_amvp = True
    enc = EL.RandomAccessEncoder(cfg, gop_size=4)
    bits = enc.encode(frames)
    dec = Decoder()
    pics = dec.decode_stream(bits)
    for hr in dec.hash_results:
        assert hr.ok, f"decoded-picture-hash mismatch at POC {hr.poc}"
    n_aff = sum(1 for p in pics if hasattr(p, "dcs")
                for c in p.dcs.cus
                if getattr(c, "affine", False) and not c.merge_flag)
    assert n_aff > 0, "no affine AMVP CU reached the bitstream"
