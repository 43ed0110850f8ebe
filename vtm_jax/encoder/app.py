"""Encoder application (EncApp equivalent, EncApp.cpp:1006).

Usage:  python -m vtm_jax.encoder.app -c cfg/encoder_intra_vtm.cfg \
            --InputFile=in.yuv --SourceWidth=W --SourceHeight=H --QP=32 \
            --FramesToBeEncoded=N --BitstreamFile=out.bit [--ReconFile=rec.yuv]

Supports the reference's `key : value` config-file grammar and
`--Key=value` CLI overrides (program_options_lite equivalent); unknown
options are accepted and ignored with a notice, so the reference CTC cfg
files drive this encoder directly.  IntraPeriod 1 → All-Intra encoder;
otherwise the low-delay-P encoder.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_cfg_file(path: str) -> dict:
    opts = {}
    for line in open(path):
        line = line.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        key, val = line.split(":", 1)
        opts[key.strip()] = val.strip()
    return opts


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts: dict = {}
    files = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-c", "--config"):
            opts.update(parse_cfg_file(argv[i + 1]))
            i += 2
        elif a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            opts[k] = v
            i += 1
        elif a.startswith("--"):
            opts[a[2:]] = argv[i + 1]
            i += 2
        else:
            files.append(a)
            i += 1

    def geti(key, default):
        return int(float(opts.get(key, default)))

    w = geti("SourceWidth", 0)
    h = geti("SourceHeight", 0)
    qp = geti("QP", 32)
    n = geti("FramesToBeEncoded", 1)
    intra_period = geti("IntraPeriod", -1)
    infile = opts.get("InputFile")
    outfile = opts.get("BitstreamFile", "out.bit")
    recon = opts.get("ReconFile")
    bd = geti("InputBitDepth", 8)
    if not (w and h and infile):
        print("need InputFile, SourceWidth, SourceHeight", file=sys.stderr)
        return 2

    import numpy as np

    from vtm_jax.common.types import ChromaFormat
    from vtm_jax.encoder.enc_lib import (
        EncoderConfig, InterEncoder, IntraEncoder, LowDelayBEncoder,
        RandomAccessEncoder,
    )
    from vtm_jax.utils import yuv_io

    fmt = yuv_io.YuvFormat(w, h, ChromaFormat.YUV420, bd)
    frames = yuv_io.read_yuv(infile, fmt, n)
    cfg = EncoderConfig(width=w, height=h, qp=qp, bit_depth=bd)
    if geti("RateControl", 0) and geti("TargetBitrate", 0):
        cfg.target_bitrate = geti("TargetBitrate", 0)
        cfg.frame_rate = float(opts.get("FrameRate", 30))
    # EncAppCfg SEIDecodedPictureHash defaults to 0 (EncAppCfg.cpp); the
    # library-level EncoderConfig default stays 1 so conformance tests
    # self-check, but a cfg-driven run must match reference CLI rate
    # semantics (a 58-byte/picture hash SEI skews any comparison)
    cfg.hash_sei = geti("SEIDecodedPictureHash", 0) != 0
    gop_size = geti("GOPSize", 1)
    frame1 = opts.get("Frame1", "")
    if intra_period == 1:
        enc = IntraEncoder(cfg)
    elif gop_size > 2:
        # hierarchical GOP (encoder_randomaccess_vtm.cfg shape)
        enc = RandomAccessEncoder(cfg, gop_size=min(gop_size, 16))
    elif frame1.strip().startswith("B"):
        enc = LowDelayBEncoder(cfg)
    else:
        enc = InterEncoder(cfg)
    t0 = time.time()
    bits = enc.encode(frames)
    dt = time.time() - t0
    open(outfile, "wb").write(bits)

    def psnr(a, b, maxv):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return 10 * np.log10(maxv * maxv / mse) if mse else 99.0

    maxv = (1 << bd) - 1
    py = psnr(frames[-1][0], enc.last_recon[0], maxv)
    # per-picture log + Analyze-style sequence summary
    for r in getattr(enc, "frame_log", []):
        print(f"POC {r['poc']:4d} ( {r['type']}-SLICE, QP {r['qp']:2d} ) "
              f"{r['bits']:10d} bits [Y {r['psnr'][0]:8.4f} dB  "
              f"U {r['psnr'][1]:8.4f} dB  V {r['psnr'][2]:8.4f} dB]")
    summary = enc.sequence_summary() if hasattr(enc, "sequence_summary") else {}
    for st, s in summary.items():
        print(f"{st} Slices: {s['pics']} pics, {s['bits']} bits, avg PSNR "
              f"Y {s['psnr'][0]:.4f} U {s['psnr'][1]:.4f} V {s['psnr'][2]:.4f}")
    print(f"encoded {len(frames)} frames → {len(bits) * 8} bits in {dt:.1f} s "
          f"({len(frames) / dt:.3f} fps), last-frame Y-PSNR {py:.2f} dB")
    if recon:
        # re-decode our own stream for the recon file (bit-exact recon)
        from vtm_jax.decoder.declib import Decoder

        dec = Decoder()
        pics = dec.decode_stream(bits)
        yuv_io.write_yuv(recon, [p.planes for p in pics], fmt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
