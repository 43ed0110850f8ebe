"""BD-rate harness: encode the same clip with this encoder and the
reference EncoderApp across a QP ladder, and report the Bjontegaard
delta-rate (BASELINE.md quality bar: BD-rate <= 0 vs VTM).

Usage:
  python tools/bdrate.py --yuv testdata/small208.yuv --width 208 \
      --height 120 --frames 8 --mode ra --qps 22,27,32,37

The reference binaries are built per .claude/skills/verify/SKILL.md at
/tmp/vtm-build/; pass --ref-bin to override.  Each of our streams is also
decoded by the reference DecoderApp as a conformance check.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_BIN = "/tmp/vtm-src/bin/ninja/gcc-12.2/x86_64/release"
REF_CFG = "/root/reference/cfg"


def read_yuv(path, w, h, n, bit_depth=8):
    dt = np.uint8 if bit_depth == 8 else np.uint16
    ysz, csz = w * h, (w // 2) * (h // 2)
    frames = []
    with open(path, "rb") as f:
        for _ in range(n):
            y = np.frombuffer(f.read(ysz * dt().itemsize), dtype=dt).reshape(h, w)
            cb = np.frombuffer(f.read(csz * dt().itemsize), dtype=dt).reshape(h // 2, w // 2)
            cr = np.frombuffer(f.read(csz * dt().itemsize), dtype=dt).reshape(h // 2, w // 2)
            frames.append([p.astype(np.int32) for p in (y, cb, cr)])
    return frames


def psnr(src_frames, rec_frames, bit_depth=8):
    maxv = (1 << bit_depth) - 1
    psnrs = []
    for comp in range(3):
        se = cnt = 0
        for s, r in zip(src_frames, rec_frames):
            d = s[comp].astype(np.float64) - r[comp].astype(np.float64)
            se += float((d * d).sum())
            cnt += d.size
        mse = se / cnt if cnt else 0.0
        p = 10 * np.log10(maxv * maxv / mse) if mse > 0 else 99.0
        psnrs.append(p)
    # weighted YUV PSNR (JVET convention (6*Y + U + V) / 8)
    return (6 * psnrs[0] + psnrs[1] + psnrs[2]) / 8, psnrs


def bd_rate(r1, p1, r2, p2):
    """Bjontegaard delta rate of (r2,p2) vs anchor (r1,p1), percent."""
    lr1, lr2 = np.log(r1), np.log(r2)
    f1 = np.polyfit(p1, lr1, 3)
    f2 = np.polyfit(p2, lr2, 3)
    lo = max(min(p1), min(p2))
    hi = min(max(p1), max(p2))
    i1 = np.polyint(f1)
    i2 = np.polyint(f2)
    v1 = np.polyval(i1, hi) - np.polyval(i1, lo)
    v2 = np.polyval(i2, hi) - np.polyval(i2, lo)
    avg = (v2 - v1) / (hi - lo)
    return (np.exp(avg) - 1) * 100


def encode_ours(frames, w, h, mode, qp, bit_depth=8):
    from vtm_jax.encoder.enc_lib import (
        EncoderConfig, IntraEncoder, LowDelayBEncoder, RandomAccessEncoder)

    cfg = EncoderConfig(width=w, height=h, qp=qp, bit_depth=bit_depth)
    cfg.sao = True
    cfg.dep_quant = True
    cfg.alf = True
    cfg.ccalf = True
    # VTM CTC rate excludes the decoded-picture-hash SEI (EncApp default
    # off); correctness is still checked via the reference DecoderApp below
    cfg.hash_sei = False
    if mode == "ai":
        cfg.mts = cfg.lfnst = cfg.mip = cfg.mrl = cfg.cclm = cfg.isp = True
        enc = IntraEncoder(cfg)
    elif mode == "ld":
        enc = LowDelayBEncoder(cfg)
    else:
        enc = RandomAccessEncoder(cfg)
    return enc.encode(frames)


def decode_ours(bitstream):
    from vtm_jax.decoder.declib import Decoder

    dec = Decoder()
    pics = dec.decode_stream(bitstream)
    assert all(hr.ok for hr in dec.hash_results)
    return [[p.astype(np.int32) for p in pic.planes] for pic in pics]


def run_reference(yuv, w, h, n, mode, qp, workdir):
    cfgs = {
        "ai": "encoder_intra_vtm.cfg",
        "ld": "encoder_lowdelay_vtm.cfg",
        "ra": "encoder_randomaccess_vtm.cfg",
    }
    bit = os.path.join(workdir, f"ref_{mode}_{qp}.bit")
    rec = os.path.join(workdir, f"ref_{mode}_{qp}.yuv")
    args = [
        os.path.join(REF_BIN, "EncoderApp"),
        "-c", os.path.join(REF_CFG, cfgs[mode]),
        "-i", yuv, "-wdt", str(w), "-hgt", str(h),
        "-fr", "30", "-f", str(n), "-q", str(qp),
        "-b", bit, "-o", rec, "--TemporalSubsampleRatio=1",
        "--ConformanceWindowMode=1", "--InternalBitDepth=8",
    ]
    if mode == "ra":
        args += ["--IntraPeriod=32"]
    subprocess.run(args, check=True, capture_output=True)
    return bit, rec


def ref_decode_check(bit, workdir):
    """Decode one of our streams with the reference DecoderApp."""
    dec = os.path.join(REF_BIN, "DecoderApp")
    if not os.path.exists(dec):
        return None
    out = subprocess.run([dec, "-b", bit, "-o", os.path.join(workdir, "chk.yuv")],
                         capture_output=True, text=True)
    ok = out.returncode == 0 and "mismatch" not in out.stdout.lower()
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--yuv", required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--mode", default="ra", choices=("ai", "ld", "ra"))
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--skip-ref", action="store_true",
                    help="only report our rate/PSNR points")
    args = ap.parse_args()

    qps = [int(q) for q in args.qps.split(",")]
    frames = read_yuv(args.yuv, args.width, args.height, args.frames)
    npix = args.width * args.height * args.frames

    ours_r, ours_p = [], []
    conformant = True
    with tempfile.TemporaryDirectory() as wd:
        for qp in qps:
            bs = encode_ours(frames, args.width, args.height, args.mode, qp)
            rec = decode_ours(bs)
            pw, _ = psnr(frames, rec)
            ours_r.append(len(bs) * 8 * 30 / args.frames)  # bits/s @30fps
            ours_p.append(pw)
            bp = os.path.join(wd, f"ours_{qp}.bit")
            with open(bp, "wb") as f:
                f.write(bs)
            chk = ref_decode_check(bp, wd)
            if chk is False:
                conformant = False
            print(f"ours qp={qp}: {ours_r[-1]/1000:.1f} kbps  "
                  f"{pw:.3f} dB  refdec={'OK' if chk else chk}", file=sys.stderr)

        result = {
            "mode": args.mode,
            "ours": {"kbps": [r / 1000 for r in ours_r], "psnr": ours_p},
            "ref_decoder_conformant": conformant,
        }
        if not args.skip_ref and os.path.exists(os.path.join(REF_BIN, "EncoderApp")):
            ref_r, ref_p = [], []
            for qp in qps:
                bit, recf = run_reference(args.yuv, args.width, args.height,
                                          args.frames, args.mode, qp, wd)
                rec = read_yuv(recf, args.width, args.height, args.frames)
                pw, _ = psnr(frames, rec)
                ref_r.append(os.path.getsize(bit) * 8 * 30 / args.frames)
                ref_p.append(pw)
                print(f"ref  qp={qp}: {ref_r[-1]/1000:.1f} kbps  {pw:.3f} dB",
                      file=sys.stderr)
            result["ref"] = {"kbps": [r / 1000 for r in ref_r], "psnr": ref_p}
            result["bd_rate_vs_ref_pct"] = round(
                bd_rate(ref_r, ref_p, ours_r, ours_p), 2)
        print(json.dumps(result))


if __name__ == "__main__":
    main()
