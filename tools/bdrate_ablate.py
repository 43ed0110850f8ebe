"""Round-5 BD-rate ladder + per-tool ablations (VERDICT r4 item 2).

Runs the RA and AI QP ladders on a clip with the current encoder and a
set of single-tool ablations, measures the reference EncoderApp anchor
once, and writes one JSON per config to --out (default bdr_runs/).
Streams are conformance-checked with the reference DecoderApp.

  python tools/bdrate_ablate.py --yuv testdata/small208x9_208x120_420_8.yuv \
      --width 208 --height 120 --frames 9 --qps 27,32,37 \
      --configs ra_base,ra_no_ciip,...

Configs: ra_base, ra_no_ciip, ra_no_ccalf, ra_tcq4, ra_no_rmd, ai_base,
ai_tcq4 (and *_fast variants set by the caller via env).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.bdrate import (REF_BIN, bd_rate, psnr, read_yuv,  # noqa: E402
                          ref_decode_check, run_reference)


def encode_cfg(name, frames, w, h, qp):
    from vtm_jax.encoder.enc_lib import (EncoderConfig, IntraEncoder,
                                         RandomAccessEncoder)

    cfg = EncoderConfig(width=w, height=h, qp=qp)
    cfg.sao = cfg.alf = cfg.ccalf = cfg.dep_quant = True
    cfg.hash_sei = False  # CTC rate excludes the hash SEI
    mode = name.split("_")[0]
    if mode == "ai":
        cfg.mts = cfg.lfnst = cfg.mip = cfg.mrl = cfg.cclm = cfg.isp = True
    env = {}
    if "tcq4" in name:
        env["VTM_TCQ_4STATE"] = "1"
    if "no_ccalf" in name:
        cfg.ccalf = False
    if "no_rmd" in name:
        cfg.satd_rmd = False
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if mode == "ai":
            enc = IntraEncoder(cfg)
        else:
            # tool-off ablations: raise the RA CTC defaults first, then
            # clear the ablated tool BEFORE the encoder builds its SPS
            cfg.mmvd = cfg.amvr = cfg.geo = cfg.ciip = cfg.affine = True
            cfg.num_active_refs = max(cfg.num_active_refs, 2)
            # affine_amvp / sbt default off (each measured ~+1.2% RA
            # BD-rate on this ladder); 'r5tools'/'no_*' names toggle them
            if "r5tools" in name or "sbt_on" in name:
                cfg.sbt = True
            if "r5tools" in name or "affamvp_on" in name:
                cfg.affine_amvp = True
            if "no_ciip" in name:
                cfg.ciip = False
            if "no_affine" in name:
                cfg.affine = False
            if "no_sbt" in name:
                cfg.sbt = False
            enc = RandomAccessEncoder(cfg, raise_tool_defaults=False)
        return enc.encode(frames)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--yuv", required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--qps", default="27,32,37")
    ap.add_argument("--configs", default="ra_base")
    ap.add_argument("--out", default="bdr_runs")
    args = ap.parse_args()
    qps = [int(q) for q in args.qps.split(",")]
    frames = read_yuv(args.yuv, args.width, args.height, args.frames)
    os.makedirs(args.out, exist_ok=True)
    tag = os.path.basename(args.yuv).split("_")[0]

    # anchors (measured once per mode, cached on disk)
    anchors = {}
    for mode in {c.split("_")[0] for c in args.configs.split(",")}:
        apath = os.path.join(args.out, f"anchor_{tag}_{mode}.json")
        if os.path.exists(apath):
            anchors[mode] = json.load(open(apath))
            continue
        ref_r, ref_p = [], []
        with tempfile.TemporaryDirectory() as wd:
            for qp in qps:
                bit, recf = run_reference(
                    args.yuv, args.width, args.height, args.frames,
                    mode, qp, wd)
                rec = read_yuv(recf, args.width, args.height, args.frames)
                pw, _ = psnr(frames, rec)
                ref_r.append(os.path.getsize(bit) * 8 * 30 / args.frames)
                ref_p.append(pw)
                print(f"[anchor {mode}] qp={qp}: {ref_r[-1]/1000:.1f} kbps "
                      f"{pw:.3f} dB", flush=True)
        anchors[mode] = {"qps": qps, "bps": ref_r, "psnr": ref_p}
        json.dump(anchors[mode], open(apath, "w"))

    from tools.bdrate import decode_ours
    for name in args.configs.split(","):
        opath = os.path.join(args.out, f"{tag}_{name}.json")
        if os.path.exists(opath):
            print(f"[{name}] cached", flush=True)
            continue
        mode = name.split("_")[0]
        ours_r, ours_p, conf = [], [], True
        with tempfile.TemporaryDirectory() as wd:
            for qp in qps:
                bs = encode_cfg(name, frames, args.width, args.height, qp)
                rec = decode_ours(bs)
                pw, _ = psnr(frames, rec)
                ours_r.append(len(bs) * 8 * 30 / args.frames)
                ours_p.append(pw)
                bp = os.path.join(wd, "b.bit")
                open(bp, "wb").write(bs)
                ok = ref_decode_check(bp, wd)
                conf = conf and (ok is not False)
                print(f"[{name}] qp={qp}: {ours_r[-1]/1000:.1f} kbps "
                      f"{pw:.3f} dB refdec={ok}", flush=True)
        a = anchors[mode]
        res = {
            "config": name, "clip": tag, "qps": qps,
            "kbps": [r / 1000 for r in ours_r], "psnr": ours_p,
            "anchor_kbps": [r / 1000 for r in a["bps"]],
            "anchor_psnr": a["psnr"],
            "bd_rate_pct": round(bd_rate(a["bps"], a["psnr"],
                                         ours_r, ours_p), 2),
            "ref_decoder_conformant": conf,
        }
        json.dump(res, open(opath, "w"), indent=1)
        print(f"[{name}] BD-rate {res['bd_rate_pct']:+.2f}% "
              f"conformant={conf}", flush=True)


if __name__ == "__main__":
    main()
