"""Decoder application (DecApp equivalent, DecApp.cpp:76).

Usage:  python -m vtm_jax.decoder.app -b in.bit -o out.yuv [-d bitdepth]
                                      [--opl out.opl]

Decodes an Annex-B VVC bitstream, writes the output pictures in display
order, verifies decoded-picture-hash SEIs, and optionally writes a
conformance `.opl` file (POC, resolution, MD5 per picture —
DecApp.cpp:329-333).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vtm_jax-decoder")
    ap.add_argument("-b", "--bitstream", required=True)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-d", "--output-bit-depth", type=int, default=0,
                    help="0 = native internal bit depth")
    ap.add_argument("--opl", default=None)
    ap.add_argument("--stats", action="store_true",
                    help="per-syntax bit statistics (analyser build)")
    args = ap.parse_args(argv)

    from vtm_jax.decoder.declib import Decoder
    from vtm_jax.utils import pic_hash, yuv_io

    data = open(args.bitstream, "rb").read()
    dec = Decoder()
    if args.stats:
        from vtm_jax.decoder.stats import BitStats

        dec.bit_stats = BitStats()
    t0 = time.time()
    pics = dec.decode_stream(data)
    dt = time.time() - t0
    mismatches = 0
    for hr in dec.hash_results:
        status = "OK" if hr.ok else "***ERROR***"
        print(f"POC {hr.poc:5d}  [MD5:{hr.computed.hex()},({status})]")
        mismatches += 0 if hr.ok else 1
    sps = dec.psm.sps[pics[0].sps_id] if pics else None
    bd = sps.bit_depth if sps else 8
    if args.output and pics:
        out_bd = args.output_bit_depth or bd
        h, w = pics[0].planes[0].shape
        fmt = yuv_io.YuvFormat(w, h, sps.chroma_format, out_bd)
        frames = [yuv_io.scale_planes(p.planes, out_bd - bd) for p in pics]
        yuv_io.write_yuv(args.output, frames, fmt)
    if args.opl and pics:
        with open(args.opl, "w") as f:
            for p in pics:
                digest = pic_hash.pic_md5(p.planes, [bd] * len(p.planes))
                h, w = p.planes[0].shape
                f.write(f"{p.poc},{w},{h},{digest.hex()}\n")
    if args.stats and dec.bit_stats is not None:
        print(dec.bit_stats.report())
    n = len(pics)
    print(f"decoded {n} pictures in {dt:.2f} s ({n / dt:.2f} fps), "
          f"{mismatches} hash mismatches")
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
