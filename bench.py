"""Benchmark entry point — prints ONE JSON line, on a GPU only.

END-TO-END metric: full decode throughput (CABAC parse + MV derivation on
host, batched MC/DMVR/BDOF + whole-plane deblock/SAO/ALF device kernels)
of the reference RA bitstream ra_full_bq416_qp37 (8 frames, 416x240, full
VVC inter toolset), decoded-picture-hash verified.

vs_baseline compares against the reference DecoderApp single-thread decode
of the same stream.  The anchor is MEASURED at bench time when the
reference binary is present (its own "Total Time" meter,
source/App/DecoderApp/DecApp.cpp:76); otherwise a fixed anchor is used and
flagged "fallback".

The JSON names the device the kernels ran on, with the card's name and
power limit; the script exits nonzero when JAX's default backend is not a
GPU, so a CPU run never reports a device number.
"""

import json
import os
import re
import subprocess
import sys
import time

# VTM 9.3 reference-software anchors (single-thread CPU runs of the
# reference apps, see BASELINE.md), used when the binaries are absent
VTM_DECODE_FPS_FALLBACK = 72.7  # DecoderApp "Total Time" 0.110 s / 8 frames
VTM_ENCODE_AI_FPS_FALLBACK = 1 / 3.046  # EncoderApp AI small208 qp32
# 1080p AI qp37: EncoderApp "Total Time" 81.7 s / 2 frames
# (testdata/ai_full_hd1080_qp37.enc.log)
VTM_ENCODE_HD1080_AI_FPS = 0.0245

VTM_BIN = "/tmp/vtm-src/bin/ninja/gcc-12.2/x86_64/release"


def measure_vtm_decode_fps(stream: str, frames: int):
    dec = os.path.join(VTM_BIN, "DecoderApp")
    if not os.path.exists(dec):
        return VTM_DECODE_FPS_FALLBACK, "fallback"
    try:
        best = None
        for _ in range(3):
            out = subprocess.run(
                [dec, "-b", stream, "-o", "/dev/null"],
                capture_output=True, text=True, timeout=120).stdout
            m = re.search(r"Total Time:\s+([0-9.]+)\s+sec", out)
            if not m:
                return VTM_DECODE_FPS_FALLBACK, "fallback"
            t = float(m.group(1))
            best = t if best is None else min(best, t)
        return frames / best, "measured"
    except Exception:
        return VTM_DECODE_FPS_FALLBACK, "fallback"


def measure_vtm_encode_ai_fps():
    """EncoderApp AI, 1 frame of small208 at QP32 (matching _encode_once)."""
    enc = os.path.join(VTM_BIN, "EncoderApp")
    cfg = "/root/reference/cfg/encoder_intra_vtm.cfg"
    if not (os.path.exists(enc) and os.path.exists(cfg)):
        return VTM_ENCODE_AI_FPS_FALLBACK, "fallback"
    try:
        t0 = time.perf_counter()
        subprocess.run(
            [enc, "-c", cfg, "--InputFile=testdata/small208_208x120_420_8.yuv",
             "--SourceWidth=208", "--SourceHeight=120", "--FrameRate=30",
             "--FramesToBeEncoded=1", "--QP=32", "--IntraPeriod=1",
             "--TemporalSubsampleRatio=1", "--BitstreamFile=/dev/null",
             "--SEIDecodedPictureHash=1"],
            capture_output=True, text=True, timeout=300, check=True)
        return 1.0 / (time.perf_counter() - t0), "measured"
    except Exception:
        return VTM_ENCODE_AI_FPS_FALLBACK, "fallback"


def _decode_once():
    from vtm_jax.decoder.declib import Decoder

    with open("testdata/ra_full_bq416_qp37.bit", "rb") as f:
        data = f.read()
    dec = Decoder()
    pics = dec.decode_stream(data)
    mismatches = sum(1 for hr in dec.hash_results if not hr.ok)
    assert len(dec.hash_results) == len(pics)
    return len(pics), mismatches


def _read_420(path, w, h):
    import numpy as np

    with open(path, "rb") as f:
        raw = f.read(w * h * 3 // 2)
    y = np.frombuffer(raw[: w * h], np.uint8).reshape(h, w)
    u = np.frombuffer(raw[w * h : w * h * 5 // 4], np.uint8).reshape(
        h // 2, w // 2)
    v = np.frombuffer(raw[w * h * 5 // 4 :], np.uint8).reshape(h // 2, w // 2)
    return [p.astype(np.int32) for p in (y, u, v)]


def _encode_once() -> float:
    """AI encode of one small208 frame; returns seconds."""
    from vtm_jax.encoder.enc_lib import EncoderConfig, IntraEncoder

    frame = _read_420("testdata/small208_208x120_420_8.yuv", 208, 120)
    cfg = EncoderConfig(width=208, height=120, qp=32)
    IntraEncoder(cfg).encode([frame])  # warm-up (jit compiles)
    t0 = time.perf_counter()
    IntraEncoder(cfg).encode([frame])
    return time.perf_counter() - t0


def _decode_hd1080() -> float | None:
    """Decode throughput of the 1080p AI golden (north-star resolution)."""
    from vtm_jax.decoder.declib import Decoder

    path = "testdata/ai_full_hd1080_qp37.bit"
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    dec = Decoder()
    pics = dec.decode_stream(data)  # warm-up + hash check
    if any(not hr.ok for hr in dec.hash_results):
        return None
    t0 = time.perf_counter()
    dec = Decoder()
    pics = dec.decode_stream(data)
    return len(pics) / (time.perf_counter() - t0)


def _encode_hd1080_once() -> float:
    """AI encode of one synthetic 1080p frame at QP37 (north-star config);
    opt-in via VTM_BENCH_HD=1."""
    from tools.make_testdata import synth_clip
    from vtm_jax.encoder.enc_lib import EncoderConfig, IntraEncoder

    frame = synth_clip(1920, 1080, 1)[0]
    cfg = EncoderConfig(width=1920, height=1080, qp=37)
    IntraEncoder(cfg).encode([frame])
    t0 = time.perf_counter()
    IntraEncoder(cfg).encode([frame])
    return time.perf_counter() - t0


def main():
    from vtm_jax.utils.device_info import card_line, jax_device

    device = jax_device()
    card = card_line()
    print(f"device: {device}; card: {card}", flush=True)
    if device["platform"] != "gpu":
        print("bench.py measures the GPU only; JAX's default backend is "
              f"{device['platform']}", file=sys.stderr)
        sys.exit(1)
    anchor_fps, anchor_src = measure_vtm_decode_fps(
        "testdata/ra_full_bq416_qp37.bit", 8)
    # warm-up: first pass compiles every kernel shape
    n, bad = _decode_once()
    assert bad == 0, f"hash mismatches: {bad}"
    # best-of-3, matching the anchor measurement's methodology above
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        n, bad = _decode_once()
        assert bad == 0
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    fps = n / best
    enc_anchor_fps, enc_anchor_src = measure_vtm_encode_ai_fps()
    enc_dt = min(_encode_once() for _ in range(3))
    hd_dec_fps = _decode_hd1080()
    hd_fps = None
    if os.environ.get("VTM_BENCH_HD"):
        hd_fps = round(1.0 / _encode_hd1080_once(), 4)
    print(json.dumps({
        "metric": "e2e_decode_fps_ra_full_bq416_qp37",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / anchor_fps, 4),
        "device": device,
        "card": card,
        "anchor_decode_fps": round(anchor_fps, 2),
        "anchor_source": anchor_src,
        "encode_ai_fps_small208": round(1.0 / enc_dt, 4),
        "encode_vs_vtm": round((1.0 / enc_dt) / enc_anchor_fps, 4),
        "encode_ai_fps_hd1080": hd_fps,
        "anchor_encode_ai_fps_hd1080": VTM_ENCODE_HD1080_AI_FPS,
        "decode_fps_hd1080": (round(hd_dec_fps, 3)
                              if hd_dec_fps is not None else None),
        "anchor_encode_ai_fps": round(enc_anchor_fps, 4),
        "anchor_encode_source": enc_anchor_src,
    }))


if __name__ == "__main__":
    main()
