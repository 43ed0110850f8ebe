"""Generate deterministic synthetic YUV test clips.

Content mixes gradients, edges, textured noise, and motion so intra and
inter coding tools all get exercised.  Seeded — the clips are reproducible
and small enough to regenerate rather than commit.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vtm_jax.common.types import ChromaFormat
from vtm_jax.utils.yuv_io import YuvFormat, write_yuv


def synth_clip(w: int, h: int, frames: int, seed: int = 7, bit_depth: int = 8):
    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    # static base: diagonal gradient + circles + blocky texture
    base = 0.35 * maxv * (xx / w + yy / h) / 2
    cx, cy = w * 0.6, h * 0.4
    r = np.hypot(xx - cx, yy - cy)
    base += 0.3 * maxv * (np.sin(r / 6.0) * 0.5 + 0.5)
    tex = rng.normal(0, 0.04 * maxv, (h, w))
    # low-pass the noise so it codes like natural texture
    k = np.ones((3, 3)) / 9.0
    from scipy.signal import convolve2d  # noqa: PLC0415

    tex = convolve2d(tex, k, mode="same", boundary="symm")
    out = []
    for t in range(frames):
        dx, dy = 1.5 * t, 0.8 * t
        mov = 0.25 * maxv * (np.sin((xx - dx) / 9.0) * np.cos((yy - dy) / 11.0) * 0.5 + 0.5)
        y = np.clip(base + mov + tex, 0, maxv)
        # chroma: smooth fields with some correlation to luma
        ch, cw = h // 2, w // 2
        u = np.clip(maxv * 0.5 + 0.2 * maxv * np.sin((xx[:ch, :cw] + t) / 17.0), 0, maxv)
        v = np.clip(maxv * 0.5 + 0.2 * maxv * np.cos((yy[:ch, :cw] - t) / 13.0), 0, maxv)
        out.append([np.round(y).astype(np.int32), np.round(u).astype(np.int32), np.round(v).astype(np.int32)])
    return out


def screen_clip(w: int, h: int, frames: int, seed: int = 3):
    """Screen-content-like clip: flat background, sharp text-like glyph
    rows that repeat (IBC bait), and a small color palette (PLT bait)."""
    rng = np.random.default_rng(seed)
    palette_y = np.array([16, 235, 81, 145, 210])
    palette_u = np.array([128, 128, 90, 54, 160])
    palette_v = np.array([128, 128, 240, 34, 110])
    # glyph atlas: 8x8 random-bit glyphs, reused across the frame
    glyphs = rng.integers(0, 2, size=(12, 8, 8))
    y = np.zeros((h, w), dtype=np.int64)
    idx = np.zeros((h, w), dtype=np.int64)
    # text rows every 16 pixels
    for row in range(0, h - 8, 16):
        for col in range(0, w - 8, 8):
            g = glyphs[(col // 8 + row // 16) % 7]
            idx[row : row + 8, col : col + 8] = g * ((row // 16) % 3 + 1)
    # a window with a different fill
    idx[h // 2 :, w // 3 : 2 * w // 3] = np.where(
        idx[h // 2 :, w // 3 : 2 * w // 3] > 0, 4, 3
    )
    out = []
    for t in range(frames):
        sh = (idx + 0).copy()
        # scroll the bottom window by 2 px/frame vertically (inter motion)
        win = np.roll(idx[h // 2 :, w // 3 : 2 * w // 3], 2 * t, axis=0)
        sh[h // 2 :, w // 3 : 2 * w // 3] = win
        yv = palette_y[sh]
        ch, cw = h // 2, w // 2
        uv = palette_u[sh[::2, ::2]]
        vv = palette_v[sh[::2, ::2]]
        out.append([yv.astype(np.int32), uv[:ch, :cw].astype(np.int32), vv[:ch, :cw].astype(np.int32)])
    return out


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "testdata"
    os.makedirs(outdir, exist_ok=True)
    for w, h, n, name in [(64, 64, 5, "tiny64"), (208, 120, 3, "small208"), (416, 240, 8, "bq416")]:
        clip = synth_clip(w, h, n)
        fmt = YuvFormat(w, h, ChromaFormat.YUV420, 8)
        path = os.path.join(outdir, f"{name}_{w}x{h}_420_8.yuv")
        write_yuv(path, clip, fmt)
        print(path, os.path.getsize(path))
    # screen content clip
    clip = screen_clip(208, 120, 4)
    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 8)
    path = os.path.join(outdir, "screen208_208x120_420_8.yuv")
    write_yuv(path, clip, fmt)
    print(path, os.path.getsize(path))
    # 10-bit clip
    clip = synth_clip(208, 120, 3, bit_depth=10)
    fmt = YuvFormat(208, 120, ChromaFormat.YUV420, 10)
    path = os.path.join(outdir, "small208_208x120_420_10.yuv")
    write_yuv(path, clip, fmt)
    print(path, os.path.getsize(path))
    # 1080p north-star clip (bench + BD-rate ladder resolution)
    clip = synth_clip(1920, 1080, 2)
    fmt = YuvFormat(1920, 1080, ChromaFormat.YUV420, 8)
    path = os.path.join(outdir, "hd1080_1920x1080_420_8.yuv")
    write_yuv(path, clip, fmt)
    print(path, os.path.getsize(path))


if __name__ == "__main__":
    main()
