"""Quantization scaling lists (explicit scaling matrices).

Behavioral contract:
  * parse: VLCReader.cpp parseScalingList:4725 / decodeScalingList:4790 —
    28 lists (ids 0-1: 2x2 chroma, 2-7: 4x4, 8-27: 8x8 base + DC for
    16x16+), copy/predictor modes with pred_matrix_id_delta, DPCM coded
    deltas over the ungrouped diagonal scan.
  * derivation: Quant.cpp xSetScalingListDec:610 / xSetRecScalingListDec
    /processScalingListDec:646 — per (listType, qpRem, log2W, log2H)
    dequant-coefficient matrices by nearest-neighbour upsampling of the
    base matrix, DC override for >8 sizes, zero-out beyond 32.

VVC default matrices are flat 16 (Rom.cpp:646-678), so default-list
streams (`--ScalingList=1`) are numerically identical to flat dequant;
only APS-delivered custom lists (`--ScalingList=2`) change results.
"""

from __future__ import annotations

import functools

import numpy as np

from vtm_jax.common import rom

START_4x4 = 2
START_8x8 = 8
START_16x16 = 14
START_64x64 = 26
SCALING_LIST_NUM_IDS = 28
START_VALUE = 8  # SCALING_LIST_START_VALUE
DEFAULT_DC = 16

# g_scalingListId[sizeId][listId] (Rom.cpp:681); sizeId = log2(dim)
SCALING_LIST_ID = [
    [0, 0, 0, 0, 0, 0],       # 1x1
    [0, 0, 0, 0, 0, 1],       # 2x2
    [2, 3, 4, 5, 6, 7],       # 4x4
    [8, 9, 10, 11, 12, 13],   # 8x8
    [14, 15, 16, 17, 18, 19],  # 16x16
    [20, 21, 22, 23, 24, 25],  # 32x32
    [26, 21, 22, 27, 24, 25],  # 64x64
    [0, 0, 0, 0, 0, 0],       # 128x128
]


def _matrix_size(lid: int) -> int:
    return 2 if lid < START_4x4 else 4 if lid < START_8x8 else 8


def is_luma_list(lid: int) -> bool:
    # ScalingList::isLumaScalingList (Slice.cpp:4077)
    return (lid % 3 == START_4x4) or lid == START_64x64 + 1


@functools.lru_cache(maxsize=None)
def _diag_scan(n: int) -> np.ndarray:
    """Ungrouped diagonal scan (idx, x, y) rows for an n x n matrix."""
    return rom.scan(0, n, n)


class ScalingList:
    """Decoded scaling-list state (Slice.h:161 ScalingList)."""

    def __init__(self):
        self.chroma_present = True
        self.lists = [np.full(_matrix_size(i) ** 2, 16, np.int64)
                      for i in range(SCALING_LIST_NUM_IDS)]
        self.dc = [DEFAULT_DC] * SCALING_LIST_NUM_IDS  # ids >= 14 only

    def copy_ref(self, lid: int, ref: int):
        # processRefMatrix: self-reference copies the (flat-16) default
        if lid == ref:
            self.lists[lid] = np.full(_matrix_size(lid) ** 2, 16, np.int64)
        else:
            self.lists[lid] = self.lists[ref].copy()


def parse_scaling_list(r) -> ScalingList:
    """parseScalingList (VLCReader.cpp:4725); r is a BitReader with
    flag()/ue()/se()."""
    sl = ScalingList()
    sl.chroma_present = bool(r.flag())
    for lid in range(SCALING_LIST_NUM_IDS):
        if not (sl.chroma_present or is_luma_list(lid)):
            # chroma lists absent (400): default + DC 16
            sl.copy_ref(lid, lid)
            if lid >= START_16x16:
                sl.dc[lid] = 16
            continue
        copy_mode = bool(r.flag())
        pred_mode = False
        if not copy_mode:
            pred_mode = bool(r.flag())
        ref = lid
        if (copy_mode or pred_mode) and lid not in (0, START_4x4, START_8x8):
            ref = lid - r.ue()
        if copy_mode:
            if lid >= START_16x16:
                sl.dc[lid] = (16 if ref == lid
                              else int(sl.lists[ref][0]) if ref < START_16x16
                              else sl.dc[ref])
            sl.copy_ref(lid, ref)
            continue
        # explicit DPCM coding (decodeScalingList)
        msize = _matrix_size(lid)
        n = msize * msize
        next_coef = 0 if pred_mode else START_VALUE
        scan = _diag_scan(msize)
        if pred_mode and ref == lid:
            src = np.full(n, 16, np.int64)  # default (flat-16) matrix
            sl.dc[ref] = DEFAULT_DC
        elif pred_mode:
            src = sl.lists[ref]
        else:
            src = None
        dst = np.zeros(n, np.int64)
        if lid >= START_16x16:
            dc_delta = r.se()
            next_coef += dc_delta
            pred_dc = 0
            if pred_mode:
                pred_dc = (sl.dc[ref] if ref >= START_16x16
                           else int(src[0]))
            sl.dc[lid] = (next_coef + pred_dc + 256) & 255
        for i in range(n):
            x, y = int(scan[i][1]), int(scan[i][2])
            if lid >= START_64x64 and x >= 4 and y >= 4:
                dst[int(scan[i][0])] = 0
                continue
            next_coef += r.se()
            pred = int(src[int(scan[i][0])]) if pred_mode else 0
            dst[int(scan[i][0])] = (next_coef + pred + 256) & 255
        sl.lists[lid] = dst
    return sl


# ---------------------------------------------------------------------------
# dequant-coefficient matrix derivation (Quant.cpp processScalingListDec)


@functools.lru_cache(maxsize=None)
def _dequant_matrix_cached(sl_key, list_type: int, qp_rem: int,
                           log2w: int, log2h: int):
    sl = _SL_REGISTRY[sl_key]
    w, h = 1 << log2w, 1 << log2h
    size_w, size_h = log2w, log2h
    large = max(size_w, size_h)
    lid = SCALING_LIST_ID[large][list_type]
    base = sl.lists[lid]
    msize = _matrix_size(lid)
    needs_sqrt2 = ((log2w + log2h) & 1) == 1
    inv_scale = int(rom.inv_quant_scale(qp_rem, needs_sqrt2))
    dc = sl.dc[lid] if lid >= START_16x16 else 0
    out = np.zeros((h, w), np.int64)
    if w == h:
        ratio = max(1, w // min(8, w))
        for j in range(h):
            row = (j // ratio) * msize
            for i in range(w):
                out[j, i] = inv_scale * base[row + i // ratio]
        if ratio > 1:
            out[0, 0] = inv_scale * dc
    else:
        ratio_wh = h // w if h > w else w // h
        ratio_h = (h // msize) if (h // msize) else (msize // h)
        ratio_w = (w // msize) if (w // msize) else (msize // w)
        for j in range(h):
            for i in range(w):
                if i >= 32 or j >= 32:
                    out[j, i] = 0
                    continue
                if h > w:
                    c = base[(j // ratio_h) * msize
                             + ((i * ratio_wh) // ratio_h)]
                else:
                    c = base[((j * ratio_wh) // ratio_w) * msize
                             + (i // ratio_w)]
                out[j, i] = inv_scale * c
        if max(w, h) > 8:
            out[0, 0] = inv_scale * dc
    return out


_SL_REGISTRY: dict = {}


def dequant_matrix(sl: ScalingList, list_type: int, qp_rem: int,
                   w: int, h: int) -> np.ndarray:
    """Per-TU dequant coefficients (inv_scale * matrix entry per pos)."""
    key = id(sl)
    _SL_REGISTRY[key] = sl
    return _dequant_matrix_cached(key, list_type, qp_rem,
                                  w.bit_length() - 1, h.bit_length() - 1)


def scaling_list_type(is_intra: bool, comp: int) -> int:
    """getScalingListType (ChromaFormat.h:123)."""
    return (0 if is_intra else 3) + comp
