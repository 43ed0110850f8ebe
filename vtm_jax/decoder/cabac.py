"""CABAC arithmetic decoding engine + context model.

Behavioral equivalent of DecoderLib/BinDecoder.cpp (decodeBin:276,
decodeBinEP:366+, decodeBinsEP, decodeBinTrm, decodeAlignedBinsEP,
decodeRemAbsEP) and CommonLib/Contexts.{h,cpp} (BinProbModel_Std: dual
15-bit probability counters, init:?, window sizes).  Context init values,
window sizes, and the LPS renorm table come bit-identically from the ROM
(rom.ctx_init_table / rom.renorm_table).

Pure Python scalar engine — this is the inherently serial part of the
codec; the parallel plan (SURVEY §7) spreads work across WPP rows / tiles,
not within a bin.  Its C twin (native/cabac.c) is the production path.
"""

from __future__ import annotations

import numpy as np

from vtm_jax.common import rom

PROB_BITS = 15
MASK_0 = ((1 << 10) - 1) << (PROB_BITS - 10)  # 0x7C00 >> ... (10-bit counter)
MASK_1 = ((1 << 14) - 1) << (PROB_BITS - 14)


class ContextModels:
    """Per-slice adaptive context states (CtxStore<BinProbModel_Std>)."""

    __slots__ = ("state0", "state1", "rate0", "rate1", "n")

    def __init__(self):
        self.n = rom.num_contexts()
        self.state0 = np.zeros(self.n, dtype=np.int32)
        self.state1 = np.zeros(self.n, dtype=np.int32)
        self.rate0 = np.zeros(self.n, dtype=np.int32)
        self.rate1 = np.zeros(self.n, dtype=np.int32)

    def init(self, qp: int, init_id: int) -> None:
        """init_id = int(SliceType): 0=B, 1=P, 2=I (CtxStore::init)."""
        qp = max(0, min(63, qp))
        init_vals = rom.ctx_init_table(init_id).astype(np.int32)
        rate_vals = rom.ctx_init_table(3).astype(np.int32)
        slope = (init_vals >> 3) - 4
        offset = ((init_vals & 7) * 18) + 1
        inistate = ((slope * (qp - 16)) >> 1) + offset
        state_clip = np.clip(inistate, 1, 127)
        p1 = state_clip << 8
        self.state0 = p1 & MASK_0
        self.state1 = p1 & MASK_1
        r0 = 2 + ((rate_vals >> 2) & 3)
        self.rate0 = r0
        self.rate1 = 3 + r0 + (rate_vals & 3)

    def copy(self) -> "ContextModels":
        c = ContextModels.__new__(ContextModels)
        c.n = self.n
        c.state0 = self.state0.copy()
        c.state1 = self.state1.copy()
        c.rate0 = self.rate0.copy()
        c.rate1 = self.rate1.copy()
        return c

    def state(self, i: int) -> int:
        return (int(self.state0[i]) + int(self.state1[i])) >> 8


_RENORM = rom.renorm_table().astype(np.int32)

_NATIVE = None


def make_cabac_decoder(data: bytes, ctx: "ContextModels", stats=None):
    """Engine factory: native C engine when available (vtm_jax/native/
    cabac.c), pure-Python fallback. Tracing and bit statistics always use
    the Python engine (the native one has neither hook)."""
    global _NATIVE
    import os

    if os.environ.get("VTM_CABAC_TRACE") or stats is not None:
        d = CabacDecoder(data, ctx)
        d.stats = stats
        return d
    if _NATIVE is None:
        from vtm_jax.native import load_cabac

        _NATIVE = load_cabac() or False
        if _NATIVE:
            _NATIVE.set_tables(
                np.ascontiguousarray(rom.group_idx(), dtype=np.int32),
                np.ascontiguousarray(rom.min_in_group(), dtype=np.int32),
                np.ascontiguousarray(rom.go_rice_pars_coeff(), dtype=np.int32),
            )
    if _NATIVE:
        return _NATIVE.NativeCabac(data, ctx, _RENORM)
    return CabacDecoder(data, ctx)


class CabacDecoder:
    """Arithmetic decoder over one substream (BinDecoderBase + TBinDecoder)."""

    __slots__ = ("data", "pos", "range", "value", "bits_needed", "ctx", "trace",
                 "trace_count", "stats")

    def __init__(self, data: bytes, ctx: ContextModels):
        self.data = data
        self.pos = 0
        self.ctx = ctx
        self.range = 0
        self.value = 0
        self.bits_needed = 0
        self.trace = None  # file-like; mirrors the reference D_CABAC channel
        self.trace_count = 0
        self.stats = None  # BitStats for the analyser build (decoder --stats)

    def _read_byte(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        self.pos += 1
        return 0

    def start(self) -> None:
        self.range = 510
        self.value = (self._read_byte() << 8) + self._read_byte()
        self.bits_needed = -8

    # -- context-coded bins -------------------------------------------------

    def decode_bin(self, ctx_id: int) -> int:
        c = self.ctx
        s0 = int(c.state0[ctx_id])
        s1 = int(c.state1[ctx_id])
        q = (s0 + s1) >> 8
        bin_val = q >> 7
        qq = q ^ 0xFF if (q & 0x80) else q
        lps = ((qq >> 2) * (self.range >> 5) >> 1) + 4
        self.range -= lps
        sr = self.range << 7
        if self.trace is not None:
            mps_path = 1 if self.value < sr else 0
            self.trace.write(
                f"{self.trace_count} {ctx_id} {self.range + lps}  "
                f"[{self.range}:{lps}]  {q:2d}(MPS={mps_path})  "
            )
            self.trace_count += 1
        if self.value < sr:
            # MPS path
            if self.range < 256:
                self.range <<= 1
                self.value <<= 1
                self.bits_needed += 1
                if self.bits_needed >= 0:
                    self.value += self._read_byte()
                    self.bits_needed = -8
        else:
            bin_val = 1 - bin_val
            num_bits = int(_RENORM[lps >> 3])
            self.value = (self.value - sr) << num_bits
            self.range = lps << num_bits
            self.bits_needed += num_bits
            if self.bits_needed >= 0:
                self.value += self._read_byte() << self.bits_needed
                self.bits_needed -= 8
        # probability update
        r0 = int(c.rate0[ctx_id])
        r1 = int(c.rate1[ctx_id])
        s0 -= (s0 >> r0) & MASK_0
        s1 -= (s1 >> r1) & MASK_1
        if bin_val:
            s0 += (0x7FFF >> r0) & MASK_0
            s1 += (0x7FFF >> r1) & MASK_1
        c.state0[ctx_id] = s0
        c.state1[ctx_id] = s1
        if self.trace is not None:
            self.trace.write(f"  -  {bin_val}\n")
        if self.stats is not None:
            self.stats.add_ctx(ctx_id, q, bin_val)
        return bin_val

    # -- bypass bins --------------------------------------------------------

    def decode_bin_ep(self) -> int:
        self.value += self.value
        self.bits_needed += 1
        if self.bits_needed >= 0:
            self.value += self._read_byte()
            self.bits_needed = -8
        sr = self.range << 7
        if self.value >= sr:
            self.value -= sr
            bin_val = 1
        else:
            bin_val = 0
        if self.trace is not None:
            self.trace.write(f"{self.trace_count}  {self.range}  EP={bin_val} \n")
            self.trace_count += 1
        if self.stats is not None:
            self.stats.ep_bins += 1
        return bin_val

    def decode_bins_ep(self, num_bins: int) -> int:
        if num_bins == 0:
            return 0
        if self.stats is not None:
            self.stats.ep_bins += num_bins
        if self.range == 256:
            return self._decode_aligned_bins_ep(num_bins)
        rem = num_bins
        bins = 0
        while rem > 8:
            self.value = (self.value << 8) + (self._read_byte() << (8 + self.bits_needed))
            sr = self.range << 15
            for _ in range(8):
                bins += bins
                sr >>= 1
                if self.value >= sr:
                    bins += 1
                    self.value -= sr
            rem -= 8
        self.bits_needed += rem
        self.value <<= rem
        if self.bits_needed >= 0:
            self.value += self._read_byte() << self.bits_needed
            self.bits_needed -= 8
        sr = self.range << (rem + 7)
        for _ in range(rem):
            bins += bins
            sr >>= 1
            if self.value >= sr:
                bins += 1
                self.value -= sr
        if self.trace is not None:
            for i in range(num_bins):
                self.trace.write(
                    f"{self.trace_count}  {self.range}  EP={(bins >> (num_bins - 1 - i)) & 1} \n"
                )
                self.trace_count += 1
        return bins

    def _decode_aligned_bins_ep(self, num_bins: int) -> int:
        rem = num_bins
        bins = 0
        while rem > 0:
            n = min(rem, 8)
            mask = (1 << n) - 1
            new_bins = (self.value >> (15 - n)) & mask
            bins = (bins << n) | new_bins
            self.value = (self.value << n) & 0x7FFF
            rem -= n
            self.bits_needed += n
            if self.bits_needed >= 0:
                self.value |= self._read_byte() << self.bits_needed
                self.bits_needed -= 8
        if self.trace is not None:
            for i in range(num_bins):
                self.trace.write(
                    f"{self.trace_count}  {self.range}  EP={(bins >> (num_bins - 1 - i)) & 1} \n"
                )
                self.trace_count += 1
        return bins

    def decode_rem_abs_ep(self, go_rice_par: int, cutoff: int, max_log2_tr_dr: int) -> int:
        prefix = 0
        max_prefix = 32 - max_log2_tr_dr
        code_word = 0
        while True:
            prefix += 1
            code_word = self.decode_bin_ep()
            if not (code_word and prefix < max_prefix):
                break
        prefix -= 1 - code_word
        length = go_rice_par
        if prefix < cutoff:
            offset = prefix << go_rice_par
        else:
            offset = ((1 << (prefix - cutoff)) + cutoff - 1) << go_rice_par
            length += (
                max_log2_tr_dr - go_rice_par
                if prefix == 32 - max_log2_tr_dr
                else prefix - cutoff
            )
        return offset + self.decode_bins_ep(length)

    def decode_bin_trm(self) -> int:
        self.range -= 2
        sr = self.range << 7
        if self.value >= sr:
            return 1
        if self.range < 256:
            self.range += self.range
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.value += self._read_byte()
                self.bits_needed = -8
        return 0

    def align(self) -> None:
        self.range = 256
