"""Per-syntax bit statistics — the DecoderAnalyser build's equivalent
(CodingStatistics.h taxonomy, DecoderAnalyserLib compiled with
RExt__DECODER_DEBUG_BIT_STATISTICS).

Context-coded bins are attributed to their context set (which maps 1:1 to
a syntax element family, Contexts.cpp CtxSet table); per-bin cost is the
model's fractional self-information -log2(P(bin)) plus the bin count.
Bypass bins cost exactly 1 bit. Enable with `--stats` on the decoder app
(forces the Python engine).
"""

from __future__ import annotations

import math

from vtm_jax.common import rom


class BitStats:
    def __init__(self):
        self.ctx_bins = {}   # ctx_id -> [bins, frac_bits]
        self.ep_bins = 0

    def add_ctx(self, ctx_id: int, q: int, bin_val: int):
        # q is the 8-bit probability state: P(bin==1) ≈ q/256
        p1 = min(max(q / 256.0, 1e-4), 1 - 1e-4)
        p = p1 if bin_val else 1.0 - p1
        e = self.ctx_bins.setdefault(ctx_id, [0, 0.0])
        e[0] += 1
        e[1] += -math.log2(p)

    def report(self) -> str:
        """Table of bins/estimated-bits per context set (syntax family)."""
        off = rom.ctx_offsets()
        per_set = {}
        for ctx_id, (bins, bits) in self.ctx_bins.items():
            name = "?"
            for k, (s, n) in off.items():
                if s <= ctx_id < s + n:
                    name = k
                    break
            e = per_set.setdefault(name, [0, 0.0])
            e[0] += bins
            e[1] += bits
        rows = sorted(per_set.items(), key=lambda kv: -kv[1][1])
        total_bits = sum(b for _, (_, b) in rows) + self.ep_bins
        out = [f"{'syntax (ctx set)':<24}{'bins':>10}{'est.bits':>12}{'share':>8}"]
        for name, (bins, bits) in rows:
            out.append(f"{name:<24}{bins:>10}{bits:>12.0f}"
                       f"{bits / total_bits * 100:>7.1f}%")
        out.append(f"{'(bypass bins)':<24}{self.ep_bins:>10}{self.ep_bins:>12}"
                   f"{self.ep_bins / total_bits * 100:>7.1f}%")
        out.append(f"{'TOTAL':<24}{'':>10}{total_bits:>12.0f}")
        return "\n".join(out)
