"""All-Intra encoder v1 (SURVEY §7 phase 4 'minimum end-to-end slice').

Architecture: the encoder builds the SAME decode-side coding structure the
decoder uses (CUs committed into DecCodingStructure, reconstruction through
the exact-integer ops), so every context derivation and prediction is
bit-consistent with decoding by construction.  RD search runs on
BitEstimator copies of the live CABAC contexts (the reference's
TBitEstimator approach, BinEncoder.h:226) with full state
checkpoint/rollback; the final CTU bins are written by replaying the chosen
tree with the real arithmetic encoder.

v1 toolset: CTU 64, single tree, QT-only partitioning to 8x8, 67-mode luma
intra (coarse+refine SATD preselection, exact RD on finalists), chroma DM,
DCT2, flat quant, IDR every frame, picture hash SEI.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vtm_jax import enable_compile_cache
from vtm_jax.bitstream import reader as nalio
from vtm_jax.bitstream.writer import BitWriter, make_nal
from vtm_jax.common.types import SliceType
from vtm_jax.decoder import cs as D
from vtm_jax.decoder import partitioner as P
from vtm_jax.decoder import vlc
from vtm_jax.decoder.cabac import ContextModels
from vtm_jax.decoder.cabac_reader import CuCtx
from vtm_jax.decoder.cs import CU, Rect, TU
from vtm_jax.decoder.dec_cu import CuReconstructor
from vtm_jax.encoder.bin_encoder import BinEncoder, BitEstimator
from vtm_jax.encoder.cabac_writer import SyntaxWriter
from vtm_jax.encoder import vlc_writer as W
from vtm_jax.ops import intra as I
from vtm_jax.ops import quant as Q
from vtm_jax.ops import transform as TX
from vtm_jax.utils import pic_hash


@dataclass
class EncoderConfig:
    width: int
    height: int
    qp: int = 32
    bit_depth: int = 8
    chroma_format_idc: int = 1
    ctu_size: int = 64
    log2_ctu_size: int = 6
    log2_min_cb_size: int = 2  # min CU 4
    log2_min_qt_intra: int = 3
    log2_min_qt_inter: int = 3
    max_mtt_depth_intra: int = 2
    max_mtt_depth_inter: int = 0
    log2_max_bt_intra: int = 5
    log2_max_tt_intra: int = 5
    log2_max_bt_inter: int = 5
    log2_max_tt_inter: int = 5
    log2_max_tb_size: int = 6
    init_qp: int = 26
    num_rd_modes: int = 3  # finalists for full RD
    sao: bool = False  # SAO search + signalling
    target_bitrate: int = 0  # bits/s; 0 = fixed QP (rate control off)
    frame_rate: float = 30.0
    mctf: bool = False  # motion-compensated temporal prefilter
    wpp: bool = False  # wavefront parallel processing (entropy sync + entry points)
    mts: bool = False  # explicit intra MTS (DST7/DCT8 transform search)
    alf: bool = False  # adaptive loop filter (LS-trained APS + CTU RD)
    dep_quant: bool = True  # dependent quantization (trellis, DepQuant analogue)
    lfnst: bool = False  # LFNST secondary transform search
    mip: bool = False  # matrix intra prediction search
    mrl: bool = False  # multi-reference-line intra search
    cclm: bool = False  # cross-component linear model chroma search
    isp: bool = False  # intra sub-partition search
    mmvd: bool = False  # merge with MVD search (SATD preselect + RD)
    tmvp: bool = False  # temporal MVP (collocated motion from ref pictures)
    amvr: bool = False  # adaptive MV resolution (IMV full-pel / 4-pel trials)
    bcw: bool = False  # bi-prediction with CU-level weights (weight trials)
    num_active_refs: int = 1  # active L0 references (multi-ref ME when > 1)
    geo: bool = False  # geometric-partition merge search (B slices)
    affine: bool = False  # affine (subblock) merge candidate trials
    # affine AMVP search (gradient-LS CPMVs) and SBT half-TU trials are
    # implemented and decode-proven but DEFAULT OFF: on the synthetic
    # translational BD-rate ladder each costs ~+1.2% RA BD-rate
    # (bdr_runs/small208x9_ra_{no_sbt,no_affine,r5tools}.json) — their
    # RD-local wins don't pay off globally there.  Enable per content.
    affine_amvp: bool = False
    sbt: bool = False  # sub-block transform trials for inter residuals
    aqp: bool = False  # variance-adaptive per-CTU QP (cu_qp_delta)
    ctu_rc: bool = False  # CTU-level R-lambda rate control (needs target_bitrate)
    aqp_range: int = 3  # max |dQP| (MaxQPAdaptationRange)
    aqp_strength: float = 1.5  # dQP per doubling of relative activity
    satd_rmd: bool = True  # whole-frame batched device RMD (SATD costs)
    ccalf: bool = False  # cross-component ALF training (needs alf=True)
    ciip: bool = False  # combined inter/intra prediction merge trials
    # intra split pruning from the RMD SATD table: skip an RD split trial
    # whose children's summed best-SATD (plus per-child signalling cost)
    # is >= margin * the node's own best SATD.  0 disables; larger =
    # more aggressive (1.0 only tries splits that SATD predicts to win).
    # Measured on small208 qp32: 2.1x speedup, +0.5% bits, +0.04 dB.
    intra_split_prune: float = 1.0
    # fast-RD: decide the whole frame's partition tree bottom-up from the
    # batched RMD SATD table (one DP pass, no per-split exact-RD trials),
    # then commit each chosen CU once — the EncCu temp/best recursion
    # (EncCu.cpp:530 xCompressCU) recast as argmin over the enumerated
    # candidate table (SURVEY §7).  fast_rd_cands = exact-RD finalists
    # re-ranked at commit time (1 = table winner only).
    fast_rd: bool = True
    fast_rd_cands: int = 1
    # DP cost-model constants (see _fast_rd_cost_model): residual bits ~
    # SATD / (bits_per_satd * Qstep); per-CU and per-split signalling bits.
    # bits_per_satd calibrated on bq416/small208 qp 27-37: at 24 the DP
    # reproduces the exact-RD tree (fast-part+exact-mode == exact within
    # 0.1%); the residual fast-path cost is the mode commit (+0.5-3%).
    fast_rd_bits_per_satd: float = 24.0
    fast_rd_leaf_bits: float = 6.0
    fast_rd_split_bits: float = 2.0
    hash_sei: bool = True  # decoded-picture-hash SEI per picture
    # (VTM CTC measures rate WITHOUT hash SEI: SEIDecodedPictureHash is a
    # debug option, EncApp default off — disable for BD-rate runs)


def _quantize_tu(coeffs, qp, bd, lam, dep, tu=None, comp=0, est=None,
                 sps=None, eff_w=None, eff_h=None, lfnst_idx=0):
    """Forward quantization: context-aware TCQ trellis (dq_ctx, priced
    with the live CABAC estimator contexts like DepQuant::quant) when the
    caller provides (tu, est, sps); else the context-free DQ trellis
    (quant_dep) or RDOQ by slice flag."""
    from vtm_jax.common import rom as _rom

    import os as _os

    if dep and tu is not None and est is not None and sps is not None \
            and min(coeffs.shape) >= 4 \
            and not _os.environ.get("VTM_TCQ_4STATE"):
        # VTM_TCQ_4STATE=1 drops to the context-free 4-state trellis
        # (BD-rate ablation knob for the context-aware TCQ)
        from vtm_jax.encoder import dq_ctx

        cctx = dq_ctx.rate_ctx(coeffs.shape[1], coeffs.shape[0], comp)
        lev = dq_ctx.quant_dep_ctx(coeffs, qp, bd, lam, cctx, est,
                                   eff_w=eff_w, eff_h=eff_h,
                                   lfnst_idx=lfnst_idx)
        if lev is not None:
            return lev
    if dep:
        scan = _rom.scan(1, coeffs.shape[1], coeffs.shape[0])
        return Q.quant_dep(coeffs, qp, bd, lam, scan)
    return Q.quant_rdoq(coeffs, qp, bd, lam)


def _dequantize_tu(lev, qp, bd, dep):
    from vtm_jax.common import rom as _rom

    if dep:
        scan = _rom.scan(1, lev.shape[1], lev.shape[0])
        return Q.dequant_dep(lev, qp, bd, scan)
    return Q.dequant(lev, qp, bd)


class IntraEncoder:
    def __init__(self, cfg: EncoderConfig):
        enable_compile_cache()
        self.cfg = cfg
        # build SPS/PPS objects by parsing our own written headers — this
        # guarantees the encoder's view matches any conforming decoder's
        self.sps_nal = W.write_sps(cfg)
        self.pps_nal = W.write_pps(cfg)
        sps_rbsp = nalio.parse_nal(nalio.split_annexb(self.sps_nal)[0]).rbsp
        pps_rbsp = nalio.parse_nal(nalio.split_annexb(self.pps_nal)[0]).rbsp
        self.sps = vlc.parse_sps(sps_rbsp)
        self.pps = vlc.parse_pps(pps_rbsp)
        self.frame_qp = cfg.qp
        self.lam = 0.57 * 2.0 ** ((cfg.qp - 12) / 3.0)

    # ------------------------------------------------------------------
    def encode(self, frames: list[list[np.ndarray]]) -> bytes:
        out = bytearray()
        out += self.sps_nal
        out += self.pps_nal
        for poc, planes in enumerate(frames):
            out += self.encode_frame(planes, poc)
        return bytes(out)

    def encode_frame(self, src_planes, poc: int) -> bytes:
        cfg = self.cfg
        sps, pps = self.sps, self.pps
        # picture-header fixups (normally done at PH parse)
        from vtm_jax.common.params import PicHeader, SliceHeader

        vlc.derive_pps_partitioning(pps, sps)
        ph = PicHeader()
        ph.inter_slice_allowed = False
        ph.min_qt_size = list(sps.min_qt_size)
        ph.max_mtt_depth = list(sps.max_mtt_depth)
        ph.max_bt_size = list(sps.max_bt_size)
        ph.max_tt_size = list(sps.max_tt_size)
        self.frame_qp = cfg.qp
        self.lam = 0.57 * 2.0 ** ((self.frame_qp - 12) / 3.0)
        self._base_lam = self.lam
        self._aqp_dqp = (self._aqp_map(src_planes[0].astype(np.int64))
                         if cfg.aqp else {})
        self._ctu_rc = None  # CTU rate control applies to inter frames only
        self._qg_carry = self.frame_qp
        sh = SliceHeader()
        sh.slice_type = SliceType.I
        sh.qp = self.frame_qp
        sh.sao_enabled = [cfg.sao, cfg.sao and cfg.chroma_format_idc != 0]
        sh.dep_quant = cfg.dep_quant
        n_ctu = pps.pic_width_in_ctu(sps.ctu_size) * pps.pic_height_in_ctu(sps.ctu_size)
        dcs = D.DecCodingStructure(sps, pps, ph, sh, np.zeros(n_ctu, dtype=np.int32))
        dcs._slice_headers = [sh]
        dcs.lmcs_model = None
        self.dcs = dcs
        from vtm_jax.decoder.cabac_reader import SyntaxReader

        self._helper = SyntaxReader(dcs, None)
        self.src = src_planes
        self._frame_rmd = None
        if cfg.satd_rmd:
            from vtm_jax.encoder.frame_rmd import FrameRMD

            self._frame_rmd = FrameRMD(src_planes[0], cfg, self.lam ** 0.5)
        planes = [np.zeros_like(p) for p in src_planes]
        self.recon = CuReconstructor(dcs, planes)
        # CABAC state
        ctx = ContextModels()
        ctx.init(self.frame_qp, int(SliceType.I))
        slice_bw = BitWriter()
        enc = BinEncoder(slice_bw, ctx)
        enc.start()
        import os
        tr_path = os.environ.get("VTM_ENC_TRACE")
        if tr_path:
            if not hasattr(self, "_trace_f"):
                self._trace_f = open(tr_path, "w")
            enc.trace = self._trace_f
        w_ctu = dcs.pic_w_ctu
        h_ctu = dcs.pic_h_ctu
        rep_ctx = CuCtx(self.frame_qp)  # slice-persistent QP chain
        # fast-RD phase 1: whole-frame partition DP from the reduced RMD
        # stats, then ONE device gather of the chosen leaves' full mode
        # rows (2 device syncs per frame total)
        fast_maps = {}
        if cfg.fast_rd and self._frame_rmd is not None:
            leaves = []
            for cy in range(h_ctu):
                for cx in range(w_ctu):
                    ctu_rect = Rect(cx * cfg.ctu_size, cy * cfg.ctu_size,
                                    cfg.ctu_size, cfg.ctu_size)
                    part = P.Partitioner(dcs)
                    part.init_ctu(ctu_rect, D.CH_L)
                    r = self._fast_rd_node(part)
                    if r is not None:
                        fast_maps[(ctu_rect.x, ctu_rect.y)] = r[1]
                        leaves.extend(
                            k[:4] for k, v in r[1].items()
                            if v == P.CU_DONT_SPLIT)
            self._frame_rmd.prefetch_rows(
                [(x, y, w, h) for (x, y, w, h) in leaves])
            if len(fast_maps) == w_ctu * h_ctu:
                # every CTU is table-decided: release the full on-device
                # cost tensors now instead of holding ~150MB/frame of
                # device memory until the next frame
                self._frame_rmd._full = {}
        for cy in range(h_ctu):
            for cx in range(w_ctu):
                ctu_rect = Rect(cx * cfg.ctu_size, cy * cfg.ctu_size,
                                cfg.ctu_size, cfg.ctu_size)
                # RD search with estimator seeded from live contexts
                est = BitEstimator(ctx.copy())
                self._enter_ctu_qp(ctu_rect)
                fast = fast_maps.get((ctu_rect.x, ctu_rect.y))
                if fast is not None:
                    self._split_map = fast
                    cpart = P.Partitioner(dcs)
                    cpart.init_ctu(ctu_rect, D.CH_L)
                    self._commit_node(cpart, est)
                else:
                    part = P.Partitioner(dcs)
                    part.init_ctu(ctu_rect, D.CH_L)
                    _, self._split_map = self._rd_node(part, est)
                self.__dict__.setdefault("_ctu_split_maps", {})[
                    (ctu_rect.x, ctu_rect.y)] = self._split_map
                # final write: replay chosen tree with the real encoder
                writer = SyntaxWriter(dcs, enc)
                wpart = P.Partitioner(dcs)
                wpart.init_ctu(ctu_rect, D.CH_L)
                self._replay_node(writer, wpart, rep_ctx)
                # VVC: terminating bin only at slice/tile/WPP-row end
                # (DecSlice.cpp:141-234); v1 has one slice, no tiles/WPP.
                if cy == h_ctu - 1 and cx == w_ctu - 1:
                    enc.encode_bin_trm(1)
        enc.finish()
        slice_bw.write_byte_alignment()
        # in-loop filters on reconstruction (DecLib::executeLoopFilters order)
        from vtm_jax.ops import deblock as DB

        class _PicShim:
            pass

        shim = _PicShim()
        shim.planes = planes
        if not sh.deblocking_disable:
            DB.deblock_picture(dcs, shim)
        entry_points = None
        self._alf_aps_nal = b""
        if cfg.sao or cfg.wpp or cfg.alf:
            slice_bw, entry_points = self._sao_and_rewrite(shim, SliceType.I)
        # slice NAL = header + slice data
        hdr = W.write_slice_header_head(cfg, poc, self.frame_qp,
                                        sao=tuple(sh.sao_enabled),
                                        entry_points=entry_points,
                                        alf=sh)
        rbsp = bytes(hdr.bytes) + slice_bw.data()
        nal = make_nal(nalio.NAL_IDR_N_LP, rbsp)
        # hash SEI (computed on the filtered reconstruction, like VTM)
        sei = b""
        if cfg.hash_sei:
            digest = pic_hash.pic_md5(planes, [cfg.bit_depth] * len(planes))
            sei = W.write_hash_sei(digest)
        self.last_recon = planes
        self._log_picture(poc, "I", self.frame_qp, len(nal) * 8, planes)
        return self._alf_aps_nal + nal + sei

    def _log_picture(self, poc, stype, qp, bits, planes):
        """Per-picture log record (EncGOP xCalculateAddPSNR:3995 analogue)."""
        maxv = (1 << self.cfg.bit_depth) - 1
        ps = []
        for c, p in enumerate(planes):
            d = self.src[c].astype(np.float64) - p.astype(np.float64)
            mse = float((d * d).mean())
            ps.append(10 * np.log10(maxv * maxv / mse) if mse > 0 else 99.0)
        rec = dict(poc=poc, type=stype, qp=qp, bits=bits, psnr=ps)
        self.__dict__.setdefault("frame_log", []).append(rec)
        if getattr(self.cfg, "verbose", False):
            import sys

            print(f"POC {poc:4d} ( {stype}-SLICE, QP {qp} ) {bits:10d} bits "
                  f"[Y {ps[0]:.4f} dB  U {ps[1]:.4f} dB  V {ps[2]:.4f} dB]",
                  file=sys.stderr)

    def sequence_summary(self):
        """Analyze.h-style per-slice-type averages → dict."""
        out = {}
        for st in ("I", "P", "B"):
            recs = [r for r in getattr(self, "frame_log", []) if r["type"] == st]
            if not recs:
                continue
            out[st] = dict(
                pics=len(recs),
                bits=sum(r["bits"] for r in recs),
                psnr=[float(np.mean([r["psnr"][c] for r in recs]))
                      for c in range(3)],
            )
        return out

    def _sao_and_rewrite(self, shim, slice_type):
        """Filter-parameter search + final entropy pass (the reference's
        two-pass compressSlice -> filters -> encodeSlice flow,
        EncGOP.cpp:2874-3324). With cfg.wpp, writes one CABAC substream per
        CTU row with the 1-CTU-delayed context sync (EncSlice.cpp:1833-1868)
        and returns (BitWriter, entry_point_sizes)."""
        from vtm_jax.decoder.cabac_reader import SaoParams
        from vtm_jax.encoder.sao_search import sao_search
        from vtm_jax.ops import sao as SAOOP

        cfg = self.cfg
        dcs = self.dcs
        n_ctu = dcs.pic_w_ctu * dcs.pic_h_ctu
        shim.sao_params = [SaoParams() for _ in range(n_ctu)]
        if cfg.sao:
            est_ctx = ContextModels()
            est_ctx.init(self.frame_qp, int(slice_type))
            est = BitEstimator(est_ctx)
            sao_search(dcs, shim, self.src, self.lam, est)
            SAOOP.sao_picture(dcs, shim)
        alf_on = getattr(cfg, "alf", False)
        if alf_on:
            # ALF param search + exact integer application on the
            # post-SAO reconstruction (EncGOP.cpp:2918 ALFProcess slot)
            from vtm_jax.encoder.alf_search import alf_search
            from vtm_jax.encoder.vlc_writer import write_aps_alf
            from vtm_jax.ops import alf as ALFOP

            pre_alf_luma = (shim.planes[0].copy()
                            if getattr(cfg, "ccalf", False) else None)
            param = alf_search(dcs, shim, self.src, self.lam)
            if param is not None:
                ALFOP.alf_picture(dcs, shim)
                if pre_alf_luma is not None and dcs.sh.alf_enabled[0]:
                    # CC-ALF trains against the post-ALF chroma with the
                    # pre-ALF (post-SAO) luma as filter input
                    from vtm_jax.encoder.alf_search import derive_ccalf

                    derive_ccalf(dcs, shim, self.src, self.lam,
                                 pre_alf_luma, param)
                self._alf_aps_nal = write_aps_alf(param, aps_id=0)
            else:
                n = dcs.pic_w_ctu * dcs.pic_h_ctu
                shim.alf_ctb_flag = [np.zeros(n, dtype=np.int64) for _ in range(3)]
                shim.alf_ctb_filter_index = np.zeros(n, dtype=np.int64)
                shim.alf_ctb_alt = [np.zeros(n, dtype=np.int64) for _ in range(3)]
        # final write pass: sao params + replayed coding trees
        ctx_m = ContextModels()
        ctx_m.init(self.frame_qp, int(slice_type))
        bw = BitWriter()
        enc = BinEncoder(bw, ctx_m)
        enc.start()
        w_ctu, h_ctu = dcs.pic_w_ctu, dcs.pic_h_ctu
        substreams = []
        wpp_ctx = None
        rep_ctx = CuCtx(self.frame_qp)
        for cy in range(h_ctu):
            if cfg.wpp and cy > 0:
                # start a fresh substream, synced from the above row's
                # post-first-CTU context (DecSlice.cpp:186-210 mirror)
                ctx_m = wpp_ctx.copy()
                bw = BitWriter()
                enc = BinEncoder(bw, ctx_m)
                enc.start()
            if cfg.wpp and hasattr(dcs, "motion_lut"):
                dcs.motion_lut.clear()
                dcs.motion_lut_ibc.clear()
            for cx in range(w_ctu):
                rect = Rect(cx * cfg.ctu_size, cy * cfg.ctu_size,
                            cfg.ctu_size, cfg.ctu_size)
                writer = SyntaxWriter(dcs, enc)
                writer.sao(rect, shim.sao_params[cy * w_ctu + cx])
                if alf_on:
                    writer.alf_ctb(rect, cy * w_ctu + cx, shim)
                self._split_map = self._ctu_split_maps[(rect.x, rect.y)]
                wpart = P.Partitioner(dcs)
                wpart.init_ctu(rect, D.CH_L)
                self._replay_node(writer, wpart, rep_ctx)
                if cfg.wpp and cx == 0:
                    wpp_ctx = ctx_m.copy()
                if cx == w_ctu - 1 and (cfg.wpp or cy == h_ctu - 1):
                    enc.encode_bin_trm(1)
            if cfg.wpp:
                enc.finish()
                bw.write_byte_alignment()
                substreams.append(bw.data())
        if not cfg.wpp:
            enc.finish()
            bw.write_byte_alignment()
            return bw, None
        out = BitWriter()
        for sub in substreams:
            for b in sub:
                out.u(b, 8)
        return out, [len(sub) for sub in substreams[:-1]]

    # ------------------------------------------------------------------
    # state checkpointing
    def _snapshot(self, a: Rect):
        dcs = self.dcs
        r = self.recon
        sx, sy = dcs.chroma_format.scale_x, dcs.chroma_format.scale_y
        ca = Rect(a.x >> sx, a.y >> sy, a.w >> sx, a.h >> sy)
        snap = {
            "n_cus": len(dcs.cus),
            "n_tus": len(dcs.tus),
            "qg": (dict(self._qg) if getattr(self, "_qg", None) else None,
                   getattr(self, "_qg_carry", None)),
            "map_l": dcs.map_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2].copy(),
            "map_tu_l": dcs.map_tu_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2].copy(),
            "qp_l": dcs.qp_map_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2].copy(),
            "plane0": r.planes[0][a.y : a.y1, a.x : a.x1].copy(),
            "dec_l": r.decomp_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2].copy(),
        }
        if dcs.map_c is not None:
            snap["map_c"] = dcs.map_c[ca.y >> 1 : ca.y1 >> 1, ca.x >> 1 : ca.x1 >> 1].copy()
            snap["map_tu_c"] = dcs.map_tu_c[ca.y >> 1 : ca.y1 >> 1, ca.x >> 1 : ca.x1 >> 1].copy()
            snap["plane1"] = r.planes[1][ca.y : ca.y1, ca.x : ca.x1].copy()
            snap["plane2"] = r.planes[2][ca.y : ca.y1, ca.x : ca.x1].copy()
            snap["dec_c"] = r.decomp_c[ca.y >> 1 : ca.y1 >> 1, ca.x >> 1 : ca.x1 >> 1].copy()
        if hasattr(dcs, "mf_inter"):
            s4 = slice(a.y >> 2, a.y1 >> 2), slice(a.x >> 2, a.x1 >> 2)
            snap["mf"] = (
                dcs.mf_inter[s4].copy(), dcs.mf_interdir[s4].copy(),
                dcs.mf_mv[s4].copy(), dcs.mf_refidx[s4].copy(),
                dcs.mf_slice[s4].copy(), dcs.mf_alt_hpel[s4].copy(),
                dcs.mf_bcw[s4].copy(),
            )
            snap["lut"] = list(dcs.motion_lut)
        return snap

    def _restore_motion(self, a: Rect, snap):
        dcs = self.dcs
        if "mf" not in snap:
            return
        s4 = slice(a.y >> 2, a.y1 >> 2), slice(a.x >> 2, a.x1 >> 2)
        (dcs.mf_inter[s4], dcs.mf_interdir[s4], dcs.mf_mv[s4],
         dcs.mf_refidx[s4], dcs.mf_slice[s4], dcs.mf_alt_hpel[s4],
         dcs.mf_bcw[s4]) = snap["mf"]
        dcs.motion_lut[:] = snap["lut"]

    def _restore(self, a: Rect, snap):
        dcs = self.dcs
        r = self.recon
        sx, sy = dcs.chroma_format.scale_x, dcs.chroma_format.scale_y
        ca = Rect(a.x >> sx, a.y >> sy, a.w >> sx, a.h >> sy)
        if snap.get("qg") is not None:
            q, carry = snap["qg"]
            self._qg = dict(q) if q else None
            if carry is not None:
                self._qg_carry = carry
        del dcs.cus[snap["n_cus"]:]
        del dcs.tus[snap["n_tus"]:]
        dcs.map_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2] = snap["map_l"]
        dcs.map_tu_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2] = snap["map_tu_l"]
        dcs.qp_map_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2] = snap["qp_l"]
        r.planes[0][a.y : a.y1, a.x : a.x1] = snap["plane0"]
        r.decomp_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2] = snap["dec_l"]
        if dcs.map_c is not None:
            dcs.map_c[ca.y >> 1 : ca.y1 >> 1, ca.x >> 1 : ca.x1 >> 1] = snap["map_c"]
            dcs.map_tu_c[ca.y >> 1 : ca.y1 >> 1, ca.x >> 1 : ca.x1 >> 1] = snap["map_tu_c"]
            r.planes[1][ca.y : ca.y1, ca.x : ca.x1] = snap["plane1"]
            r.planes[2][ca.y : ca.y1, ca.x : ca.x1] = snap["plane2"]
            r.decomp_c[ca.y >> 1 : ca.y1 >> 1, ca.x >> 1 : ca.x1 >> 1] = snap["dec_c"]
        self._restore_motion(a, snap)

    # ------------------------------------------------------------------
    def _rd_node(self, part: P.Partitioner, est: BitEstimator):
        """Decide split-vs-CU at this node; leaves chosen state applied.

        Returns (subtree RD cost, {node key: chosen split} for the winning
        subtree) — the choices map drives the final-bin replay.
        """
        dcs = self.dcs
        a = part.cur_area()
        clipped = Rect(a.x, a.y,
                       min(a.w, dcs.pic_w - a.x), min(a.h, dcs.pic_h - a.y))
        can_no, can_qt, can_bh, can_bv, can_th, can_tv = part.can_split_flags()
        key = (a.x, a.y, a.w, a.h, part.cur_depth)
        inside = a.x1 <= dcs.pic_w and a.y1 <= dcs.pic_h
        best = None  # (cost, capture_after, est_after, choices)
        snap0 = self._snapshot(clipped)

        def capture():
            cap = self._snapshot(clipped)
            cap["n_cus"] = snap0["n_cus"]
            cap["n_tus"] = snap0["n_tus"]
            cap["cus_tail"] = dcs.cus[snap0["n_cus"]:]
            cap["tus_tail"] = dcs.tus[snap0["n_tus"]:]
            return cap

        if can_no:
            est_ns = est.copy()
            bits0 = est_ns.frac_bits
            w = SyntaxWriter(dcs, est_ns)
            w.split_cu_mode(P.CU_DONT_SPLIT, part)
            dist = self._rd_cu(a, part, est_ns)
            cost = dist + self.lam * ((est_ns.frac_bits - bits0) / 32768.0)
            best = (cost, capture(), est_ns, {key: P.CU_DONT_SPLIT})
            self._restore(clipped, snap0)

        split_modes = []
        if can_qt and (
            not can_no or self._helper._signal_mode_cons(part, P.CU_QUAD_SPLIT) == 0
        ):
            split_modes.append(P.CU_QUAD_SPLIT)
        # BT/TT only on fully-inside nodes (border nodes use implicit QT);
        # avoid any split that would start a local dual tree (signalModeCons
        # != inherit) — single-tree local dual trees not implemented in the
        # encoder yet
        if inside:
            helper = self._helper
            if can_bh and helper._signal_mode_cons(part, P.CU_HORZ_SPLIT) == 0:
                split_modes.append(P.CU_HORZ_SPLIT)
            if can_bv and helper._signal_mode_cons(part, P.CU_VERT_SPLIT) == 0:
                split_modes.append(P.CU_VERT_SPLIT)
            if can_th and helper._signal_mode_cons(part, P.CU_TRIH_SPLIT) == 0:
                split_modes.append(P.CU_TRIH_SPLIT)
            if can_tv and helper._signal_mode_cons(part, P.CU_TRIV_SPLIT) == 0:
                split_modes.append(P.CU_TRIV_SPLIT)
        # SATD-based split pruning (EncModeCtrl fast-skip analogue): the
        # whole-frame RMD table bounds how much a split can help; skip RD
        # of splits it predicts to lose
        fr = getattr(self, "_frame_rmd", None)
        prune = getattr(self.cfg, "intra_split_prune", 0.0)
        ns_satd = None
        if fr is not None and prune > 0 and inside and split_modes:
            st = fr.stats(clipped.x, clipped.y, clipped.w, clipped.h)
            if st is not None:
                ns_satd = float(st[0])
        for mode in split_modes:
            if ns_satd is not None and best is not None:
                est_sp_satd = self._split_satd_estimate(part, mode, fr)
                if est_sp_satd is not None and \
                        est_sp_satd >= ns_satd * prune:
                    continue
            est_sp = est.copy()
            bits0 = est_sp.frac_bits
            w = SyntaxWriter(dcs, est_sp)
            w.split_cu_mode(mode, part)
            total = self.lam * ((est_sp.frac_bits - bits0) / 32768.0)
            choices = {key: mode}
            part.split_cur_area(mode)
            while True:
                sub = part.cur_area()
                if sub.x < dcs.pic_w and sub.y < dcs.pic_h:
                    c, sub_choices = self._rd_node(part, est_sp)
                    total += c
                    choices.update(sub_choices)
                if not part.next_part():
                    break
            part.exit_cur_split()
            if best is None or total < best[0]:
                best = (total, capture(), est_sp, choices)
            self._restore(clipped, snap0)
        cost, cap_after, est_after, choices = best
        self._restore_region(clipped, cap_after)
        est.ctx = est_after.ctx
        est.frac_bits = est_after.frac_bits
        return cost, choices

    # -- adaptive QP (cu_qp_delta) ---------------------------------------
    def _aqp_map(self, src_y: np.ndarray):
        """Variance-adaptive per-CTU QP offsets (AQp.cpp:69 preanalyze
        behavioral shape): activity = 1 + mean of the four quadrant
        variances; dQP = clip(strength * log2(act / avgAct))."""
        cfg = self.cfg
        cs = cfg.ctu_size
        h, w = src_y.shape
        acts = {}
        vals = []
        for cy in range(0, h, cs):
            for cx in range(0, w, cs):
                blk = src_y[cy : cy + cs, cx : cx + cs].astype(np.float64)
                bh, bw = blk.shape
                qs = [blk[: bh // 2 or 1, : bw // 2 or 1],
                      blk[: bh // 2 or 1, bw // 2 :],
                      blk[bh // 2 :, : bw // 2 or 1],
                      blk[bh // 2 :, bw // 2 :]]
                act = 1.0 + float(np.mean(
                    [q.var() for q in qs if q.size]))
                acts[(cx, cy)] = act
                vals.append(act)
        avg = float(np.mean(vals)) if vals else 1.0
        out = {}
        for k, act in acts.items():
            d = cfg.aqp_strength * np.log2(act / avg)
            out[k] = int(np.clip(round(d), -cfg.aqp_range, cfg.aqp_range))
        return out

    def _enter_ctu_qp(self, ctu_rect):
        """Per-CTU target QP + lambda + fresh quantization-group state."""
        if not self.dcs.pps.cu_qp_delta_enabled:
            self._ctu_qp = None
            return
        rc = getattr(self, "_ctu_rc", None)
        if rc is not None:
            qp, _lam = rc.ctu_qp()
            d = qp - self.frame_qp
        else:
            d = getattr(self, "_aqp_dqp", {}).get((ctu_rect.x, ctu_rect.y), 0)
        qp = int(np.clip(self.frame_qp + d, 0, 63))
        self._ctu_qp = qp
        self.lam = self._base_lam * 2.0 ** ((qp - self.frame_qp) / 3.0)
        self._qg = {"prev": getattr(self, "_qg_carry", self.frame_qp),
                    "pred": None, "signaled": False, "qp": None}

    def _qg_update(self, cu, codes_dqp: bool):
        """Decoder-consistent QP finalization: CUs before the first
        dqp-coded TU of a quantization group carry the PREDICTED QP (the
        reader never sees their target)."""
        qg = getattr(self, "_qg", None)
        if qg is None or not self.dcs.pps.cu_qp_delta_enabled:
            return
        if qg["pred"] is None:
            qg["pred"] = self._helper._predict_qp(cu, qg["prev"])
            qg["qp"] = qg["pred"]
        if qg["signaled"]:
            cu.qp = qg["qp"]
        elif codes_dqp:
            qg["signaled"] = True
            qg["qp"] = cu.qp
        else:
            cu.qp = qg["pred"]
        self._qg_carry = qg["qp"]
        b = cu.blocks[0]
        self.dcs.qp_map_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = cu.qp

    # -- fast-RD: whole-tree partition DP over the RMD SATD table --------
    def _fast_rd_cost_model(self):
        """(satd_weight, leaf_cost, split_cost) of the partition DP, in
        real RD units (pixel SSD + lambda*bits).

        Residual bits of a coded block ~ SATD / (c * Qstep) (the
        high-rate entropy model), so SATD enters the DP weighted by
        lambda / (c * Qstep) rather than 1.0 — without this the DP
        over-splits badly at moderate QP where most residual quantizes
        away (measured: 255 vs 54 leaves on small208 qp32).  leaf bits ~
        mode + cbf signalling per CU; split bits ~ split flags."""
        qstep = 2.0 ** ((self.frame_qp - 4) / 6.0)
        c = getattr(self.cfg, "fast_rd_bits_per_satd", 8.0)
        return (self.lam / (c * qstep),
                self.lam * getattr(self.cfg, "fast_rd_leaf_bits", 6.0),
                self.lam * getattr(self.cfg, "fast_rd_split_bits", 2.0))

    def _fast_rd_node(self, part: P.Partitioner):
        """Split-vs-CU decision from the batched RMD table alone (no
        exact-RD trials): bottom-up cost = weighted best SATD +
        mode/split signalling estimates, the EncCu recursion recast as
        argmin over the enumerated table (SURVEY §7).  Returns
        (cost, {key: split}) or None when a subtree can't be priced from
        the table (caller falls back to the exact-RD recursion)."""
        dcs = self.dcs
        fr = self._frame_rmd
        a = part.cur_area()
        key = (a.x, a.y, a.w, a.h, part.cur_depth)
        can_no, can_qt, can_bh, can_bv, can_th, can_tv = part.can_split_flags()
        inside = a.x1 <= dcs.pic_w and a.y1 <= dcs.pic_h
        model = getattr(self, "_fast_model", None)
        if model is None or model[3] != self.frame_qp:
            self._fast_model = model = (*self._fast_rd_cost_model(),
                                        self.frame_qp)
        sw, leaf_bits, split_bits = model[:3]
        best = None
        ns_satd = None
        if can_no:
            st = fr.stats(a.x, a.y, a.w, a.h) if inside else None
            if st is None:
                return None
            ns_satd = float(st[0])
            leaf = ns_satd
            if self.cfg.mip and st[3] is not None:
                leaf = min(leaf, float(st[3]))
            best = (leaf * sw + leaf_bits, {key: P.CU_DONT_SPLIT})
        split_modes = []
        if can_qt and (
            not can_no or self._helper._signal_mode_cons(part, P.CU_QUAD_SPLIT) == 0
        ):
            split_modes.append(P.CU_QUAD_SPLIT)
        if inside:
            helper = self._helper
            for flag, mode in ((can_bh, P.CU_HORZ_SPLIT),
                               (can_bv, P.CU_VERT_SPLIT),
                               (can_th, P.CU_TRIH_SPLIT),
                               (can_tv, P.CU_TRIV_SPLIT)):
                if flag and helper._signal_mode_cons(part, mode) == 0:
                    split_modes.append(mode)
        for mode in split_modes:
            total = split_bits
            choices = {key: mode}
            ok = True
            part.split_cur_area(mode)
            while True:
                sub = part.cur_area()
                if sub.x < dcs.pic_w and sub.y < dcs.pic_h:
                    r = self._fast_rd_node(part)
                    if r is None:
                        ok = False
                    else:
                        total += r[0]
                        choices.update(r[1])
                if not part.next_part():
                    break
            part.exit_cur_split()
            if not ok:
                return None
            if best is None or total < best[0]:
                best = (total, choices)
        return best

    def _commit_node(self, part: P.Partitioner, est: BitEstimator):
        """Commit the DP-chosen tree: encode each leaf once (no
        temp/best snapshots) with the table-ranked mode."""
        dcs = self.dcs
        a = part.cur_area()
        key = (a.x, a.y, a.w, a.h, part.cur_depth)
        mode = self._split_map[key]
        if mode != P.CU_DONT_SPLIT:
            part.split_cur_area(mode)
            while True:
                sub = part.cur_area()
                if sub.x < dcs.pic_w and sub.y < dcs.pic_h:
                    self._commit_node(part, est)
                if not part.next_part():
                    break
            part.exit_cur_split()
            return
        cands = self._fast_mode_cands(a)
        if len(cands) == 1:
            fmt = dcs.chroma_format
            self._ref_ok = {
                0: (a.x, a.y, a.w, a.h),
                1: (a.x >> fmt.scale_x, a.y >> fmt.scale_y,
                    a.w >> fmt.scale_x, a.h >> fmt.scale_y),
            }
            self._ref_cache = {}
            self._encode_cu_with_mode(a, part, cands[0], est)
            self._ref_ok = None
        else:
            self._rd_cu(a, part, est, cand_modes=cands)

    def _fast_mode_cands(self, a: Rect) -> list:
        """Commit-time mode ranking: table SATD + true-MPM signalling
        bits (the exact-MPM re-rank the frame-level DP can't do because
        neighbour modes aren't decided yet)."""
        fr = self._frame_rmd
        row = fr._rows.get((a.x, a.y, a.w, a.h))
        n = max(1, getattr(self.cfg, "fast_rd_cands", 1))
        if row is None:
            st = fr.stats(a.x, a.y, a.w, a.h)
            if st is None:
                src_y = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
                return self._preselect_modes_host(a, src_y)[:n]
            # un-prefetched leaf: summary-stat candidates (best + planar
            # + mip) without the full-row MPM re-rank
            out = [st[1]]
            if 0 not in out:
                out.append(0)
            if self.cfg.mip and st[3] is not None and st[3] < st[0]:
                out.insert(0, ("mip", st[4] >> 1, bool(st[4] & 1)))
            return out
        ang, mipc = row
        cu_probe = self._make_cu(a)
        mpm = self._helper._get_intra_mpms(cu_probe)
        lam_bits = self.lam ** 0.5
        bits = np.full(67, 7.0)
        for i, m in enumerate(mpm):
            bits[m] = (2.0, 3.0, 4.0, 5.0, 6.0, 6.0)[i]
        cost = ang.astype(np.float64) + lam_bits * bits
        order = np.argsort(cost, kind="stable")
        out: list = [int(m) for m in order[:n]]
        if 0 not in out:
            out.append(0)  # planar always reaches the RD stage (VTM)
        if self.cfg.mip and len(mipc):
            bi = int(np.argmin(mipc))
            mip_cand = ("mip", bi >> 1, bool(bi & 1))
            if float(mipc[bi]) + lam_bits * 6.0 < float(cost[order[0]]):
                out.insert(0, mip_cand)
            else:
                out.append(mip_cand)
        return out

    def _split_satd_estimate(self, part: P.Partitioner, mode: int, fr):
        """Sum of children's best angular SATD + per-child mode-signalling
        cost for a candidate split, from the frame RMD table.  None when
        any child is outside the table (border/untracked geometry)."""
        lam_bits = self.lam ** 0.5
        dcs = self.dcs
        total = 0.0
        ok = True
        part.split_cur_area(mode)
        while True:
            sub = part.cur_area()
            if sub.x < dcs.pic_w and sub.y < dcs.pic_h:
                if sub.x1 > dcs.pic_w or sub.y1 > dcs.pic_h:
                    ok = False
                else:
                    st = fr.stats(sub.x, sub.y, sub.w, sub.h)
                    if st is None:
                        ok = False
                    else:
                        total += float(st[0]) + lam_bits * 7.0
            if not part.next_part():
                break
        part.exit_cur_split()
        return total if ok else None

    def _restore_from_capture(self, a: Rect, snap):
        """Apply a captured (post-branch) snapshot: list lengths grow back."""
        dcs = self.dcs
        # the capture contains the region state AND implies cus/tus lists
        # up to the captured lengths; branches only append, so re-extend
        # is impossible after truncation — instead keep the captured list
        # tails inside the snapshot.
        self._restore_region(a, snap)

    def _restore_region(self, a: Rect, snap):
        dcs = self.dcs
        r = self.recon
        sx, sy = dcs.chroma_format.scale_x, dcs.chroma_format.scale_y
        ca = Rect(a.x >> sx, a.y >> sy, a.w >> sx, a.h >> sy)
        if snap.get("qg") is not None:
            q, carry = snap["qg"]
            self._qg = dict(q) if q else None
            if carry is not None:
                self._qg_carry = carry
        dcs.map_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2] = snap["map_l"]
        dcs.map_tu_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2] = snap["map_tu_l"]
        dcs.qp_map_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2] = snap["qp_l"]
        r.planes[0][a.y : a.y1, a.x : a.x1] = snap["plane0"]
        r.decomp_l[a.y >> 2 : a.y1 >> 2, a.x >> 2 : a.x1 >> 2] = snap["dec_l"]
        if dcs.map_c is not None:
            dcs.map_c[ca.y >> 1 : ca.y1 >> 1, ca.x >> 1 : ca.x1 >> 1] = snap["map_c"]
            dcs.map_tu_c[ca.y >> 1 : ca.y1 >> 1, ca.x >> 1 : ca.x1 >> 1] = snap["map_tu_c"]
            r.planes[1][ca.y : ca.y1, ca.x : ca.x1] = snap["plane1"]
            r.planes[2][ca.y : ca.y1, ca.x : ca.x1] = snap["plane2"]
            r.decomp_c[ca.y >> 1 : ca.y1 >> 1, ca.x >> 1 : ca.x1 >> 1] = snap["dec_c"]
        self._restore_motion(a, snap)
        if "cus_tail" in snap:
            del dcs.cus[snap["n_cus"]:]
            dcs.cus.extend(snap["cus_tail"])
            del dcs.tus[snap["n_tus"]:]
            dcs.tus.extend(snap["tus_tail"])

    # ------------------------------------------------------------------
    def _rd_cu(self, a: Rect, part: P.Partitioner, est: BitEstimator,
               cand_modes: list | None = None) -> float:
        """Search intra modes for CU at area a; commit best; return dist and
        add bits to est.  cand_modes overrides the RMD preselection (the
        fast-RD commit passes its own table-ranked finalists)."""
        dcs = self.dcs
        fmt = dcs.chroma_format
        src_y = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
        # full-block reference fills are invariant across the mode trials of
        # this CU (reconstruction only touches samples INSIDE the block):
        # cache them for the duration of this _rd_cu call
        self._ref_ok = {
            0: (a.x, a.y, a.w, a.h),
            1: (a.x >> fmt.scale_x, a.y >> fmt.scale_y,
                a.w >> fmt.scale_x, a.h >> fmt.scale_y),
        }
        self._ref_cache = {}
        # ---- luma candidate preselection by SATD-like cost on prediction
        if cand_modes is None:
            cand_modes = self._preselect_modes(a, src_y)
        best = None  # (cost, dist, snap_after, est_after)
        clipped = a
        snap0 = self._snapshot(clipped)
        for mode in cand_modes:
            est_c = est.copy()
            bits0 = est_c.frac_bits
            dist = self._encode_cu_with_mode(a, part, mode, est_c)
            cost = dist + self.lam * ((est_c.frac_bits - bits0) / 32768.0)
            if best is None or cost < best[0]:
                cap = self._snapshot(clipped)
                cap["n_cus"] = snap0["n_cus"]
                cap["n_tus"] = snap0["n_tus"]
                cap["cus_tail"] = dcs.cus[snap0["n_cus"]:]
                cap["tus_tail"] = dcs.tus[snap0["n_tus"]:]
                best = (cost, dist, cap, est_c)
            self._restore(clipped, snap0)
        cost, dist, cap, est_c = best
        self._restore_region(clipped, cap)
        est.ctx = est_c.ctx
        est.frac_bits = est_c.frac_bits
        self._ref_ok = None
        return dist

    def _fill_refs(self, b, cu, comp: int, mrl: int):
        """fill_reference_samples with a per-_rd_cu memo for full-block
        fills (trial-invariant; see _rd_cu)."""
        ok = getattr(self, "_ref_ok", None)
        if ok is not None and ok.get(min(comp, 1)) == (b.x, b.y, b.w, b.h):
            key = (comp, mrl)
            v = self._ref_cache.get(key)
            if v is None:
                v = self.recon.fill_reference_samples(b, cu, comp, mrl)
                self._ref_cache[key] = v
            return v
        return self.recon.fill_reference_samples(b, cu, comp, mrl)

    def _predict_luma_cu(self, cu, b) -> np.ndarray:
        """Luma prediction dispatch matching the decoder's intra_rec_blk
        (DecCu.cpp xIntraRecBlk): MIP, MRL reference lines, or the regular
        angular/planar/DC path."""
        if getattr(cu, "mip_flag", False):
            top, left = self._fill_refs(b, cu, 0, 0)
            return I.pred_mip(
                top[1 : b.w + 1], left[1 : b.h + 1], b.w, b.h,
                cu.intra_dir[0], cu.mip_transposed, self.cfg.bit_depth)
        mrl = getattr(cu, "multi_ref_idx", 0)
        mode = cu.intra_dir[0]
        p = I.IntraParams(mode, b.w, b.h, b.w, b.h, True, mrl, False, False)
        top, left = self._fill_refs(b, cu, 0, mrl)
        if p.ref_filter_flag:
            ftop, fleft = I.filter_reference_samples(top, left, b.w * 2,
                                                     b.h * 2, mrl)
        else:
            ftop, fleft = top, left
        if mode == D.PLANAR_IDX:
            pred = I.pred_planar(ftop, fleft, b.w, b.h)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, ftop, fleft)
        elif mode == D.DC_IDX:
            dc = I.pred_dc(top, left, b.w, b.h, p.multi_ref_idx)
            pred = np.full((b.h, b.w), dc, dtype=np.int64)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, top, left)
        else:
            use_t, use_l = (ftop, fleft) if p.ref_filter_flag else (top, left)
            pred = I.pred_angular(use_t, use_l, b.w, b.h, p, True,
                                  self.cfg.bit_depth)
        return pred

    def _preselect_modes(self, a: Rect, src_y: np.ndarray) -> list[int]:
        """RMD candidate selection (IntraSearch estIntraPredLumaQT SATD
        pass).  Primary path: the whole-frame batched device RMD table
        (frame_rmd.FrameRMD — SATD over all modes, one dispatch per frame);
        fallback: the per-CU host SAD sweep."""
        fr = getattr(self, "_frame_rmd", None)
        row = fr.costs(a.x, a.y, a.w, a.h) if fr is not None else None
        if row is None:
            return self._preselect_modes_host(a, src_y)
        ang, mipc = row
        cu_probe = self._make_cu(a)
        mpm = self._helper._get_intra_mpms(cu_probe)
        lam_bits = self.lam ** 0.5
        # xFracModeBits approximation: mpm_flag + unary mpm idx, or
        # flag + 6-bit truncated binary over the 61 non-MPM modes
        bits = np.full(67, 7.0)
        for i, m in enumerate(mpm):
            bits[m] = (2.0, 3.0, 4.0, 5.0, 6.0, 6.0)[i]
        cost = ang.astype(np.float64) + lam_bits * bits
        order = np.argsort(cost, kind="stable")
        finalists: list = [int(m) for m in order[: self.cfg.num_rd_modes]]
        if 0 not in finalists:
            finalists.append(0)  # planar always reaches full RD (VTM)
        finalists.extend(self._isp_candidates(a, int(order[0])))
        if self.cfg.mip and len(mipc):
            bi = int(np.argmin(mipc))
            finalists.append(("mip", bi >> 1, bool(bi & 1)))
        mrl = self._mrl_candidate(a, cu_probe)
        if mrl is not None:
            finalists.append(mrl)
        return finalists

    def _isp_candidates(self, a: Rect, best_mode: int) -> list:
        """ISP candidates: both split directions with the best RMD mode."""
        out = []
        if self.cfg.isp and a.w <= 64 and a.h <= 64 and a.w * a.h > 16:
            from vtm_jax.decoder.cabac_reader import SyntaxReader as _SR

            for split in (1, 2):
                if split == 1:
                    tw, th = a.w, _SR.isp_split_dim(a.w, a.h, True)
                else:
                    tw, th = _SR.isp_split_dim(a.w, a.h, False), a.h
                if tw >= 4 and th >= 4:
                    out.append(("isp", split, best_mode))
        return out

    def _mrl_candidate(self, a: Rect, cu_probe):
        """Best reference-line-1/2 MPM candidate by SAD on recon refs."""
        if not (self.cfg.mrl and (a.y & (self.cfg.ctu_size - 1)) != 0):
            return None
        src_y = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
        mpm = self._helper._get_intra_mpms(cu_probe)
        best_mrl = None
        for ref in (1, 2):
            top_r, left_r = self._fill_refs(
                Rect(a.x, a.y, a.w, a.h), cu_probe, 0, ref)
            for m in mpm[1:]:
                if m < 2:
                    continue
                p = I.IntraParams(m, a.w, a.h, a.w, a.h, True, ref,
                                  False, False)
                if p.ref_filter_flag:
                    ft, fl = I.filter_reference_samples(
                        top_r, left_r, a.w * 2, a.h * 2, ref)
                else:
                    ft, fl = top_r, left_r
                pred = I.pred_angular(ft, fl, a.w, a.h, p, True,
                                      self.cfg.bit_depth)
                c = float(np.abs(src_y - pred).sum())
                if best_mrl is None or c < best_mrl[0]:
                    best_mrl = (c, ref, m)
        if best_mrl is None:
            return None
        return ("mrl", best_mrl[1], best_mrl[2])

    def _preselect_modes_host(self, a: Rect, src_y: np.ndarray) -> list[int]:
        """Coarse angular sweep + refinement, SAD cost on luma prediction."""
        cu_probe = self._make_cu(a)  # temporary for ref fetch (not committed)
        top, left = self._fill_refs(Rect(a.x, a.y, a.w, a.h), cu_probe, 0, 0)
        ftop, fleft = I.filter_reference_samples(top, left, a.w * 2, a.h * 2, 0)
        sad = {}
        coarse = [0, 1, 2, 10, 18, 26, 34, 42, 50, 58, 66]
        for m in (0, 1):
            sad[m] = self._pred_cost(m, a, src_y, top, left, ftop, fleft)
        # all angular probes of the sweep in one batched gather+interp
        sad.update(I.angular_sad_batch(top, left, ftop, fleft, a.w, a.h,
                                       [m for m in coarse if m > 1],
                                       src_y, self.cfg.bit_depth))
        best_ang = min((m for m in coarse if m > 1), key=lambda m: sad[m])
        refine = [m for m in (best_ang - 4, best_ang - 2, best_ang - 1,
                              best_ang + 1, best_ang + 2, best_ang + 4)
                  if 2 <= m <= 66 and m not in sad]
        if refine:
            sad.update(I.angular_sad_batch(top, left, ftop, fleft, a.w, a.h,
                                           refine, src_y,
                                           self.cfg.bit_depth))
        ranked = sorted(sad, key=lambda m: sad[m])
        finalists = []
        for m in (0, 1):
            finalists.append(m)
        for m in ranked:
            if m not in finalists:
                finalists.append(m)
            if len(finalists) >= 2 + self.cfg.num_rd_modes:
                break
        # ISP candidates: both split directions with the best SATD mode
        # (IntraSearch ISP candidate handling analogue)
        finalists.extend(self._isp_candidates(a, ranked[0]))
        # MIP candidates (MatrixIntraPrediction SATD pass,
        # IntraSearch.cpp estIntraPredLumaQT MIP preselection analogue)
        if self.cfg.mip:
            from vtm_jax.ops.intra import mip_size_id

            num_modes = {0: 16, 1: 8, 2: 6}[mip_size_id(a.w, a.h)]
            t1 = top[1 : a.w + 1]
            l1 = left[1 : a.h + 1]
            best_mip = None
            for idx in range(num_modes):
                for tr in (False, True):
                    pred = I.pred_mip(t1, l1, a.w, a.h, idx, tr,
                                      self.cfg.bit_depth)
                    c = float(np.abs(src_y - pred).sum())
                    if best_mip is None or c < best_mip[0]:
                        best_mip = (c, idx, tr)
            finalists.append(("mip", best_mip[1], best_mip[2]))
        # MRL candidates: reference lines 1/2 over the non-planar MPMs
        mrl = self._mrl_candidate(a, cu_probe)
        if mrl is not None:
            finalists.append(mrl)
        return finalists

    def _pred_cost(self, mode, a, src_y, top, left, ftop, fleft) -> float:
        pred = self._predict_luma(mode, a, top, left, ftop, fleft)
        return float(np.abs(src_y - pred).sum())

    def _predict_luma(self, mode, a, top, left, ftop, fleft) -> np.ndarray:
        p = I.IntraParams(mode, a.w, a.h, a.w, a.h, True, 0, False, False)
        if mode == D.PLANAR_IDX:
            use_t, use_l = (ftop, fleft) if p.ref_filter_flag else (top, left)
            pred = I.pred_planar(use_t, use_l, a.w, a.h)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, use_t, use_l)
        elif mode == D.DC_IDX:
            dc = I.pred_dc(top, left, a.w, a.h, 0)
            pred = np.full((a.h, a.w), dc, dtype=np.int64)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, top, left)
        else:
            use_t, use_l = (ftop, fleft) if p.ref_filter_flag else (top, left)
            pred = I.pred_angular(use_t, use_l, a.w, a.h, p, True,
                                  self.cfg.bit_depth)
        return pred

    def _make_cu(self, a: Rect) -> CU:
        fmt = self.dcs.chroma_format
        ca = Rect(a.x >> fmt.scale_x, a.y >> fmt.scale_y,
                  a.w >> fmt.scale_x, a.h >> fmt.scale_y)
        blocks = [Rect(a.x, a.y, a.w, a.h), ca, Rect(ca.x, ca.y, ca.w, ca.h)]
        cu = CU(ch_type=D.CH_L, tree_type=D.TREE_D, mode_type=D.MODE_TYPE_ALL,
                blocks=blocks, chroma_format=fmt)
        cu.qp = getattr(self, "_ctu_qp", None) or self.frame_qp
        return cu

    def _encode_cu_with_mode(self, a: Rect, part: P.Partitioner, mode: int,
                             est: BitEstimator) -> float:
        """Commit a CU with the given luma mode (chroma DM); returns SSD."""
        dcs = self.dcs
        fmt = dcs.chroma_format
        cu = self._make_cu(a)
        cu.mip_flag = False
        cu.mip_transposed = False
        cu.multi_ref_idx = 0
        if isinstance(mode, tuple) and mode[0] == "isp":
            return self._encode_cu_isp(a, part, mode[1], mode[2], est)
        if isinstance(mode, tuple):
            if mode[0] == "mip":
                cu.mip_flag = True
                cu.intra_dir = [mode[1], D.DM_CHROMA_IDX]
                cu.mip_transposed = bool(mode[2])
            else:  # ("mrl", ref_idx, mode)
                cu.multi_ref_idx = mode[1]
                cu.intra_dir = [mode[2], D.DM_CHROMA_IDX]
        else:
            cu.intra_dir = [mode, D.DM_CHROMA_IDX]
        cu.qt_depth = part.cur_qt_depth
        cu.depth = part.cur_depth
        cu.split_series = tuple(lvl.split for lvl in part.stack[1:])
        dcs.add_cu(cu)
        tu = TU(blocks=[Rect(b.x, b.y, b.w, b.h) if b else None for b in cu.blocks],
                cu=cu, depth=0)
        cu.tus.append(tu)
        dcs.add_tu(tu)
        dist = 0.0
        maxv = (1 << self.cfg.bit_depth) - 1
        for comp in range(fmt.num_components):
            b = tu.blocks[comp]
            src = self.src[comp][b.y : b.y1, b.x : b.x1].astype(np.int64)
            # prediction via the shared reconstructor path
            if comp == 0:
                pred = self._predict_luma_cu(cu, b)
            else:
                if comp == 1:
                    self._choose_chroma_mode(cu, tu)
                pred = self._predict_chroma(cu, tu, comp)
            resi = src - pred
            qp = self.recon._qp_for(tu, comp)
            use_tx_search = comp == 0 and (
                (self.cfg.mts and 4 <= b.w <= 32 and 4 <= b.h <= 32)
                or (self.cfg.lfnst and min(b.w, b.h) >= 4)
            )
            if comp == 0:
                luma_ctx = (b, pred, resi, qp)
            if use_tx_search:
                lev, rec_resi, mts, lfn = self._search_luma_transform(
                    tu, resi.astype(np.int32), qp, est)
                tu.mts_idx[0] = mts
                cu.lfnst_idx = lfn
                tu.coeffs[comp] = lev
                tu.cbf[comp] = int(np.any(lev))
            else:
                coeffs = TX.fwd_transform_2d_np(resi.astype(np.int32), self.cfg.bit_depth)
                lev = _quantize_tu(coeffs, qp, self.cfg.bit_depth, self.lam,
                                   self.cfg.dep_quant, tu=tu, comp=comp,
                                   est=est, sps=self.sps)
                tu.coeffs[comp] = lev
                tu.cbf[comp] = int(np.any(lev))
                if tu.cbf[comp]:
                    deq = _dequantize_tu(lev, qp, self.cfg.bit_depth,
                                         self.cfg.dep_quant)
                    rec_resi = TX.inv_transform_2d_np(deq, self.cfg.bit_depth)
                else:
                    rec_resi = np.zeros_like(src)
            recon = np.clip(pred + rec_resi, 0, maxv).astype(np.int32)
            self.recon.planes[comp][b.y : b.y1, b.x : b.x1] = recon
            self.recon.set_decomp(comp, b)
            if comp == 0:
                dcs.qp_map_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = cu.qp
            w = 1.0
            dist += w * float(np.sum((src - recon.astype(np.int64)) ** 2))
        if getattr(cu, "lfnst_idx", 0) and not self._lfnst_signalable(tu):
            # a chroma TB put its last significant coefficient outside the
            # LFNST corner (residual_lfnst_mode parse gate) — redo luma
            # with the secondary transform off
            b, pred, resi, qp = luma_ctx
            cu.lfnst_idx = 0
            coeffs = TX.fwd_transform_2d_np(resi.astype(np.int32), self.cfg.bit_depth)
            lev = _quantize_tu(coeffs, qp, self.cfg.bit_depth, self.lam,
                               self.cfg.dep_quant, tu=tu, comp=0,
                               est=est, sps=self.sps)
            tu.mts_idx[0] = 0
            tu.coeffs[0] = lev
            tu.cbf[0] = int(np.any(lev))
            if tu.cbf[0]:
                deq = _dequantize_tu(lev, qp, self.cfg.bit_depth, self.cfg.dep_quant)
                rec_resi = TX.inv_transform_2d_np(deq, self.cfg.bit_depth)
            else:
                rec_resi = np.zeros((b.h, b.w), dtype=np.int64)
            src = self.src[0][b.y : b.y1, b.x : b.x1].astype(np.int64)
            recon = np.clip(pred + rec_resi, 0, maxv).astype(np.int32)
            old = self.recon.planes[0][b.y : b.y1, b.x : b.x1].astype(np.int64)
            dist -= float(np.sum((src - old) ** 2))
            dist += float(np.sum((src - recon.astype(np.int64)) ** 2))
            self.recon.planes[0][b.y : b.y1, b.x : b.x1] = recon
        # bits
        self._qg_update(cu, bool(any(t.cbf[0] or t.cbf[1] or t.cbf[2]
                                     for t in cu.tus)))
        writer = SyntaxWriter(dcs, est)
        writer.coding_unit(cu, part, CuCtx(self.frame_qp))
        return dist

    def _encode_cu_isp(self, a: Rect, part: P.Partitioner, split: int,
                       mode: int, est: BitEstimator) -> float:
        """Commit an ISP candidate (split 1=horizontal, 2=vertical): builds
        the sub-TU chain (reader _isp_transform_tree layout), quantizes each
        sub-TB against the decoder-exact sequential prediction via the
        _recon_isp_luma hook, then codes chroma on the last sub-TU.
        Returns inf when the candidate is unsignalable (all-zero luma)."""
        dcs = self.dcs
        fmt = dcs.chroma_format
        cu = self._make_cu(a)
        cu.mip_flag = False
        cu.mip_transposed = False
        cu.multi_ref_idx = 0
        cu.intra_dir = [mode, D.DM_CHROMA_IDX]
        cu.isp_mode = split
        cu.qt_depth = part.cur_qt_depth
        cu.depth = part.cur_depth
        cu.split_series = tuple(lvl.split for lvl in part.stack[1:])
        dcs.add_cu(cu)
        parts = self._helper.isp_partitions(cu)
        has_chroma = fmt.num_components > 1
        for idx, sub in enumerate(parts):
            blocks = [sub, None, None]
            if idx == len(parts) - 1 and has_chroma:
                blocks[1] = Rect(cu.blocks[1].x, cu.blocks[1].y,
                                 cu.blocks[1].w, cu.blocks[1].h)
                blocks[2] = Rect(cu.blocks[2].x, cu.blocks[2].y,
                                 cu.blocks[2].w, cu.blocks[2].h)
            tu = TU(blocks=blocks, cu=cu, depth=1)
            cu.tus.append(tu)
            dcs.add_tu(tu)
        bd = self.cfg.bit_depth

        def qcb(tu, pred_tb):
            b = tu.blocks[0]
            src = self.src[0][b.y : b.y1, b.x : b.x1].astype(np.int64)
            resi = (src - pred_tb).astype(np.int32)
            coeffs = TX.fwd_transform_2d_np(resi, bd)
            qp = self.recon._qp_for(tu, 0)
            lev = _quantize_tu(coeffs, qp, bd, self.lam, self.cfg.dep_quant,
                               tu=tu, comp=0, est=est, sps=self.sps)
            tu.coeffs[0] = lev
            tu.cbf[0] = int(np.any(lev))

        self.recon._recon_isp_luma(cu, quantize_cb=qcb)
        if not any(t.cbf[0] for t in cu.tus):
            return float("inf")  # last-cbf inference needs a nonzero luma TB
        src_l = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
        rec_l = self.recon.planes[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
        dist = float(np.sum((src_l - rec_l) ** 2))
        tu = cu.tus[-1]
        maxv = (1 << bd) - 1
        if has_chroma:
            for comp in (1, 2):
                b = tu.blocks[comp]
                if comp == 1:
                    self._choose_chroma_mode(cu, tu)
                src = self.src[comp][b.y : b.y1, b.x : b.x1].astype(np.int64)
                pred = self._predict_chroma(cu, tu, comp)
                resi = src - pred
                coeffs = TX.fwd_transform_2d_np(resi.astype(np.int32), bd)
                qp = self.recon._qp_for(tu, comp)
                lev = _quantize_tu(coeffs, qp, bd, self.lam,
                                   self.cfg.dep_quant, tu=tu, comp=comp,
                                   est=est, sps=self.sps)
                tu.coeffs[comp] = lev
                tu.cbf[comp] = int(np.any(lev))
                if tu.cbf[comp]:
                    deq = _dequantize_tu(lev, qp, bd, self.cfg.dep_quant)
                    rec_resi = TX.inv_transform_2d_np(deq, bd)
                else:
                    rec_resi = np.zeros_like(src)
                recon = np.clip(pred + rec_resi, 0, maxv).astype(np.int32)
                self.recon.planes[comp][b.y : b.y1, b.x : b.x1] = recon
                self.recon.set_decomp(comp, b)
                dist += float(np.sum((src - recon.astype(np.int64)) ** 2))
        self._qg_update(cu, bool(any(t.cbf[0] or t.cbf[1] or t.cbf[2]
                                     for t in cu.tus)))
        writer = SyntaxWriter(dcs, est)
        writer.coding_unit(cu, part, CuCtx(self.frame_qp))
        return dist

    def _lfnst_signalable(self, tu) -> bool:
        """Chroma side of the residual_lfnst_mode parse gate (the luma TB is
        constrained at candidate time in _search_luma_transform)."""
        from vtm_jax.common import rom as _rom

        for comp in (1, 2):
            if comp >= len(tu.blocks) or tu.blocks[comp] is None:
                continue
            if not tu.cbf[comp]:
                continue
            bb = tu.blocks[comp]
            if bb.w < 4 or bb.h < 4:
                continue
            scan = _rom.scan(1, bb.w, bb.h)
            nz = np.nonzero(tu.coeffs[comp].ravel()[scan[:, 0].astype(np.int64)])[0]
            if nz.size == 0:
                continue
            maxp = 7 if ((bb.w == 4 and bb.h == 4) or
                         (bb.w == 8 and bb.h == 8)) else 15
            if int(nz[-1]) > maxp:
                return False
        return True

    def _search_luma_transform(self, tu, resi, qp, est):
        """Luma transform candidate loop (IntraSearch MTS/LFNST pass
        analogue, IntraSearch.cpp:3591 xRecurIntraCodingLumaQT tests):
        DCT2, the four explicit-MTS DST7/DCT8 combos, and LFNST idx 1/2 on
        top of DCT2, priced by distortion + a level-magnitude rate proxy;
        returns (levels, rec_resi, mts_idx, lfnst_idx)."""
        from vtm_jax.common import rom as _rom
        from vtm_jax.decoder.cs import (
            MTS_DCT2_DCT2, MTS_DST7_DST7, MTS_DCT8_DST7, MTS_DST7_DCT8,
            MTS_DCT8_DCT8,
        )

        bd = self.cfg.bit_depth
        b = tu.blocks[0]
        w, h = b.w, b.h
        best = None

        def consider(lev, rec, sig_bins, mts, lfn):
            nonlocal best
            dist = float(np.sum((resi.astype(np.int64) - rec) ** 2))
            rate = float(np.abs(lev).sum() + np.count_nonzero(lev)) + sig_bins
            cost = dist + self.lam * rate
            if best is None or cost < best[0]:
                best = (cost, lev, rec, mts, lfn)

        prim = [(MTS_DCT2_DCT2, TX.DCT2, TX.DCT2, 0)]
        if self.cfg.mts and 4 <= w <= 32 and 4 <= h <= 32:
            prim += [
                (MTS_DST7_DST7, TX.DST7, TX.DST7, 2),
                (MTS_DCT8_DST7, TX.DCT8, TX.DST7, 3),
                (MTS_DST7_DCT8, TX.DST7, TX.DCT8, 3),
                (MTS_DCT8_DCT8, TX.DCT8, TX.DCT8, 4),
            ]
        coeffs_dct2 = None
        for mts, th, tv, sig_bins in prim:
            coeffs = TX.fwd_transform_2d_np(resi, bd, th, tv)
            if mts == MTS_DCT2_DCT2:
                coeffs_dct2 = coeffs
            lev = _quantize_tu(coeffs, qp, bd, self.lam, self.cfg.dep_quant,
                               tu=tu, comp=0, est=est, sps=self.sps,
                               eff_w=16 if (mts != MTS_DCT2_DCT2 and w == 32)
                               else None,
                               eff_h=16 if (mts != MTS_DCT2_DCT2 and h == 32)
                               else None)
            nzy, nzx = np.nonzero(lev)
            if mts != MTS_DCT2_DCT2:
                # must be signalable: last scan pos > 0, nothing outside 16x16
                if nzy.size == 0 or (nzy.size == 1 and nzy[0] == 0 and nzx[0] == 0):
                    continue
                if (nzx >= 16).any() or (nzy >= 16).any():
                    continue
            if nzy.size:
                deq = _dequantize_tu(lev, qp, bd, self.cfg.dep_quant)
                rec = TX.inv_transform_2d_np(deq, bd, th, tv)
            else:
                rec = np.zeros_like(resi, dtype=np.int64)
            consider(lev, rec, sig_bins, mts, 0)
        max_tb = 1 << self.sps.log2_max_tb_size
        mip_blocks_lfnst = getattr(tu.cu, "mip_flag", False) and not (
            w >= 16 and h >= 16)
        if (self.cfg.lfnst and min(w, h) >= 4 and w <= max_tb and h <= max_tb
                and not mip_blocks_lfnst and coeffs_dct2 is not None):
            scan = _rom.scan(1, w, h)
            sidx = scan[:, 0].astype(np.int64)
            maxp = 7 if ((w == 4 and h == 4) or (w == 8 and h == 8)) else 15
            for lfn in (1, 2):
                lfc = self.recon.fwd_lfnst(tu, 0, coeffs_dct2, lfn)
                lev = _quantize_tu(lfc, qp, bd, self.lam, self.cfg.dep_quant,
                                   tu=tu, comp=0, est=est, sps=self.sps,
                                   lfnst_idx=lfn)
                nz = np.nonzero(lev.ravel()[sidx])[0]
                # residual_lfnst_mode parse gate: last in [1, maxp]
                if nz.size == 0 or int(nz[-1]) < 1 or int(nz[-1]) > maxp:
                    continue
                deq = _dequantize_tu(lev, qp, bd, self.cfg.dep_quant)
                tu.cu.lfnst_idx = lfn
                inv = self.recon.inv_lfnst(tu, 0, deq)
                tu.cu.lfnst_idx = 0
                rec = TX.inv_transform_2d_np(inv, bd)
                consider(lev, rec, 2.0, MTS_DCT2_DCT2, lfn)
        return best[1], best[2], best[3], best[4]

    def _choose_chroma_mode(self, cu: CU, tu: TU):
        """Chroma mode RD (IntraSearch::estIntraPredChromaQT analogue):
        DM vs the three CCLM linear models, priced by joint Cb+Cr
        distortion + a level-magnitude rate proxy.  Runs after the luma
        pass so CCLM sees this CU's reconstructed luma."""
        if not self.cfg.cclm:
            return
        bd = self.cfg.bit_depth
        cands = [D.DM_CHROMA_IDX, D.LM_CHROMA_IDX, D.MDLM_L_IDX, D.MDLM_T_IDX]
        best = None
        for m in cands:
            cu.intra_dir[1] = m
            cost = 2.0 if m != D.DM_CHROMA_IDX else 1.0  # mode bins proxy
            for comp in (1, 2):
                b = tu.blocks[comp]
                if b is None:
                    continue
                src = self.src[comp][b.y : b.y1, b.x : b.x1].astype(np.int64)
                pred = self._predict_chroma(cu, tu, comp)
                resi = (src - pred).astype(np.int64)
                coeffs = TX.fwd_transform_2d_np(resi.astype(np.int32), bd)
                qp = self.recon._qp_for(tu, comp)
                lev = _quantize_tu(coeffs, qp, bd, self.lam, self.cfg.dep_quant)
                if np.any(lev):
                    deq = _dequantize_tu(lev, qp, bd, self.cfg.dep_quant)
                    rec = TX.inv_transform_2d_np(deq, bd)
                    d = float(np.sum((resi - rec) ** 2))
                    r = float(np.abs(lev).sum() + np.count_nonzero(lev))
                else:
                    d = float(np.sum(resi.astype(np.float64) ** 2))
                    r = 0.0
                cost += d + self.lam * r
            if best is None or cost < best[0]:
                best = (cost, m)
        cu.intra_dir[1] = best[1]

    def _predict_chroma(self, cu: CU, tu: TU, comp: int) -> np.ndarray:
        b = tu.blocks[comp]
        if cu.intra_dir[1] in (D.LM_CHROMA_IDX, D.MDLM_L_IDX, D.MDLM_T_IDX):
            return self.recon._pred_cclm(tu, comp, cu.intra_dir[1])
        mode = self.recon._final_intra_mode(cu, comp)
        top, left = self._fill_refs(b, cu, comp, 0)
        p = I.IntraParams(mode, b.w, b.h, b.w, b.h, False, 0, False, False)
        if mode == D.PLANAR_IDX:
            pred = I.pred_planar(top, left, b.w, b.h)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, top, left)
        elif mode == D.DC_IDX:
            dc = I.pred_dc(top, left, b.w, b.h, 0)
            pred = np.full((b.h, b.w), dc, dtype=np.int64)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, top, left)
        else:
            pred = I.pred_angular(top, left, b.w, b.h, p, False, self.cfg.bit_depth)
        return pred

    # ------------------------------------------------------------------
    def _replay_node(self, writer: SyntaxWriter, part: P.Partitioner,
                     cu_ctx: CuCtx | None = None):
        """Write final bins for the chosen tree (from the RD choices map).

        cu_ctx threads the QP-prediction chain across CTUs when the
        caller passes a slice-persistent context (cu_qp_delta)."""
        dcs = self.dcs
        if cu_ctx is None:
            cu_ctx = CuCtx(self.frame_qp)
        if dcs.pps.cu_qp_delta_enabled and part.cur_qg_enable() \
                and part.ch_type != D.CH_C:
            cu_ctx.qg_start = True
            cu_ctx.is_dqp_coded = False
        a = part.cur_area()
        key = (a.x, a.y, a.w, a.h, part.cur_depth)
        split_mode = self._split_map[key]
        writer.split_cu_mode(split_mode, part)
        if split_mode != P.CU_DONT_SPLIT:
            part.split_cur_area(split_mode)
            while True:
                sub = part.cur_area()
                if sub.x < dcs.pic_w and sub.y < dcs.pic_h:
                    self._replay_node(writer, part, cu_ctx)
                if not part.next_part():
                    break
            part.exit_cur_split()
            return
        cu = dcs.get_cu(a.x, a.y, D.CH_L)
        writer.coding_unit(cu, part, cu_ctx)


class InterEncoder(IntraEncoder):
    """Low-delay-P encoder (SURVEY §7 phase 5 minimum): first frame IDR,
    then P frames referencing the previous picture.  Per-CU modes: skip /
    merge (full candidate list), AMVP with diamond integer ME + quarter-pel
    refinement (InterSearch.cpp xTZSearch/xPatternSearchFracDIF behavioral
    shape), and the intra toolset as fallback.  Tools-off SPS (no TMVP /
    MMVD / affine) so decode-side derivation needs only spatial + HMVP
    candidates."""

    def __init__(self, cfg: EncoderConfig):
        cfg.inter = True
        cfg.tmvp = True  # collocated temporal MVP on by default
        super().__init__(cfg)
        self.prev_pic = None
        self.me_range = 48

    def encode(self, frames):
        out = bytearray()
        out += self.sps_nal
        out += self.pps_nal
        for poc, planes in enumerate(frames):
            out += self.encode_frame(planes, poc, is_p=poc > 0)
        return bytes(out)

    def encode_frame(self, src_planes, poc: int, is_p: bool = False) -> bytes:
        if not is_p:
            nal = super().encode_frame(src_planes, poc)
            self._store_ref(poc)
            return nal
        d = poc - self.prev_pic.poc
        return self.encode_inter_frame(
            src_planes, poc, SliceType.P, [d], [d],
            self.cfg.qp + getattr(self.cfg, "p_qp_offset", 5))

    def encode_inter_frame(self, src_planes, poc: int, slice_type,
                           rpl0: list, rpl1: list, qp: int) -> bytes:
        """Encode one P or B picture.

        rpl0/rpl1: POC-delta lists (positive = past, negative = future);
        the first entry of each list is the active reference."""
        cfg = self.cfg
        sps, pps = self.sps, self.pps
        from types import SimpleNamespace

        from vtm_jax.common.params import PicHeader, SliceHeader
        from vtm_jax.decoder import motion as M
        from vtm_jax.decoder.cabac_reader import SyntaxReader

        is_b = slice_type == SliceType.B
        vlc.derive_pps_partitioning(pps, sps)
        ph = PicHeader()
        ph.inter_slice_allowed = True
        ph.intra_slice_allowed = False
        # B pictures code both mvds (true bi ME); P leaves L1 unused
        ph.mvd_l1_zero = not is_b
        ph.tmvp_enabled = bool(self.sps.temporal_mvp)
        # subblock merge cand count (vlc.py PH derivation rule)
        if self.sps.affine:
            ph.max_num_affine_merge_cand = self.sps.max_num_affine_merge_cand
        else:
            ph.max_num_affine_merge_cand = int(
                getattr(self.sps, "sbtmvp", False) and ph.tmvp_enabled)
        # PROF enable mirrors the PH parse inference (vlc.py:1355-1357):
        # no prof_control_present flag written -> ph_prof_disabled = 0
        ph.dis_prof = False
        ph.min_qt_size = list(sps.min_qt_size)
        ph.max_mtt_depth = list(sps.max_mtt_depth)
        ph.max_bt_size = list(sps.max_bt_size)
        ph.max_tt_size = list(sps.max_tt_size)
        self.frame_qp = qp
        # EncSlice::initializeLambda with LambdaFromQPEnable (CTC): flat
        # dQPFactor 0.57, lambda from the final per-picture QP
        self.lam = 0.57 * 2.0 ** ((self.frame_qp - 12) / 3.0)
        self._base_lam = self.lam
        self._aqp_dqp = {}  # per-CTU AQp targets: intra pictures only
        self._qg_carry = self.frame_qp
        sh = SliceHeader()
        sh.slice_type = slice_type
        sh.qp = self.frame_qp
        sh.poc = poc
        refs0 = [self.dpb[poc - d] for d in rpl0]
        refs1 = [self.dpb[poc - d] for d in rpl1]
        n0 = min(getattr(cfg, "num_active_refs", 1), len(refs0))
        sh.num_ref_idx = [n0, 1 if is_b else 0]
        sh.ref_pics = [refs0[:n0], refs1[:1] if is_b else []]
        sh.ref_pocs = [[p.poc for p in sh.ref_pics[0]],
                       [p.poc for p in sh.ref_pics[1]]]
        sh.ref_longterm = [[False] * len(sh.ref_pics[0]),
                           [False] * len(sh.ref_pics[1])]
        sh.check_ldc = all(p <= poc for p in sh.ref_pocs[0]) and all(
            p <= poc for p in sh.ref_pocs[1])
        sh.col_from_l0 = True
        sh.col_ref_idx = 0
        sh.bi_dir_pred = False
        sh.independent_slice_idx = 0
        sh.sao_enabled = [cfg.sao, cfg.sao and cfg.chroma_format_idc != 0]
        sh.dep_quant = cfg.dep_quant
        self._rpl_deltas = (rpl0, rpl1)
        n_ctu = pps.pic_width_in_ctu(sps.ctu_size) * pps.pic_height_in_ctu(sps.ctu_size)
        dcs = D.DecCodingStructure(sps, pps, ph, sh, np.zeros(n_ctu, dtype=np.int32))
        dcs._slice_headers = [sh]
        dcs.lmcs_model = None
        dcs.cur_ind_slice_idx = 0
        M.init_motion_field(dcs)
        self.dcs = dcs
        self._helper = SyntaxReader(dcs, None)
        self.src = src_planes
        # inter frames: the batched RMD table is only consulted by the
        # rare intra-fallback trials, so they use the per-CU host sweep on
        # every device (the same bitstream on the CPU and on the GPU)
        self._frame_rmd = None
        planes = [np.zeros_like(p) for p in src_planes]
        self.recon = CuReconstructor(dcs, planes)
        ctx_m = ContextModels()
        ctx_m.init(self.frame_qp, int(slice_type))
        slice_bw = BitWriter()
        enc = BinEncoder(slice_bw, ctx_m)
        enc.start()
        import os
        tr_path = os.environ.get("VTM_ENC_TRACE")
        if tr_path:
            if not hasattr(self, "_trace_f"):
                self._trace_f = open(tr_path, "w")
            enc.trace = self._trace_f
        w_ctu = dcs.pic_w_ctu
        h_ctu = dcs.pic_h_ctu
        # CTU-level rate control: remaining-budget R-lambda allocation with
        # MAD-vs-previous-recon complexity weights (RateCtrl.h:189-247)
        self._ctu_rc = None
        rc_t = getattr(self, "_rc_pic_target", None)
        if rc_t is not None and dcs.pps.cu_qp_delta_enabled:
            from vtm_jax.encoder.rate_ctrl import CtuRateControl

            target, lam_pic, qp_pic = rc_t
            prev = getattr(self, "last_recon", None)
            weights, ppc = [], []
            cs_sz = cfg.ctu_size
            for cy in range(h_ctu):
                for cx in range(w_ctu):
                    y0, x0 = cy * cs_sz, cx * cs_sz
                    blk = self.src[0][y0 : y0 + cs_sz, x0 : x0 + cs_sz]
                    if prev is not None:
                        pb = prev[0][y0 : y0 + cs_sz, x0 : x0 + cs_sz]
                        weights.append(float(np.abs(
                            blk.astype(np.int64) - pb).mean()) + 0.1)
                    else:
                        weights.append(1.0)
                    ppc.append(blk.size)
            self._ctu_rc = CtuRateControl(target, weights, lam_pic,
                                          qp_pic, ppc)
        rep_ctx = CuCtx(self.frame_qp)  # slice-persistent QP chain
        for cy in range(h_ctu):
            for cx in range(w_ctu):
                if cx == 0:
                    dcs.motion_lut.clear()  # HMVP reset per CTU row
                ctu_rect = Rect(cx * cfg.ctu_size, cy * cfg.ctu_size,
                                cfg.ctu_size, cfg.ctu_size)
                est = BitEstimator(ctx_m.copy())
                self._enter_ctu_qp(ctu_rect)
                part = P.Partitioner(dcs)
                part.init_ctu(ctu_rect, D.CH_L)
                _, self._split_map = self._rd_node(part, est)
                if getattr(self, "_ctu_rc", None) is not None:
                    # estimator bits of the chosen tree feed the CTU model
                    self._ctu_rc.update(est.frac_bits / 32768.0)
                self.__dict__.setdefault("_ctu_split_maps", {})[
                    (ctu_rect.x, ctu_rect.y)] = self._split_map
                writer = SyntaxWriter(dcs, enc)
                wpart = P.Partitioner(dcs)
                wpart.init_ctu(ctu_rect, D.CH_L)
                self._replay_node(writer, wpart, rep_ctx)
                if cy == h_ctu - 1 and cx == w_ctu - 1:
                    enc.encode_bin_trm(1)
        enc.finish()
        slice_bw.write_byte_alignment()
        from vtm_jax.ops import deblock as DB

        shim = SimpleNamespace(planes=planes)
        if not sh.deblocking_disable:
            DB.deblock_picture(dcs, shim)
        entry_points = None
        if cfg.sao or cfg.wpp:
            slice_bw, entry_points = self._sao_and_rewrite(shim, slice_type)
        hdr = W.write_slice_header_head(cfg, poc, self.frame_qp,
                                        slice_type=slice_type, rpl0=rpl0,
                                        rpl1=rpl1, mvd_l1_zero=ph.mvd_l1_zero,
                                        sao=tuple(sh.sao_enabled),
                                        entry_points=entry_points,
                                        active=tuple(sh.num_ref_idx))
        rbsp = bytes(hdr.bytes) + slice_bw.data()
        nal = make_nal(nalio.NAL_TRAIL, rbsp)
        sei = b""
        if cfg.hash_sei:
            digest = pic_hash.pic_md5(planes, [cfg.bit_depth] * len(planes))
            sei = W.write_hash_sei(digest)
        self.last_recon = planes
        self._store_ref(poc)
        self._log_picture(poc, "B" if is_b else "P", self.frame_qp,
                          len(nal) * 8, planes)
        return nal + sei

    def _store_ref(self, poc: int):
        from types import SimpleNamespace

        from vtm_jax.decoder import motion as M

        d = self.dcs
        if not hasattr(d, "mf_inter"):
            M.init_motion_field(d)  # I picture: all-intra motion field
        motion = {
            "inter": d.mf_inter, "ibc": d.mf_ibc, "interdir": d.mf_interdir,
            "mv": d.mf_mv, "refidx": d.mf_refidx, "slice": d.mf_slice,
        }
        self.prev_pic = SimpleNamespace(
            poc=poc, planes=self.last_recon, slices=[d.sh], motion=motion
        )
        if not hasattr(self, "dpb"):
            self.dpb = {}
        self.dpb[poc] = self.prev_pic

    # ------------------------------------------------------------------
    def _rd_cu(self, a: Rect, part: P.Partitioner, est: BitEstimator,
               cand_modes: list | None = None) -> float:
        if self.dcs.sh.slice_type == SliceType.I:
            return super()._rd_cu(a, part, est, cand_modes=cand_modes)
        from vtm_jax.decoder import motion as M

        dcs = self.dcs
        snap0 = self._snapshot(a)
        best = None  # (cost, dist, cap, est_after)

        def consider(trial):
            nonlocal best
            est_c = est.copy()
            bits0 = est_c.frac_bits
            res = trial(est_c)
            if res is None:
                self._restore(a, snap0)
                return
            dist = res
            cost = dist + self.lam * ((est_c.frac_bits - bits0) / 32768.0)
            if best is None or cost < best[0]:
                cap = self._snapshot(a)
                cap["n_cus"] = snap0["n_cus"]
                cap["n_tus"] = snap0["n_tus"]
                cap["cus_tail"] = dcs.cus[snap0["n_cus"]:]
                cap["tus_tail"] = dcs.tus[snap0["n_tus"]:]
                best = (cost, dist, cap, est_c)
            self._restore(a, snap0)

        # merge candidates (derive once on a probe CU)
        probe = self._make_inter_cu(a, part)
        probe.idx = len(dcs.cus)
        mrg = M.get_inter_merge_candidates(dcs, probe, -1)
        seen = set()
        merge_list = []
        for i in range(mrg.num_valid):
            sig = (mrg.interdir[i], tuple(mrg.mv[i][0]), mrg.ref_idx[i][0])
            if sig in seen:
                continue
            seen.add(sig)
            merge_list.append(i)
        for idx in merge_list[:4]:
            consider(lambda e, idx=idx: self._try_merge(a, part, idx, True, e))
            consider(lambda e, idx=idx: self._try_merge(a, part, idx, False, e))
        # CIIP: regular-merge MC + planar intra blend (EncCu CIIP loop)
        if (self.sps.ciip and a.w < 128 and a.h < 128 and a.w * a.h >= 64
                and a.x1 <= dcs.pic_w and a.y1 <= dcs.pic_h):
            for idx in merge_list[:2]:
                consider(lambda e, idx=idx: self._try_ciip(a, part, idx, e))
        # Affine/subblock merge: inherited + constructed CPMV candidates
        # (EncCu::xCheckRDCostAffineMerge2Nx2N analogue; candidate list =
        # decoder's get_affine_merge_cand, skip + coded trials per index)
        if (self.dcs.ph.max_num_affine_merge_cand > 0
                and a.w >= 8 and a.h >= 8):
            n_aff = min(self.dcs.ph.max_num_affine_merge_cand, 3)
            for aidx in range(n_aff):
                consider(lambda e, i=aidx:
                         self._try_affine_merge(a, part, i, True, e))
                consider(lambda e, i=aidx:
                         self._try_affine_merge(a, part, i, False, e))
        # MMVD: SATD preselection over base x step x direction, then full RD
        # of the top candidates (EncCu xCheckRDCostMerge2Nx2N MMVD part)
        if self.sps.mmvd and mrg.num_valid > 0:
            for mi in self._preselect_mmvd(a, mrg):
                consider(lambda e, mi=mi: self._try_mmvd(a, part, mrg, mi, True, e))
                consider(lambda e, mi=mi: self._try_mmvd(a, part, mrg, mi, False, e))
        # GEO: SAD preselection over split x candidate pairs, then full RD
        # (EncCu::xCheckRDCostMergeGeo2Nx2N analogue)
        if (getattr(self.sps, "geo", False) and dcs.sh.is_b
                and self.sps.max_num_geo_cand > 1
                and 8 <= a.w <= 64 and 8 <= a.h <= 64
                and a.w < 8 * a.h and a.h < 8 * a.w):
            for split, g0, g1 in self._preselect_geo(a, part):
                consider(lambda e, s=split, g0=g0, g1=g1:
                         self._try_geo(a, part, s, g0, g1, False, e))
                consider(lambda e, s=split, g0=g0, g1=g1:
                         self._try_geo(a, part, s, g0, g1, True, e))
        # AMVP with motion estimation (per list and active L0 ref; bi for B)
        mv0, mvp_idx0 = self._motion_estimate(a, part, 0)
        consider(lambda e: self._try_amvp(a, part, 0, mv0, mvp_idx0, e))
        for ri in range(1, dcs.sh.num_ref_idx[0]):
            if dcs.sh.ref_pocs[0][ri] == dcs.sh.ref_pocs[0][0]:
                continue
            mvr, mvpr = self._motion_estimate(a, part, 0, ref_idx=ri)
            consider(lambda e, ri=ri, mvr=mvr, mvpr=mvpr:
                     self._try_amvp(a, part, 0, mvr, mvpr, e, ref_idx=ri))
        # AMVR (IMV) trials: full-pel / 4-pel signalling of the same ME
        # result (EncCu::xCheckRDCostInterIMV analogue)
        if self.sps.amvr:
            for imv in (1, 2):
                consider(lambda e, imv=imv: self._try_amvp_imv(
                    a, part, 0, mv0, mvp_idx0, imv, e))
        # Affine AMVP: gradient-LS CPMV estimation seeded from the
        # translational ME winner (InterSearch.cpp:4520
        # xPredAffineInterSearch + AffineGradientSearch.cpp objective,
        # solved as one closed-form whole-block step)
        if (self.sps.affine and getattr(self.cfg, "affine_amvp", False)
                and a.w > 8 and a.h > 8
                and a.x1 <= dcs.pic_w and a.y1 <= dcs.pic_h):
            for lt, rt, lb, atype in self._affine_estimate(a, mv0, 0, 0):
                consider(lambda e, lt=lt, rt=rt, lb=lb, t=atype:
                         self._try_affine_amvp(a, part, 0, lt, rt, lb, t, e))
        # SBT: half-TU residual trials on the best motion candidates,
        # pre-gated by residual-energy asymmetry at the ME winner
        # (EncCu.cpp:4210 SBT loop + its SBT energy early-out)
        if (self.sps.sbt and a.x1 <= dcs.pic_w and a.y1 <= dcs.pic_h
                and a.w <= (1 << self.sps.log2_max_tb_size)
                and a.h <= (1 << self.sps.log2_max_tb_size)):
            for si in self._sbt_pick(a, 0, 0, mv0):
                consider(lambda e, si=si: self._try_amvp(
                    a, part, 0, mv0, mvp_idx0, e, sbt_info=si))
                for idx in merge_list[:1]:
                    consider(lambda e, idx=idx, si=si: self._try_merge(
                        a, part, idx, False, e, sbt_info=si))
        if dcs.sh.is_b:
            mv1, mvp_idx1 = self._motion_estimate(a, part, 1)
            if dcs.sh.ref_pocs[1][0] != dcs.sh.ref_pocs[0][0]:
                consider(lambda e: self._try_amvp(a, part, 1, mv1, mvp_idx1, e))
            if a.w + a.h > 12:  # bi-pred restriction (PU::isBipredRestriction)
                consider(lambda e: self._try_bi(a, part, mv0, mvp_idx0,
                                                mv1, mvp_idx1, e))
                # BCW weight trials on the same bi MVs (EncCu BCW loop)
                if self.sps.bcw and a.w * a.h >= 256 and not dcs.sh.wp_present([0, 0]):
                    for bcw in (1, 3):
                        consider(lambda e, bcw=bcw: self._try_bi(
                            a, part, mv0, mvp_idx0, mv1, mvp_idx1, e, bcw=bcw))
        # intra fallback (top preselected modes)
        if a.x1 <= dcs.pic_w and a.y1 <= dcs.pic_h:
            src_y = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
            for mode in self._preselect_modes(a, src_y)[:2]:
                consider(lambda e, m=mode: self._encode_cu_with_mode(a, part, m, e))
        cost, dist, cap, est_c = best
        self._restore_region(a, cap)
        est.ctx = est_c.ctx
        est.frac_bits = est_c.frac_bits
        return dist

    def _make_inter_cu(self, a: Rect, part: P.Partitioner) -> CU:
        fmt = self.dcs.chroma_format
        ca = Rect(a.x >> fmt.scale_x, a.y >> fmt.scale_y,
                  a.w >> fmt.scale_x, a.h >> fmt.scale_y)
        cu = CU(ch_type=D.CH_L, tree_type=D.TREE_D, mode_type=D.MODE_TYPE_ALL,
                blocks=[Rect(a.x, a.y, a.w, a.h), ca, Rect(ca.x, ca.y, ca.w, ca.h)],
                chroma_format=fmt)
        cu.pred_mode = D.MODE_INTER
        cu.qp = getattr(self, "_ctu_qp", None) or self.frame_qp
        return cu

    # -- trials ---------------------------------------------------------
    def _sbt_pick(self, a: Rect, lst: int, ref_idx: int, mv) -> list:
        """SBT config preselection: residual energy of each zeroed half at
        the translational ME winner; only a strongly one-sided residual
        justifies the half-TU trial (cf. EncCu SBT fast decisions)."""
        from vtm_jax.ops import mc as MC

        dcs = self.dcs
        ref = dcs.sh.ref_pics[lst][ref_idx].planes[0]
        src = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
        pred = MC.mc_block(ref, a.x + (mv[0] >> 4), a.y + (mv[1] >> 4),
                           a.w, a.h, mv[0] & 15, mv[1] & 15, True,
                           self.cfg.bit_depth, True)
        e2 = (src - pred).astype(np.float64) ** 2
        total = float(e2.sum())
        if total <= 0:
            return []
        cfgs = []
        if a.w >= 8:
            e_l = float(e2[:, : a.w // 2].sum())
            cfgs.append((e_l, 1 | (1 << 4)))          # zero left  → pos 1
            cfgs.append((total - e_l, 1))             # zero right → pos 0
        if a.h >= 8:
            e_t = float(e2[: a.h // 2].sum())
            cfgs.append((e_t, 2 | (1 << 4)))          # zero top    → pos 1
            cfgs.append((total - e_t, 2))             # zero bottom → pos 0
        if not cfgs:
            return []
        zero_e, best = min(cfgs)
        return [best] if zero_e < 0.15 * total else []

    def _sbt_tus(self, cu, sbt_info: int) -> list:
        """SBT half-TU tiling (mirror of the decoder's _sbt_transform_tree /
        PartitionerImpl::getSbtTuTiling, UnitPartitioner.cpp:1091)."""
        sbt_idx = sbt_info & 0xF
        sbt_pos = (sbt_info >> 4) & 0x3
        tus = []
        for i in range(2):
            if sbt_idx == 2:  # HOR_HALF
                wf, xo, hf, yo = 4, 0, 2, (0 if i == 0 else 2)
            else:  # VER_HALF
                wf, xo, hf, yo = 2, (0 if i == 0 else 2), 4, 0
            blocks = []
            for b in cu.blocks:
                if b is None:
                    blocks.append(None)
                    continue
                blocks.append(Rect(b.x + ((b.w * xo) >> 2),
                                   b.y + ((b.h * yo) >> 2),
                                   (b.w * wf) >> 2, (b.h * hf) >> 2))
            tu = TU(blocks=blocks, cu=cu, depth=1)
            tu.no_residual = (sbt_pos == 0 and i == 1) or (sbt_pos == 1 and i == 0)
            tus.append(tu)
        return tus

    def _sbt_tr_types(self, cu, b):
        """SBT implicit luma transform pair (TrQuant::getTrTypes SBT branch,
        TrQuant.cpp:728) — must match the decoder's inv_transform."""
        if not self.sps.mts:
            return TX.DCT2, TX.DCT2
        sbt_idx = cu.sbt_info & 0xF
        sbt_pos = (cu.sbt_info >> 4) & 0x3
        if sbt_idx in (1, 3):  # VER_HALF / VER_QUAD
            if b.h > 32:
                return TX.DCT2, TX.DCT2
            return (TX.DCT8, TX.DST7) if sbt_pos == 0 else (TX.DST7, TX.DST7)
        if b.w > 32:
            return TX.DCT2, TX.DCT2
        return (TX.DST7, TX.DCT8) if sbt_pos == 0 else (TX.DST7, TX.DST7)

    def _commit_inter(self, cu, a, part, est, skip: bool, sbt_info: int = 0):
        """Common commit: derive span/HMVP, MC, residual, recon, bits."""
        from vtm_jax.decoder import inter_cu as IC
        from vtm_jax.decoder import motion as M

        dcs = self.dcs
        cu.qt_depth = part.cur_qt_depth
        cu.depth = part.cur_depth
        cu.split_series = tuple(lvl.split for lvl in part.stack[1:])
        dcs.add_cu(cu)
        if getattr(cu, "affine", False):
            # decoder-exact derivation: affine merge CPMVs / SbTMVP subPUs
            # + per-4x4 motion spans (inter_cu.derive_cu_mv)
            IC.derive_cu_mv(dcs, cu)
        elif getattr(cu, "geo_flag", False):
            M.span_geo_motion_info(dcs, cu, cu._geo_mrg)
        else:
            M.span_motion_info(dcs, cu)
        M.save_motion_hmvp(dcs, cu)
        if getattr(cu, "geo_flag", False):
            preds = IC._geo_motion_compensation(self.recon, dcs, cu)
        else:
            preds = IC.motion_compensation(self.recon, dcs, cu)
            if getattr(cu, "ciip_flag", False):
                preds = IC.ciip_blend(self.recon, dcs, cu, preds)
        fmt = dcs.chroma_format
        if sbt_info and not skip:
            cu.sbt_info = sbt_info
            tus = self._sbt_tus(cu, sbt_info)
        else:
            tus = [TU(blocks=[Rect(b.x, b.y, b.w, b.h) if b else None
                              for b in cu.blocks], cu=cu, depth=0)]
        for tu in tus:
            cu.tus.append(tu)
            dcs.add_tu(tu)
        maxv = (1 << self.cfg.bit_depth) - 1
        dist = 0.0
        cbfs = []
        for tu in tus:
            for comp in range(fmt.num_components):
                b = tu.blocks[comp]
                cb = cu.blocks[comp]
                src = self.src[comp][b.y : b.y1, b.x : b.x1].astype(np.int64)
                pred = preds[comp][b.y - cb.y : b.y1 - cb.y,
                                   b.x - cb.x : b.x1 - cb.x]
                if skip or getattr(tu, "no_residual", False):
                    lev = np.zeros((b.h, b.w), dtype=np.int32)
                else:
                    resi = src - pred
                    if sbt_info and comp == 0:
                        th, tv = self._sbt_tr_types(cu, b)
                        coeffs = TX.fwd_transform_2d_np(
                            resi.astype(np.int32), self.cfg.bit_depth, th, tv)
                    else:
                        coeffs = TX.fwd_transform_2d_np(
                            resi.astype(np.int32), self.cfg.bit_depth)
                    qp = self.recon._qp_for(tu, comp)
                    lev = _quantize_tu(coeffs, qp, self.cfg.bit_depth, self.lam,
                                       self.cfg.dep_quant, tu=tu, comp=comp,
                                       est=est, sps=self.sps)
                tu.coeffs[comp] = lev
                tu.cbf[comp] = int(np.any(lev))
                cbfs.append(tu.cbf[comp])
                if tu.cbf[comp]:
                    rec_resi = self.recon.inv_transform(tu, comp)
                else:
                    rec_resi = np.zeros_like(src)
                recon = np.clip(pred + rec_resi, 0, maxv).astype(np.int32)
                self.recon.planes[comp][b.y : b.y1, b.x : b.x1] = recon
                self.recon.set_decomp(comp, b)
                if comp == 0:
                    dcs.qp_map_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = cu.qp
                dist += float(np.sum((src - recon.astype(np.int64)) ** 2))
        cu.root_cbf = any(cbfs)
        self._qg_update(cu, bool(cu.root_cbf))
        writer = SyntaxWriter(dcs, est)
        writer.coding_unit(cu, part, CuCtx(self.frame_qp))
        return dist

    def _try_merge(self, a, part, idx: int, skip: bool, est, sbt_info: int = 0):
        from vtm_jax.decoder import motion as M

        dcs = self.dcs
        cu = self._make_inter_cu(a, part)
        cu.idx = len(dcs.cus)
        cu.merge_flag = True
        cu.skip = skip
        mrg = M.get_inter_merge_candidates(dcs, cu, idx)
        M.set_merge_info(dcs, cu, mrg, idx)
        if not skip:
            # coded merge: rootCbf inferred 1 → invalid if residual all-zero
            dist = self._commit_inter(cu, a, part, est, skip=False,
                                      sbt_info=sbt_info)
            if not cu.root_cbf or (
                not (cu.tus[0].cbf[1] or cu.tus[0].cbf[2]) and not cu.tus[0].cbf[0]
            ):
                return None
            if not cu.tus[0].cbf[0] and not (cu.tus[0].cbf[1] or cu.tus[0].cbf[2]):
                return None
            if not cu.root_cbf:
                return None
            return dist
        cu.root_cbf = False
        return self._commit_inter(cu, a, part, est, skip=True)

    def _try_affine_merge(self, a, part, idx: int, skip: bool, est):
        """Affine/SbTMVP subblock merge trial: candidate derivation, MC
        (4x4 CPMV interpolation + PROF / subPU TMVP) and motion span all
        go through the decoder-exact inter_cu.derive_cu_mv inside
        _commit_inter — the trial only sets the parsed-syntax fields."""
        dcs = self.dcs
        cu = self._make_inter_cu(a, part)
        cu.idx = len(dcs.cus)
        cu.merge_flag = True
        cu.skip = skip
        cu.affine = True
        cu.merge_idx = idx
        cu.regular_merge_flag = False
        cu.mvp_idx = [0, 0]
        cu.mvd = [(0, 0), (0, 0)]
        if not skip:
            dist = self._commit_inter(cu, a, part, est, skip=False)
            if not cu.root_cbf:
                return None  # non-skip merge needs residual (rootCbf = 1)
            return dist
        cu.root_cbf = False
        return self._commit_inter(cu, a, part, est, skip=True)

    def _try_ciip(self, a, part, idx: int, est):
        """CIIP merge trial (EncCu xCheckRDCostMerge2Nx2N CIIP part):
        regular merge MC blended with planar intra; root cbf inferred 1
        so an all-zero residual invalidates the candidate."""
        from vtm_jax.decoder import motion as M

        dcs = self.dcs
        cu = self._make_inter_cu(a, part)
        cu.idx = len(dcs.cus)
        cu.merge_flag = True
        cu.skip = False
        cu.ciip_flag = True
        cu.regular_merge_flag = False
        mrg = M.get_inter_merge_candidates(dcs, cu, idx)
        M.set_merge_info(dcs, cu, mrg, idx)
        dist = self._commit_inter(cu, a, part, est, skip=False)
        if not cu.root_cbf or not (
            cu.tus[0].cbf[0] or cu.tus[0].cbf[1] or cu.tus[0].cbf[2]
        ):
            return None
        return dist

    def _preselect_mmvd(self, a: Rect, mrg) -> list[int]:
        """Luma-SAD preselection of MMVD refine positions, computed through
        one batched MC kernel call (all candidates at once)."""
        from vtm_jax.decoder import motion as M
        from vtm_jax.ops import mc as MCops
        from vtm_jax.ops.mc_kernel import McBatch

        dcs = self.dcs
        n_base = 2 if mrg.num_valid >= 2 else 1
        cand = [b * 32 + s * 4 + d
                for b in range(n_base) for s in range(6) for d in range(4)]
        batch = McBatch(self.cfg.bit_depth)
        plans = []
        for mi in cand:
            probe = self._make_inter_cu(a, None)
            probe.idx = len(dcs.cus)
            probe.merge_flag = True
            probe.mmvd_flag = True
            probe.mmvd_idx = mi
            M.set_mmvd_merge_info(dcs, probe, mrg, mi)
            handles = []
            for lst in range(2):
                if not (probe.interdir & (1 << lst)):
                    continue
                mv = M.clip_mv_in_pic(probe.mv[lst], a.x, a.y, dcs)
                fx, fy = mv[0] & 15, mv[1] & 15
                ref = dcs.sh.ref_pics[lst][probe.ref_idx[lst]].planes[0]
                cfh = MCops.luma_coeffs(fx, a.w, a.h if fy == 0 else a.h + 7,
                                        False, True)
                cfv = MCops.luma_coeffs(fy, a.w, a.h, False, False)
                handles.append(batch.add_block(
                    ref, a.x + (mv[0] >> 4), a.y + (mv[1] >> 4), a.w, a.h,
                    cfh, cfv, fy != 0, probe.interdir != 3, True))
            plans.append((mi, probe.interdir, handles))
        batch.execute()
        src_y = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
        lam_me = np.sqrt(self.lam)
        scored = []
        for mi, idir, hs in plans:
            if idir == 3:
                pred = MCops.bi_average(batch.block_result(hs[0]),
                                        batch.block_result(hs[1]),
                                        self.cfg.bit_depth)
            else:
                pred = batch.block_result(hs[0])
            bits = (1 if n_base > 1 else 0) + 1 + ((mi % 32) // 4) + 2
            sad = float(np.abs(src_y - pred).sum())
            scored.append((sad + lam_me * bits, mi))
        scored.sort()
        return [mi for _, mi in scored[:2]]

    def _preselect_geo(self, a: Rect, part) -> list:
        """Masked-SAD preselection over split_dir x candidate pairs: one
        batched MC evaluates each geo candidate's uni prediction, then the
        per-split weighted SADs come from mask/abs-diff dot products
        (EncCu::xCheckRDCostMergeGeo2Nx2N SAD preselection analogue)."""
        from vtm_jax.decoder import motion as M
        from vtm_jax.ops import mc as MCops
        from vtm_jax.ops.mc_kernel import McBatch

        dcs = self.dcs
        probe = self._make_inter_cu(a, None)
        probe.idx = len(dcs.cus)
        geo = M.get_geo_merge_candidates(dcs, probe)
        ncand = min(geo.num_valid, self.sps.max_num_geo_cand)
        if ncand < 2:
            return []
        batch = McBatch(self.cfg.bit_depth)
        handles = []
        for c in range(ncand):
            lst = 0 if geo.interdir[c] == 1 else 1
            mv = M.clip_mv_in_pic(geo.mv[c][lst], a.x, a.y, dcs)
            ref = dcs.sh.ref_pics[lst][geo.ref_idx[c][lst]].planes[0]
            fx, fy = mv[0] & 15, mv[1] & 15
            cfh = MCops.luma_coeffs(fx, a.w, a.h if fy == 0 else a.h + 7,
                                    False, True)
            cfv = MCops.luma_coeffs(fy, a.w, a.h, False, False)
            handles.append(batch.add_block(
                ref, a.x + (mv[0] >> 4), a.y + (mv[1] >> 4), a.w, a.h,
                cfh, cfv, fy != 0, True, True))
        batch.execute()
        src_y = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
        ad = np.stack([np.abs(src_y - batch.block_result(h)).ravel()
                       for h in handles])                       # [C, HW]
        masks = np.stack([MCops.geo_weight_block(s, a.w, a.h, 0, 0, a.w, a.h)
                          .ravel() for s in range(64)])          # [64, HW] 0..8
        G = masks.astype(np.float64) @ ad.T.astype(np.float64)   # [64, C]
        S8 = 8.0 * ad.sum(axis=1)                                # [C]
        lam_me = np.sqrt(self.lam)
        best = []
        for s in range(64):
            for c0 in range(ncand):
                for c1 in range(ncand):
                    if c0 == c1:
                        continue
                    cost = G[s, c0] + (S8[c1] - G[s, c1])
                    cost += 8.0 * lam_me * (6 + c0 + c1)
                    best.append((cost, s, c0, c1))
        best.sort(key=lambda t: t[0])
        return [(s, c0, c1) for _, s, c0, c1 in best[:2]]

    def _try_geo(self, a, part, split, g0, g1, skip, est):
        from vtm_jax.decoder import motion as M

        dcs = self.dcs
        cu = self._make_inter_cu(a, part)
        cu.idx = len(dcs.cus)
        cu.merge_flag = True
        cu.skip = skip
        cu.regular_merge_flag = False
        cu.ciip_flag = False
        cu.geo_flag = True
        cu.geo_split_dir = split
        cu.geo_merge_idx = [g0, g1]
        cu._geo_mrg = M.get_geo_merge_candidates(dcs, cu)
        if not skip:
            dist = self._commit_inter(cu, a, part, est, skip=False)
            if not cu.root_cbf:
                return None
            return dist
        cu.root_cbf = False
        return self._commit_inter(cu, a, part, est, skip=True)

    def _try_mmvd(self, a, part, mrg, mmvd_idx, skip, est):
        from vtm_jax.decoder import motion as M

        dcs = self.dcs
        cu = self._make_inter_cu(a, part)
        cu.idx = len(dcs.cus)
        cu.merge_flag = True
        cu.skip = skip
        cu.regular_merge_flag = True
        cu.mmvd_flag = True
        cu.mmvd_skip = skip
        cu.mmvd_idx = mmvd_idx
        M.set_mmvd_merge_info(dcs, cu, mrg, mmvd_idx)
        if not skip:
            dist = self._commit_inter(cu, a, part, est, skip=False)
            if not cu.root_cbf:
                return None
            return dist
        cu.root_cbf = False
        return self._commit_inter(cu, a, part, est, skip=True)

    def _try_amvp(self, a, part, lst, mv, mvp_idx, est, ref_idx: int = 0,
                  sbt_info: int = 0):
        from vtm_jax.decoder import motion as M

        dcs = self.dcs
        cu = self._make_inter_cu(a, part)
        cu.idx = len(dcs.cus)
        cu.merge_flag = False
        cu.skip = False
        cu.interdir = 1 << lst
        cu.ref_idx = [-1, -1]
        cu.ref_idx[lst] = ref_idx
        cands = M.fill_mvp_cand(dcs, cu, lst, ref_idx)
        mvp = cands[mvp_idx]
        mvd = ((mv[0] - mvp[0]) >> 2, (mv[1] - mvp[1]) >> 2)
        cu.mvp_idx = [0, 0]
        cu.mvp_idx[lst] = mvp_idx
        cu.mvd = [(0, 0), (0, 0)]
        cu.mvd[lst] = mvd
        # reconstruct the decoder's view: mv = mvp + (mvd << 2)
        cu.mv = [(0, 0), (0, 0)]
        cu.mv[lst] = M.mv_clip_periodic(
            (mvp[0] + (mvd[0] << 2), mvp[1] + (mvd[1] << 2)))
        dist = self._commit_inter(cu, a, part, est, skip=False,
                                  sbt_info=sbt_info)
        if sbt_info and not cu.root_cbf:
            return None  # SBT needs residual; plain AMVP covers all-zero
        return dist

    def _try_amvp_imv(self, a, part, lst, mv, mvp_idx, imv, est):
        """AMVP with reduced MV resolution (imv 1 = full-pel, 2 = 4-pel):
        AMVP candidates and the coded mvd live at the reduced precision,
        reconstruction mirrors the decoder's imv scaling."""
        from vtm_jax.decoder import motion as M

        dcs = self.dcs
        cu = self._make_inter_cu(a, part)
        cu.idx = len(dcs.cus)
        cu.merge_flag = False
        cu.skip = False
        cu.interdir = 1 << lst
        cu.ref_idx = [0 if lst == 0 else -1, 0 if lst == 1 else -1]
        cu.imv = imv
        cands = M.fill_mvp_cand(dcs, cu, lst, 0)  # rounded per cu.imv
        mvp = cands[mvp_idx]
        mv_r = M.round_trans_prec_internal_2_amvr(mv, imv)
        shift = M._PREC_INTERNAL - M._AMVR_PREC[imv]
        mvd = ((mv_r[0] - mvp[0]) >> shift, (mv_r[1] - mvp[1]) >> shift)
        if mvd == (0, 0):
            return None  # zero mvd → imv not signalled (inferred 0)
        cu.mvp_idx = [0, 0]
        cu.mvp_idx[lst] = mvp_idx
        cu.mvd = [(0, 0), (0, 0)]
        cu.mvd[lst] = mvd
        mvd_int = M.change_trans_prec_amvr_2_internal(mvd, imv)
        cu.mv = [(0, 0), (0, 0)]
        cu.mv[lst] = M.mv_clip_periodic((mvp[0] + mvd_int[0],
                                         mvp[1] + mvd_int[1]))
        return self._commit_inter(cu, a, part, est, skip=False)

    def _affine_estimate(self, a: Rect, mv_trans, lst: int, ref_idx: int):
        """Gradient affine CPMV estimation (encoder-only policy).

        One batched Gauss-Newton step on whole-block tensors around the
        best translational MV: error-vs-gradient least squares for the
        4- and 6-parameter motion models.  Same objective as the
        reference's iterative scalar search (InterSearch.cpp:5340
        xAffineMotionEstimation, AffineGradientSearch.cpp), redesigned as
        one closed-form numpy solve per model.  Returns
        [(lt, rt, lb, affine_type), ...] with CPMVs at quarter-pel
        internal (1/16) precision."""
        from vtm_jax.ops import mc as MC

        dcs = self.dcs
        ref = dcs.sh.ref_pics[lst][ref_idx].planes[0]
        src = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.float64)
        ix, iy = mv_trans[0] >> 4, mv_trans[1] >> 4
        fx, fy = mv_trans[0] & 15, mv_trans[1] & 15
        pred = MC.mc_block(ref, a.x + ix, a.y + iy, a.w, a.h, fx, fy,
                           True, self.cfg.bit_depth, True).astype(np.float64)
        e = (src - pred).ravel()
        gy, gx = np.gradient(pred)
        xs = np.broadcast_to(np.arange(a.w, dtype=np.float64), (a.h, a.w))
        ys = np.broadcast_to(
            np.arange(a.h, dtype=np.float64)[:, None], (a.h, a.w))
        out = []
        for atype in ((0, 1) if self.sps.affine_type else (0,)):
            if atype == 0:
                cols = [gx, gy, gx * xs + gy * ys, gy * xs - gx * ys]
            else:
                cols = [gx, gy, gx * xs, gx * ys, gy * xs, gy * ys]
            A = np.stack([c.ravel() for c in cols], axis=1)
            ata = A.T @ A + np.eye(A.shape[1]) * 1e-3
            try:
                dp = np.linalg.solve(ata, A.T @ e)
            except np.linalg.LinAlgError:
                continue

            def dmv(px, py, dp=dp, atype=atype):
                if atype == 0:
                    return (dp[0] + dp[2] * px - dp[3] * py,
                            dp[1] + dp[3] * px + dp[2] * py)
                return (dp[0] + dp[2] * px + dp[3] * py,
                        dp[1] + dp[4] * px + dp[5] * py)

            cp = []
            for px, py in ((0.0, 0.0), (float(a.w), 0.0), (0.0, float(a.h))):
                dx, dy = dmv(px, py)
                # quarter-pel units, clamped to +-32 pel for stability
                qx = int(np.clip(round(dx * 4), -128, 128)) << 2
                qy = int(np.clip(round(dy * 4), -128, 128)) << 2
                cp.append((mv_trans[0] + qx, mv_trans[1] + qy))
            if cp[0] == cp[1] == cp[2]:
                continue  # degenerates to the translational candidate
            out.append((cp[0], cp[1], cp[2], atype))
        return out

    def _try_affine_amvp(self, a, part, lst, lt, rt, lb, atype, est,
                         ref_idx: int = 0):
        """Affine AMVP trial: CPMVs at quarter-pel, coded mvds follow the
        decoder's cumulative convention (mvd1/mvd2 relative to mvd0 —
        inter_cu.derive_cu_mv), so reconstruction is decoder-exact."""
        from vtm_jax.decoder import affine as AF

        dcs = self.dcs
        cu = self._make_inter_cu(a, part)
        cu.idx = len(dcs.cus)
        cu.merge_flag = False
        cu.skip = False
        cu.affine = True
        cu.affine_type = atype
        cu.imv = 0
        cu.interdir = 1 << lst
        cu.ref_idx = [-1, -1]
        cu.ref_idx[lst] = ref_idx
        cands = AF.fill_affine_mvp_cand(dcs, cu, lst, ref_idx)
        best = None
        for mi, cand in enumerate(cands[:2]):
            m0 = ((lt[0] - cand[0][0]) >> 2, (lt[1] - cand[0][1]) >> 2)
            m1 = (((rt[0] - cand[1][0]) >> 2) - m0[0],
                  ((rt[1] - cand[1][1]) >> 2) - m0[1])
            if atype == 1:
                m2 = (((lb[0] - cand[2][0]) >> 2) - m0[0],
                      ((lb[1] - cand[2][1]) >> 2) - m0[1])
            else:
                m2 = (0, 0)
            wgt = sum(abs(v) for v in (*m0, *m1, *m2))
            if best is None or wgt < best[0]:
                best = (wgt, mi, m0, m1, m2)
        _, mi, m0, m1, m2 = best
        cu.mvp_idx = [0, 0]
        cu.mvp_idx[lst] = mi
        cu.mvd = [(0, 0), (0, 0)]
        cu.mvd_affi = [[(0, 0)] * 3, [(0, 0)] * 3]
        cu.mvd_affi[lst] = [m0, m1, m2]
        return self._commit_inter(cu, a, part, est, skip=False)

    def _try_bi(self, a, part, mv0, mvp_idx0, mv1, mvp_idx1, est,
                bcw: int | None = None):
        from vtm_jax.decoder import motion as M

        dcs = self.dcs
        cu = self._make_inter_cu(a, part)
        cu.idx = len(dcs.cus)
        cu.merge_flag = False
        cu.skip = False
        cu.interdir = 3
        cu.ref_idx = [0, 0]
        if bcw is not None:
            cu.bcw_idx = bcw
        cu.mvp_idx = [mvp_idx0, mvp_idx1]
        cu.mvd = [(0, 0), (0, 0)]
        cu.mv = [(0, 0), (0, 0)]
        for lst, (mv, mi) in enumerate(((mv0, mvp_idx0), (mv1, mvp_idx1))):
            cands = M.fill_mvp_cand(dcs, cu, lst, 0)
            mvp = cands[mi]
            mvd = ((mv[0] - mvp[0]) >> 2, (mv[1] - mvp[1]) >> 2)
            cu.mvd[lst] = mvd
            cu.mv[lst] = M.mv_clip_periodic(
                (mvp[0] + (mvd[0] << 2), mvp[1] + (mvd[1] << 2)))
        return self._commit_inter(cu, a, part, est, skip=False)

    # -- motion estimation ---------------------------------------------
    def _motion_estimate(self, a: Rect, part, lst: int = 0, ref_idx: int = 0):
        """TZ-style integer search + SATD fractional refinement.

        InterSearch::xMotionEstimation (InterSearch.cpp:3299) redesign:
        MVP/zero starts, batched 8-point diamond rings at exponential
        distances (xTZ8PointDiamondSearch), a stride-5 raster stage when
        the best point is far from the start (xTZSearch raster), star
        refinement rings around the raster winner, then half->quarter-pel
        refinement over the full 8-neighbourhood costed with Hadamard
        SATD (xPatternSearchFracDIF / RdCost HAD)."""
        from vtm_jax.decoder import motion as M
        from vtm_jax.ops import mc as MC
        from vtm_jax.ops import rdcost as RC

        dcs = self.dcs
        ref = dcs.sh.ref_pics[lst][ref_idx].planes[0]
        src = self.src[0][a.y : a.y1, a.x : a.x1].astype(np.int64)
        probe = self._make_inter_cu(a, part)
        probe.idx = len(dcs.cus)
        probe.interdir = 1 << lst
        probe.ref_idx = [-1, -1]
        probe.ref_idx[lst] = ref_idx
        cands = M.fill_mvp_cand(dcs, probe, lst, ref_idx)
        lam_me = np.sqrt(self.lam)
        ph_, pw_ = ref.shape
        rng = self.me_range

        # row-subsampled SAD for blocks taller than 8 (DistParam subShift)
        sub = 2 if a.h > 8 else 1
        ys_base = np.arange(0, a.h, sub, dtype=np.int64)
        xs_base = np.arange(a.w, dtype=np.int64)
        src_sub = src[::sub]

        def sad_batch(pts):
            """SAD for a list of integer (ix, iy) positions, batched."""
            p = np.asarray(pts, dtype=np.int64)
            Y = np.clip(a.y + p[:, 1, None] + ys_base[None, :], 0, ph_ - 1)
            X = np.clip(a.x + p[:, 0, None] + xs_base[None, :], 0, pw_ - 1)
            wins = ref[Y[:, :, None], X[:, None, :]]
            return (np.abs(src_sub[None] - wins).sum(axis=(1, 2))
                    .astype(np.float64) * sub)

        def mvd_bits(ix, iy, mvp):
            dx = abs((ix << 4) - mvp[0]) >> 2
            dy = abs((iy << 4) - mvp[1]) >> 2
            return lam_me * (dx.bit_length() * 2 + dy.bit_length() * 2 + 2)

        # ---- start points: MVPs + zero ----
        starts = []
        for mvp_idx, mvp in enumerate(cands[:2]):
            starts.append((int(round(mvp[0] / 16.0)),
                           int(round(mvp[1] / 16.0)), mvp_idx))
        starts.append((0, 0, 0))
        scosts = sad_batch([(sx, sy) for sx, sy, _ in starts])
        best = None
        for (sx, sy, mi), c0 in zip(starts, scosts):
            c = c0 + mvd_bits(sx, sy, cands[mi])
            if best is None or c < best[0]:
                best = (c, sx, sy, mi)
        bcost, bx, by, bi = best
        mvp = cands[bi]
        sx0, sy0 = bx, by  # search centre for the raster decision

        def ring_sweep(cx, cy, dists):
            """Evaluate 8-point diamond rings at the given distances around
            (cx, cy); returns the best (cost, x, y) among them."""
            pts = []
            for d in dists:
                h = max(1, d >> 1)
                for dx, dy in ((0, -d), (0, d), (-d, 0), (d, 0),
                               (-h, -h), (h, -h), (-h, h), (h, h)):
                    nx, ny = cx + dx, cy + dy
                    if abs(nx) <= rng and abs(ny) <= rng:
                        pts.append((nx, ny))
            if not pts:
                return None
            cs = sad_batch(pts)
            out = None
            for (nx, ny), c0 in zip(pts, cs):
                c = c0 + mvd_bits(nx, ny, mvp)
                if out is None or c < out[0]:
                    out = (c, nx, ny)
            return out

        # ---- exponential diamond rings around the start ----
        r = ring_sweep(bx, by, [1, 2, 4, 8, 16, 32, 64])
        if r is not None and r[0] < bcost:
            bcost, bx, by = r
        # ---- raster stage when the winner is far from the start ----
        # (restricted to PUs >= 256 samples: small blocks rarely profit
        # and the batched full-window sweep is where the cost is)
        i_raster = 5
        if (a.w * a.h >= 256
                and max(abs(bx - sx0), abs(by - sy0)) > i_raster):
            pts = [(x, y)
                   for y in range(-rng, rng + 1, i_raster)
                   for x in range(-rng, rng + 1, i_raster)]
            cs = sad_batch(pts)
            for (nx, ny), c0 in zip(pts, cs):
                c = c0 + mvd_bits(nx, ny, mvp)
                if c < bcost:
                    bcost, bx, by = c, nx, ny
        # ---- star refinement: shrinking rings around the current best ----
        for _ in range(3):
            moved = False
            r = ring_sweep(bx, by, [1, 2, 4])
            if r is not None and r[0] < bcost:
                bcost, bx, by = r
                moved = True
            if not moved:
                break

        # ---- fractional: half then quarter pel, full 8-neighbourhood,
        #      Hadamard SATD cost (xPatternSearchFracDIF) ----
        def satd_frac(mv):
            fx, fy = mv[0] & 15, mv[1] & 15
            pred = MC.mc_block(ref, a.x + (mv[0] >> 4), a.y + (mv[1] >> 4),
                               a.w, a.h, fx, fy, True,
                               self.cfg.bit_depth, rnd_res=True)
            return float(RC.satd(src, pred)) + lam_me * (
                (abs(mv[0] - mvp[0]) >> 2).bit_length() * 2
                + (abs(mv[1] - mvp[1]) >> 2).bit_length() * 2 + 2)

        best_q = (bx << 4, by << 4)
        bqcost = satd_frac(best_q)
        for qstep in (8, 4):
            centre = best_q
            for dx in (-qstep, 0, qstep):
                for dy in (-qstep, 0, qstep):
                    if dx == 0 and dy == 0:
                        continue
                    mvq = (centre[0] + dx, centre[1] + dy)
                    if mvq[0] & 3 or mvq[1] & 3:
                        continue  # quarter-pel signalling granularity
                    c = satd_frac(mvq)
                    if c < bqcost:
                        bqcost = c
                        best_q = mvq
        return best_q, bi


class LowDelayBEncoder(InterEncoder):
    """IDR + low-delay B pictures (both lists = previous picture),
    mirroring encoder_lowdelay_vtm.cfg's GOP-1 shape. With
    cfg.target_bitrate set, per-picture QP comes from the λ-domain rate
    control (rate_ctrl.RateControl)."""

    def encode(self, frames):
        cfg = self.cfg
        if cfg.mctf and len(frames) > 1:
            from vtm_jax.encoder.mctf import mctf_filter

            frames = mctf_filter(frames, cfg.qp, cfg.bit_depth)
        rc = None
        if cfg.target_bitrate:
            from vtm_jax.encoder.rate_ctrl import RateControl

            rc = RateControl(cfg.target_bitrate, cfg.frame_rate,
                             cfg.width, cfg.height)
        self.rc_qps = []
        out = bytearray()
        out += self.sps_nal
        out += self.pps_nal
        for poc, planes in enumerate(frames):
            is_i = poc == 0
            if rc:
                lam, qp = rc.picture_lambda_qp(is_intra=is_i)
            else:
                qp = cfg.qp if is_i else cfg.qp + getattr(cfg, "b_qp_offset", 5)
            self.rc_qps.append(qp)
            self._rc_pic_target = (
                (rc.picture_target(), lam, qp)
                if (rc and getattr(cfg, "ctu_rc", False) and not is_i)
                else None)
            if is_i:
                saved = cfg.qp
                cfg.qp = qp
                nal = self.encode_frame(planes, 0, is_p=False)
                cfg.qp = saved
            else:
                nal = self.encode_inter_frame(planes, poc, SliceType.B,
                                              [1], [1], qp)
            out += nal
            if rc:
                rc.update_after_picture(len(nal) * 8, lam, is_intra=is_i)
        return bytes(out)


class RandomAccessEncoder(InterEncoder):
    """IDR + hierarchical-B GOPs (encoder_randomaccess_vtm.cfg shape):
    key picture per GOP referencing the previous key, then dyadic bisection
    B pictures referencing the nearest decoded past/future pictures.

    Full RPLs carry every still-needed DPB picture (inactive entries) so
    RPL-based reference marking (Slice.cpp applyReferencePictureListBased-
    Marking) keeps the pyramid alive; active count stays 1 per list."""

    # GOPEntry-style hierarchy table: per temporal layer (QPOffset,
    # QPOffsetModelOffset, QPOffsetModelScale), the X0038 / JCTVC-X0038
    # model of cfg/encoder_randomaccess_vtm.cfg:19-40
    _LAYER_QP_MODEL = [
        (1, 0.0, 0.0),
        (1, -4.8848, 0.2061),
        (4, -5.7476, 0.2286),
        (5, -5.90, 0.2333),
        (6, -7.1444, 0.3),
    ]
    INTRA_QP_OFFSET = -3  # IntraQPOffset (CTC RA)

    # NOTE: RA force-enables mmvd/amvr/geo (CTC defaults) and mutates the
    # caller's cfg object; pass raise_tool_defaults=False to keep the
    # caller's explicit tool choices.
    def __init__(self, cfg, gop_size: int = 16,
                 raise_tool_defaults: bool = True):
        if raise_tool_defaults:
            cfg.mmvd = True  # MMVD merge search on by default for RA
            cfg.amvr = True  # IMV (full/4-pel) trials on by default for RA
            cfg.geo = True  # geometric-partition merge on for RA (CTC)
            cfg.ciip = True  # combined inter/intra merge on for RA (CTC)
            cfg.affine = True  # affine merge candidates on for RA (CTC)
            cfg.num_active_refs = max(cfg.num_active_refs, 2)  # multi-ref ME
        super().__init__(cfg)
        self.gop_size = gop_size

    def _qp_for_layer(self, tid: int) -> int:
        """EncCfg::getQPForPicture (EncLib.cpp:2195): per-GOP-entry QP
        offset plus the QP-dependent offset model."""
        off, m_off, m_scale = self._LAYER_QP_MODEL[min(tid, 4)]
        qp = self.cfg.qp + off
        dqp = qp * m_scale + m_off + 0.5
        qp += int(np.floor(min(3.0, max(0.0, dqp))))
        return qp

    def _plan(self, n: int):
        """Decode-order plan: (poc, past_ref, future_ref|None, temporal_id)."""
        plan = []

        def bisect(lo, hi, level):
            if hi - lo < 2:
                return
            mid = (lo + hi + 1) // 2
            plan.append((mid, lo, hi, 1 + level))
            bisect(lo, mid, level + 1)
            bisect(mid, hi, level + 1)

        lo = 0
        while lo < n - 1:
            hi = min(lo + self.gop_size, n - 1)
            plan.append((hi, lo, None, 0))
            bisect(lo, hi, 0)
            lo = hi
        return plan

    def encode(self, frames):
        out = bytearray()
        out += self.sps_nal
        out += self.pps_nal
        n = len(frames)
        # I picture: IntraQPOffset (EncCfg getIntraQPOffset, CTC -3)
        saved_qp = self.cfg.qp
        self.cfg.qp = saved_qp + self.INTRA_QP_OFFSET
        out += self.encode_frame(frames[0], 0, is_p=False)
        self.cfg.qp = saved_qp
        plan = self._plan(n)
        decoded = {0}
        for i, (poc, past, fut, tid) in enumerate(plan):
            # keep-alive set: refs needed by this and all later pictures
            keep = set()
            for poc2, p2, f2, _ in plan[i + 1:]:
                for r in (p2, f2):
                    if r is not None and r in decoded:
                        keep.add(r)
            own = [past] + ([fut] if fut is not None else [])
            keep -= set(own + [poc])
            rpl0 = [poc - past] + sorted(poc - k for k in keep)
            active1 = fut if fut is not None else past
            rpl1 = [poc - active1] + sorted(
                poc - k for k in keep if k != active1)
            # dedup: rpl1 tail may repeat rpl0's entries — fine (separate lists)
            out += self.encode_inter_frame(
                frames[poc], poc, SliceType.B, rpl0, rpl1,
                self._qp_for_layer(tid))
            decoded.add(poc)
        return bytes(out)
