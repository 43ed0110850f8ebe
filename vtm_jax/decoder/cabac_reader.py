"""CTU-level CABAC syntax parsing (intra toolset).

Behavioral equivalent of DecoderLib/CABACReader.cpp: coding_tree_unit:136,
sao:314, coding_tree:465, split_cu_mode:727, coding_unit:812, pred_mode:1043,
bdpcm_mode:1132, intra_luma_pred_modes:1325, intra_chroma_pred_modes:1423,
cu_residual:1500, transform_tree:2514, transform_unit:2683, cu_qp_delta:2810,
residual_coding:2878, last_sig_coeff:3110, residual_coding_subblock:3190,
mip_flag:3622 — plus the context derivations from ContextModelling.{h,cpp}
(CoeffCodingContext, CtxSplit, CtxModeConsFlag, CtxMipFlag) and the MPM /
chroma-candidate derivations from UnitTools.cpp (PU::getIntraMPMs:~500,
getIntraChromaCandModes:643).

Covers the full intra + inter CTU syntax (merge/MMVD/affine/GEO/CIIP/SMVD,
AMVR, BCW, SBT, IBC, PLT, ACT) as exercised by the golden-stream suite.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from vtm_jax.common import rom
from vtm_jax.common.types import SliceType
from vtm_jax.decoder import cs as D
from vtm_jax.decoder import partitioner as P
from vtm_jax.decoder import motion as M
from vtm_jax.decoder.cabac import CabacDecoder
from vtm_jax.decoder.cs import (
    CH_C,
    CH_L,
    CU,
    DC_IDX,
    DM_CHROMA_IDX,
    HOR_IDX,
    LM_CHROMA_IDX,
    MDLM_L_IDX,
    MDLM_T_IDX,
    MODE_INTER,
    MODE_INTRA,
    MODE_TYPE_ALL,
    MODE_TYPE_INTER,
    MODE_TYPE_INTRA,
    MTS_DCT2_DCT2,
    MTS_DST7_DST7,
    MTS_SKIP,
    NUM_LUMA_MODE,
    PLANAR_IDX,
    Rect,
    TREE_C,
    TREE_D,
    TREE_L,
    TU,
    VDIA_IDX,
    VER_IDX,
)

_CTXOFF = rom.ctx_offsets()
NUM_MPM = 6
CU_DQP_TU_CMAX = 5
CU_DQP_EG_K = 0
JVET_C0024_ZERO_OUT_TH = 32
COEF_REMAIN_BIN_REDUCTION = 5
SBH_THRESHOLD = 4
MAX_CTX_BIN_RATIO_LUMA = 28
MAX_CTX_BIN_RATIO_CHROMA = 28
LFNST_LAST_SIG_LUMA = 1
LFNST_LAST_SIG_CHROMA = 1
NUM_ALF_FIXED_FILTER_SETS = 16


def ctx(name: str, i: int = 0) -> int:
    off, size = _CTXOFF[name]
    assert i < size, (name, i, size)
    return off + i


# palette run contexts (Rom.cpp:698-699) and traverse scan
_PLT_RUN_TOP_LUT = [0, 1, 1, 2, 2]
_PLT_RUN_LEFT_LUT = [0, 1, 2, 3, 4]


def _traverse_scan(w: int, h: int, rotation: bool):
    """g_scanOrder[SCAN_UNGROUPED][SCAN_TRAV_HOR/VER] snake scan
    (Rom.cpp ScanGenerator)."""
    pos = []
    if not rotation:
        for y in range(h):
            xs = range(w) if (y & 1) == 0 else range(w - 1, -1, -1)
            pos.extend((x, y) for x in xs)
    else:
        for x in range(w):
            ys = range(h) if (x & 1) == 0 else range(h - 1, -1, -1)
            pos.extend((x, y) for y in ys)
    return pos


_GROUP_IDX = rom.group_idx()
_MIN_IN_GROUP = rom.min_in_group()
_GO_RICE_PARS = rom.go_rice_pars_coeff()


@functools.lru_cache(maxsize=None)
def _rc_static(w: int, h: int, ch: int):
    """Shape-dependent CoeffCtx constants for the native residual decoder
    (mirrors CoeffCtx.__init__ / ContextModelling.h:51)."""
    log2w = w.bit_length() - 1
    log2h = h.bit_length() - 1
    lcw, lch = rom.log2_sbb_size(log2w, log2h)
    wig = min(JVET_C0024_ZERO_OUT_TH, w) >> lcw
    hig = min(JVET_C0024_ZERO_OUT_TH, h) >> lch
    scan = np.ascontiguousarray(rom.scan(1, w, h), dtype=np.int32)
    scan_cg = np.ascontiguousarray(rom.scan(0, wig, hig), dtype=np.int32)
    max_last_x = int(_GROUP_IDX[min(JVET_C0024_ZERO_OUT_TH, w) - 1])
    max_last_y = int(_GROUP_IDX[min(JVET_C0024_ZERO_OUT_TH, h) - 1])
    if ch == 1:
        lox = loy = 0
        lsx = min(max(0, w >> 3), 2)
        lsy = min(max(0, h >> 3), 2)
    else:
        prefix_ctx = (0, 0, 0, 3, 6, 10, 15, 21)
        lox = prefix_ctx[log2w]
        loy = prefix_ctx[log2h]
        lsx = (log2w + 1) >> 2
        lsy = (log2h + 1) >> 2
    return (
        scan, scan_cg, lcw, lch, max_last_x, max_last_y, lox, loy, lsx, lsy,
        _CTXOFF[f"LastX_{ch}"][0], _CTXOFF[f"LastY_{ch}"][0],
        _CTXOFF[f"SigFlag_{ch}"][0], _CTXOFF[f"SigFlag_{ch + 2}"][0],
        _CTXOFF[f"SigFlag_{ch + 4}"][0], _CTXOFF[f"ParFlag_{ch}"][0],
        _CTXOFF[f"GtxFlag_{ch}"][0], _CTXOFF[f"GtxFlag_{ch + 2}"][0],
        _CTXOFF[f"SigCoeffGroup_{ch}"][0],
    )


_TS_BASES = (
    _CTXOFF["TsSigCoeffGroup"][0],
    _CTXOFF["TsSigFlag"][0],
    _CTXOFF["TsResidualSign"][0],
    _CTXOFF["TsLrg1Flag"][0],
    _CTXOFF["TsParFlag"][0],
    _CTXOFF["TsGtxFlag"][0],
)


@dataclass
class CuCtx:
    qp: int
    qg_start: bool = False
    is_dqp_coded: bool = False
    is_chroma_qp_adj_coded: bool = False
    violates_lfnst: list[bool] = field(default_factory=lambda: [False, False])
    lfnst_last_scan_pos: bool = False
    violates_mts: bool = False
    mts_last_scan_pos: bool = False


@dataclass
class SaoParams:
    mode: list[int] = field(default_factory=lambda: [0, 0, 0])  # 0=off,1=new,2=merge
    type_idc: list[int] = field(default_factory=lambda: [0, 0, 0])
    type_aux: list[int] = field(default_factory=lambda: [0, 0, 0])
    offsets: list[list[int]] = field(default_factory=lambda: [[0] * 32 for _ in range(3)])


class SyntaxReader:
    """Parses one slice's CTU stream into the decode coding structure."""

    def __init__(self, dcs: D.DecCodingStructure, dec: CabacDecoder):
        self.cs = dcs
        self.d = dec
        self.sps = dcs.sps
        self.pps = dcs.pps
        self.ph = dcs.ph
        self.sh = dcs.sh
        self.chroma_adj = 0
        # native residual decoding when the C engine is active (tracing and
        # bit-statistics runs use the Python engine, which lacks rc_block)
        self._rc_native = hasattr(dec, "rc_block")
        # per-picture side data expected on the picture object
        self.is_dual_itree = (
            self.sh.slice_type == SliceType.I and self.sps.dual_i_tree
        )

    # ==================================================================
    # CTU level
    # ==================================================================

    def coding_tree_unit(self, ctu: Rect, qps: list[int], ctu_rs_addr: int, pic):
        self.sao(ctu_rs_addr, ctu, pic)
        if self.sps.alf and self.sh.alf_enabled[0]:
            self._alf_ctb(ctu, ctu_rs_addr, pic)
        if self.sps.ccalf:
            for comp in (1, 2):
                enabled = self.sh.ccalf_cb_enabled if comp == 1 else self.sh.ccalf_cr_enabled
                if enabled:
                    self._ccalf_filter_control_idc(comp, ctu_rs_addr, ctu, pic)
        part = P.Partitioner(self.cs)
        part.init_ctu(ctu, CH_L)
        cu_ctx = CuCtx(qps[0])
        if self.is_dual_itree and self.sps.chroma_format_idc != 0 and self.sps.ctu_size > 64:
            part_c = P.Partitioner(self.cs)
            part_c.init_ctu(ctu, CH_C)
            cu_ctx_c = CuCtx(qps[1])
            self.coding_tree(part, cu_ctx, part_c, cu_ctx_c)
            qps[0] = cu_ctx.qp
            qps[1] = cu_ctx_c.qp
        else:
            self.coding_tree(part, cu_ctx)
            qps[0] = cu_ctx.qp
            if self.is_dual_itree and self.sps.chroma_format_idc != 0:
                cu_ctx_c = CuCtx(qps[1])
                part.init_ctu(ctu, CH_C)
                self.coding_tree(part, cu_ctx_c)
                qps[1] = cu_ctx_c.qp

    # -- SAO / ALF CTB ------------------------------------------------------

    def sao(self, ctu_rs_addr: int, ctu: Rect, pic):
        if not self.sps.sao:
            return
        sh = self.sh
        luma_on = sh.sao_enabled[0]
        chroma_on = sh.sao_enabled[1] and self.sps.chroma_format_idc != 0
        params = pic.sao_params[ctu_rs_addr]
        if not luma_on and not chroma_on:
            return
        merge_type = -1
        if self.cs.get_cu_restricted(ctu.x - self.sps.ctu_size, ctu.y, ctu.x, ctu.y, CH_L):
            merge_type += self.d.decode_bin(ctx("SaoMergeFlag"))
        if merge_type < 0 and self.cs.get_cu_restricted(
            ctu.x, ctu.y - self.sps.ctu_size, ctu.x, ctu.y, CH_L
        ):
            merge_type += self.d.decode_bin(ctx("SaoMergeFlag")) << 1
        if merge_type >= 0:
            if luma_on or chroma_on:
                params.mode[0] = 2
                params.type_idc[0] = merge_type
            if chroma_on:
                params.mode[1] = params.mode[2] = 2
                params.type_idc[1] = params.type_idc[2] = merge_type
            return
        first = 0 if luma_on else 1
        last = 2 if chroma_on else 0
        max_offset = min(
            (1 << (min(self.sps.bit_depth, 10) - 5)) - 1, 31
        )  # getMaxOffsetQVal = (1<<(min(bd,10)-5))-1
        for comp in range(first, last + 1):
            if comp != 2:
                if self.d.decode_bin(ctx("SaoTypeIdx")):
                    if self.d.decode_bin_ep():
                        params.mode[comp] = 1
                        params.type_idc[comp] = 0  # EO start
                    else:
                        params.mode[comp] = 1
                        params.type_idc[comp] = 4  # BO start (SAO_TYPE_START_BO)
                else:
                    params.mode[comp] = 0
            else:
                params.mode[comp] = params.mode[1]
                params.type_idc[comp] = params.type_idc[1]
            if params.mode[comp] == 0:
                continue
            offset = [self._unary_max_eqprob(max_offset) for _ in range(4)]
            if params.type_idc[comp] == 4:  # band offset
                for k in range(4):
                    if offset[k] and self.d.decode_bin_ep():
                        offset[k] = -offset[k]
                params.type_aux[comp] = self.d.decode_bins_ep(5)
                for k in range(4):
                    params.offsets[comp][(params.type_aux[comp] + k) % 32] = offset[k]
                continue
            params.type_aux[comp] = 0
            if comp != 2:
                params.type_idc[comp] += self.d.decode_bins_ep(2)
            else:
                params.type_idc[comp] = params.type_idc[1]
            # EO classes: full valley, half valley, plain, half peak, full peak
            params.offsets[comp][0] = offset[0]
            params.offsets[comp][1] = offset[1]
            params.offsets[comp][2] = 0
            params.offsets[comp][3] = -offset[2]
            params.offsets[comp][4] = -offset[3]

    def _alf_ctb(self, ctu: Rect, ctu_rs_addr: int, pic):
        w_ctu = self.cs.pic_w_ctu
        left = self.cs.get_cu_restricted(ctu.x - self.sps.ctu_size, ctu.y, ctu.x, ctu.y, CH_L)
        above = self.cs.get_cu_restricted(ctu.x, ctu.y - self.sps.ctu_size, ctu.x, ctu.y, CH_L)
        left_addr = ctu_rs_addr - 1 if left else -1
        above_addr = ctu_rs_addr - w_ctu if above else -1
        for comp in range(3):
            if self.sh.alf_enabled[comp]:
                flags = pic.alf_ctb_flag[comp]
                c = 0
                c += 1 if (left_addr > -1 and flags[left_addr]) else 0
                c += 1 if (above_addr > -1 and flags[above_addr]) else 0
                flags[ctu_rs_addr] = self.d.decode_bin(ctx("ctbAlfFlag", comp * 3 + c))
                if comp == 0 and flags[ctu_rs_addr]:
                    self._alf_ctb_filter_index(ctu_rs_addr, pic)
                if comp > 0:
                    aps = self.cs.aps_map[(0, self.sh.alf_aps_id_chroma)]
                    num_alts = aps.alf.num_alternatives_chroma
                    pic.alf_ctb_alt[comp][ctu_rs_addr] = 0
                    if flags[ctu_rs_addr]:
                        decoded = 0
                        while decoded < num_alts - 1 and self.d.decode_bin(
                            ctx("ctbAlfAlternative", comp - 1)
                        ):
                            decoded += 1
                        pic.alf_ctb_alt[comp][ctu_rs_addr] = decoded

    def _alf_ctb_filter_index(self, ctu_rs_addr: int, pic):
        num_aps = self.sh.num_alf_aps
        num_avail = num_aps + NUM_ALF_FIXED_FILTER_SETS
        filt_index = 0
        if num_avail > NUM_ALF_FIXED_FILTER_SETS:
            use_prev = self.d.decode_bin(ctx("AlfUseTemporalFilt"))
            if use_prev:
                if num_aps > 1:
                    filt_index = self._trunc_bin(num_avail - NUM_ALF_FIXED_FILTER_SETS)
                filt_index += NUM_ALF_FIXED_FILTER_SETS
            else:
                filt_index = self._trunc_bin(NUM_ALF_FIXED_FILTER_SETS)
        else:
            filt_index = self._trunc_bin(NUM_ALF_FIXED_FILTER_SETS)
        pic.alf_ctb_filter_index[ctu_rs_addr] = filt_index

    def _ccalf_filter_control_idc(self, comp: int, ctu_rs_addr: int, ctu: Rect, pic):
        filter_controls = pic.ccalf_control[comp - 1]
        left = self.cs.get_cu_restricted(ctu.x - self.sps.ctu_size, ctu.y, ctu.x, ctu.y, CH_L)
        above = self.cs.get_cu_restricted(ctu.x, ctu.y - self.sps.ctu_size, ctu.x, ctu.y, CH_L)
        c = 0
        if left:
            c += 1 if filter_controls[ctu_rs_addr - 1] else 0
        if above:
            c += 1 if filter_controls[ctu_rs_addr - self.cs.pic_w_ctu] else 0
        c += 3 if comp == 2 else 0
        filter_count = (
            self.cs.aps_map[(0, self.sh.ccalf_cb_aps_id)].alf.ccalf_filter_count[0]
            if comp == 1
            else self.cs.aps_map[(0, self.sh.ccalf_cr_aps_id)].alf.ccalf_filter_count[1]
        )
        idc = self.d.decode_bin(ctx("CcAlfFilterControlFlag", c))
        if idc:
            while idc != filter_count and self.d.decode_bin_ep():
                idc += 1
        filter_controls[ctu_rs_addr] = idc

    # ==================================================================
    # coding tree
    # ==================================================================

    def coding_tree(self, part: P.Partitioner, cu_ctx: CuCtx,
                    part_c: P.Partitioner | None = None, cu_ctx_c: CuCtx | None = None):
        pps = self.pps
        if pps.cu_qp_delta_enabled and part.cur_qg_enable() and part.ch_type != CH_C:
            cu_ctx.qg_start = True
            cu_ctx.is_dqp_coded = False
        if self.sh.use_chroma_qp_adj and part.cur_qg_chroma_enable():
            cu_ctx.is_chroma_qp_adj_coded = False
            self.chroma_adj = 0
        if self.is_dual_itree and part_c is not None:
            if pps.cu_qp_delta_enabled and part_c.cur_qg_enable():
                cu_ctx_c.qg_start = True
                cu_ctx_c.is_dqp_coded = False
            if self.sh.use_chroma_qp_adj and part_c.cur_qg_chroma_enable():
                cu_ctx_c.is_chroma_qp_adj_coded = False
                self.chroma_adj = 0
        split_mode = self.split_cu_mode(part)
        if split_mode != P.CU_DONT_SPLIT:
            if part_c is not None and (
                part.cur_area().w >= 64 or part.cur_area().h >= 64
            ):
                part.split_cur_area(P.CU_QUAD_SPLIT)
                part_c.split_cur_area(P.CU_QUAD_SPLIT)
                cont = True
                while cont:
                    sub = part.cur_area()
                    if sub.w > 64 or sub.h > 64:
                        if self._area_in_pic(part):
                            self.coding_tree(part, cu_ctx, part_c, cu_ctx_c)
                        lc = part.next_part()
                        cc = part_c.next_part()
                        cont = lc
                    else:
                        if self._area_in_pic(part):
                            self.coding_tree(part, cu_ctx)
                        lc = part.next_part()
                        if self._area_in_pic(part_c):
                            self.coding_tree(part_c, cu_ctx_c)
                        cc = part_c.next_part()
                        cont = lc
                part.exit_cur_split()
                part_c.exit_cur_split()
            else:
                mode_type_parent = part.mode_type
                new_mode_type = self.mode_constraint(part, split_mode)
                part.mode_type = new_mode_type
                chroma_not_split = (
                    mode_type_parent == MODE_TYPE_ALL and new_mode_type == MODE_TYPE_INTRA
                )
                if part.tree_type == TREE_D:
                    part.tree_type = TREE_L if chroma_not_split else TREE_D
                part.split_cur_area(split_mode)
                while True:
                    if self._area_in_pic(part):
                        self.coding_tree(part, cu_ctx)
                    if not part.next_part():
                        break
                part.exit_cur_split()
                if chroma_not_split:
                    part.ch_type = CH_C
                    part.tree_type = TREE_C
                    if self._area_in_pic(part):
                        self.coding_tree(part, cu_ctx)
                    part.ch_type = CH_L
                    part.tree_type = TREE_D
                part.mode_type = mode_type_parent
            return
        # leaf: create CU
        cu = self._make_cu(part)
        if cu_ctx.qg_start:
            cu_ctx.qg_start = False
            cu_ctx.qp = self._predict_qp(cu, cu_ctx.qp)
        luma_qp_backup = -1
        if self.pps.cu_qp_delta_enabled and part.tree_type != TREE_D and cu.ch_type == CH_C:
            cb = cu.blocks[1]
            cx = (cb.x + (cb.w >> 1)) << self.cs.chroma_format.scale_x
            cy = (cb.y + (cb.h >> 1)) << self.cs.chroma_format.scale_y
            col = self.cs.get_cu(cx, cy, CH_L)
            luma_qp_backup = cu_ctx.qp
            if col is not None:
                cu_ctx.qp = col.qp
        cu.qp = cu_ctx.qp
        cu.chroma_qp_adj = self.chroma_adj
        self.coding_unit(cu, part, cu_ctx)
        # palette predictor update (CABACReader.cpp:661-695)
        if cu.pred_mode == D.MODE_PLT:
            local_sep = cu.tree_type != D.TREE_D and not cu.sep_tree
            if cu.is_sep_tree:
                if local_sep:
                    comp_begin = 0
                    num_comp = 3 if self.sps.chroma_format_idc != 0 else 1
                    joint = True
                elif part.ch_type == CH_L:
                    comp_begin, num_comp, joint = 0, 1, False
                else:
                    comp_begin, num_comp, joint = 1, 2, False
            else:
                comp_begin = 0
                num_comp = 3 if self.sps.chroma_format_idc != 0 else 1
                joint = True
            self.cs.reorder_prev_plt(cu, comp_begin, num_comp, joint)
        if self.pps.cu_qp_delta_enabled and part.tree_type != TREE_D and cu.ch_type == CH_C:
            cu_ctx.qp = luma_qp_backup

    def _area_in_pic(self, part: P.Partitioner) -> bool:
        b = part.cur_block()
        if part.ch_type == CH_C:
            return (
                b.x < (self.cs.pic_w >> self.cs.chroma_format.scale_x)
                and b.y < (self.cs.pic_h >> self.cs.chroma_format.scale_y)
            )
        return b.x < self.cs.pic_w and b.y < self.cs.pic_h

    def _make_cu(self, part: P.Partitioner) -> CU:
        luma = part.cur_area()
        croma = part.cur_chroma()
        fmt = self.cs.chroma_format
        tree = part.tree_type
        # effective channel restriction (CS::getArea): dual-I-tree slices
        # restrict every CU to its parse channel.
        luma_only = tree == TREE_L or self.sps.chroma_format_idc == 0 or (
            self.is_dual_itree and part.ch_type == CH_L
        )
        chroma_only = tree == TREE_C or (self.is_dual_itree and part.ch_type == CH_C)
        if chroma_only:
            blocks = [None, Rect(croma.x, croma.y, croma.w, croma.h),
                      Rect(croma.x, croma.y, croma.w, croma.h)]
        elif luma_only:
            blocks = [Rect(luma.x, luma.y, luma.w, luma.h), None, None]
        else:
            blocks = [Rect(luma.x, luma.y, luma.w, luma.h),
                      Rect(croma.x, croma.y, croma.w, croma.h),
                      Rect(croma.x, croma.y, croma.w, croma.h)]
        cu = CU(
            ch_type=part.ch_type,
            tree_type=tree,
            mode_type=part.mode_type,
            blocks=blocks,
            chroma_format=fmt,
            sep_tree=self.is_dual_itree or tree != TREE_D,
        )
        cu.qt_depth = part.cur_qt_depth
        cu.depth = part.cur_depth
        cu.split_series = tuple(lvl.split for lvl in part.stack[1:])
        return self.cs.add_cu(cu)

    def mode_constraint(self, part: P.Partitioner, split_mode: int) -> int:
        val = self._signal_mode_cons(part, split_mode)
        if val == 2:  # signal
            c = self._ctx_mode_cons_flag(part)
            flag = self.d.decode_bin(ctx("ModeConsFlag", c))
            return MODE_TYPE_INTRA if flag else MODE_TYPE_INTER
        if val == 1:  # infer
            return MODE_TYPE_INTRA
        return part.mode_type

    def _signal_mode_cons(self, part: P.Partitioner, split: int) -> int:
        """0=inherit, 1=infer, 2=signal (CodingStructure::signalModeCons)."""
        if (
            self.is_dual_itree
            or part.mode_type != MODE_TYPE_ALL
            or self.sps.chroma_format_idc in (0, 3)
        ):
            return 0
        a = part.cur_area()
        min_luma_area = a.w * a.h
        if split in (P.CU_QUAD_SPLIT, P.CU_TRIH_SPLIT, P.CU_TRIV_SPLIT):
            min_luma_area >>= 2
        elif split in (P.CU_HORZ_SPLIT, P.CU_VERT_SPLIT):
            min_luma_area >>= 1
        fmt = self.cs.chroma_format
        min_chroma_block = min_luma_area >> (fmt.scale_x + fmt.scale_y)
        cw = a.w >> fmt.scale_x
        is_2xn = (cw == 4 and split == P.CU_VERT_SPLIT) or (
            cw == 8 and split == P.CU_TRIV_SPLIT
        )
        if min_chroma_block >= 16 and not is_2xn:
            return 0
        if min_luma_area < 32 or self.sh.slice_type == SliceType.I:
            return 1
        return 2

    def _ctx_mode_cons_flag(self, part: P.Partitioner) -> int:
        a = part.cur_area()
        left = self.cs.get_cu_restricted(a.x - 1, a.y, a.x, a.y, part.ch_type)
        above = self.cs.get_cu_restricted(a.x, a.y - 1, a.x, a.y, part.ch_type)
        return 1 if (
            (above and above.pred_mode == MODE_INTRA)
            or (left and left.pred_mode == MODE_INTRA)
        ) else 0

    def split_cu_mode(self, part: P.Partitioner) -> int:
        can_no, can_qt, can_bh, can_bv, can_th, can_tv = part.can_split_flags()
        ctx_spl, ctx_qt, ctx_hv, ctx_h12, ctx_v12 = self._ctx_split(
            part, (can_no, can_qt, can_bh, can_bv, can_th, can_tv)
        )
        is_split = can_bh or can_bv or can_th or can_tv or can_qt
        if can_no and is_split:
            is_split = bool(self.d.decode_bin(ctx("SplitFlag", ctx_spl)))
        if not is_split:
            return P.CU_DONT_SPLIT
        can_btt = can_bh or can_bv or can_th or can_tv
        is_qt = can_qt
        if is_qt and can_btt:
            is_qt = bool(self.d.decode_bin(ctx("SplitQtFlag", ctx_qt)))
        if is_qt:
            return P.CU_QUAD_SPLIT
        can_hor = can_bh or can_th
        is_ver = can_bv or can_tv
        if is_ver and can_hor:
            is_ver = bool(self.d.decode_bin(ctx("SplitHvFlag", ctx_hv)))
        can14 = can_tv if is_ver else can_th
        is12 = can_bv if is_ver else can_bh
        if is12 and can14:
            is12 = bool(
                self.d.decode_bin(ctx("Split12Flag", ctx_v12 if is_ver else ctx_h12))
            )
        if is_ver and is12:
            return P.CU_VERT_SPLIT
        if is_ver:
            return P.CU_TRIV_SPLIT
        if is12:
            return P.CU_HORZ_SPLIT
        return P.CU_TRIH_SPLIT

    def _ctx_split(self, part: P.Partitioner, can):
        can_no, can_qt, can_bh, can_bv, can_th, can_tv = can
        b = part.cur_block()
        left = self.cs.get_cu_restricted(b.x - 1, b.y, b.x, b.y, part.ch_type)
        above = self.cs.get_cu_restricted(b.x, b.y - 1, b.x, b.y, part.ch_type)
        comp = 0 if part.ch_type == CH_L else 1
        ctx_spl = 0
        if left:
            lb = left.blocks[comp]
            ctx_spl += 1 if lb.h < b.h else 0
        if above:
            ab = above.blocks[comp]
            ctx_spl += 1 if ab.w < b.w else 0
        num_split = 0
        if can_qt:
            num_split += 2
        num_split += int(can_bh) + int(can_bv) + int(can_th) + int(can_tv)
        if num_split > 0:
            num_split -= 1
        ctx_spl += 3 * (num_split >> 1)
        ctx_qt = (1 if (left and left.qt_depth > part.cur_qt_depth) else 0) + (
            1 if (above and above.qt_depth > part.cur_qt_depth) else 0
        )
        ctx_qt += 0 if part.cur_qt_depth < 2 else 3
        num_hor = int(can_bh) + int(can_th)
        num_ver = int(can_bv) + int(can_tv)
        if num_ver == num_hor:
            w_above = above.blocks[comp].w if above else 1
            h_left = left.blocks[comp].h if left else 1
            dep_above = b.w // w_above
            dep_left = b.h // h_left
            if dep_above == dep_left or not left or not above:
                ctx_hv = 0
            elif dep_above < dep_left:
                ctx_hv = 1
            else:
                ctx_hv = 2
        elif num_ver < num_hor:
            ctx_hv = 3
        else:
            ctx_hv = 4
        ctx_h12 = 1 if part.cur_mt_depth <= 1 else 0
        ctx_v12 = 3 if part.cur_mt_depth <= 1 else 2
        return ctx_spl, ctx_qt, ctx_hv, ctx_h12, ctx_v12

    # ==================================================================
    # coding unit
    # ==================================================================

    def coding_unit(self, cu: CU, part: P.Partitioner, cu_ctx: CuCtx):
        if (self.sh.slice_type != SliceType.I or self.sps.ibc) and cu.blocks[0] is not None:
            self.cu_skip_flag(cu)
        if cu.skip:
            cu.color_transform = False
            self._add_empty_tus(cu, part)
            self.prediction_unit(cu)
            self.end_of_ctu(cu, cu_ctx)
            return
        self.pred_mode(cu)
        if cu.pred_mode == D.MODE_PLT:
            cu.color_transform = False
            self._add_empty_tus(cu, part)
            if cu.is_sep_tree:
                if cu.ch_type == CH_L:
                    self.cu_palette_info(cu, 0, 1, cu_ctx)
                if (
                    self.sps.chroma_format_idc != 0
                    and part.ch_type == CH_C
                ):
                    self.cu_palette_info(cu, 1, 2, cu_ctx)
            else:
                if self.sps.chroma_format_idc != 0:
                    self.cu_palette_info(cu, 0, 3, cu_ctx)
                else:
                    self.cu_palette_info(cu, 0, 1, cu_ctx)
            self.end_of_ctu(cu, cu_ctx)
            return
        # ACT (requires sps.act)
        if cu.pred_mode == MODE_INTRA and self.sps.act and not cu.is_sep_tree:
            cu.color_transform = bool(self.d.decode_bin(ctx("ACTFlag")))
        self.cu_pred_data(cu)
        self.cu_residual(cu, part, cu_ctx)
        self.end_of_ctu(cu, cu_ctx)

    def _add_empty_tus(self, cu: CU, part: P.Partitioner):
        """CodingStructure::addEmptyTUs — one zero-coeff TU covering the CU."""
        luma = part.cur_area()
        chroma = part.cur_chroma()
        blocks = [
            Rect(luma.x, luma.y, luma.w, luma.h) if cu.blocks[0] is not None else None,
            Rect(chroma.x, chroma.y, chroma.w, chroma.h) if cu.blocks[1] is not None else None,
            Rect(chroma.x, chroma.y, chroma.w, chroma.h) if cu.blocks[2] is not None else None,
        ]
        tu = TU(blocks=blocks, cu=cu, depth=0)
        for c in range(3):
            if blocks[c] is not None:
                tu.coeffs[c] = np.zeros((blocks[c].h, blocks[c].w), dtype=np.int32)
        cu.tus.append(tu)
        self.cs.add_tu(tu)

    # ==================================================================
    # palette mode (CABACReader.cpp cu_palette_info:1650)
    # ==================================================================

    def cu_palette_info(self, cu: CU, comp_begin: int, num_comp: int, cu_ctx: CuCtx):
        sps = self.sps
        if cu.plt is None:
            cu.plt = D.PltData()
            cu.plt.calls = []
        p = cu.plt
        p.calls.append((comp_begin, num_comp))
        chb = 0 if comp_begin == 0 else 1
        prev = self.cs.prev_plt
        local_sep = cu.tree_type != D.TREE_D and not cu.sep_tree
        if local_sep:
            prev.size[chb] = prev.size[0]
        p.last_size[chb] = prev.size[chb]
        max_plt = D.MAXPLTSIZE_DUALTREE if cu.is_sep_tree else D.MAXPLTSIZE
        if p.last_size[chb]:
            self._plt_pred_indicator(cu, max_plt, chb, local_sep)
        cur_idx = 0
        for idx in range(p.last_size[chb]):
            if p.reuse[chb][idx]:
                comps = range(3) if local_sep else range(comp_begin, comp_begin + num_comp)
                for c in comps:
                    p.cur[c][cur_idx] = prev.plt[c][idx]
                cur_idx += 1
        received = 0
        if cur_idx < max_plt:
            received = self._exp_golomb_eqprob(0)
        p.cur_size[chb] = cur_idx + received
        if local_sep:
            p.cur_size[0] = p.cur_size[chb]
        bd = sps.bit_depth
        for c in range(comp_begin, comp_begin + num_comp):
            for idx in range(cur_idx, p.cur_size[chb]):
                p.cur[c][idx] = self.d.decode_bins_ep(bd)
                if local_sep:
                    if cu.ch_type == CH_L:
                        p.cur[1][idx] = 1 << (bd - 1)
                        p.cur[2][idx] = 1 << (bd - 1)
                    else:
                        p.cur[0][idx] = 1 << (bd - 1)
        p.use_escape[chb] = True
        if p.cur_size[chb] > 0:
            p.use_escape[chb] = bool(self.d.decode_bin_ep())
        index_max = p.cur_size[chb] + (1 if p.use_escape[chb] else 0)
        b = cu.blocks[comp_begin]
        total = b.w * b.h
        if index_max > 1:
            p.use_rotation[chb] = bool(self.d.decode_bin(ctx("RotationFlag")))
        else:
            p.use_rotation[chb] = False
        if p.use_escape[chb] and self.pps.cu_qp_delta_enabled and not cu_ctx.is_dqp_coded:
            if not cu.is_sep_tree or cu.ch_type == CH_L:
                cu.qp = self.cu_qp_delta(cu, cu_ctx.qp)
                cu_ctx.qp = cu.qp
                cu_ctx.is_dqp_coded = True
        if (
            p.use_escape[chb] and self.sh.chroma_qp_adj
            and not cu_ctx.is_chroma_qp_adj_coded
        ):
            if not cu.is_sep_tree or cu.ch_type == CH_C:
                self._cu_chroma_qp_offset(cu)
                cu_ctx.is_chroma_qp_adj_coded = True
        # index/run maps over the traverse scan
        p.idx[chb] = np.zeros((b.h, b.w), dtype=np.int32)
        p.run_type[chb] = np.zeros((b.h, b.w), dtype=np.int32)
        for c in range(comp_begin, comp_begin + num_comp):
            cb = cu.blocks[c]
            p.escape[c] = np.zeros((cb.h, cb.w), dtype=np.int32)
        scan = _traverse_scan(b.w, b.h, p.use_rotation[chb])
        state = [0, 0]  # prevRunPos, prevRunType
        for sub in range((total - 1 >> 4) + 1):
            self._plt_subblock(cu, comp_begin, num_comp, sub, scan, state, chb, index_max)

    def _plt_pred_indicator(self, cu: CU, max_plt: int, chb: int, local_sep: bool):
        """xDecodePLTPredIndicator (CABACReader.cpp:1917)."""
        p = cu.plt
        num_pred = 0
        idx = 0
        symbol = self._exp_golomb_eqprob(0)
        if symbol != 1:
            while idx < p.last_size[chb] and num_pred < max_plt:
                if idx > 0:
                    symbol = self._exp_golomb_eqprob(0)
                if symbol == 1:
                    break
                if symbol:
                    idx += symbol - 1
                p.reuse[chb][idx] = True
                if local_sep:
                    p.reuse[0][idx] = True
                num_pred += 1
                idx += 1

    def _plt_subblock(self, cu, comp_begin, num_comp, sub, scan, state, chb, index_max):
        """cuPaletteSubblockInfo (CABACReader.cpp:1770)."""
        p = cu.plt
        run_type = p.run_type[chb]
        plt_idx = p.idx[chb]
        b = cu.blocks[comp_begin]
        total = b.w * b.h
        min_pos = sub << 4
        max_pos = min(min_pos + 16, total)
        rot = p.use_rotation[chb]
        run_copy = [None] * 16
        if min_pos == 0:
            run_copy[0] = 0
        # run-copy flags and run types (context coded)
        for pos in range(min_pos, max_pos):
            if index_max <= 1:
                break
            px, py = scan[pos]
            ppx, ppy = scan[pos - 1] if pos else (0, 0)
            identity = 1
            set_name = "IdxRunModel" if state[1] == 0 else "CopyRunModel"
            if pos > 0:
                dist = pos - state[0] - 1
                lut = _PLT_RUN_LEFT_LUT if state[1] == 0 else _PLT_RUN_TOP_LUT
                c = lut[min(dist, 4)]
                identity = self.d.decode_bin(ctx(set_name, c))
                run_copy[pos - min_pos] = identity
            if identity == 0 or pos == 0:
                if (py == 0 and not rot) or (px == 0 and rot):
                    run_type[py, px] = 0  # PLT_RUN_INDEX
                elif pos != 0 and run_type[ppy, ppx] == 1:
                    run_type[py, px] = 0
                else:
                    run_type[py, px] = self.d.decode_bin(ctx("RunTypeFlag"))
                state[1] = int(run_type[py, px])
                state[0] = pos
            else:
                run_type[py, px] = run_type[ppy, ppx]
        # index values (bypass)
        if index_max > 1:
            for pos in range(min_pos, max_pos):
                adjust = 1 if pos > 0 else 0
                px, py = scan[pos]
                ppx, ppy = scan[pos - 1] if pos else (0, 0)
                if run_copy[pos - min_pos] == 0 and run_type[py, px] == 0:
                    symbol = self._trunc_bin(index_max - adjust)
                    self._plt_adjust_index(cu, symbol, pos, scan, plt_idx,
                                           run_type, index_max, chb, rot)
                elif run_type[py, px] == 0:
                    plt_idx[py, px] = plt_idx[ppy, ppx]
                else:
                    plt_idx[py, px] = (
                        plt_idx[py, px - 1] if rot else plt_idx[py - 1, px]
                    )
        else:
            for pos in range(min_pos, max_pos):
                px, py = scan[pos]
                ppx, ppy = scan[pos - 1] if pos else (0, 0)
                run_type[py, px] = 0
                if run_copy[pos - min_pos] == 0:
                    plt_idx[py, px] = 0
                else:
                    plt_idx[py, px] = plt_idx[ppy, ppx]
        # escape values (bypass)
        fmt = self.cs.chroma_format
        sx, sy = fmt.scale_x, fmt.scale_y
        for c in range(comp_begin, comp_begin + num_comp):
            for pos in range(min_pos, max_pos):
                px, py = scan[pos]
                if plt_idx[py, px] == p.cur_size[chb]:
                    if c == 0 or comp_begin != 0:
                        p.escape[c][py, px] = self._exp_golomb_eqprob(5)
                    elif (
                        comp_begin == 0 and c != 0
                        and py % (1 << sy) == 0 and px % (1 << sx) == 0
                    ):
                        p.escape[c][py >> sy, px >> sx] = self._exp_golomb_eqprob(5)

    def _plt_adjust_index(self, cu, symbol, pos, scan, plt_idx, run_type,
                          index_max, chb, rot):
        """xAdjustPLTIndex (CABACReader.cpp:1948)."""
        p = cu.plt
        max_symbol = index_max
        ref_level = 1 << 30
        px, py = scan[pos]
        if pos:
            ppx, ppy = scan[pos - 1]
            if run_type[ppy, ppx] == 0:
                ref_level = plt_idx[ppy, ppx]
                if plt_idx[ppy, ppx] == p.cur_size[chb]:
                    ref_level = max_symbol - 1
            else:
                if rot:
                    ref_level = plt_idx[py, px - 1]
                    if plt_idx[py, px - 1] == p.cur_size[chb]:
                        ref_level = max_symbol - 1
                else:
                    ref_level = plt_idx[py - 1, px]
                    if plt_idx[py - 1, px] == p.cur_size[chb]:
                        ref_level = max_symbol - 1
            max_symbol -= 1
        if symbol >= ref_level:
            symbol += 1
        plt_idx[py, px] = symbol

    def cu_skip_flag(self, cu: CU):
        if (self.sh.slice_type == SliceType.I or cu.mode_type == MODE_TYPE_INTRA) and self.sps.ibc:
            cu.skip = False
            cu.pred_mode = MODE_INTRA
            if cu.lwidth < 128 and cu.lheight < 128:
                c = self._ctx_skip_flag(cu)
                if self.d.decode_bin(ctx("SkipFlag", c)):
                    cu.skip = True
                    cu.pred_mode = D.MODE_IBC
            return
        if not self.sps.ibc and cu.lwidth == 4 and cu.lheight == 4:
            return
        if not self.sps.ibc and cu.mode_type == MODE_TYPE_INTRA:
            return
        c = self._ctx_skip_flag(cu)
        skip = self.d.decode_bin(ctx("SkipFlag", c))
        if skip and self.sps.ibc:
            if (
                cu.lwidth < 128 and cu.lheight < 128
                and cu.mode_type != MODE_TYPE_INTER
            ):
                if cu.lwidth == 4 and cu.lheight == 4:
                    cu.skip = True
                    cu.root_cbf = False
                    cu.pred_mode = D.MODE_IBC
                    return
                if self.d.decode_bin(ctx("IBCFlag", self._ctx_ibc_flag(cu))):
                    cu.skip = True
                    cu.root_cbf = False
                    cu.pred_mode = D.MODE_IBC
                    cu.regular_merge_flag = False
                else:
                    cu.pred_mode = MODE_INTER
            else:
                cu.pred_mode = MODE_INTER
        if skip and (cu.pred_mode == MODE_INTER or not self.sps.ibc):
            cu.skip = True
            cu.root_cbf = False
            cu.pred_mode = MODE_INTER

    def _ctx_skip_flag(self, cu: CU) -> int:
        x, y = cu.lx, cu.ly
        left = self.cs.get_cu_restricted(x - 1, y, x, y, CH_L)
        above = self.cs.get_cu_restricted(x, y - 1, x, y, CH_L)
        return (1 if (left and left.skip) else 0) + (1 if (above and above.skip) else 0)

    def pred_mode(self, cu: CU):
        if self.sps.ibc and cu.ch_type != CH_C:
            if cu.mode_type == MODE_TYPE_INTER:
                cu.pred_mode = MODE_INTER
                return
            if (
                self.sh.slice_type == SliceType.I
                or (cu.lwidth == 4 and cu.lheight == 4)
                or cu.mode_type == MODE_TYPE_INTRA
            ):
                cu.pred_mode = MODE_INTRA
                if cu.lwidth < 128 and cu.lheight < 128:
                    c = self._ctx_ibc_flag(cu)
                    if self.d.decode_bin(ctx("IBCFlag", c)):
                        cu.pred_mode = D.MODE_IBC
                if (
                    cu.pred_mode != D.MODE_IBC
                    and self.sps.palette
                    and cu.lwidth <= 64
                    and cu.lheight <= 64
                    and cu.lwidth * cu.lheight > 16
                ):
                    if self.d.decode_bin(ctx("PLTFlag")):
                        cu.pred_mode = D.MODE_PLT
            else:
                if self.d.decode_bin(ctx("PredMode", self._ctx_pred_mode(cu))):
                    cu.pred_mode = MODE_INTRA
                    if (
                        self.sps.palette
                        and cu.lwidth <= 64 and cu.lheight <= 64
                        and cu.lwidth * cu.lheight > 16
                    ):
                        if self.d.decode_bin(ctx("PLTFlag")):
                            cu.pred_mode = D.MODE_PLT
                else:
                    cu.pred_mode = MODE_INTER
                    if cu.lwidth < 128 and cu.lheight < 128:
                        if self.d.decode_bin(ctx("IBCFlag", self._ctx_ibc_flag(cu))):
                            cu.pred_mode = D.MODE_IBC
            return
        if cu.mode_type == MODE_TYPE_INTER:
            cu.pred_mode = MODE_INTER
            return
        if (
            self.sh.slice_type == SliceType.I
            or (cu.lwidth == 4 and cu.lheight == 4)
            or cu.mode_type == MODE_TYPE_INTRA
        ):
            cu.pred_mode = MODE_INTRA
            if self.sps.palette and cu.lheight <= 64 and self._plt_size_ok(cu):
                if self.d.decode_bin(ctx("PLTFlag")):
                    cu.pred_mode = D.MODE_PLT
        else:
            c = self._ctx_pred_mode(cu)
            cu.pred_mode = MODE_INTRA if self.d.decode_bin(ctx("PredMode", c)) else MODE_INTER
            # NB the reference omits the lheight<=64 bound in this branch
            # (CABACReader.cpp:1123)
            if cu.pred_mode == MODE_INTRA and self.sps.palette and self._plt_size_ok(cu):
                if self.d.decode_bin(ctx("PLTFlag")):
                    cu.pred_mode = D.MODE_PLT

    def _plt_size_ok(self, cu: CU) -> bool:
        """Size/area/tree gates shared by pred_mode PLT checks
        (CABACReader.cpp:1113,1123)."""
        if cu.lwidth > 64:
            return False
        local_sep_tree = cu.tree_type != D.TREE_D and not cu.sep_tree
        if local_sep_tree and cu.ch_type == CH_C:
            return False
        if cu.ch_type == CH_C:
            b = cu.blocks[1]
            return b.w * b.h > 16
        return cu.lwidth * cu.lheight > 16

    def _ctx_ibc_flag(self, cu: CU) -> int:
        x, y = cu.lx, cu.ly
        left = self.cs.get_cu_restricted(x - 1, y, x, y, CH_L)
        above = self.cs.get_cu_restricted(x, y - 1, x, y, CH_L)
        return (1 if (left and left.pred_mode == D.MODE_IBC) else 0) + (
            1 if (above and above.pred_mode == D.MODE_IBC) else 0
        )

    def _ctx_pred_mode(self, cu: CU) -> int:
        x, y = cu.lx, cu.ly
        left = self.cs.get_cu_restricted(x - 1, y, x, y, cu.ch_type)
        above = self.cs.get_cu_restricted(x, y - 1, x, y, cu.ch_type)
        return 1 if (
            (left and left.pred_mode == MODE_INTRA)
            or (above and above.pred_mode == MODE_INTRA)
        ) else 0

    # -- intra prediction data ---------------------------------------------

    def cu_pred_data(self, cu: CU):
        if cu.pred_mode != MODE_INTRA:
            self.prediction_unit(cu)
            self.imv_mode(cu)
            self.affine_amvr_mode(cu)
            self.cu_bcw_flag(cu)
            return
        if cu.blocks[0] is not None:
            self.bdpcm_mode(cu, 0)
        self.intra_luma_pred_modes(cu)
        if (
            (cu.blocks[0] is None or (not cu.is_sep_tree and cu.blocks[0] is not None))
            and self.sps.chroma_format_idc != 0
        ):
            self.bdpcm_mode(cu, 1)
        self.intra_chroma_pred_modes(cu)

    # ------------------------------------------------------------------
    # inter prediction data (CABACReader.cpp prediction_unit:2009,
    # merge_flag:2166, merge_data:2183, merge_idx:2270, mmvd_merge_idx:2354,
    # inter_pred_idc:2402, ref_idx:2433, mvp_flag:2473, mvd_coding:2623,
    # imv_mode:962, smvd_mode:2109, subblock_merge_flag:2129,
    # affine_flag:2143, Ciip_flag:2484, cu_bcw_flag:1211)

    def prediction_unit(self, cu: CU):
        if cu.skip:
            cu.merge_flag = True
        else:
            self.merge_flag(cu)
        if cu.merge_flag:
            self.merge_data(cu)
        elif cu.pred_mode == D.MODE_IBC:
            cu.interdir = 1
            cu.affine = False
            cu.ref_idx[0] = M.MAX_NUM_REF
            cu.mvd[0] = self.mvd_coding()
            if self.sps.max_num_ibc_merge_cand == 1:
                cu.mvp_idx[0] = 0
            else:
                self.mvp_flag(cu, 0)
        else:
            self.inter_pred_idc(cu)
            self.affine_flag(cu)
            self.smvd_mode(cu)
            if cu.interdir != 2:
                self.ref_idx(cu, 0)
                if cu.affine:
                    cu.mvd_affi[0][0] = self.mvd_coding()
                    cu.mvd_affi[0][1] = self.mvd_coding()
                    if cu.affine_type == 1:
                        cu.mvd_affi[0][2] = self.mvd_coding()
                else:
                    cu.mvd[0] = self.mvd_coding()
                self.mvp_flag(cu, 0)
            if cu.interdir != 1:
                if cu.smvd_mode != 1:
                    self.ref_idx(cu, 1)
                    if self.ph.mvd_l1_zero and cu.interdir == 3:
                        cu.mvd[1] = (0, 0)
                        cu.mvd_affi[1] = [(0, 0)] * 3
                    elif cu.affine:
                        cu.mvd_affi[1][0] = self.mvd_coding()
                        cu.mvd_affi[1][1] = self.mvd_coding()
                        if cu.affine_type == 1:
                            cu.mvd_affi[1][2] = self.mvd_coding()
                    else:
                        cu.mvd[1] = self.mvd_coding()
                self.mvp_flag(cu, 1)
        if cu.interdir == 3 and M.is_bipred_restriction(cu):
            cu.mv[1] = (0, 0)
            cu.ref_idx[1] = -1
            cu.interdir = 1
            cu.bcw_idx = M.BCW_DEFAULT
        if cu.smvd_mode:
            lst = cu.smvd_mode - 1
            cu.mvd[1 - lst] = (-cu.mvd[lst][0], -cu.mvd[lst][1])
            cu.ref_idx[1 - lst] = self.sh.sym_ref_idx[1 - lst]
        # spanMotionInfo happens after MV finalization in DecCu

    def merge_flag(self, cu: CU):
        cu.merge_flag = bool(self.d.decode_bin(ctx("MergeFlag")))

    def _sbt_allowed(self, cu: CU) -> int:
        """CU::checkAllowedSbt (Unit.cpp:450): bitmask over SbtIdx 1..4."""
        if not self.sps.sbt or cu.pred_mode != MODE_INTER or cu.ciip_flag:
            return 0
        w, h = cu.lwidth, cu.lheight
        max_size = 1 << self.sps.log2_max_tb_size
        if w > max_size or h > max_size:
            return 0
        min_size = 8  # 1 << (MIN_CU_LOG2 + 1)
        mask = 0
        mask |= (w >= min_size) << 1       # SBT_VER_HALF
        mask |= (h >= min_size) << 2       # SBT_HOR_HALF
        mask |= (w >= min_size * 2) << 3   # SBT_VER_QUAD
        mask |= (h >= min_size * 2) << 4   # SBT_HOR_QUAD
        return mask

    def sbt_mode(self, cu: CU):
        allowed = self._sbt_allowed(cu)
        if not allowed:
            return
        w, h = cu.lwidth, cu.lheight
        c = 1 if w * h <= 256 else 0
        if not self.d.decode_bin(ctx("SbtFlag", c)):
            return
        ver_half = (allowed >> 1) & 1
        hor_half = (allowed >> 2) & 1
        ver_quad = (allowed >> 3) & 1
        hor_quad = (allowed >> 4) & 1
        quad = 0
        if (hor_half or ver_half) and (hor_quad or ver_quad):
            quad = self.d.decode_bin(ctx("SbtQuadFlag"))
        if (quad and ver_quad and hor_quad) or (not quad and ver_half and hor_half):
            c = 0 if w == h else (1 if w < h else 2)
            hor = self.d.decode_bin(ctx("SbtHorFlag", c))
        else:
            hor = int((quad and hor_quad) or (not quad and hor_half))
        sbt_idx = (2 if hor else 1) + (2 if quad else 0)  # HOR_HALF=2/VER_HALF=1/HOR_QUAD=4/VER_QUAD=3
        pos = self.d.decode_bin(ctx("SbtPosFlag"))
        cu.sbt_info = (pos << 4) | sbt_idx

    def merge_data(self, cu: CU):
        if cu.pred_mode == D.MODE_IBC:
            self.merge_idx(cu)
            return
        self.subblock_merge_flag(cu)
        if cu.affine:
            self.merge_idx(cu)
            cu.regular_merge_flag = False
            return
        ciip_avail = (
            self.sps.ciip and not cu.skip and cu.lwidth < 128 and cu.lheight < 128
            and cu.lwidth * cu.lheight >= 64
        )
        geo_avail = (
            self.sps.geo and self.sh.is_b and self.sps.max_num_geo_cand > 1
            and cu.lwidth >= 8 and cu.lheight >= 8
            and cu.lwidth <= 64 and cu.lheight <= 64
            and cu.lwidth < 8 * cu.lheight and cu.lheight < 8 * cu.lwidth
        )
        if geo_avail or ciip_avail:
            cu.regular_merge_flag = bool(
                self.d.decode_bin(ctx("RegularMergeFlag", 0 if cu.skip else 1))
            )
        else:
            cu.regular_merge_flag = True
        if cu.regular_merge_flag:
            if self.sps.mmvd:
                cu.mmvd_flag = bool(self.d.decode_bin(ctx("MmvdFlag", 0)))
            else:
                cu.mmvd_flag = False
            if cu.skip:
                cu.mmvd_skip = cu.mmvd_flag
        else:
            cu.mmvd_flag = False
            cu.mmvd_skip = False
            if geo_avail and ciip_avail:
                self.ciip_flag(cu)
            elif ciip_avail:
                cu.ciip_flag = True
            else:
                cu.ciip_flag = False
            if cu.ciip_flag:
                cu.intra_dir = [D.PLANAR_IDX, D.DM_CHROMA_IDX]
            else:
                cu.geo_flag = True
        if cu.mmvd_flag or cu.mmvd_skip:
            self.mmvd_merge_idx(cu)
        else:
            self.merge_idx(cu)

    def merge_idx(self, cu: CU):
        if cu.affine:
            n_minus1 = self.ph.max_num_affine_merge_cand - 1
            cu.merge_idx = 0
            if n_minus1 > 0 and self.d.decode_bin(ctx("AffMergeIdx")):
                cu.merge_idx = 1
                while cu.merge_idx < n_minus1 and self.d.decode_bin_ep():
                    cu.merge_idx += 1
            return
        if cu.geo_flag:
            cu.geo_split_dir = self._trunc_bin(64)
            max_geo = self.sps.max_num_geo_cand
            n_minus2 = max_geo - 2
            m0 = m1 = 0
            if self.d.decode_bin(ctx("MergeIdx")):
                m0 += self._unary_max_eqprob(n_minus2) + 1
            if n_minus2 > 0 and self.d.decode_bin(ctx("MergeIdx")):
                m1 += self._unary_max_eqprob(n_minus2 - 1) + 1
            m1 += 1 if m1 >= m0 else 0
            cu.geo_merge_idx = [m0, m1]
            return
        if cu.pred_mode == D.MODE_IBC:
            n_minus1 = self.sps.max_num_ibc_merge_cand - 1
        else:
            n_minus1 = self.sps.max_num_merge_cand - 1
        cu.merge_idx = 0
        if n_minus1 > 0 and self.d.decode_bin(ctx("MergeIdx")):
            cu.merge_idx = 1
            while cu.merge_idx < n_minus1 and self.d.decode_bin_ep():
                cu.merge_idx += 1

    def mmvd_merge_idx(self, cu: CU):
        var0 = 0
        if self.sps.max_num_merge_cand > 1:
            var0 = self.d.decode_bin(ctx("MmvdMergeIdx"))
        var1 = 0
        if self.d.decode_bin(ctx("MmvdStepMvpIdx")):
            var1 = 1
            while var1 < 7 and self.d.decode_bin_ep():
                var1 += 1
        var2 = 0
        if self.d.decode_bin_ep():
            var2 += 2
        if self.d.decode_bin_ep():
            var2 += 1
        cu.mmvd_idx = var0 * 32 + var1 * 4 + var2  # MMVD_MAX_REFINE_NUM=32

    def inter_pred_idc(self, cu: CU):
        if self.sh.slice_type == SliceType.P:
            cu.interdir = 1
            return
        if not M.is_bipred_restriction(cu):
            w, h = cu.lwidth, cu.lheight
            c = 7 - (((w.bit_length() - 1) + (h.bit_length() - 1) + 1) >> 1)
            if self.d.decode_bin(ctx("InterDir", c)):
                cu.interdir = 3
                return
        cu.interdir = 2 if self.d.decode_bin(ctx("InterDir", 5)) else 1

    def affine_flag(self, cu: CU):
        if (
            self.sh.slice_type != SliceType.I and self.sps.affine
            and cu.lwidth > 8 and cu.lheight > 8
        ):
            c = self._ctx_affine_flag(cu)
            cu.affine = bool(self.d.decode_bin(ctx("AffineFlag", c)))
            if cu.affine and self.sps.affine_type:
                cu.affine_type = self.d.decode_bin(ctx("AffineType"))
            else:
                cu.affine_type = 0

    def subblock_merge_flag(self, cu: CU):
        cu.affine = False
        if (
            self.sh.slice_type != SliceType.I
            and self.ph.max_num_affine_merge_cand > 0
            and cu.lwidth >= 8 and cu.lheight >= 8
        ):
            c = self._ctx_affine_flag(cu)
            cu.affine = bool(self.d.decode_bin(ctx("SubblockMergeFlag", c)))

    def _ctx_affine_flag(self, cu: CU) -> int:
        x, y = cu.lx, cu.ly
        left = self.cs.get_cu_restricted(x - 1, y, x, y, CH_L)
        above = self.cs.get_cu_restricted(x, y - 1, x, y, CH_L)
        return (1 if (left and left.affine) else 0) + (
            1 if (above and above.affine) else 0
        )

    def smvd_mode(self, cu: CU):
        cu.smvd_mode = 0
        if cu.interdir != 3 or cu.affine:
            return
        if not self.sh.bi_dir_pred:
            return
        cu.smvd_mode = 1 if self.d.decode_bin(ctx("SmvdFlag")) else 0

    def ref_idx(self, cu: CU, lst: int):
        if cu.smvd_mode:
            cu.ref_idx[lst] = self.sh.sym_ref_idx[lst]
            return
        num_ref = self.sh.num_ref_idx[lst]
        if num_ref <= 1 or not self.d.decode_bin(ctx("RefPic")):
            cu.ref_idx[lst] = 0
            return
        if num_ref <= 2 or not self.d.decode_bin(ctx("RefPic", 1)):
            cu.ref_idx[lst] = 1
            return
        idx = 3
        while True:
            if num_ref <= idx or not self.d.decode_bin_ep():
                cu.ref_idx[lst] = idx - 1
                return
            idx += 1

    def mvp_flag(self, cu: CU, lst: int):
        cu.mvp_idx[lst] = self.d.decode_bin(ctx("MVPIdx"))

    def mvd_coding(self) -> tuple:
        hor = self.d.decode_bin(ctx("Mvd"))
        ver = self.d.decode_bin(ctx("Mvd"))
        if hor:
            hor += self.d.decode_bin(ctx("Mvd", 1))
        if ver:
            ver += self.d.decode_bin(ctx("Mvd", 1))
        if hor:
            if hor > 1:
                hor += self.d.decode_rem_abs_ep(1, 0, 17)  # MV_BITS-1
            if self.d.decode_bin_ep():
                hor = -hor
        if ver:
            if ver > 1:
                ver += self.d.decode_rem_abs_ep(1, 0, 17)
            if self.d.decode_bin_ep():
                ver = -ver
        return (hor, ver)

    def imv_mode(self, cu: CU):
        if not self.sps.amvr:
            return
        if not self._has_nonzero_mvd(cu):
            return
        if cu.affine:
            return
        if cu.pred_mode == D.MODE_IBC:
            value = 1
        else:
            value = self.d.decode_bin(ctx("ImvFlag", 0))
        cu.imv = value
        if value:
            if cu.pred_mode != D.MODE_IBC:
                value = self.d.decode_bin(ctx("ImvFlag", 4))
                cu.imv = 1 if value else M.IMV_HPEL
            if value:
                value = self.d.decode_bin(ctx("ImvFlag", 1))
                cu.imv = value + 1

    def affine_amvr_mode(self, cu: CU):
        if not self.sps.affine_amvr or not cu.affine:
            return
        if not self._has_nonzero_affine_mvd(cu):
            return
        value = self.d.decode_bin(ctx("ImvFlag", 2))
        if value:
            value = self.d.decode_bin(ctx("ImvFlag", 3)) + 1
        cu.imv = value

    def _has_nonzero_mvd(self, cu: CU) -> bool:
        """CU::hasSubCUNonZeroMVd."""
        if cu.merge_flag or cu.pred_mode not in (MODE_INTER, D.MODE_IBC):
            return False
        nz = False
        if cu.interdir != 2:
            nz |= cu.mvd[0] != (0, 0)
        if cu.interdir != 1:
            if not (self.ph.mvd_l1_zero and cu.interdir == 3):
                nz |= cu.mvd[1] != (0, 0)
        return nz

    def _has_nonzero_affine_mvd(self, cu: CU) -> bool:
        if cu.merge_flag or not cu.affine:
            return False
        nz = False
        if cu.interdir != 2:
            nz |= any(m != (0, 0) for m in cu.mvd_affi[0])
        if cu.interdir != 1:
            if not (self.ph.mvd_l1_zero and cu.interdir == 3):
                nz |= any(m != (0, 0) for m in cu.mvd_affi[1])
        return nz

    def cu_bcw_flag(self, cu: CU):
        if not self._is_bcw_coded(cu):
            return
        idx = 0
        if self.d.decode_bin(ctx("BcwIdx")):
            num_bcw = 5 if self.sh.check_ldc else 3
            idx = 1
            for _ in range(num_bcw - 2):
                if not self.d.decode_bin_ep():
                    break
                idx += 1
        # g_BcwParsingOrder = {BCW_DEFAULT, BCW_DEFAULT+1, BCW_DEFAULT-1,
        #                      BCW_DEFAULT+2, BCW_DEFAULT-2} (Rom.cpp:202)
        order = [2, 3, 1, 4, 0]
        cu.bcw_idx = order[idx]

    def _is_bcw_coded(self, cu: CU) -> bool:
        """CU::isBcwIdxCoded: bi-pred, non-merge, sps_bcw, size >= 256,
        no explicit WP for either ref."""
        if not self.sps.bcw or cu.pred_mode != MODE_INTER:
            return False
        if cu.merge_flag or cu.interdir != 3:
            return False
        if cu.lwidth * cu.lheight < 256:
            return False
        if self.sh.wp_present(cu.ref_idx):
            return False
        return True

    def ciip_flag(self, cu: CU):
        if not self.sps.ciip or cu.skip:
            cu.ciip_flag = False
            return
        cu.ciip_flag = bool(self.d.decode_bin(ctx("CiipFlag")))

    def bdpcm_mode(self, cu: CU, comp: int):
        if not self._bdpcm_allowed(cu, comp):
            if comp == 0:
                cu.bdpcm_mode = 0
                if not self.is_dual_itree:
                    cu.bdpcm_mode_chroma = 0
            else:
                cu.bdpcm_mode_chroma = 0
            return
        ctx_id = 0 if comp == 0 else 2
        mode = self.d.decode_bin(ctx("BDPCMMode", ctx_id))
        if mode:
            mode += self.d.decode_bin(ctx("BDPCMMode", ctx_id + 1))
        if comp == 0:
            cu.bdpcm_mode = mode
        else:
            cu.bdpcm_mode_chroma = mode

    def _bdpcm_allowed(self, cu: CU, comp: int) -> bool:
        if not self.sps.bdpcm:
            return False
        ts_max = 1 << self.sps.log2_max_ts_size
        if comp == 0:
            return cu.lwidth <= ts_max and cu.lheight <= ts_max and cu.pred_mode == MODE_INTRA
        b = cu.blocks[1]
        return (
            b is not None and b.w <= ts_max and b.h <= ts_max and cu.pred_mode == MODE_INTRA
            and (cu.is_sep_tree or self.sps.chroma_format_idc == 3)
        )

    def mip_flag(self, cu: CU):
        if cu.blocks[0] is None:
            return
        if not self.sps.mip:
            cu.mip_flag = False
            return
        x, y = cu.lx, cu.ly
        left = self.cs.get_cu_restricted(x - 1, y, x, y, CH_L)
        above = self.cs.get_cu_restricted(x, y - 1, x, y, CH_L)
        c = (1 if (left and left.mip_flag) else 0) + (1 if (above and above.mip_flag) else 0)
        if cu.lwidth > 2 * cu.lheight or cu.lheight > 2 * cu.lwidth:
            c = 3
        cu.mip_flag = bool(self.d.decode_bin(ctx("MipFlag", c)))

    def intra_luma_pred_modes(self, cu: CU):
        if cu.blocks[0] is None:
            return
        if cu.bdpcm_mode:
            cu.intra_dir[0] = VER_IDX if cu.bdpcm_mode == 2 else HOR_IDX
            return
        self.mip_flag(cu)
        if cu.mip_flag:
            cu.mip_transposed = bool(self.d.decode_bin_ep())
            num_modes = self._num_mip_modes(cu.lwidth, cu.lheight)
            cu.intra_dir[0] = self._trunc_bin(num_modes)
            return
        self.extend_ref_line(cu)
        self.isp_mode(cu)
        if cu.multi_ref_idx:
            mpm_flag = True
        else:
            mpm_flag = bool(self.d.decode_bin(ctx("IntraLumaMpmFlag")))
        mpm = self._get_intra_mpms(cu)
        if mpm_flag:
            c = 0 if cu.isp_mode else 1
            if cu.multi_ref_idx == 0:
                idx = self.d.decode_bin(ctx("IntraLumaPlanarFlag", c))
            else:
                idx = 1
            if idx:
                idx += self.d.decode_bin_ep()
            if idx > 1:
                idx += self.d.decode_bin_ep()
            if idx > 2:
                idx += self.d.decode_bin_ep()
            if idx > 3:
                idx += self.d.decode_bin_ep()
            cu.intra_dir[0] = mpm[idx]
        else:
            mode = self._trunc_bin(NUM_LUMA_MODE - NUM_MPM)
            for m in sorted(mpm):
                if mode >= m:
                    mode += 1
            cu.intra_dir[0] = mode

    @staticmethod
    def _num_mip_modes(w: int, h: int) -> int:
        if w == 4 and h == 4:
            return 16
        if w == 4 or h == 4 or (w == 8 and h == 8):
            return 8
        return 6

    def extend_ref_line(self, cu: CU):
        if cu.blocks[0] is None or cu.pred_mode != MODE_INTRA or cu.ch_type != CH_L or cu.bdpcm_mode:
            cu.multi_ref_idx = 0
            return
        if not self.sps.mrl:
            cu.multi_ref_idx = 0
            return
        if (cu.blocks[0].y & (self.sps.ctu_size - 1)) == 0:
            cu.multi_ref_idx = 0
            return
        multi_ref_idx = 0
        if self.d.decode_bin(ctx("MultiRefLineIdx", 0)):
            multi_ref_idx = 1
            if self.d.decode_bin(ctx("MultiRefLineIdx", 1)):
                multi_ref_idx = 2
        cu.multi_ref_idx = multi_ref_idx

    def isp_mode(self, cu: CU):
        if (
            cu.pred_mode != MODE_INTRA
            or cu.ch_type != CH_L
            or cu.multi_ref_idx
            or not self.sps.isp
            or cu.bdpcm_mode
            or not self._can_use_isp(cu)
            or cu.color_transform
        ):
            cu.isp_mode = 0
            return
        if self.d.decode_bin(ctx("ISPMode", 0)):
            cu.isp_mode = 1 + self.d.decode_bin(ctx("ISPMode", 1))
        else:
            cu.isp_mode = 0

    def _can_use_isp(self, cu: CU) -> bool:
        max_tb = 1 << self.sps.log2_max_tb_size
        w, h = cu.lwidth, cu.lheight
        if w > max_tb or h > max_tb:
            return False
        if w * h <= 16:  # MIN_TB_SIZEY^2 * 2? (CU::canUseISP: area > minTb*minTb)
            return False
        return True

    def _get_intra_mpms(self, cu: CU) -> list[int]:
        b = cu.blocks[0]
        left_dir = above_dir = PLANAR_IDX
        # left at bottom-left, above at top-right (PU::getIntraMPMs)
        pl = self.cs.get_cu_restricted(b.x - 1, b.y1 - 1, b.x, b.y, CH_L)
        if pl and pl.pred_mode == MODE_INTRA:
            left_dir = PLANAR_IDX if pl.mip_flag else pl.intra_dir[0]
        pa = self.cs.get_cu_restricted(b.x1 - 1, b.y - 1, b.x, b.y, CH_L)
        if pa and pa.pred_mode == MODE_INTRA and self._same_ctu(cu, b.x1 - 1, b.y - 1):
            above_dir = PLANAR_IDX if pa.mip_flag else pa.intra_dir[0]
        offset = NUM_LUMA_MODE - 6
        mod = offset + 3
        mpm = [PLANAR_IDX, DC_IDX, VER_IDX, HOR_IDX, VER_IDX - 4, VER_IDX + 4]
        if left_dir == above_dir:
            if left_dir > DC_IDX:
                mpm = [
                    PLANAR_IDX,
                    left_dir,
                    ((left_dir + offset) % mod) + 2,
                    ((left_dir - 1) % mod) + 2,
                    ((left_dir + offset - 1) % mod) + 2,
                    (left_dir % mod) + 2,
                ]
        else:
            if left_dir > DC_IDX and above_dir > DC_IDX:
                mpm[0] = PLANAR_IDX
                mpm[1] = left_dir
                mpm[2] = above_dir
                mx = max(left_dir, above_dir)
                mn = min(left_dir, above_dir)
                if mx - mn == 1:
                    mpm[3] = ((mn + offset) % mod) + 2
                    mpm[4] = ((mx - 1) % mod) + 2
                    mpm[5] = ((mn + offset - 1) % mod) + 2
                elif mx - mn >= 62:
                    mpm[3] = ((mn - 1) % mod) + 2
                    mpm[4] = ((mx + offset) % mod) + 2
                    mpm[5] = (mn % mod) + 2
                elif mx - mn == 2:
                    mpm[3] = ((mn - 1) % mod) + 2
                    mpm[4] = ((mn + offset) % mod) + 2
                    mpm[5] = ((mx - 1) % mod) + 2
                else:
                    mpm[3] = ((mn + offset) % mod) + 2
                    mpm[4] = ((mn - 1) % mod) + 2
                    mpm[5] = ((mx + offset) % mod) + 2
            elif left_dir + above_dir >= 2:
                mx = max(left_dir, above_dir)
                mpm[0] = PLANAR_IDX
                mpm[1] = mx
                mpm[2] = ((mx + offset) % mod) + 2
                mpm[3] = ((mx - 1) % mod) + 2
                mpm[4] = ((mx + offset - 1) % mod) + 2
                mpm[5] = (mx % mod) + 2
        return mpm

    def _same_ctu(self, cu: CU, x: int, y: int) -> bool:
        size = self.sps.ctu_size
        return (cu.lx // size == x // size) and (cu.ly // size == y // size)

    def intra_chroma_pred_modes(self, cu: CU):
        if self.sps.chroma_format_idc == 0 or (cu.is_sep_tree and cu.ch_type == CH_L):
            return
        if cu.bdpcm_mode_chroma:
            cu.intra_dir[1] = VER_IDX if cu.bdpcm_mode_chroma == 2 else HOR_IDX
            return
        if cu.color_transform:
            cu.intra_dir[1] = DM_CHROMA_IDX
            return
        if self.sps.cclm and self._cclm_allowed(cu):
            if self.d.decode_bin(ctx("CclmModeFlag")):
                symbol = self.d.decode_bin(ctx("CclmModeIdx"))
                if symbol:
                    symbol += self.d.decode_bin_ep()
                cu.intra_dir[1] = [LM_CHROMA_IDX, MDLM_L_IDX, MDLM_T_IDX][symbol]
                return
        if self.d.decode_bin(ctx("IntraChromaPredMode")) == 0:
            cu.intra_dir[1] = DM_CHROMA_IDX
            return
        cand_id = self.d.decode_bins_ep(2)
        modes = self._chroma_cand_modes(cu)
        cu.intra_dir[1] = modes[cand_id]

    def _cclm_allowed(self, cu: CU) -> bool:
        """CU::checkCCLMAllowed (Unit.cpp)."""
        if not self.is_dual_itree:
            return True
        if self.sps.ctu_size <= 32:
            return True
        depth64 = 1 if self.sps.ctu_size == 128 else 0

        def split_at(series: tuple, d: int) -> int:
            return series[d] if d < len(series) else P.CU_DONT_SPLIT

        s1 = split_at(cu.split_series, depth64)
        s2 = split_at(cu.split_series, depth64 + 1)
        allow = False
        if s1 == P.CU_QUAD_SPLIT or (s1 == P.CU_HORZ_SPLIT and s2 == P.CU_VERT_SPLIT):
            allow = True
        elif s1 == P.CU_DONT_SPLIT:
            allow = True
        elif s1 == P.CU_HORZ_SPLIT and s2 == P.CU_DONT_SPLIT:
            allow = True
        if allow:
            fmt = self.cs.chroma_format
            lx = cu.blocks[1].x << fmt.scale_x
            ly = cu.blocks[1].y << fmt.scale_y
            col = self.cs.get_cu(lx, ly, CH_L)
            if col is None:
                return allow
            if col.lwidth < 64 or col.lheight < 64:
                if split_at(col.split_series, depth64) != P.CU_QUAD_SPLIT:
                    allow = False
            elif col.lwidth == 64 and col.lheight == 64 and col.isp_mode:
                allow = False
        return allow

    def _chroma_cand_modes(self, cu: CU) -> list[int]:
        modes = [PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX]
        if self._is_dm_chroma_mip(cu):
            return modes
        luma_mode = self._co_located_luma_mode(cu)
        for i in range(4):
            if luma_mode == modes[i]:
                modes[i] = VDIA_IDX
                break
        return modes

    def _co_located_luma_pu(self, cu: CU) -> CU | None:
        b = cu.blocks[1]
        fmt = self.cs.chroma_format
        if cu.is_sep_tree:
            cx = (b.x + (b.w >> 1)) << fmt.scale_x
            cy = (b.y + (b.h >> 1)) << fmt.scale_y
        else:
            cx = b.x << fmt.scale_x
            cy = b.y << fmt.scale_y
        return self.cs.get_cu(cx, cy, CH_L)

    def _is_dm_chroma_mip(self, cu: CU) -> bool:
        """PU::isDMChromaMIP — 4:4:4 single-tree only."""
        if cu.is_sep_tree or self.sps.chroma_format_idc != 3:
            return False
        luma = self._co_located_luma_pu(cu)
        return luma is not None and luma.mip_flag

    def _co_located_luma_mode(self, cu: CU) -> int:
        luma = self._co_located_luma_pu(cu)
        if luma is None:
            return PLANAR_IDX
        return PLANAR_IDX if luma.mip_flag else luma.intra_dir[0]

    # ==================================================================
    # residual
    # ==================================================================

    def cu_residual(self, cu: CU, part: P.Partitioner, cu_ctx: CuCtx):
        if cu.pred_mode != MODE_INTRA:
            if not cu.merge_flag:
                cu.root_cbf = bool(self.d.decode_bin(ctx("QtRootCbf")))
            else:
                cu.root_cbf = True
            if cu.root_cbf:
                self.sbt_mode(cu)
            if not cu.root_cbf:
                cu.color_transform = False
                self._add_empty_tus(cu, part)
                return
            if self.sps.act and not cu.is_sep_tree:
                cu.color_transform = bool(self.d.decode_bin(ctx("ACTFlag")))
        cu_ctx.violates_lfnst = [False, False]
        cu_ctx.lfnst_last_scan_pos = False
        cu_ctx.violates_mts = False
        cu_ctx.mts_last_scan_pos = False
        if cu.isp_mode and part.ch_type == CH_L:
            self._isp_transform_tree(cu, part, cu_ctx)
        else:
            self.transform_tree(cu, part, cu_ctx)
        self.residual_lfnst_mode(cu, cu_ctx)
        self.mts_idx(cu, cu_ctx)

    @staticmethod
    def isp_split_dim(w: int, h: int, horizontal: bool) -> int:
        """CU::getISPSplitDim (UnitTools.cpp:433)."""
        split_size = h if horizontal else w
        non_split = w if horizontal else h
        min_samples = 16
        factor = (min_samples >> (non_split.bit_length() - 1)) if non_split < min_samples else 1
        return max(split_size >> 2, factor)

    def isp_partitions(self, cu: CU) -> list[Rect]:
        b = cu.blocks[0]
        horizontal = cu.isp_mode == 1
        dim = self.isp_split_dim(b.w, b.h, horizontal)
        parts = []
        if horizontal:
            n = b.h // dim
            for i in range(n):
                parts.append(Rect(b.x, b.y + i * dim, b.w, dim))
        else:
            n = b.w // dim
            for i in range(n):
                parts.append(Rect(b.x + i * dim, b.y, dim, b.h))
        return parts

    def _isp_transform_tree(self, cu: CU, part: P.Partitioner, cu_ctx: CuCtx):
        parts = self.isp_partitions(cu)
        n = len(parts)
        has_chroma = (not cu.is_sep_tree) and cu.blocks[1] is not None
        for idx, sub in enumerate(parts):
            is_last = idx == n - 1
            blocks = [sub, None, None]
            if is_last and has_chroma:
                blocks[1] = Rect(cu.blocks[1].x, cu.blocks[1].y, cu.blocks[1].w, cu.blocks[1].h)
                blocks[2] = Rect(cu.blocks[2].x, cu.blocks[2].y, cu.blocks[2].w, cu.blocks[2].h)
            tu = TU(blocks=blocks, cu=cu, depth=1)
            for c in range(3):
                if blocks[c] is not None:
                    tu.coeffs[c] = np.zeros((blocks[c].h, blocks[c].w), dtype=np.int32)
            cu.tus.append(tu)
            self.cs.add_tu(tu)
            self._isp_transform_unit(tu, cu_ctx, part, idx, n)

    def _isp_transform_unit(self, tu: TU, cu_ctx: CuCtx, part: P.Partitioner,
                            sub_idx: int, n_tus: int):
        """transform_unit specialization for ISP sub-TUs."""
        cu = tu.cu
        tr_depth = tu.depth
        chroma_cbfs = [False, False]
        has_chroma = tu.blocks[1] is not None
        if has_chroma:
            chroma_cbfs[0] = bool(self.cbf_comp(tu.blocks[1], 1, False, False, cu))
            chroma_cbfs[1] = bool(self.cbf_comp(tu.blocks[2], 2, chroma_cbfs[0], False, cu))
            tu.cbf[1] = int(chroma_cbfs[0])
            tu.cbf[2] = int(chroma_cbfs[1])
        # luma cbf with inference on last sub-TU
        last_cbf_inferred = False
        prev_cbf = False
        if sub_idx == n_tus - 1:
            root_cbf_so_far = any(t.cbf[0] for t in cu.tus[:-1])
            if not root_cbf_so_far:
                last_cbf_inferred = True
        if not last_cbf_inferred:
            prev_cbf = bool(cu.tus[sub_idx - 1].cbf[0]) if sub_idx > 0 else False
        cbf_y = True if last_cbf_inferred else bool(
            self.cbf_comp(tu.blocks[0], 0, prev_cbf, True, cu)
        )
        tu.cbf[0] = int(cbf_y)
        cbf_chroma = chroma_cbfs[0] or chroma_cbfs[1]
        if (cu.lwidth > 64 or cu.lheight > 64 or cbf_y or cbf_chroma) and (
            not cu.is_sep_tree or part.ch_type == CH_L
        ):
            if self.pps.cu_qp_delta_enabled and not cu_ctx.is_dqp_coded:
                cu.qp = self.cu_qp_delta(cu, cu_ctx.qp)
                cu_ctx.qp = cu.qp
                cu_ctx.is_dqp_coded = True
        if not cu.is_sep_tree or part.ch_type == CH_C:
            if self.sh.use_chroma_qp_adj and cbf_chroma and not cu_ctx.is_chroma_qp_adj_coded:
                self._cu_chroma_qp_offset(cu)
                cu_ctx.is_chroma_qp_adj_coded = True
        if has_chroma:
            self.joint_cb_cr(tu, (2 if tu.cbf[1] else 0) + (1 if tu.cbf[2] else 0))
        if cbf_y:
            self.residual_coding(tu, 0, cu_ctx)
        if has_chroma:
            for comp in (1, 2):
                if tu.cbf[comp]:
                    self.residual_coding(tu, comp, cu_ctx)

    def transform_tree(self, cu: CU, part: P.Partitioner, cu_ctx: CuCtx):
        split = part.can_split(P.TU_MAX_TR_SPLIT)
        tr_depth = part.cur_tr_depth
        if not split and cu.sbt_info and tr_depth == 0:
            self._sbt_transform_tree(cu, part, cu_ctx)
            return
        if split:
            part.split_cur_area(P.TU_MAX_TR_SPLIT)
            while True:
                self.transform_tree(cu, part, cu_ctx)
                if not part.next_part():
                    break
            part.exit_cur_split()
            return
        # make TU — channel validity mirrors the CU's blocks
        luma = part.cur_area()
        chroma = part.cur_chroma()
        blocks = [
            Rect(luma.x, luma.y, luma.w, luma.h) if cu.blocks[0] is not None else None,
            Rect(chroma.x, chroma.y, chroma.w, chroma.h) if cu.blocks[1] is not None else None,
            Rect(chroma.x, chroma.y, chroma.w, chroma.h) if cu.blocks[2] is not None else None,
        ]
        tu = TU(blocks=blocks, cu=cu, depth=tr_depth)
        for c in range(3):
            if blocks[c] is not None:
                tu.coeffs[c] = np.zeros((blocks[c].h, blocks[c].w), dtype=np.int32)
        cu.tus.append(tu)
        self.cs.add_tu(tu)
        self.transform_unit(tu, cu_ctx, part)

    def _sbt_transform_tree(self, cu: CU, part: P.Partitioner, cu_ctx: CuCtx):
        """SBT TU tiling (PartitionerImpl::getSbtTuTiling,
        UnitPartitioner.cpp:1091) + per-TU noResidual
        (TransformUnit::checkTuNoResidual, Unit.cpp:832)."""
        sbt_idx = cu.sbt_info & 0xF
        sbt_pos = (cu.sbt_info >> 4) & 0x3
        luma = part.cur_area()
        chroma = part.cur_chroma()
        tiles = []
        for i in range(2):
            if sbt_idx in (3, 4):  # quad
                if sbt_idx == 4:  # HOR_QUAD
                    wf, xo = 4, 0
                    hf = 1 if ((i == 0 and sbt_pos == 0) or (i == 1 and sbt_pos == 1)) else 3
                    yo = 0 if i == 0 else (1 if sbt_pos == 0 else 3)
                else:  # VER_QUAD
                    wf = 1 if ((i == 0 and sbt_pos == 0) or (i == 1 and sbt_pos == 1)) else 3
                    xo = 0 if i == 0 else (1 if sbt_pos == 0 else 3)
                    hf, yo = 4, 0
            else:
                if sbt_idx == 2:  # HOR_HALF
                    wf, xo, hf, yo = 4, 0, 2, (0 if i == 0 else 2)
                else:  # VER_HALF
                    wf, xo, hf, yo = 2, (0 if i == 0 else 2), 4, 0

            def tile(b):
                if b is None:
                    return None
                return Rect(
                    b.x + ((b.w * xo) >> 2), b.y + ((b.h * yo) >> 2),
                    (b.w * wf) >> 2, (b.h * hf) >> 2,
                )

            tiles.append((tile(luma), tile(chroma)))
        for idx, (lt, ct) in enumerate(tiles):
            blocks = [
                lt if cu.blocks[0] is not None else None,
                Rect(ct.x, ct.y, ct.w, ct.h) if cu.blocks[1] is not None else None,
                Rect(ct.x, ct.y, ct.w, ct.h) if cu.blocks[2] is not None else None,
            ]
            tu = TU(blocks=blocks, cu=cu, depth=1)
            tu.no_residual = (sbt_pos == 0 and idx == 1) or (sbt_pos == 1 and idx == 0)
            for c in range(3):
                if blocks[c] is not None:
                    tu.coeffs[c] = np.zeros((blocks[c].h, blocks[c].w), dtype=np.int32)
            cu.tus.append(tu)
            self.cs.add_tu(tu)
            self.transform_unit(tu, cu_ctx, part)

    def cbf_comp(self, area: Rect, comp: int, prev_cbf: bool, use_isp: bool, cu: CU) -> int:
        if use_isp and comp == 0:
            c = 2 + int(prev_cbf)
        elif comp == 2:
            c = 1 if prev_cbf else 0
        else:
            c = 0
        if (comp == 0 and cu.bdpcm_mode) or (comp != 0 and cu.bdpcm_mode_chroma):
            c = 1 if comp in (0, 1) else 2
        return self.d.decode_bin(ctx(f"QtCbf_{comp}", c))

    def transform_unit(self, tu: TU, cu_ctx: CuCtx, part: P.Partitioner):
        cu = tu.cu
        tr_depth = tu.depth
        chroma_cbfs = [False, False]
        has_chroma_blocks = (
            self.sps.chroma_format_idc != 0 and tu.blocks[1] is not None
        )
        chroma_cbf_isp = has_chroma_blocks and cu.isp_mode
        if has_chroma_blocks and (not cu.is_sep_tree or part.ch_type == CH_C) and (
            not cu.isp_mode or chroma_cbf_isp
        ):
            cbf_depth = tr_depth - 1 if chroma_cbf_isp else tr_depth
            if not (cu.sbt_info and tu.no_residual):
                chroma_cbfs[0] = bool(self.cbf_comp(tu.blocks[1], 1, False, False, cu))
                chroma_cbfs[1] = bool(self.cbf_comp(tu.blocks[2], 2, chroma_cbfs[0], False, cu))
        if part.ch_type == CH_L:
            sig_chroma = chroma_cbfs[0] or chroma_cbfs[1]
            if cu.pred_mode != MODE_INTRA and tr_depth == 0 and not sig_chroma:
                # inter root TU with no chroma cbf: luma cbf inferred 1
                tu.cbf[0] = 1
            elif cu.sbt_info and tu.no_residual:
                tu.cbf[0] = 0
            elif cu.sbt_info and not sig_chroma:
                tu.cbf[0] = 1
            else:
                cbf_y = bool(self.cbf_comp(tu.blocks[0], 0, False, bool(cu.isp_mode), cu))
                tu.cbf[0] = int(cbf_y)
        if has_chroma_blocks and (not cu.isp_mode or chroma_cbf_isp):
            tu.cbf[1] = int(chroma_cbfs[0])
            tu.cbf[2] = int(chroma_cbfs[1])
        luma_only = self.sps.chroma_format_idc == 0 or tu.blocks[1] is None
        cbf_luma = tu.cbf[0] != 0
        cbf_chroma = (not luma_only) and (tu.cbf[1] or tu.cbf[2])
        if (cu.lwidth > 64 or cu.lheight > 64 or cbf_luma or cbf_chroma) and (
            not cu.is_sep_tree or part.ch_type == CH_L
        ):
            if self.pps.cu_qp_delta_enabled and not cu_ctx.is_dqp_coded:
                cu.qp = self.cu_qp_delta(cu, cu_ctx.qp)
                cu_ctx.qp = cu.qp
                cu_ctx.is_dqp_coded = True
        if not cu.is_sep_tree or part.ch_type == CH_C:
            if cu.is_sep_tree:
                ch_w, ch_h = cu.blocks[1].w, cu.blocks[1].h
            else:
                ch_w, ch_h = cu.lwidth, cu.lheight
            if self.sh.use_chroma_qp_adj and (
                ch_w > 64 or ch_h > 64 or cbf_chroma
            ) and not cu_ctx.is_chroma_qp_adj_coded:
                self._cu_chroma_qp_offset(cu)
                cu_ctx.is_chroma_qp_adj_coded = True
        if not luma_only:
            self.joint_cb_cr(tu, (2 if tu.cbf[1] else 0) + (1 if tu.cbf[2] else 0))
        if cbf_luma:
            self.residual_coding(tu, 0, cu_ctx)
        if not luma_only:
            for comp in (1, 2):
                if tu.cbf[comp]:
                    self.residual_coding(tu, comp, cu_ctx)

    def joint_cb_cr(self, tu: TU, cbf_mask: int):
        if not self.sps.joint_cbcr:
            return
        cu = tu.cu
        if (cu.pred_mode == MODE_INTRA and cbf_mask) or cbf_mask == 3:
            tu.joint_cbcr = (
                cbf_mask if self.d.decode_bin(ctx("JointCbCrFlag", cbf_mask - 1)) else 0
            )

    def cu_qp_delta(self, cu: CU, pred_qp: int) -> int:
        qp_y = pred_qp
        dqp = self._unary_max_symbol(ctx("DeltaQP", 0), ctx("DeltaQP", 1), CU_DQP_TU_CMAX)
        if dqp >= CU_DQP_TU_CMAX:
            dqp += self._exp_golomb_eqprob(CU_DQP_EG_K)
        if dqp > 0:
            if self.d.decode_bin_ep():
                dqp = -dqp
            off = self.sps.qp_bd_offset
            qp_y = ((pred_qp + dqp + 64 + 2 * off) % (64 + off)) - off
        return qp_y

    def _cu_chroma_qp_offset(self, cu: CU):
        length = len(self.pps.chroma_qp_offset_list)
        adj = self.d.decode_bin(ctx("ChromaQpAdjFlag"))
        if adj and length > 1:
            adj += self._unary_max_symbol(
                ctx("ChromaQpAdjIdc"), ctx("ChromaQpAdjIdc"), length - 1
            )
        cu.chroma_qp_adj = adj
        self.chroma_adj = adj

    def _predict_qp(self, cu: CU, prev_qp: int) -> int:
        """CU::predictQP."""
        ch = cu.ch_type
        comp = 0 if ch == CH_L else 1
        b = cu.blocks[comp]
        fmt = self.cs.chroma_format
        sx = fmt.scale_x if ch == CH_C else 0
        sy = fmt.scale_y if ch == CH_C else 0
        mask_w = (self.sps.ctu_size - 1) >> sx
        mask_h = (self.sps.ctu_size - 1) >> sy
        ctu_x = cu.lx >> self.sps.log2_ctu_size
        tile_col = self.pps.ctu_to_tile_col[ctu_x]
        tile_x_pos = self.pps.tile_col_bd[tile_col]
        above = self.cs.get_cu(b.x, b.y - 1, ch)
        if (
            ctu_x == tile_x_pos
            and not (b.x & mask_w)
            and not (b.y & mask_h)
            and above is not None
            and above.slice_idx == self.cs.cur_slice_idx
            and above.tile_idx == self.cs.tile_idx_at(cu.lx, cu.ly)
        ):
            return above.qp
        a = self.cs.get_cu(b.x, b.y - 1, ch).qp if (b.y & mask_h) else prev_qp
        bb = self.cs.get_cu(b.x - 1, b.y, ch).qp if (b.x & mask_w) else prev_qp
        return (a + bb + 1) >> 1

    def end_of_ctu(self, cu: CU, cu_ctx: CuCtx):
        comp = 0 if cu.ch_type == CH_L else 1
        b = cu.blocks[comp]
        fmt = self.cs.chroma_format
        sx = fmt.scale_x if cu.ch_type == CH_C else 0
        sy = fmt.scale_y if cu.ch_type == CH_C else 0
        rb_x = b.x1 << sx
        rb_y = b.y1 << sy
        mask = self.sps.ctu_size - 1
        if (
            ((rb_x & mask) == 0 or rb_x == self.pps.pic_width)
            and ((rb_y & mask) == 0 or rb_y == self.pps.pic_height)
            and (not cu.is_sep_tree or self.sps.chroma_format_idc == 0 or cu.ch_type == CH_C)
        ):
            cu_ctx.is_dqp_coded = self.pps.cu_qp_delta_enabled and not cu_ctx.is_dqp_coded

    # -- transform skip / mts / lfnst --------------------------------------

    def ts_flag(self, tu: TU, comp: int):
        cu = tu.cu
        ts = 1 if ((cu.bdpcm_mode and comp == 0) or (cu.bdpcm_mode_chroma and comp != 0)) else (
            1 if tu.mts_idx[comp] == MTS_SKIP else 0
        )
        ctx_idx = 0 if comp == 0 else 1
        if self._is_ts_allowed(tu, comp):
            ts = self.d.decode_bin(ctx("TransformSkipFlag", ctx_idx))
        tu.mts_idx[comp] = MTS_SKIP if ts else MTS_DCT2_DCT2

    def _is_ts_allowed(self, tu: TU, comp: int) -> bool:
        if not self.sps.transform_skip:
            return False
        cu = tu.cu
        if cu.isp_mode and comp == 0:
            return False
        if cu.sbt_info:  # all components (UnitTools.cpp:3819)
            return False
        ts_max = 1 << self.sps.log2_max_ts_size
        b = tu.blocks[comp]
        if (cu.bdpcm_mode and comp == 0) or (cu.bdpcm_mode_chroma and comp != 0):
            return False  # ts flag inferred 1, not signalled
        return b.w <= ts_max and b.h <= ts_max

    def mts_idx(self, cu: CU, cu_ctx: CuCtx):
        tu = cu.tus[0]
        mts = tu.mts_idx[0]
        if (
            self._is_mts_allowed(cu)
            and not cu_ctx.violates_mts
            and cu_ctx.mts_last_scan_pos
            and cu.lfnst_idx == 0
            and mts != MTS_SKIP
        ):
            symbol = self.d.decode_bin(ctx("MTSIdx", 0))
            if symbol:
                mts = MTS_DST7_DST7
                for i in range(1, 4):
                    symbol = self.d.decode_bin(ctx("MTSIdx", i))
                    mts += symbol
                    if not symbol:
                        break
        tu.mts_idx[0] = mts

    def _is_mts_allowed(self, cu: CU) -> bool:
        """CU::isMTSAllowed for luma."""
        if self.sps.chroma_format_idc == 0:
            return False
        if cu.pred_mode == MODE_INTRA:
            if not (self.sps.mts and self.sps.explicit_mts_intra):
                return False
        else:
            if not (self.sps.mts and self.sps.explicit_mts_inter):
                return False
        if cu.lwidth > 32 or cu.lheight > 32:
            return False
        if cu.isp_mode or cu.sbt_info:
            return False
        return True

    def residual_lfnst_mode(self, cu: CU, cu_ctx: CuCtx):
        ch_idx = 1 if (cu.is_sep_tree and cu.ch_type == CH_C) else 0
        if cu.isp_mode and not self._can_lfnst_with_isp(cu):
            return
        if (
            self.sps.lfnst
            and cu.pred_mode == MODE_INTRA
            and cu.mip_flag
            and not (cu.lwidth >= 16 and cu.lheight >= 16)
        ):
            return
        if cu.is_sep_tree and cu.ch_type == CH_C and min(
            cu.blocks[1].w, cu.blocks[1].h
        ) < 4:
            return
        ref = cu.blocks[ch_idx]
        ref_lw = ref.w << (self.cs.chroma_format.scale_x if ch_idx else 0)
        ref_lh = ref.h << (self.cs.chroma_format.scale_y if ch_idx else 0)
        max_tb = 1 << self.sps.log2_max_tb_size
        if ref_lw > max_tb or ref_lh > max_tb:
            return
        if self.sps.lfnst and cu.pred_mode == MODE_INTRA:
            luma_flag = (cu.ch_type == CH_L) if cu.is_sep_tree else True
            chroma_flag = (cu.ch_type == CH_C) if cu.is_sep_tree else True
            non_zero_corner = (luma_flag and cu_ctx.violates_lfnst[0]) or (
                chroma_flag and cu_ctx.violates_lfnst[1]
            )
            is_tr_skip = False
            for tu in cu.tus:
                for comp in range(3):
                    if (
                        tu.blocks[comp] is not None
                        and tu.cbf[comp]
                        and tu.mts_idx[comp] == MTS_SKIP
                    ):
                        is_tr_skip = True
                        break
            if (not cu_ctx.lfnst_last_scan_pos and not cu.isp_mode) or non_zero_corner or is_tr_skip:
                cu.lfnst_idx = 0
                return
        else:
            cu.lfnst_idx = 0
            return
        c = 1 if cu.is_sep_tree else 0
        idx = self.d.decode_bin(ctx("LFNSTIdx", c))
        if idx:
            idx += self.d.decode_bin(ctx("LFNSTIdx", 2))
        cu.lfnst_idx = idx

    def _can_lfnst_with_isp(self, cu: CU) -> bool:
        """CU::canUseLfnstWithISP (UnitTools.cpp:410)."""
        comp = 0 if cu.ch_type == CH_L else 1
        b = cu.blocks[comp]
        if cu.isp_mode == 1:  # horizontal
            tw, th = b.w, self.isp_split_dim(b.w, b.h, True)
        else:
            tw, th = self.isp_split_dim(b.w, b.h, False), b.h
        return tw >= 4 and th >= 4

    # -- residual coefficients ---------------------------------------------

    def residual_coding(self, tu: TU, comp: int, cu_ctx: CuCtx):
        cu = tu.cu
        if comp == 2 and tu.joint_cbcr == 3:
            return
        self.ts_flag(tu, comp)
        # explicit rdpcm: inter-only, skip
        if tu.mts_idx[comp] == MTS_SKIP and not self.sh.ts_residual_coding_disabled:
            if self._rc_native:
                self._residual_coding_ts_native(tu, comp)
            else:
                self.residual_coding_ts(tu, comp)
            return
        if self._rc_native:
            self._residual_coding_native(tu, comp, cu_ctx)
            return
        sign_hiding = self.sh.sign_data_hiding
        cctx = CoeffCtx(tu, comp, sign_hiding, self.sps)
        coeff = tu.coeffs[comp]
        last = self.last_sig_coeff(cctx, tu, comp)
        cctx.scan_pos_last = last
        b = tu.blocks[comp]
        if tu.mts_idx[comp] != MTS_SKIP and b.h >= 4 and b.w >= 4:
            max_lfnst_pos = 7 if ((b.h == 4 and b.w == 4) or (b.h == 8 and b.w == 8)) else 15
            cu_ctx.violates_lfnst[0 if comp == 0 else 1] |= last > max_lfnst_pos
            cu_ctx.lfnst_last_scan_pos |= last >= LFNST_LAST_SIG_LUMA
        if comp == 0 and tu.mts_idx[comp] != MTS_SKIP:
            cu_ctx.mts_last_scan_pos |= last >= 1
        state_trans = 32040 if self.sh.dep_quant else 0
        state = 0
        ratio = MAX_CTX_BIN_RATIO_LUMA if comp == 0 else MAX_CTX_BIN_RATIO_CHROMA
        cctx.reg_bin_limit = (self._tb_area_after_zero_out(tu, comp) * ratio) >> 4
        flat = coeff.ravel()
        for subset in range(last >> cctx.log2_cg_size, -1, -1):
            cctx.init_subblock(subset)
            if (
                self.sps.mts
                and cu.sbt_info
                and b.h <= 32
                and b.w <= 32
                and comp == 0
            ):
                if (b.h == 32 and cctx.cg_pos_y >= (16 >> cctx.log2_cg_h)) or (
                    b.w == 32 and cctx.cg_pos_x >= (16 >> cctx.log2_cg_w)
                ):
                    continue
            state = self.residual_coding_subblock(cctx, flat, state_trans, state)
            if comp == 0 and cctx.sig_group_flags[cctx.sub_set_pos] and (
                cctx.cg_pos_y > 3 or cctx.cg_pos_x > 3
            ):
                cu_ctx.violates_mts = True

    def _residual_coding_native(self, tu: TU, comp: int, cu_ctx: CuCtx):
        """Native-engine fast path: last_sig_coeff + all subblock passes run
        in C (vtm_jax/native/cabac.c nc_rc_block), bit-exact with the Python
        path below."""
        cu = tu.cu
        b = tu.blocks[comp]
        ch = 0 if comp == 0 else 1
        st = _rc_static(b.w, b.h, ch)
        max_x, max_y = st[4], st[5]
        sbt_adj = bool(
            self.sps.mts and cu.sbt_info and b.w <= 32 and b.h <= 32 and comp == 0
        )
        if sbt_adj:
            if b.w == 32:
                max_x = int(_GROUP_IDX[15])
            if b.h == 32:
                max_y = int(_GROUP_IDX[15])
        state_trans = 32040 if self.sh.dep_quant else 0
        ratio = MAX_CTX_BIN_RATIO_LUMA if comp == 0 else MAX_CTX_BIN_RATIO_CHROMA
        reg_bin_limit = (self._tb_area_after_zero_out(tu, comp) * ratio) >> 4
        flat = tu.coeffs[comp].ravel()
        last, viol_mts = self.d.rc_block(
            flat, st[0], st[1], b.w, b.h, st[2], st[3], ch,
            int(self.sh.sign_data_hiding), state_trans, reg_bin_limit,
            int(sbt_adj), max_x, max_y, st[6], st[7], st[8], st[9],
            st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
            st[18],
        )
        if tu.mts_idx[comp] != MTS_SKIP and b.h >= 4 and b.w >= 4:
            max_lfnst_pos = 7 if ((b.h == 4 and b.w == 4) or (b.h == 8 and b.w == 8)) else 15
            cu_ctx.violates_lfnst[0 if comp == 0 else 1] |= last > max_lfnst_pos
            cu_ctx.lfnst_last_scan_pos |= last >= LFNST_LAST_SIG_LUMA
        if comp == 0 and tu.mts_idx[comp] != MTS_SKIP:
            cu_ctx.mts_last_scan_pos |= last >= 1
        if viol_mts:
            cu_ctx.violates_mts = True

    def _residual_coding_ts_native(self, tu: TU, comp: int):
        cu = tu.cu
        bdpcm = cu.bdpcm_mode if comp == 0 else cu.bdpcm_mode_chroma
        b = tu.blocks[comp]
        st = _rc_static(b.w, b.h, 0 if comp == 0 else 1)
        flat = tu.coeffs[comp].ravel()
        self.d.rc_block_ts(
            flat, st[0], st[1], b.w, b.h, st[2], st[3], int(bdpcm), *_TS_BASES
        )

    def _tb_area_after_zero_out(self, tu: TU, comp: int) -> int:
        b = tu.blocks[comp]
        w = min(JVET_C0024_ZERO_OUT_TH, b.w)
        h = min(JVET_C0024_ZERO_OUT_TH, b.h)
        return w * h

    def last_sig_coeff(self, cctx: "CoeffCtx", tu: TU, comp: int) -> int:
        pos_x = 0
        pos_y = 0
        max_x = cctx.max_last_pos_x
        max_y = cctx.max_last_pos_y
        if (
            self.sps.mts
            and tu.cu.sbt_info
            and tu.blocks[comp].w <= 32
            and tu.blocks[comp].h <= 32
            and comp == 0
        ):
            if tu.blocks[comp].w == 32:
                max_x = int(_GROUP_IDX[15])
            if tu.blocks[comp].h == 32:
                max_y = int(_GROUP_IDX[15])
        while pos_x < max_x and self.d.decode_bin(cctx.last_x_ctx_id(pos_x)):
            pos_x += 1
        while pos_y < max_y and self.d.decode_bin(cctx.last_y_ctx_id(pos_y)):
            pos_y += 1
        if pos_x > 3:
            n = (pos_x - 2) >> 1
            tmp = 0
            for i in range(n - 1, -1, -1):
                tmp += self.d.decode_bin_ep() << i
            pos_x = int(_MIN_IN_GROUP[pos_x]) + tmp
        if pos_y > 3:
            n = (pos_y - 2) >> 1
            tmp = 0
            for i in range(n - 1, -1, -1):
                tmp += self.d.decode_bin_ep() << i
            pos_y = int(_MIN_IN_GROUP[pos_y]) + tmp
        blk_pos = pos_x + pos_y * cctx.width
        # invert scan
        return int(cctx.scan_blkpos_to_scanpos[blk_pos])

    def residual_coding_subblock(self, cctx: "CoeffCtx", coeff: np.ndarray,
                                 state_trans: int, state: int) -> int:
        d = self.d
        min_sub_pos = cctx.min_sub_pos
        is_last = cctx.is_last()
        first_sig_pos = cctx.scan_pos_last if is_last else cctx.max_sub_pos
        next_sig_pos = first_sig_pos
        sig_group = is_last or cctx.sub_set_id == 0
        if not sig_group:
            sig_group = bool(d.decode_bin(cctx.sig_group_ctx_id()))
        if sig_group:
            cctx.sig_group_flags[cctx.sub_set_pos] = True
        else:
            return state
        ctx_off = [0] * 16
        infer_sig_pos = (
            (min_sub_pos if cctx.sub_set_id != 0 else -1)
            if next_sig_pos != cctx.scan_pos_last
            else next_sig_pos
        )
        first_nz = next_sig_pos
        last_nz = -1
        num_nonzero = 0
        rem_reg_bins = cctx.reg_bin_limit
        sig_blk_pos = [0] * 16
        pos = next_sig_pos
        while pos >= min_sub_pos and rem_reg_bins >= 4:
            blk_pos = cctx.blockpos(pos)
            sig = int(num_nonzero == 0 and pos == infer_sig_pos)
            if not sig:
                sig_ctx = cctx.sig_ctx_id_abs(pos, coeff, state)
                sig = d.decode_bin(sig_ctx)
                rem_reg_bins -= 1
            elif pos != cctx.scan_pos_last:
                cctx.sig_ctx_id_abs(pos, coeff, state)
            if sig:
                off = cctx.ctx_offset_abs()
                ctx_off[pos - min_sub_pos] = off
                sig_blk_pos[num_nonzero] = blk_pos
                num_nonzero += 1
                first_nz = pos
                last_nz = max(last_nz, pos)
                gt1 = d.decode_bin(cctx.gt1_ctx_id(off))
                rem_reg_bins -= 1
                par = 0
                gt2 = 0
                if gt1:
                    par = d.decode_bin(cctx.par_ctx_id(off))
                    rem_reg_bins -= 1
                    gt2 = d.decode_bin(cctx.gt2_ctx_id(off))
                    rem_reg_bins -= 1
                coeff[blk_pos] += 1 + par + gt1 + (gt2 << 1)
            state = (state_trans >> ((state << 2) + ((int(coeff[blk_pos]) & 1) << 1))) & 3
            pos -= 1
        first_pos_mode2 = pos
        cctx.reg_bin_limit = rem_reg_bins
        # 2nd pass: go-rice for >= 4
        for scan_pos in range(first_sig_pos, first_pos_mode2, -1):
            sum_all = cctx.template_abs_sum(scan_pos, coeff, 4)
            rice = int(_GO_RICE_PARS[sum_all])
            blk_pos = cctx.blockpos(scan_pos)
            if coeff[blk_pos] >= 4:
                rem = d.decode_rem_abs_ep(rice, COEF_REMAIN_BIN_REDUCTION, 15)
                coeff[blk_pos] += rem << 1
        # bypass pass
        for scan_pos in range(first_pos_mode2, min_sub_pos - 1, -1):
            sum_all = cctx.template_abs_sum(scan_pos, coeff, 0)
            rice = int(_GO_RICE_PARS[sum_all])
            pos0 = (1 if state < 2 else 2) << rice
            rem = d.decode_rem_abs_ep(rice, COEF_REMAIN_BIN_REDUCTION, 15)
            tcoeff = 0 if rem == pos0 else (rem + 1 if rem < pos0 else rem)
            state = (state_trans >> ((state << 2) + ((tcoeff & 1) << 1))) & 3
            if tcoeff:
                blk_pos = cctx.blockpos(scan_pos)
                sig_blk_pos[num_nonzero] = blk_pos
                num_nonzero += 1
                first_nz = scan_pos
                last_nz = max(last_nz, scan_pos)
                coeff[blk_pos] = tcoeff
        # signs
        hide = cctx.sign_hiding and (last_nz - first_nz >= SBH_THRESHOLD)
        num_signs = num_nonzero - 1 if hide else num_nonzero
        sign_pattern = d.decode_bins_ep(num_signs) << (32 - num_signs) if num_signs else 0
        sum_abs = 0
        for k in range(num_signs):
            abs_c = int(coeff[sig_blk_pos[k]])
            sum_abs += abs_c
            if sign_pattern & (1 << 31):
                coeff[sig_blk_pos[k]] = -abs_c
            sign_pattern = (sign_pattern << 1) & 0xFFFFFFFF
        if num_nonzero > num_signs:
            abs_c = int(coeff[sig_blk_pos[num_signs]])
            sum_abs += abs_c
            if sum_abs & 1:
                coeff[sig_blk_pos[num_signs]] = -abs_c
        return state

    def residual_coding_ts(self, tu: TU, comp: int):
        """residual_codingTS (CABACReader.cpp:3358)."""
        cu = tu.cu
        bdpcm = cu.bdpcm_mode if comp == 0 else cu.bdpcm_mode_chroma
        cctx = CoeffCtx(tu, comp, False, self.sps, bdpcm=bdpcm)
        coeff = tu.coeffs[comp].ravel()
        cctx.num_ctx_bins = (cctx.max_num_coeff * 7) >> 2
        for subset in range(((cctx.max_num_coeff - 1) >> cctx.log2_cg_size) + 1):
            cctx.init_subblock(subset)
            self._residual_coding_subblock_ts(cctx, coeff)

    def _residual_coding_subblock_ts(self, cctx: "CoeffCtx", coeff: np.ndarray):
        d = self.d
        min_sub_pos = cctx.max_sub_pos  # NB: reversed roles vs regular RC
        first_sig_pos = cctx.min_sub_pos
        next_sig = first_sig_pos
        sign_pattern = 0
        is_last_subset = cctx.sub_set_id == (cctx.max_num_coeff - 1) >> cctx.log2_cg_size
        sig_group = is_last_subset and not cctx.sig_group_flags.any()
        if not sig_group:
            sig_group = bool(d.decode_bin(cctx.sig_group_ctx_id_ts()))
        if sig_group:
            cctx.sig_group_flags[cctx.sub_set_pos] = True
        else:
            return
        infer_sig_pos = min_sub_pos
        num_nonzero = 0
        sig_blk_pos = [0] * 16
        last_pass1 = -1
        last_pass2 = -1
        pos = next_sig
        while pos <= min_sub_pos and cctx.num_ctx_bins >= 4:
            blk_pos = cctx.blockpos(pos)
            sig = int(num_nonzero == 0 and pos == infer_sig_pos)
            if not sig:
                sig = d.decode_bin(cctx.sig_ctx_id_ts(pos, coeff))
                cctx.num_ctx_bins -= 1
            if sig:
                sign = d.decode_bin(cctx.sign_ctx_id_ts(pos, coeff))
                cctx.num_ctx_bins -= 1
                sign_pattern += sign << num_nonzero
                sig_blk_pos[num_nonzero] = blk_pos
                num_nonzero += 1
                gt1 = d.decode_bin(cctx.lrg1_ctx_id_ts(pos, coeff))
                cctx.num_ctx_bins -= 1
                par = 0
                if gt1:
                    par = d.decode_bin(cctx.par_ctx_id_ts())
                    cctx.num_ctx_bins -= 1
                coeff[blk_pos] = (-1 if sign else 1) * (1 + par + gt1)
            last_pass1 = pos
            pos += 1
        # 2nd pass: gt2 bins
        pos = first_sig_pos
        while pos <= min_sub_pos and cctx.num_ctx_bins >= 4:
            blk_pos = cctx.blockpos(pos)
            cutoff = 2
            for i in range(4):
                if coeff[blk_pos] < 0:
                    coeff[blk_pos] = -coeff[blk_pos]
                if coeff[blk_pos] >= cutoff:
                    gt2 = d.decode_bin(cctx.gtx_ctx_id_ts(cutoff >> 1))
                    coeff[blk_pos] += gt2 << 1
                    cctx.num_ctx_bins -= 1
                cutoff += 2
            last_pass2 = pos
            pos += 1
        # 3rd pass: rice remainders + trailing sig/sign
        for pos in range(first_sig_pos, min_sub_pos + 1):
            blk_pos = cctx.blockpos(pos)
            cutoff = 10 if pos <= last_pass2 else (2 if pos <= last_pass1 else 0)
            if coeff[blk_pos] < 0:
                coeff[blk_pos] = -coeff[blk_pos]
            if coeff[blk_pos] >= cutoff:
                rice = 1  # templateAbsSumTS returns 1
                rem = d.decode_rem_abs_ep(rice, COEF_REMAIN_BIN_REDUCTION, 15)
                coeff[blk_pos] += (rem << 1) if pos <= last_pass1 else rem
                if coeff[blk_pos] and pos > last_pass1:
                    sign = d.decode_bin_ep()
                    sign_pattern += sign << num_nonzero
                    sig_blk_pos[num_nonzero] = blk_pos
                    num_nonzero += 1
            if not cctx.bdpcm and cutoff:
                if coeff[blk_pos] > 0:
                    right, below = cctx.neigh_ts(pos, coeff)
                    coeff[blk_pos] = cctx.dec_derive_mod_coeff(right, below, int(coeff[blk_pos]))
        for k in range(num_nonzero):
            abs_c = int(coeff[sig_blk_pos[k]])
            coeff[sig_blk_pos[k]] = -abs_c if (sign_pattern & 1) else abs_c
            sign_pattern >>= 1

    # -- primitive codes ----------------------------------------------------

    def _unary_max_symbol(self, ctx0: int, ctx_n: int, max_symbol: int) -> int:
        ones = 0
        while ones < max_symbol and self.d.decode_bin(ctx0 if ones == 0 else ctx_n):
            ones += 1
        return ones

    def _unary_max_eqprob(self, max_symbol: int) -> int:
        for k in range(max_symbol):
            if not self.d.decode_bin_ep():
                return k
        return max_symbol

    def _exp_golomb_eqprob(self, count: int) -> int:
        symbol = 0
        bit = 1
        while bit:
            bit = self.d.decode_bin_ep()
            symbol += bit << count
            count += 1
        count -= 1
        if count:
            symbol += self.d.decode_bins_ep(count)
        return symbol

    def _trunc_bin(self, max_symbol: int) -> int:
        thresh = max_symbol.bit_length() - 1
        val = 1 << thresh
        b = max_symbol - val
        symbol = self.d.decode_bins_ep(thresh)
        if symbol >= val - b:
            symbol = (symbol << 1) + self.d.decode_bin_ep() - (val - b)
        return symbol

    def terminating_bit(self) -> int:
        return self.d.decode_bin_trm()


class CoeffCtx:
    """CoeffCodingContext equivalent (ContextModelling.h:51)."""

    def __init__(self, tu: TU, comp: int, sign_hiding: bool, sps, bdpcm: int = 0):
        self.bdpcm = bdpcm
        self.num_ctx_bins = 0
        b = tu.blocks[comp]
        self.comp = comp
        self.ch = 0 if comp == 0 else 1
        self.width = b.w
        self.height = b.h
        log2w = b.w.bit_length() - 1
        log2h = b.h.bit_length() - 1
        self.log2_cg_w, self.log2_cg_h = rom.log2_sbb_size(log2w, log2h)
        self.log2_cg_size = self.log2_cg_w + self.log2_cg_h
        self.width_in_groups = min(JVET_C0024_ZERO_OUT_TH, b.w) >> self.log2_cg_w
        self.height_in_groups = min(JVET_C0024_ZERO_OUT_TH, b.h) >> self.log2_cg_h
        self.max_num_coeff = b.w * b.h
        self.sign_hiding = sign_hiding
        self.scan = rom.scan(1, b.w, b.h)  # grouped 4x4, (N,3): idx,x,y
        self.scan_cg = rom.scan(0, self.width_in_groups, self.height_in_groups)
        self.scan_blkpos_to_scanpos = np.zeros(self.max_num_coeff, dtype=np.int64)
        self.scan_blkpos_to_scanpos[self.scan[:, 0]] = np.arange(len(self.scan))
        self.max_last_pos_x = int(_GROUP_IDX[min(JVET_C0024_ZERO_OUT_TH, b.w) - 1])
        self.max_last_pos_y = int(_GROUP_IDX[min(JVET_C0024_ZERO_OUT_TH, b.h) - 1])
        if self.ch == 1:
            self.last_offset_x = 0
            self.last_offset_y = 0
            self.last_shift_x = min(max(0, b.w >> 3), 2)
            self.last_shift_y = min(max(0, b.h >> 3), 2)
        else:
            prefix_ctx = [0, 0, 0, 3, 6, 10, 15, 21]
            self.last_offset_x = prefix_ctx[log2w]
            self.last_offset_y = prefix_ctx[log2h]
            self.last_shift_x = (log2w + 1) >> 2
            self.last_shift_y = (log2h + 1) >> 2
        ch = self.ch
        self.ctx_last_x = _CTXOFF[f"LastX_{ch}"][0]
        self.ctx_last_y = _CTXOFF[f"LastY_{ch}"][0]
        self.sig_flag_sets = [
            _CTXOFF[f"SigFlag_{ch}"][0],
            _CTXOFF[f"SigFlag_{ch + 2}"][0],
            _CTXOFF[f"SigFlag_{ch + 4}"][0],
        ]
        self.par_flag_set = _CTXOFF[f"ParFlag_{ch}"][0]
        self.gtx_flag_sets = [_CTXOFF[f"GtxFlag_{ch}"][0], _CTXOFF[f"GtxFlag_{ch + 2}"][0]]
        self.sig_cg_set = _CTXOFF[f"SigCoeffGroup_{ch}"][0]
        self.sig_group_flags = np.zeros(
            self.width_in_groups * self.height_in_groups, dtype=bool
        )
        self.scan_pos_last = -1
        self.sub_set_id = -1
        self.sub_set_pos = -1
        self.cg_pos_x = -1
        self.cg_pos_y = -1
        self.min_sub_pos = -1
        self.max_sub_pos = -1
        self.sig_group_ctx = -1
        self.tmpl_sum1 = -1
        self.tmpl_diag = -1
        self.reg_bin_limit = 0

    def init_subblock(self, subset_id: int):
        self.sub_set_id = subset_id
        self.sub_set_pos = int(self.scan_cg[subset_id][0])
        self.cg_pos_y = self.sub_set_pos // self.width_in_groups
        self.cg_pos_x = self.sub_set_pos - self.cg_pos_y * self.width_in_groups
        self.min_sub_pos = subset_id << self.log2_cg_size
        self.max_sub_pos = self.min_sub_pos + (1 << self.log2_cg_size) - 1
        sig_right = (
            bool(self.sig_group_flags[self.sub_set_pos + 1])
            if self.cg_pos_x + 1 < self.width_in_groups
            else False
        )
        sig_lower = (
            bool(self.sig_group_flags[self.sub_set_pos + self.width_in_groups])
            if self.cg_pos_y + 1 < self.height_in_groups
            else False
        )
        self.sig_group_ctx = self.sig_cg_set + int(sig_right or sig_lower)

    def is_last(self) -> bool:
        return (self.scan_pos_last >> self.log2_cg_size) == self.sub_set_id

    def blockpos(self, scan_pos: int) -> int:
        return int(self.scan[scan_pos][0])

    def last_x_ctx_id(self, pos: int) -> int:
        return self.ctx_last_x + self.last_offset_x + (pos >> self.last_shift_x)

    def last_y_ctx_id(self, pos: int) -> int:
        return self.ctx_last_y + self.last_offset_y + (pos >> self.last_shift_y)

    def sig_group_ctx_id(self) -> int:
        return self.sig_group_ctx

    def sig_ctx_id_abs(self, scan_pos: int, coeff: np.ndarray, state: int) -> int:
        y = int(self.scan[scan_pos][2])
        x = int(self.scan[scan_pos][1])
        base = x + y * self.width
        diag = x + y
        num_pos = 0
        sum_abs = 0
        w, h = self.width, self.height

        def upd(v):
            nonlocal num_pos, sum_abs
            a = abs(int(v))
            sum_abs += min(4 + (a & 1), a)
            num_pos += 1 if a else 0

        if x < w - 1:
            upd(coeff[base + 1])
            if x < w - 2:
                upd(coeff[base + 2])
            if y < h - 1:
                upd(coeff[base + w + 1])
        if y < h - 1:
            upd(coeff[base + w])
            if y < h - 2:
                upd(coeff[base + 2 * w])
        ctx_ofs = min((sum_abs + 1) >> 1, 3) + (4 if diag < 2 else 0)
        if self.ch == 0:
            ctx_ofs += 4 if diag < 5 else 0
        self.tmpl_diag = diag
        self.tmpl_sum1 = sum_abs - num_pos
        return self.sig_flag_sets[max(0, state - 1)] + ctx_ofs

    def ctx_offset_abs(self) -> int:
        offset = 0
        if self.tmpl_diag != -1:
            offset = min(self.tmpl_sum1, 4) + 1
            if self.tmpl_diag == 0:
                offset += 15 if self.ch == 0 else 5
            elif self.ch == 0:
                if self.tmpl_diag < 3:
                    offset += 10
                elif self.tmpl_diag < 10:
                    offset += 5
        return offset

    def par_ctx_id(self, offset: int) -> int:
        return self.par_flag_set + offset

    def gt1_ctx_id(self, offset: int) -> int:
        return self.gtx_flag_sets[1] + offset

    def gt2_ctx_id(self, offset: int) -> int:
        return self.gtx_flag_sets[0] + offset

    # -- transform-skip context helpers ------------------------------------

    def sig_group_ctx_id_ts(self) -> int:
        sig_left = (
            bool(self.sig_group_flags[self.sub_set_pos - 1]) if self.cg_pos_x > 0 else False
        )
        sig_above = (
            bool(self.sig_group_flags[self.sub_set_pos - self.width_in_groups])
            if self.cg_pos_y > 0
            else False
        )
        return _CTXOFF["TsSigCoeffGroup"][0] + int(sig_left) + int(sig_above)

    def sig_ctx_id_ts(self, scan_pos: int, coeff: np.ndarray) -> int:
        y = int(self.scan[scan_pos][2])
        x = int(self.scan[scan_pos][1])
        base = x + y * self.width
        num_pos = 0
        if x > 0:
            num_pos += 1 if coeff[base - 1] else 0
        if y > 0:
            num_pos += 1 if coeff[base - self.width] else 0
        return _CTXOFF["TsSigFlag"][0] + num_pos

    def sign_ctx_id_ts(self, scan_pos: int, coeff: np.ndarray) -> int:
        y = int(self.scan[scan_pos][2])
        x = int(self.scan[scan_pos][1])
        base = x + y * self.width
        right = int(np.sign(coeff[base - 1])) if x > 0 else 0
        below = int(np.sign(coeff[base - self.width])) if y > 0 else 0
        if (right == 0 and below == 0) or right * below < 0:
            c = 0
        elif right >= 0 and below >= 0:
            c = 1
        else:
            c = 2
        if self.bdpcm:
            c += 3
        return _CTXOFF["TsResidualSign"][0] + c

    def lrg1_ctx_id_ts(self, scan_pos: int, coeff: np.ndarray) -> int:
        if self.bdpcm:
            num_pos = 3
        else:
            y = int(self.scan[scan_pos][2])
            x = int(self.scan[scan_pos][1])
            base = x + y * self.width
            num_pos = 0
            if x > 0:
                num_pos += 1 if coeff[base - 1] else 0
            if y > 0:
                num_pos += 1 if coeff[base - self.width] else 0
        return _CTXOFF["TsLrg1Flag"][0] + num_pos

    def par_ctx_id_ts(self) -> int:
        return _CTXOFF["TsParFlag"][0]

    def gtx_ctx_id_ts(self, offset: int) -> int:
        return _CTXOFF["TsGtxFlag"][0] + offset

    def neigh_ts(self, scan_pos: int, coeff: np.ndarray) -> tuple[int, int]:
        y = int(self.scan[scan_pos][2])
        x = int(self.scan[scan_pos][1])
        base = x + y * self.width
        right = int(coeff[base - 1]) if x > 0 else 0
        below = int(coeff[base - self.width]) if y > 0 else 0
        return right, below

    @staticmethod
    def dec_derive_mod_coeff(right: int, below: int, abs_coeff: int) -> int:
        if abs_coeff == 0:
            return 0
        pred1 = max(abs(below), abs(right))
        if abs_coeff == 1 and pred1 > 0:
            return pred1
        return abs_coeff - (1 if abs_coeff <= pred1 else 0)

    def template_abs_sum(self, scan_pos: int, coeff: np.ndarray, base_level: int) -> int:
        y = int(self.scan[scan_pos][2])
        x = int(self.scan[scan_pos][1])
        base = x + y * self.width
        w, h = self.width, self.height
        s = 0
        if x < w - 1:
            s += abs(int(coeff[base + 1]))
            if x < w - 2:
                s += abs(int(coeff[base + 2]))
            if y < h - 1:
                s += abs(int(coeff[base + w + 1]))
        if y < h - 1:
            s += abs(int(coeff[base + w]))
            if y < h - 2:
                s += abs(int(coeff[base + 2 * w]))
        return max(min(s - 5 * base_level, 31), 0)
