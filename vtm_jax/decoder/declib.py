"""Top-level decoder: NAL dispatch state machine.

Behavioral equivalent of DecoderLib/DecLib.cpp decode():2632 — parameter-set
storage/activation, picture lifecycle, per-slice decode, DPB output, and
decoded-picture-hash verification.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vtm_jax import enable_compile_cache
from vtm_jax.bitstream import reader as nalio
from vtm_jax.common.params import PicHeader, SliceHeader
from vtm_jax.common.types import ChromaFormat
from vtm_jax.decoder import sei as seilib
from vtm_jax.decoder import vlc
from vtm_jax.utils import pic_hash


class Picture:
    """Decoded picture.  `planes` is lazily materialized: the in-loop
    filter chain leaves its fused output on the device (ops/filter_chain),
    and the host copy is fetched only at first host use — so XLA filter
    compute overlaps the next picture's CABAC parse, and device-resident
    reference planes are sliced from the chain output without a
    host round-trip (throughput pipeline; cf. DecLib::executeLoopFilters
    DecLib.cpp:596 which filters synchronously)."""

    def __init__(self, poc: int, planes: list[np.ndarray], sps_id: int,
                 pps_id: int, hash_sei=None, slices=None, is_irap=False,
                 is_reference=True, needed_for_output=True):
        self.poc = poc
        self._planes = planes  # reconstruction, int32
        self.sps_id = sps_id
        self.pps_id = pps_id
        self.hash_sei = hash_sei
        self.slices = slices if slices is not None else []
        self.is_irap = is_irap
        self.is_reference = is_reference
        self.needed_for_output = needed_for_output
        self._pending_packed = None  # device array from the filter chain
        self._decoder = None  # set while a hash verification is pending
        # 4x4 motion field etc. added when inter decode lands

    @property
    def planes(self) -> list[np.ndarray]:
        if self._pending_packed is not None:
            self._materialize()
        return self._planes

    @planes.setter
    def planes(self, v) -> None:
        self._planes = v
        self._pending_packed = None

    def _fetch_only(self) -> None:
        """Blocking fetch of the pending filter-chain output (no hash
        bookkeeping — callers that need ordering use _materialize)."""
        packed = self._pending_packed
        if packed is None:
            return
        self._pending_packed = None
        arr = np.asarray(packed)
        pl = self._planes
        ny = pl[0].size
        pl[0][:] = arr[:ny].reshape(pl[0].shape).astype(pl[0].dtype)
        if len(pl) > 1:
            nc = pl[1].size
            pl[1][:] = arr[ny : ny + nc].reshape(pl[1].shape).astype(pl[1].dtype)
            pl[2][:] = arr[ny + nc : ny + 2 * nc].reshape(pl[2].shape).astype(pl[2].dtype)

    def _materialize(self) -> None:
        self._fetch_only()
        dec = self._decoder
        if dec is not None:
            self._decoder = None
            dec._drain_hashes(self)


@dataclass
class HashResult:
    poc: int
    ok: bool
    computed: bytes
    expected: bytes
    hash_type: int


class Decoder:
    """Feed NAL units (or whole Annex-B streams); collect output pictures."""

    def __init__(self, strict: bool = True):
        enable_compile_cache()
        self.psm = vlc.ParameterSetManager()
        self.sei_log: list = []  # (payload_type, parsed dict) observability
        self.ph: PicHeader | None = None
        self.cur_pic: Picture | None = None
        self.dpb: list[Picture] = []
        self.output: list[Picture] = []
        self.hash_results: list[HashResult] = []
        self.prev_tid0_poc = 0
        self.pending_hash_sei: seilib.DecodedPictureHash | None = None
        # decode-ordered pictures whose hash check awaits materialization
        self._hash_queue: list[Picture] = []
        self._decode_seq = 0
        # strict=False: malformed/unsupported NALs are skipped with an error
        # count instead of aborting the stream (DecLib error resilience)
        self.strict = strict
        self.error_count = 0
        self.concealed_count = 0

    # -- public API ---------------------------------------------------------

    def decode_stream(self, data: bytes) -> list[Picture]:
        import sys

        for ebsp in nalio.split_annexb(data):
            if self.strict:
                self.decode_nal(nalio.parse_nal(ebsp))
                continue
            try:
                self.decode_nal(nalio.parse_nal(ebsp))
            except Exception as e:  # noqa: BLE001 — resilience path
                self.error_count += 1
                print(f"warning: NAL decode error skipped: {e}",
                      file=sys.stderr)
        self.finish_picture()
        self.flush()
        return self.output

    def decode_nal(self, nal: nalio.NalUnit) -> None:
        t = nal.nal_unit_type
        if t == nalio.NAL_SPS:
            sps = vlc.parse_sps(nal.rbsp)
            self.psm.sps[sps.sps_id] = sps
        elif t == nalio.NAL_PPS:
            pps = vlc.parse_pps(nal.rbsp)
            self.psm.pps[pps.pps_id] = pps
        elif t in (nalio.NAL_PREFIX_APS, nalio.NAL_SUFFIX_APS):
            self.psm.store_aps(vlc.parse_aps(nal.rbsp))
        elif t == nalio.NAL_PH:
            self.finish_picture()
            self.ph = vlc.parse_picture_header(
                vlc.BitReader(nal.rbsp), self.psm
            )
        elif t in nalio.SLICE_NAL_TYPES:
            self._decode_slice(nal)
        elif t == nalio.NAL_PREFIX_SEI:
            for msg in seilib.parse_sei_rbsp(nal.rbsp):
                if msg.payload_type == seilib.SEI_DECODED_PICTURE_HASH:
                    self.pending_hash_sei = seilib.parse_decoded_picture_hash(msg.payload)
                    continue
                if msg.payload_type == seilib.SEI_BUFFERING_PERIOD:
                    self.last_bp = seilib.parse_buffering_period(msg.payload)
                parsed = seilib.parse_known_payload(
                    msg, getattr(self, "last_bp", None), nal.temporal_id)
                if parsed is not None:
                    self.sei_log.append((msg.payload_type, parsed))
        elif t == nalio.NAL_SUFFIX_SEI:
            for msg in seilib.parse_sei_rbsp(nal.rbsp):
                if msg.payload_type == seilib.SEI_DECODED_PICTURE_HASH:
                    if self.cur_pic is not None:
                        self.cur_pic.hash_sei = seilib.parse_decoded_picture_hash(msg.payload)
        elif t == nalio.NAL_VPS:
            vps = vlc.parse_vps(nal.rbsp)
            self.psm.vps[vps["vps_id"]] = vps
        elif t == nalio.NAL_DCI:
            self.dci = vlc.parse_dci(nal.rbsp)
        # AUD/EOS/EOB ignored (no decoding-process effect)

    # -- internals ----------------------------------------------------------

    def _decode_slice(self, nal: nalio.NalUnit) -> None:
        first_flag = nal.rbsp[0] >> 7  # picture_header_in_slice_header_flag
        if first_flag:
            self.finish_picture()
        sh, ph, r = vlc.parse_slice_header(
            nal.rbsp, nal.nal_unit_type, nal.temporal_id, self.psm,
            None if first_flag else self.ph, self.prev_tid0_poc,
        )
        self.ph = ph
        pps = self.psm.pps[ph.pps_id]
        sps = self.psm.sps[pps.sps_id]
        if self.cur_pic is None or self.cur_pic.poc != sh.poc:
            self.finish_picture()
            fmt = sps.chroma_format
            shapes = [(pps.pic_height, pps.pic_width)]
            if fmt != ChromaFormat.YUV400:
                shapes += [(pps.pic_height >> fmt.scale_y, pps.pic_width >> fmt.scale_x)] * 2
            self.cur_pic = Picture(
                poc=sh.poc,
                planes=[np.zeros(s, dtype=np.int32) for s in shapes],
                sps_id=sps.sps_id,
                pps_id=pps.pps_id,
                is_irap=nal.nal_unit_type in nalio.IRAP_NAL_TYPES,
            )
            if self.pending_hash_sei is not None:
                self.cur_pic.hash_sei = self.pending_hash_sei
                self.pending_hash_sei = None
        self.cur_pic.slices.append(sh)
        if nal.temporal_id == 0 and nal.nal_unit_type not in (
            nalio.NAL_RASL, nalio.NAL_RADL
        ):
            self.prev_tid0_poc = sh.poc
        self._construct_ref_lists(sh, sps)
        # slice data decode
        from vtm_jax.decoder.dec_slice import decompress_slice

        decompress_slice(self, sps, pps, ph, sh, r)

    def _construct_ref_lists(self, sh: SliceHeader, sps) -> None:
        """Slice::constructRefPicList (Slice.cpp:458) + checkLDC + symmetric
        MVD ref derivation (DecLib.cpp:2247-2352) + RPL-based marking."""
        # RPL-based reference marking: any DPB picture not referred to by the
        # full RPLs of this picture stays, but is no longer found as a ref.
        sh.ref_pics = [[], []]
        sh.ref_pocs = [[], []]
        sh.ref_longterm = [[], []]
        sh.temporal_mvp = self.ph.tmvp_enabled if self.ph else False
        if sh.is_intra:
            sh.num_ref_idx = [0, 0]
            sh.check_ldc = False
            sh.bi_dir_pred = False
            return
        for lst in range(2):
            rpl = sh.rpl[lst]
            n_active = sh.num_ref_idx[lst]
            for ii in range(n_active):
                if rpl.is_interlayer[ii] if ii < len(rpl.is_interlayer) else False:
                    raise NotImplementedError("inter-layer ref")
                if not rpl.is_longterm[ii]:
                    poc = sh.poc - rpl.identifiers[ii]
                    ref = self._find_ref(poc)
                    lt = False
                else:
                    # long-term ref: identifier carries the POC LSBs
                    # (Slice::constructRefPicList LT branch, Slice.cpp:458).
                    # When the MSB cycle is signalled, reconstruct the full
                    # POC (spec 8.3.2 / Slice.cpp getFullPocLSB) and match it
                    # exactly; only fall back to LSB matching otherwise.
                    max_lsb = 1 << sps.bits_for_poc
                    ident = rpl.identifiers[ii]
                    ref = None
                    msb_present = (
                        rpl.delta_poc_msb_present[ii]
                        if ii < len(rpl.delta_poc_msb_present) else False
                    )
                    if msb_present:
                        full_poc = (
                            sh.poc - rpl.delta_poc_msb_cycle[ii] * max_lsb
                            - (sh.poc & (max_lsb - 1)) + ident
                        )
                        for p in self.dpb:
                            if p.is_reference and p.poc == full_poc:
                                ref = p
                                break
                        poc = full_poc
                    else:
                        for p in self.dpb:
                            if p.is_reference and (p.poc & (max_lsb - 1)) == ident:
                                ref = p
                                break
                        poc = ref.poc if ref is not None else ident
                    lt = True
                if ref is None:
                    # lost/unavailable reference concealment
                    # (DecLib::xCreateLostPicture, DecLib.cpp:818)
                    ref = self._conceal_lost_picture(poc)
                sh.ref_pics[lst].append(ref)
                sh.ref_pocs[lst].append(poc)
                sh.ref_longterm[lst].append(lt)
        # checkLDC
        low_delay = all(p <= sh.poc for p in sh.ref_pocs[0]) and (
            not sh.is_b or all(p <= sh.poc for p in sh.ref_pocs[1])
        )
        sh.check_ldc = low_delay
        # symmetric-MVD refs
        sh.bi_dir_pred = False
        sh.sym_ref_idx = [-1, -1]
        if sps.smvd and not sh.check_ldc and not (self.ph and self.ph.mvd_l1_zero):
            cur = sh.poc
            fwd_poc, bwd_poc = cur, cur
            r0 = r1 = -1
            for ref, poc in enumerate(sh.ref_pocs[0]):
                if poc < cur and (poc > fwd_poc or r0 == -1) and not sh.ref_longterm[0][ref]:
                    fwd_poc, r0 = poc, ref
            for ref, poc in enumerate(sh.ref_pocs[1]):
                if poc > cur and (poc < bwd_poc or r1 == -1) and not sh.ref_longterm[1][ref]:
                    bwd_poc, r1 = poc, ref
            if not (fwd_poc < cur and bwd_poc > cur):
                fwd_poc, bwd_poc = cur, cur
                r0 = r1 = -1
                for ref, poc in enumerate(sh.ref_pocs[0]):
                    if poc > cur and (poc < bwd_poc or r0 == -1) and not sh.ref_longterm[0][ref]:
                        bwd_poc, r0 = poc, ref
                for ref, poc in enumerate(sh.ref_pocs[1]):
                    if poc < cur and (poc > fwd_poc or r1 == -1) and not sh.ref_longterm[1][ref]:
                        fwd_poc, r1 = poc, ref
            if fwd_poc < cur and bwd_poc > cur:
                sh.bi_dir_pred = True
                sh.sym_ref_idx = [r0, r1]

    def _find_ref(self, poc: int):
        for p in self.dpb:
            if p.poc == poc and p.is_reference:
                return p
        return None

    def _conceal_lost_picture(self, poc: int):
        """DecLib::xCreateLostPicture: synthesize the missing reference by
        copying the closest-POC decoded picture; the picture is inserted in
        the DPB so later RPLs resolve it, and the event is counted."""
        import copy as _copy
        import sys

        print(f"warning: reference picture POC {poc} missing - concealing "
              "from nearest decoded picture", file=sys.stderr)
        self.concealed_count = getattr(self, "concealed_count", 0) + 1
        if not self.dpb:
            raise RuntimeError(f"no decoded pictures to conceal POC {poc}")
        src = min(self.dpb, key=lambda p: abs(p.poc - poc))
        lost = Picture(
            poc=poc,
            planes=[p.copy() for p in src.planes],
            sps_id=src.sps_id,
            pps_id=src.pps_id,
            slices=list(src.slices),
            is_irap=False,
            is_reference=True,
            needed_for_output=False,
        )
        if hasattr(src, "motion"):
            lost.motion = src.motion
        if getattr(src, "device_planes", None) is not None:
            lost.device_planes = src.device_planes
        self.dpb.append(lost)
        return lost

    def finish_picture(self) -> None:
        if self.cur_pic is None:
            return
        pic = self.cur_pic
        self.cur_pic = None
        # in-loop filter chain (executeLoopFilters): LMCS inverse -> deblock
        # -> SAO -> ALF/CC-ALF, fused as one device dispatch per picture
        from vtm_jax.decoder import filters

        filters.apply_loop_filters(self, pic)
        # persist the 4x4 motion field for TMVP from later pictures
        if hasattr(pic, "dcs") and hasattr(pic.dcs, "mf_inter"):
            d = pic.dcs
            pic.motion = {
                "inter": d.mf_inter, "ibc": d.mf_ibc, "interdir": d.mf_interdir,
                "mv": d.mf_mv, "refidx": d.mf_refidx, "slice": d.mf_slice,
            }
        pic._seq = self._decode_seq
        self._decode_seq += 1
        if pic.hash_sei is not None:
            if pic._pending_packed is not None:
                # hash runs lazily at first host use of the planes, in
                # decode order (see _drain_hashes)
                pic._decoder = self
                self._hash_queue.append(pic)
            else:
                self._hash_one(pic)
        # device-resident reference copies: MC batches of later pictures
        # gather from these without re-uploading the DPB each slice.  When
        # the filter chain output is still on the device they are sliced
        # from it directly — no host round-trip at all.
        if pic.is_reference:
            try:
                import jax.numpy as jnp

                packed = pic._pending_packed
                if packed is not None:
                    pl = pic._planes
                    ny = pl[0].size
                    dev = [packed[:ny].reshape(pl[0].shape)]
                    if len(pl) > 1:
                        nc = pl[1].size
                        dev.append(packed[ny : ny + nc].reshape(pl[1].shape))
                        dev.append(
                            packed[ny + nc : ny + 2 * nc].reshape(pl[2].shape))
                    pic.device_planes = dev
                else:
                    pic.device_planes = [jnp.asarray(p) for p in pic._planes]
            except Exception:
                pic.device_planes = None
        self.dpb.append(pic)
        self.output.append(pic)

    def _hash_one(self, pic: Picture) -> None:
        sps = self.psm.sps[pic.sps_id]
        bds = [sps.bit_depth] * len(pic._planes)
        fn = pic_hash.HASH_FUNCS[pic.hash_sei.hash_type]
        computed = fn(pic._planes, bds)
        self.hash_results.append(
            HashResult(pic.poc, computed == pic.hash_sei.digest, computed,
                       pic.hash_sei.digest, pic.hash_sei.hash_type)
        )

    def _drain_hashes(self, upto_pic: Picture) -> None:
        """Hash-check every queued picture decoded no later than upto_pic
        (materializing stragglers), keeping hash_results in decode order."""
        q = self._hash_queue
        upto = getattr(upto_pic, "_seq", None)
        while q and (upto is None or q[0]._seq <= upto):
            p = q.pop(0)
            p._decoder = None
            p._fetch_only()
            self._hash_one(p)

    def flush(self) -> None:
        # materialize everything still pending (and run deferred hashes)
        while self._hash_queue:
            p = self._hash_queue.pop(0)
            p._decoder = None
            p._fetch_only()
            self._hash_one(p)
        for p in self.output:
            p._fetch_only()
        self.output.sort(key=lambda p: p.poc)
