"""StreamMergeApp equivalent — interleave single-layer streams into one
multi-layer stream (StreamMergeApp.cpp mergeStreams:256).

Each input stream's NAL units get nuh_layer_id = its index; access units
are interleaved in decoding order (AU-by-AU round robin), preceded by a
generated VPS declaring the layers as independent.

Usage:  python -m vtm_jax.apps.stream_merge in0.bit in1.bit ... out.bit
"""

from __future__ import annotations

import sys

from vtm_jax.bitstream import reader as nalio
from vtm_jax.bitstream.writer import BitWriter, make_nal


def _write_vps(num_layers: int) -> bytes:
    """VPS for N independent layers, each its own OLS (single sublayer):
    full syntax incl. the shared profile_tier_level and alignment."""
    from vtm_jax.encoder.vlc_writer import write_ptl

    w = BitWriter()
    w.u(1, 4)   # vps_video_parameter_set_id (must be > 0)
    w.u(num_layers - 1, 6)  # vps_max_layers_minus1
    w.u(0, 3)   # vps_max_sublayers_minus1 (single sublayer)
    if num_layers > 1:
        w.flag(1)  # vps_all_independent_layers_flag
    for i in range(num_layers):
        w.u(i, 6)  # vps_layer_id[i]
    if num_layers > 1:
        w.flag(1)  # each_layer_is_an_ols_flag
    w.u(0, 8)  # vps_num_ptls_minus1
    # pt_present[0] = 1 inferred; ptl_max_tid inferred (same-sublayers)
    while not w.byte_aligned():
        w.u(0, 1)  # vps_ptl_alignment_zero_bit
    write_ptl(w)  # referenced by every OLS (ols_ptl_idx inferred 0)
    # each layer is an OLS: no DPB/HRD tables, hrd flag not signalled
    w.flag(0)  # vps_extension_flag
    w.write_rbsp_trailing()
    return make_nal(nalio.NAL_VPS, w.data())


def _split_aus(data: bytes):
    """Group a stream's NALs into access units (new AU at a slice NAL whose
    picture header starts, or at a PH NAL; parameter sets attach forward)."""
    aus = []
    cur = []
    for ebsp in nalio.split_annexb(data):
        nal = nalio.parse_nal(ebsp)
        starts_pic = False
        if nal.nal_unit_type in nalio.SLICE_NAL_TYPES:
            from vtm_jax.bitstream.reader import BitReader

            starts_pic = bool(BitReader(nal.rbsp).flag())
        elif nal.nal_unit_type == nalio.NAL_PH:
            starts_pic = True
        if starts_pic and any(
            n.nal_unit_type in nalio.SLICE_NAL_TYPES or n.nal_unit_type == nalio.NAL_PH
            for n in cur
        ):
            aus.append(cur)
            cur = []
        cur.append(nal)
    if cur:
        aus.append(cur)
    return aus


def merge_streams(paths: list[str], with_vps: bool = True) -> bytes:
    """Interleave AUs round-robin with per-stream nuh_layer_id, preceded
    by a generated VPS declaring the layers independent (each its own
    OLS) — the reference StreamMergeApp behavior."""
    streams = [_split_aus(open(p, "rb").read()) for p in paths]
    out = bytearray()
    if with_vps:
        out += _write_vps(len(streams))
    n_aus = max(len(s) for s in streams)
    for i in range(n_aus):
        for layer, aus in enumerate(streams):
            if i >= len(aus):
                continue
            for nal in aus[i]:
                out += make_nal(nal.nal_unit_type, nal.rbsp, nal.temporal_id, layer)
    return bytes(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print("usage: stream_merge <in0> <in1> [...] <outfile>", file=sys.stderr)
        return 2
    out = merge_streams(argv[:-1])
    open(argv[-1], "wb").write(out)
    print(f"merged {len(argv) - 1} streams -> {len(out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
