#!/usr/bin/env python3
"""Smoke test of the codec on one NVIDIA GPU.

Drives decode and encode once through the normal entry points
(`Decoder.decode_stream`, `IntraEncoder`, `LowDelayBEncoder`) at JVET CTC
sizes and checks every result by the codec's own oracles: the decoded
picture hash SEI of every picture, and, for the encoder, byte-identical
bitstreams and equal RMD cost tables from the same work done by a child
process on the CPU (the plain reference, which stays off the card).

    python chip_smoke.py             phases 1-5 on one card
    python chip_smoke.py --goldens   phases 1-5, then every testdata/*.bit
    python chip_smoke.py --four      only the four-card paths: GOP-parallel
                                     encode and width-sharded live decode

Each phase prints one line.  The last line is one JSON object,
{"ok": ..., "device": {"platform": ..., "kind": ..., "count": ...}}, and
"ok" is true only when every phase passed on a GPU.  Without a GPU (for
example under JAX_PLATFORMS=cpu) every phase still runs, as a rehearsal
with the 1080p encode cut to 832x480, and the run ends "ok": false with
exit code 1.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
RA_D = "ra_full_bq416_qp37"  # class D 416x240, 8 frames, full inter toolset
AI_B = "ai_full_hd1080_qp37"  # class B 1920x1080, 2 frames
HD = (1920, 1080)
HD_REHEARSE = (832, 480)  # class C: keeps a run without a GPU small
D_SIZE = (416, 240)
CPU_CHILD_TIMEOUT_S = 900


def _stream(name: str) -> bytes:
    with open(os.path.join(REPO, "testdata", name + ".bit"), "rb") as f:
        return f.read()


def _decode(data: bytes, n_pics: int | None = None):
    """Decode through Decoder.decode_stream; every picture hash must match."""
    from vtm_jax.decoder.declib import Decoder

    dec = Decoder()
    pics = dec.decode_stream(data)
    n_ok = sum(hr.ok for hr in dec.hash_results)
    _check(dec.hash_results and n_ok == len(dec.hash_results) == len(pics),
           f"{n_ok}/{len(dec.hash_results)} hashes match over {len(pics)} "
           "pictures")
    if n_pics is not None:
        _check(len(pics) == n_pics, f"{len(pics)} pictures, want {n_pics}")
    return dec, pics


class SmokeFailure(Exception):
    """A check of the smoke test failed."""


def _check(ok, message) -> None:
    """Raise SmokeFailure unless `ok` (an explicit check, not an assert,
    so that `python -O` cannot skip it)."""
    if not ok:
        raise SmokeFailure(message)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


@contextlib.contextmanager
def _chain_outputs():
    """Record the device set of every fused filter-chain output while the
    block runs."""
    from vtm_jax.ops import filter_chain as FC

    seen = []
    run_chain = FC._chain

    def recording_chain(*a, **k):
        out = run_chain(*a, **k)
        seen.append(out.devices())
        return out

    FC._chain = recording_chain
    try:
        yield seen
    finally:
        FC._chain = run_chain


# ---------------------------------------------------------------------------
# phases: each returns its one-line summary and raises when a check fails


def phase_device(st) -> str:
    """JAX's device and the native engines; the default backend must be
    the GPU and the CABAC engine must be built from native/cabac.c."""
    import jax

    from vtm_jax import native
    from vtm_jax.utils.device_info import jax_device

    st["device"] = dev = jax_device()
    engines = {"cabac": native.load_cabac(), "tcq": native.load_tcq(),
               "depquant": native.load_depquant()}
    loaded = ", ".join(f"{k} {'native' if m else 'python'}"
                       for k, m in engines.items())
    summary = (f"jax {dev['platform']} '{dev['kind']}' x{dev['count']}; "
               f"engines: {loaded}")
    cabac = engines["cabac"]
    _check(cabac is not None,
           f"{summary}; native CABAC failed: "
           f"{native.BUILD_ERRORS.get('cabac_native')}")
    built = native.built_path("cabac_native", ["cabac.c"])
    _check(os.path.samefile(cabac.__file__, built),
           f"CABAC engine {cabac.__file__} is not the build of cabac.c")
    _check(jax.default_backend() == "gpu",
           f"{summary}; default backend is {jax.default_backend()}, not gpu")
    return summary


def phase_ra_decode(st) -> str:
    """Class D RA decode: hashes, device placement, cold and warm time."""
    import jax

    data = _stream(RA_D)
    dev = jax.devices()[0]
    with _chain_outputs() as chain_devices:
        cold, (dec, pics) = _timed(lambda: _decode(data, 8))
    _check(chain_devices and all(d == {dev} for d in chain_devices),
           f"filter chain ran on {chain_devices}, not {dev}")
    refs = [a for p in dec.dpb for a in (getattr(p, "device_planes", None)
                                        or [])]
    _check(refs and all(a.devices() == {dev} for a in refs),
           f"DPB reference planes not all on {dev}")
    warm = min(_timed(lambda: _decode(data, 8))[0] for _ in range(3))
    return (f"{RA_D}: 8/8 hashes; cold {cold:.3f} s (compile ~"
            f"{cold - warm:.3f} s); warm {8 / warm:.3f} frames/s best of 3; "
            f"chain x{len(chain_devices)} and {len(refs)} DPB planes on {dev}")


def phase_ai_decode(st) -> str:
    """Class B AI decode: hashes, cold and warm time, peak device memory."""
    import jax

    data = _stream(AI_B)
    cold, _ = _timed(lambda: _decode(data, 2))
    warm = min(_timed(lambda: _decode(data, 2))[0] for _ in range(2))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not reported")
    return (f"{AI_B}: 2/2 hashes; cold {cold:.3f} s (compile ~"
            f"{cold - warm:.3f} s); warm {warm:.3f} s ({2 / warm:.3f} "
            f"frames/s best of 2); peak_bytes_in_use {peak}")


def rmd_tables(y, w: int, h: int) -> dict:
    """FrameRMD's reduced per-position cost tables of one luma plane (MIP
    on, so the MIP einsum is exercised too), keyed '<class>:<column>'."""
    import numpy as np

    from vtm_jax.encoder.enc_lib import EncoderConfig
    from vtm_jax.encoder.frame_rmd import FrameRMD

    cfg = EncoderConfig(width=w, height=h, qp=37, mip=True)
    lam = 0.57 * 2.0 ** ((cfg.qp - 12) / 3.0)
    stats = FrameRMD(y, cfg, lam ** 0.5)._force_reduced()
    return {f"{cw}x{ch}:{i}": np.asarray(a)
            for (cw, ch), cols in stats.items()
            for i, a in enumerate(cols) if a is not None}


def _encodes(hd):
    """The encodes compared between the card and the CPU reference."""
    from tools.make_testdata import synth_clip
    from vtm_jax.encoder.enc_lib import (EncoderConfig, IntraEncoder,
                                         LowDelayBEncoder)

    w, h = D_SIZE
    clip = synth_clip(w, h, 3)
    out = {}
    out["ai"] = _timed(lambda: IntraEncoder(
        EncoderConfig(width=w, height=h, qp=32)).encode(clip[:1]))
    out["ldb"] = _timed(lambda: LowDelayBEncoder(
        EncoderConfig(width=w, height=h, qp=32)).encode(clip))
    hd_y = synth_clip(*hd, 1)[0][0]
    out["rmd"] = _timed(lambda: rmd_tables(hd_y, *hd))
    return out


def _hd_size() -> tuple[int, int]:
    """The large encode's size: full 1080p on the GPU, class C elsewhere."""
    import jax

    return HD if jax.default_backend() == "gpu" else HD_REHEARSE


def cpu_reference(outdir: str, hd: tuple[int, int]) -> int:
    """Child process: the same encodes on the CPU, written to `outdir`."""
    import jax
    import numpy as np

    _check(jax.default_backend() == "cpu", jax.default_backend())
    out = _encodes(hd)
    for k in ("ai", "ldb"):
        with open(os.path.join(outdir, k + ".bit"), "wb") as f:
            f.write(out[k][1])
    np.savez(os.path.join(outdir, "rmd.npz"), **out["rmd"][1])
    return 0


def _start_cpu_reference(outdir: str, hd: tuple[int, int]):
    """Start the CPU child; its output goes to <outdir>/log.txt (a file,
    not a pipe nobody drains while the device encodes run)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, os.path.abspath(__file__), "--cpu-reference",
           outdir, str(hd[0]), str(hd[1])]
    with open(os.path.join(outdir, "log.txt"), "w") as log:
        return subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def phase_encode(st) -> str:
    """Encode round trips on the device; the 416x240 streams and the
    1080p RMD tables must equal the CPU child's."""
    import numpy as np

    from tools.make_testdata import synth_clip
    from vtm_jax.encoder.enc_lib import EncoderConfig, IntraEncoder

    hd = _hd_size()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
    child = _start_cpu_reference(outdir, hd)
    try:
        frame = synth_clip(*hd, 1)[0]
        t_hd, bits_hd = _timed(lambda: IntraEncoder(
            EncoderConfig(width=hd[0], height=hd[1], qp=37)).encode([frame]))
        _decode(bits_hd, 1)
        dev = _encodes(hd)
        _decode(dev["ai"][1], 1)
        _decode(dev["ldb"][1], 3)
        child.wait(timeout=CPU_CHILD_TIMEOUT_S)
        if child.returncode != 0:
            with open(os.path.join(outdir, "log.txt")) as f:
                _check(False, f"CPU reference failed:\n{f.read()[-4000:]}")
        for k in ("ai", "ldb"):
            with open(os.path.join(outdir, k + ".bit"), "rb") as f:
                ref = f.read()
            _check(dev[k][1] == ref,
                   f"{k} stream differs from the CPU encode "
                   f"({len(dev[k][1])} vs {len(ref)} bytes)")
        with np.load(os.path.join(outdir, "rmd.npz")) as ref:
            got = dev["rmd"][1]
            _check(sorted(ref.files) == sorted(got), "RMD table keys differ")
            bad = [k for k in got if not np.array_equal(got[k], ref[k])]
            _check(not bad, f"RMD tables differ from the CPU's: {bad[:8]}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(outdir, ignore_errors=True)
    w, h = D_SIZE
    return (f"AI {hd[0]}x{hd[1]} qp37 {t_hd:.3f} s/frame, 1/1 hashes; "
            f"AI {w}x{h} qp32 {dev['ai'][0]:.3f} s/frame and LDB {w}x{h} "
            f"qp32 {dev['ldb'][0] / 3:.3f} s/frame ({len(dev['ai'][1])} + "
            f"{len(dev['ldb'][1])} bytes), 1/1 + 3/3 hashes, byte-identical "
            f"to the CPU; RMD {hd[0]}x{hd[1]} {dev['rmd'][0]:.3f} s, "
            f"{len(dev['rmd'][1])} tables equal to the CPU's "
            "(first runs, compile included)")


def phase_goldens(st) -> str:
    """Every testdata/*.bit decodes with every picture hash matching."""
    paths = sorted(glob.glob(os.path.join(REPO, "testdata", "*.bit")))
    bad = []
    n_pics = 0
    t0 = time.perf_counter()
    for p in paths:
        name = os.path.basename(p)[:-4]
        try:
            dt, (_, pics) = _timed(lambda: _decode(_stream(name)))
        except Exception as e:  # noqa: BLE001 — reported, fails the phase
            bad.append(name)
            print(f"  {name}: FAILED {type(e).__name__}: {e}", flush=True)
            continue
        n_pics += len(pics)
        print(f"  {name}: {len(pics)}/{len(pics)} hashes, {dt:.3f} s",
              flush=True)
    _check(not bad, f"{len(bad)}/{len(paths)} streams failed: {bad}")
    return (f"{len(paths)}/{len(paths)} streams, {n_pics} pictures, every "
            f"hash matches ({time.perf_counter() - t0:.3f} s)")


def phase_gop_parallel(st) -> str:
    """GOP-segment parallel encode, one worker per card; the parent holds
    no card while the workers run, then encodes sequentially itself."""
    from tools.make_testdata import synth_clip
    from vtm_jax.parallel.gop import (encode_parallel, visible_cards,
                                      worker_cards)

    # nothing in this process has imported JAX yet, so it holds no card
    _check("jax" not in sys.modules, "the parent process imported JAX")
    w, h = D_SIZE
    frames = synth_clip(w, h, 8)
    cfg = dict(width=w, height=h, qp=32)
    n, cards = worker_cards(4, 4, visible_cards(), os.cpu_count() or 1)
    t_par, par = _timed(lambda: encode_parallel(
        frames, cfg, mode="ldb", segment_len=2, workers=4))
    t_seq, seq = _timed(lambda: encode_parallel(
        frames, cfg, mode="ldb", segment_len=2, workers=1))
    import jax  # loaded by the sequential encode, after the workers ended

    if jax.default_backend() == "gpu":
        _check(cards is not None and len(cards) == 4,
               f"workers were pinned to cards {cards}, not to 4 cards")
    _check(par == seq, f"parallel stream differs from the sequential one "
                       f"({len(par)} vs {len(seq)} bytes)")
    _decode(par, 8)
    return (f"LDB {w}x{h} 8 frames in 4 segments: {n} workers on cards "
            f"{cards} {t_par:.3f} s, sequential {t_seq:.3f} s; "
            f"{len(par)} bytes byte-identical, 8/8 hashes")


def phase_sharded_decode(st) -> str:
    """Live decode width-sharded over a 4-device 'tile' axis; hashes and
    planes must equal the one-device decode."""
    import jax
    import numpy as np

    from vtm_jax.parallel.mesh import codec_mesh, decode_mesh_ctx
    from vtm_jax.utils.device_info import jax_device

    st["device"] = jax_device()
    _check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices")
    data = _stream(RA_D)
    _, ref = _decode(data, 8)
    with _chain_outputs() as chain_devices, \
            decode_mesh_ctx(codec_mesh(4, gop=1)):
        cold, (_, pics) = _timed(lambda: _decode(data, 8))
        warm, _ = _timed(lambda: _decode(data, 8))
    spans = [len(d) for d in chain_devices]
    _check(spans and all(s == 4 for s in spans), f"chain spans {spans}")
    for a, b in zip(ref, pics):
        same = a.poc == b.poc and all(
            np.array_equal(x, y) for x, y in zip(a.planes, b.planes))
        _check(same, f"POC {a.poc} planes differ from the one-device decode")
    return (f"{RA_D} under codec_mesh(4, gop=1): 8/8 hashes, planes equal "
            f"the one-device decode; chain x{len(spans)} on 4 devices; "
            f"cold {cold:.3f} s, warm {8 / warm:.3f} frames/s")


# ---------------------------------------------------------------------------


def _run(name: str, fn, st) -> bool:
    try:
        line = fn(st)
    except Exception as e:  # noqa: BLE001 — recorded as a failed phase
        traceback.print_exc(file=sys.stderr)
        print(f"[{name}] FAILED {type(e).__name__}: {e}", flush=True)
        return False
    print(f"[{name}] ok {line}", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--goldens", action="store_true",
                    help="also decode every testdata/*.bit")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    ap.add_argument("--trace", metavar="DIR",
                    help="write a jax.profiler trace of phases 2-4 to DIR")
    ap.add_argument("--cpu-reference", nargs=3, metavar=("DIR", "W", "H"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        import vtm_jax  # noqa: F401
        from tools import make_testdata  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the codec is not importable next to this "
              f"script ({e})", file=sys.stderr)
        return 1
    if args.cpu_reference:
        outdir, w, h = args.cpu_reference
        return cpu_reference(outdir, (int(w), int(h)))

    from vtm_jax.utils.device_info import card_line

    print(f"card: {card_line()}", flush=True)
    st = {"device": None}
    if args.four:
        phases = [("gop-parallel encode", phase_gop_parallel),
                  ("sharded decode", phase_sharded_decode)]
        ok = all([_run(n, f, st) for n, f in phases])
    else:
        ok = _run("device", phase_device, st)
        phases = [("RA decode", phase_ra_decode),
                  ("AI decode", phase_ai_decode),
                  ("encode", phase_encode)]
        if args.trace:
            import jax

            # device activity only: Python-level host tracing of the
            # parse plane would swamp the trace
            opts = jax.profiler.ProfileOptions()
            opts.python_tracer_level = 0
            opts.host_tracer_level = 1
            with jax.profiler.trace(args.trace, profiler_options=opts):
                results = [_run(n, f, st) for n, f in phases]
        else:
            results = [_run(n, f, st) for n, f in phases]
        if args.goldens:
            results.append(_run("goldens", phase_goldens, st))
        ok = ok and all(results)
    if st["device"] is None:
        from vtm_jax.utils.device_info import jax_device

        st["device"] = jax_device()
    ok = ok and st["device"]["platform"] == "gpu"
    print(json.dumps({"ok": ok, "device": st["device"]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
