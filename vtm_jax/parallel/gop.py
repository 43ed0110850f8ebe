"""Segment (GOP) parallel encoding — the framework's multi-host scaling
axis (SURVEY §2.6: reference mechanism = offline segment encode + Parcat
stitch, App/Parcat/readme.md).

Frames are split at IRAP boundaries into independent segments; each
segment encodes in its own worker process (on a production deployment:
one card or one host per segment), and the bitstreams are stitched with
vtm_jax.apps.parcat into one stream that is bit-identical to the
sequential intra-period encode.

On GPUs each worker is pinned to a card of its own through
CUDA_VISIBLE_DEVICES, set before the worker imports JAX: a JAX process
reserves most of its card's memory when it starts, so a second process on
the same card would fail.  The calling process must not hold a card
while the workers run: encode_parallel refuses to start pinned workers
once this process has started JAX's GPU backend.
"""

from __future__ import annotations

import multiprocessing
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor


def visible_cards() -> list[str]:
    """CUDA card ids the workers may use, found without starting JAX in
    this process: none when JAX is held to the CPU or no card is listed."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and not {"cuda", "gpu"} & set(plats.split(",")):
        return []
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [c.strip() for c in vis.split(",") if c.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    return out.stdout.split() if out.returncode == 0 else []


def worker_cards(n_segments: int, workers: int | None, cards: list[str],
                 cpu_count: int) -> tuple[int, list[str] | None]:
    """(number of worker processes, card of each worker or None).

    Without cards every worker shares the host: `workers`, by default one
    per segment up to `cpu_count`.  With cards there is at most one
    worker per card."""
    if not cards:
        n = workers if workers is not None else min(n_segments, cpu_count)
        return n, None
    n = min(n_segments, len(cards), workers or len(cards))
    return n, cards[:n]


def parent_holds_card() -> bool:
    """Whether this process has started JAX's GPU backend, which reserves
    memory on every card it sees."""
    if "jax" not in sys.modules:
        return False
    from jax._src import xla_bridge

    return xla_bridge.backends_are_initialized() and any(
        b.platform == "gpu" for b in xla_bridge.backends().values())


def _pin_card(cards) -> None:
    """Pool initializer: take one card for this worker, before JAX loads."""
    os.environ["CUDA_VISIBLE_DEVICES"] = cards.get()


def _encode_segment(args):
    (mode, cfg_kwargs, frames, kw) = args
    from vtm_jax.encoder import enc_lib as E

    cfg = E.EncoderConfig(**cfg_kwargs)
    enc_cls = {
        "intra": E.IntraEncoder,
        "ldp": E.InterEncoder,
        "ldb": E.LowDelayBEncoder,
        "ra": E.RandomAccessEncoder,
    }[mode]
    enc = enc_cls(cfg, **kw)
    return enc.encode(frames)


def encode_parallel(frames, cfg_kwargs: dict, mode: str = "ldp",
                    segment_len: int = 8, workers: int | None = None,
                    enc_kwargs: dict | None = None) -> bytes:
    """Encode `frames` as ceil(N/segment_len) independent segments in
    parallel worker processes and parcat-stitch the results."""
    from vtm_jax.apps.parcat import parcat

    segments = [frames[i : i + segment_len]
                for i in range(0, len(frames), segment_len)]
    kw = enc_kwargs or {}
    jobs = [(mode, cfg_kwargs, seg, kw) for seg in segments]
    workers, cards = worker_cards(len(segments), workers, visible_cards(),
                                  os.cpu_count() or 1)
    if workers > 1 and len(segments) > 1:
        # spawn, not fork: the encoder runs jax kernels (batched RMD,
        # filter chains) whose XLA runtime threads/mutexes make a forked
        # child deadlock-prone; spawn gives each worker a clean runtime
        ctx = multiprocessing.get_context("spawn")
        pin = {}
        if cards is not None:
            if parent_holds_card():
                raise RuntimeError(
                    "encode_parallel: this process has started JAX on the "
                    "GPU and holds its cards, so workers pinned to them "
                    f"({cards}) would run out of memory; call it before "
                    "this process uses JAX on the GPU, or with workers=1")
            queue = ctx.Queue()
            for c in cards:
                queue.put(c)
            pin = dict(initializer=_pin_card, initargs=(queue,))
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                                 **pin) as pool:
            streams = list(pool.map(_encode_segment, jobs))
    else:
        streams = [_encode_segment(j) for j in jobs]
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, s in enumerate(streams):
            p = os.path.join(td, f"seg{i}.bit")
            open(p, "wb").write(s)
            paths.append(p)
        return parcat(paths)
