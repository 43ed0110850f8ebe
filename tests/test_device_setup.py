"""How the codec uses its devices: exact f32 products, live sharded decode
with in-loop filters on, the persistent compile cache, GOP workers pinned
to cards, and native engines built from their sources."""

import os
import queue
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "testdata")


# ---------------------------------------------------------------------------
# (i) every float32 product of the RMD runs at HIGHEST precision: on a GPU
# a DEFAULT-precision f32 product may run in TF32 and round its operands


def _f32_dots(hlo_text: str) -> list[str]:
    dots = [ln for ln in hlo_text.splitlines() if "dot_general" in ln]
    return [ln for ln in dots if "xf32>" in ln.split(" : ")[-1]]


@pytest.mark.parametrize("w,h,with_mip", [(8, 8, True), (16, 8, True),
                                          (4, 16, False)])
def test_rmd_class_fn_f32_dots_highest(w, h, with_mip):
    import jax
    import jax.numpy as jnp

    from vtm_jax.encoder import frame_rmd as R

    fn, consts, _ = R.class_fn(w, h, 8, with_mip)
    srcpad = jnp.zeros((64 + 131, 64 + 131), jnp.int32)
    pos = jnp.zeros(8, jnp.int32)
    text = jax.jit(fn).lower(srcpad, pos, pos,
                             *[jnp.asarray(c) for c in consts]).as_text()
    dots = _f32_dots(text)
    assert dots, "no f32 products found"
    assert all("precision = [HIGHEST, HIGHEST]" in d for d in dots), dots


@pytest.mark.parametrize("h,w", [(8, 8), (8, 16), (16, 8), (4, 8)])
def test_satd_batch_f32_dots_highest(h, w):
    import jax
    import jax.numpy as jnp

    from vtm_jax.ops import rdcost

    text = jax.jit(lambda d: rdcost.satd_batch_jax(d, h, w)).lower(
        jnp.zeros((3, h, w), jnp.int32)).as_text()
    dots = _f32_dots(text)
    assert dots, "no f32 products found"
    assert all("precision = [HIGHEST, HIGHEST]" in d for d in dots), dots


# ---------------------------------------------------------------------------
# (ii) live width-sharded decode of a stream whose in-loop filters run


def test_live_sharded_decode_filters_on():
    import jax

    from vtm_jax.decoder.declib import Decoder
    from vtm_jax.parallel.mesh import codec_mesh, decode_mesh_ctx

    assert len(jax.devices()) >= 4, "conftest provides 8 virtual devices"
    with open(os.path.join(TD, "ra_full_small208_qp32.bit"), "rb") as f:
        data = f.read()
    with decode_mesh_ctx(codec_mesh(4, gop=1)):
        dec = Decoder()
        pics = dec.decode_stream(data)
    assert len(dec.hash_results) == len(pics) > 0
    assert all(hr.ok for hr in dec.hash_results)


# ---------------------------------------------------------------------------
# (iii) persistent compile cache placement


@pytest.mark.parametrize("env_dir,backend,want_repo_dir", [
    (None, "gpu", True),        # unset on the card: fixed in-checkout path
    (None, "cpu", False),       # CPU executables never enter the checkout
    ("/elsewhere", "gpu", False),  # set: JAX places it, nothing set here
])
def test_compile_cache_dir(env_dir, backend, want_repo_dir):
    import vtm_jax

    got = vtm_jax.compile_cache_dir(env_dir, backend)
    if want_repo_dir:
        assert got == os.path.join(REPO, ".jax_cache")
        ignored = subprocess.run(["git", "-C", REPO, "check-ignore", "-q",
                                  os.path.join(got, "entry")],
                                 capture_output=True)
        if ignored.returncode in (0, 1):  # 128: not a git checkout
            assert ignored.returncode == 0, ".jax_cache is not gitignored"
    else:
        assert got is None


def test_compile_cache_follows_env_var(tmp_path):
    cache = tmp_path / "xla"
    code = (
        "import jax, jax.numpy as jnp, vtm_jax\n"
        "vtm_jax.enable_compile_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(5)).block_until_ready()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


# ---------------------------------------------------------------------------
# (iv) GOP workers: at most one per card, each pinned before JAX loads


@pytest.mark.parametrize("n_seg,workers,cards,cpus,want", [
    (4, None, [], 8, (4, None)),            # CPU: one per segment
    (9, None, [], 4, (4, None)),            # CPU: capped by cores
    (4, 2, [], 8, (2, None)),               # CPU: caller's count
    (4, None, ["0", "1", "2", "3"], 64, (4, ["0", "1", "2", "3"])),
    (8, 16, ["0", "1"], 64, (2, ["0", "1"])),  # never two on one card
    (2, None, ["4", "5", "6", "7"], 64, (2, ["4", "5"])),
    (4, 3, ["0", "1", "2", "3"], 64, (3, ["0", "1", "2"])),
])
def test_worker_cards(n_seg, workers, cards, cpus, want):
    from vtm_jax.parallel.gop import worker_cards

    assert worker_cards(n_seg, workers, cards, cpus) == want


def test_visible_cards_from_env(monkeypatch):
    from vtm_jax.parallel.gop import visible_cards

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    assert visible_cards() == []
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 3")
    assert visible_cards() == ["2", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert visible_cards() == []


def test_pin_card_takes_one_card(monkeypatch):
    from vtm_jax.parallel import gop

    q = queue.Queue()
    for c in ("1", "3"):
        q.put(c)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    gop._pin_card(q)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"
    gop._pin_card(q)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"


def test_gop_parallel_pinned_workers(monkeypatch):
    """The card-pinning pool (one card id per worker, taken before JAX
    loads) encodes the same stream as one process; on the CPU the ids are
    inert."""
    from vtm_jax.common.types import ChromaFormat
    from vtm_jax.parallel import gop
    from vtm_jax.utils.yuv_io import YuvFormat, read_yuv

    fmt = YuvFormat(64, 64, ChromaFormat.YUV420, 8)
    frames = read_yuv(os.path.join(TD, "tiny64_64x64_420_8.yuv"), fmt, 4)
    cfgk = dict(width=64, height=64, qp=32, max_mtt_depth_intra=0)
    monkeypatch.setattr(gop, "visible_cards", lambda: ["7", "9"])
    pinned = gop.encode_parallel(frames, cfgk, mode="ldp", segment_len=2)
    single = gop.encode_parallel(frames, cfgk, mode="ldp", segment_len=2,
                                 workers=1)
    assert pinned == single


def test_parent_on_cpu_holds_no_card():
    import jax

    from vtm_jax.parallel import gop

    jax.devices()  # this process's backends are started, on the CPU
    assert not gop.parent_holds_card()


def test_gop_refuses_pinned_workers_when_parent_holds_card(monkeypatch):
    """A parent that already holds the cards gets a clear error before any
    worker starts; one process (workers=1) is still allowed."""
    from vtm_jax.apps import parcat
    from vtm_jax.parallel import gop

    monkeypatch.setattr(gop, "visible_cards", lambda: ["0", "1"])
    monkeypatch.setattr(gop, "parent_holds_card", lambda: True)
    monkeypatch.setattr(gop, "_encode_segment", lambda job: b"seg")
    monkeypatch.setattr(parcat, "parcat", lambda paths: len(paths))
    with pytest.raises(RuntimeError, match="holds its cards"):
        gop.encode_parallel([None] * 4, {}, segment_len=2)
    assert gop.encode_parallel([None] * 4, {}, segment_len=2,
                               workers=1) == 2


# ---------------------------------------------------------------------------
# (v) native engines: built from the sources in the tree, none committed


def test_native_engines_built_from_source():
    from vtm_jax import native

    for load, name, src in ((native.load_cabac, "cabac_native", "cabac.c"),
                            (native.load_tcq, "tcq_native", "tcq.c"),
                            (native.load_depquant, "depquant_native",
                             "depquant.c")):
        mod = load()
        assert mod is not None, native.BUILD_ERRORS.get(name)
        assert os.path.samefile(mod.__file__, native.built_path(name, [src]))


def test_no_binary_tracked():
    out = subprocess.run(["git", "-C", REPO, "ls-files", "*.so", "*.o"],
                         capture_output=True, text=True)
    if out.returncode == 0:
        assert out.stdout.split() == []
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "*.so" in f.read().split()


def test_native_build_follows_source(tmp_path, monkeypatch):
    from vtm_jax import native

    src = tmp_path / "eng.c"
    src.write_text("int a;\n")
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    first = native.built_path("eng", ["eng.c"])
    src.write_text("int b;\n")
    assert native.built_path("eng", ["eng.c"]) != first


def test_native_build_failure_is_reported(tmp_path, monkeypatch):
    from vtm_jax import native

    (tmp_path / "broken.c").write_text("this is not C\n")
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.delenv("VTM_NO_NATIVE", raising=False)
    with pytest.warns(RuntimeWarning, match="broken"):
        assert native._load("broken", ["broken.c"]) is None
    assert native.BUILD_ERRORS.pop("broken")
    assert not list((tmp_path / "_build").glob("*.so"))
