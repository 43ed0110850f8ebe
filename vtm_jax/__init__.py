"""vtm_jax: a VVC (H.266) encode/decode engine in JAX.

Built from scratch in jax/XLA against the behavior of the VVC reference
software (VTM 9.3, surveyed in SURVEY.md).  The normative sample math
lives in `vtm_jax.ops` (batched jnp/lax kernels with exact-integer numpy
twins), the serial entropy layer in `vtm_jax.bitstream` +
`vtm_jax.decoder`/`vtm_jax.encoder`, and multi-device sharding in
`vtm_jax.parallel`.
"""

import os

__version__ = "0.1.0"

# fixed in-checkout location of the persistent compilation cache (the path
# is part of the cache key, so it must not move between runs)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

_cache_checked = False


def compile_cache_dir(env_dir: str | None, backend: str) -> str | None:
    """Directory this package points XLA's persistent cache at, or None.

    None when JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself) and on
    the CPU backend: a CPU executable is tuned to the host that compiled it,
    and the in-checkout directory travels with copies of the checkout.
    """
    if env_dir or backend == "cpu":
        return None
    return CACHE_DIR


def enable_compile_cache() -> None:
    """Turn on the persistent compilation cache for this process.

    The fused whole-plane kernels (deblock/ALF chains, the batched RMD
    classes) take seconds each to compile; caching them makes every run
    after the first cheap.  Must run before the first compilation, so the
    decoder and encoder constructors call it; later calls do nothing.
    """
    global _cache_checked
    if _cache_checked:
        return
    _cache_checked = True
    import jax

    path = compile_cache_dir(os.environ.get("JAX_COMPILATION_CACHE_DIR"),
                             jax.default_backend())
    if path is None:
        return
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
