"""Device-mesh layout and halo exchange for the multi-device compute path.

The codec's two sharding axes (SURVEY §2.6):
  - "gop": frame-batch data parallelism (pictures/GOPs across devices;
    across hosts this becomes segment parallelism stitched by parcat)
  - "tile": intra-frame spatial parallelism (CTU tiles/subpictures across
    devices, halo exchange of reference/filter borders)

Everything here is jax.sharding/shard_map-based: XLA inserts the
collectives (NCCL on GPUs); ppermute carries the halos.  The mesh follows
the algorithm alone: every GPU of a host reaches every other at the same
NVLink rate, so no device order is preferred.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def codec_mesh(n_devices: int | None = None, gop: int | None = None):
    """Factor the device set into a (gop, tile) mesh."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if gop is None:
        gop = 2 if n % 2 == 0 and n > 1 else 1
    tile = n // gop
    return Mesh(np.array(devs[: gop * tile]).reshape(gop, tile), ("gop", "tile"))


def halo_exchange(x, halo: int, axis_name: str):
    """Exchange `halo` rows with the previous/next shard along `axis_name`
    and concatenate: (rows, w) -> (halo + rows + halo, w).

    Boundary shards receive the neighbour's wrap-around rows; callers mask
    them (picture borders are padded by clamp rules anyway). This is the
    cross-device analogue of the reference's subpicture border save/restore
    (Picture.cpp:757-954) for cross-tile MC and filter edges.
    """
    import jax
    import jax.lax as lax

    n = lax.psum(1, axis_name)
    idx = lax.axis_index(axis_name)
    perm_fwd = [(i, (i + 1) % n) for i in range(n)]   # send to next
    perm_bwd = [(i, (i - 1) % n) for i in range(n)]   # send to prev
    top_halo = lax.ppermute(x[-halo:], axis_name, perm_fwd)   # from prev shard
    bot_halo = lax.ppermute(x[:halo], axis_name, perm_bwd)    # from next shard
    import jax.numpy as jnp

    return jnp.concatenate([top_halo, x, bot_halo], axis=0)


def sharded_recon_step(mesh, coeff, pred, orig):
    """Jit a full sharded reconstruction step over the mesh: per-shard
    inverse transform + recon, cross-device SSE reduction (the RD/rate-
    control feedback path). Inputs are (F, T, N, N) sharded (gop, tile)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vtm_jax.ops.transform import inv_transform_batch

    sharding = NamedSharding(mesh, P("gop", "tile"))
    coeff, pred, orig = (jax.device_put(x, sharding) for x in (coeff, pred, orig))

    @jax.jit
    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("gop", "tile"), P("gop", "tile"), P("gop", "tile")),
        out_specs=(P("gop", "tile"), P()),
    )
    def step(c, p, o):
        f, t, n, _ = c.shape
        r = inv_transform_batch(c.reshape(f * t, n, n), 8).reshape(c.shape)
        recon = jnp.clip(p + r, 0, 255)
        sse = jnp.sum((recon - o).astype(jnp.float32) ** 2)
        sse = jax.lax.psum(sse, ("gop", "tile"))
        return recon.astype(jnp.int16), sse[None]

    return step(coeff, pred, orig)


# ---------------------------------------------------------------------------
# Product decode-mesh plumbing: when a mesh is active the decoder's device
# dispatches (fused filter chain, MC tile batches) are issued with sharded
# input placements, and XLA/GSPMD partitions the SAME jitted kernels over
# the mesh (halo exchanges inserted by the compiler).  This is the live
# sharded path — the capture-replay forms in __graft_entry__ additionally
# prove gop-axis batching over distinct pictures.

_DECODE_MESH = None


def decode_mesh():
    """The active decode mesh, or None (single-device execution)."""
    return _DECODE_MESH


from contextlib import contextmanager  # noqa: E402


@contextmanager
def decode_mesh_ctx(mesh):
    """Run decoder dispatches sharded over `mesh` (gop, tile axes)."""
    global _DECODE_MESH
    prev = _DECODE_MESH
    _DECODE_MESH = mesh
    try:
        yield
    finally:
        _DECODE_MESH = prev
