"""Transform kernel tests: jax batched vs numpy exact; round-trip sanity."""

import numpy as np
import pytest

from vtm_jax.ops import transform as tx


def _rand_coeff(rng, h, w, scale=2000):
    return rng.integers(-scale, scale, size=(h, w)).astype(np.int32)


@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (16, 16), (32, 32), (4, 16), (32, 8), (64, 64)])
def test_inv_batch_matches_np(h, w):
    rng = np.random.default_rng(3)
    blocks = np.stack([_rand_coeff(rng, h, w) for _ in range(4)])
    ref = np.stack([tx.inv_transform_2d_np(b, 8) for b in blocks])
    got = np.asarray(tx.inv_transform_batch(blocks, 8))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (32, 32), (16, 4)])
@pytest.mark.parametrize("kinds", [(tx.DCT2, tx.DCT2), (tx.DST7, tx.DCT8), (tx.DCT8, tx.DST7)])
def test_inv_batch_kinds_matches_np(h, w, kinds):
    th, tv = kinds
    rng = np.random.default_rng(5)
    blocks = np.stack([_rand_coeff(rng, h, w, 32000) for _ in range(3)])
    ref = np.stack([tx.inv_transform_2d_np(b, 8, th, tv) for b in blocks])
    got = np.asarray(tx.inv_transform_batch(blocks, 8, th, tv))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bd", [8, 10])
def test_fwd_inv_roundtrip_small_error(bd):
    # not bit-exact (lossy integer transforms) but near-identity
    rng = np.random.default_rng(11)
    maxv = (1 << bd) - 1
    r = rng.integers(-maxv // 4, maxv // 4, size=(8, 8)).astype(np.int32)
    c = tx.fwd_transform_2d_np(r, bd)
    r2 = tx.inv_transform_2d_np(c, bd)
    assert np.abs(r2 - r).max() <= 2


def test_fwd_zero_out():
    rng = np.random.default_rng(2)
    r = rng.integers(-100, 100, size=(64, 64)).astype(np.int32)
    c = tx.fwd_transform_2d_np(r, 8)
    assert np.all(c[32:, :] == 0) and np.all(c[:, 32:] == 0)
    c2 = tx.fwd_transform_2d_np(
        rng.integers(-100, 100, size=(32, 32)).astype(np.int32), 8, tx.DST7, tx.DCT8
    )
    assert np.all(c2[16:, :] == 0) and np.all(c2[:, 16:] == 0)
