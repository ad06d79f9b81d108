"""Tests for the deterministic Lloyd's k-means (ops/kmeans.py)."""

import numpy as np
import pytest
import jax.numpy as jnp

from snesimage.ops.kmeans import lloyd_kmeans


def _clustered_data(rng, centers, n_per):
    pts = np.concatenate(
        [c + rng.normal(0, 0.5, (n_per, len(c))) for c in centers]
    ).astype(np.float32)
    return pts


def test_separates_clear_clusters(rng):
    centers = np.array([[0, 0, 0], [100, 0, 0], [0, 100, 0]], dtype=np.float32)
    data = _clustered_data(rng, centers, 50)
    mask = np.ones(len(data), dtype=bool)
    res = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 3)
    got = np.sort(np.asarray(res.centers), axis=0)
    want = np.sort(centers, axis=0)
    np.testing.assert_allclose(got, want, atol=1.0)
    assert bool(res.converged)


def test_deterministic(rng):
    data = rng.random((200, 3)).astype(np.float32) * 255
    mask = np.ones(200, dtype=bool)
    a = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 4)
    b = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 4)
    np.testing.assert_array_equal(np.asarray(a.centers), np.asarray(b.centers))
    np.testing.assert_array_equal(np.asarray(a.assignments), np.asarray(b.assignments))


def test_mask_excludes_points(rng):
    data = np.zeros((100, 3), dtype=np.float32)
    data[:50] = [10, 10, 10]
    data[50:] = [1000, 1000, 1000]  # masked out
    mask = np.arange(100) < 50
    res = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 2)
    # No center may be pulled toward the masked region.
    assert np.asarray(res.centers).max() < 100


def test_init_order_controls_seeding():
    """Initial centers are the first k valid points in priority order."""
    data = np.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], np.float32)
    mask = np.ones(4, dtype=bool)
    rev = jnp.asarray([3, 2, 1, 0], dtype=jnp.int32)
    a = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 2)
    b = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 2, init_order=rev)
    # Different seeding order -> different cluster labeling on this data.
    assert not np.array_equal(np.asarray(a.assignments), np.asarray(b.assignments))


def test_init_skips_invalid_points():
    data = np.array([[500.0, 0, 0], [0, 0, 0], [1, 0, 0], [100, 0, 0]], np.float32)
    mask = np.array([False, True, True, True])
    res = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 2)
    # The invalid 500-point must not be a center.
    assert np.asarray(res.centers).max() <= 100.0


def test_assignment_tie_first_cluster_wins():
    data = np.array([[5.0, 0, 0]], np.float32)
    mask = np.ones(1, dtype=bool)
    # Forced single iteration situation: two equidistant centers exist only
    # transiently; emulate via direct assignment check on the public API:
    # a single point yields cluster 0 (first minimum).
    res = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 1)
    assert int(res.assignments[0]) == 0


def test_vmapped_over_masks(rng):
    import jax

    data = rng.random((100, 3)).astype(np.float32)
    masks = np.stack([np.arange(100) < 60, np.arange(100) >= 40])
    res = jax.vmap(lambda m: lloyd_kmeans(jnp.asarray(data), m, 3))(
        jnp.asarray(masks)
    )
    assert res.centers.shape == (2, 3, 3)


def test_no_valid_points_gives_zero_centers():
    """A subpalette with no assigned opaque pixels must come out all-black
    (the reference's initial palette state, src/lib.rs:756), not garbage
    colors from masked-out data."""
    data = np.full((50, 3), 123.0, dtype=np.float32)
    mask = np.zeros(50, dtype=bool)
    res = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 4)
    np.testing.assert_array_equal(np.asarray(res.centers), 0.0)


def test_fewer_valid_than_k_zeroes_surplus():
    data = np.full((10, 3), 50.0, dtype=np.float32)
    mask = np.arange(10) < 2  # two valid points
    res = lloyd_kmeans(jnp.asarray(data), jnp.asarray(mask), 4)
    c = np.asarray(res.centers)
    assert (c[0] == 50.0).all()
    # surplus centers stay at black unless points migrate to them
    assert (c[2:] == 0.0).all() or (c[2:] == 50.0).all()


def _clustered_image(rng, h=64, w=64):
    """Well-separated color quadrants (+noise, one transparent tile) so
    f32 (JAX) and f64 (oracle) k-means converge to identical clusters."""
    img = np.zeros((h, w, 4), np.uint8)
    bases = np.array([[220, 40, 40], [40, 220, 40], [40, 40, 220], [220, 220, 40]])
    for q, (y0, x0) in enumerate([(0, 0), (0, w // 2), (h // 2, 0), (h // 2, w // 2)]):
        blk = bases[q] + rng.integers(-12, 13, (h // 2, w // 2, 3))
        img[y0:y0 + h // 2, x0:x0 + w // 2, :3] = blk.clip(0, 255)
    img[..., 3] = 255
    img[0:8, 0:8, 3] = 0  # transparent tile -> excluded, subpalette 0
    return img


@pytest.mark.parametrize("perceptual,nes", [(False, False), (True, False), (False, True)])
def test_init_pipeline_matches_cpp_oracle(rng, perceptual, nes):
    """The whole deterministic init path — tile k-means assignment, flat
    fill, per-subpalette pixel k-means, undithered remap — must agree
    with the independent scalar C++ oracle (native/oracle.cpp) on a
    well-separated fixture."""
    from snesimage.config import QuantConfig
    from snesimage.core import pipeline
    from snesimage.core.state import new_state
    from snesimage.native import (
        oracle_assign_tiles,
        oracle_recalculate,
        oracle_remap,
    )

    img = _clustered_image(rng)
    cfg = QuantConfig(
        subpalette_count=4, subpalette_size=3, width=64, height=64,
        perceptual_palettes=perceptual, nes=nes,
    )
    st = new_state(img, cfg)
    st = pipeline.initialize(st, cfg)

    tp_o, pal_o = oracle_assign_tiles(img, 4, 3, perceptual, nes)
    np.testing.assert_array_equal(np.asarray(st.tile_palettes), tp_o)
    np.testing.assert_array_equal(np.asarray(st.palette), pal_o)

    st = pipeline.cluster(st, cfg)
    pal2_o = oracle_recalculate(img, tp_o, 4, 3, perceptual, nes)
    if perceptual:
        # f32-vs-f64 Lab coordinates can flip near-tie cluster members;
        # quantized 5-bit centers must still land within 1 code.
        assert np.abs(np.asarray(st.palette) - pal2_o).max() <= 1
    else:
        np.testing.assert_array_equal(np.asarray(st.palette), pal2_o)

    want_map = oracle_remap(img, tp_o, pal2_o, dither=False, perceptual=perceptual)
    if not perceptual:
        np.testing.assert_array_equal(np.asarray(st.palette_map), want_map)
