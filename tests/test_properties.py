"""Property-based tests (hypothesis) for the color and remap invariants
(SURVEY.md §4 item c: transparency invariants, index ranges, tie
determinism)."""

import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from snesimage.ops import color

u5 = st.integers(0, 31)
u8 = st.integers(0, 255)
rgb5 = st.tuples(u5, u5, u5)
rgb8 = st.tuples(u8, u8, u8)


@given(u5)
def test_expand_range_and_monotone(c):
    v = int(color.expand_5bit_to_8bit(jnp.asarray(c)))
    assert 0 <= v <= 255
    if c > 0:
        assert v > int(color.expand_5bit_to_8bit(jnp.asarray(c - 1)))


@given(rgb5)
def test_pack_bgr555_bijective_range(c):
    v = int(color.pack_bgr555(jnp.asarray(c)))
    assert 0 <= v < 2**15
    # unpack round-trips
    assert (v & 31, (v >> 5) & 31, (v >> 10) & 31) == c


@given(rgb8, rgb8)
@settings(max_examples=30, deadline=None)
def test_red_mean_symmetry_and_identity(c1, c2):
    a = jnp.asarray(c1)
    b = jnp.asarray(c2)
    d_ab = int(color.red_mean_sq_scaled(a, b))
    d_ba = int(color.red_mean_sq_scaled(b, a))
    assert d_ab == d_ba
    assert d_ab >= 0
    assert int(color.red_mean_sq_scaled(a, a)) == 0


@given(rgb8)
@settings(max_examples=30, deadline=None)
def test_lab_in_gamut(c):
    lab = np.asarray(color.srgb_u8_to_lab(jnp.asarray(c)))
    assert -1e-3 <= lab[0] <= 100.01
    assert -130 <= lab[1] <= 130
    assert -130 <= lab[2] <= 130


@given(rgb5)
@settings(max_examples=20, deadline=None)
def test_nes_projection_idempotent(c):
    p1 = color.nes_quantize(jnp.asarray(c), False)
    p2 = color.nes_quantize(p1, False)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_remap_output_ranges(seed):
    from snesimage.ops.remap import remap_undithered

    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    tp = rng.integers(0, 2, (2, 2)).astype(np.int32)
    pal = rng.integers(0, 32, (2, 3, 3)).astype(np.int32)
    pm = np.asarray(
        remap_undithered(
            jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp), jnp.asarray(pal), False,
        )
    )
    assert pm.min() >= 0 and pm.max() < 3
    # transparent pixels are always index 0
    assert (pm[rgba[..., 3] == 0] == 0).all()
