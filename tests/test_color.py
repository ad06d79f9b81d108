"""Unit tests for color kernels against the reference formulas and the
serial C++ oracle (SURVEY.md §4 test strategy, item b)."""

import numpy as np
import jax.numpy as jnp
import pytest

from snesimage.constants import NES_PALETTE_5BIT
from snesimage.native import oracle_ciede2000, oracle_red_mean, oracle_srgb_to_lab
from snesimage.ops import color


def test_expand_5bit_to_8bit_endpoints():
    c = jnp.arange(32)
    out = np.asarray(color.expand_5bit_to_8bit(c))
    # c*8 + c//4 (reference src/lib.rs:662-669)
    assert out[0] == 0
    assert out[31] == 255
    np.testing.assert_array_equal(out, np.arange(32) * 8 + np.arange(32) // 4)


def test_expand_5bit_clamps_out_of_range():
    assert int(color.expand_5bit_to_8bit(jnp.asarray(32))) == 255
    assert int(color.expand_5bit_to_8bit(jnp.asarray(-1))) == 0


def test_pack_bgr555():
    # r | g<<5 | b<<10 (reference src/lib.rs:679-681)
    assert int(color.pack_bgr555(jnp.asarray([31, 0, 0]))) == 31
    assert int(color.pack_bgr555(jnp.asarray([0, 31, 0]))) == 31 << 5
    assert int(color.pack_bgr555(jnp.asarray([0, 0, 31]))) == 31 << 10
    assert int(color.pack_bgr555(jnp.asarray([1, 2, 3]))) == 1 + (2 << 5) + (3 << 10)


def test_red_mean_matches_oracle(rng):
    c1 = rng.integers(0, 256, (64, 3))
    c2 = rng.integers(0, 256, (64, 3))
    scaled = np.asarray(color.red_mean_sq_scaled(jnp.asarray(c1), jnp.asarray(c2)))
    for a, b, s in zip(c1, c2, scaled):
        want = oracle_red_mean(a, b)
        got = np.sqrt(s / 512.0)
        assert got == pytest.approx(want, rel=1e-12)


def test_red_mean_scaled_is_exact_integer(rng):
    c1 = rng.integers(0, 256, (256, 3))
    c2 = rng.integers(0, 256, (256, 3))
    s = np.asarray(color.red_mean_sq_scaled(jnp.asarray(c1), jnp.asarray(c2)))
    assert s.dtype == np.int32
    assert (s >= 0).all()


def test_srgb_to_lab_matches_oracle(rng):
    cs = rng.integers(0, 256, (64, 3))
    lab = np.asarray(color.srgb_u8_to_lab(jnp.asarray(cs)))
    for c, l in zip(cs, lab):
        want = oracle_srgb_to_lab(c)
        np.testing.assert_allclose(l, want, atol=2e-3)


def test_lab_round_trip(rng):
    cs = rng.integers(0, 256, (128, 3))
    lab = color.srgb_u8_to_lab(jnp.asarray(cs))
    back = np.asarray(color.lab_to_srgb_u8(lab))
    # f32 conversion noise can shift a channel by 1 at rounding boundaries
    assert np.abs(back - cs).max() <= 1
    assert (np.abs(back - cs) <= 0).mean() > 0.9


def test_ciede2000_matches_oracle(rng):
    c1 = rng.integers(0, 256, (64, 3))
    c2 = rng.integers(0, 256, (64, 3))
    got = np.asarray(color.ciede2000_srgb_u8(jnp.asarray(c1), jnp.asarray(c2)))
    for a, b, g in zip(c1, c2, got):
        want = oracle_ciede2000(a, b)
        assert g == pytest.approx(want, abs=5e-3)


def test_ciede2000_identical_is_zero(rng):
    cs = rng.integers(0, 256, (32, 3))
    d = np.asarray(color.ciede2000_srgb_u8(jnp.asarray(cs), jnp.asarray(cs)))
    np.testing.assert_allclose(d, 0.0, atol=1e-5)


def test_ciede2000_symmetry(rng):
    c1 = rng.integers(0, 256, (32, 3))
    c2 = rng.integers(0, 256, (32, 3))
    d12 = np.asarray(color.ciede2000_srgb_u8(jnp.asarray(c1), jnp.asarray(c2)))
    d21 = np.asarray(color.ciede2000_srgb_u8(jnp.asarray(c2), jnp.asarray(c1)))
    np.testing.assert_allclose(d12, d21, atol=1e-4)


def test_nes_quantize_fixed_points():
    """Each NES color projects onto an identical-valued NES color (the
    table has duplicates — (0,0,0) at 13 and 27 — so indices may differ
    but values must match)."""
    nes = jnp.asarray(NES_PALETTE_5BIT)
    for perceptual in (False, True):
        out = np.asarray(color.nes_quantize(nes, perceptual))
        np.testing.assert_array_equal(out, np.asarray(NES_PALETTE_5BIT))


def test_nes_quantize_first_index_wins():
    """A color equidistant from duplicate entries resolves to the first
    (strict less-than scan, reference src/lib.rs:646-657)."""
    out = np.asarray(color.nes_quantize(jnp.asarray([0, 0, 0]), False))
    np.testing.assert_array_equal(out, [0, 0, 0])


def test_nes_quantize_matches_oracle_bruteforce(rng):
    """Cross-check projection against a brute-force scan with the oracle
    distance for a sample of colors."""
    nes8 = np.asarray(color.expand_5bit_to_8bit(jnp.asarray(NES_PALETTE_5BIT)))
    samples = rng.integers(0, 32, (32, 3))
    got = np.asarray(color.nes_quantize(jnp.asarray(samples), False))
    for c5, g in zip(samples, got):
        c8 = np.asarray(color.expand_5bit_to_8bit(jnp.asarray(c5)))
        best, best_err = 0, float("inf")
        for idx in range(56):
            err = oracle_red_mean(c8, nes8[idx])
            if err < best_err:
                best_err, best = err, idx
        np.testing.assert_array_equal(g, NES_PALETTE_5BIT[best])
