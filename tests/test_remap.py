"""Remap + render kernels vs the serial C++ oracle (exact for the integer
red-mean path, tolerance-checked for f32 CIEDE2000)."""

import numpy as np
import pytest
import jax.numpy as jnp

from snesimage.native import oracle_remap
from snesimage.ops.color import expand_5bit_to_8bit
from snesimage.ops.dither import remap_dithered
from snesimage.ops.remap import remap_undithered, render_rgb8


def _setup(rng, h=32, w=32, c=2, s=4):
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgba[..., 3] = 255
    rgba[0:8, 0:8, 3] = 0  # one transparent tile
    tp = rng.integers(0, c, (h // 8, w // 8)).astype(np.int32)
    pal = rng.integers(0, 32, (c, s, 3)).astype(np.int32)
    return rgba, tp, pal


def test_undithered_matches_oracle_exactly(rng):
    rgba, tp, pal = _setup(rng)
    want = oracle_remap(rgba, tp, pal, dither=False, perceptual=False)
    got = np.asarray(
        remap_undithered(
            jnp.asarray(rgba[..., :3]),
            jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp),
            jnp.asarray(pal),
            False,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_undithered_perceptual_close_to_oracle(rng):
    rgba, tp, pal = _setup(rng)
    want = oracle_remap(rgba, tp, pal, dither=False, perceptual=True)
    got = np.asarray(
        remap_undithered(
            jnp.asarray(rgba[..., :3]),
            jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp),
            jnp.asarray(pal),
            True,
        )
    )
    # f32 CIEDE2000 vs f64 can flip near-ties on a tiny fraction of pixels.
    agree = (got == want).mean()
    assert agree > 0.995, f"agreement {agree}"


def test_dithered_matches_oracle(rng):
    rgba, tp, pal = _setup(rng)
    want = oracle_remap(rgba, tp, pal, dither=True, perceptual=False)
    got = np.asarray(
        remap_dithered(
            jnp.asarray(rgba[..., :3]),
            jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp),
            jnp.asarray(pal),
            False,
        )
    )
    agree = (got == want).mean()
    # f32 error accumulation vs the oracle's f64 can flip near-ties.
    assert agree > 0.99, f"agreement {agree}"


def test_dithered_zero_weights_equals_undithered(rng):
    """With dithering disabled the reference still runs the scan with zero
    weights (src/lib.rs:426-432); our parallel remap must equal the scan."""
    rgba, tp, pal = _setup(rng)
    import snesimage.ops.dither as dither_mod
    import snesimage.constants as consts

    # Run the wavefront scan with zeroed weights via monkeypatch-free path:
    # the oracle with dither=False IS the zero-weight scan.
    want = oracle_remap(rgba, tp, pal, dither=False, perceptual=False)
    got = np.asarray(
        remap_undithered(
            jnp.asarray(rgba[..., :3]),
            jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp),
            jnp.asarray(pal),
            False,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_transparent_pixels_map_to_zero(rng):
    rgba, tp, pal = _setup(rng)
    for dither in (False, True):
        want = oracle_remap(rgba, tp, pal, dither=dither, perceptual=False)
        assert (want[0:8, 0:8] == 0).all()
        if dither:
            got = remap_dithered(
                jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
                jnp.asarray(tp), jnp.asarray(pal), False,
            )
        else:
            got = remap_undithered(
                jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
                jnp.asarray(tp), jnp.asarray(pal), False,
            )
        assert (np.asarray(got)[0:8, 0:8] == 0).all()


def test_dither_error_flows_through_transparent(rng):
    """Transparent pixels pass accumulated error to their neighbors
    (src/lib.rs:463-475) — verified transitively: wavefront output matches
    the oracle on an image with interior transparency."""
    rgba, tp, pal = _setup(rng)
    rgba[12:20, 12:20, 3] = 0  # transparent block in the interior
    want = oracle_remap(rgba, tp, pal, dither=True, perceptual=False)
    got = np.asarray(
        remap_dithered(
            jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp), jnp.asarray(pal), False,
        )
    )
    assert (got == want).mean() > 0.99


def test_render_rgb8(rng):
    rgba, tp, pal = _setup(rng)
    pm = remap_undithered(
        jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
        jnp.asarray(tp), jnp.asarray(pal), False,
    )
    out = np.asarray(
        render_rgb8(pm, jnp.asarray(rgba[..., 3]), jnp.asarray(tp), jnp.asarray(pal))
    )
    # Transparent pixels are black (src/lib.rs:570-572).
    assert (out[0:8, 0:8] == 0).all()
    # Opaque pixels show the mapped entry's 8-bit expansion.
    entries8 = np.asarray(expand_5bit_to_8bit(jnp.asarray(pal)))
    y, x = 16, 16
    e = entries8[tp[y // 8, x // 8], np.asarray(pm)[y, x]]
    np.testing.assert_array_equal(out[y, x], e)


def test_candidate_vmap_batches(rng):
    import jax

    rgba, tp, pal = _setup(rng)
    pals = jnp.asarray(np.stack([pal, (pal + 1) % 32, (pal + 7) % 32]))
    got = jax.vmap(
        lambda p: remap_undithered(
            jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp), p, False,
        )
    )(pals)
    assert got.shape == (3, 32, 32)
    for i in range(3):
        want = oracle_remap(rgba, tp, np.asarray(pals[i]), False, False)
        np.testing.assert_array_equal(np.asarray(got[i]), want)


def test_dither_candidates_xla_fallback_matches_per_palette(rng):
    """dither_candidates vmaps the scan over candidates; results must
    equal remapping each candidate palette individually."""
    from snesimage.ops.dither import dither_candidates

    rgba, tp, pal = _setup(rng, h=16, w=16, c=2, s=3)
    cands = jnp.asarray(rng.integers(0, 32, (2, 3)), dtype=jnp.int32)
    p, i = 0, 1
    maps = np.asarray(
        dither_candidates(
            jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp), jnp.asarray(pal), p, i, cands, False,
        )
    )
    for b in range(2):
        pal_b = np.asarray(pal).copy()
        pal_b[p, i] = np.asarray(cands[b])
        want = np.asarray(
            remap_dithered(
                jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
                jnp.asarray(tp), jnp.asarray(pal_b), False,
            )
        )
        np.testing.assert_array_equal(maps[b], want)


def test_dithered_perceptual_matches_oracle(rng):
    """The perceptual+dither combination against the f64 oracle."""
    rgba, tp, pal = _setup(rng, h=16, w=16, c=2, s=3)
    want = oracle_remap(rgba, tp, pal, dither=True, perceptual=True)
    got = np.asarray(
        remap_dithered(
            jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp), jnp.asarray(pal), True,
        )
    )
    agree = (got == want).mean()
    assert agree > 0.97, f"agreement {agree}"


def _dither_setup(rng, h=16, w=16, c=2, s=4):
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgba[..., 3] = 255
    rgba[0:8, 0:8, 3] = 0
    tp = rng.integers(0, c, (h // 8, w // 8)).astype(np.int32)
    pal = rng.integers(0, 32, (c, s, 3)).astype(np.int32)
    return rgba, tp, pal


@pytest.mark.parametrize("perceptual,bound", [(False, 0.98), (True, 0.95)])
def test_dither_candidates_matches_oracle(rng, perceptual, bound):
    """Every candidate's dithered map (slot (p, i) overridden by the
    candidate color) must agree with the serial C++ oracle run on that
    candidate's palette."""
    from snesimage.ops.dither import dither_candidates

    rgba, tp, pal = _dither_setup(rng)
    p, i = 1, 2
    cands = rng.integers(0, 32, (3, 3)).astype(np.int32)
    maps = np.asarray(
        dither_candidates(
            jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp), jnp.asarray(pal), p, i, jnp.asarray(cands),
            perceptual,
        )
    )
    for b, c5 in enumerate(cands):
        pal_b = pal.copy()
        pal_b[p, i] = c5
        want = oracle_remap(rgba, tp, pal_b, dither=True, perceptual=perceptual)
        agree = (maps[b] == want).mean()
        assert agree > bound, f"candidate {b}: agreement {agree}"


def test_dither_candidates_vmap_over_images(rng):
    """jax.vmap over a leading image axis (the batched paths) must
    reproduce per-image calls exactly."""
    import jax

    from snesimage.ops.dither import dither_candidates

    setups = [_dither_setup(rng) for _ in range(2)]
    imgs, tps, pals = (np.stack(x) for x in zip(*setups))
    cands = jnp.asarray(rng.integers(0, 32, (3, 3)).astype(np.int32))
    p, i = 0, 1

    def one(img, tp, pal):
        return dither_candidates(
            img[..., :3], img[..., 3], tp, pal, p, i, cands, False
        )

    batched = jax.vmap(one)(jnp.asarray(imgs), jnp.asarray(tps),
                            jnp.asarray(pals))
    for k in range(2):
        single = one(jnp.asarray(imgs[k]), jnp.asarray(tps[k]),
                     jnp.asarray(pals[k]))
        np.testing.assert_array_equal(np.asarray(batched[k]),
                                      np.asarray(single))


@pytest.mark.parametrize("perceptual", [False, True])
def test_dither_candidates_seed_vmap_matches_per_seed(rng, perceptual):
    """The portfolio batching pattern — ONE shared image, vmap only over
    per-seed palettes and candidate colors — must reproduce per-seed
    calls exactly."""
    import jax

    from snesimage.ops.dither import dither_candidates

    rgba, tp, _ = _dither_setup(rng)
    g = 3
    pals = jnp.asarray(rng.integers(0, 32, (g, 2, 4, 3)).astype(np.int32))
    cands = jnp.asarray(rng.integers(0, 32, (g, 5, 3)).astype(np.int32))
    rgb, alpha, tpj = (jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
                       jnp.asarray(tp))
    p, i = 1, 2

    def one(pal, c):
        return dither_candidates(rgb, alpha, tpj, pal, p, i, c, perceptual)

    folded = jax.vmap(one)(pals, cands)
    for k in range(g):
        np.testing.assert_array_equal(
            np.asarray(folded[k]), np.asarray(one(pals[k], cands[k]))
        )
