"""Structural tests for the SSIMULACRA2 metric (ops/ssimulacra2.py).

The upstream Rust crate cannot run in this environment, so these tests pin
the metric's structural contract: perfect score for identical frames,
strict monotonicity under increasing distortion, batching consistency, and
the documented behavior of the building blocks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from snesimage.ops.ssimulacra2 import (
    blur,
    downsample2,
    linear_rgb_to_positive_xyb,
    reference_pyramid,
    ssimulacra2,
    ssimulacra2_from_ref,
)


def _img(rng, h=64, w=64):
    base = rng.random((h, w, 3)).astype(np.float32)
    # smooth it a little so it resembles a natural image
    k = np.ones((4, 4)) / 16.0
    for c in range(3):
        base[..., c] = np.real(
            np.fft.ifft2(np.fft.fft2(base[..., c]) * np.fft.fft2(k, (h, w)))
        )
    return np.clip(base, 0, 1).astype(np.float32)


def test_identical_is_near_100(rng):
    img = _img(rng)
    s = float(ssimulacra2(jnp.asarray(img), jnp.asarray(img)))
    assert s > 99.9


def test_monotone_in_noise(rng):
    img = _img(rng)
    scores = []
    for sigma in (0.0, 0.01, 0.05, 0.1, 0.3):
        noisy = np.clip(img + rng.normal(0, sigma, img.shape), 0, 1).astype(np.float32)
        scores.append(float(ssimulacra2(jnp.asarray(img), jnp.asarray(noisy))))
    assert all(a > b for a, b in zip(scores, scores[1:])), scores


def test_blur_detected_as_distortion(rng):
    img = _img(rng)
    blurred = np.asarray(blur(jnp.asarray(img)))
    s = float(ssimulacra2(jnp.asarray(img), jnp.asarray(blurred)))
    assert s < 95.0


def test_asymmetry(rng):
    """SSIMULACRA2 is a full-reference, asymmetric metric: blurring the
    distorted image (detail loss) need not score like sharpening."""
    img = _img(rng)
    blurred = np.asarray(blur(jnp.asarray(img)))
    ab = float(ssimulacra2(jnp.asarray(img), jnp.asarray(blurred)))
    ba = float(ssimulacra2(jnp.asarray(blurred), jnp.asarray(img)))
    assert ab != pytest.approx(ba, abs=1e-6)


@pytest.mark.slow
def test_vmap_matches_loop(rng):
    img = _img(rng)
    dis = np.stack(
        [
            np.clip(img + rng.normal(0, s, img.shape), 0, 1).astype(np.float32)
            for s in (0.01, 0.05, 0.2)
        ]
    )
    refp = reference_pyramid(jnp.asarray(img))
    batched = np.asarray(
        jax.vmap(lambda d: ssimulacra2_from_ref(refp, d))(jnp.asarray(dis))
    )
    single = np.array(
        [float(ssimulacra2(jnp.asarray(img), jnp.asarray(d))) for d in dis]
    )
    # batched vs unbatched compilations differ by f32 cancellation noise
    # in the variance terms (~0.02 in score units; see module notes)
    np.testing.assert_allclose(batched, single, atol=0.05)


def test_downsample2_box_average():
    img = jnp.arange(16, dtype=jnp.float32).reshape(4, 4, 1)
    out = np.asarray(downsample2(img))
    np.testing.assert_allclose(out[0, 0, 0], np.mean([0, 1, 4, 5]))
    np.testing.assert_allclose(out[1, 1, 0], np.mean([10, 11, 14, 15]))


def test_downsample2_odd_replicates_edge():
    img = jnp.ones((5, 5, 1), dtype=jnp.float32)
    out = np.asarray(downsample2(img))
    assert out.shape == (3, 3, 1)
    np.testing.assert_allclose(out, 1.0)


def test_blur_preserves_constant_interior():
    img = jnp.full((64, 64, 3), 0.5, dtype=jnp.float32)
    out = np.asarray(blur(img))
    # away from zero-padded borders the normalized kernel is exact
    np.testing.assert_allclose(out[16:-16, 16:-16], 0.5, atol=1e-5)
    # borders attenuate (zero padding), matching the IIR zero-state
    assert out[0, 0, 0] < 0.5


def test_xyb_positive_range():
    lin = jnp.asarray(
        np.stack(
            np.meshgrid(*([np.linspace(0, 1, 8)] * 3), indexing="ij"), axis=-1
        ).reshape(1, -1, 3),
        dtype=jnp.float32,
    )
    xyb = np.asarray(linear_rgb_to_positive_xyb(lin))
    # the affine shifts exist to make all channels positive
    assert xyb.min() > 0.0


def test_score_upper_bound(rng):
    img = _img(rng)
    worst = 1.0 - img  # inverted
    s = float(ssimulacra2(jnp.asarray(img), jnp.asarray(worst)))
    assert s <= 100.0


@pytest.mark.slow
def test_gradients_flow(rng):
    """The metric is differentiable end-to-end (enables future
    gradient-based palette refinement, something the reference cannot do)."""
    img = _img(rng, 32, 32)
    refp = reference_pyramid(jnp.asarray(img))
    g = jax.grad(lambda d: ssimulacra2_from_ref(refp, d))(jnp.asarray(img * 0.9))
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


def test_golden_score_values():
    """Pin concrete scores of the current weight table (consts provenance:
    ops/ssimulacra2_consts.py). Guards against silent weight/layout
    regressions — any intentional table change must regenerate these.
    CPU-backend values (conftest forces cpu); tolerance covers fused-op
    reassociation, not weight changes."""
    rng = np.random.default_rng(1234)
    img = _img(rng, 128, 128)
    expected = {0.02: 59.7591, 0.1: -59.0412}
    for sigma, want in expected.items():
        noisy = np.clip(img + rng.normal(0, sigma, img.shape), 0, 1).astype(
            np.float32
        )
        got = float(ssimulacra2(jnp.asarray(img), jnp.asarray(noisy)))
        assert abs(got - want) < 0.05, (sigma, got, want)
    half = img[::2, ::2].repeat(2, 0).repeat(2, 1)
    got = float(ssimulacra2(jnp.asarray(img), jnp.asarray(half)))
    assert abs(got - (-40.0645)) < 0.05, got


@pytest.mark.slow
def test_multiscale_fused_block_matches_xla(rng):
    """The channel-major feature block (start scale, scale count, input
    resolution) must match the feature path it wraps, scale for scale."""
    from snesimage.ops.ssimulacra2 import (
        fused_scale_feature_block,
        reference_pyramid,
        scale_features,
    )

    h = w = 64
    ref = jnp.asarray(_img(rng, h, w))
    refp = reference_pyramid(ref)
    frames = jnp.asarray(rng.random((2, h, w, 3)).astype(np.float32))
    frames_cmaj = jnp.moveaxis(frames, -1, 1)

    for start, num in ((0, 2), (2, 4), (0, 6)):
        if start:
            fr = frames
            for _ in range(start):
                fr = downsample2(fr)
            fr_cmaj = jnp.moveaxis(fr, -1, 1)
        else:
            fr, fr_cmaj = frames, frames_cmaj
        got = np.asarray(
            fused_scale_feature_block(refp, fr_cmaj, start, num)
        )
        want = np.asarray(
            scale_features(
                refp, fr, skip_scales=start, input_scale=start,
                max_scale=start + num,
            )
        )
        assert got.shape == want.shape == (2, 6, 3, 6)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
