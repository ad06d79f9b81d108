"""SSIMULACRA2 perceptual metric as batched, jit/vmap-able JAX ops.

Replacement for the Rust `ssimulacra2` crate v0.5.1 used as the
reference's objective function (reference: src/lib.rs:503-548): the score
is ``100 - ssimulacra2(src, dst)`` with lower-is-better "error" semantics
handled by the caller.

Pipeline (SSIMULACRA2 v2.1 structure):
  1. sRGB [0,1] -> linear RGB (sRGB EOTF).
  2. 6-scale pyramid: 2x2 box downsample in linear RGB per scale.
  3. Per scale: linear RGB -> XYB (libjxl opsin) -> affine "positive XYB".
  4. Gaussian blur (sigma 1.5) of {img, img^2, img1*img2} per channel.
  5. Per-channel SSIM map + two asymmetric edge-difference maps
     (ringing/artifact and detail-loss), aggregated with 1-norm and
     4-norm -> 108 features -> weighted sum -> polynomial -> score <= 100.

Design choices (documented deviations from upstream):
  - Blur is a separable FIR Gaussian (radius 8, zero-padded) computed as
    two banded matmuls, instead of libjxl's recursive IIR
    approximation of the same Gaussian. Both approximate a true Gaussian;
    differences are ~1e-3 relative near borders.
  - f32 throughout (upstream aggregates in f64); mean reductions use XLA's
    pairwise summation.
  - See ops/ssimulacra2_consts.py for the provenance of fitted constants.

The reference half of the computation (pyramid, blurred moments of the
original image) is candidate-independent, so `reference_pyramid` +
`ssimulacra2_from_ref` lets the refine loop amortize ~40% of the metric
across hundreds of candidate frames; `ssimulacra2_from_ref` is vmap-able
over the distorted input.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from snesimage.ops.color import srgb01_to_linear, srgb_u8_to_linear
from snesimage.ops.ssimulacra2_consts import (
    GAUSSIAN_SIGMA,
    NUM_SCALES,
    OPSIN_BIAS,
    OPSIN_MATRIX,
    SCORE_P1,
    SCORE_P2,
    SCORE_P3,
    SCORE_POW,
    SCORE_SCALE,
    SSIM_C2,
    WEIGHTS,
    XYB_B_OFFSET,
    XYB_X_OFFSET,
    XYB_X_SCALE,
    XYB_Y_OFFSET,
)

_BLUR_RADIUS = 8
# jax.named_scope of the metric's ops: names their device time in profiler
# traces (utils/profiling.py device_summary).
SCOPE = "ssimulacra2"


@lru_cache(maxsize=None)
def _blur_matrix(n: int) -> np.ndarray:
    """Banded (n, n) matrix applying a normalized FIR Gaussian (sigma 1.5)
    with zero padding outside the image (matches the IIR zero-state)."""
    x = np.arange(-_BLUR_RADIUS, _BLUR_RADIUS + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / GAUSSIAN_SIGMA) ** 2)
    k /= k.sum()
    mat = np.zeros((n, n), dtype=np.float32)
    for off, w in zip(range(-_BLUR_RADIUS, _BLUR_RADIUS + 1), k):
        idx = np.arange(max(0, -off), min(n, n - off))
        mat[idx, idx + off] = w
    return mat


def blur(img: jax.Array) -> jax.Array:
    """Separable Gaussian blur over the (-3, -2) spatial axes via matmuls.

    img: (..., H, W, C). Two dense banded matmuls (<= 256 wide), which
    XLA hands to the BLAS library.
    """
    h, w = img.shape[-3], img.shape[-2]
    bh = jnp.asarray(_blur_matrix(h))
    bw = jnp.asarray(_blur_matrix(w))
    # precision="highest": reduced-precision f32 matmuls (TF32, bf16
    # passes) carry ~1e-3 relative error, which the SSIM variance terms
    # amplify ~100x through cancellation. Every f32 contraction in the
    # package is pinned the same way (tests/test_precision.py).
    tmp = jnp.einsum(
        "hj,...jwc->...hwc",
        bh,
        img,
        precision="highest",
        preferred_element_type=jnp.float32,
    )
    return jnp.einsum(
        "wk,...hkc->...hwc",
        bw,
        tmp,
        precision="highest",
        preferred_element_type=jnp.float32,
    )


def downsample2(img: jax.Array) -> jax.Array:
    """2x2 box downsample with edge-replicate for odd sizes, /4 normalize
    (upstream Downsample clamps the sample coordinate and divides by 4)."""
    h, w = img.shape[-3], img.shape[-2]
    ph, pw = h % 2, w % 2
    if ph or pw:
        pad = [(0, 0)] * (img.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
        img = jnp.pad(img, pad, mode="edge")
    h2, w2 = (h + ph) // 2, (w + pw) // 2
    r = img.reshape(*img.shape[:-3], h2, 2, w2, 2, img.shape[-1])
    return r.mean(axis=(-4, -2))


def linear_rgb_to_positive_xyb(lin: jax.Array) -> jax.Array:
    """Linear RGB -> XYB (libjxl opsin) -> v2.1 positive-XYB affine map."""
    m = jnp.asarray(OPSIN_MATRIX, dtype=jnp.float32)
    bias = jnp.float32(OPSIN_BIAS)
    mixed = (
        jnp.matmul(
            lin.astype(jnp.float32), m.T, precision=jax.lax.Precision.HIGHEST
        )
        + bias
    )
    lms = jnp.cbrt(mixed) - jnp.cbrt(bias)
    x = 0.5 * (lms[..., 0] - lms[..., 1])
    y = 0.5 * (lms[..., 0] + lms[..., 1])
    b = lms[..., 2]
    # make_positive_xyb: b=(b-y)+0.55, x=x*14+0.42, y=y+0.01
    return jnp.stack(
        [x * XYB_X_SCALE + XYB_X_OFFSET, y + XYB_Y_OFFSET, (b - y) + XYB_B_OFFSET],
        axis=-1,
    )


def _norms(d: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-channel 1-norm (mean) and 4-norm over the spatial axes.

    d: (..., H, W, C) -> two (..., C) arrays. The fourth root is guarded
    at zero so the metric stays differentiable (an all-zero map — e.g. the
    detail-loss map of an identical pair — would otherwise produce NaN
    gradients through sqrt'(0))."""
    one = jnp.mean(d, axis=(-3, -2))
    m4 = jnp.mean(d**4, axis=(-3, -2))
    four = jnp.where(m4 > 0, jnp.where(m4 > 0, m4, 1.0) ** 0.25, 0.0)
    return one, four


def _scale_features(
    img1: jax.Array,
    mu1: jax.Array,
    s11: jax.Array,
    img2: jax.Array,
) -> jax.Array:
    """Per-scale feature vector, shape (..., C, 6):
    [ssim1, art1, det1, ssim4, art4, det4] per channel."""
    return _features_from_moments(
        img1, mu1, s11, img2, *_distorted_moments(img1, img2)
    )


def _distorted_moments(img1: jax.Array, img2: jax.Array):
    """Blurred (mu2, s22, s12) of the distorted frame at one scale."""
    return blur(img2), blur(img2 * img2), blur(img1 * img2)


def _features_from_moments(img1, mu1, s11, img2, mu2, s22, s12) -> jax.Array:
    """SSIM and edge maps of one scale, reduced to its (..., C, 6)
    features. The variances s - mu^2 cancel: at f32 a 1-ulp change of a
    blurred moment moves the score of a noisy frame by up to ~1e-2
    (tools/backend_gap.py, PERF.md)."""
    mu11 = mu1 * mu1
    mu22 = mu2 * mu2
    mu12 = mu1 * mu2
    mu_diff = mu1 - mu2
    num_m = 1.0 - mu_diff * mu_diff
    num_s = 2.0 * (s12 - mu12) + SSIM_C2
    denom_s = (s11 - mu11) + (s22 - mu22) + SSIM_C2
    ssim_d = jnp.maximum(1.0 - (num_m * num_s) / denom_s, 0.0)
    ssim1, ssim4 = _norms(ssim_d)

    d1 = (1.0 + jnp.abs(img2 - mu2)) / (1.0 + jnp.abs(img1 - mu1)) - 1.0
    art1, art4 = _norms(jnp.maximum(d1, 0.0))
    det1, det4 = _norms(jnp.maximum(-d1, 0.0))

    return jnp.stack([ssim1, art1, det1, ssim4, art4, det4], axis=-1)


def _decode_srgb(img: jax.Array) -> jax.Array:
    """sRGB -> linear. Integer inputs take the exact u8 LUT (bit-exact
    on every backend, whatever its `pow` error); float inputs in [0,1]
    take the analytic transfer curve."""
    if jnp.issubdtype(img.dtype, jnp.integer):
        return srgb_u8_to_linear(img)
    return srgb01_to_linear(img)


def reference_pyramid(ref01: jax.Array):
    """Precompute the candidate-independent half of the metric.

    ref01: (..., H, W, 3) sRGB in [0,1] (float) or 8-bit (integer).
    Returns a pytree of per-scale (img1, mu1, s11) tuples in positive-XYB
    space.
    """
    lin = _decode_srgb(ref01)
    scales = []
    with jax.named_scope(SCOPE):
        for s in range(NUM_SCALES):
            if s:
                lin = downsample2(lin)
            img1 = linear_rgb_to_positive_xyb(lin)
            scales.append((img1, blur(img1), blur(img1 * img1)))
    return tuple(scales)


def ssimulacra2_from_ref(refp, dis01: jax.Array) -> jax.Array:
    """Score a distorted frame against a precomputed reference pyramid.

    dis01: (..., H, W, 3) sRGB in [0,1] (float) or 8-bit (integer); vmap
    over leading axes to score candidate batches. Returns scalar (or
    batched) f32 score <= 100.
    """
    return ssimulacra2_from_ref_linear(refp, _decode_srgb(dis01))


def scale_features(
    refp,
    lin2: jax.Array,
    *,
    skip_scales: int = 0,
    input_scale: int = 0,
    max_scale: int = NUM_SCALES,
) -> jax.Array:
    """Per-scale feature tensor (..., NUM_SCALES, 3, 6); scales outside
    [max(skip_scales, input_scale), max_scale) are zero.

    skip_scales > 0 drops the finest scales' features (their weights
    become zero) — used by the refine loop's coarse prescreen ranking.
    input_scale > 0 declares that `lin2` is ALREADY at that pyramid
    scale's resolution (the caller downsampled it, e.g. via the exact
    pooled-mask construction in core/refine.py); requires
    input_scale <= skip_scales since finer scales cannot be computed.
    max_scale < NUM_SCALES computes only the finest scales — the refine
    loop sums such a tensor with a coarse prescreen tensor (disjoint
    scale slots) to assemble full-metric features for finalists without
    recomputing scales 2..5.
    """
    feats = []
    zero_feat = jnp.zeros(lin2.shape[:-3] + (3, 6), jnp.float32)
    assert input_scale <= skip_scales
    with jax.named_scope(SCOPE):
        for s in range(NUM_SCALES):
            if s < input_scale or s >= max_scale:
                feats.append(zero_feat)
                continue
            if s > input_scale:
                lin2 = downsample2(lin2)
            if s < skip_scales:
                feats.append(zero_feat)
                continue
            img1, mu1, s11 = refp[s]
            img2 = linear_rgb_to_positive_xyb(lin2)
            feats.append(_scale_features(img1, mu1, s11, img2))
        return jnp.stack(feats, axis=-3)  # (..., scales, C, 6)


def fused_scale_feature_block(
    refp,
    frames_cmaj: jax.Array,
    start_scale: int,
    num_scales: int,
    *,
    pre_ds: int = 0,
) -> jax.Array:
    """Feature tensor of `num_scales` consecutive scales from channel-major
    linear-RGB frames.

    frames_cmaj: (B, 3, h, w) linear RGB at scale `start_scale - pre_ds`'s
    resolution (pre_ds 2x2 downsamplings run first, exactly like the
    pyramid's). Returns (B, NUM_SCALES, 3, 6) with zeros outside
    [start_scale, start_scale + num_scales).
    """
    frames = jnp.moveaxis(frames_cmaj, 1, -1)
    return scale_features(
        refp,
        frames,
        skip_scales=start_scale,
        input_scale=start_scale - pre_ds,
        max_scale=start_scale + num_scales,
    )


def ssim_weighted_sum(f: jax.Array) -> jax.Array:
    """(..., NUM_SCALES, 3, 6) features -> the pre-nonlinearity weighted
    |feature| sum (the `ssim` accumulator of the upstream scoring).

    Because every feature tensor this framework combines has DISJOINT
    scale support (feats_0 / feats_1 / feats_c populate different scale
    rows and are zero elsewhere), abs distributes over their sum and this
    weighted sum decomposes EXACTLY:
    ssim_weighted_sum(f0 + f1 + fc) = wsum(f0) + wsum(f1) + wsum(fc).
    The rank1 visit gate (core/refine.py) relies on this to carry the
    current state's scale-0 term as a single scalar."""
    # (..., scales, C, 6) -> weight-ordered (..., C, scales, n, metric)
    with jax.named_scope(SCOPE):
        f = jnp.moveaxis(f, -2, -3)  # (..., C, scales, 6)
        f = f.reshape(*f.shape[:-1], 2, 3)  # 6 -> (n, metric)
        flat = jnp.abs(f).reshape(*f.shape[:-4], 108)
        return jnp.matmul(
            flat,
            jnp.asarray(WEIGHTS, dtype=jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
        )


def score_from_ssim_sum(ssim: jax.Array) -> jax.Array:
    """Weighted |feature| sum -> SSIMULACRA2 score (<= 100): the upstream
    scale + fitted cubic + power nonlinearity."""
    with jax.named_scope(SCOPE):
        ssim = ssim * SCORE_SCALE
        ssim = SCORE_P3 * ssim**3 - SCORE_P2 * ssim**2 + SCORE_P1 * ssim
        return jnp.where(
            ssim > 0.0,
            100.0 - 10.0 * jnp.maximum(ssim, 1e-30) ** SCORE_POW,
            100.0,
        )


def score_from_features(f: jax.Array) -> jax.Array:
    """(..., NUM_SCALES, 3, 6) features -> SSIMULACRA2 score (<= 100)."""
    return score_from_ssim_sum(ssim_weighted_sum(f))


def ssimulacra2_from_ref_linear(
    refp, lin2: jax.Array, *, skip_scales: int = 0, input_scale: int = 0
) -> jax.Array:
    """Like `ssimulacra2_from_ref` but takes an already-linear RGB frame.

    This is the refine loop's hot entry: rendered candidate frames are
    produced directly in linear space (ops/remap.py `render_linear`), so
    no per-pixel transfer decode runs per candidate.

    skip_scales/input_scale: see `scale_features`. Skipped-scale scores
    are only used to pre-rank candidate batches (core/refine.py
    prescreen), never reported.
    """
    return score_from_features(
        scale_features(
            refp, lin2, skip_scales=skip_scales, input_scale=input_scale
        )
    )


@jax.jit
def ssimulacra2(ref01: jax.Array, dis01: jax.Array) -> jax.Array:
    """Full-reference SSIMULACRA2 score (100 = identical, lower = worse)."""
    return ssimulacra2_from_ref(reference_pyramid(ref01), dis01)
