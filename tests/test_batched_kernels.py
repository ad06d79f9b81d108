"""Image-batched prescreen and metric entry points under vmap.

The batched paths (parallel/batch.py) vmap the slot-visit machinery over
an image or seed axis, directly and through jit (vmap-of-jit). These tests
drive the pooled win masks, the colour select and the channel-major
feature block both ways and pin them against plain numpy loops (or the
per-image feature path).
"""

import jax
import jax.numpy as jnp
import numpy as np

from snesimage.ops import prescreen as ps

N, B, H, W = 2, 3, 16, 16


def _pool_np(m, ml):
    """numpy loop reference: (B, H, W) masks -> (B, 4, H/4, W/4) sums of
    [m, m*ml_r, m*ml_g, m*ml_b] over 4x4 blocks."""
    b, h, w = m.shape
    out = np.zeros((b, 4, h // 4, w // 4), np.float64)
    for k in range(b):
        maps = [m[k]] + [m[k] * ml[c] for c in range(3)]
        for c, mp in enumerate(maps):
            for y in range(h // 4):
                for x in range(w // 4):
                    out[k, c, y, x] = mp[4 * y : 4 * y + 4, 4 * x : 4 * x + 4].sum()
    return out


def _redmean_wins(tg, cand, bva):
    """numpy reference win masks (B, H, W) for one image: 512 * red-mean^2
    distance of each candidate below the threshold."""
    t = tg.astype(np.int64)
    m = np.zeros((len(cand),) + bva.shape, bool)
    for b, (r, g, bl) in enumerate(cand.astype(np.int64)):
        rsum = t[0] + r
        d = ((1024 + rsum) * (r - t[0]) ** 2 + 2048 * (g - t[1]) ** 2
             + (1534 - rsum) * (bl - t[2]) ** 2)
        m[b] = d < bva
    return m


def _redmean_args(rng):
    tg = rng.integers(0, 256, (N, 3, H, W)).astype(np.int32)
    cand = rng.integers(0, 256, (N, B, 3)).astype(np.int32)
    bva = rng.integers(0, 150_000_000, (N, H, W)).astype(np.int32)
    ml = rng.random((N, 3, H, W)).astype(np.float32)
    return tg, cand, bva, ml


def _redmean_want(tg, cand, bva, ml):
    return np.stack([
        _pool_np(_redmean_wins(tg[n], cand[n], bva[n]).astype(np.float64),
                 ml[n])
        for n in range(N)
    ])


def test_pooled_wins_redmean_vmap(rng):
    args = _redmean_args(rng)
    got = jax.vmap(ps.pooled_wins_redmean)(*map(jnp.asarray, args))
    np.testing.assert_allclose(
        np.asarray(got), _redmean_want(*args), rtol=1e-5, atol=1e-5
    )


def test_pooled_wins_redmean_vmap_of_jit(rng):
    """The batched paths' pattern: the call staged inside jit, then
    vmapped from outside."""
    args = _redmean_args(rng)
    got = jax.vmap(jax.jit(ps.pooled_wins_redmean))(*map(jnp.asarray, args))
    np.testing.assert_allclose(
        np.asarray(got), _redmean_want(*args), rtol=1e-5, atol=1e-5
    )


def test_pooled_wins_redmean_unbatched_matches_xla(rng):
    tg, cand, bva, ml = _redmean_args(rng)
    got = ps.pooled_wins_redmean(
        jnp.asarray(tg[0]), jnp.asarray(cand[0]), jnp.asarray(bva[0]),
        jnp.asarray(ml[0]),
    )
    want = _redmean_want(tg, cand, bva, ml)[0]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_pooled_wins_ciede_vmap_of_jit(rng):
    """Distance-plane mode (the perceptual path): strict wins, or ties
    where `adj` gives them to the candidate."""
    d = (rng.integers(0, 8, (N, B, H, W)) * 0.5).astype(np.float32)
    bvalm = (rng.integers(0, 8, (N, H, W)) * 0.5).astype(np.float32)
    adj = rng.integers(0, 2, (N, H, W)).astype(np.int32)
    ml = rng.random((N, 3, H, W)).astype(np.float32)
    got = jax.vmap(jax.jit(ps.pooled_wins))(
        *map(jnp.asarray, (d, bvalm, adj, ml))
    )
    want = np.stack([
        _pool_np(
            ((d[n] < bvalm[n]) | ((d[n] == bvalm[n]) & (adj[n] != 0)))
            .astype(np.float64),
            ml[n],
        )
        for n in range(N)
    ])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_select_colors_vmap_of_jit(rng):
    nk = 7
    key = rng.integers(0, nk + 1, (N, H, W)).astype(np.int32)
    tbl = rng.random((N, 3, nk)).astype(np.float32)
    got = np.asarray(
        jax.vmap(jax.jit(ps.select_colors))(jnp.asarray(key), jnp.asarray(tbl))
    )
    want = np.zeros((N, 3, H, W), np.float32)
    for n in range(N):
        for y in range(H):
            for x in range(W):
                k = key[n, y, x]
                if k < nk:  # the sentinel key nk selects 0
                    want[n, :, y, x] = tbl[n, :, k]
    np.testing.assert_array_equal(got, want)


def test_fused_metric_block_vmap_of_jit(rng):
    """The channel-major feature block under an image batch must match
    the per-image feature path."""
    from snesimage.ops.ssimulacra2 import (
        fused_scale_feature_block,
        reference_pyramid,
        scale_features,
    )

    h = w = 32
    refs = jnp.asarray(rng.random((N, h, w, 3)).astype(np.float32))
    frames = jnp.asarray(rng.random((N, B, h, w, 3)).astype(np.float32))
    refp = jax.vmap(reference_pyramid)(refs)
    frames_cmaj = jnp.moveaxis(frames, -1, 2)

    f = jax.jit(lambda rp, fc: fused_scale_feature_block(rp, fc, 0, 3))
    got = np.asarray(jax.vmap(f)(refp, frames_cmaj))

    for i in range(N):
        rp_i = jax.tree.map(lambda a: a[i], refp)
        want = np.asarray(
            scale_features(rp_i, frames[i], skip_scales=0, max_scale=3)
        )
        np.testing.assert_allclose(got[i], want, rtol=2e-4, atol=2e-4)


def test_fused_coarse_three_level_redmean(rng):
    """The prescreen's decomposition: the quarter-res frame assembled from
    pooled win sums, ds4(L) + (c * pool4(m) - pool4(m * ML)) / 16, must
    equal the 4x4 box mean of the materialized candidate frame
    where(m, c, L) — and its scale-3..5 features (the three-level
    pre-rank, pre_ds=1) must match those of that downsampled frame."""
    from snesimage.ops.ssimulacra2 import (
        downsample2,
        fused_scale_feature_block,
        reference_pyramid,
        scale_features,
    )

    h = w = 64
    refp = reference_pyramid(
        jnp.asarray(rng.random((h, w, 3)).astype(np.float32))
    )
    tg = rng.integers(0, 256, (3, h, w)).astype(np.int32)
    cand8 = rng.integers(0, 256, (B, 3)).astype(np.int32)
    mask = rng.random((h, w)) < 0.7
    bva = np.where(
        mask, rng.integers(0, 150_000_000, (h, w)), np.iinfo(np.int32).min
    ).astype(np.int32)
    lnc = rng.random((3, h, w)).astype(np.float32)
    ml = np.where(mask[None], lnc, 0.0).astype(np.float32)
    cand_lin = rng.random((B, 3)).astype(np.float32)

    pooled = ps.pooled_wins_redmean(*map(jnp.asarray, (tg, cand8, bva, ml)))
    ds4_l = lnc.reshape(3, h // 4, 4, w // 4, 4).mean(axis=(2, 4))
    coarse = (
        cand_lin[:, :, None, None] * pooled[:, :1] - pooled[:, 1:4]
    ) / 16.0 + ds4_l[None]

    wins = _redmean_wins(tg, cand8, bva)
    frames = np.where(wins[:, None], cand_lin[:, :, None, None], lnc[None])
    ds4 = frames.reshape(B, 3, h // 4, 4, w // 4, 4).mean(axis=(3, 5))
    np.testing.assert_allclose(np.asarray(coarse), ds4, rtol=1e-5, atol=1e-5)

    got = np.asarray(fused_scale_feature_block(refp, coarse, 3, 3, pre_ds=1))
    lin = jnp.moveaxis(jnp.asarray(ds4, jnp.float32), 1, -1)
    want = np.asarray(
        scale_features(refp, downsample2(lin), skip_scales=3, input_scale=3)
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
