"""Pooled win masks and small-table colour select for the exact prescreen.

The undithered candidate frame is a two-way select (core/refine.py):

    frame_b = where(m_b, c_b, L)        m_b = cand_mask & wins_b

with L = lin_no_cand candidate-independent and c_b the candidate's linear
color. Because 4x4 box pooling is linear, the frame at pyramid scale 2 is

    ds4(frame_b) = ds4(L) + (c_b * pool4(m_b) - pool4(m_b * ML)) / 16

where ML = cand_mask * L is candidate-independent. The coarse prescreen
score (ops/ssimulacra2.py skip_scales=2) only needs the scale-2 frame, so
the coarse stage needs only the (B, 4, H/4, W/4) pooled sums below: one
compare, a multiply and a reshape-sum per candidate, which XLA fuses into
a single reduction.

Win-mask semantics match core/refine.py `_wins` (reference tie rules,
src/lib.rs:780-792): the candidate at slot index i beats the best other
entry on strictly smaller distance, or on ties when i < best_idx. The
caller folds the cand_mask into the threshold (masked pixels can never
win) and the tie rule into `adj`.
"""

from __future__ import annotations

import jax.numpy as jnp


def _pool_maps(m, ml_cmaj):
    """(B, H, W) 0/1 win masks -> (B, 4, H/4, W/4) 4x4 block sums of
    [m, m * ML_r, m * ML_g, m * ML_b]."""
    b, h, w = m.shape
    maps = jnp.concatenate([m[:, None], m[:, None] * ml_cmaj[None]], axis=1)
    return maps.reshape(b, 4, h // 4, 4, w // 4, 4).sum(axis=(3, 5))


def pooled_wins(dcand, bvalm, adj, ml_cmaj):
    """Per-candidate pooled win sums from precomputed distance planes.

    dcand:   (B, H, W) candidate distances (f32 CIEDE2000).
    bvalm:   (H, W) best other-entry distance, -BIG outside the
             (affected & opaque) pixels.
    adj:     (H, W) int tie rule: nonzero where a tie goes to the
             candidate.
    ml_cmaj: (3, H, W) f32 cand_mask * lin_no_cand, channel-major.
    """
    wins = (dcand < bvalm) | ((dcand == bvalm) & (adj != 0))
    return _pool_maps(wins.astype(jnp.float32), ml_cmaj)


def pooled_wins_redmean(target_cmaj, cand8, bva, ml_cmaj):
    """Per-candidate pooled win sums under the integer red-mean distance.

    target_cmaj: (3, H, W) int32 target image, channel-major.
    cand8:       (B, 3) int32 candidate colors (8-bit).
    bva:         (H, W) int32 win threshold: best other-entry distance
                 plus the integer tie rule, INT32_MIN outside the
                 (affected & opaque) pixels, so wins = d < bva.
    ml_cmaj:     (3, H, W) f32 cand_mask * lin_no_cand, channel-major.

    Returns (B, 4, H//4, W//4) f32 block sums.
    """
    d = cand8[:, :, None, None] - target_cmaj[None]  # (B, 3, H, W)
    rsum = target_cmaj[0][None] + cand8[:, 0, None, None]
    # 512 * red_mean^2, exact int32 (ops/color.py red_mean_sq_scaled).
    dist = (
        (1024 + rsum) * d[:, 0] * d[:, 0]
        + 2048 * d[:, 1] * d[:, 1]
        + (1534 - rsum) * d[:, 2] * d[:, 2]
    )
    return _pool_maps((dist < bva[None]).astype(jnp.float32), ml_cmaj)


def select_colors(key, table):
    """(3, H, W) color planes selected from a small table by per-pixel key.

    key:   (H, W) int32 in [0, K]; the value K (== table.shape[1]) selects
           0.0.
    table: (3, K) f32 channel-major color table.
    """
    padded = jnp.concatenate([table, jnp.zeros((3, 1), table.dtype)], axis=1)
    safe = jnp.minimum(key, padded.shape[1] - 1)
    return jnp.moveaxis(padded.T[safe], -1, 0)
