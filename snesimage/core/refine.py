"""Palette-refinement hot loop: candidate-batched slot optimization.

The reference optimizes one (subpalette, entry) slot per GUI frame by
serially trying 64 random colors / 32 channel values / 56 NES colors, each
with a full-image remap and a full SSIMULACRA2 evaluation
(src/lib.rs:191-328; cost analysis in SURVEY.md §3.3). Here the candidate
axis is a tensor batch:

- all candidates of a slot visit are evaluated in ONE jitted call —
  remap, render and metric are batched over candidates;
- the metric's reference-side pyramid is precomputed once per image
  (ops/ssimulacra2.py) and shared across every candidate ever evaluated;
- the undithered remap is *incremental*: distances to the S-1 unchanged
  entries are computed once per slot visit (and carried across slots by
  the on-device sweeps as a rank-1-updated cache), each candidate
  contributes a single distance column, and the reference's
  strict-less-than / first-index tie semantics are reproduced exactly
  (src/lib.rs:780-792);
- the dithered path runs the wavefront scan per candidate
  (ops/dither.py), vmapped over the candidate batch.

Selection semantics preserved: random/channel keep the current color
unless a candidate is strictly better than the current error
(src/lib.rs:199, 294); the NES sweep always replaces with the best NES
color, even if worse (best_error starts at f64::MAX, src/lib.rs:250).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from snesimage.config import QuantConfig
from snesimage.constants import NES_PALETTE_5BIT
from snesimage.core.state import QuantState
from snesimage.ops.color import (
    ciede2000,
    expand_5bit_to_8bit,
    red_mean_sq_scaled,
    srgb_u8_to_lab,
    srgb_u8_to_linear,
)
from snesimage.ops.dither import dither_candidates, remap_dithered
from snesimage.ops.prescreen import (
    pooled_wins,
    pooled_wins_redmean,
    select_colors,
)
from snesimage.ops.remap import (
    entry_distances,
    remap_undithered,
    render_linear,
)
from snesimage.ops.ssimulacra2 import (
    NUM_SCALES,
    fused_scale_feature_block,
    reference_pyramid,
    score_from_features,
    score_from_ssim_sum,
    ssim_weighted_sum,
    ssimulacra2_from_ref_linear,
)

_BIG = jnp.float32(3.0e38)


@jax.jit
def make_reference_pyramid(state: QuantState):
    """Candidate-independent metric precomputation for this image.
    Passes 8-bit values so the metric's exact sRGB-decode LUT applies.
    Jitted so the ~20 pyramid ops run as one program."""
    return reference_pyramid(state.rgb)


@partial(jax.jit, static_argnames=("config",))
def full_remap(state: QuantState, config: QuantConfig) -> QuantState:
    """Recompute palette_map from the current palette (reference
    `optimize`, src/lib.rs:425-501), dither-aware."""
    if config.dither:
        pm = remap_dithered(
            state.rgb,
            state.alpha,
            state.tile_palettes,
            state.palette,
            config.perceptual_palettes,
        )
    else:
        pm = remap_undithered(
            state.rgb,
            state.alpha,
            state.tile_palettes,
            state.palette,
            config.perceptual_palettes,
        )
    return state._replace(palette_map=pm)


def _error_of_frame(refp, lin_frame: jax.Array) -> jax.Array:
    """Reference `error()`: 100 - SSIMULACRA2 (src/lib.rs:503-548).
    Frames arrive already in linear RGB (see render_linear)."""
    return 100.0 - ssimulacra2_from_ref_linear(refp, lin_frame)


@partial(jax.jit, static_argnames=("config",))
def error_of(state: QuantState, config: QuantConfig, refp) -> jax.Array:
    rendered = render_linear(
        state.palette_map, state.alpha, state.tile_palettes, state.palette
    )
    return _error_of_frame(refp, rendered)


@partial(jax.jit, static_argnames=("config",))
def frame_error_fused(state: QuantState, config: QuantConfig, refp) -> jax.Array:
    """Exact full-frame error through the channel-major feature block
    (B=1).

    Same value as `error_of` up to f32 summation order; used inside the
    fused optimize loop for the convergence test and the final reported
    error."""
    rendered = render_linear(
        state.palette_map, state.alpha, state.tile_palettes, state.palette
    )
    frames_cmaj = jnp.moveaxis(rendered, -1, 0)[None]
    feats = fused_scale_feature_block(refp, frames_cmaj, 0, NUM_SCALES)
    return (100.0 - score_from_features(feats))[0]


def _gating_active(config: QuantConfig) -> bool:
    """Whether rank1 visit gating (QuantConfig.gate_margin) applies: only
    the undithered two-level-prescreened strict-less-than paths gate (the
    gate prediction needs the separate scale-1 stage that only exists
    with 0 < prescreen_full < prescreen — at prescreen_full >= prescreen
    there is no separate scale-0 stage to skip and the gated path
    asserts m < k; the NES sweep never prescreens; the dithered path
    keeps its own machinery), and the prescreen decomposition needs
    4-aligned geometry."""
    return (
        config.gate_margin > 0
        and config.prescreen > 0
        and 0 < config.prescreen_full < config.prescreen
        and not config.dither
        and not config.nes
        and config.height % 4 == 0
        and config.width % 4 == 0
    )


@partial(jax.jit, static_argnames=("config",))
def gate_base_fused(
    state: QuantState, config: QuantConfig, refp
) -> jax.Array:
    """(2,) per-scale weighted |feature| sums [scale-0, scale-1] of the
    current state (see ssim_weighted_sum: the score's weighted sum
    decomposes exactly over the disjoint scale supports). Sweeps with
    gating enabled carry it across slot visits; adding a candidate's
    exact scale-1..5 sum to the scale-0 term predicts the candidate's
    FULL error at the true operating point of the score nonlinearity —
    the only unknown is the candidate's scale-0 feature delta. The
    coarse gate (QuantConfig.gate_coarse) adds the scale-1 term to
    predict from the candidate's scale-2..5 coarse sum alone, before
    any full-resolution frame is built. One frame, one fused two-scale
    evaluation (~the cost of scoring one extra finalist per sweep)."""
    rendered = render_linear(
        state.palette_map, state.alpha, state.tile_palettes, state.palette
    )
    cmaj = jnp.moveaxis(rendered, -1, 0)[None]  # (1, 3, H, W)
    feats = fused_scale_feature_block(refp, cmaj, 0, 2)[0]  # (scales, 3, 6)
    mask0 = (jnp.arange(NUM_SCALES) == 0)[:, None, None]
    mask1 = (jnp.arange(NUM_SCALES) == 1)[:, None, None]
    return jnp.stack(
        [
            ssim_weighted_sum(feats * mask0),
            ssim_weighted_sum(feats * mask1),
        ]
    )


# ---------------------------------------------------------------------------
# Candidate evaluation
# ---------------------------------------------------------------------------


def compute_d_all(state: QuantState, config: QuantConfig) -> jax.Array:
    """(S, H, W) distances of every pixel to each entry of its own
    subpalette — native dtype (exact int32 red-mean or f32 CIEDE2000).

    Entry-major layout: the S axis leads so the per-visit reductions and
    the rank-1 column update touch contiguous (H, W) planes instead of a
    strided minor S axis. The transpose here runs once
    per sweep; sweeps carry the cache across slot visits: when slot (p, i)
    changes, only plane i of pixels in subpalette-p tiles changes (rank-1
    update), so a full recompute per visit is redundant."""
    entries8 = expand_5bit_to_8bit(state.palette)
    tp_pix = jnp.repeat(jnp.repeat(state.tile_palettes, 8, axis=0), 8, axis=1)
    sub = entries8[tp_pix]  # (H, W, S, 3)
    return jnp.moveaxis(
        entry_distances(state.rgb, sub, config.perceptual_palettes), -1, 0
    )


def _undithered_machinery(
    state: QuantState, config: QuantConfig, p, i, d_all=None, target_lab=None
):
    """Shared per-slot-visit precomputation for the undithered path.

    Everything that does not depend on the candidate color is computed
    once: (S, H, W) distances of every pixel to its subpalette's unchanged
    entries (``d_all``; passed in by sweeps that carry it across slots), the
    first-minimum-wins best entry with and without slot ``i``
    (src/lib.rs:780-792 tie semantics), and the candidate-independent part
    of the linear-RGB rendered frame. Returns three closures:

      errors(refp, cand5) -> (B,) errors — per candidate: one distance
        column, one vectorized select, one metric evaluation. No gathers,
        no per-pixel transfer decode.
      final_map(color5) -> (H, W) palette_map — the exact equivalent of a
        full remap with slot ``i`` set to ``color5``, at the cost of a
        single distance column.
      new_d_all(color5) -> updated (S, H, W) distance cache after setting
        slot (p, i) to color5 (bit-identical to compute_d_all on the
        updated state: only affected pixels' plane i changes).
    """
    s = config.subpalette_size
    entries8 = expand_5bit_to_8bit(state.palette)  # (C, S, 3)
    tp_pix = jnp.repeat(jnp.repeat(state.tile_palettes, 8, axis=0), 8, axis=1)
    target_u8 = state.rgb  # undithered: zero accumulated error
    perceptual = config.perceptual_palettes

    if d_all is None:
        d_all = compute_d_all(state, config)
    big = jnp.iinfo(jnp.int32).max if d_all.dtype == jnp.int32 else _BIG

    excl = (jnp.arange(s) == i)[:, None, None]  # (S, 1, 1)
    d_masked = jnp.where(excl, big, d_all)
    best_val = jnp.min(d_masked, axis=0)
    best_idx = jnp.argmin(d_masked, axis=0).astype(jnp.int32)
    base_idx = jnp.argmin(d_all, axis=0).astype(jnp.int32)

    affected = tp_pix == p  # (H, W)
    opaque = state.alpha > 0
    if perceptual and target_lab is None:
        target_lab = srgb_u8_to_lab(target_u8)

    entries_lin_flat = srgb_u8_to_linear(entries8).reshape(-1, 3)  # (C*S, 3)
    # lin_no_cand = the rendered linear frame with slot i never winning:
    # affected pixels take their best OTHER entry, everything else its
    # global best, transparent pixels 0: one gather from the (C*S)-row
    # entry table by a combined per-pixel key (ops/prescreen.py).
    idx_nc = jnp.where(affected, best_idx, base_idx)
    key_nc = jnp.where(opaque, tp_pix * s + idx_nc, entries_lin_flat.shape[0])
    lnc_cmaj = select_colors(
        key_nc, entries_lin_flat.T.astype(jnp.float32)
    )  # (3, H, W)
    lin_no_cand = jnp.moveaxis(lnc_cmaj, 0, -1)

    def _cand_dist(c8, c_lab):
        if perceptual:
            return ciede2000(target_lab, c_lab)
        return red_mean_sq_scaled(target_u8, c8)

    def _wins(d_c):
        """Strict-less-than scan over entry index: the candidate (at index
        i) wins on d_c < best_val, or on ties when i precedes best_idx."""
        return (d_c < best_val) | ((d_c == best_val) & (i < best_idx))

    def errors(
        refp, cand5, allow_prescreen=True, carried_base=False,
        gate=None, coarse_only=False,
    ):
        """Per-candidate errors. With ``carried_base=True`` the batch
        contains NO baseline row: the caller carries the exact error of
        the current state across slot visits (see _slot_channel), so the
        current color is never re-scored — this drops one frame from
        every scoring stage (the coarse stage, the scale-1 rank, and the
        scale-0 finalists).

        ``gate`` (only with carried_base, two-level prescreen) is the
        rank1 visit gate's context ``(gb, base_err, gate_enable,
        n_gated)``: gb = the current state's per-scale [scale-0, scale-1]
        weighted |feature| sums (gate_base_fused, carried across visits),
        base_err = the carried exact error. The return value becomes
        ``(errs, svec)`` and the scale-0 stage runs under a lax.cond:
        each finalist's FULL error is predicted as
        100 - score_poly(gb[0] + its exact scale-1..5 weighted sum) —
        exact except for the candidate's own scale-0 feature delta — and
        unless the best prediction beats base_err by MORE than
        ``config.gate_margin``, every candidate reports +inf (visit
        rejected) without the scale-0 work. With ``config.gate_coarse``
        an earlier cond skips the whole finalist pipeline (frame build +
        scale-1 + scale-0) from the coarse-stage prediction
        100 - score_poly(gb[0] + gb[1] + best coarse sum). The current
        color's own prediction equals base_err exactly (the
        decomposition is exact on the current state), so the margin must
        be strictly positive to ever skip; a SMALLER margin is safer
        (more visits fully scored) and the only possible harm is a
        missed improvement whose gain lives in the candidate's
        finest-scale deltas — acceptance always compares fully-scored
        candidates against the carried exact error. ``svec`` is (2, B):
        each fully-scored candidate's scale-0 / scale-1 weighted sums
        (the carry update on accept), 0 elsewhere."""
        cand8 = expand_5bit_to_8bit(cand5)  # (B, 3)
        cand_lin = srgb_u8_to_linear(cand8)
        cand_lab = srgb_u8_to_lab(cand8) if perceptual else cand8
        cand_mask2 = affected & opaque

        def one_frame_cmaj(c8, c_lin, c_lab):
            """(3, H, W) linear candidate frame, channel-major as
            fused_scale_feature_block takes it."""
            wins = _wins(_cand_dist(c8, c_lab))
            return jnp.where(
                (cand_mask2 & wins)[None], c_lin[:, None, None], lnc_cmaj
            )

        b = cand8.shape[0]
        k = config.prescreen
        base_rows = 0 if carried_base else 1
        h, w = target_u8.shape[:2]
        if k and b > k + base_rows and allow_prescreen and h % 4 == 0 and w % 4 == 0:
            # Two-stage scoring with EXACT quarter-resolution coarse
            # frames: the scale-2 frame of a two-way select decomposes as
            #   ds4(where(m, c, L)) = ds4(L) + (c*pool4(m) - pool4(m*L))/16
            # so the coarse rank needs only per-candidate pooled win sums
            # (ops/prescreen.py) — the
            # (B, H, W, 3) full-resolution candidate frames are built only
            # for the top-k finalists plus the in-batch baseline at index
            # 0. Unselected candidates report +inf so slot selection logic
            # is unchanged; acceptance stays exact, and — because only the
            # strict-less-than random/channel paths prescreen (the
            # always-replace NES sweep opts out via allow_prescreen) — a
            # misranked true winner can only cost a missed improvement,
            # never a regression.
            adj = (i < best_idx).astype(jnp.int32)
            ml_cmaj = jnp.where(cand_mask2[None], lnc_cmaj, 0.0)
            # ds4 of lin_no_cand, channel-major (exact 4x4 box mean; f32
            # association differs from downsample2∘downsample2 by ~1 ulp,
            # irrelevant for ranking and cancelled by the in-batch baseline)
            ds4_l = lnc_cmaj.reshape(3, h // 4, 4, w // 4, 4).mean(axis=(2, 4))
            # Three-level coarse (config.prescreen_pre): pre-rank ALL
            # candidates by their EXACT scale-3..5 score from 1/8-res
            # frames (the quarter-res coarse frame pooled 2x2 once more),
            # then run the scale-2 stage — ~75% of the coarse stage's
            # pixels — only for the top `prescreen_pre`. Same
            # missed-improvement-only safety argument as the two-level
            # prescreen; selection-perfection validated in
            # tests/test_refine.py.
            mq = config.prescreen_pre
            # coarse_only (the dither-proxy ranking) never runs the
            # scale-2 stage, so three-level mode would only weaken the
            # proxy (scales 3..5 instead of 2..5) — force the standard
            # two-level coarse there.
            three_level = bool(
                mq
                and not coarse_only
                and b > mq + base_rows
                and mq >= k + base_rows
                and h % 8 == 0
                and w % 8 == 0
            )
            dcand = None
            if perceptual:
                bvalm = jnp.where(cand_mask2, best_val, -_BIG)
                dcand = jax.vmap(_cand_dist)(cand8, cand_lab).astype(
                    best_val.dtype
                )
                pooled = pooled_wins(dcand, bvalm, adj, ml_cmaj)
            else:
                # Masked integer win-threshold: the tie rule folds into
                # the threshold, wins = d < bva.
                bva = jnp.where(
                    cand_mask2,
                    jnp.where(
                        best_val == jnp.iinfo(jnp.int32).max,
                        best_val,
                        best_val + adj,
                    ),
                    jnp.iinfo(jnp.int32).min,
                )
                tg_cmaj = jnp.moveaxis(target_u8, -1, 0).astype(jnp.int32)
                pooled = pooled_wins_redmean(
                    tg_cmaj, cand8.astype(jnp.int32), bva, ml_cmaj
                )
            coarse_frames = (
                cand_lin[:, :, None, None] * pooled[:, :1] - pooled[:, 1:4]
            ) / 16.0 + ds4_l[None]  # (B, 3, h/4, w/4) channel-major
            start_s = 3 if three_level else 2
            # three-level: scales 3-5 from an in-block 1/8-res downsample;
            # otherwise (B, 6, 3, 6) with scales 0-1 zero.
            feats_pre = fused_scale_feature_block(
                refp, coarse_frames, start_s, NUM_SCALES - start_s,
                pre_ds=start_s - 2,
            )
            if coarse_only:
                # Proxy-rank mode (config.dither_proxy): the EXACT
                # scale-(start_s)..5 undithered score of EVERY candidate,
                # finite for all rows — the dithered path ranks its
                # candidates with this before paying a wavefront each.
                return 100.0 - score_from_features(feats_pre)
            if three_level:
                # Level 1 of 3: rank ALL candidates by their EXACT
                # scale-3..5 score; only the top `prescreen_pre` run the
                # scale-2 stage (~75% of the coarse stage's pixels). The
                # in-batch baseline (legacy mode) is force-included so its
                # coarse features stay exact for the finalist sum.
                pre_rank = 100.0 - score_from_features(feats_pre)
                if carried_base:
                    _, sel_pre = jax.lax.top_k(-pre_rank, mq)
                else:
                    # Top mq CANDIDATES plus the baseline (same convention
                    # as the later levels) — keeping the candidate
                    # retention set identical across the two modes.
                    _, topp = jax.lax.top_k(-pre_rank[1:], mq)
                    sel_pre = jnp.concatenate(
                        [jnp.zeros(1, topp.dtype), topp + 1]
                    )
                feats_2 = fused_scale_feature_block(
                    refp, coarse_frames[sel_pre], 2, 1
                )
                feats_sel = feats_2 + feats_pre[sel_pre]
                feats_c = jnp.zeros_like(feats_pre).at[sel_pre].set(
                    feats_sel
                )
                coarse = jnp.full((b,), jnp.inf, jnp.float32).at[
                    sel_pre
                ].set(100.0 - score_from_features(feats_sel))
            else:
                feats_c = feats_pre
                coarse = 100.0 - score_from_features(feats_c)
            if carried_base:
                _, sel = jax.lax.top_k(-coarse, k)
            else:
                _, top = jax.lax.top_k(-coarse[1:], k)
                sel = jnp.concatenate([jnp.zeros(1, top.dtype), top + 1])
            if dcand is not None:
                # Finalist win masks from the distance planes the coarse
                # stage already computed — saves 9 more CIEDE2000 planes
                # per visit. bvalm folds the cand_mask (masked pixels are
                # -BIG, so the candidate can never win there).
                def one_frame_from_d(d_row, c_lin):
                    wins = (d_row < bvalm) | ((d_row == bvalm) & (adj != 0))
                    return jnp.where(
                        wins[None], c_lin[:, None, None], lnc_cmaj
                    )

                build = lambda ix: jax.vmap(one_frame_from_d)(  # noqa: E731
                    dcand[ix], cand_lin[ix]
                )
            else:
                build = lambda ix: jax.vmap(one_frame_cmaj)(  # noqa: E731
                    cand8[ix], cand_lin[ix], cand_lab[ix]
                )
            m = config.prescreen_full
            if gate is not None:
                # Gated path (carried baseline only; _gating_active
                # requires two-level prescreening).
                assert carried_base and m and m < k
                gb, base_full, gate_enable, n_gated = gate

                def _reject():
                    return (
                        jnp.full((b,), jnp.inf, jnp.float32),
                        jnp.zeros((2, b), jnp.float32),
                    )

                def _stage12():
                    # Second level: rank the finalists by their EXACT
                    # scale-1..5 score — the feature block downsamples
                    # the full-resolution frames itself (pre_ds=1) — then
                    # run scale 0
                    # (~4/5 of a finalist's metric cost) only for the
                    # top-m, on freshly built frames (rebuilding two
                    # frames is cheaper than gathering from the finalist
                    # stack). Ranking uses the calibrated full-error
                    # prediction (same ordering as the raw scale-1..5
                    # score: the carried b0 shifts every candidate's
                    # weighted sum by the same constant, and the score
                    # nonlinearity is monotone over the operating range).
                    frames = build(sel)
                    feats_1 = fused_scale_feature_block(
                        refp, frames, 1, 1, pre_ds=1
                    )
                    s15 = ssim_weighted_sum(feats_1 + feats_c[sel])
                    rank1 = 100.0 - score_from_ssim_sum(gb[0] + s15)
                    _, sel2 = jax.lax.top_k(-rank1, m)
                    selF = sel[sel2]

                    def _scale0():
                        feats_0 = fused_scale_feature_block(
                            refp, build(selF), 0, 1
                        )
                        full = 100.0 - score_from_features(
                            feats_0 + feats_1[sel2] + feats_c[selF]
                        )
                        errs_v = jnp.full(
                            (b,), jnp.inf, jnp.float32
                        ).at[selF].set(full)
                        # Per-scale carry updates for the accepted
                        # candidate: its scale-0 and scale-1 weighted
                        # sums (only rows that can be accepted — i.e.
                        # fully-scored selF rows — are ever read).
                        sv = jnp.zeros((2, b), jnp.float32)
                        sv = sv.at[0, selF].set(ssim_weighted_sum(feats_0))
                        sv = sv.at[1, sel].set(ssim_weighted_sum(feats_1))
                        return errs_v, sv

                    # Rank1 gate: run the scale-0 stage only when the
                    # best finalist's predicted full error beats the
                    # carried exact error by MORE than gate_margin;
                    # otherwise the visit rejects with no scale-0 work
                    # (lax.cond executes one branch). The current
                    # color's own prediction equals base exactly, so the
                    # gate closes precisely when no candidate is
                    # predicted to improve by more than the margin; a
                    # SMALLER margin is safer (more visits fully scored),
                    # at the cost of fewer skips.
                    # ``gate_enable=False`` forces the gate open: the
                    # visit scores exactly — the sweeps' EXACT
                    # confirmation mode (pipeline._optimize_fused runs an
                    # ungated sweep before any stop fires, because on
                    # hard-edged content gated sweeps can starve: the
                    # improvements are scale-0-dominated and invisible to
                    # the prediction — measured +27 error on a text/UI
                    # image without confirmation).
                    gate_open = ~gate_enable | (
                        jnp.min(rank1) - base_full
                        < -jnp.float32(config.gate_margin)
                    )
                    if n_gated is not None and n_gated < b:
                        # Explore exemption: rows >= n_gated are joint-RGB
                        # explore candidates, whose gains are often
                        # scale-0-dominated and invisible to the
                        # prediction — any of them reaching the scale-0
                        # finalists forces exact scoring, so the gate can
                        # never filter an explore jump (see _slot_channel).
                        gate_open = gate_open | jnp.any(selF >= n_gated)
                    return jax.lax.cond(gate_open, _scale0, _reject)

                if config.gate_coarse:
                    # Coarse gate (extension, round 4): predict each
                    # candidate's full error from its exact scale-2..5
                    # coarse sum plus BOTH carried fine-scale terms, and
                    # skip the entire finalist pipeline (frame build +
                    # scale-1 rank + scale-0) when even the best coarse
                    # candidate isn't predicted to improve by more than
                    # the margin. The prediction is exact up to the
                    # candidate's own scale-0 AND scale-1 deltas — a
                    # strictly larger blind spot than the rank1 gate's,
                    # traded for skipping ~all non-coarse work on reject
                    # visits; the same EXACT-confirmation stop rule keeps
                    # convergence exact. sel[0] is the coarse argmin and
                    # the prediction is monotone in the coarse sum, so
                    # one element decides.
                    wsum_c = ssim_weighted_sum(feats_c)
                    pred_best = 100.0 - score_from_ssim_sum(
                        gb[0] + gb[1] + wsum_c[sel[0]]
                    )
                    open_c = ~gate_enable | (
                        pred_best - base_full
                        < -jnp.float32(config.gate_margin)
                    )
                    if n_gated is not None and n_gated < b:
                        # Explore exemption, coarse level: any explore
                        # candidate among the coarse finalists forces the
                        # finalist pipeline to run.
                        open_c = open_c | jnp.any(sel >= n_gated)
                    return jax.lax.cond(open_c, _stage12, _reject)
                return _stage12()
            frames = build(sel)
            if m and m < k:
                # Second level, ungated (see the gated twin above for the
                # stage semantics; legacy mode force-includes the in-batch
                # baseline row).
                feats_1 = fused_scale_feature_block(
                    refp, frames, 1, 1, pre_ds=1
                )
                s15 = ssim_weighted_sum(feats_1 + feats_c[sel])
                rank1 = 100.0 - score_from_ssim_sum(s15)
                if carried_base:
                    _, sel2 = jax.lax.top_k(-rank1, m)
                else:
                    _, top2 = jax.lax.top_k(-rank1[1:], m)
                    sel2 = jnp.concatenate(
                        [jnp.zeros(1, top2.dtype), top2 + 1]
                    )
                selF = sel[sel2]
                feats_0 = fused_scale_feature_block(
                    refp, build(selF), 0, 1
                )
                full = 100.0 - score_from_features(
                    feats_0 + feats_1[sel2] + feats_c[selF]
                )
                return jnp.full(
                    (b,), jnp.inf, jnp.float32
                ).at[selF].set(full)
            # Finalists: only the two finest scales run at full
            # resolution; scales 2..5 reuse the coarse features (the
            # pooled scale-2 frame IS the finalist frame's scale-2
            # downsample, exactly, up to f32 summation order).
            feats_f = fused_scale_feature_block(refp, frames, 0, 2)
            full = 100.0 - score_from_features(feats_f + feats_c[sel])
            return jnp.full((b,), jnp.inf, jnp.float32).at[sel].set(full)
        # Build all candidate frames, then score them as ONE explicit
        # batch through the multi-scale feature block.
        frames = jax.vmap(one_frame_cmaj)(cand8, cand_lin, cand_lab)
        feats = fused_scale_feature_block(refp, frames, 0, NUM_SCALES)
        errs = 100.0 - score_from_features(feats)
        if coarse_only:
            # Proxy-rank mode, small-batch fallback: the full exact
            # undithered error is an even better rank (all rows finite).
            return errs
        if gate is not None:
            # Small batches (e.g. windowed visits) skip the prescreen
            # decomposition; no gating opportunity, but the gate carry
            # still needs each candidate's per-scale weighted sums —
            # extracted from the already-computed full features (~free).
            sv = jnp.stack(
                [
                    ssim_weighted_sum(
                        feats * (jnp.arange(NUM_SCALES) == s)[:, None, None]
                    )
                    for s in (0, 1)
                ]
            )
            return errs, sv
        return errs

    def _chosen_dist(color5):
        c8 = expand_5bit_to_8bit(color5)
        c_lab = srgb_u8_to_lab(c8) if perceptual else c8
        return _cand_dist(c8, c_lab)

    def final_map(color5):
        wins = _wins(_chosen_dist(color5))
        idx = jnp.where(affected, jnp.where(wins, i, best_idx), base_idx)
        return jnp.where(opaque, idx, 0).astype(jnp.int32)

    def new_d_all(color5):
        d_c = _chosen_dist(color5).astype(d_all.dtype)
        old_col = jax.lax.dynamic_index_in_dim(d_all, i, 0, keepdims=False)
        col = jnp.where(affected, d_c, old_col)
        return jax.lax.dynamic_update_slice(d_all, col[None], (i, 0, 0))

    return errors, final_map, new_d_all


def _candidate_errors_undithered(
    state: QuantState, config: QuantConfig, refp, p, i, cand5
):
    """Errors for B candidate colors in slot (p, i), incremental remap."""
    errors, _, _ = _undithered_machinery(state, config, p, i)
    return errors(refp, cand5)


def _candidate_errors_dithered(
    state: QuantState, config: QuantConfig, refp, p, i, cand5,
    allow_prescreen=True, carried_base=False,
):
    """Dithered candidate evaluation: wavefront remap per candidate
    (the vmapped scan of ops/dither.py), then one explicit metric batch.

    With ``config.dither_proxy = K > 0`` (extension, round 4) the B
    candidates are first ranked by their EXACT undithered coarse-scale
    score (scales 2..5 of the undithered argmin remap — FS error
    diffusion is high-frequency content that pools out at those scales,
    so the undithered coarse rank closely tracks the dithered one) and
    only the top K pay the wavefront remap + exact dithered scoring;
    the rest report +inf. The per-candidate wavefront is expected to be
    the dithered visit's dominant cost, so this is the dithered analogue
    of the undithered
    two-level prescreen, with the same missed-improvement-only safety:
    acceptance still compares exactly-scored dithered candidates
    (strict-less-than; the NES sweep opts out via allow_prescreen, and
    the legacy baseline row 0 is always force-included)."""
    b = cand5.shape[0]
    base_rows = 0 if carried_base else 1
    kprox = config.dither_proxy
    if kprox and allow_prescreen and b - base_rows > kprox:
        und_errors, _, _ = _undithered_machinery(state, config, p, i)
        # carried_base=True in rank mode: every row (incl. a legacy
        # baseline) is ranked as a plain candidate; the force-include
        # below restores the baseline's exact scoring.
        proxy = und_errors(refp, cand5, carried_base=True, coarse_only=True)
        if carried_base:
            _, selp = jax.lax.top_k(-proxy, kprox)
        else:
            _, topp = jax.lax.top_k(-proxy[1:], kprox)
            selp = jnp.concatenate([jnp.zeros(1, topp.dtype), topp + 1])
        # The recursive call cannot re-enter this branch: its batch is
        # exactly kprox + base_rows rows.
        errs_k = _candidate_errors_dithered(
            state, config, refp, p, i, cand5[selp], allow_prescreen,
            carried_base,
        )
        return jnp.full((b,), jnp.inf, jnp.float32).at[selp].set(errs_k)
    s = config.subpalette_size
    maps = dither_candidates(
        state.rgb,
        state.alpha,
        state.tile_palettes,
        state.palette,
        p,
        i,
        cand5.astype(jnp.int32),
        config.perceptual_palettes,
    )  # (B, H, W)

    entries8 = expand_5bit_to_8bit(state.palette)
    entries_lin = srgb_u8_to_linear(entries8)  # (C, S, 3)
    tp_pix = jnp.repeat(jnp.repeat(state.tile_palettes, 8, axis=0), 8, axis=1)
    # One candidate-independent gather; per-candidate rendering is a
    # one-hot contraction over S instead of per-candidate (B, H*W)
    # gathers from the entry table.
    sub_lin_pix = entries_lin[tp_pix]  # (H, W, S, 3)
    opaque = state.alpha > 0
    cand_lin = srgb_u8_to_linear(expand_5bit_to_8bit(cand5))
    entry_ids = jnp.arange(s)

    def one_frame(pm, c_lin):
        onehot = (pm[..., None] == entry_ids).astype(jnp.float32)  # (H, W, S)
        lin = jnp.sum(sub_lin_pix * onehot[..., None], axis=-2)
        use_c = (tp_pix == p) & (pm == i) & opaque
        lin = jnp.where(use_c[..., None], c_lin, lin)
        return jnp.where(opaque[..., None], lin, 0.0)

    frames = jax.vmap(one_frame)(maps, cand_lin)
    frames_cmaj = jnp.moveaxis(frames, -1, 1)  # (B, 3, H, W)
    k = config.prescreen
    if k and b > k + base_rows and allow_prescreen:
        # Same two-stage scoring as the undithered path (validated
        # zero-regret on dithered candidate batches too); the coarse rank
        # downsamples the full-resolution frames inside the feature block
        # (pre_ds).
        feats_c = fused_scale_feature_block(
            refp, frames_cmaj, 2, NUM_SCALES - 2, pre_ds=2
        )
        coarse = 100.0 - score_from_features(feats_c)
        if carried_base:
            _, sel = jax.lax.top_k(-coarse, k)
        else:
            _, top = jax.lax.top_k(-coarse[1:], k)
            sel = jnp.concatenate([jnp.zeros(1, top.dtype), top + 1])
        fsel = frames_cmaj[sel]
        m = config.prescreen_full
        if m and m < k:
            # Two-level finalists, as in the undithered path.
            feats_1 = fused_scale_feature_block(refp, fsel, 1, 1, pre_ds=1)
            rank1 = 100.0 - score_from_features(feats_1 + feats_c[sel])
            if carried_base:
                _, sel2 = jax.lax.top_k(-rank1, m)
            else:
                _, top2 = jax.lax.top_k(-rank1[1:], m)
                sel2 = jnp.concatenate([jnp.zeros(1, top2.dtype), top2 + 1])
            selF = sel[sel2]
            feats_0 = fused_scale_feature_block(
                refp, frames_cmaj[selF], 0, 1
            )
            full = 100.0 - score_from_features(
                feats_0 + feats_1[sel2] + feats_c[selF]
            )
            return jnp.full((b,), jnp.inf, jnp.float32).at[selF].set(full)
        feats_f = fused_scale_feature_block(refp, fsel, 0, 2)
        full = 100.0 - score_from_features(feats_f + feats_c[sel])
        return jnp.full((b,), jnp.inf, jnp.float32).at[sel].set(full)
    feats = fused_scale_feature_block(refp, frames_cmaj, 0, NUM_SCALES)
    return 100.0 - score_from_features(feats)


def candidate_errors(state, config: QuantConfig, refp, p, i, cand5):
    if config.dither:
        return _candidate_errors_dithered(state, config, refp, p, i, cand5)
    return _candidate_errors_undithered(state, config, refp, p, i, cand5)


# ---------------------------------------------------------------------------
# Slot refiners (one jitted call per slot visit)
# ---------------------------------------------------------------------------


class SlotResult(NamedTuple):
    state: QuantState
    error: jax.Array  # error after the visit (reference logs this)
    changed: jax.Array  # whether the entry changed


def _slot_machinery(state: QuantState, config: QuantConfig, p, i, cache=None):
    """(errors, apply, new_cache) closures for one slot visit, dither-aware.

    `apply(color5)` produces the post-visit state: for the undithered path
    the new palette_map comes from the slot context at the cost of ONE
    distance column (bit-identical to a full remap with the new palette);
    the dithered path re-runs the wavefront scan.

    `cache` is the optional (d_all, target_lab) pair carried across slot
    visits by the on-device sweeps; `new_cache(color5)` returns its
    updated value (None-safe for the dithered path, which has no cache)."""
    if config.dither:

        def errors(
            refp, cand5, allow_prescreen=True, carried_base=False,
            gate=None,
        ):
            # The dithered path never gates (_gating_active excludes it):
            # its remap is a full wavefront per candidate, so the metric
            # stages are not the dominant slice they are undithered.
            assert gate is None
            return _candidate_errors_dithered(
                state, config, refp, p, i, cand5, allow_prescreen,
                carried_base,
            )

        def apply(color5):
            palette = jax.lax.dynamic_update_slice(
                state.palette,
                color5.astype(jnp.int32).reshape(1, 1, 3),
                (p, i, 0),
            )
            return full_remap(state._replace(palette=palette), config)

        return errors, apply, lambda color5: None

    d_all, target_lab = cache if cache is not None else (None, None)
    errors, final_map, new_d_all = _undithered_machinery(
        state, config, p, i, d_all, target_lab
    )

    def apply(color5):
        palette = jax.lax.dynamic_update_slice(
            state.palette, color5.astype(jnp.int32).reshape(1, 1, 3), (p, i, 0)
        )
        return state._replace(palette=palette, palette_map=final_map(color5))

    def new_cache(color5):
        return (new_d_all(color5), target_lab)

    return errors, apply, new_cache


def _pick(
    errors, apply, new_cache, refp, cand5, current, base_err,
    gate_base=None, skip=None, accept_margin=0.0, gate_enable=None,
    n_gated=None,
):
    """Shared accept/apply tail for the strict-less-than slot visits.

    ``accept_margin`` (extension, QuantConfig.accept_margin): accept only
    improvements strictly larger than this threshold (0 = the reference's
    plain strict-less-than rule). Filtering weak greedy accepts measurably
    steers the descent out of poor local optima on some contents (the
    rank1 gate produces the same filtering as a side effect); this knob applies it on the EXACT path,
    for any schedule and with or without prescreening.

    With ``base_err=None`` (legacy / public per-slot API) the baseline is
    evaluated inside the same batch as the candidates, mirroring the
    reference's identical-code-path baseline — robust to batched-vs-
    single ulp differences. With a carried ``base_err`` (the on-device
    sweeps) the baseline row is dropped from every scoring stage and the
    exact error of the current state is carried across visits instead;
    the ``changed`` guard keeps tiny cross-decomposition f32 noise from
    ever drifting the carried error on a phantom re-accept of the
    current color.

    ``gate_base`` (only with a carried ``base_err``) enables the rank1
    visit gate: it is the carried scale-0 weighted |feature| sum of the
    current state (see gate_base_fused / QuantConfig.gate_margin). The
    third return value is the updated carry — the accepted candidate's
    own scale-0 sum on accept, unchanged otherwise.

    ``skip`` (only with a carried ``base_err``): the incoming
    ``(state, cache)`` pair. When given, rejected visits return it
    verbatim under a lax.cond instead of recomputing ``apply(current)``
    / ``new_cache(current)`` — both are provably identity on reject (the
    palette_map / distance-cache invariants the sweeps maintain), and on
    the dithered path apply() is a full wavefront remap, the visit's
    single most expensive op."""
    if base_err is None:
        assert gate_base is None
        errs = errors(refp, jnp.concatenate([current[None, :], cand5], axis=0))
        base = errs[0]
        cand_errs = errs[1:]
    elif gate_base is not None:
        base = base_err
        if gate_enable is None:
            gate_enable = jnp.bool_(True)
        cand_errs, s0_vec = errors(
            refp, cand5, carried_base=True,
            gate=(gate_base, base_err, gate_enable, n_gated),
        )
    else:
        base = base_err
        cand_errs = errors(refp, cand5, carried_base=True)
    bidx = jnp.argmin(cand_errs)
    bmin = cand_errs[bidx]
    if accept_margin:
        accept = bmin < base - jnp.float32(accept_margin)
    else:
        accept = bmin < base
    color = jnp.where(accept, cand5[bidx], current)
    changed = accept & jnp.any(color != current)
    err_out = jnp.where(changed, jnp.minimum(bmin, base), base)
    if skip is not None:
        assert base_err is not None
        state_out, cache_out = jax.lax.cond(
            changed,
            lambda: (apply(color), new_cache(color)),
            lambda: skip,
        )
        res = SlotResult(state_out, err_out, changed)
    else:
        res = SlotResult(apply(color), err_out, changed)
        cache_out = new_cache(color)
    new_gate = None
    if gate_base is not None:
        # gate_base / s0_vec are (2,) / (2, B): per-scale [scale-0,
        # scale-1] weighted sums (see gate_base_fused).
        new_gate = jnp.where(changed, s0_vec[:, bidx], gate_base)
    return res, cache_out, new_gate


def _slot_random(
    state: QuantState, config: QuantConfig, refp, key, p, i, cache=None,
    base_err=None, gate_base=None, skip=False, gate_enable=None,
):
    """64 uniform-random 5-bit candidates; keep the best only if it beats
    the current error (src/lib.rs:191-240). Baseline handling: _pick."""
    current = jax.lax.dynamic_slice(state.palette, (p, i, 0), (1, 1, 3)).reshape(3)
    rand5 = jax.random.randint(key, (config.random_trials, 3), 0, 32, dtype=jnp.int32)
    errors, apply, new_cache = _slot_machinery(state, config, p, i, cache)
    return _pick(
        errors, apply, new_cache, refp, rand5, current, base_err,
        gate_base, (state, cache) if skip else None, config.accept_margin,
        gate_enable,
    )


def _slot_channel(
    state: QuantState, config: QuantConfig, refp, p, i, channel, cache=None,
    base_err=None, key=None, window=False, gate_base=None, skip=False,
    gate_enable=None,
):
    """Exhaustive sweep of one channel's 32 values (src/lib.rs:286-328).
    Baseline handling: _pick (the current color is among the 32 sweep
    values, so the carried-base batch is exactly the 32-value sweep).

    With `config.channel_explore > 0` and a `key`, `channel_explore`
    uniform-random full-RGB candidates join the 32-value sweep
    (extension; see QuantConfig.channel_explore): the joint moves let
    coordinate descent escape single-channel equilibria. Acceptance is
    unchanged (strict-less-than against the carried exact error).

    With ``window=True`` (extension; see QuantConfig.channel_window) the
    sweep covers only the 2*channel_window values nearest the current
    one, clamped to [0, 31] (clamping may duplicate boundary values —
    harmless under first-index argmin). The coarse prescreen cost scales
    with the candidate count, so windowed visits are cheaper; the
    scheduler interleaves exhaustive sweeps to preserve escapes."""
    current = jax.lax.dynamic_slice(state.palette, (p, i, 0), (1, 1, 3)).reshape(3)
    onehot = (jnp.arange(3) == channel).astype(jnp.int32)
    if window:
        w = config.channel_window
        offsets = jnp.concatenate(
            [jnp.arange(-w, 0, dtype=jnp.int32),
             jnp.arange(1, w + 1, dtype=jnp.int32)]
        )
        values = jnp.clip(current[channel] + offsets, 0, 31)
    else:
        values = jnp.arange(32, dtype=jnp.int32)
    sweep5 = (
        current[None, :] * (1 - onehot)[None, :] + values[:, None] * onehot[None, :]
    )
    n_gated = None
    if key is not None and config.channel_explore > 0:
        # Explore rows are EXEMPT from the rank1 gate (n_gated marks the
        # deterministic prefix): the joint-RGB jumps are the deep-quality
        # moves whose gains are often scale-0-dominated and invisible to
        # the gate's scale-1..5 prediction — gating them measured up to
        # ~8 error of premature plateau, which is why
        # gate+explore used to be auto-disabled outright.
        n_gated = sweep5.shape[0]
        rand5 = jax.random.randint(
            key, (config.channel_explore, 3), 0, 32, dtype=jnp.int32
        )
        sweep5 = jnp.concatenate([sweep5, rand5], axis=0)
    errors, apply, new_cache = _slot_machinery(state, config, p, i, cache)
    return _pick(
        errors, apply, new_cache, refp, sweep5, current, base_err,
        gate_base, (state, cache) if skip else None, config.accept_margin,
        gate_enable, n_gated,
    )


def _slot_nes(
    state: QuantState, config: QuantConfig, refp, p, i, cache=None,
    base_err=None, skip=False,
):
    """Exhaustive sweep of the 56 NES colors; ALWAYS replaces the entry
    with the best NES color (best_error starts at MAX, src/lib.rs:242-284).
    `base_err` is accepted for signature uniformity but unused: the
    always-replace rule never compares against the current error, and the
    exact 56-candidate scores come from the full (prescreen-free) path.

    Prescreening is disabled here: under always-replace semantics a coarse
    misranking could select a color *worse* than both the current entry and
    the true 56-color argmin — an actual regression, not just a missed
    improvement as in the strict-less-than random/channel paths."""
    cand5 = jnp.asarray(NES_PALETTE_5BIT)
    errors, apply, new_cache = _slot_machinery(state, config, p, i, cache)
    errs = errors(refp, cand5, allow_prescreen=False)
    bidx = jnp.argmin(errs)
    current = jax.lax.dynamic_slice(state.palette, (p, i, 0), (1, 1, 3)).reshape(3)
    color = cand5[bidx]
    changed = jnp.any(color != current)
    if skip:
        # Once the palette is NES-snapped, most visits re-pick the same
        # color; apply()/new_cache() are identity then (see _pick's skip).
        state_out, cache_out = jax.lax.cond(
            changed,
            lambda: (apply(color), new_cache(color)),
            lambda: (state, cache),
        )
        return SlotResult(state_out, errs[bidx], changed), cache_out
    res = SlotResult(apply(color), errs[bidx], changed)
    return res, new_cache(color)


@partial(jax.jit, static_argnames=("config",))
def refine_slot_random(state, config: QuantConfig, refp, key, p, i) -> SlotResult:
    return _slot_random(state, config, refp, key, p, i)[0]


@partial(jax.jit, static_argnames=("config", "window"))
def refine_slot_channel(
    state, config: QuantConfig, refp, p, i, channel, key=None, window=False
) -> SlotResult:
    return _slot_channel(
        state, config, refp, p, i, channel, key=key, window=window
    )[0]


@partial(jax.jit, static_argnames=("config",))
def refine_slot_nes(state, config: QuantConfig, refp, p, i) -> SlotResult:
    return _slot_nes(state, config, refp, p, i)[0]


# ---------------------------------------------------------------------------
# On-device full sweeps: one jitted call per scheduler step
# ---------------------------------------------------------------------------
#
# The host-driven loop dispatches one jitted call per slot visit; a full
# 8x15 sweep is 120 dispatches with a device sync each (the scheduler is
# sequentially dependent). These fori_loop versions run the whole sweep in
# one XLA program — the host sees only the final state. Key-split order
# matches the host loop exactly (same visits, same candidate draws);
# f32 fusion differences between the two compilations can still flip
# near-tie selections (tests assert trajectory equivalence, not bits).
#
# On the undithered path the sweeps carry the (H, W, S) distance cache and
# (perceptual mode) the precomputed target Lab image across slot visits —
# each accepted color performs a rank-1 column update instead of a full
# O(H*W*S) distance recompute per slot.


def _init_cache(state: QuantState, config: QuantConfig):
    if config.dither:
        return None
    target_lab = (
        srgb_u8_to_lab(state.rgb) if config.perceptual_palettes else None
    )
    return (compute_d_all(state, config), target_lab)


@partial(jax.jit, static_argnames=("config", "gate"))
def sweep_random(
    state: QuantState, config: QuantConfig, refp, key, base_err=None,
    use_gate=None, gate=True,
) -> SlotResult:
    """One full random step: every (palette, index) slot once
    (src/lib.rs:888-932, steps with step % 5 < 4).

    `base_err` is the exact error of the incoming state (carried across
    sweeps by the fused optimize loop); None computes it here. Each visit
    then carries the exact post-visit error forward, so no visit ever
    re-scores the current color as an in-batch baseline. With gating
    (QuantConfig.gate_margin) the current state's scale-0 weighted sum
    rides the carry too (see _pick / gate_base_fused); ``use_gate=False``
    (a dynamic scalar) forces every visit exact — the fused loop's
    confirmation sweeps before any convergence stop. ``gate=False``
    (STATIC) skips building the gate machinery entirely: the batched
    paths vmap this sweep, where the gate's lax.cond becomes a select
    that computes both branches, so gating there saves nothing
    (parallel/batch.py)."""
    s = config.subpalette_size
    if base_err is None:
        base_err = frame_error_fused(state, config, refp)
    gate0 = (
        gate_base_fused(state, config, refp)
        if gate and _gating_active(config)
        else None
    )
    enable = jnp.bool_(True) if use_gate is None else jnp.asarray(use_gate)

    def body(k, carry):
        state, key, err, cache, gb = carry
        key, sub = jax.random.split(key)
        res, cache, gb = _slot_random(
            state, config, refp, sub, k // s, k % s, cache, err, gb,
            skip=True, gate_enable=enable,
        )
        return res.state, key, res.error, cache, gb

    n = config.subpalette_count * s
    state, _, err, _, _ = jax.lax.fori_loop(
        0, n, body, (state, key, base_err, _init_cache(state, config), gate0)
    )
    return SlotResult(state, err, jnp.bool_(True))


@partial(jax.jit, static_argnames=("config", "window", "gate"))
def sweep_channel(
    state: QuantState, config: QuantConfig, refp, base_err=None, key=None,
    window=False, use_gate=None, gate=True,
) -> SlotResult:
    """One full channel step: every slot visited for channels 0,1,2 in
    sequence (src/lib.rs:917-923). Carried baseline: see sweep_random.

    With `config.channel_explore > 0` and a `key`, every visit draws
    that many extra random full-RGB candidates (split-per-visit stream,
    same discipline as sweep_random). ``window=True`` makes every visit
    windowed (see _slot_channel); ``use_gate=False`` (a dynamic scalar)
    forces every visit exact — the fused loop's confirmation sweeps
    before any convergence stop; ``gate=False`` (STATIC) skips building
    the gate machinery entirely — see sweep_random."""
    s = config.subpalette_size
    if base_err is None:
        base_err = frame_error_fused(state, config, refp)
    explore = key is not None and config.channel_explore > 0
    gate0 = (
        gate_base_fused(state, config, refp)
        if gate and _gating_active(config)
        else None
    )
    enable = jnp.bool_(True) if use_gate is None else jnp.asarray(use_gate)

    def body(k, carry):
        state, err, cache, key, gb = carry
        p = k // (s * 3)
        i = (k // 3) % s
        ch = k % 3
        sub = None
        if explore:
            key, sub = jax.random.split(key)
        res, cache, gb = _slot_channel(
            state, config, refp, p, i, ch, cache, err, key=sub,
            window=window, gate_base=gb, skip=True, gate_enable=enable,
        )
        return res.state, res.error, cache, key, gb

    if key is None:
        # keep the carry a fixed pytree; unused when explore is off
        key = jax.random.key(0)
    n = config.subpalette_count * s * 3
    state, err, _, _, _ = jax.lax.fori_loop(
        0, n, body, (state, base_err, _init_cache(state, config), key, gate0)
    )
    return SlotResult(state, err, jnp.bool_(True))


@partial(jax.jit, static_argnames=("config",))
def sweep_nes(
    state: QuantState, config: QuantConfig, refp, base_err=None
) -> SlotResult:
    """One full NES step: every slot NES-swept once (the reference's
    triple-visit counter quirk is coalesced; see core/pipeline.py).
    NES visits never use a baseline (always-replace); `base_err` is
    accepted for scheduler uniformity."""
    del base_err
    s = config.subpalette_size

    def body(k, carry):
        state, _, cache = carry
        res, cache = _slot_nes(
            state, config, refp, k // s, k % s, cache, skip=True
        )
        return res.state, res.error, cache

    n = config.subpalette_count * s
    state, err, _ = jax.lax.fori_loop(
        0, n, body, (state, jnp.float32(jnp.inf), _init_cache(state, config))
    )
    return SlotResult(state, err, jnp.bool_(True))
