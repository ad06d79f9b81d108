"""Pixel -> palette-entry remap and frame rendering as batched tensor ops.

Vectorized replacement for the reference's serial per-pixel scan
(reference: src/lib.rs:425-501 `optimize`, src/lib.rs:762-795
`get_closest_color_index`, src/lib.rs:550-577 `as_rgba`).

The undithered path (dither weights all zero in the reference) is a pure
per-pixel argmin over the pixel's subpalette and is fully parallel; it is
also `vmap`-able over a batch of candidate palettes, which is how the
refine loop evaluates dozens-to-hundreds of candidates per step.
The dithered path lives in ops/dither.py (sequential wavefront scan).

Semantics mirrored exactly:
- targets are clamped to [0,255] and rounded half-away-from-zero to 8-bit
  before the distance computation (src/lib.rs:773-778);
- red-mean distance in non-perceptual mode, CIEDE2000 in perceptual mode
  (src/lib.rs:780-792);
- ties resolve to the lowest entry index (strict less-than scan);
- transparent pixels (alpha == 0) get palette_map 0 (src/lib.rs:453-458)
  and render as (0,0,0,0) (src/lib.rs:570-572).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from snesimage.ops.color import (
    ciede2000,
    expand_5bit_to_8bit,
    red_mean_sq_scaled,
    round_half_away_nonneg,
    srgb_u8_to_lab,
)


def quantize_target_u8(target: jax.Array) -> jax.Array:
    """Clamp float targets to [0,255] and round half-away-from-zero to int.

    Reference: src/lib.rs:773-778 (f64 -> u8 conversion before distance).
    """
    return round_half_away_nonneg(jnp.clip(target, 0.0, 255.0)).astype(jnp.int32)


def entry_distances(
    target_u8: jax.Array,
    sub_entries8: jax.Array,
    perceptual: bool,
    sub_entries_lab: jax.Array | None = None,
) -> jax.Array:
    """Distance from each pixel to each of its subpalette's entries.

    Args:
      target_u8: (..., 3) int 8-bit target colors.
      sub_entries8: (..., S, 3) int 8-bit palette entries per pixel.
      perceptual: CIEDE2000 when True, exact integer red-mean otherwise.
      sub_entries_lab: optional precomputed (..., S, 3) Lab of entries.

    Returns (..., S) distances (int32 scaled red-mean or f32 CIEDE2000).
    """
    if perceptual:
        lab_t = srgb_u8_to_lab(target_u8)[..., None, :]
        lab_e = (
            sub_entries_lab
            if sub_entries_lab is not None
            else srgb_u8_to_lab(sub_entries8)
        )
        # Reference order: color_distance_cielab(entry, target) — CIEDE2000
        # is symmetric, so argument order is immaterial.
        return ciede2000(lab_e, lab_t)
    return red_mean_sq_scaled(sub_entries8, target_u8[..., None, :])


def remap_undithered(
    original_rgb: jax.Array,
    alpha: jax.Array,
    tile_palettes: jax.Array,
    palette5: jax.Array,
    perceptual: bool,
) -> jax.Array:
    """Nearest-entry remap with zero accumulated error (no dithering).

    Args:
      original_rgb: (H, W, 3) uint8/int source colors.
      alpha: (H, W) source alpha channel.
      tile_palettes: (Ht, Wt) int subpalette id per 8x8 tile.
      palette5: (C, S, 3) int 5-bit palette.
      perceptual: distance selection flag.

    Returns palette_map (H, W) int32 in [0, S).
    """
    h, w, _ = original_rgb.shape
    entries8 = expand_5bit_to_8bit(palette5)  # (C, S, 3)
    tp_pix = jnp.repeat(jnp.repeat(tile_palettes, 8, axis=0), 8, axis=1)  # (H, W)
    sub = entries8[tp_pix]  # (H, W, S, 3)
    target_u8 = original_rgb.astype(jnp.int32)
    # Perceptual: convert the (C, S, 3) entry table to Lab ONCE and
    # gather, instead of converting the gathered (H, W, S, 3).
    sub_lab = srgb_u8_to_lab(entries8)[tp_pix] if perceptual else None
    d = entry_distances(target_u8, sub, perceptual, sub_entries_lab=sub_lab)
    idx = jnp.argmin(d, axis=-1).astype(jnp.int32)
    return jnp.where(alpha > 0, idx, 0)


def render_rgb8(
    palette_map: jax.Array,
    alpha: jax.Array,
    tile_palettes: jax.Array,
    palette5: jax.Array,
) -> jax.Array:
    """Expand (palette_map, tile_palettes, palette) to an (H, W, 3) frame.

    Transparent source pixels render as (0, 0, 0); callers that need RGBA
    carry `alpha` alongside. Reference: src/lib.rs:550-577.
    """
    entries8 = expand_5bit_to_8bit(palette5)  # (C, S, 3)
    c, s, _ = entries8.shape
    flat = entries8.reshape(c * s, 3)
    tp_pix = jnp.repeat(jnp.repeat(tile_palettes, 8, axis=0), 8, axis=1)
    color_index = tp_pix * s + palette_map
    rgb = flat[color_index]  # (H, W, 3)
    return jnp.where((alpha > 0)[..., None], rgb, 0)


def frame01(rgb8: jax.Array) -> jax.Array:
    """8-bit frame -> float32 [0,1] triples for the metric
    (reference: src/lib.rs:506-536 normalizes r,g,b and drops alpha)."""
    return rgb8.astype(jnp.float32) / 255.0


def render_linear(
    palette_map: jax.Array,
    alpha: jax.Array,
    tile_palettes: jax.Array,
    palette5: jax.Array,
) -> jax.Array:
    """Render the quantized frame directly in linear RGB for the metric.

    Per-pixel sRGB decode would be a per-pixel gather from a 256-entry
    LUT for every candidate frame. Since rendered frames
    only ever contain palette-entry colors (plus black for transparency),
    decode the C*S entries once (exact f64-derived LUT, tiny) and gather
    *linear* values during the render instead.
    """
    from snesimage.ops.color import srgb_u8_to_linear

    entries_lin = srgb_u8_to_linear(expand_5bit_to_8bit(palette5))  # (C, S, 3)
    c, s, _ = entries_lin.shape
    flat = entries_lin.reshape(c * s, 3)
    tp_pix = jnp.repeat(jnp.repeat(tile_palettes, 8, axis=0), 8, axis=1)
    color_index = tp_pix * s + palette_map
    lin = flat[color_index]
    return jnp.where((alpha > 0)[..., None], lin, 0.0)
