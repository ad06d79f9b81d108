"""Initialization stage: tile->subpalette assignment and palette k-means.

Vectorized rebuild of the reference's `initialize_tiles` (src/lib.rs:79-189)
and `recalculate_palette(s)` (src/lib.rs:330-415):

- Per-tile mean colors over opaque pixels (RGB, or CIELAB when
  `perceptual_palettes`), tiles with zero channel-sum excluded
  (src/lib.rs:89-128 — note the reference's guard tests the *sum*, so pure
  black tiles are excluded too; preserved here).
- k-means of tile means into `subpalette_count` clusters; the cluster id
  becomes the tile's subpalette (src/lib.rs:130-138). Initial centers are
  the first k valid tiles in the reference's push order (tile_x-major,
  src/lib.rs:89-90), see ops/kmeans.py.
- Each subpalette is flat-filled with its cluster mean quantized to 5 bits
  (perceptual: Lab->sRGB then truncating `u8/8` division; otherwise
  `round(mean/8)`), NES-snapped under `--nes` (src/lib.rs:140-184).
- `recalculate_palettes`: per-subpalette k-means over that subpalette's
  opaque pixels into `subpalette_size` colors (src/lib.rs:330-415). All
  subpalettes run as one vmapped k-means (the reference loops serially).

Pixel ordering note: the reference pushes pixels tile-by-tile with x as the
outer and y as the inner loop (src/lib.rs:338-339); we reproduce that order
for the deterministic first-k init.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from snesimage.config import QuantConfig
from snesimage.core.state import QuantState
from snesimage.ops.color import (
    lab_to_srgb_u8,
    nes_quantize,
    round_half_away_nonneg,
    srgb_u8_to_lab,
)
from snesimage.ops.kmeans import lloyd_kmeans


def _tile_pixel_gather(config: QuantConfig) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) index arrays of shape (T, 64) listing each tile's pixels
    in the reference's x-outer / y-inner order (src/lib.rs:95-96, 338-339)."""
    wt, ht = config.width_tiles, config.height_tiles
    t = np.arange(wt * ht)
    ty, tx = t // wt, t % wt
    x = np.arange(8)
    y = np.arange(8)
    # within-tile flat index o = x*8 + y (x outer, y inner)
    rows = np.broadcast_to(ty[:, None, None] * 8 + y[None, None, :], (len(t), 8, 8))
    cols = np.broadcast_to(tx[:, None, None] * 8 + x[None, :, None], (len(t), 8, 8))
    return rows.reshape(-1, 64), cols.reshape(-1, 64)


def _tile_init_order(config: QuantConfig) -> np.ndarray:
    """Tile priority order for k-means init: the reference pushes tile means
    with tile_x as the outer loop (src/lib.rs:89-90), i.e. column-major."""
    wt, ht = config.width_tiles, config.height_tiles
    return np.arange(ht * wt).reshape(ht, wt).T.reshape(-1).astype(np.int32)


def tile_pixels(state: QuantState, config: QuantConfig) -> tuple[jax.Array, jax.Array]:
    """Gather pixels into (T, 64, 3) rgb-u8 and (T, 64) opacity, reference
    traversal order."""
    rows, cols = _tile_pixel_gather(config)
    rgb = state.rgb[rows, cols]  # (T, 64, 3)
    opaque = state.alpha[rows, cols] > 0  # (T, 64)
    return rgb, opaque


def _color_coords(rgb_u8: jax.Array, perceptual: bool) -> jax.Array:
    """Clustering coordinates: CIELAB in perceptual mode, raw RGB otherwise
    (src/lib.rs:100-111, 343-359)."""
    if perceptual:
        return srgb_u8_to_lab(rgb_u8)
    return rgb_u8.astype(jnp.float32)


def _quantize_center(center: jax.Array, config: QuantConfig) -> jax.Array:
    """Cluster mean -> 5-bit SNES color, matching src/lib.rs:140-171,
    368-401: perceptual converts Lab->sRGB u8 then truncates /8; RGB mode
    rounds mean/8; NES mode snaps to the 56-color master palette."""
    if config.perceptual_palettes:
        rgb8 = lab_to_srgb_u8(center)
        rgb5 = rgb8 // 8  # u8 integer division truncates
    else:
        rgb5 = round_half_away_nonneg(center / 8.0).astype(jnp.int32)
        rgb5 = jnp.clip(rgb5, 0, 31)  # ref would overflow u8 at mean==255
    if config.nes:
        rgb5 = nes_quantize(rgb5, config.perceptual_palettes)
    return rgb5


@partial(jax.jit, static_argnames=("config",))
def assign_tiles(state: QuantState, config: QuantConfig) -> QuantState:
    """Cluster tile means into subpalettes and flat-fill initial palettes
    (src/lib.rs:79-189 minus the final remap, which the pipeline owns).

    With subpalette_count == 1 this is the identity on tile_palettes and
    palette initialization is left to recalculate_palettes
    (src/lib.rs:80-84)."""
    if config.subpalette_count == 1:
        return state

    rgb, opaque = tile_pixels(state, config)
    coords = _color_coords(rgb, config.perceptual_palettes)  # (T, 64, 3)
    w = opaque.astype(jnp.float32)[..., None]
    sums = jnp.sum(coords * w, axis=1)  # (T, 3)
    counts = jnp.sum(opaque, axis=1).astype(jnp.float32)  # (T,)
    means = sums / jnp.maximum(counts, 1.0)[:, None]
    valid = jnp.sum(sums, axis=-1) > 0.0  # reference guard, src/lib.rs:118

    km = lloyd_kmeans(
        means,
        valid,
        config.subpalette_count,
        init_order=jnp.asarray(_tile_init_order(config)),
    )
    tp = jnp.where(valid, km.assignments, 0).reshape(
        config.height_tiles, config.width_tiles
    )

    colors5 = jax.vmap(lambda c: _quantize_center(c, config))(km.centers)  # (C, 3)
    palette = jnp.broadcast_to(
        colors5[:, None, :],
        (config.subpalette_count, config.subpalette_size, 3),
    ).astype(jnp.int32)
    return state._replace(tile_palettes=tp, palette=palette)


@partial(jax.jit, static_argnames=("config",))
def recalculate_palettes(state: QuantState, config: QuantConfig) -> QuantState:
    """Per-subpalette pixel k-means into subpalette_size colors
    (src/lib.rs:330-415 minus the final remap). All subpalettes run as one
    vmapped Lloyd's instead of the reference's serial loop."""
    rgb, opaque = tile_pixels(state, config)  # (T, 64, 3), (T, 64)
    coords = _color_coords(rgb, config.perceptual_palettes).reshape(-1, 3)
    tp_flat = state.tile_palettes.reshape(-1)  # (T,)
    tile_of_pixel = jnp.repeat(tp_flat, 64)  # (T*64,)
    opaque_flat = opaque.reshape(-1)

    def one_palette(p: jax.Array):
        mask = (tile_of_pixel == p) & opaque_flat
        km = lloyd_kmeans(coords, mask, config.subpalette_size)
        return km.centers  # (S, 3)

    centers = jax.vmap(one_palette)(
        jnp.arange(config.subpalette_count, dtype=jnp.int32)
    )  # (C, S, 3)
    colors5 = jax.vmap(jax.vmap(lambda c: _quantize_center(c, config)))(centers)
    return state._replace(palette=colors5.astype(jnp.int32))
