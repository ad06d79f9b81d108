"""Optimizer state as a pure pytree.

The reference keeps a mutable ``OptimizedImage`` struct (src/lib.rs:33-77);
here the same information is an immutable pytree threaded through jitted
transforms, which also makes the whole optimizer state trivially
checkpointable (the reference has no resume path; TODO.md:38-39).

Fields:
  original:      (H, W, 4) uint8 RGBA source pixels.
  tile_palettes: (Ht, Wt) int32 subpalette id per 8x8 tile
                 (reference: flat Vec<u8> of 32*32, src/lib.rs:58).
  palette:       (C, S, 3) int32 5-bit palette entries
                 (reference: flat Vec<SnesColor>, src/lib.rs:747-760).
  palette_map:   (H, W) int32 entry index per pixel (src/lib.rs:39).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from snesimage.config import QuantConfig


class QuantState(NamedTuple):
    original: jax.Array
    tile_palettes: jax.Array
    palette: jax.Array
    palette_map: jax.Array

    @property
    def rgb(self) -> jax.Array:
        return self.original[..., :3].astype(jnp.int32)

    @property
    def alpha(self) -> jax.Array:
        return self.original[..., 3].astype(jnp.int32)


def new_state(source_rgba: np.ndarray | jax.Array, config: QuantConfig) -> QuantState:
    """Fresh all-black state for a source image (src/lib.rs:45-65)."""
    source_rgba = jnp.asarray(source_rgba, dtype=jnp.uint8)
    h, w = config.height, config.width
    if source_rgba.shape != (h, w, 4):
        raise ValueError(
            f"expected source of shape {(h, w, 4)}, got {source_rgba.shape}"
        )
    return QuantState(
        original=source_rgba,
        tile_palettes=jnp.zeros(
            (config.height_tiles, config.width_tiles), dtype=jnp.int32
        ),
        palette=jnp.zeros(
            (config.subpalette_count, config.subpalette_size, 3), dtype=jnp.int32
        ),
        palette_map=jnp.zeros((h, w), dtype=jnp.int32),
    )
