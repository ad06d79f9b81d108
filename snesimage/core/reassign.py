"""Automatic tile->subpalette reassignment.

The reference never reassigns tiles after the initial k-means clustering —
its TODO explicitly wishes for it ("no attempt is made to reassign tiles
dynamically if it could improve the overall result", TODO.md:36-37); the
only mechanism is manual clicking in the GUI (src/lib.rs:1005-1024).

This extension reassigns every tile to the subpalette that minimizes the
tile's summed nearest-entry distance (red-mean or CIEDE2000, matching the
active color-comparison mode) — the same greedy criterion the per-pixel
remap optimizes, lifted to tile granularity. One fused evaluation scores
all (tile, subpalette) combinations on-device.

Caveat: the criterion is an undithered-distance proxy. With dithering
enabled it can WORSEN the SSIMULACRA2 error (measured +8 error points on
the bench image) because error diffusion lets a "worse" subpalette
average out — prefer it for undithered runs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from snesimage.config import QuantConfig
from snesimage.core.state import QuantState
from snesimage.ops.color import expand_5bit_to_8bit
from snesimage.ops.remap import entry_distances


@partial(jax.jit, static_argnames=("config",))
def auto_reassign_tiles(state: QuantState, config: QuantConfig) -> QuantState:
    """Greedily reassign each tile to its best subpalette.

    Returns the state with updated tile_palettes (palette_map is stale
    afterwards; callers re-remap — core/pipeline.py does).
    Fully-transparent tiles keep subpalette 0 (reference behavior for
    unclustered tiles, src/lib.rs:58).
    """
    c = config.subpalette_count
    entries8 = expand_5bit_to_8bit(state.palette)  # (C, S, 3)
    pixels = state.rgb  # (H, W, 3)

    # (H, W, C, S) distances to every entry of every subpalette.
    d = entry_distances(
        pixels[:, :, None, :], entries8[None, None], config.perceptual_palettes
    )
    dmin = jnp.min(d, axis=-1).astype(jnp.float32)  # (H, W, C)
    dmin = jnp.where((state.alpha > 0)[..., None], dmin, 0.0)

    ht, wt = config.height_tiles, config.width_tiles
    per_tile = dmin.reshape(ht, 8, wt, 8, c).sum(axis=(1, 3))  # (Ht, Wt, C)
    tp_new = jnp.argmin(per_tile, axis=-1).astype(jnp.int32)

    opaque_any = (
        (state.alpha > 0).reshape(ht, 8, wt, 8).any(axis=(1, 3))
    )  # (Ht, Wt)
    tp_new = jnp.where(opaque_any, tp_new, 0)
    return state._replace(tile_palettes=tp_new)
