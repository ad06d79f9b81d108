"""JSON output contract, bit-compatible with the reference.

Reference `as_json` (src/lib.rs:579-625) + serde_json serialization:

- ``palette``: for each subpalette, 16 u16 values — index 0 is the
  transparent slot (0), indices 1..=sub_size are the entries packed as
  BGR555 (``r | g<<5 | b<<10``), the rest padded with 0.
- ``tiles``: row-major tiles, each 64 row-major (y outer, x inner) values:
  ``palette_map + 1`` or 0 for transparent source pixels.
- ``tile_palettes``: per-tile subpalette id.

serde_json's default map is a BTreeMap, so keys serialize alphabetically
(palette, tile_palettes, tiles) with compact separators; we reproduce that
byte-for-byte.
"""

from __future__ import annotations

import json

import numpy as np

from snesimage.config import QuantConfig
from snesimage.core.state import QuantState
from snesimage.ops.color import pack_bgr555


def state_to_json_obj(state: QuantState, config: QuantConfig) -> dict:
    palette5 = np.asarray(state.palette)  # (C, S, 3)
    pmap = np.asarray(state.palette_map)  # (H, W)
    alpha = np.asarray(state.original[..., 3])
    tp = np.asarray(state.tile_palettes)  # (Ht, Wt)

    c, s, _ = palette5.shape
    packed = np.asarray(pack_bgr555(state.palette))  # (C, S)
    palette = []
    for pi in range(c):
        for i in range(16):
            if i == 0 or i > s:
                palette.append(0)
            else:
                palette.append(int(packed[pi, i - 1]))

    ht, wt = tp.shape
    values = np.where(alpha > 0, pmap + 1, 0)  # (H, W)
    # (Ht, 8, Wt, 8) -> per tile row-major y, x
    tiles_arr = values.reshape(ht, 8, wt, 8).transpose(0, 2, 1, 3).reshape(ht * wt, 64)
    tiles = tiles_arr.astype(int).tolist()
    tile_palettes = tp.reshape(-1).astype(int).tolist()

    # Alphabetical key order matches serde_json's BTreeMap serialization.
    return {"palette": palette, "tile_palettes": tile_palettes, "tiles": tiles}


def state_to_json(state: QuantState, config: QuantConfig) -> str:
    """Serialize exactly like serde_json's `to_string` (compact)."""
    return json.dumps(
        state_to_json_obj(state, config), separators=(",", ":"), ensure_ascii=False
    )


def write_json(path: str, state: QuantState, config: QuantConfig) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(state_to_json(state, config))
